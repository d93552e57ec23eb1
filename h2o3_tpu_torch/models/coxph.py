"""Cox proportional hazards — the port of ``h2o3_tpu/models/coxph.py``
(the successor of ``hex.coxph.CoxPH``): Newton–Raphson on the partial
log-likelihood with Efron (H2O's default) or Breslow ties.

Rows sort once on the host by descending stop time, so a row's risk set
is a prefix, and the design (centered on its float64 means) moves to the
frame's device in that order. Each iteration is one pass there
(:func:`ll_grad_hess`): per tie group the sums of exp(η), x·exp(η) and of
the events' terms by ``index_add_``, the risk sets as prefix sums over the
groups, then the Efron or Breslow terms looped over the within-group event
rank up to the largest group's event count (read once). The per-row outer
products JAX forms, (n, d, d), are never built: the Hessian's Σ φ₂/φ₀
terms regroup into one weighted Gram XᵀCX with C a per-row weight (each
row's exp(η) times the reverse sum of its risk sets' 1/φ₀ terms, less its
own group's Efron share), and the gradient into Xᵀ(δ − C), which is
JAX's formula with its sums taken in another order. The d x d Newton
step is solved on the host in float64; Harrell's C is computed on the
host over JAX's 3,000-row sample (``default_rng(0)``).

**Dtype.** JAX runs this pass in float32 (the package never enables x64,
so its float64 arrays become float32 on the device). The port runs it in
float64, since float32 prefix sums over 1M rows lose digits: its
coefficients agree with JAX's to float32's precision and with a float64
evaluation of JAX's formula to float64's.

JAX unrolls the Efron correction over at most 32 events a tie group
(``MAXD``): a group with more events drops the terms after its 32nd. The
port keeps that rule (:data:`MAXD`); see the roadmap's faults of the
reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.metrics import ModelMetrics
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder

MAXD = 32  # JAX's cap on the Efron terms of a tie group
CONCORDANCE_ROWS = 3000  # JAX's sample for Harrell's C


@dataclass
class CoxPHParams(CommonParams):
    start_column: str | None = None
    stop_column: str | None = None  # defaults to the response column
    ties: str = "efron"  # efron | breslow
    max_iterations: int = 20
    tolerance: float = 1e-8


class CoxPHModel(Model):
    algo = "coxph"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """The linear predictor (log partial hazard) centered like H2O and
        R, float64 on the frame's device."""
        o = self.output
        X = torch.stack([frame.vec(c).data.double() for c in o["names"]], 1)
        dev = X.device
        means = torch.as_tensor(o["x_means"], dtype=torch.float64, device=dev)
        beta = torch.as_tensor(o["coefficients"], dtype=torch.float64,
                               device=dev)
        return (torch.nan_to_num(X) - means[None, :]) @ beta

    def concordance(self) -> float:
        return self.training_metrics.value("concordance")


class Survival:
    """The sorted design on the device and its tie groups: what every
    Newton iteration reads."""

    def __init__(self, Xc: torch.Tensor, event: np.ndarray,
                 grp_id: np.ndarray, efron: bool):
        dev = Xc.device
        self.X = Xc
        self.ev = torch.from_numpy(event).to(dev)
        self.gid = torch.from_numpy(grp_id).to(dev)
        self.n_grp = int(grp_id[-1]) + 1 if len(grp_id) else 0
        self.efron = efron
        dsum = torch.zeros(self.n_grp, dtype=torch.float64, device=dev)
        dsum.index_add_(0, self.gid, self.ev)
        self.dsum = dsum
        self.zsum = self.X.T @ self.ev  # Σ over events of x
        # the largest group's event count, read once: the Efron loop's end
        self.max_events = int(dsum.max()) if self.n_grp else 0
        self.efron_terms = min(self.max_events, MAXD)

    def _gsum(self, v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n_grp,) + v.shape[1:], dtype=v.dtype,
                          device=v.device)
        return out.index_add_(0, self.gid, v)

    def ll_grad_hess(self, beta: torch.Tensor):
        """The partial log-likelihood, its gradient and Hessian at
        ``beta`` (float64, on the device)."""
        X, ev, gid = self.X, self.ev, self.gid
        eta = X @ beta
        r = torch.exp(eta)
        re = r * ev
        # risk-set sums at each group: prefix sums over the groups
        s0 = torch.cumsum(self._gsum(r), 0)
        s1 = torch.cumsum(self._gsum(X * r[:, None]), 0)
        e0 = self._gsum(re)
        e1 = self._gsum(X * re[:, None])
        ll = self._gsum(eta * ev).sum()
        dg = self.dsum
        A = torch.zeros_like(s0)  # Σ_l 1/φ₀ over a group's active terms
        Bf = torch.zeros_like(s0)  # Σ_l frac_l/φ₀
        H = torch.zeros((X.shape[1], X.shape[1]), dtype=X.dtype,
                        device=X.device)
        for l in range(self.efron_terms):
            active = l < dg
            frac = (torch.where(dg > 0, l / torch.clamp(dg, min=1.0), 0.0)
                    if self.efron else torch.zeros_like(dg))
            phi0 = torch.clamp(s0 - frac * e0, min=1e-300)
            inv = torch.where(active, 1.0 / phi0, 0.0)
            ll = ll - torch.where(active, torch.log(phi0), 0.0).sum()
            A = A + inv
            Bf = Bf + frac * inv
            V = (s1 - frac[:, None] * e1) * inv[:, None]
            H = H + V.T @ V
        # row weights: exp(η)·(Σ of 1/φ₀ over the risk sets holding the
        # row) − the row's own Efron share when it is an event
        SA = torch.flip(torch.cumsum(torch.flip(A, [0]), 0), [0])
        c = r * SA[gid] - re * Bf[gid]
        grad = self.zsum - X.T @ c
        H = H - (X * c[:, None]).T @ X
        return ll, grad, H


def concordance(times, event, eta) -> float:
    """Harrell's C on (possibly subsampled) pairs — JAX's, O(n²) capped at
    3,000 rows sampled by ``default_rng(0)``; ``eta`` is a callable giving
    the linear predictor of the given rows (so only those are read)."""
    n = len(times)
    idx = np.arange(n)
    if n > CONCORDANCE_ROWS:
        idx = np.random.default_rng(0).choice(n, CONCORDANCE_ROWS,
                                              replace=False)
        times, event = times[idx], event[idx]
        n = CONCORDANCE_ROWS
    eta = eta(idx)
    conc = ties = total = 0.0
    for i in range(n):
        if event[i] != 1:
            continue
        cmp = times > times[i]
        total += cmp.sum()
        conc += (eta[cmp] < eta[i]).sum()
        ties += (eta[cmp] == eta[i]).sum()
    return float((conc + 0.5 * ties) / total) if total > 0 else float("nan")


class CoxPH(ModelBuilder):
    algo = "coxph"
    PARAMS_CLS = CoxPHParams

    def _build(self, train: Frame, valid: Frame | None):
        p: CoxPHParams = self.params
        # call shape: response_column = event indicator 0/1,
        # stop_column = time (the common (time, event) pair)
        if not p.stop_column:
            raise ValueError("CoxPH needs stop_column (the time column)")
        dev = train.device
        times = train.vec(p.stop_column).to_numpy().astype(np.float64)
        ev_v = train.vec(p.response_column)
        event = ev_v.to_numpy().astype(np.float64)
        if ev_v.is_categorical():
            event = (event == 1).astype(np.float64)
        cols = [c for c in self._x
                if c not in (p.stop_column, p.response_column)]
        X = torch.stack([train.vec(c).data.double() for c in cols], 1)
        ok = (~np.isnan(times) & ~np.isnan(event)
              & ~torch.isnan(X).any(1).cpu().numpy())
        times, event = times[ok], event[ok]
        # sort by DESCENDING time so risk sets are prefixes
        srt = np.argsort(-times, kind="mergesort")
        times, event = times[srt], event[srt]
        rows = torch.from_numpy(np.flatnonzero(ok)[srt]).to(dev)
        X = X.index_select(0, rows)
        x_means = X.mean(0)
        Xc = X - x_means[None, :]
        del X
        n, d = Xc.shape

        # tie groups (equal event times), in sorted order
        grp_id = np.zeros(n, np.int64)
        if n:
            grp_id[1:] = np.cumsum(times[1:] != times[:-1])
        surv = Survival(Xc, event, grp_id, p.ties.lower() == "efron")
        # times, event, the rows with an NA, the largest group's events
        host_reads = 4

        beta = torch.zeros(d, dtype=torch.float64, device=dev)
        ll_prev = -np.inf
        ll = float("nan")
        iters = 0
        for it in range(p.max_iterations):
            ll_d, grad, H = surv.ll_grad_hess(beta)
            packed = torch.cat([ll_d.reshape(1), grad, H.reshape(-1)]
                               ).cpu().numpy()
            host_reads += 1
            ll = float(packed[0])
            gn = packed[1: 1 + d]
            Hn = packed[1 + d:].reshape(d, d)
            try:
                delta = np.linalg.solve(Hn - 1e-9 * np.eye(d), -gn)
            except np.linalg.LinAlgError:
                break
            beta = beta + torch.from_numpy(delta).to(dev)
            iters = it + 1
            if abs(ll - ll_prev) < p.tolerance * (abs(ll) + 1e-9):
                break
            ll_prev = ll

        beta_np = beta.cpu().numpy()
        out = {
            "coefficients": beta_np,
            "coef_names": cols,
            "names": cols,
            "x_means": x_means.cpu().numpy(),
            "loglik": ll,
            "n": int(n),
            "n_events": int(event.sum()),
            "largest_group_events": surv.max_events,
            "efron_terms": surv.efron_terms,
            "tie_groups": surv.n_grp,
            "host_reads": host_reads + 3,  # beta, the means, the C sample
            "response_domain": None,
        }
        model = CoxPHModel(None, p, out)
        eta_dev = Xc @ beta
        conc = concordance(times, event, lambda idx: eta_dev.index_select(
            0, torch.from_numpy(idx).to(dev)).cpu().numpy())
        model.training_metrics = ModelMetrics(
            "coxph",
            {"loglik": ll, "concordance": conc, "iterations": iters,
             "n": int(n), "n_events": int(event.sum())})
        return model
