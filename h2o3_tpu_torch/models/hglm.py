"""HGLM — the port of ``h2o3_tpu/models/hglm.py`` (the successor of
``hex.hglm.HGLM``): a gaussian mixed model with a random intercept per
level of each of the ``random_columns`` factors.

Model: y = Xβ + Σ_j Z_j u_j + e,  u_j ~ N(0, σ²_{u_j} I),  e ~ N(0, σ²_e I).

The fixed effects come through ``DataInfo`` (no level kept for the base,
the intercept on), and each random column appends its one-hot block, so
the design ``[X | Z_1 | ...]`` is built densely on the frame's device, as
JAX builds it: at 1M rows and 500 levels that is 2.1 GB of float32. ONE
``weighted_gram`` pass gives the whole coefficient matrix of Henderson's
mixed-model equations and its right-hand side. The EM-REML loop then runs
on the host in float64, as JAX runs it:

    σ²_{u_j} ← (û_jᵀû_j + σ²_e·tr(C_jj)) / q_j
    σ²_e     ← (yᵀy − solᵀ·rhs) / (n − p)

with the ``k·I`` blocks added to the random blocks, ``inv`` falling back to
``pinv``, and the stop on ``em_epsilon``. Prediction adds each random
column's BLUPs by one gather from the frame's codes (an unseen or NA level
gets 0, the prior mean).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree.binning import _adapt_codes
from h2o3_tpu_torch.ops.gram import weighted_gram


@dataclass
class HGLMParams(CommonParams):
    random_columns: list = field(default_factory=list)
    method: str = "EM"
    max_iterations: int = 100
    em_epsilon: float = 1e-6
    standardize: bool = False
    intercept: bool = True


class HGLMModel(Model):
    algo = "hglm"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Xβ plus the BLUPs of the frame's levels, float64 on the frame's
        device."""
        o = self.output
        X, _ = o["datainfo"].transform(frame)
        dev = X.device
        eta = X.double() @ torch.as_tensor(o["beta"], dtype=torch.float64,
                                           device=dev)
        for rc, (dom, u) in o["random_effects"].items():
            codes = _adapt_codes(frame.vec(rc), dom).long()
            # one slot past the levels for NA and unseen levels: u = 0
            table = torch.zeros(len(dom) + 1, dtype=torch.float64, device=dev)
            table[: len(dom)] = torch.as_tensor(u, dtype=torch.float64,
                                                device=dev)
            eta = eta + table[torch.where(codes < 0, len(dom), codes)]
        return eta

    @property
    def coef(self) -> dict:
        return dict(zip(self.output["coef_names"], self.output["beta"]))

    def coefs_random(self, column: str) -> dict:
        dom, u = self.output["random_effects"][column]
        return dict(zip(dom, u))

    def _distribution_for_metrics(self) -> str:
        return "gaussian"


def em_reml(M0: np.ndarray, rhs: np.ndarray, yty: float, n_eff: float,
            P: int, qs: list[int], max_iterations: int, em_epsilon: float):
    """JAX's EM-REML iterations on the mixed-model equations, float64 on
    the host: ``(beta, [u_j], sigma_e2, [sigma_u2_j], iterations)``."""
    sig_e = max(yty / max(n_eff, 1.0), 1e-8)
    sig_u = [sig_e / 2.0] * len(qs)
    beta = np.zeros(P)
    us: list[np.ndarray] = [np.zeros(q) for q in qs]
    it = 0
    for it in range(max_iterations):
        M = M0.copy()
        off = P
        for j, q in enumerate(qs):
            k = sig_e / max(sig_u[j], 1e-12)
            M[off: off + q, off: off + q] += k * np.eye(q)
            off += q
        try:
            C = np.linalg.inv(M + 1e-10 * np.eye(len(M)))
        except np.linalg.LinAlgError:
            C = np.linalg.pinv(M)
        sol = C @ rhs
        beta = sol[:P]
        off = P
        new_sig_u = []
        for j, q in enumerate(qs):
            u = sol[off: off + q]
            us[j] = u
            C_jj = C[off: off + q, off: off + q]
            new_sig_u.append(max((u @ u + sig_e * np.trace(C_jj)) / q, 1e-10))
            off += q
        sse = max(yty - sol @ rhs, 1e-12)
        new_sig_e = sse / max(n_eff - P, 1.0)
        delta = abs(new_sig_e - sig_e) / max(sig_e, 1e-12) + sum(
            abs(a - b_) / max(b_, 1e-12) for a, b_ in zip(new_sig_u, sig_u))
        sig_e, sig_u = new_sig_e, new_sig_u
        if delta < em_epsilon:
            break
    return beta, us, sig_e, sig_u, it + 1


class HGLM(ModelBuilder):
    algo = "hglm"
    PARAMS_CLS = HGLMParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: HGLMParams = self.params
        if not p.random_columns:
            raise ValueError("hglm requires random_columns")
        if p.max_iterations < 1:
            raise ValueError("max_iterations must be >= 1")
        yv = train.vec(p.response_column)
        if yv.is_categorical():
            raise ValueError("hglm supports gaussian (numeric) responses")

        fixed = [n for n in self._x if n not in p.random_columns]
        di = DataInfo.fit(train, fixed, standardize=p.standardize,
                          use_all_factor_levels=False,
                          add_intercept=p.intercept)
        X, valid_mask = di.transform(train)
        P = di.ncols_expanded
        dev = X.device

        blocks: list[tuple[str, list, int]] = []  # (column, domain, q)
        parts = [X]
        for rc in p.random_columns:
            v = train.vec(rc)
            if not v.is_categorical():
                raise ValueError(f"random column {rc!r} must be categorical")
            q = v.cardinality
            codes = v.data.long()  # -1 for NA: an all-zero row
            parts.append((codes[:, None] == torch.arange(q, device=dev)[None, :]
                          ).to(torch.float32))
            blocks.append((rc, list(v.domain or ()), q))
        W = torch.cat(parts, dim=1)
        del parts

        y = yv.data.to(torch.float32)
        w = valid_mask * (~torch.isnan(y))
        if p.weights_column:
            w = w * torch.nan_to_num(train.vec(p.weights_column).data.float())
        y = torch.nan_to_num(y, nan=0.0)

        G_d, b_d, sw_d = weighted_gram(W, w, y, keep_f64=True)
        del W
        yty_d = torch.sum(w * y * y)
        Q = G_d.shape[0]
        packed = torch.cat([G_d.reshape(-1), b_d,
                            torch.stack([sw_d.double(), yty_d.double()])])
        packed = packed.cpu().numpy()  # the one read of the device pass
        M0 = packed[: Q * Q].reshape(Q, Q)
        rhs = packed[Q * Q: Q * Q + Q]
        n_eff, yty = float(packed[-2]), float(packed[-1])

        qs = [q for _, _, q in blocks]
        beta, us, sig_e, sig_u, iters = em_reml(
            M0, rhs, yty, n_eff, P, qs, p.max_iterations, p.em_epsilon)

        out = {
            "datainfo": di,
            "beta": beta,
            "coef_names": di.coef_names(),
            "random_effects": {rc: (dom, u)
                               for (rc, dom, _), u in zip(blocks, us)},
            "sigma_e2": float(sig_e),
            "sigma_u2": {rc: float(s) for (rc, _, _), s in zip(blocks, sig_u)},
            "em_iterations": iters,
            "names": list(self._x),
            "response_domain": None,
        }
        model = HGLMModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
