"""GAM — the port of ``h2o3_tpu/models/gam.py`` (the successor of
``hex.gam.GAM``): generalized additive models with cubic regression
splines, mgcv's construction as H2O inherits it.

What JAX computes on the host in float64 stays there, in the same code:
per ``gam_column`` the quantile knots, the cardinal natural cubic spline's
second-derivative map F and curvature penalty S (:func:`cr_penalty`) and
the sum-to-zero centering transform Z (:func:`center_transform`, from the
basis's column sums). The 1M-row basis itself is evaluated on the frame's
device in float64 (:func:`cr_basis`: ``torch.searchsorted`` and gathers,
the same formula as JAX's numpy), multiplied by Z and cast to the float32
design ``[linear | splines | intercept]``, so the design is never built in
numpy and uploaded.

Each IRLS iteration is JAX's ``_gam_irls_pass``: the link, working
response and weights on the device, then the port's ``weighted_gram``;
the penalized solve ``G + Pen`` (the splines' ``scale``·S̃ blocks, and
``lambda_`` as a ridge on everything but the intercept) runs on the host
in float64. One host read an iteration (G, b and the deviance).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.glm_families import get_family
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.ops.gram import full_fp32, solve_cholesky, weighted_gram


@dataclass
class GAMParams(CommonParams):
    family: str = "AUTO"
    gam_columns: list = field(default_factory=list)
    num_knots: list = field(default_factory=list)  # per gam col; default 10
    scale: list = field(default_factory=list)  # smoothing lambda per gam col
    bs: list = field(default_factory=list)  # basis type per col; 0 = cr (only)
    lambda_: float = 0.0  # ridge on the parametric part
    standardize: bool = True
    intercept: bool = True
    max_iterations: int = 50
    beta_epsilon: float = 1e-6
    keep_gam_cols: bool = False


def cr_penalty(knots: np.ndarray):
    """``(F, S)``: the second-derivative map (k, k) and the penalty
    DᵀB⁻¹D (k, k) of the knots (JAX's ``_cr_penalty``, float64)."""
    k = len(knots)
    h = np.diff(knots)
    D = np.zeros((k - 2, k))
    B = np.zeros((k - 2, k - 2))
    for i in range(k - 2):
        D[i, i] = 1.0 / h[i]
        D[i, i + 1] = -1.0 / h[i] - 1.0 / h[i + 1]
        D[i, i + 2] = 1.0 / h[i + 1]
        B[i, i] = (h[i] + h[i + 1]) / 3.0
        if i + 1 < k - 2:
            B[i, i + 1] = B[i + 1, i] = h[i + 1] / 6.0
    Binv = np.linalg.inv(B)
    F = np.zeros((k, k))
    F[1:-1] = Binv @ D  # natural spline: zero curvature at the boundary knots
    S = D.T @ Binv @ D
    return F, S


def cr_basis(x: torch.Tensor, knots: np.ndarray, F: np.ndarray
             ) -> torch.Tensor:
    """The cardinal CR basis at ``x`` (float64, on its device) -> (n, k),
    clamped at the knots' range: JAX's ``_cr_basis`` formula."""
    dev = x.device
    kn = torch.as_tensor(knots, dtype=torch.float64, device=dev)
    Ft = torch.as_tensor(F, dtype=torch.float64, device=dev)
    k = len(knots)
    xc = torch.clamp(x, kn[0], kn[-1])
    j = torch.clamp(torch.searchsorted(kn, xc, right=True) - 1, 0, k - 2)
    k0, k1 = kn[j], kn[j + 1]
    h = k1 - k0
    am = (k1 - xc) / h
    ap = (xc - k0) / h
    cm = ((k1 - xc) ** 3 / h - h * (k1 - xc)) / 6.0
    cp = ((xc - k0) ** 3 / h - h * (xc - k0)) / 6.0
    rows = torch.arange(len(x), device=dev)
    X = torch.zeros((len(x), k), dtype=torch.float64, device=dev)
    X[rows, j] += am
    X[rows, j + 1] += ap
    X += cm[:, None] * Ft[j] + cp[:, None] * Ft[j + 1]
    return X


def center_transform(colsum: np.ndarray) -> np.ndarray:
    """Z with columns spanning {v : 1ᵀXv = 0} from the basis's column sums
    (mgcv's centering constraint; JAX's ``_center_transform``)."""
    q, _ = np.linalg.qr(np.asarray(colsum, np.float64)[None, :].T,
                        mode="complete")
    return q[:, 1:]  # (k, k-1)


def _imputed64(frame: Frame, name: str, value: float) -> torch.Tensor:
    x = frame.vec(name).data.double()
    return torch.where(torch.isnan(x), value, x)


def expand(frame: Frame, linear_names, linear_info, gam_terms,
           intercept: bool) -> torch.Tensor:
    """The float64 design ``[linear | splines | intercept]`` of ``frame``
    on its device (JAX's ``GAMModel._expand``)."""
    cols = []
    for n in linear_names:
        info = linear_info[n]
        x = _imputed64(frame, n, info["mean"])
        cols.append(((x - info["mean"]) / info["sigma"])[:, None])
    for g in gam_terms:
        x = _imputed64(frame, g["name"], g["impute"])
        Z = torch.as_tensor(g["Z"], dtype=torch.float64, device=x.device)
        cols.append(cr_basis(x, g["knots"], g["F"]) @ Z)
    if intercept:
        cols.append(torch.ones((frame.nrow, 1), dtype=torch.float64,
                               device=frame.device))
    return torch.cat(cols, dim=1)


def _irls_pass(X, y, w, beta, fam):
    """JAX's ``_gam_irls_pass``: the Gram, XᵀWz and the deviance."""
    with full_fp32():
        eta = X @ beta
    mu = fam.link.inv(eta)
    d = fam.link.dinv(eta)
    d = torch.where(d == 0, 1e-10,
                    torch.sign(d) * torch.clamp(torch.abs(d), min=1e-10))
    var = fam.variance(mu)
    z = eta + (y - mu) / d
    W = w * d * d / var
    G, b, _ = weighted_gram(X, W, z)
    return G, b, fam.deviance(y, mu, w)


class GAMModel(Model):
    algo = "gam"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """On the frame's device: the float64 linear predictor, then the
        inverse link in float32 (JAX's ``jnp`` on float64 input); (n, 2)
        class probabilities for a binomial model."""
        o = self.output
        X = expand(frame, o["linear_names"], o["linear_info"],
                   o["gam_terms"], o.get("intercept", True))
        eta = X @ torch.as_tensor(o["beta"], dtype=torch.float64,
                                  device=X.device)
        mu = get_family(o["family"]).link.inv(eta.float())
        if self.is_classifier:
            return torch.stack([1 - mu, mu], dim=1)
        return mu

    @property
    def coef(self) -> dict:
        return dict(zip(self.output["coef_names"], self.output["beta"]))

    def _distribution_for_metrics(self) -> str:
        return {"poisson": "poisson", "gamma": "gamma"}.get(
            self.output["family"], "gaussian")


class GAM(ModelBuilder):
    algo = "gam"
    PARAMS_CLS = GAMParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: GAMParams = self.params
        if not p.gam_columns:
            raise ValueError("gam requires gam_columns")
        yv = train.vec(p.response_column)
        family = p.family.lower()
        if family == "auto":
            family = "binomial" if yv.is_categorical() else "gaussian"
        fam = get_family(family)
        dev = train.device

        gam_cols = [c[0] if isinstance(c, (list, tuple)) else c
                    for c in p.gam_columns]
        linear_names = [n for n in self._x
                        if n not in gam_cols and train.vec(n).is_numeric()]

        # the linear (parametric) part, standardized with numpy's nanmean
        # and nanstd (population) of the column
        linear_info: dict[str, dict] = {}
        for n in linear_names:
            x = train.vec(n).data.double()
            ok = ~torch.isnan(x)
            cnt = max(int(ok.sum()), 1)
            mean = float(torch.where(ok, x, 0.0).sum()) / cnt
            var = float(torch.where(ok, (x - mean) ** 2, 0.0).sum()) / cnt
            linear_info[n] = ({"mean": mean, "sigma": float(np.sqrt(var))
                               or 1.0} if p.standardize
                              else {"mean": 0.0, "sigma": 1.0})

        # spline terms: knots, F, S and Z on the host from the pulled column
        gam_terms: list[dict] = []
        blocks: list[tuple[int, int]] = []  # (offset, width) of each spline
        off = len(linear_names)
        penalties: list[tuple[np.ndarray, float]] = []
        for gi, name in enumerate(gam_cols):
            v = train.vec(name)
            if not v.is_numeric():
                raise ValueError(f"gam column {name!r} must be numeric")
            x = v.to_numpy().astype(np.float64)
            impute = float(np.nanmean(x))
            x = np.where(np.isnan(x), impute, x)
            nk = int(p.num_knots[gi]) if gi < len(p.num_knots) else 10
            nk = max(3, nk)
            knots = np.unique(np.quantile(x, np.linspace(0, 1, nk)))
            if len(knots) < 3:
                raise ValueError(
                    f"gam column {name!r} has too few distinct values")
            F, S = cr_penalty(knots)
            colsum = cr_basis(torch.from_numpy(x).to(dev), knots,
                              F).sum(0).cpu().numpy()
            Z = center_transform(colsum)
            lam = float(p.scale[gi]) if gi < len(p.scale) else 1.0
            gam_terms.append({"name": name, "knots": knots, "F": F, "Z": Z,
                              "impute": impute, "scale": lam})
            blocks.append((off, Z.shape[1]))
            penalties.append((Z.T @ S @ Z, lam))
            off += Z.shape[1]
        X = expand(train, linear_names, linear_info, gam_terms,
                   p.intercept).float()
        P = X.shape[1]

        # penalty matrix over the full design
        Pen = np.zeros((P, P))
        for (o_, w_), (Sc, lam) in zip(blocks, penalties):
            Pen[o_: o_ + w_, o_: o_ + w_] = lam * Sc
        if p.lambda_:
            n_ridge = P - 1 if p.intercept else P  # never ridge the intercept
            for i in range(n_ridge):
                Pen[i, i] += p.lambda_

        y = yv.data.double()
        if yv.is_categorical():
            y = torch.where(y < 0, float("nan"), y)
        w = torch.ones_like(y)
        if p.weights_column:
            w = w * torch.nan_to_num(train.vec(p.weights_column).data.double())
        w = w * (~torch.isnan(y))
        y = torch.nan_to_num(y, nan=0.0)

        beta = np.zeros(P, np.float64)
        if p.intercept:
            mu0 = float((w * y).sum() / max(float(w.sum()), 1e-10))
            if family == "binomial":
                mu0 = min(max(mu0, 1e-4), 1 - 1e-4)
            beta[-1] = float(fam.link.fwd(torch.tensor(mu0,
                                                       dtype=torch.float32)))
        wd, yd = w.float(), y.float()

        max_iter = p.max_iterations if p.max_iterations > 0 else 50
        dev_val = np.inf
        iterations = 0
        for _ in range(max_iter):
            G, b, dv = _irls_pass(X, yd, wd, torch.as_tensor(
                beta, dtype=torch.float32, device=dev), fam)
            packed = torch.cat([G.reshape(-1).double(), b.double(),
                                dv.double().reshape(1)]).cpu().numpy()
            iterations += 1
            G_h = packed[: P * P].reshape(P, P)
            new = solve_cholesky(G_h + Pen, packed[P * P: P * P + P])
            delta = np.max(np.abs(new - beta))
            beta = new
            dev_val = float(packed[-1])
            if delta < p.beta_epsilon:
                break

        coef_names = (
            list(linear_names)
            + [f"{g['name']}_cr_{i}" for g, (o_, w_) in zip(gam_terms, blocks)
               for i in range(w_)]
            + (["Intercept"] if p.intercept else []))
        out = {
            "intercept": p.intercept,
            "beta": beta,
            "coef_names": coef_names,
            "linear_names": linear_names,
            "linear_info": linear_info,
            "gam_terms": gam_terms,
            "family": family,
            "deviance": dev_val,
            "iterations": iterations,
            "host_reads": iterations + 1 + len(gam_terms),
            "names": list(self._x),
            "response_domain": tuple(yv.domain) if yv.is_categorical()
            else None,
        }
        model = GAMModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
