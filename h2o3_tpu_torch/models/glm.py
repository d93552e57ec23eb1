"""GLM — the port of ``h2o3_tpu/models/glm.py``: the single-response
families (gaussian, binomial, quasibinomial, fractionalbinomial, poisson,
gamma, tweedie, negativebinomial) with solvers IRLSM and L_BFGS, the
multinomial family (cycling IRLS over the classes) and the ordinal family
(proportional odds), on designs with interaction columns and hashed
categoricals (``datainfo.py``).

IRLSM runs on the frame's device, in the JAX package's fused lane
(``H2O3_TPU_GLM_FUSE``, default ``auto`` = 8 iterations a chunk): the
design matrix is built on the device (``datainfo.py``), padded to the
shape bucket with a unit solve diagonal on the padded columns, and each
IRLS iteration — the row pass (link, variance, working response and
weights), the float32 Gram ``XᵀWX``/``XᵀWz`` and the float32 solve
(Cholesky with a jitter ladder without L1, the elastic-net ADMM with it) —
runs with its state (beta, the previous deviance, the iteration count and
the stop and non-finite flags) in device tensors, frozen by
``torch.where`` once the chunk is done, so a masked iteration changes
nothing. The host reads the chunk's state once per chunk; the ADMM solve
reads one pair of flags per block of 25 steps, and when those show the
chunk already stopped, the chunk ends there. A non-finite device solve
keeps the previous beta and sends the lambda to the host float64 lane,
as JAX does; ``H2O3_TPU_GLM_FUSE=0`` runs every iteration on that lane.

Multinomial: the same chunks, each iteration a cycle over the K classes
in place (class k's pass sees the classes already updated), one solve per
class on the shared solver of the width; the stop rule reads the last
class's -2 log-likelihood, and one non-finite class solve discards the
whole iteration and hands the fit to the host float64 cycling lane.

Ordinal: the negative log-likelihood and its gradient
(``torch.autograd``) on the device, minimized by JAX's BFGS on the device
(``bfgs.py``); a non-finite optimum, or ``H2O3_TPU_GLM_FUSE=0``, runs
scipy's L-BFGS-B on the host over the same device objective.

L_BFGS: the deviance and its gradient (``torch.autograd``) are one pass on
the device; scipy's L-BFGS-B drives it on the host, with JAX's null model,
lambda scale and elastic-net split.

Cross-validation (``nfolds``) runs the fold models through
``model_base._cross_validate``: each fold's design has the training's
width, so the folds reuse the cached ADMM solver of that width and the
fused chunk. Not ported yet (ROADMAP Queue A 5 and 6): the out-of-core
streamed lane and checkpoints (``checkpoint``, ``export_checkpoints_dir``);
the options raise ``NotImplementedError``. GLM never reads
``max_runtime_secs``, as in JAX.
"""

from __future__ import annotations

import itertools
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from h2o3_tpu_torch import config
from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import bfgs
from h2o3_tpu_torch.models.datainfo import MEAN_IMPUTATION, ColumnSpec, DataInfo
from h2o3_tpu_torch.models.glm_families import get_family
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.ops.gram import (
    AdmmSolver,
    admm_elastic_net,
    cho_solve_jitter_device,
    full_fp32,
    solve_cholesky,
    weighted_gram,
)

_BINOMIALS = ("binomial", "quasibinomial", "fractionalbinomial")

# one ADMM solver (fixed buffers and, on the card, one captured block of
# steps) per (device, width, non_negative): a warm training of a shape
# captures nothing
_ADMM_SOLVERS: dict = {}


def _admm_solver(p: int, device, non_negative: bool) -> AdmmSolver:
    key = (str(device), p, bool(non_negative))
    s = _ADMM_SOLVERS.get(key)
    if s is None:
        s = _ADMM_SOLVERS[key] = AdmmSolver(p, device,
                                            non_negative=non_negative)
    s.reads, s.blocks = 0, 0
    return s


def _glm_fuse_chunk(params) -> int:
    """Iterations per chunk (K); 0 = the per-iteration host-float64 lane.
    ``auto`` = 8, an integer = that K (JAX's ``_glm_fuse_chunk``)."""
    raw = config.get("H2O3_TPU_GLM_FUSE").strip().lower()
    if raw == "0":
        return 0
    k = int(raw) if raw.isdigit() else 8
    return max(k, 1)


def _glm_pad_cols(p_real: int) -> int:
    """Design width of the fused lane: a multiple of 4 under
    ``H2O3_TPU_SHAPE_BUCKETS``. Padded columns are all-zero with a unit
    solve diagonal, so their coefficients are exactly zero."""
    if config.get_bool("H2O3_TPU_SHAPE_BUCKETS"):
        return -(-p_real // 4) * 4
    return p_real


@dataclass
class GLMParams(CommonParams):
    family: str = "AUTO"
    link: str = "family_default"
    solver: str = "AUTO"  # -> IRLSM
    alpha: float | None = None
    lambda_: Any = None  # scalar, list, or None (auto)
    lambda_search: bool = False
    nlambdas: int = -1
    lambda_min_ratio: float = -1.0
    standardize: bool = True
    intercept: bool = True
    max_iterations: int = -1
    beta_epsilon: float = 1e-4
    objective_epsilon: float = 1e-6
    tweedie_variance_power: float = 0.0
    tweedie_link_power: float = 1.0
    theta: float = 1e-5
    missing_values_handling: str = MEAN_IMPUTATION
    compute_p_values: bool = False
    non_negative: bool = False
    interactions: Any = None
    interaction_pairs: Any = None
    hash_buckets: Any = None
    export_checkpoints_dir: str | None = None


def _fam_args(p: GLMParams) -> tuple:
    return (p.link, float(p.tweedie_variance_power or 1.5),
            float(p.tweedie_link_power), float(p.theta))


def _is_lbfgs(p: GLMParams) -> bool:
    return p.solver.upper().replace("-", "_") in ("L_BFGS", "LBFGS")


def _irls_weights(fam, X, y, w, offset, beta):
    """The row pass for the current beta: IRLS working weights W, working
    response z and the deviance (JAX's ``_irls_weights``)."""
    with full_fp32():
        eta = X @ beta + offset
    mu = fam.link.inv(eta)
    d = fam.link.dinv(eta)
    d = torch.where(d == 0, 1e-10,
                    torch.sign(d) * torch.clamp(torch.abs(d), min=1e-10))
    var = fam.variance(mu)
    z = (eta - offset) + (y - mu) / d
    W = w * d * d / var
    dev = fam.deviance(y, mu, w)
    return W, z, dev


def _irls_pass(fam, X, y, w, offset, beta):
    """One IRLS pass: the Gram and XᵀWz for ``beta``, and the deviance.
    The ``glm.rowpass`` and ``glm.gram`` spans let ``tools/profile_glm.py``
    attribute the card's time."""
    with record_function("glm.rowpass"):
        W, z, dev = _irls_weights(fam, X, y, w, offset, beta)
    with record_function("glm.gram"):
        G, b, _ = weighted_gram(X, W, z)
    return G, b, dev


def _deviance_pass(fam, X, y, w, offset, beta):
    with full_fp32():
        eta = X @ beta + offset
    return fam.deviance(y, fam.link.inv(eta), w)


def _multinomial_pass(X, Y1h, w, Beta, k: int):
    """The cycling-IRLS pass of class ``k`` (JAX's ``_multinomial_pass``):
    the softmax row pass at ``Beta`` (p x K), the class's working weights
    ``w·mu_k·(1-mu_k)`` and response, their Gram, and the -2
    log-likelihood of ``Beta``."""
    with record_function("glm.rowpass"):
        with full_fp32():
            Eta = X @ Beta
            eta_k = X @ Beta[:, k]
        Eta = Eta - torch.logsumexp(Eta, dim=1, keepdim=True)
        mu_k = torch.clamp(torch.exp(Eta[:, k]), 1e-10, 1 - 1e-10)
        wk = w * mu_k * (1 - mu_k)
        z = eta_k + (Y1h[:, k] - mu_k) / torch.clamp(
            wk / torch.clamp(w, min=1e-10), min=1e-10)
        ll = torch.sum(w * torch.sum(Y1h * Eta, dim=1))
    with record_function("glm.gram"):
        G, b, _ = weighted_gram(X, wk, z)
    return G, b, -2.0 * ll


def ordinal_nll(X, yi, w, params, K: int):
    """The proportional-odds negative log-likelihood (JAX's
    ``_ordinal_nll_grad``): cuts ``theta = cumsum([raw_0, exp(raw_1:)])``,
    ``P(y<=j) = sigmoid(theta_j - x·beta)``, the class probability
    ``clip(hi - lo, 1e-12, 1)`` of each row's class (``yi``, int64)."""
    P = X.shape[1]
    b, raw = params[:P], params[P:]
    theta = torch.cumsum(torch.cat([raw[:1], torch.exp(raw[1:])]), 0)
    with full_fp32():
        eta = X @ b
    cum = torch.sigmoid(theta[None, :] - eta[:, None])
    n = X.shape[0]
    ones = torch.ones((n, 1), dtype=cum.dtype, device=cum.device)
    bounds = torch.cat([torch.zeros_like(ones), cum, ones], dim=1)
    lo_hi = torch.gather(bounds, 1, torch.stack([yi, yi + 1], dim=1))
    pk = torch.clamp(lo_hi[:, 1] - lo_hi[:, 0], 1e-12, 1.0)
    return -torch.sum(w * torch.log(pk))


def _ordinal_probs(X, beta, theta) -> torch.Tensor:
    """(n, K) unnormalised class probabilities ``clip(hi - lo, 1e-12, 1)``
    of an ordinal model, in float64 on X's device."""
    eta = X.double() @ torch.as_tensor(beta, dtype=torch.float64,
                                       device=X.device)
    th = torch.as_tensor(theta, dtype=torch.float64, device=X.device)
    cum = 1.0 / (1.0 + torch.exp(-(th[None, :] - eta[:, None])))
    z = torch.zeros((len(eta), 1), dtype=torch.float64, device=X.device)
    return torch.clamp(torch.cat([cum, z + 1], 1) - torch.cat([z, cum], 1),
                       1e-12, 1.0)


def _lambda_sequence(p: GLMParams, lambda_max: float, nobs: float, P: int):
    """Explicit values, the lambda_search geometric path, or the default
    ``lambda_max/1e3``."""
    if p.lambda_ is not None:
        return np.atleast_1d(np.asarray(p.lambda_, np.float64))
    if p.lambda_search:
        nl = p.nlambdas if p.nlambdas > 0 else 100
        ratio = p.lambda_min_ratio if p.lambda_min_ratio > 0 else (
            1e-4 if nobs > P else 1e-2)
        return np.geomspace(lambda_max, lambda_max * ratio, nl)
    return np.array([lambda_max / 1e3])


def _offset_col(params, frame: Frame) -> torch.Tensor:
    if params.offset_column:
        return torch.nan_to_num(frame.vec(params.offset_column).data)
    return torch.zeros(frame.nrow, dtype=torch.float32, device=frame.device)


def interaction_pairs(p: GLMParams) -> list[tuple[str, str]]:
    """The interaction columns: every 2-combination of ``interactions``,
    then ``interaction_pairs``."""
    pairs = []
    if p.interactions:
        pairs += list(itertools.combinations(
            [str(c) for c in p.interactions], 2))
    if p.interaction_pairs:
        pairs += [(str(a), str(b)) for a, b in p.interaction_pairs]
    return pairs


def training_inputs(p: GLMParams, train: Frame, x: list[str], fuse_k: int,
                    intercept: bool | None = None):
    """``(datainfo, X, y, w, offset)`` of a training, all on the frame's
    device: the design (padded to the shape bucket on the fused lane; with
    the interaction and hashed columns; an intercept column unless
    ``intercept`` is False — ordinal's cuts are its intercepts), the
    response with NAs as 0, the weights (0 on NA responses and skipped
    rows) and the offset — JAX's ``GLM._build`` without its host pulls."""
    with record_function("glm.setup"):
        di = DataInfo.fit(
            train, x, standardize=p.standardize,
            use_all_factor_levels=False,
            missing_handling=p.missing_values_handling,
            add_intercept=p.intercept if intercept is None else intercept,
            interaction_pairs=interaction_pairs(p) or None,
            hash_buckets=int(p.hash_buckets) if p.hash_buckets else None)
        P = di.ncols_expanded
    with record_function("glm.transform"):
        X, valid_mask = di.transform(
            train, pad_to=_glm_pad_cols(P) if fuse_k else P)
    with record_function("glm.setup"):
        yv = train.vec(p.response_column)
        yd = yv.data.to(torch.float32)
        if yv.is_categorical():
            yd = torch.where(yv.data < 0, float("nan"), yd)
        yna = torch.isnan(yd)
        y = torch.where(yna, 0.0, yd)
        w = valid_mask
        if p.weights_column:
            w = w * torch.nan_to_num(train.vec(p.weights_column).data)
        w = w * (1.0 - yna.to(torch.float32))  # NA responses: weight 0
    return di, X, y, w, _offset_col(p, train)


class GLMModel(Model):
    algo = "glm"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """On the frame's device: (n, K) softmax probabilities of a
        multinomial model, (n, K) unnormalised class probabilities of an
        ordinal one (float64, as JAX computes them), (n, 2) class
        probabilities of a binomial classifier, else the (n,) mean
        response."""
        di: DataInfo = self.output["datainfo"]
        X, _ = di.transform(frame)
        if self.output.get("ordinal"):
            return _ordinal_probs(X, self.output["beta_std"],
                                  self.output["theta"])
        if self.output.get("multinomial"):
            B = torch.as_tensor(np.asarray(self.output["beta_multinomial_std"]),
                                dtype=torch.float32, device=X.device)
            with full_fp32():
                return torch.softmax(X @ B, dim=1)
        beta = torch.as_tensor(np.asarray(self.output["beta_std"]),
                               dtype=torch.float32, device=X.device)
        with full_fp32():
            eta = X @ beta + _offset_col(self.params, frame)
        mu = self.output["family_obj"].link.inv(eta)
        if self.is_classifier:
            return torch.stack([1 - mu, mu], dim=1)
        return mu

    @property
    def coef(self) -> dict:
        return dict(zip(self.output["coef_names"], self.output["beta_orig"]))

    def coef_norm(self) -> dict:
        return dict(zip(self.output["coef_names"],
                        self.output["beta_std_report"]))

    @property
    def null_deviance(self) -> float:
        return self.output.get("null_deviance", float("nan"))

    @property
    def residual_deviance(self) -> float:
        return self.output["residual_deviance"]

    @property
    def regularization_path(self) -> list:
        return self.output.get("regularization_path", [])

    def _distribution_for_metrics(self) -> str:
        return {"poisson": "poisson", "gamma": "gamma"}.get(
            self.output["family"], "gaussian")


def _stats() -> dict:
    """A training's loop accounting, kept in ``output["irls_stats"]``:
    iterations (IRLS — a multinomial iteration is one cycle over the
    classes —, L-BFGS's or BFGS's), chunks, host reads of the fit (nobs,
    mu0, the null pass, one per chunk, one per ADMM block, one per lambda's
    final deviance; a multinomial host iteration: one per class; L-BFGS:
    one per evaluation; BFGS: one per block of steps), iterations the
    device ran on frozen state, ADMM blocks and the steps of each solve
    (multinomial: each class's), fits sent to the host float64 lane
    (lambdas, a multinomial fit, an ordinal fit) and the iterations run
    there. An ordinal fit adds ``bfgs``: its evaluations, steps, masked
    steps, reads, status and stop reason."""
    return {"iterations": 0, "chunks": 0, "host_reads": 0,
            "masked_iterations": 0, "admm_blocks": 0, "admm_steps": [],
            "fallbacks": 0, "host_iterations": 0}


class GLM(ModelBuilder):
    """``h2o.glm`` builder."""

    algo = "glm"
    PARAMS_CLS = GLMParams
    PARAM_ALIASES = {"lambda": "lambda_"}

    @staticmethod
    def free_graphs() -> None:
        """Release the ADMM solvers' CUDA graphs and buffers."""
        _ADMM_SOLVERS.clear()

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: GLMParams = self.params
        unported = {
            "checkpoint": p.checkpoint is not None,
            "export_checkpoints_dir": bool(p.export_checkpoints_dir),
        }
        bad = sorted(k for k, v in unported.items() if v)
        if bad:
            raise NotImplementedError(
                f"GLM options not ported yet (ROADMAP Queue A 5): {bad}")
        yv = train.vec(p.response_column)
        family = p.family.lower()
        if family == "auto":
            if yv.is_categorical():
                family = "binomial" if yv.cardinality <= 2 else "multinomial"
            else:
                family = "gaussian"
        classification = (family in ("binomial", "multinomial", "ordinal")
                          and yv.is_categorical())
        lbfgs = _is_lbfgs(p) and family not in ("multinomial", "ordinal")
        fuse_k = 0 if lbfgs else _glm_fuse_chunk(p)

        if family == "ordinal":
            # the K-1 ordered cuts are the intercepts: no intercept column,
            # no padding (BFGS's parameters are the design's columns)
            di, X, y, w, offset = training_inputs(p, train, self._x, 0,
                                                  intercept=False)
        else:
            di, X, y, w, offset = training_inputs(p, train, self._x, fuse_k)
        nobs = float(w.sum())
        p_pad = X.shape[1]

        if family == "multinomial":
            out = self._fit_multinomial(X, y, w, di, yv.cardinality, p, nobs,
                                        fuse_k)
        elif family == "ordinal":
            out = self._fit_ordinal(X, y, w, di, yv.cardinality, p, fuse_k)
        elif lbfgs:
            out = self._fit_lbfgs(X, y, w, offset, di, p, family, nobs)
        else:
            out = self._fit_irls(X, y, w, offset, di, p, family, nobs,
                                 fuse_k, p_pad)
        out["datainfo"] = di
        out["response_domain"] = tuple(yv.domain) if classification else None
        out["names"] = list(self._x)
        out["link"] = p.link
        model = GLMModel(None, p, out)
        del X
        with record_function("glm.metrics"):
            model.training_metrics = model._score_metrics(train)
            if valid is not None:
                model.validation_metrics = model._score_metrics(valid)
        return model

    # -- IRLSM --------------------------------------------------------------
    def _fit_irls(self, X, y, w, offset, di, p: GLMParams, family, nobs,
                  fuse_k, p_pad):
        fam_args = _fam_args(p)
        fam = get_family(family, *fam_args)
        dev = X.device
        P = di.ncols_expanded
        icpt = P - 1 if p.intercept else None
        icpt_i = icpt if icpt is not None else -1
        alpha = 0.5 if p.alpha is None else float(p.alpha)
        max_iter = p.max_iterations if p.max_iterations > 0 else 50
        st = _stats()
        f32 = dict(dtype=torch.float32, device=dev)

        st["host_reads"] += 1  # nobs, read by _build
        with record_function("glm.setup"):
            beta = np.zeros(P, np.float64)
            if p.intercept:
                mu0 = float(torch.sum(w * y)
                            / torch.clamp(torch.sum(w), min=1e-10))
                if family in _BINOMIALS:
                    mu0 = min(max(mu0, 1e-4), 1 - 1e-4)
                beta[icpt] = float(fam.link.fwd(
                    torch.tensor(mu0, dtype=torch.float32)))
                st["host_reads"] += 1

        def pad_beta(b64):
            return np.concatenate([b64, np.zeros(p_pad - P)]) if p_pad > P else b64

        def to_dev(b64):
            return torch.as_tensor(pad_beta(b64), **f32)

        def gram_pass(b64):
            """G (P, P), b (P,) and the deviance on the host in float64."""
            G, b, d = _irls_pass(fam, X, y, w, offset, to_dev(b64))
            st["host_reads"] += 1
            packed = torch.cat([G[:P, :P].reshape(-1), b[:P], d[None]]
                               ).double().cpu().numpy()
            return (packed[: P * P].reshape(P, P), packed[P * P: P * P + P],
                    float(packed[-1]))

        def host_iteration(b64, l1, l2):
            """One IRLS iteration with the float64 host solve."""
            G, b, d = gram_pass(b64)
            if l1 > 0:
                beta_new = admm_elastic_net(G, b, l1, l2, icpt,
                                            non_negative=p.non_negative)
            else:
                Gp = G + l2 * np.eye(P)
                if icpt is not None:
                    Gp[icpt, icpt] -= l2
                beta_new = solve_cholesky(Gp, b)
                if p.non_negative:
                    mask = np.arange(P) != icpt_i
                    beta_new = np.where(mask & (beta_new < 0), 0.0, beta_new)
            st["host_iterations"] += 1
            return beta_new, d, float(np.max(np.abs(beta_new - b64)))

        with record_function("glm.setup"):
            G0, b0, dev0 = gram_pass(beta)
            g0 = b0 - G0 @ beta
            g0_pen = np.delete(g0, icpt) if icpt is not None else g0
            lambda_max = float(np.max(np.abs(g0_pen)) / max(alpha, 1e-3)
                               / max(nobs, 1.0))
            lambdas = _lambda_sequence(p, lambda_max, nobs, P)
            ar = torch.arange(p_pad, device=dev)
            pad_diag = (ar >= P).to(torch.float32)
            penal = torch.where(ar == icpt_i, 0.0, 1.0)
            beta_eps = torch.tensor(p.beta_epsilon, **f32)
            obj_eps = torch.tensor(p.objective_epsilon, **f32)

        best = None
        null_dev = float(dev0)
        path = []
        admm = None
        for li, lam in enumerate(lambdas):
            l1 = lam * alpha * nobs
            l2 = lam * (1 - alpha) * nobs
            l1_t = torch.tensor(l1, **f32)
            l2_t = torch.tensor(l2, **f32)
            if fuse_k and l1 > 0 and admm is None:
                admm = _admm_solver(p_pad, dev, p.non_negative)
            dev_prev = np.inf
            iters_done = 0
            fused_ok = bool(fuse_k)
            beta_d = to_dev(beta) if fuse_k else None
            dev_prev_d = torch.tensor(np.inf, **f32)
            with record_function("glm.lambda"):
                while iters_done < max_iter:
                    if fused_ok:
                        kmax = min(fuse_k, max_iter - iters_done)
                        with record_function("glm.chunk"):
                            beta_d, dev_prev_d, packed = self._chunk(
                                fam, X, y, w, offset, beta_d, dev_prev_d,
                                kmax, l1 > 0, l1_t, l2_t, penal, pad_diag,
                                icpt_i, P, beta_eps, obj_eps, admm,
                                p.non_negative, st)
                        n_done, stop, bad = (int(packed[0]), bool(packed[1]),
                                             bool(packed[2]))
                        st["chunks"] += 1
                        st["host_reads"] += 1
                        if n_done:
                            beta = packed[4:4 + P].copy()
                            dev_prev = float(packed[3])
                        iters_done += n_done
                        if bad:
                            # a non-finite float32 solve: this lambda goes
                            # on in the host float64 lane
                            st["fallbacks"] += 1
                            fused_ok = False
                        if stop:
                            break
                        continue
                    beta_new, dev_now, delta = host_iteration(beta, l1, l2)
                    beta = beta_new
                    iters_done += 1
                    stop = delta < p.beta_epsilon or abs(dev_prev - dev_now) / max(
                        abs(dev_now), 1e-10) < p.objective_epsilon
                    if stop:
                        break
                    dev_prev = dev_now
                st["iterations"] += iters_done
                dev_final = float(_deviance_pass(fam, X, y, w, offset,
                                                 to_dev(beta)))
                st["host_reads"] += 1
            expl = 1 - dev_final / max(null_dev, 1e-30)
            path.append({"lambda": float(lam), "deviance": dev_final,
                         "dev_ratio": expl, "iters": iters_done})
            if best is None or dev_final <= best["deviance"]:
                best = {"lambda": float(lam), "beta": beta.copy(),
                        "deviance": dev_final}
            if p.lambda_search and expl > 0.999:
                break

        if admm is not None:
            st["admm_blocks"] = admm.blocks
            st["host_reads"] += admm.reads
        if st["admm_steps"]:  # one read: the steps of each active solve
            steps = torch.stack(st["admm_steps"]).cpu().numpy()
            st["admm_steps"] = [int(v) for v in steps if v >= 0]
        beta = best["beta"]
        out = _coef_output(beta, di, p)
        out.update(
            family=family, family_obj=fam, null_deviance=null_dev,
            residual_deviance=best["deviance"], lambda_best=best["lambda"],
            lambda_max=lambda_max, alpha=alpha, regularization_path=path,
            multinomial=False, irls_stats=st,
        )
        if p.compute_p_values:
            out.update(_p_values(fam, X, y, w, offset, beta, di, nobs))
        return out

    @staticmethod
    def _chunk(fam, X, y, w, offset, beta, dev_prev, kmax, l1_on, l1, l2,
               penal, pad_diag, icpt, P, beta_eps, obj_eps, admm,
               non_negative, st):
        """Up to ``kmax`` IRLS iterations on the device, JAX's fused chunk:
        each iteration runs only while neither ``stop`` nor ``bad`` is set
        (a masked iteration keeps the state). Returns the new beta and
        previous deviance (device) and the chunk's state in one host read:
        [iterations done, stop, bad, previous deviance, beta[:P]]."""
        dev = X.device
        it = torch.zeros((), dtype=torch.int32, device=dev)
        stop = torch.zeros((), dtype=torch.bool, device=dev)
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        ar = torch.arange(beta.shape[0], device=dev)
        ran = 0
        for _ in range(kmax):
            ran += 1
            frozen = stop | bad
            G, b, d = _irls_pass(fam, X, y, w, offset, beta)
            with record_function("glm.solve"):
                if l1_on:
                    beta_new, ok = admm.solve(G, b, l1, l2, icpt, pad_diag,
                                              P, frozen=frozen)
                    st["admm_steps"].append(torch.where(frozen, -1, admm.i))
                else:
                    # the ridge with the intercept unpenalized, plus the
                    # unit diagonal of the padded columns
                    beta_new, ok = cho_solve_jitter_device(
                        G, b, l2 * penal + pad_diag)
                    if non_negative:
                        beta_new = torch.where(
                            (ar != icpt) & (beta_new < 0), 0.0, beta_new)
            bad_new = ~ok | ~torch.isfinite(beta_new).all()
            delta = torch.max(torch.abs(beta_new - beta))
            stop_new = ~bad_new & (
                (delta < beta_eps)
                | (torch.abs(dev_prev - d)
                   / torch.clamp(torch.abs(d), min=1e-10) < obj_eps))
            act = ~frozen
            beta = torch.where(act & ~bad_new, beta_new, beta)
            dev_prev = torch.where(act & ~(stop_new | bad_new), d, dev_prev)
            it = it + (act & ~bad_new).to(torch.int32)
            stop = stop | (act & stop_new)
            bad = bad | (act & bad_new)
            if l1_on and admm.last_frozen:
                break  # the ADMM's block read showed the chunk had stopped
        packed = torch.cat([torch.stack([it.double(), stop.double(),
                                         bad.double(), dev_prev.double()]),
                            beta[:P].double()]).cpu().numpy()
        st["masked_iterations"] += ran - int(packed[0]) - int(packed[2])
        return beta, dev_prev, packed

    # -- multinomial ----------------------------------------------------------
    def _fit_multinomial(self, X, y, w, di, K: int, p: GLMParams, nobs,
                         fuse_k):
        """JAX's ``_fit_multinomial``: the cycling IRLS over the K classes
        from Beta = 0, on the fused lane in chunks, after a non-finite
        class solve (and under ``H2O3_TPU_GLM_FUSE=0``) on the host float64
        lane. Only the first ``lambda_`` is used (unset: 0, the Cholesky
        solve), ``max_iterations`` defaults to 30."""
        dev = X.device
        P = di.ncols_expanded
        p_pad = X.shape[1]
        icpt = P - 1 if p.intercept else None
        icpt_i = icpt if icpt is not None else -1
        alpha = 0.5 if p.alpha is None else float(p.alpha)
        lam = 0.0
        if p.lambda_ is not None:
            lam = float(np.atleast_1d(np.asarray(p.lambda_))[0])
        max_iter = p.max_iterations if p.max_iterations > 0 else 30
        l1 = lam * alpha * nobs
        l2 = lam * (1 - alpha) * nobs
        st = _stats()
        st["host_reads"] += 1  # nobs, read by _build
        f32 = dict(dtype=torch.float32, device=dev)
        with record_function("glm.setup"):
            Y1h = ((y[:, None] == torch.arange(K, device=dev)[None, :])
                   .to(torch.float32) * (w[:, None] > 0))
            ar = torch.arange(p_pad, device=dev)
            pad_diag = (ar >= P).to(torch.float32)
            penal = torch.where(ar == icpt_i, 0.0, 1.0)
            l1_t, l2_t = torch.tensor(l1, **f32), torch.tensor(l2, **f32)
            obj_eps = torch.tensor(p.objective_epsilon, **f32)
        admm = (_admm_solver(p_pad, dev, p.non_negative)
                if fuse_k and l1 > 0 else None)

        Beta = np.zeros((P, K), np.float64)
        Beta_d = torch.zeros((p_pad, K), **f32)
        ll_prev, ll_prev_d = np.inf, torch.tensor(np.inf, **f32)
        it = 0
        fused_ok = bool(fuse_k)
        stop = False
        with record_function("glm.lambda"):
            while it < max_iter and not stop:
                if fused_ok:
                    kmax = min(fuse_k, max_iter - it)
                    with record_function("glm.chunk"):
                        Beta_d, ll_prev_d, packed = self._multinomial_chunk(
                            X, Y1h, w, Beta_d, ll_prev_d, kmax, l1 > 0, l1_t,
                            l2_t, penal, pad_diag, icpt_i, P, obj_eps, admm,
                            p.non_negative, st)
                    n_done, stop, bad = (int(packed[0]), bool(packed[1]),
                                         bool(packed[2]))
                    st["chunks"] += 1
                    st["host_reads"] += 1
                    if n_done:
                        Beta = packed[4:].reshape(P, K).copy()
                        ll_prev = float(packed[3])
                    it += n_done
                    if bad:
                        # a non-finite float32 class solve: the fit goes on
                        # in the host float64 cycling lane
                        st["fallbacks"] += 1
                        fused_ok = False
                    continue
                # the host float64 cycling lane: one read per class pass
                for k in range(K):
                    Bd = torch.zeros((p_pad, K), **f32)
                    Bd[:P] = torch.as_tensor(Beta, **f32)
                    G, b, m2ll = _multinomial_pass(X, Y1h, w, Bd, k)
                    packed = torch.cat([G[:P, :P].reshape(-1), b[:P],
                                        m2ll[None]]).double().cpu().numpy()
                    st["host_reads"] += 1
                    G64 = packed[: P * P].reshape(P, P)
                    b64 = packed[P * P: P * P + P]
                    if l1 > 0:
                        Beta[:, k] = admm_elastic_net(G64, b64, l1, l2, icpt)
                    else:
                        Gp = G64 + l2 * np.eye(P)
                        if icpt is not None:
                            Gp[icpt, icpt] -= l2
                        Beta[:, k] = solve_cholesky(Gp, b64)
                ll_now = float(packed[-1])
                it += 1
                st["host_iterations"] += 1
                stop = (abs(ll_prev - ll_now) / max(abs(ll_now), 1e-10)
                        < p.objective_epsilon)
                if not stop:
                    ll_prev = ll_now
        st["iterations"] = it
        if admm is not None:
            st["admm_blocks"] = admm.blocks
            st["host_reads"] += admm.reads
        if st["admm_steps"]:  # one read: the steps of each active solve
            steps = torch.stack(st["admm_steps"]).cpu().numpy()
            st["admm_steps"] = [int(v) for v in steps if v >= 0]
        out = _multinomial_output(di, Beta)
        out.update(residual_deviance=ll_prev, irls_stats=st)
        return out

    @staticmethod
    def _multinomial_chunk(X, Y1h, w, Beta, ll_prev, kmax, l1_on, l1, l2,
                           penal, pad_diag, icpt, P, obj_eps, admm,
                           non_negative, st):
        """Up to ``kmax`` multinomial iterations on the device, JAX's fused
        multinomial chunk: each a cycle over the classes in place, each
        class solved by the Cholesky ladder (``l2·penal + pad_diag``) or
        the shared ADMM solver; a non-finite class solve keeps that class
        and discards the whole iteration; the stop rule reads the last
        class's -2LL. An iteration of a stopped chunk is masked. Returns
        Beta and the previous -2LL (device) and the chunk's state in one
        host read: [iterations done, stop, bad, previous -2LL, Beta[:P]
        row-major]."""
        dev = X.device
        K = Y1h.shape[1]
        it = torch.zeros((), dtype=torch.int32, device=dev)
        stop = torch.zeros((), dtype=torch.bool, device=dev)
        bad = torch.zeros((), dtype=torch.bool, device=dev)
        ar = torch.arange(Beta.shape[0], device=dev)
        cols = torch.arange(K, device=dev)
        ran = 0
        for _ in range(kmax):
            ran += 1
            frozen = stop | bad
            Beta0 = Beta
            bad_it = torch.zeros((), dtype=torch.bool, device=dev)
            ended = False
            for k in range(K):
                G, b, m2ll = _multinomial_pass(X, Y1h, w, Beta, k)
                with record_function("glm.solve"):
                    if l1_on:
                        beta_k, ok = admm.solve(G, b, l1, l2, icpt, pad_diag,
                                                P, frozen=frozen)
                        st["admm_steps"].append(
                            torch.where(frozen, -1, admm.i))
                    else:
                        beta_k, ok = cho_solve_jitter_device(
                            G, b, l2 * penal + pad_diag)
                        if non_negative:
                            beta_k = torch.where(
                                (ar != icpt) & (beta_k < 0), 0.0, beta_k)
                bad_k = ~ok | ~torch.isfinite(beta_k).all()
                Beta = torch.where(bad_k | (cols != k)[None, :], Beta,
                                   beta_k[:, None])
                bad_it = bad_it | bad_k
                if l1_on and admm.last_frozen:
                    # the ADMM's block read showed the chunk had stopped
                    # before this iteration: the chunk ends here, the
                    # iteration's class updates discarded
                    ended = True
                    break
            if ended:
                Beta = Beta0
                break
            stop_new = ~bad_it & (
                torch.abs(ll_prev - m2ll)
                / torch.clamp(torch.abs(m2ll), min=1e-10) < obj_eps)
            act = ~frozen
            Beta = torch.where(act & ~bad_it, Beta, Beta0)
            ll_prev = torch.where(act & ~(stop_new | bad_it), m2ll, ll_prev)
            it = it + (act & ~bad_it).to(torch.int32)
            stop = stop | (act & stop_new)
            bad = bad | (act & bad_it)
        packed = torch.cat([torch.stack([it.double(), stop.double(),
                                         bad.double(), ll_prev.double()]),
                            Beta[:P].double().reshape(-1)]).cpu().numpy()
        st["masked_iterations"] += ran - int(packed[0]) - int(packed[2])
        return Beta, ll_prev, packed

    # -- ordinal (proportional odds) -------------------------------------------
    def _fit_ordinal(self, X, y, w, di, K: int, p: GLMParams, fuse_k):
        """JAX's ``_fit_ordinal``: BFGS on the device from zero betas and
        cuts ``raw = [-1, 0, ...]``; a non-finite optimum, or
        ``H2O3_TPU_GLM_FUSE=0``, runs scipy's L-BFGS-B on the host over the
        device objective (one host read per evaluation)."""
        from scipy import optimize as spo

        if p.offset_column:
            raise ValueError("ordinal does not support offset_column")
        if p.compute_p_values:
            raise ValueError("compute_p_values requires solver=IRLSM")
        if p.lambda_search:
            raise ValueError("lambda_search is not supported for ordinal")
        if p.lambda_ is not None and float(
                np.atleast_1d(np.asarray(p.lambda_))[0]) > 0:
            warnings.warn("ordinal fits unpenalized; lambda_ is ignored")
        if K < 2:
            raise ValueError(
                "ordinal needs a categorical response with >=2 levels")
        P = di.ncols_expanded
        st = _stats()
        st["host_reads"] += 1  # nobs, read by _build
        f32 = dict(dtype=torch.float32, device=X.device)
        yi = torch.clamp(y.to(torch.int64), 0, K - 1)
        raw0 = np.zeros(K - 1)
        raw0[0] = -1.0
        x0 = np.concatenate([np.zeros(P), raw0])
        maxiter = p.max_iterations if p.max_iterations > 0 else 200

        def nll(params):
            return ordinal_nll(X, yi, w, params, K)

        x_fit = fun_val = None
        if fuse_k:
            with record_function("glm.bfgs"):
                res = bfgs.minimize_bfgs(bfgs.value_and_grad(nll),
                                         torch.as_tensor(x0, **f32), maxiter)
            st["iterations"] = res.iterations
            st["host_reads"] += res.reads
            st["bfgs"] = {"evaluations": res.evaluations, "steps": res.steps,
                          "masked_steps": res.masked_steps,
                          "reads": res.reads, "status": res.status,
                          "stop": res.stop}
            if res.ok:
                x_fit, fun_val = res.x, res.fun
            else:
                st["fallbacks"] += 1
        if x_fit is None:
            fg = bfgs.value_and_grad(nll)

            def fun(params):
                val, g = fg(torch.as_tensor(params, **f32))
                st["host_reads"] += 1
                packed = torch.cat([val[None], g]).double().cpu().numpy()
                return float(packed[0]), packed[1:]

            with record_function("glm.lbfgs"):
                res = spo.minimize(fun, x0, jac=True, method="L-BFGS-B",
                                   options={"maxiter": maxiter})
            x_fit, fun_val = res.x, float(res.fun)
            st["host_iterations"] += int(res.nit)
            st["iterations"] += int(res.nit)
        beta, raw = x_fit[:P], x_fit[P:]
        theta = np.cumsum(np.concatenate([raw[:1], np.exp(raw[1:])]))
        out = _coef_output(beta, di, p, has_intercept=False)
        out.update(
            family="ordinal", family_obj=get_family("binomial"),
            ordinal=True,
            theta=theta,  # the standardized scale, what predict uses
            # the cuts on the original scale: the same cumulatives from
            # the original-scale linear predictor
            theta_orig=theta + out["destandardize_shift"],
            residual_deviance=2.0 * fun_val, null_deviance=float("nan"),
            multinomial=False, irls_stats=st)
        return out

    # -- L-BFGS -------------------------------------------------------------
    def _fit_lbfgs(self, X, y, w, offset, di, p: GLMParams, family, nobs):
        from scipy import optimize as spo

        if p.compute_p_values:
            raise ValueError("compute_p_values requires solver=IRLSM")
        fam = get_family(family, *_fam_args(p))
        P = di.ncols_expanded
        icpt = P - 1 if p.intercept else None
        alpha = 0.5 if p.alpha is None else float(p.alpha)
        st = _stats()
        f32 = dict(dtype=torch.float32, device=X.device)

        def dev_grad(b64):
            """Deviance and its gradient at ``b64``: one device pass, one
            host read."""
            b = torch.as_tensor(np.asarray(b64), **f32).requires_grad_(True)
            with full_fp32():
                eta = X @ b + offset
            val = fam.deviance(y, fam.link.inv(eta), w)
            (g,) = torch.autograd.grad(val, b)
            st["host_reads"] += 1
            packed = torch.cat([val.detach()[None], g]).double().cpu().numpy()
            return float(packed[0]), packed[1:]

        beta0 = np.zeros(P, np.float64)
        if p.intercept:
            mu0 = float(torch.sum(w * y) / torch.clamp(torch.sum(w), min=1e-10))
            if family in _BINOMIALS:
                mu0 = min(max(mu0, 1e-4), 1 - 1e-4)
            beta0[icpt] = float(fam.link.fwd(
                torch.tensor(mu0, dtype=torch.float32)))
        null_dev, g_dev0 = dev_grad(beta0)
        # lambda_max from the null gradient on the half-deviance scale
        g_half = g_dev0 / 2.0
        g_pen = np.delete(g_half, icpt) if icpt is not None else g_half
        lambda_max = float(np.max(np.abs(g_pen)) / max(alpha, 1e-3)
                           / max(nobs, 1.0))
        lambdas = _lambda_sequence(p, lambda_max, nobs, P)
        maxiter = p.max_iterations if p.max_iterations > 0 else 200
        l1_mask = np.ones(P)
        if icpt is not None:
            l1_mask[icpt] = 0.0

        def smooth(b, l2):
            val, g = dev_grad(b)
            pen = np.asarray(b, np.float64) * l1_mask
            return val + l2 * float(pen @ pen), g + 2.0 * l2 * pen

        def solve_one(lam, beta_init):
            """One elastic-net L-BFGS solve, warm-started: on the deviance
            scale l2 = lam(1-alpha)N on ||b||² and l1 = 2 lam alpha N on
            ||b||₁, the L1 part as the bound-constrained split b = b+ - b-."""
            l2 = lam * (1 - alpha) * nobs
            l1 = 2.0 * lam * alpha * nobs
            if l1 > 0:
                l1_vec = l1 * l1_mask

                def fun2(zz):
                    bp, bn = zz[:P], zz[P:]
                    val, g = smooth(bp - bn, l2)
                    val += float(l1_vec @ (bp + bn))
                    return val, np.concatenate([g + l1_vec, -g + l1_vec])

                z0 = np.concatenate([np.maximum(beta_init, 0.0),
                                     np.maximum(-beta_init, 0.0)])
                res = spo.minimize(fun2, z0, jac=True, method="L-BFGS-B",
                                   bounds=[(0.0, None)] * (2 * P),
                                   options={"maxiter": maxiter})
                b = res.x[:P] - res.x[P:]
                b[np.abs(b) < 1e-10] = 0.0
                return b, int(res.nit)
            res = spo.minimize(lambda bb: smooth(bb, l2), beta_init, jac=True,
                               method="L-BFGS-B", options={"maxiter": maxiter})
            return res.x, int(res.nit)

        best = None
        path = []
        beta = beta0.copy()
        for lam_i in lambdas:
            with record_function("glm.lambda"):
                beta, nit = solve_one(float(lam_i), beta)
                st["iterations"] += nit
                dev_i = float(_deviance_pass(fam, X, y, w, offset,
                                             torch.as_tensor(beta, **f32)))
                st["host_reads"] += 1
            expl = 1 - dev_i / max(null_dev, 1e-30)
            path.append({"lambda": float(lam_i), "deviance": dev_i,
                         "dev_ratio": expl})
            if best is None or dev_i <= best["deviance"]:
                best = {"lambda": float(lam_i), "beta": beta.copy(),
                        "deviance": dev_i}
            if p.lambda_search and expl > 0.999:
                break

        out = _coef_output(best["beta"], di, p)
        out.update(
            family=family, family_obj=fam, null_deviance=null_dev,
            residual_deviance=best["deviance"], lambda_best=best["lambda"],
            lambda_max=lambda_max, alpha=alpha, regularization_path=path,
            multinomial=False, solver="L_BFGS", irls_stats=st,
        )
        return out


def _coef_output(beta_std, di: DataInfo, p: GLMParams,
                 has_intercept: bool | None = None) -> dict:
    """Coefficients back on the original scale (JAX's ``_coef_output``).
    ``has_intercept`` overrides ``p.intercept`` for a design with no
    intercept column (ordinal); the accumulated shift is returned."""
    if has_intercept is None:
        has_intercept = p.intercept
    names = di.coef_names()
    beta_std = np.asarray(beta_std, np.float64)
    beta_orig = beta_std.copy()
    shift = 0.0
    if p.standardize:
        for c in di.columns:
            if c.kind == "num":
                beta_orig[c.offset] = beta_std[c.offset] / c.sigma
                shift += beta_std[c.offset] * c.mean / c.sigma
        if has_intercept:
            beta_orig[-1] = beta_std[-1] - shift
    return {
        "coef_names": names,
        "beta_std": beta_std,
        "beta_std_report": beta_std,
        "beta_orig": beta_orig,
        "destandardize_shift": shift,
    }


def _multinomial_output(di: DataInfo, Beta) -> dict:
    """A multinomial fit's outputs (JAX's ``_multinomial_output``): the
    (P, K) standardized coefficients; ``beta_std``, ``beta_orig`` and the
    coefficient table report the last class's column, as JAX does."""
    Beta = np.asarray(Beta, np.float64)
    return {
        "coef_names": di.coef_names(),
        "beta_multinomial_std": Beta,
        "beta_std": Beta[:, -1],
        "beta_orig": Beta[:, -1],
        "beta_std_report": Beta[:, -1],
        "family": "multinomial",
        "family_obj": get_family("binomial"),
        "multinomial": True,
    }


def _p_values(fam, X, y, w, offset, beta, di, nobs) -> dict:
    """Standard errors, z values and p-values from the Gram at the fitted
    beta (JAX's ``_p_values``)."""
    from scipy import stats as sps

    P = int(np.shape(beta)[0])
    b = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    b[:P] = torch.as_tensor(beta, dtype=torch.float32)
    G, _, d = _irls_pass(fam, X, y, w, offset, b)
    G = G[:P, :P].double().cpu().numpy()
    try:
        inv = np.linalg.inv(G)
    except np.linalg.LinAlgError:
        inv = np.linalg.pinv(G)
    dispersion = 1.0
    if not fam.dispersion_fixed:
        dispersion = float(d) / max(nobs - P, 1.0)
    se = np.sqrt(np.maximum(np.diag(inv) * dispersion, 0.0))
    z = np.asarray(beta, np.float64) / np.maximum(se, 1e-30)
    if fam.dispersion_fixed:
        pv = 2 * sps.norm.sf(np.abs(z))
    else:
        pv = 2 * sps.t.sf(np.abs(z), df=max(nobs - P, 1.0))
    return {"std_errs": se, "z_values": z, "p_values": pv,
            "dispersion": dispersion}


def glm_from_numpy(out: dict, params: dict | None = None,
                   device=None) -> GLMModel:
    """A port ``GLMModel`` from a GLM's outputs as plain numpy / Python
    values (a JAX model's ``output`` carried across without importing
    JAX): ``beta_std`` (and optionally ``beta_orig``, ``coef_names``) —
    a multinomial model's ``beta_multinomial_std`` (P x K), an ordinal
    model's ``beta_std`` and cuts ``theta`` —, ``family``, ``link``,
    ``tweedie_variance_power``, ``tweedie_link_power``, ``theta`` (the
    negative-binomial dispersion; an ordinal model's cuts are an array),
    ``response_domain``, ``names`` and ``datainfo`` — a dict with
    ``standardize``, ``use_all_factor_levels``, ``missing_handling``,
    ``add_intercept``, ``ncols_expanded``, ``hash_buckets`` and
    ``columns`` (each: name, kind, offset, width, mean, sigma, domain, and
    an interaction's pair, pair_means and pair_domains). ``params`` sets
    GLMParams fields (response_column, offset_column, weights_column). The
    model scores on ``device`` (``cuda`` unless given)."""
    resolve(device)
    dspec = out["datainfo"]

    def pair_of(c, key):
        v = c.get(key)
        return tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                     for x in v) if v else None

    di = DataInfo(
        columns=[ColumnSpec(c["name"], c["kind"], mean=float(c["mean"]),
                            sigma=float(c["sigma"]),
                            domain=tuple(c.get("domain") or ()),
                            offset=int(c["offset"]), width=int(c["width"]),
                            pair=pair_of(c, "pair"),
                            pair_means=pair_of(c, "pair_means"),
                            pair_domains=pair_of(c, "pair_domains"))
                 for c in dspec["columns"]],
        standardize=bool(dspec["standardize"]),
        use_all_factor_levels=bool(dspec["use_all_factor_levels"]),
        missing_handling=dspec["missing_handling"],
        add_intercept=bool(dspec["add_intercept"]),
        ncols_expanded=int(dspec["ncols_expanded"]),
        hash_buckets=(int(dspec["hash_buckets"])
                      if dspec.get("hash_buckets") else None),
    )
    family = out["family"]
    prm = GLMParams(**(params or {}))
    prm.family = family
    prm.link = out.get("link", "family_default")
    prm.tweedie_variance_power = float(out.get("tweedie_variance_power", 0.0))
    prm.tweedie_link_power = float(out.get("tweedie_link_power", 1.0))
    o = {
        "family": family,
        "link": prm.link,
        "datainfo": di,
        "response_domain": (tuple(out["response_domain"])
                            if out.get("response_domain") else None),
        "names": list(out.get("names") or [c.name for c in di.columns]),
        "null_deviance": out.get("null_deviance", float("nan")),
        "residual_deviance": out.get("residual_deviance", float("nan")),
    }
    if family == "multinomial":
        o.update(_multinomial_output(di, out["beta_multinomial_std"]))
        o["coef_names"] = list(out.get("coef_names") or di.coef_names())
        return GLMModel(None, prm, o)
    beta_std = np.asarray(out["beta_std"], np.float64)
    o.update(
        coef_names=list(out.get("coef_names") or di.coef_names()),
        beta_std=beta_std, beta_std_report=beta_std,
        beta_orig=np.asarray(out.get("beta_orig", beta_std), np.float64),
        multinomial=False)
    if family == "ordinal":
        o.update(ordinal=True, family_obj=get_family("binomial"),
                 theta=np.asarray(out["theta"], np.float64))
        return GLMModel(None, prm, o)
    prm.theta = float(out.get("theta", 1e-5))
    o["family_obj"] = get_family(family, *_fam_args(prm))
    return GLMModel(None, prm, o)
