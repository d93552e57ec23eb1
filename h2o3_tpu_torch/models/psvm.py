"""PSVM — the port of ``h2o3_tpu/models/psvm.py`` (the successor of
``hex.psvm.PSVM``): a binary SVM with the gaussian (RBF) kernel.

JAX keeps upstream's low-rank idea in a matrix-product form: a Nyström
feature map on ``m`` landmark rows (Φ = K_nm · K_mm^{-1/2}), then a linear
squared-hinge primal fitted by Nesterov-accelerated full-batch gradient
steps. The port does the same:
- the design is the standardized ``DataInfo`` one without an intercept,
  labels ±1 and the class weights in ``sw``, on the frame's device;
- the landmarks are drawn by JAX's ``default_rng(abs(seed) or 31)`` and
  gathered from the device; ``K_mm^{-1/2}`` comes from ``eigh`` on the
  host, with JAX's numpy arithmetic (float32 distances, float64 ``eigh``);
- Φ (:func:`rbf_features`) and the fit (:func:`sq_hinge_fit`: 8 power
  iterations for the step, then ``max_iterations`` accelerated steps with
  the objective kept per step) run on the device in float32, in JAX's
  order of operations; the objectives are read once, at the end.

One deviation: JAX's step is 1/L with L = 1 + 2C·λmax(ΦᵀSΦ), the
curvature of ``w`` alone. The bias ``b`` adds 2C·Σs, more than that on
the headline frame, so JAX's iterates grow without bound there and its
model is NaN at its defaults (a fault of the reference). The port's power
iterations run on ``[Φ | 1]``, the whole (w, b) Hessian, so its steps
converge; where JAX's converge too, both reach the same optimum.

``predict`` squashes the clipped margin into a class probability (PSVM has
no calibrated probabilities; JAX's documented deviation).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    gather_rows,
)
from h2o3_tpu_torch.ops.gram import full_fp32

POWER_ITERS = 8  # JAX's power iterations for the Lipschitz constant


@dataclass
class PSVMParams(CommonParams):
    kernel_type: str = "gaussian"
    gamma: float = -1.0  # -1 -> 1 / n_features
    hyper_param: float = 1.0  # the penalty C
    positive_weight: float = 1.0
    negative_weight: float = 1.0
    rank_ratio: float = -1.0  # landmark fraction; -1 -> min(0.1, 200/n)
    max_iterations: int = 200
    convergence_tol: float = 1e-6


def rbf_features(X: torch.Tensor, Lm: torch.Tensor, Whalf: torch.Tensor,
                 gamma: float) -> torch.Tensor:
    """The Nyström map Φ = K(X, Lm) @ Whalf, K gaussian, float32 (JAX's
    ``_rbf_features``)."""
    g = torch.tensor(gamma, dtype=torch.float32, device=X.device)
    with full_fp32():
        d2 = ((X * X).sum(1)[:, None] - 2.0 * (X @ Lm.T)
              + (Lm * Lm).sum(1)[None, :])
        K = torch.exp(-g * torch.clamp(d2, min=0.0))
        return K @ Whalf


def step_size(Phi: torch.Tensor, sw: torch.Tensor,
              C: torch.Tensor) -> torch.Tensor:
    """1/L for the Lipschitz constant L = 1 + 2C·λmax(AᵀSA) of the
    objective's gradient in (w, b), A = [Φ | 1], by a few power
    iterations (float32, on ``Phi``'s device)."""
    m = Phi.shape[1]

    def curvature(v):  # AᵀSA·v
        r = sw * (Phi @ v[:m] + v[m])
        return torch.cat([Phi.T @ r, r.sum().reshape(1)])

    v = torch.ones(m + 1, dtype=Phi.dtype, device=Phi.device) / torch.sqrt(
        torch.tensor(float(m + 1), dtype=Phi.dtype, device=Phi.device))
    for _ in range(POWER_ITERS):
        u = curvature(v)
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
    return 1.0 / (1.0 + 2.0 * C * torch.linalg.norm(curvature(v)))


def sq_hinge_fit(Phi: torch.Tensor, yy: torch.Tensor, sw: torch.Tensor,
                 C: float, iters: int):
    """Accelerated gradient steps of :func:`step_size` on 0.5‖w‖² +
    C·Σ s_i·max(0, 1 − y(Φw+b))², float32 on ``Phi``'s device (JAX's
    ``_sq_hinge_fit``): ``(wb, objectives)``, each a device tensor."""
    dev = Phi.device
    f32 = torch.float32
    m = Phi.shape[1]
    C = torch.tensor(C, dtype=f32, device=dev)
    with full_fp32():
        step = step_size(Phi, sw, C)

        def loss_grad(wb):
            w, b = wb[:m], wb[m]
            marg = 1.0 - yy * (Phi @ w + b)
            act = torch.clamp(marg, min=0.0) * sw
            gw = w - 2.0 * C * (Phi.T @ (act * yy))
            gb = -2.0 * C * torch.sum(act * yy)
            obj = 0.5 * torch.dot(w, w) + C * torch.sum(act * marg)
            return obj, torch.cat([gw, gb.reshape(1)])

        wb = torch.zeros(m + 1, dtype=f32, device=dev)
        vb = torch.zeros(m + 1, dtype=f32, device=dev)
        t = torch.ones((), dtype=f32, device=dev)
        objs = torch.empty(iters, dtype=f32, device=dev)
        for i in range(iters):
            obj, g = loss_grad(vb)
            objs[i] = obj
            wb_new = vb - step * g
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            vb = wb_new + ((t - 1.0) / t_new) * (wb_new - wb)
            wb, t = wb_new, t_new
    return wb, objs


class PSVMModel(Model):
    algo = "psvm"

    def _decision(self, frame: Frame) -> torch.Tensor:
        """The decision value Φw + b, float32 on the frame's device."""
        o = self.output
        X, _ = o["datainfo"].transform(frame)
        dev = X.device
        Phi = rbf_features(X, torch.as_tensor(o["landmarks"], device=dev),
                           torch.as_tensor(o["whalf"], device=dev),
                           o["gamma"])
        with full_fp32():
            return Phi @ torch.as_tensor(o["w"], device=dev) + float(o["b"])

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        # the margin squashed (for the metrics), clipped so that exp cannot
        # overflow on wide margins
        d = torch.clamp(self._decision(frame), -30.0, 30.0)
        p1 = 1.0 / (1.0 + torch.exp(-2.0 * d))
        return torch.stack([1 - p1, p1], dim=1)

    def _distribution_for_metrics(self) -> str:
        return "bernoulli"


def landmark_count(nrow: int, rank_ratio: float) -> int:
    """JAX's ``m = clip(round(n·rr), 8, min(1024, n))``, ``rr`` defaulting
    to ``min(0.1, 200/n)``."""
    rr = rank_ratio if rank_ratio > 0 else min(0.1, 200.0 / max(nrow, 1))
    return int(np.clip(round(nrow * rr), 8, min(1024, nrow)))


def whalf_of(Lm: np.ndarray, gamma: float) -> np.ndarray:
    """``K_mm^{-1/2}`` of the float32 landmarks, JAX's host numpy step by
    step (float32 distances and kernel, float64 ``eigh``)."""
    m = Lm.shape[0]
    d2 = (np.sum(Lm * Lm, axis=1)[:, None] - 2.0 * Lm @ Lm.T
          + np.sum(Lm * Lm, axis=1)[None, :])
    Kmm = np.exp(-gamma * np.maximum(d2, 0.0))
    ev, U = np.linalg.eigh(Kmm + 1e-6 * np.eye(m))
    ev = np.maximum(ev, 1e-10)
    return (U / np.sqrt(ev)) @ U.T


class PSVM(ModelBuilder):
    algo = "psvm"
    PARAMS_CLS = PSVMParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: PSVMParams = self.params
        if p.kernel_type.lower() != "gaussian":
            raise ValueError("psvm supports the gaussian kernel")
        yv = train.vec(p.response_column)
        if not yv.is_categorical() or yv.cardinality > 2:
            raise ValueError("psvm needs a binary categorical response")

        di = DataInfo.fit(train, self._x, standardize=True,
                          use_all_factor_levels=False, add_intercept=False)
        X, valid_mask = di.transform(train)
        nrow = train.nrow
        codes = yv.data
        w = valid_mask * (codes >= 0)
        yy = torch.where(w != 0, torch.where(codes > 0, 1.0, -1.0), 0.0)
        sw = torch.where(yy > 0, float(p.positive_weight),
                         float(p.negative_weight)) * w

        nf = di.ncols_expanded
        gamma = p.gamma if p.gamma > 0 else 1.0 / max(nf, 1)
        m = landmark_count(nrow, p.rank_ratio)
        rng = np.random.default_rng(abs(p.seed) or 31)
        lm_idx = rng.choice(nrow, m, replace=False)
        Lm = gather_rows(X, lm_idx)  # float32, as JAX's np.asarray(X)[idx]
        Whalf = whalf_of(Lm, gamma)

        dev = X.device
        Phi = rbf_features(X, torch.from_numpy(Lm).to(dev),
                           torch.from_numpy(Whalf.astype(np.float32)).to(dev),
                           gamma)
        iters = p.max_iterations if p.max_iterations > 0 else 200
        wb, objs = sq_hinge_fit(Phi, yy, sw, p.hyper_param, iters)
        w32 = wb[:m]
        # support vectors: the rows inside the margin
        with full_fp32():
            dec = Phi @ w32 + wb[m]
        sv = torch.sum((yy * dec < 1.0) & (w > 0))
        packed = torch.cat([wb, objs, sv.reshape(1).to(torch.float32)])
        packed = packed.cpu().numpy()  # the fit's one read
        w_np = packed[:m].astype(np.float64)
        b = float(packed[m])
        objs_np = packed[m + 1: m + 1 + iters]

        out = {
            "datainfo": di,
            "landmarks": Lm.astype(np.float32),
            "whalf": Whalf.astype(np.float32),
            "gamma": float(gamma),
            "w": w_np.astype(np.float32),
            "b": b,
            "svs_count": int(packed[-1]),
            "rank": m,
            "objectives": objs_np,
            "names": list(self._x),
            "response_domain": tuple(yv.domain),
        }
        model = PSVMModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
