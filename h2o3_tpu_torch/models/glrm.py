"""GLRM — the port of ``h2o3_tpu/models/glrm.py`` (the successor of
``hex.glrm.GLRM``): A ≈ X·Y with X (n, k) and the archetypes Y (k, d), fit
by JAX's alternating scheme on the masked, transformed numeric design.

Everything per row stays on the frame's device: the design and its mask,
the SVD start (the (d, d) Gram's SVD on the host, X₀ = A·Y₀ᵀ on the
device), the exact alternating ridge step when both regularizers are
smooth (``None``/``L2``: per-row and per-column k × k solves, batched in
``torch.linalg.solve``), the Lipschitz-scaled proximal step otherwise
(``L1``, ``NonNegative``), and the objective. The host reads the objective
once an iteration and applies JAX's step rule (accept and grow the step by
1.05 when the objective does not rise, else halve it). ``x_factor`` stays
a device tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.ops.gram import full_fp32


@dataclass
class GLRMParams(CommonParams):
    k: int = 2
    loss: str = "Quadratic"
    regularization_x: str = "None"  # None | L2 | L1 | NonNegative
    regularization_y: str = "None"
    gamma_x: float = 0.0
    gamma_y: float = 0.0
    max_iterations: int = 100
    init_step_size: float = 1.0
    min_step_size: float = 1e-6
    tolerance_rel: float = 1e-7
    transform: str = "STANDARDIZE"  # NONE | DEMEAN | STANDARDIZE
    init: str = "SVD"  # SVD | Random


def _prox(M, reg: str, t, gamma: float):
    if reg == "L1":
        return torch.sign(M) * torch.clamp(M.abs() - t * gamma, min=0.0)
    if reg == "L2":
        return M / (1.0 + 2.0 * t * gamma)
    if reg == "NonNegative":
        return torch.clamp(M, min=0.0)
    return M


def _reg_val(M, reg: str, gamma: float):
    if reg == "L1":
        return gamma * M.abs().sum()
    if reg == "L2":
        return gamma * (M**2).sum()
    return 0.0


def _design(frame: Frame, cols, means, sigmas):
    """The transformed design (NAs 0) and its mask, (n, d) float32 on the
    frame's device (the constants rounded to float32, as JAX's)."""
    x = torch.stack([frame.vec(c).data for c in cols], 1)
    m = ~torch.isnan(x)
    mu = torch.as_tensor(np.asarray(means, np.float32), device=x.device)
    sd = torch.as_tensor(np.asarray(sigmas, np.float32), device=x.device)
    A = torch.where(m, (torch.nan_to_num(x) - mu) / sd, 0.0)
    return A, m.to(torch.float32)


def _ridge_rows(F, mask, B, gamma: float):
    """Each row's k × k ridge solve against the fixed factor F (k, d):
    ``(F diag(mask_n) Fᵀ + (γ + 1e-8) I) x_n = F (B_n)``, batched; the
    per-row Grams are one product with the (d, k²) outer products."""
    k, d = F.shape
    outer = (F.T[:, :, None] * F.T[:, None, :]).reshape(d, k * k)
    G = (mask @ outer).reshape(-1, k, k) + (gamma + 1e-8) * torch.eye(
        k, device=F.device)
    return torch.linalg.solve(G, (B @ F.T)[..., None])[..., 0]


class GLRMModel(Model):
    algo = "glrm"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        raise NotImplementedError(
            "GLRM is a matrix factorization; use transform_frame/reconstruct")

    def _x_of(self, frame: Frame) -> torch.Tensor:
        """New rows projected onto the archetypes (a ridge solve)."""
        o = self.output
        A, mask = _design(frame, o["names"], o["means"], o["sigmas"])
        Y = torch.as_tensor(np.asarray(o["archetypes"], np.float32),
                            device=A.device)
        with full_fp32():
            G = Y @ Y.T + 1e-6 * torch.eye(Y.shape[0], device=A.device)
            return torch.linalg.solve(G, Y @ (A * mask).T).T

    def transform_frame(self, frame: Frame) -> Frame:
        X = self._x_of(frame)
        return Frame([Vec(X[:, j].contiguous(), NUM)
                      for j in range(X.shape[1])],
                     [f"Arch{j + 1}" for j in range(X.shape[1])])

    def reconstruct(self, frame: Frame) -> Frame:
        o = self.output
        X = self._x_of(frame)
        Y = torch.as_tensor(np.asarray(o["archetypes"], np.float32),
                            device=X.device)
        dev = X.device
        with full_fp32():
            R = X @ Y
        R = (R * torch.as_tensor(np.asarray(o["sigmas"], np.float32),
                                 device=dev)
             + torch.as_tensor(np.asarray(o["means"], np.float32),
                               device=dev))
        return Frame([Vec(R[:, i].contiguous(), NUM)
                      for i in range(len(o["names"]))],
                     [f"reconstr_{n}" for n in o["names"]])


class GLRM(ModelBuilder):
    algo = "glrm"
    PARAMS_CLS = GLRMParams

    def _validate(self, train, valid):
        pass  # unsupervised

    def _features(self, train: Frame, response):
        return [n for n in train.names if train.vec(n).is_numeric()]

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: GLRMParams = self.params
        cols = self._x
        if not cols:
            raise ValueError("GLRM needs numeric columns")
        d = len(cols)
        k = min(p.k, d)
        dev = train.device
        means, sigmas = self._moments(train, cols, p.transform)
        A, mask = _design(train, cols, means, sigmas)
        n = A.shape[0]
        rng = np.random.default_rng(abs(p.seed) if p.seed and p.seed > 0 else 11)
        with full_fp32():
            if p.init.upper() == "SVD":
                Am = A * mask
                G = (Am.T @ Am).cpu().numpy()
                _, _, vt = np.linalg.svd(G)
                Y = torch.from_numpy(np.ascontiguousarray(vt[:k, :])).to(dev)
                X = A @ Y.T
            else:
                Y = torch.from_numpy((rng.normal(size=(k, d)) * 0.1).astype(
                    np.float32)).to(dev)
                X = torch.from_numpy((rng.normal(size=(n, k)) * 0.1).astype(
                    np.float32)).to(dev)

        rx, ry = p.regularization_x, p.regularization_y
        gx, gy = float(p.gamma_x), float(p.gamma_y)
        smooth = rx in ("None", "L2") and ry in ("None", "L2")
        Am = A * mask

        def objective(X, Y):
            R = (X @ Y - A) * mask
            return 0.5 * (R**2).sum() + _reg_val(X, rx, gx) + _reg_val(Y, ry, gy)

        def als_step(X, Y):
            Xn = _ridge_rows(Y, mask, Am, gx)
            Yn = _ridge_rows(Xn.T.contiguous(), mask.T.contiguous(),
                             Am.T.contiguous(), gy).T
            return Xn, Yn

        def prox_step(X, Y, alpha: float):
            ly = torch.linalg.matrix_norm(Y @ Y.T, ord=2) + 2 * gx + 1e-6
            R = (X @ Y - A) * mask
            gX = R @ Y.T + (2 * gx * X if rx == "L2" else 0.0)
            Xn = _prox(X - (alpha / ly) * gX, rx, alpha / ly, gx)
            lx = torch.linalg.matrix_norm(Xn.T @ Xn, ord=2) + 2 * gy + 1e-6
            R2 = (Xn @ Y - A) * mask
            gY = Xn.T @ R2 + (2 * gy * Y if ry == "L2" else 0.0)
            Yn = _prox(Y - (alpha / lx) * gY, ry, alpha / lx, gy)
            return Xn, Yn

        alpha = p.init_step_size
        with full_fp32():
            nobs = float(torch.clamp(mask.sum(), min=1.0))
            obj = float(objective(X, Y))
            history = [{"iteration": 0, "objective": obj, "step_size": alpha}]
            for it in range(p.max_iterations):
                if smooth:
                    Xn, Yn = als_step(X, Y)
                else:
                    Xn, Yn = prox_step(X, Y, float(np.float32(alpha)))
                new_obj = float(objective(Xn, Yn))  # the iteration's read
                if np.isfinite(new_obj) and new_obj <= obj * (1 + 1e-7):
                    converged = obj - new_obj < p.tolerance_rel * max(
                        abs(obj), 1e-12)
                    X, Y, obj = Xn, Yn, new_obj
                    alpha *= 1.05  # upstream grows the step on success
                    if converged and it > 2:
                        history.append({"iteration": it + 1,
                                        "objective": obj,
                                        "step_size": alpha})
                        break
                else:
                    alpha *= 0.5  # and halves it on failure
                    if alpha < p.min_step_size:
                        break
                history.append({"iteration": it + 1, "objective": obj,
                                "step_size": alpha})

        out = {
            "names": list(cols),
            "archetypes": Y.cpu().numpy(),
            "x_factor": X,
            "means": means,
            "sigmas": sigmas,
            "objective": obj,
            "response_domain": None,
        }
        model = GLRMModel(None, p, out)
        model.scoring_history = history
        model.training_metrics = MM.ModelMetrics(
            "glrm", {"objective": obj, "sse": float(obj),
                     "iterations": len(history) - 1, "nobs": int(nobs)})
        return model

    @staticmethod
    def _moments(train: Frame, cols, transform: str):
        """Per column the mean and standard deviation of its non-NA values
        (numpy's ``std``, dividing by n), as ``transform`` asks: one
        float64 reduction of the stacked columns on the device."""
        d = len(cols)
        means, sigmas = np.zeros(d), np.ones(d)
        if transform not in ("DEMEAN", "STANDARDIZE"):
            return means, sigmas
        x = torch.stack([train.vec(c).data for c in cols], 1).double()
        ok = ~torch.isnan(x)
        cnt = ok.sum(0)
        xs = torch.where(ok, x, 0.0)
        mu = xs.sum(0) / cnt.clamp(min=1)
        var = torch.where(ok, (x - mu) ** 2, 0.0).sum(0) / cnt.clamp(min=1)
        host = torch.stack([mu, var.sqrt(), cnt.double()]).cpu().numpy()
        has = host[2] > 0
        means = np.where(has, host[0], 0.0)
        if transform == "STANDARDIZE":
            s = np.where(has, host[1], 1.0)
            sigmas = np.where(s > 1e-12, s, 1.0)
        return means, sigmas
