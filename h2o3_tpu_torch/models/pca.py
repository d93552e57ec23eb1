"""PCA and SVD — the port of ``h2o3_tpu/models/pca.py`` (the successors of
``hex.pca.PCA`` and ``hex.svd.SVD``).

PCA (GramSVD, H2O's default): the design's Gram on its device
(``ops/gram.weighted_gram``: full-float32 chunk products added in float64),
then the (p, p) eigen decomposition in float64 on the host, as JAX does;
the transforms ``NONE``, ``DEMEAN``, ``DESCALE`` and ``STANDARDIZE`` set up
the DataInfo as JAX's does. SVD takes the Gram's eigen decomposition when
the design has at most 64 columns (or ``svd_method="GramSVD"``), and
otherwise JAX's randomized subspace iteration: the starting block drawn
from the same numpy generator, the products and ``torch.linalg.qr`` on the
device, and only the (n, nv + 4) block pulled for the host SVD, as JAX
pulls it. Eigen- and singular vectors are defined up to sign.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.datainfo import DataInfo
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.ops.gram import full_fp32, weighted_gram

GRAM_SVD_MAX_COLS = 64  # SVD's Gram path up to this design width (JAX's)


def _gram64(X, w) -> np.ndarray:
    """``XᵀX`` of the device design as float64 numpy (the rows in
    full-float32 chunks, the chunks added in float64)."""
    return weighted_gram(X, w, w)[0].double().cpu().numpy()


def _project(di: DataInfo, frame: Frame, V) -> torch.Tensor:
    """The frame's design times ``V`` on the frame's device."""
    X, _ = di.transform(frame)
    Vd = torch.as_tensor(np.asarray(V, np.float32), device=X.device)
    with full_fp32():
        return X @ Vd


def _frame_of(S: torch.Tensor, prefix: str) -> Frame:
    return Frame([Vec(S[:, i].contiguous(), NUM) for i in range(S.shape[1])],
                 [f"{prefix}{i + 1}" for i in range(S.shape[1])])


@dataclass
class PCAParams(CommonParams):
    k: int = 1
    transform: str = "STANDARDIZE"  # NONE | DEMEAN | DESCALE | STANDARDIZE
    pca_method: str = "GramSVD"
    use_all_factor_levels: bool = False


class PCAModel(Model):
    algo = "pca"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """(n, k) principal component scores on the frame's device."""
        return _project(self.output["datainfo"], frame,
                        self.output["eigenvectors"])

    def predict(self, frame: Frame) -> Frame:
        return _frame_of(self._predict_raw(frame), "PC")


class PCA(ModelBuilder):
    algo = "pca"
    PARAMS_CLS = PCAParams

    def _validate(self, train, valid):
        pass  # unsupervised

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: PCAParams = self.params
        t = p.transform.upper()
        di = DataInfo.fit(train, self._x, standardize=(t == "STANDARDIZE"),
                          use_all_factor_levels=p.use_all_factor_levels)
        if t in ("NONE", "DESCALE"):
            for c in di.columns:
                if c.kind == "num":
                    c.mean = 0.0
        if t == "DESCALE":
            di.standardize = True
        X, w = di.transform(train)
        G = _gram64(X, w)
        nobs = float(w.sum())
        eigvals, eigvecs = np.linalg.eigh(G / max(nobs - 1, 1.0))
        order = np.argsort(-eigvals)
        eigvals = np.maximum(eigvals[order], 0.0)
        eigvecs = eigvecs[:, order]
        k = min(int(p.k), len(eigvals))
        std_dev = np.sqrt(eigvals[:k])
        prop = eigvals[:k] / max(eigvals.sum(), 1e-30)
        out = {
            "datainfo": di,
            "eigenvectors": eigvecs[:, :k],
            "eigenvalues": eigvals[:k],
            "std_deviation": std_dev,
            "proportion_of_variance": prop,
            "cumulative_proportion": np.cumsum(prop),
            "coef_names": di.coef_names(),
            "names": list(self._x),
            "response_domain": None,
        }
        model = PCAModel(None, p, out)
        model.training_metrics = MM.ModelMetrics(
            "pca", {"std_deviation": std_dev.tolist(), "k": k})
        return model


@dataclass
class SVDParams(CommonParams):
    nv: int = 1
    transform: str = "NONE"
    svd_method: str = "Randomized"  # GramSVD | Power | Randomized
    max_iterations: int = 4


class SVDModel(Model):
    algo = "svd"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """(n, nv) projections on the right singular vectors."""
        return _project(self.output["datainfo"], frame, self.output["v"])

    def predict(self, frame: Frame) -> Frame:
        return _frame_of(self._predict_raw(frame), "SV")


class SVD(ModelBuilder):
    algo = "svd"
    PARAMS_CLS = SVDParams

    def _validate(self, train, valid):
        pass  # unsupervised

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: SVDParams = self.params
        di = DataInfo.fit(train, self._x,
                          standardize=(p.transform.upper() == "STANDARDIZE"))
        X, w = di.transform(train)
        P = X.shape[1]
        nv = min(int(p.nv), P)
        rng = np.random.default_rng(abs(p.seed) if p.seed and p.seed > 0 else 1)
        if p.svd_method.lower() == "gramsvd" or P <= GRAM_SVD_MAX_COLS:
            evals, evecs = np.linalg.eigh(_gram64(X, w))
            order = np.argsort(-evals)
            V = evecs[:, order[:nv]]
            d = np.sqrt(np.maximum(evals[order[:nv]], 0.0))
            method = "gram"
        else:
            # randomized subspace iteration: the products on the device
            Q = torch.from_numpy(rng.normal(size=(P, nv + 4)).astype(
                np.float32)).to(X.device)
            with full_fp32():
                for _ in range(max(1, p.max_iterations)):
                    Q, _ = torch.linalg.qr(X.T @ (X @ Q))
                B = (X @ Q).cpu().numpy()
            _, s, Vt = np.linalg.svd(B, full_matrices=False)
            V = (Q.cpu().numpy() @ Vt.T)[:, :nv]
            d = s[:nv]
            method = "randomized"
        out = {
            "datainfo": di,
            "v": V,
            "d": d,
            "names": list(self._x),
            "response_domain": None,
            "method": method,
        }
        model = SVDModel(None, p, out)
        model.training_metrics = MM.ModelMetrics("svd", {"d": d.tolist()})
        return model
