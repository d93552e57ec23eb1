"""GBM distributions — the port of ``h2o3_tpu/models/tree/distributions.py``
for the bernoulli and gaussian families: per-row (target, hessian) at the
current raw score, the init score, and the link inverse for prediction.
Leaf values are Newton steps Σ(w·t)/Σh from the same histogram stats."""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-10
_DISTS = ("gaussian", "bernoulli")


def _check(dist: str) -> None:
    if dist not in _DISTS:
        raise NotImplementedError(
            f"distribution {dist!r} is not ported yet (ported: {_DISTS})")


def grad_hess(dist: str, f: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Per-row pseudo-residual target and hessian for the next tree."""
    _check(dist)
    if dist == "gaussian":
        return y - f, w
    p = torch.sigmoid(f)
    return y - p, w * torch.clamp(p * (1 - p), min=_EPS)


def init_score(dist: str, y: np.ndarray, w: np.ndarray) -> float:
    """f0 — the initial prediction (host float64, like the JAX package)."""
    _check(dist)
    sw = w.sum()
    mean = float((w * y).sum() / max(sw, _EPS))
    if dist == "gaussian":
        return mean
    p = min(max(mean, 1e-6), 1 - 1e-6)
    return float(np.log(p / (1 - p)))


def response_transform(dist: str, f: torch.Tensor) -> torch.Tensor:
    """Raw score F -> prediction scale (linkinv)."""
    _check(dist)
    return torch.sigmoid(f) if dist == "bernoulli" else f


def resolve_distribution(dist: str, yv) -> str:
    """AUTO resolution, mirroring h2o defaults."""
    d = (dist or "AUTO").lower()
    if d == "auto":
        if yv.is_categorical():
            d = "bernoulli" if yv.cardinality <= 2 else "multinomial"
        else:
            d = "gaussian"
    _check(d)
    return d
