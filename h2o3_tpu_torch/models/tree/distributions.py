"""GBM distributions — the port of ``h2o3_tpu/models/tree/distributions.py``
(gaussian, bernoulli, poisson, gamma, tweedie, laplace, quantile, huber and
multinomial): per-row (target, hessian) at the current raw score, the init
score, and the link inverse for prediction. Leaf values are Newton steps
Σ(w·t)/Σh from the same histogram stats. The deviations from h2o's exact
leaf formulas that the JAX package notes (laplace's median leaves, huber's
delta) are carried over unchanged. Multinomial has its own entry points:
:func:`multinomial_grad_hess` for the K class columns at once and
:func:`multinomial_init` for the K init scores.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-10
DISTRIBUTIONS = ("gaussian", "bernoulli", "poisson", "gamma", "tweedie",
                 "laplace", "quantile", "huber", "multinomial")


def _check(dist: str, single_class: bool = False) -> None:
    if dist not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {dist}")
    if single_class and dist == "multinomial":
        raise ValueError("multinomial has K class columns: use "
                         "multinomial_grad_hess / multinomial_init")


def grad_hess(dist: str, f: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              aux: float = 0.0):
    """Per-row pseudo-residual target and hessian for the next tree."""
    _check(dist, single_class=True)
    if dist == "gaussian":
        return y - f, w
    if dist == "bernoulli":
        p = torch.sigmoid(f)
        return y - p, w * torch.clamp(p * (1 - p), min=_EPS)
    if dist == "poisson":
        mu = torch.exp(f)
        return y - mu, w * torch.clamp(mu, min=_EPS)
    if dist == "gamma":
        e = torch.exp(-f) * y
        return e - 1.0, w * torch.clamp(e, min=_EPS)
    if dist == "tweedie":
        p = aux
        a = y * torch.exp((1.0 - p) * f)
        b = torch.exp((2.0 - p) * f)
        return a - b, w * torch.clamp((2.0 - p) * b - (1.0 - p) * a, min=_EPS)
    if dist == "laplace":
        # gradient step on sign; h2o refits leaf medians [deviation noted]
        return torch.sign(y - f), w
    if dist == "quantile":
        alpha = aux
        return torch.where(y > f, alpha, alpha - 1.0), w
    delta = aux  # huber
    return torch.clamp(y - f, -delta, delta), w


def multinomial_grad_hess(F, Y1h, w, K: int):
    """(n, K) targets and hessians at the raw scores ``F`` (n, K), float32:
    P = softmax(F), T = Y1h − P, and H scaled so Newton leaves carry the
    (K-1)/K LogitBoost factor h2o applies."""
    P = torch.softmax(F.to(torch.float32), dim=1)
    T = Y1h - P
    H = w[:, None] * torch.clamp(P * (1 - P), min=_EPS) * (K / max(K - 1.0,
                                                                   1.0))
    return T, H


def multinomial_init(y: np.ndarray, w: np.ndarray, K: int) -> np.ndarray:
    """The (K,) float32 init scores: the log of the weighted class priors,
    floored at 1e-9 (host float64, like the JAX package)."""
    sw = max(w.sum(), 1e-30)
    prior = np.array([max((w * (y == k)).sum() / sw, 1e-9)
                      for k in range(K)])
    return np.log(prior).astype(np.float32)


def init_score(dist: str, y: np.ndarray, w: np.ndarray,
               aux: float = 0.0) -> float:
    """f0 — the initial prediction (host float64, like the JAX package)."""
    _check(dist, single_class=True)
    sw = w.sum()
    mean = float((w * y).sum() / max(sw, _EPS))
    if dist in ("gaussian", "huber"):
        return mean
    if dist == "bernoulli":
        p = min(max(mean, 1e-6), 1 - 1e-6)
        return float(np.log(p / (1 - p)))
    if dist in ("poisson", "gamma", "tweedie"):
        return float(np.log(max(mean, _EPS)))
    if dist == "laplace":
        return float(_weighted_quantile(y, w, 0.5))
    return float(_weighted_quantile(y, w, aux))  # quantile


def _weighted_quantile(y, w, q):
    order = np.argsort(y)
    cw = np.cumsum(w[order])
    return y[order][np.searchsorted(cw, q * cw[-1])]


def response_transform(dist: str, f: torch.Tensor) -> torch.Tensor:
    """Raw score F -> prediction scale (linkinv)."""
    _check(dist)
    if dist == "bernoulli":
        return torch.sigmoid(f)
    if dist in ("poisson", "gamma", "tweedie"):
        return torch.exp(f)
    return f


def resolve_distribution(dist: str, yv, quantile_alpha: float = 0.5,
                         tweedie_power: float = 1.5,
                         huber_alpha: float = 0.9) -> tuple[str, float]:
    """AUTO resolution + the aux parameter, mirroring h2o defaults:
    ``(dist, aux)``."""
    d = (dist or "AUTO").lower()
    if d == "auto":
        if yv.is_categorical():
            d = "bernoulli" if yv.cardinality <= 2 else "multinomial"
        else:
            d = "gaussian"
    _check(d)
    aux = 0.0
    if d == "tweedie":
        aux = float(tweedie_power)
    elif d == "quantile":
        aux = float(quantile_alpha)
    elif d == "huber":
        aux = float(huber_alpha)  # note: h2o derives delta from this quantile
    return d, aux
