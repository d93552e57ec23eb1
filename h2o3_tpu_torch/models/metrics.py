"""Model metrics — the port of the host path of
``h2o3_tpu/models/metrics.py``: ``binomial_metrics`` (exact rank-statistic
AUC, PR-AUC, logloss, the max-F1 threshold) and ``regression_metrics``.

Predictions come to the host as float64 numpy (one pull of an (n,) column)
and are reduced there exactly as the JAX package's host path reduces them.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-15


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


class ModelMetrics:
    def __init__(self, kind: str, values: dict, domain=None):
        self.kind = kind
        self._v = dict(values)
        self.domain = domain

    def __getattr__(self, item):
        v = self.__dict__.get("_v", {})
        if item in v:
            return v[item]
        raise AttributeError(item)

    def value(self, name: str) -> float:
        """A scalar criterion by name (nan if absent)."""
        v = self._v.get(name)
        if v is None and name == "mean_residual_deviance":
            v = self._v.get("mse")
        try:
            return float(v)
        except (TypeError, ValueError):
            return float("nan")

    def __repr__(self):
        keys = [k for k in ("rmse", "mae", "r2", "auc", "pr_auc", "logloss")
                if k in self._v]
        body = ", ".join(f"{k}={self._v[k]:.6g}" for k in keys)
        return f"<ModelMetrics{self.kind.capitalize()} {body}>"


def regression_metrics(actual, pred, weights=None) -> ModelMetrics:
    """Gaussian regression metrics (mse, rmse, mae, rmsle, r2, deviance)."""
    a = _host(actual)
    p = _host(pred)
    w = np.ones_like(a) if weights is None else _host(weights)
    ok = ~np.isnan(a) & ~np.isnan(p) & (w > 0)
    a, p, w = a[ok], p[ok], w[ok]
    sw = w.sum()
    err = a - p
    mse = float((w * err**2).sum() / sw)
    mae = float((w * np.abs(err)).sum() / sw)
    mean_a = (w * a).sum() / sw
    ss_tot = float((w * (a - mean_a) ** 2).sum() / sw)
    rmsle = float("nan")
    if (a > -1).all() and (p > -1).all():
        rmsle = float(np.sqrt((w * (np.log1p(a) - np.log1p(p)) ** 2).sum() / sw))
    return ModelMetrics("regression", {
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": mae,
        "rmsle": rmsle,
        "r2": float(1.0 - mse / ss_tot) if ss_tot > 0 else float("nan"),
        "mean_residual_deviance": mse,
        "nobs": int(ok.sum()),
    })


def binomial_metrics(actual, prob, weights=None,
                     domain: tuple = ("0", "1")) -> ModelMetrics:
    """``actual`` is {0,1}; ``prob`` is P(class 1)."""
    y = _host(actual)
    p = np.clip(_host(prob), _EPS, 1 - _EPS)
    w = np.ones_like(y) if weights is None else _host(weights)
    ok = ~np.isnan(y) & ~np.isnan(p) & (w > 0)
    y, p, w = y[ok], p[ok], w[ok]
    sw = w.sum()
    logloss = float(-(w * (y * np.log(p) + (1 - y) * np.log(1 - p))).sum() / sw)
    mse = float((w * (y - p) ** 2).sum() / sw)
    auc = _weighted_auc(y, p, w)
    thr, f1 = _max_f1(y, p, w)
    return ModelMetrics("binomial", {
        "auc": auc,
        "pr_auc": _pr_auc(y, p, w),
        "gini": 2 * auc - 1,
        "logloss": logloss,
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "default_threshold": thr,
        "max_f1": f1,
        "nobs": int(ok.sum()),
    }, domain=domain)


def _weighted_auc(y, p, w) -> float:
    order = np.argsort(p, kind="mergesort")
    y, p, w = y[order], p[order], w[order]
    wpos = w * (y == 1)
    wneg = w * (y == 0)
    tot_pos, tot_neg = wpos.sum(), wneg.sum()
    if tot_pos == 0 or tot_neg == 0:
        return float("nan")
    # rank-sum with ties: positives at a tied score see half the tied negatives
    _, idx, inv = np.unique(p, return_index=True, return_inverse=True)
    grp_neg = np.add.reduceat(wneg, idx)
    below = np.concatenate([[0.0], np.cumsum(grp_neg)[:-1]])
    frac = below[inv] + 0.5 * grp_neg[inv]
    return float((wpos * frac).sum() / (tot_pos * tot_neg))


def _pr_auc(y, p, w) -> float:
    order = np.argsort(-p, kind="mergesort")
    y, w = y[order], w[order]
    tp = np.cumsum(w * (y == 1))
    fp = np.cumsum(w * (y == 0))
    if tp[-1] == 0:
        return float("nan")
    precision = tp / np.maximum(tp + fp, _EPS)
    recall = tp / tp[-1]
    return float(np.trapezoid(precision, recall))


def _max_f1(y, p, w) -> tuple[float, float]:
    """(threshold, F1) maximizing F1 over the 400 score quantiles of the
    JAX package's threshold table, a row predicted positive at ``p >= t``.
    Sums come from one sort and cumulative sums instead of the table's
    (thresholds × rows) matrix."""
    thresholds = np.unique(np.quantile(p, np.linspace(0, 1, 400)))
    order = np.argsort(p, kind="mergesort")
    ps = p[order]
    cpos = np.concatenate([[0.0], np.cumsum((w * (y == 1))[order])])
    cneg = np.concatenate([[0.0], np.cumsum((w * (y == 0))[order])])
    below = np.searchsorted(ps, thresholds, side="left")
    tp = cpos[-1] - cpos[below]
    fp = cneg[-1] - cneg[below]
    fn = cpos[-1] - tp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
        f1 = 2 * precision * recall / (precision + recall)
    if np.all(np.isnan(f1)):
        return 0.5, float("nan")
    best = int(np.nanargmax(f1))
    return float(thresholds[best]), float(f1[best])
