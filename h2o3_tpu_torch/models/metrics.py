"""Model metrics — the port of ``h2o3_tpu/models/metrics.py``:
``binomial_metrics`` (AUC, PR-AUC, logloss, the threshold table with its
max criteria, the confusion matrix at the max-F1 threshold, gains/lift and
KS), ``multinomial_metrics`` (logloss, classification and mean per-class
error, the K×K confusion matrix, top-k hit ratios) and
``regression_metrics`` with the mean residual deviance of its
``distribution``, each behind two paths, as in JAX:

- **host** (CPU tensors or numpy): the predictions come to the host as
  float64 and reduce exactly — the rank-statistic AUC, PR-AUC over every
  row, the threshold table over 400 score quantiles, gains/lift over every
  distinct score;
- **device** (any CUDA tensor among the inputs, the counterpart of JAX's
  ``_on_device``): the O(n) sufficient statistics reduce on the card —
  float32 weighted sums and, for binomial, a 1024-bucket ``(wpos, wneg)``
  score histogram (H2O ``AUC2``'s bucketed design, finer), for multinomial
  the confusion matrix and the histogram of the true class's rank — and
  come back in ONE packed transfer; AUC (buckets as tie groups), PR-AUC,
  the threshold surface, max-F1 and gains/lift are assembled from the
  bucket cumulatives on the host (``_binomial_metrics_device``,
  ``_multinomial_metrics_device``, ``_regression_metrics_device``).
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-15
_NBUCKETS = 1024


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _on_device(*arrays) -> bool:
    """True when the device-stats path applies: a CUDA tensor among the
    inputs."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in arrays)


def _stat_inputs(*arrays) -> list:
    """The inputs as float32 tensors on one device: a CUDA tensor's if any
    is on the card, else the first tensor's (numpy is uploaded once);
    None stays None."""
    devs = [a.device for a in arrays if isinstance(a, torch.Tensor)]
    dev = next((d for d in devs if d.type == "cuda"),
               devs[0] if devs else torch.device("cpu"))
    return [None if a is None else torch.as_tensor(
        a.detach() if isinstance(a, torch.Tensor) else np.asarray(a),
        dtype=torch.float32, device=dev) for a in arrays]


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

    def gains_lift(self):
        """Gains/lift table rows (binomial metrics only; else None)."""
        return self._v.get("gains_lift_table")

    def kolmogorov_smirnov(self) -> float:
        return self.value("ks")

    def value(self, name: str) -> float:
        """A scalar criterion by name (nan if absent)."""
        v = self._v.get(name)
        if v is None and name == "mean_residual_deviance":
            v = self._v.get("mse")
        try:
            return float(v)
        except (TypeError, ValueError):
            return float("nan")

    def to_dict(self) -> dict:
        out = {"kind": self.kind}
        for k, v in self._v.items():
            out[k] = v.tolist() if isinstance(v, np.ndarray) else v
        return out

    def __repr__(self):
        keys = [k for k in ("rmse", "mae", "r2", "mean_residual_deviance",
                            "auc", "pr_auc", "logloss",
                            "mean_per_class_error", "gini")
                if k in self._v]
        body = ", ".join(f"{k}={self._v[k]:.6g}" for k in keys)
        return f"<ModelMetrics{self.kind.capitalize()} {body}>"


def regression_metrics(actual, pred, weights=None,
                       distribution: str = "gaussian") -> ModelMetrics:
    """Regression metrics (mse, rmse, mae, rmsle, r2) and the mean residual
    deviance of ``distribution``."""
    if _on_device(actual, pred, weights):
        return _regression_metrics_device(actual, pred, weights, distribution)
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
    dev = _mean_deviance(a, p, w, distribution)
    return ModelMetrics("regression", {
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": mae,
        "rmsle": rmsle,
        "r2": float(1.0 - mse / ss_tot) if ss_tot > 0 else float("nan"),
        "mean_residual_deviance": dev,
        "nobs": int(ok.sum()),
    })


def _mean_deviance(a, p, w, distribution: str) -> float:
    """Poisson, gamma and laplace deviance; squared error otherwise."""
    sw = w.sum()
    if distribution == "poisson":
        p = np.maximum(p, _EPS)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(a > 0, a * np.log(a / p), 0.0)
        return float((2 * w * (t - (a - p))).sum() / sw)
    if distribution == "gamma":
        p = np.maximum(p, _EPS)
        a_ = np.maximum(a, _EPS)
        return float((2 * w * (-np.log(a_ / p) + (a_ - p) / p)).sum() / sw)
    if distribution == "laplace":
        return float((w * np.abs(a - p)).sum() / sw)
    return float((w * (a - p) ** 2).sum() / sw)  # gaussian & default


def binomial_metrics(actual, prob, weights=None,
                     domain: tuple = ("0", "1")) -> ModelMetrics:
    """``actual`` is {0,1}; ``prob`` is P(class 1)."""
    if _on_device(actual, prob, weights):
        return _binomial_metrics_device(actual, prob, weights, domain)
    y = _host(actual)
    p = np.clip(_host(prob), _EPS, 1 - _EPS)
    w = np.ones_like(y) if weights is None else _host(weights)
    ok = ~np.isnan(y) & ~np.isnan(p) & (w > 0)
    y, p, w = y[ok], p[ok], w[ok]
    sw = w.sum()
    logloss = float(-(w * (y * np.log(p) + (1 - y) * np.log(1 - p))).sum() / sw)
    mse = float((w * (y - p) ** 2).sum() / sw)
    auc = _weighted_auc(y, p, w)

    # threshold table (the AUC2 criterion surface)
    thresholds = np.unique(np.quantile(p, np.linspace(0, 1, 400)))
    table = _threshold_table(y, p, w, thresholds)
    mx = _max_criteria(table, thresholds)
    f1 = table["f1"]
    best = int(np.nanargmax(f1)) if not np.all(np.isnan(f1)) else 0
    best_thr = float(thresholds[best])

    order = np.argsort(-p, kind="mergesort")
    # tied scores collapse to one mass each: KS and gains are defined over
    # realizable thresholds (a constant predictor has KS 0, whatever the
    # row order)
    first = np.concatenate([[0], np.nonzero(np.diff(p[order]))[0] + 1])
    gl_rows, ks = _gains_lift(np.add.reduceat((w * y)[order], first),
                              np.add.reduceat((w * (1 - y))[order], first))
    return ModelMetrics("binomial", {
        "auc": auc,
        "pr_auc": _pr_auc(y, p, w),
        "gini": 2 * auc - 1,
        "logloss": logloss,
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mean_per_class_error": float(
            1.0 - mx["max_mean_per_class_accuracy"]["value"]),
        "default_threshold": best_thr,
        "max_f1": mx["max_f1"]["value"],
        "confusion_matrix": _confusion(y, p, w, best_thr),
        "max_criteria": mx,
        "nobs": int(ok.sum()),
        "gains_lift_table": gl_rows,
        "ks": ks,
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


def _threshold_table(y, p, w, thresholds, block: int = 16) -> dict:
    """The criterion surface at each threshold, a row predicted positive at
    ``p >= t`` — JAX's ``_threshold_table``, its (thresholds × rows) mask
    taken ``block`` thresholds at a time so the host holds (block, n), not
    (400, n); each threshold's sums are the same row sums as JAX's."""
    wpos = (w * (y == 1))[None, :]
    wneg = (w * (y == 0))[None, :]
    tp = np.empty(len(thresholds))
    fp = np.empty(len(thresholds))
    for i in range(0, len(thresholds), block):
        pred = p[None, :] >= thresholds[i: i + block, None]
        tp[i: i + block] = (pred * wpos).sum(1)
        fp[i: i + block] = (pred * wneg).sum(1)
    fn = wpos.sum() - tp
    tn = wneg.sum() - fp
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = tp / (tp + fp)
        recall = tp / (tp + fn)
        specificity = tn / (tn + fp)
        accuracy = (tp + tn) / (tp + fp + fn + tn)
        f1 = 2 * precision * recall / (precision + recall)
        f2 = 5 * precision * recall / (4 * precision + recall)
        f05 = 1.25 * precision * recall / (0.25 * precision + recall)
        mcc = (tp * tn - fp * fn) / np.sqrt(
            (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        min_pca = np.minimum(recall, specificity)
        mean_pca = 0.5 * (recall + specificity)
    return {
        "f1": f1, "f2": f2, "f0point5": f05, "accuracy": accuracy,
        "precision": precision, "recall": recall, "specificity": specificity,
        "mcc": np.abs(mcc), "min_per_class_accuracy": min_pca,
        "mean_per_class_accuracy": mean_pca,
    }


def _max_criteria(table: dict, thresholds) -> dict:
    """``{max_<criterion>: {threshold, value}}``; a criterion that is NaN
    everywhere (constant predictions) reports threshold 0.5 and NaN."""
    mx = {}
    for name, vals in table.items():
        if np.all(np.isnan(vals)):
            mx[f"max_{name}"] = {"threshold": 0.5, "value": float("nan")}
        else:
            i = int(np.nanargmax(vals))
            mx[f"max_{name}"] = {"threshold": float(thresholds[i]),
                                 "value": float(vals[i])}
    return mx


def _confusion(y, p, w, thr) -> list[list[float]]:
    """``[[tn, fp], [fn, tp]]`` weighted, predicted positive at ``p >= thr``."""
    pred = (p >= thr).astype(np.float64)
    tp = float((w * ((y == 1) & (pred == 1))).sum())
    fp = float((w * ((y == 0) & (pred == 1))).sum())
    fn = float((w * ((y == 1) & (pred == 0))).sum())
    tn = float((w * ((y == 0) & (pred == 0))).sum())
    return [[tn, fp], [fn, tp]]


def multinomial_metrics(actual, probs, weights=None,
                        domain: tuple = ()) -> ModelMetrics:
    """``actual`` class ids (-1 or NaN: no response); ``probs`` (n, K)."""
    if _on_device(actual, probs, weights):
        return _multinomial_metrics_device(actual, probs, weights, domain)
    y = _host(actual)
    P = np.clip(_host(probs), _EPS, 1.0)
    w = np.ones(len(y), np.float64) if weights is None else _host(weights)
    ok = ~np.isnan(y) & (y >= 0) & (w > 0) & ~np.isnan(P).any(axis=1)
    y, P, w = y[ok].astype(np.int64), P[ok], w[ok]
    sw = w.sum()
    K = P.shape[1]

    logloss = float(-(w * np.log(P[np.arange(len(y)), y])).sum() / sw)
    pred = P.argmax(axis=1)
    err = float((w * (pred != y)).sum() / sw)

    cm = np.zeros((K, K))
    np.add.at(cm, (y, pred), w)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class_err = 1.0 - np.diag(cm) / cm.sum(axis=1)

    # top-k hit ratios (h2o reports up to 10)
    order = np.argsort(-P, axis=1)
    ranks = np.argmax(order == y[:, None], axis=1)
    topk = [float((w * (ranks <= k)).sum() / sw) for k in range(min(10, K))]

    onehot = np.zeros_like(P)
    onehot[np.arange(len(y)), y] = 1.0
    mse = float((w[:, None] * (onehot - P) ** 2).sum() / sw)
    return ModelMetrics("multinomial", {
        "logloss": logloss,
        "classification_error": err,
        "mean_per_class_error": float(np.nanmean(per_class_err)),
        "per_class_error": per_class_err,
        "confusion_matrix": cm,
        "hit_ratios": topk,
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "nobs": int(ok.sum()),
    }, domain=domain)


# --------------------------------------------------------------------------
# device-stats path (CUDA inputs; see the module docstring)


def _gains_lift(wpos_desc, wneg_desc, groups: int = 16):
    """Gains/lift table and Kolmogorov-Smirnov from positive/negative weight
    mass ordered by DESCENDING score (per score bucket here) — JAX's
    ``_gains_lift``. Returns (rows, ks)."""
    wpos = np.asarray(wpos_desc, np.float64)
    wneg = np.asarray(wneg_desc, np.float64)
    w = wpos + wneg
    cum_w = np.cumsum(w)
    cum_pos = np.cumsum(wpos)
    cum_neg = np.cumsum(wneg)
    tot, tot_pos, tot_neg = cum_w[-1], cum_pos[-1], cum_neg[-1]
    if tot <= 0 or tot_pos <= 0 or tot_neg <= 0:
        return [], float("nan")
    ks = float(np.max(np.abs(cum_pos / tot_pos - cum_neg / tot_neg)))
    overall = tot_pos / tot
    rows = []
    prev_i = -1
    prev_pos = prev_w = 0.0
    for g in range(1, groups + 1):
        i = int(np.searchsorted(cum_w, tot * g / groups - 1e-12))
        i = min(i, len(w) - 1)
        if i <= prev_i:
            continue  # degenerate tiny group (ties/few rows): merge forward
        grp_w = cum_w[i] - prev_w
        grp_pos = cum_pos[i] - prev_pos
        rate = grp_pos / grp_w if grp_w > 0 else float("nan")
        rows.append({
            "group": len(rows) + 1,
            "cumulative_data_fraction": float(cum_w[i] / tot),
            "lower_threshold_index": int(i),
            "response_rate": float(rate),
            "lift": float(rate / overall),
            "cumulative_response_rate": float(cum_pos[i] / cum_w[i]),
            "cumulative_lift": float((cum_pos[i] / cum_w[i]) / overall),
            "capture_rate": float(grp_pos / tot_pos),
            "cumulative_capture_rate": float(cum_pos[i] / tot_pos),
            "gain": float(100.0 * (rate / overall - 1.0)),
            "cumulative_gain": float(
                100.0 * ((cum_pos[i] / cum_w[i]) / overall - 1.0)),
        })
        prev_i, prev_pos, prev_w = i, cum_pos[i], cum_w[i]
    return rows, ks


def _bucket_hist(b: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """(n,) bucket ids + (n, S) stats -> (NBUCKETS, S) sums: one
    ``index_add_`` (JAX's one-hot matrix product is a TPU idiom)."""
    out = torch.zeros(_NBUCKETS, stats.shape[1], dtype=stats.dtype,
                      device=stats.device)
    return out.index_add_(0, b.long(), stats)


def _binom_device_stats(y, p, w) -> torch.Tensor:
    """The binomial sufficient statistics, packed: [logloss sum, mse sum,
    sum of weights, nobs (int32 bits), wpos/wneg per bucket]."""
    ok = ~torch.isnan(y) & ~torch.isnan(p) & (w > 0)
    wok = torch.where(ok, w, 0.0)
    # zero masked values BEFORE arithmetic: 0 * NaN = NaN would poison the
    # weighted sums the ok-mask is meant to exclude
    y = torch.where(ok, y, 0.0)
    pc = torch.clamp(torch.where(ok, p, 0.5), _EPS, 1 - _EPS)
    ypos = y == 1
    logloss_sum = -(wok * torch.where(ypos, torch.log(pc),
                                      torch.log1p(-pc))).sum()
    mse_sum = (wok * (y - pc) ** 2).sum()
    # nobs travels as int32 bits: counts past 2^24 do not fit a float32
    nobs = ok.sum().to(torch.int32).reshape(1).view(torch.float32)
    b = torch.clamp((pc * _NBUCKETS).to(torch.int32), 0, _NBUCKETS - 1)
    table = _bucket_hist(b, torch.stack([wok * ypos, wok * ~ypos], dim=1))
    head = torch.cat([torch.stack([logloss_sum, mse_sum, wok.sum()]), nobs])
    return torch.cat([head, table.reshape(-1)])


def _binomial_metrics_device(actual, prob, weights, domain) -> ModelMetrics:
    y, p, w = _stat_inputs(actual, prob, weights)
    w = torch.ones_like(p) if w is None else w
    packed = _binom_device_stats(y, p, w).cpu().numpy()  # one transfer
    ll_s, mse_s, sw = (float(v) for v in packed[:3])
    nobs = int(packed[3:4].view(np.int32)[0])
    table = packed[4:].astype(np.float64).reshape(_NBUCKETS, 2)
    return _binomial_from_stats(ll_s, mse_s, sw, nobs, table, domain)


def _binomial_from_stats(ll_s, mse_s, sw, nobs, table,
                         domain) -> ModelMetrics:
    """The binomial metrics from the sufficient statistics: the weighted
    logloss and squared-error sums, the sum of weights, the row count and
    the (NBUCKETS, 2) ``(wpos, wneg)`` score histogram."""
    logloss = ll_s / sw
    mse = mse_s / sw
    wpos_b, wneg_b = table[:, 0], table[:, 1]
    tot_pos, tot_neg = wpos_b.sum(), wneg_b.sum()

    # AUC with each bucket a tie group (H2O AUC2 semantics)
    below_neg = np.concatenate([[0.0], np.cumsum(wneg_b)[:-1]])
    auc = (float((wpos_b * (below_neg + 0.5 * wneg_b)).sum()
                 / (tot_pos * tot_neg))
           if tot_pos > 0 and tot_neg > 0 else float("nan"))

    # threshold surface from bucket cumulatives: thr_b = b / NBUCKETS,
    # predicted positive = buckets >= b
    tp = np.cumsum(wpos_b[::-1])[::-1]
    fp = np.cumsum(wneg_b[::-1])[::-1]
    fn = tot_pos - tp
    tn = tot_neg - fp
    thresholds = np.arange(_NBUCKETS) / _NBUCKETS
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = tp / (tp + fp)
        recall = tp / np.maximum(tot_pos, _EPS)
        specificity = tn / np.maximum(tot_neg, _EPS)
        accuracy = (tp + tn) / sw
        f1 = 2 * precision * recall / (precision + recall)
        f2 = 5 * precision * recall / (4 * precision + recall)
        f05 = 1.25 * precision * recall / (0.25 * precision + recall)
        mcc = (tp * tn - fp * fn) / np.sqrt(
            (tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
        min_pca = np.minimum(recall, specificity)
        mean_pca = 0.5 * (recall + specificity)
    tbl = {
        "f1": f1, "f2": f2, "f0point5": f05, "accuracy": accuracy,
        "precision": precision, "recall": recall, "specificity": specificity,
        "mcc": np.abs(mcc), "min_per_class_accuracy": min_pca,
        "mean_per_class_accuracy": mean_pca,
    }
    # PR-AUC over the descending-threshold sweep
    pr, rc = precision[::-1], recall[::-1]
    okm = ~np.isnan(pr)
    pr_auc = (float(np.trapezoid(pr[okm], rc[okm])) if okm.any()
              else float("nan"))
    mx = _max_criteria(tbl, thresholds)
    bi = int(np.nanargmax(f1)) if not np.all(np.isnan(f1)) else 0
    cm = [[float(tn[bi]), float(fp[bi])], [float(fn[bi]), float(tp[bi])]]
    gl_rows, ks = _gains_lift(wpos_b[::-1], wneg_b[::-1])
    return ModelMetrics("binomial", {
        "auc": auc,
        "pr_auc": pr_auc,
        "gini": 2 * auc - 1,
        "logloss": logloss,
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mean_per_class_error": float(
            1.0 - mx["max_mean_per_class_accuracy"]["value"]),
        "default_threshold": float(thresholds[bi]),
        "max_f1": mx["max_f1"]["value"],
        "confusion_matrix": cm,
        "max_criteria": mx,
        "nobs": nobs,
        "gains_lift_table": gl_rows,
        "ks": ks,
    }, domain=domain)


def _multinomial_device_stats(y, P, w) -> torch.Tensor:
    """The multinomial sufficient statistics, packed: [logloss sum, error
    sum, mse sum, sum of weights, nobs (int32 bits), the K×K confusion
    matrix (true class by row), the weight of each rank of the true class
    (1024 buckets; rank = classes with a strictly larger probability)]."""
    n, K = P.shape
    ok = ~torch.isnan(y) & (y >= 0) & (w > 0) & ~torch.isnan(P).any(dim=1)
    wok = torch.where(ok, w, 0.0)
    ysafe = torch.where(ok, y, 0.0).long().clamp(0, K - 1)
    # zero masked rows before arithmetic (0 * NaN = NaN)
    Pc = torch.clamp(torch.where(ok[:, None], P, 1.0 / K), _EPS, 1.0)
    p_true = Pc.gather(1, ysafe[:, None])[:, 0]
    ll_s = -(wok * torch.log(p_true)).sum()
    pred = torch.argmax(Pc, dim=1)
    err_s = (wok * (pred != ysafe)).sum()
    cm = torch.zeros(K * K, dtype=torch.float32, device=P.device)
    cm.index_add_(0, ysafe * K + pred, wok)
    rank = (Pc > p_true[:, None]).sum(dim=1).clamp(max=_NBUCKETS - 1)
    rank_hist = _bucket_hist(rank, wok[:, None])[:, 0]
    oh_y = torch.nn.functional.one_hot(ysafe, K).to(torch.float32)
    mse_s = (wok[:, None] * (oh_y - Pc) ** 2).sum()
    nobs = ok.sum().to(torch.int32).reshape(1).view(torch.float32)
    head = torch.cat([torch.stack([ll_s, err_s, mse_s, wok.sum()]), nobs])
    return torch.cat([head, cm, rank_hist])


def _multinomial_metrics_device(actual, probs, weights,
                                domain) -> ModelMetrics:
    y, P, w = _stat_inputs(actual, probs, weights)
    w = torch.ones_like(y) if w is None else w
    K = P.shape[1]
    packed = _multinomial_device_stats(y, P, w).cpu().numpy()  # one transfer
    ll_s, err_s, mse_s, sw = (float(v) for v in packed[:4])
    nobs = int(packed[4:5].view(np.int32)[0])
    cm = packed[5: 5 + K * K].astype(np.float64).reshape(K, K)
    rank_hist = packed[5 + K * K:].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class_err = 1.0 - np.diag(cm) / cm.sum(axis=1)
    topk = np.cumsum(rank_hist[: min(10, K)]) / sw
    mse = mse_s / sw
    return ModelMetrics("multinomial", {
        "logloss": ll_s / sw,
        "classification_error": err_s / sw,
        "mean_per_class_error": float(np.nanmean(per_class_err)),
        "per_class_error": per_class_err,
        "confusion_matrix": cm,
        "hit_ratios": [float(t) for t in topk],
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "nobs": nobs,
    }, domain=domain)


def _regression_device_stats(a, p, w) -> torch.Tensor:
    """The regression sufficient statistics, packed: [sw, mse sum, mae sum,
    sum of a, centred sum of a², loggable, rmsle sum, poisson and gamma
    deviance sums, nobs (int32 bits)]."""
    ok = ~torch.isnan(a) & ~torch.isnan(p) & (w > 0)
    wok = torch.where(ok, w, 0.0)
    a0 = torch.where(ok, a, 0.0)
    p0 = torch.where(ok, p, 0.0)
    sw = wok.sum()
    err = a0 - p0
    sa = (wok * a0).sum()
    # CENTRED second moment: E[a²]−E[a]² cancels catastrophically in
    # float32 for large-mean targets
    mean_a = sa / torch.clamp(sw, min=1e-30)
    saa = (wok * (a0 - mean_a) ** 2).sum()
    loggable = torch.where(ok, (a0 > -1) & (p0 > -1), True).all()
    le = (torch.log1p(torch.clamp(a0, min=-1 + 1e-12))
          - torch.log1p(torch.clamp(p0, min=-1 + 1e-12)))
    pe = torch.clamp(p0, min=_EPS)
    ae = torch.clamp(a0, min=_EPS)
    pois = (2 * wok * (torch.where(a0 > 0, a0 * torch.log(ae / pe), 0.0)
                       - (a0 - p0))).sum()
    gam = (2 * wok * (-torch.log(ae / pe) + (ae - pe) / pe)).sum()
    nobs = ok.sum().to(torch.int32).reshape(1).view(torch.float32)
    return torch.cat([torch.stack([
        sw, (wok * err ** 2).sum(), (wok * err.abs()).sum(), sa, saa,
        loggable.to(torch.float32), (wok * le * le).sum(), pois, gam]), nobs])


def _regression_metrics_device(actual, pred, weights,
                               distribution) -> ModelMetrics:
    a, p, w = _stat_inputs(actual, pred, weights)
    w = torch.ones_like(a) if w is None else w
    packed = _regression_device_stats(a, p, w).cpu().numpy()  # one transfer
    nobs = int(packed[9:10].view(np.int32)[0])
    return _regression_from_stats(packed[:9].astype(np.float64), nobs,
                                  distribution)


def _regression_from_stats(stats, nobs: int, distribution) -> ModelMetrics:
    """The regression metrics from ``_regression_device_stats``' first nine
    sums (the centred second moment included) and the row count."""
    sw, mse_s, mae_s, _, saa, loggable, rmsle_s, pois, gam = (
        float(v) for v in stats)
    mse = mse_s / sw
    mae = mae_s / sw
    ss_tot = saa / sw  # already centred on the device
    rmsle = float(np.sqrt(rmsle_s / sw)) if loggable else float("nan")
    dev_ = {"poisson": pois / sw, "gamma": gam / sw,
            "laplace": mae}.get(distribution, mse)
    return ModelMetrics("regression", {
        "mse": mse,
        "rmse": float(np.sqrt(mse)),
        "mae": mae,
        "rmsle": rmsle,
        "r2": float(1.0 - mse / ss_tot) if ss_tot > 0 else float("nan"),
        "mean_residual_deviance": dev_,
        "nobs": nobs,
    })


def metrics_of_blocks(kind: str, blocks, domain=("0", "1"),
                      distribution: str = "gaussian") -> ModelMetrics:
    """Device-stats binomial (``kind`` "binomial": P(class 1)) or
    regression metrics over row blocks ``(actual, pred, weights)`` on the
    card — the out-of-core lanes' training metrics, which never hold the
    rows at once: each block's sufficient statistics reduce on the card,
    all blocks' come back in one transfer and combine in float64 on the
    host (bucket histograms and sums add; the centred second moment
    combines by the blocks' means)."""
    stats = [_binom_device_stats if kind == "binomial"
             else _regression_device_stats]
    parts = []
    for a, p, w in blocks:
        a, p, w = _stat_inputs(a, p, w)
        parts.append(stats[0](a, p, w))
    packed = torch.stack(parts).cpu().numpy()  # one transfer
    if kind == "binomial":
        nobs = int(packed[:, 3:4].view(np.int32).sum())
        tot = packed.astype(np.float64).sum(axis=0)
        return _binomial_from_stats(
            tot[0], tot[1], tot[2], nobs,
            tot[4:].reshape(_NBUCKETS, 2), domain)
    nobs = int(packed[:, 9:10].view(np.int32).sum())
    st = packed[:, :9].astype(np.float64)
    sw_b, sa_b = st[:, 0], st[:, 3]
    tot = st.sum(axis=0)
    mean_b = np.where(sw_b > 0, sa_b / np.maximum(sw_b, 1e-30), 0.0)
    mean = tot[3] / max(tot[0], 1e-30)
    tot[4] = st[:, 4].sum() + (sw_b * (mean_b - mean) ** 2).sum()
    tot[5] = float(st[:, 5].all())
    return _regression_from_stats(tot, nobs, distribution)
