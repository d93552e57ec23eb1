"""UpliftDRF — the port of ``h2o3_tpu/models/uplift.py``: a random forest
for heterogeneous treatment effects (Rzepakowski & Jaroszewicz divergence
splitting).

One histogram per level carries four stat lanes, {w_t, w_t·y, w_c, w_c·y}
(kernel B1 on the card, its plain version on the CPU), so each (node,
column, bin) holds the treatment and the control outcome counts. The split
scan (:func:`_uplift_split_scan`, plain PyTorch as it is plain ``jnp`` in
JAX) scores

    gain = (n_L/n)·D(P_t^L, P_c^L) + (n_R/n)·D(P_t^R, P_c^R) − D(P_t, P_c)

for D in {KL, ChiSquared, Euclidean} over the binary outcome, with prefix
splits in bin order (numeric) and in observed-uplift order (categorical).
A leaf holds the uplift estimate p_t − p_c; the records and their replay
are the tree builder's (``shared_tree.TreeLevel``, ``_partition_update``).

A tree grows level by level in an eager loop. On the card it reads
nothing from the host: every level runs at its padded width, and the levels
after the one that split nothing record all-leaf, zero-valued nodes, as
JAX's whole-tree uplift program does (``_uplift_tree_program``); on the CPU
the loop stops at that level, as JAX's per-level loop does. The two give
the same trees on every real level.

Rows are bootstrapped per tree (``sample_rate``) and each node draws its
candidate columns (``mtries``) by the keyed draws of ``sampling.py``:
torch cannot reproduce ``jax.random``, so the draws have JAX's
distribution, not its bits; at ``sample_rate`` 1 and all columns (the
``mtries`` default -2) nothing is drawn and the forest is JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree import sampling
from h2o3_tpu_torch.models.tree.binning import bin_frame, fit_bins
from h2o3_tpu_torch.models.tree.shared_tree import (
    Tree,
    TreeLevel,
    _partition_update,
    _split_draw,
)
from h2o3_tpu_torch.ops.histogram import histogram, node_totals

_NEG = -1e30


@dataclass
class UpliftDRFParams(CommonParams):
    nbins_cats: int = 1024
    treatment_column: str = "treatment"
    uplift_metric: str = "KL"  # KL | ChiSquared | Euclidean
    ntrees: int = 50
    max_depth: int = 10
    min_rows: float = 10.0
    mtries: int = -2  # -2: all columns (H2O's uplift default)
    sample_rate: float = 0.632
    nbins: int = 255
    min_split_improvement: float = 1e-5
    score_tree_interval: int = 10


def _divergence(pt, pc, metric: str):
    """D(P_t || P_c) of two Bernoulli distributions given their success
    probabilities."""
    eps = 1e-9
    pt = torch.clamp(pt, eps, 1 - eps)
    pc = torch.clamp(pc, eps, 1 - eps)
    if metric == "kl":
        return (pt * torch.log(pt / pc)
                + (1 - pt) * torch.log((1 - pt) / (1 - pc)))
    if metric == "chisquared":
        return (pt - pc) ** 2 / pc + ((1 - pt) - (1 - pc)) ** 2 / (1 - pc)
    return (pt - pc) ** 2 + ((1 - pt) - (1 - pc)) ** 2  # euclidean


def _rate(num, den):
    return torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0)


def _node_div(s, metric: str, min_rows):
    """Per-cell divergence, validity (both arms at least ``min_rows``) and
    weight from stacked stats (..., 4)."""
    wt, wyt, wc, wyc = s[..., 0], s[..., 1], s[..., 2], s[..., 3]
    d = _divergence(_rate(wyt, wt), _rate(wyc, wc), metric)
    ok = (wt >= min_rows) & (wc >= min_rows)
    return d, ok, wt + wc


def _take(a, idx):
    """``a[n, idx[n], ...]`` along axis 1 (JAX's ``take_along_axis``)."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def _uplift_split_scan(hist, is_cat, col_mask, min_rows,
                       min_split_improvement, metric: str) -> dict:
    """Best divergence-gain split per node from ``hist`` (N, C, B, 4):
    stats 0 = w_t, 1 = w_t·y, 2 = w_c, 3 = w_c·y; bin 0 is the NA bin.
    Every column gets both the numeric and the categorical scan, and
    ``is_cat`` picks, as in JAX (so a numeric winner's ``cat_mask`` is the
    categorical scan's, as JAX records it)."""
    N, C, B, _ = hist.shape
    total = hist.sum(dim=2)  # (N, C, 4)
    na = hist[:, :, 0, :]
    data = hist[:, :, 1:, :]
    d_parent, _, _ = _node_div(total[:, 0, :], metric, 0.0)

    def gain_of(L, R):
        dl, okl, nl = _node_div(L, metric, min_rows)
        dr, okr, nr = _node_div(R, metric, min_rows)
        n = torch.clamp(nl + nr, min=1e-30)
        g = (nl / n) * dl + (nr / n) * dr - d_parent[:, None, None]
        return torch.where(okl & okr, g, _NEG)

    def prefix_scan(d):
        """Gains of the prefix splits of ``d`` (N, C, B-1, 4), NA left or
        right: (best index, its gain, NA goes left)."""
        cum = torch.cumsum(d, dim=2)
        left = cum[:, :, :-1, :]
        right = cum[:, :, -1:, :] - left
        g_nl = gain_of(left + na[:, :, None, :], right)
        g_nr = gain_of(left, right + na[:, :, None, :])
        t = torch.argmax(torch.maximum(g_nl, g_nr), dim=2, keepdim=True)
        gl, gr = g_nl.gather(2, t).squeeze(2), g_nr.gather(2, t).squeeze(2)
        return t.squeeze(2), torch.maximum(gl, gr), gl >= gr

    num_t, num_gain, num_na_left = prefix_scan(data)
    # categorical: prefix splits in observed-uplift order of the bins
    up = (torch.where(data[..., 0] > 0, data[..., 1]
                      / torch.clamp(data[..., 0], min=1e-30), torch.inf)
          - _rate(data[..., 3], data[..., 2]))
    order = torch.argsort(up, dim=2, stable=True)
    sdata = data.gather(2, order[..., None].expand(-1, -1, -1, 4))
    cat_k, cat_gain, cat_na_left = prefix_scan(sdata)

    col_gain = torch.where(is_cat[None, :], cat_gain, num_gain)
    col_gain = torch.where(col_mask > 0, col_gain, _NEG)
    best_col = torch.argmax(col_gain, dim=1)
    best_gain = _take(col_gain, best_col)
    split_bin = _take(num_t, best_col).to(torch.int32) + 1
    bc_is_cat = is_cat[best_col]
    bc_na_left = torch.where(bc_is_cat, _take(cat_na_left, best_col),
                             _take(num_na_left, best_col))
    ranks = torch.argsort(order, dim=2, stable=True)
    cat_left = _take(ranks, best_col) <= _take(cat_k, best_col)[:, None]
    cat_mask = torch.cat([bc_na_left[:, None], cat_left], dim=1)
    wt, wyt, wc, wyc = (total[:, 0, s] for s in range(4))
    return {"gain": best_gain, "ok": best_gain >= min_split_improvement,
            "col": best_col, "is_cat": bc_is_cat, "split_bin": split_bin,
            "na_left": bc_na_left, "cat_mask": cat_mask,
            "node_w": wt + wc, "uplift": _rate(wyt, wt) - _rate(wyc, wc)}


def _uplift_level(bins, nid, preds, varimp, stats, is_cat, col_keep,
                  min_rows, min_split_improvement, metric: str, *,
                  n_pad: int, n_pad_next: int, n_bins: int,
                  force_leaf: bool):
    """One uplift level (JAX's ``_uplift_level_fn``): the four-lane
    histogram, the split scan (or, at the terminal level, every node a
    leaf), the frontier cap, leaf values, varimp (in place) and the
    partition. Returns ``(nid, preds, n_split, record)``."""
    dev = bins.device
    hist = histogram(bins, nid, stats, n_pad, n_bins)
    if force_leaf:
        tot = node_totals(hist)
        wt, wyt, wc, wyc = (tot[:, s] for s in range(4))
        uplift = _rate(wyt, wt) - _rate(wyc, wc)
        ok = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        gain = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        split_col = split_bin = torch.zeros(n_pad, dtype=torch.int32,
                                            device=dev)
        is_cat_n = na_left = ok
        cat_mask = torch.zeros(n_pad, n_bins, dtype=torch.bool, device=dev)
        node_w = wt + wc
    else:
        col_mask = torch.ones(n_pad, bins.shape[1], device=dev)
        if col_keep is not None:
            col_mask = col_mask * col_keep
        sp = _uplift_split_scan(hist, is_cat, col_mask, min_rows,
                                min_split_improvement, metric)
        ok = sp["ok"]
        ok = ok & (2 * torch.cumsum(ok.to(torch.int32), dim=0) <= n_pad_next)
        gain = torch.where(ok, torch.clamp(sp["gain"], min=0.0), 0.0)
        split_col, split_bin = sp["col"], sp["split_bin"]
        is_cat_n, cat_mask, na_left = sp["is_cat"], sp["cat_mask"], \
            sp["na_left"]
        uplift, node_w = sp["uplift"], sp["node_w"]
    leaf_now = ~ok
    leaf_val = torch.where(leaf_now, uplift, 0.0).to(torch.float32)
    cs = torch.cumsum(ok.to(torch.int32), dim=0, dtype=torch.int32)
    child_base = torch.where(ok, 2 * (cs - 1), 0).to(torch.int32)
    varimp.index_add_(0, split_col.long(),
                      torch.where(ok, gain, 0.0).to(varimp.dtype))
    nid, preds = _partition_update(bins, nid, preds, split_col, split_bin,
                                   is_cat_n, cat_mask, na_left, leaf_now,
                                   leaf_val, child_base)
    record = {"node_w": node_w.to(torch.float32),
              "split_col": split_col.to(torch.int32),
              "split_bin": split_bin.to(torch.int32), "is_cat": is_cat_n,
              "cat_mask": cat_mask, "na_left": na_left, "leaf_now": leaf_now,
              "leaf_val": leaf_val, "child_base": child_base, "gain": gain}
    return nid, preds, cs[-1], record


def build_uplift_tree(bins, wt, y, wc, *, n_bins: int, is_cat_cols,
                      max_depth: int, min_rows: float,
                      min_split_improvement: float, col_sample_rate: float,
                      preds, varimp, metric: str, tree_key=None,
                      idx_hash=None, node_cap: int = 1024):
    """One uplift tree over ``bins`` (n, C) with treatment weights ``wt``,
    control weights ``wc`` and the 0/1 outcome ``y``; ``tree_key`` keys
    the per-split column draws when ``col_sample_rate`` < 1. ``preds``
    gains each row's leaf value, ``varimp`` the split gains (in place).
    Returns ``(Tree, preds)``."""
    dev = bins.device
    C = bins.shape[1]
    is_cat = torch.as_tensor(np.asarray(is_cat_cols, bool), device=dev)
    stats = torch.stack([wt, wt * y, wc, wc * y], dim=1).contiguous()
    nid = torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)
    tree = Tree()
    for depth in range(max_depth + 1):
        n_pad = min(1 << depth, node_cap)
        force_leaf = depth == max_depth
        col_keep = None
        if tree_key is not None and not force_leaf:
            col_keep = _split_draw(tree_key, depth, col_sample_rate, n_pad,
                                   C, C, idx_hash)
        nid, preds, n_split, rec = _uplift_level(
            bins, nid, preds, varimp, stats, is_cat, col_keep, min_rows,
            min_split_improvement, metric, n_pad=n_pad,
            n_pad_next=min(2 * n_pad, node_cap), n_bins=n_bins,
            force_leaf=force_leaf)
        tree.levels.append(TreeLevel(**rec))
        if dev.type == "cpu" and not force_leaf and int(n_split) == 0:
            break
    return tree, preds


class UpliftDRFModel(Model):
    algo = "upliftdrf"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """The forest's mean uplift per row, (n,) on the frame's device."""
        bins = bin_frame(self.output["bin_spec"], frame)
        preds = torch.zeros(bins.shape[0], dtype=torch.float32,
                            device=bins.device)
        for tree in self.output["trees"]:
            _, preds = tree.replay(bins, torch.zeros(
                bins.shape[0], dtype=torch.int32, device=bins.device), preds)
        return preds / max(self.output["ntrees_actual"], 1)

    def predict(self, frame: Frame) -> Frame:
        frame = self._apply_preprocessors(frame)
        return Frame([Vec(self._predict_raw(frame), NUM)], ["uplift_predict"])

    def _score_metrics(self, frame: Frame) -> MM.ModelMetrics:
        """AUUC, qini and ATE of the predictions on ``frame``."""
        u = self._predict_raw(frame).cpu().numpy()
        y = frame.vec(self.params.response_column).to_numpy()
        t = frame.vec(self.params.treatment_column).to_numpy()
        return _auuc_metrics(u, y, t)


def _auuc_metrics(uplift: np.ndarray, y: np.ndarray, treat: np.ndarray,
                  n_bins: int = 1000) -> MM.ModelMetrics:
    """Qini-style AUUC, the qini coefficient and the ATE from the
    predicted uplift, the outcome and the treatment flag (JAX's
    ``_auuc_metrics``, in float64 on the host)."""
    order = np.argsort(-uplift)
    y_s = y[order]
    t_s = (treat[order] > 0).astype(np.float64)
    n = len(y_s)
    ct = np.cumsum(t_s)
    cc = np.cumsum(1 - t_s)
    cyt = np.cumsum(y_s * t_s)
    cyc = np.cumsum(y_s * (1 - t_s))
    with np.errstate(divide="ignore", invalid="ignore"):
        lift = cyt - np.where(cc > 0, cyc * ct / np.maximum(cc, 1), 0.0)
    idx = np.linspace(0, n - 1, min(n, n_bins)).astype(np.int64)
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    auuc = float(trapezoid(lift[idx], idx) / n)
    total = lift[-1]
    qini = auuc - float(total * (n - 1) / 2.0 / n)
    ate = float((cyt[-1] / max(ct[-1], 1)) - (cyc[-1] / max(cc[-1], 1)))
    return MM.ModelMetrics("uplift", {"auuc": auuc, "qini": qini, "ate": ate,
                                      "nobs": float(n)})


class UpliftDRF(ModelBuilder):
    algo = "upliftdrf"
    PARAMS_CLS = UpliftDRFParams
    MODEL_CLS = UpliftDRFModel

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: UpliftDRFParams = self.params
        if p.ntrees < 1 or p.max_depth < 1:
            raise ValueError("ntrees and max_depth must be >= 1")
        yv = train.vec(p.response_column)
        if not yv.is_categorical() or yv.cardinality > 2:
            raise ValueError("upliftdrf needs a binary categorical response")
        if p.treatment_column not in train:
            raise ValueError(
                f"treatment_column {p.treatment_column!r} not in frame")
        tv = train.vec(p.treatment_column)
        if not tv.is_categorical() or tv.cardinality > 2:
            raise ValueError("treatment_column must be a 2-level factor")
        metric = p.uplift_metric.lower()
        if metric not in ("kl", "chisquared", "euclidean"):
            raise ValueError(f"unknown uplift_metric {p.uplift_metric!r}")

        feats = [n for n in self._x if n != p.treatment_column]
        # JAX's fit_bins_for
        spec = fit_bins(train, feats, nbins=p.nbins, seed=abs(p.seed) or 7,
                        nbins_cats=p.nbins_cats)
        bins = bin_frame(spec, train)
        dev = train.device
        C = len(feats)
        y_np = yv.to_numpy().astype(np.float64)
        t_np = tv.to_numpy().astype(np.float64)
        w_np = np.ones(train.nrow, np.float32)
        if p.weights_column:
            w_np *= np.nan_to_num(
                train.vec(p.weights_column).to_numpy()).astype(np.float32)
        w_np *= (y_np >= 0) & (t_np >= 0)
        w = torch.from_numpy(w_np).to(dev)
        y = torch.from_numpy(np.clip(np.nan_to_num(y_np, nan=0.0), 0, 1)
                             .astype(np.float32)).to(dev)
        tr = torch.from_numpy(np.clip(np.nan_to_num(t_np, nan=0.0), 0, 1)
                              .astype(np.float32)).to(dev)

        mtries = p.mtries
        if mtries in (-1, 0):
            mtries = max(1, int(np.sqrt(C)))
        elif mtries == -2:
            mtries = C
        col_rate = min(1.0, mtries / C)
        sample = sampling.Sampling(p.seed if p.seed and p.seed > 0 else 97,
                                   sample_rate=p.sample_rate,
                                   col_sample_rate=col_rate)
        idx_hash = (sampling.index_hash(1024 * C, dev) if col_rate < 1.0
                    else None)
        preds = torch.zeros(train.nrow, dtype=torch.float32, device=dev)
        varimp = torch.zeros(C, dtype=torch.float32, device=dev)
        trees: list[Tree] = []
        for m in range(p.ntrees):
            if m and self.stop_requested():
                break
            w_tree = sample.rows(m, w)
            tree, preds = build_uplift_tree(
                bins, w_tree * tr, y, w_tree * (1.0 - tr),
                n_bins=spec.max_bins, is_cat_cols=spec.is_cat,
                max_depth=p.max_depth, min_rows=p.min_rows,
                min_split_improvement=p.min_split_improvement,
                col_sample_rate=col_rate, preds=preds, varimp=varimp,
                metric=metric,
                tree_key=(sampling.split_key(sample.key, m, 0)
                          if col_rate < 1.0 else None),
                idx_hash=idx_hash)
            trees.append(tree)
        model = UpliftDRFModel(None, p, {
            "bin_spec": spec, "trees": trees, "names": feats,
            "varimp": varimp.cpu().numpy().astype(np.float64),
            "response_domain": tuple(yv.domain),
            "treatment_domain": tuple(tv.domain),
            "ntrees_actual": len(trees)})
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
