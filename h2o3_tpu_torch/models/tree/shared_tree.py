"""Level-wise tree builder — the port of ``h2o3_tpu/models/tree/shared_tree.py``
(split scan, leaf decision, partition update, the recorded ``Tree``, the
per-level ``build_tree`` loop with sibling subtraction, the whole-tree
build: ``WholeTreeBuilder``/``build_trees_scanned``, ``trees_from_stacked``
and ``replay_batch``, the counterparts of ``_fused_levels`` and
``build_trees_scanned``, and the out-of-core ``build_trees_streamed``).

The whole-tree build (the default, ``use_fused_trees``) runs the same steps
as below at every level, at padded shapes and with no host read, so that on
the card each tree is one CUDA-graph replay; ``build_tree`` is the eager
escape hatch (``H2O3_TPU_WHOLE_TREE=0``). Per level, in ``build_tree``
eagerly one Python iteration:

1. histogram — the lighter child of every split pair is built (kernel B1 on
   the card, ``ops/histogram.py``), its sibling is ``parent − built``;
2. split scan — numeric candidates per (node, column) (kernel B2 on the
   card, ``ops/split_cuda.py``; kernel B3 on monotone-constrained builds),
   categorical columns by mean-sorted prefix, then the lowest-index column
   argmax;
3. leaf decision and child-id assignment, compacted by a cumulative sum;
4. partition update — rows move to their child node, or add their leaf's
   value to the running prediction and retire with ``nid = -1``.

The terminal level needs no histogram: every node's {w, wy, wh} is its
parent's chosen-split child stats. The eager loop's records stay on the
device; the whole-tree build pulls a chunk's to the host in one transfer.
Prediction replays them with the same partition update.

A multinomial iteration grows K class trees on one (n, K) score matrix:
the targets and hessians of every class come from the scores as the
iteration found them, and class tree k moves column k (``_iter_head``).

Monotone constraints carry per-node ``[lo, hi]`` bounds from level to
level, starting unbounded at the root: leaf values clip to their node's
bounds, and the children of a split on a constrained column tighten to the
split's ``mid`` on the constrained side (``_child_bounds``).

Row and column sampling (``sampling.py``) draws by keys, not from a
generator: the row bootstrap of an iteration scales the weights (rows out
of it add nothing to the histograms but still walk the tree and get leaf
values), the per-tree draw masks a class tree's columns and the per-split
draw each node's candidates. The whole-tree build reads the keys' parts
from device buffers, so a graph draws anew on each replay and draws what
the eager loop draws for the same tree.

The tree variants, each read where JAX's builders read it: GOSS
(``H2O3_TPU_TREE_GOSS``) weighs each tree's rows after the bootstrap in
all three lanes; per-level bin coarsening (``H2O3_TPU_BIN_ADAPT``),
exclusive feature bundling (an ``EFBPlan``) and the lossguide leaf budget
(``max_leaves``) run on the whole-tree build only, as on JAX's fused lane.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch
from torch.profiler import record_function

from h2o3_tpu_torch import config
from h2o3_tpu_torch.models.tree import sampling
from h2o3_tpu_torch.models.tree.binning import (
    bucket_cols,
    bucket_nbins,
    expand_arrays,
    expand_hist,
)
from h2o3_tpu_torch.ops.histogram import histogram, node_totals
from h2o3_tpu_torch.ops.split_cuda import _NEG, fused_split_scan


def _split_scan(hist, is_cat, col_mask, min_rows, min_split_improvement,
                cat_cols=(), node_totals=None, mono=None, node_lo=None,
                node_hi=None) -> dict:
    """Best split per node from hist (N, C, B, 3), all plain PyTorch — the
    port of ``shared_tree._split_scan`` (numeric and categorical branches,
    and the ``mono`` branch), and the plain version of kernels B2 and B3.
    Stats axis: 0=w, 1=wy, 2=wh; bin 0 is the NA bin. ``node_totals``
    overrides the column-0 totals."""
    return fused_split_scan(
        hist, is_cat, col_mask, min_rows, min_split_improvement, cat_cols,
        node_totals=node_totals, plain=True, mono=mono, node_lo=node_lo,
        node_hi=node_hi)


def _partition_update(bins_u8, nid, preds, split_col, split_bin, is_cat,
                      cat_mask, na_left, leaf_now, leaf_val, child_base):
    """Rows move to their child node or retire into their leaf's value."""
    active = nid >= 0
    node = torch.where(active, nid, 0).long()
    C = bins_u8.shape[1]
    col = split_col[node].long().clamp(0, C - 1)
    b = bins_u8.gather(1, col[:, None]).squeeze(1).long()
    in_mask = cat_mask[node, b.clamp(max=cat_mask.shape[1] - 1)]
    go_left = torch.where(
        b == 0, na_left[node],
        torch.where(is_cat[node], in_mask, b <= split_bin[node]))
    child = child_base[node] + torch.where(go_left, 0, 1)
    retired = leaf_now[node]
    new_nid = torch.where(active, torch.where(retired, -1, child), -1)
    new_preds = preds + torch.where(active & retired, leaf_val[node], 0.0)
    return new_nid.to(torch.int32), new_preds


def _leaf_decide(ok, gain, node_w, node_wy, node_wh, split_col, split_bin,
                 is_cat_n, cat_mask, na_left, learn_rate, max_abs_leaf, n_pad,
                 node_lo=None, node_hi=None, reg=None):
    """Leaf decision + child-id assignment + the replayable record. Leaf
    values clip to ``[node_lo, node_hi]`` on monotone builds, before the
    ``max_abs_leaf`` clamp and the learn rate. ``reg`` ((2,) tensor
    ``[reg_lambda, reg_alpha]``, XGBoost's leaf regularization, or None on
    GBM's path) makes a leaf ``sign(wy)·max(|wy| - α, 0) / (wh + λ)``."""
    leaf_now = ~ok
    if reg is not None:
        num = torch.sign(node_wy) * torch.clamp(node_wy.abs() - reg[1],
                                                min=0.0)
        den = node_wh + reg[0]
        leaf_val = torch.where(den > 0, num / torch.clamp(den, min=1e-30),
                               0.0)
    else:
        leaf_val = torch.where(node_wh > 0,
                               node_wy / torch.clamp(node_wh, min=1e-30), 0.0)
    if node_lo is not None:  # monotone bound clamp
        leaf_val = torch.minimum(torch.maximum(leaf_val, node_lo), node_hi)
    leaf_val = torch.clamp(leaf_val, -max_abs_leaf, max_abs_leaf) * learn_rate
    leaf_val = torch.where(leaf_now, leaf_val, 0.0).to(torch.float32)
    cs = torch.cumsum(ok.to(torch.int32), dim=0, dtype=torch.int32)
    child_base = torch.where(ok, 2 * (cs - 1), 0).to(torch.int32)
    n_split = cs[-1] if n_pad else torch.zeros((), dtype=torch.int32)
    record = {
        "node_w": node_w.to(torch.float32),
        "split_col": split_col.to(torch.int32),
        "split_bin": split_bin.to(torch.int32),
        "is_cat": is_cat_n,
        "cat_mask": cat_mask,
        "na_left": na_left,
        "leaf_now": leaf_now,
        "leaf_val": leaf_val,
        "child_base": child_base,
        "gain": gain,
    }
    return leaf_now, leaf_val, child_base, cs, n_split, record


def _finish_level(bins_u8, nid, preds, varimp, ok, gain, node_w, node_wy,
                  node_wh, split_col, split_bin, is_cat_n, cat_mask, na_left,
                  learn_rate, max_abs_leaf, n_pad, node_lo=None, node_hi=None,
                  reg=None):
    """Leaf decision, varimp scatter (in place into ``varimp``), partition
    update, and the replayable record."""
    leaf_now, leaf_val, child_base, cs, n_split, record = _leaf_decide(
        ok, gain, node_w, node_wy, node_wh, split_col, split_bin, is_cat_n,
        cat_mask, na_left, learn_rate, max_abs_leaf, n_pad, node_lo, node_hi,
        reg)
    varimp.index_add_(0, split_col.long(),
                      torch.where(ok, gain, 0.0).to(varimp.dtype))
    nid, preds = _partition_update(
        bins_u8, nid, preds, split_col, split_bin, is_cat_n, cat_mask,
        na_left, leaf_now, leaf_val, child_base)
    return nid, preds, varimp, n_split, record, cs


def _child_bounds(ok, child_base, mono_col, mid, node_lo, node_hi,
                  n_pad_next: int):
    """Monotone child-bound propagation: children of a constrained split
    tighten to the parent's ``mid`` on the constrained side (left child at
    ``child_base``, right at ``child_base + 1``). Leaves write into one
    extra slot that is dropped, as JAX's out-of-bounds scatter drops them.
    Returns ``(new_lo, new_hi)`` sized ``n_pad_next``."""
    dev = mid.device
    inc = mono_col > 0
    dec = mono_col < 0
    l_lo = torch.where(dec, mid, node_lo)
    l_hi = torch.where(inc, mid, node_hi)
    r_lo = torch.where(inc, mid, node_lo)
    r_hi = torch.where(dec, mid, node_hi)
    li = torch.where(ok, child_base.long(), n_pad_next)
    ri = torch.where(ok, child_base.long() + 1, n_pad_next)
    new_lo = torch.full((n_pad_next + 1,), -torch.inf, device=dev)
    new_hi = torch.full((n_pad_next + 1,), torch.inf, device=dev)
    new_lo[li] = l_lo
    new_lo[ri] = r_lo
    new_hi[li] = l_hi
    new_hi[ri] = r_hi
    return new_lo[:n_pad_next], new_hi[:n_pad_next]


def _level_core(hist, bins_u8, nid, preds, varimp, cols_enabled, is_cat,
                min_rows, min_split_improvement, learn_rate, max_abs_leaf, *,
                n_pad: int, n_pad_next: int, cat_cols: tuple = (), mono=None,
                node_lo=None, node_hi=None, col_keep=None, reg=None,
                leaf_budget=None):
    """Split scan → decisions → partition for one level, given its histogram.

    Returns ``(nid, preds, varimp, n_split, record, pair_info, bounds)``;
    ``pair_info`` carries, per next-level child pair slot, what sibling
    subtraction needs: ``parent_idx``, ``valid``, ``build_left`` (the
    lighter child) and the chosen split's child stats ``Lst``/``Rst``.
    ``bounds`` is the next level's ``(node_lo, node_hi)`` on monotone builds
    (``mono`` given), else None. ``col_keep`` ((n_pad, C) float, or None
    for all) is the level's per-split column draw: a node's candidates are
    the enabled columns it drew. ``reg`` regularizes the leaf values
    (:func:`_leaf_decide`), never the split scan.

    ``leaf_budget`` ((1,) int32, ``grow_policy="lossguide"``) rations the
    level's splits by gain rank, as JAX's ``_level_core``: the candidates
    are ordered by a stable sort of their negated gains (ties to the lower
    node slot), only the first ``leaf_budget`` split, and the decremented
    budget comes back as ``pair_info["budget"]``. A budget at least the
    candidate count leaves the level as depth-wise growth makes it."""
    C = bins_u8.shape[1]
    col_mask = cols_enabled[None, :].expand(n_pad, C)
    if col_keep is not None:
        col_mask = col_mask * col_keep
    sp = fused_split_scan(hist, is_cat, col_mask, min_rows,
                          min_split_improvement, cat_cols, mono=mono,
                          node_lo=node_lo, node_hi=node_hi)
    ok = sp["ok"]
    # frontier cap: children must fit n_pad_next; later nodes go leaf
    ok = ok & (2 * torch.cumsum(ok.to(torch.int32), dim=0) <= n_pad_next)
    new_budget = None
    if leaf_budget is not None:
        order = torch.argsort(torch.where(ok, -sp["gain"], torch.inf),
                              stable=True)
        rank = torch.empty_like(order).scatter_(
            0, order, torch.arange(n_pad, device=order.device))
        ok = ok & (rank < leaf_budget)
        new_budget = (leaf_budget - ok.sum()).to(torch.int32)
    gain = torch.where(ok, torch.clamp(sp["gain"], min=0.0), 0.0)
    nid, preds, varimp, n_split, record, cs = _finish_level(
        bins_u8, nid, preds, varimp, ok, gain, sp["node_w"], sp["node_wy"],
        sp["node_wh"], sp["col"], sp["split_bin"], sp["is_cat"],
        sp["cat_mask"], sp["na_left"], learn_rate, max_abs_leaf, n_pad,
        node_lo, node_hi, reg)

    half = n_pad_next // 2
    pidx = torch.where(ok, cs.long() - 1, half)  # slot `half` is dropped

    def scat(init, vals):
        buf = torch.cat([init, init[:1]])
        buf[pidx] = vals
        return buf[:half]

    dev = hist.device
    pair_info = {
        "valid": scat(torch.zeros(half, dtype=torch.bool, device=dev),
                      torch.ones(n_pad, dtype=torch.bool, device=dev)),
        "parent_idx": scat(torch.zeros(half, dtype=torch.long, device=dev),
                           torch.arange(n_pad, device=dev)),
        "build_left": scat(torch.zeros(half, dtype=torch.bool, device=dev),
                           sp["Lst"][:, 0] <= sp["Rst"][:, 0]),
        "Lst": scat(torch.zeros(half, 3, device=dev), sp["Lst"]),
        "Rst": scat(torch.zeros(half, 3, device=dev), sp["Rst"]),
    }
    if new_budget is not None:
        pair_info["budget"] = new_budget
    bounds = None
    if mono is not None:
        bounds = _child_bounds(ok, record["child_base"], sp["mono_col"],
                               sp["mid"], node_lo, node_hi, n_pad_next)
    return nid, preds, varimp, n_split, record, pair_info, bounds


def leaf_reg(reg_lambda: float, reg_alpha: float):
    """``(reg_lambda, reg_alpha)``, or None when both are 0: the
    unregularized leaf, as JAX traces it."""
    if float(reg_lambda) == 0.0 and float(reg_alpha) == 0.0:
        return None
    return float(reg_lambda), float(reg_alpha)


def _split_draw(tree_key, depth, rate, n_pad: int, C: int, Cp: int,
                idx_hash) -> torch.Tensor:
    """The per-split column draw of one level at the real column count C,
    padded to ``Cp`` with columns no node keeps: (n_pad, Cp) float."""
    keep = sampling.split_cols(tree_key, depth, rate, n_pad, C, idx_hash)
    return torch.nn.functional.pad(keep.to(torch.float32), (0, Cp - C))


# ---------------------------------------------------------------------------
# GOSS, gradient-based one-side sampling (JAX's ``_goss_ab`` and
# ``_goss_factor``, after arXiv:1706.08359): the top-a fraction of the
# valid rows by |w·t| is kept, a b/(1-a) share of the rest is drawn and
# amplified by (1-a)/b so that the histogram sums stay unbiased, every
# other row weighs 0. It applies after the row bootstrap, to w, wy and wh.


def _goss_ab() -> tuple[float, float] | None:
    """``H2O3_TPU_TREE_GOSS='a,b'`` parsed and checked as JAX checks it;
    None when the knob is blank (GOSS off)."""
    raw = config.get("H2O3_TPU_TREE_GOSS").strip()
    if not raw:
        return None
    try:
        a_s, b_s = raw.split(",")
        a, b = float(a_s), float(b_s)
    except ValueError:
        raise ValueError(
            f"H2O3_TPU_TREE_GOSS must be 'a,b' (two floats), got {raw!r}"
        ) from None
    if not (0.0 <= a < 1.0):
        raise ValueError(f"GOSS top fraction a must be in [0, 1), got {a}")
    if not (0.0 < b <= 1.0 - a):
        raise ValueError(f"GOSS rest fraction b must be in (0, 1-a], got {b}")
    return a, b


def _goss_factor(w, wy, key, a: float, b: float,
                 idx_hash: torch.Tensor) -> torch.Tensor:
    """Per-row GOSS factor: 1 for the top-a valid rows (``w > 0``) by
    ``|wy|``, ``(1-a)/b`` for the drawn share of the rest, 0 otherwise.
    ``k = round(a · n_valid)`` rounds half to even in float32 and is a
    device scalar, so the threshold is the k-th value of one descending
    sort (no host read, capturable); rows tied at it are all kept, and
    invalid rows sort last as -inf. The rest draw is keyed by ``key``
    (``sampling.goss_key``) over ``idx_hash``."""
    valid = w > 0
    gmag = torch.where(valid, wy.abs(), -torch.inf)
    n_valid = valid.sum(dtype=torch.int32).to(torch.float32)
    k = torch.round(n_valid * a).to(torch.int64).reshape(1)
    srt = torch.sort(gmag, descending=True).values
    thr = srt.index_select(0, (k - 1).clamp(min=0))
    top = valid & (gmag >= thr) & (k > 0)
    # the constants are filled on the device: a graph capture takes no
    # host copy
    def const(v):
        return torch.full((), v, dtype=torch.float32, device=w.device)

    keep = (valid & ~top) & (sampling.uniform(key, idx_hash)
                             < const(b / (1.0 - a)))
    amp = torch.where(keep, const((1.0 - a) / b), 0.0)
    return torch.where(top, const(1.0), amp).to(w.dtype)


# GOSS tallies: trees sampled, the modeled kept rows ((a+b) · rows a
# tree, JAX's tree_rows_sampled_total), and the kept rows counted on each
# device without a host read (read by :func:`goss_stats`)
GOSS_EVENTS = {"trees": 0, "rows_modeled": 0.0}
_GOSS_KEPT: dict = {}


def _goss_count(kept: torch.Tensor) -> None:
    """Add a device count of kept rows to the device's tally, no sync."""
    acc = _GOSS_KEPT.get(str(kept.device))
    if acc is None:
        acc = _GOSS_KEPT[str(kept.device)] = torch.zeros(
            (), dtype=torch.int64, device=kept.device)
    acc.add_(kept.reshape(()).to(torch.int64))


def goss_stats() -> dict:
    """The GOSS tallies, the kept rows read from each device."""
    return {**GOSS_EVENTS,
            "rows_kept": sum(int(v) for v in _GOSS_KEPT.values())}


def _apply_goss(goss, w, wy, wh, key, idx_hash):
    """``(w, wy, wh)`` times the GOSS factor, and its kept-row count."""
    gf = _goss_factor(w, wy, key, goss[0], goss[1], idx_hash)
    return w * gf, wy * gf, wh * gf, (gf > 0).sum()


# ---------------------------------------------------------------------------
# per-level bin coarsening (JAX's ``H2O3_TPU_BIN_ADAPT``, the whole-tree
# lane only): from depth 3 each level halves the data bins of the static
# quantile codes, never below 63, so deep levels histogram and scan fewer
# bins. A coarse prefix split is a full-resolution prefix split, so the
# records keep ``split_bin << shift`` and replay, the tmojo and TreeSHAP
# see full-resolution codes. Frames with categorical columns never
# coarsen.

_BIN_ADAPT_START = 3  # the first depth allowed to coarsen
_BIN_ADAPT_MIN = 63  # never fewer data bins than this


def _bin_shifts(max_depth: int, n_bins: int, cat_cols: tuple) -> list[int]:
    """The coarsening shift of each level (all 0 when the knob is off or
    the frame has a categorical column)."""
    if cat_cols or not config.get_bool("H2O3_TPU_BIN_ADAPT"):
        return [0] * (max_depth + 1)
    D = n_bins - 1  # data bins (bin 0 is NA)
    out = []
    for d in range(max_depth + 1):
        s = max(d - (_BIN_ADAPT_START - 1), 0)
        while s > 0 and (D >> s) < _BIN_ADAPT_MIN:
            s -= 1
        out.append(s)
    return out


def _coarse_nbins(n_bins: int, s: int) -> int:
    return (-(-(n_bins - 1) // (1 << s))) + 1 if s else n_bins


def _coarsen_bins(bins_u8: torch.Tensor, s: int) -> torch.Tensor:
    if s == 0:
        return bins_u8
    b = bins_u8.to(torch.int32)
    return torch.where(b == 0, 0, ((b - 1) >> s) + 1).to(torch.uint8)


def _coarsen_hist(hist: torch.Tensor, ds: int) -> torch.Tensor:
    """Sum adjacent groups of 2**ds data bins (the NA bin passes)."""
    if ds == 0:
        return hist
    N, C, B, S = hist.shape
    data = hist[:, :, 1:, :]
    Dc = -(-(B - 1) // (1 << ds))
    pad = Dc * (1 << ds) - (B - 1)
    if pad:
        data = torch.nn.functional.pad(data, (0, 0, 0, pad))
    data = data.reshape(N, C, Dc, 1 << ds, S).sum(dim=3)
    return torch.cat([hist[:, :, :1, :], data], dim=2)


def _force_leaf_from_stats(bins_u8, nid, preds, varimp, node_w, node_wy,
                           node_wh, learn_rate, max_abs_leaf, n_pad, n_bins,
                           node_lo=None, node_hi=None, reg=None):
    """Terminal level: every active node becomes a leaf (no split scan).
    ``node_lo``/``node_hi`` clip the leaf values on monotone builds; ``reg``
    regularizes them (:func:`_leaf_decide`)."""
    dev = bins_u8.device
    ok = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    zi = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    nid, preds, varimp, n_split, record, _ = _finish_level(
        bins_u8, nid, preds, varimp, ok,
        torch.zeros(n_pad, dtype=torch.float32, device=dev),
        node_w, node_wy, node_wh, zi, zi, ok,
        torch.zeros(n_pad, n_bins, dtype=torch.bool, device=dev), ok,
        learn_rate, max_abs_leaf, n_pad, node_lo, node_hi, reg)
    return nid, preds, varimp, n_split, record


# host spans around each level's (or graph's) launches, by the widest
# level they run: ``tools/profile_gbm.py`` splits device time by them
_WIDE = 1024


def _width_span(width: int) -> str:
    return "tree.wide" if width > _WIDE else "tree.narrow"


def _clamp_node_cap(node_cap: int, npad: int, min_rows) -> int:
    """node_cap can't usefully exceed the next power of two ≥ the row count:
    with min_rows ≥ 1 a split needs two rows, so every frontier slot past
    that bound is dead padding."""
    if float(min_rows) < 1.0:
        return node_cap
    cap_rows = 1 << max(1, int(npad - 1).bit_length())
    return max(2, min(node_cap, cap_rows))


# ---------------------------------------------------------------------------
# recorded tree (prediction replay; fields are tensors on the build device)


@dataclass
class TreeLevel:
    split_col: torch.Tensor
    split_bin: torch.Tensor
    is_cat: torch.Tensor
    cat_mask: torch.Tensor
    na_left: torch.Tensor
    leaf_now: torch.Tensor
    leaf_val: torch.Tensor
    child_base: torch.Tensor
    gain: torch.Tensor | None = None  # per-node split gain (varimp source)
    node_w: torch.Tensor | None = None  # per-node weighted cover


REPLAY_FIELDS = ("split_col", "split_bin", "is_cat", "cat_mask", "na_left",
                 "leaf_now", "leaf_val", "child_base")


@dataclass
class Tree:
    levels: list[TreeLevel] = field(default_factory=list)

    def to_host(self) -> "Tree":
        """Every level as numpy arrays (export and inspection)."""
        out = Tree()
        for lv in self.levels:
            out.levels.append(TreeLevel(*[
                v if v is None or isinstance(v, np.ndarray) else v.cpu().numpy()
                for v in (getattr(lv, f.name) for f in fields(TreeLevel))]))
        return out

    def _replay_levels(self, dev) -> list[tuple]:
        """The replay fields of every level as tensors on ``dev``: trees
        pulled to the host by :func:`trees_from_stacked` upload once per
        device and keep the copy."""
        cache = self.__dict__.setdefault("_on_device", {})
        key = str(dev)
        if key not in cache:
            cache[key] = [tuple(torch.as_tensor(getattr(lv, f), device=dev)
                                for f in REPLAY_FIELDS) for lv in self.levels]
        return cache[key]

    def real_level_masks(self) -> list[np.ndarray]:
        """Mask of REAL node slots per level: level 0 has one real node,
        level i+1 has 2 × (real non-leaf nodes at level i), compacted to
        the front by child_base."""
        masks = []
        n_real = 1
        for lv in self.to_host().levels:
            m = np.arange(len(lv.leaf_now)) < n_real
            masks.append(m)
            n_real = 2 * int(np.sum(~lv.leaf_now & m))
        return masks

    @property
    def n_leaves(self) -> int:
        """Leaves among the real node slots (padding slots are all-leaf
        with zero stats and do not count)."""
        host = self.to_host()
        return int(sum(int(np.sum(lv.leaf_now & m)) for lv, m in
                       zip(host.levels, host.real_level_masks())))

    @property
    def depth(self) -> int:
        """Depth of the deepest real node (the recorded level count can
        exceed it when every branch retired early)."""
        d = 0
        for li, m in enumerate(self.real_level_masks()):
            if m.any():
                d = li
        return d

    def replay(self, bins_u8, nid, preds):
        """Accumulate this tree's contribution into preds (device walk)."""
        for lv in self._replay_levels(bins_u8.device):
            nid, preds = _partition_update(bins_u8, nid, preds, *lv)
        return nid, preds


# ---------------------------------------------------------------------------
# the level-wise builder


def _subtract_enabled() -> bool:
    return config.get_bool("H2O3_TPU_HIST_SUBTRACT")


def build_tree(bins_u8, w, t, h, *, n_bins: int, is_cat_cols, max_depth: int,
               min_rows: float, min_split_improvement: float,
               learn_rate: float, preds, varimp, cols_enabled=None,
               max_abs_leaf: float = float("inf"), node_cap: int = 2048,
               monotone=None, sample: "sampling.Sampling | None" = None,
               iteration: int = 0, cls: int = 0, reg=None):
    """Build one tree with one eager Python iteration per level.

    ``bins_u8`` (n, C) uint8 codes, per-row weight ``w`` (0 = out of this
    tree: the caller applies the row bootstrap), target ``t`` (residual)
    and hessian ``h``, all on one device; ``varimp`` a (C,) accumulator.
    ``monotone`` ((C,) ints in {-1, 0, 1}, or None) constrains the split
    scans (kernel B3 on the card) and clips leaves to the bounds carried
    from level to level. ``sample`` draws this tree's columns and each
    level's per-split columns, keyed by ``iteration`` and class ``cls`` as
    the whole-tree build keys them. ``reg`` (``(reg_lambda, reg_alpha)``,
    or None) regularizes the leaf values, as XGBoost's. Under
    ``H2O3_TPU_TREE_GOSS`` the weights, after the bootstrap, take the GOSS
    factor of this tree (keyed as the whole-tree build keys it). The loop
    neither coarsens bins nor bundles columns, as JAX's per-level loop.
    Returns ``(Tree, preds, varimp)``.
    ALL rows walk the tree: sampled-out rows add nothing to the histograms
    but still receive leaf predictions. Bins pad to a power of two and
    columns to a multiple of 4 (``bucket_nbins``/``bucket_cols``); the pad is
    inert — empty bins and all-NA masked columns never win a split."""
    dev = bins_u8.device
    C = bins_u8.shape[1]
    Cp = bucket_cols(C)
    n_bins = bucket_nbins(n_bins)
    node_cap = _clamp_node_cap(node_cap, bins_u8.shape[0], min_rows)
    node_cap = max(2, node_cap - (node_cap % 2))  # pairs need an even frontier
    is_cat_np = np.asarray(is_cat_cols, bool)
    cat_cols = tuple(int(i) for i in np.nonzero(is_cat_np)[0])
    is_cat_dev = torch.as_tensor(np.pad(is_cat_np, (0, Cp - C)), device=dev)
    if cols_enabled is None:
        cols_enabled = torch.ones(C, dtype=torch.float32, device=dev)
    cols_enabled = torch.as_tensor(cols_enabled, dtype=torch.float32,
                                   device=dev)
    tree_key = idx_hash = None
    smp = sample or sampling.Sampling()
    _, draw_split, draw_tree = smp.draws
    if draw_tree or draw_split:
        idx_hash = sampling.index_hash(node_cap * C, dev)
    if draw_tree:
        cols_enabled = cols_enabled * sampling.tree_cols(
            smp.key, iteration, cls, smp.col_sample_rate_per_tree, C, idx_hash)
    if draw_split:
        tree_key = sampling.split_key(smp.key, iteration, cls)
    if Cp > C:  # bucketed column pad: code 0 (NA) everywhere, masked
        bins_u8 = torch.nn.functional.pad(bins_u8, (0, Cp - C))
        cols_enabled = torch.nn.functional.pad(cols_enabled, (0, Cp - C))
    varimp_p = torch.zeros(Cp, dtype=torch.float32, device=dev)
    varimp_p[:C] = varimp
    mono = node_lo = node_hi = None
    if monotone is not None and np.any(np.asarray(monotone) != 0):
        # pad columns are unconstrained (and masked); the root is unbounded
        mono = torch.as_tensor(np.pad(np.asarray(monotone, np.int32),
                                      (0, Cp - C)), device=dev)
        node_lo = torch.full((1,), -torch.inf, device=dev)
        node_hi = torch.full((1,), torch.inf, device=dev)

    if reg is not None:
        reg = torch.tensor(reg, dtype=torch.float32, device=dev)
    wy = w * t
    wh = torch.where(w > 0, h, 0.0)  # sampled-out rows carry no hessian
    goss = _goss_ab()
    if goss is not None:
        w, wy, wh, kept = _apply_goss(
            goss, w, wy, wh, sampling.goss_key(smp.key, iteration, cls),
            sampling.index_hash(w.shape[0], dev))
        _goss_count(kept)
        GOSS_EVENTS["trees"] += 1
        GOSS_EVENTS["rows_modeled"] += (goss[0] + goss[1]) * w.shape[0]
    stats = torch.stack([w, wy, wh], dim=1).contiguous()
    subtract = _subtract_enabled()
    nid = torch.zeros(bins_u8.shape[0], dtype=torch.int32, device=dev)
    tree = Tree()
    parent_hist = pair_info = None
    for depth in range(max_depth + 1):
        n_pad = min(1 << depth, node_cap)
        with record_function(_width_span(n_pad)):
            n_pad_next = min(2 * n_pad, node_cap)
            force_leaf = depth == max_depth
            if force_leaf and subtract and pair_info is not None:
                # leaf stats straight from the parents' chosen splits
                st = torch.stack([pair_info["Lst"], pair_info["Rst"]],
                                 dim=1).reshape(n_pad, 3)
                nid, preds, varimp_p, n_split, rec = _force_leaf_from_stats(
                    bins_u8, nid, preds, varimp_p, st[:, 0], st[:, 1],
                    st[:, 2], learn_rate, max_abs_leaf, n_pad, n_bins,
                    node_lo, node_hi, reg)
                tree.levels.append(TreeLevel(**rec))
                break
            if depth == 0 or not subtract:
                hist = histogram(bins_u8, nid, stats, n_pad, n_bins)
            else:
                hist = _sibling_hist(bins_u8, nid, stats, n_pad, n_bins,
                                     parent_hist, pair_info)
            if force_leaf:
                tot = node_totals(hist)
                nid, preds, varimp_p, n_split, rec = _force_leaf_from_stats(
                    bins_u8, nid, preds, varimp_p, tot[:, 0], tot[:, 1],
                    tot[:, 2], learn_rate, max_abs_leaf, n_pad, n_bins,
                    node_lo, node_hi, reg)
            else:
                col_keep = None if tree_key is None else _split_draw(
                    tree_key, depth, smp.col_sample_rate, n_pad, C, Cp,
                    idx_hash)
                (nid, preds, varimp_p, n_split, rec, pair_info,
                 bounds) = _level_core(
                    hist, bins_u8, nid, preds, varimp_p, cols_enabled,
                    is_cat_dev, min_rows, min_split_improvement, learn_rate,
                    max_abs_leaf, n_pad=n_pad, n_pad_next=n_pad_next,
                    cat_cols=cat_cols, mono=mono, node_lo=node_lo,
                    node_hi=node_hi, col_keep=col_keep, reg=reg)
                if bounds is not None:
                    node_lo, node_hi = bounds
                parent_hist = hist
            tree.levels.append(TreeLevel(**rec))
            if force_leaf:
                break
            # early exit trades a blocking device→host read against running
            # empty levels: every level on the CPU, sparsely past depth 8 on
            # the card (the per-level JAX loop's rule)
            if dev.type == "cpu":
                if int(n_split) == 0:
                    break
            elif depth >= 8 and depth % 4 == 0 and int(n_split) == 0:
                break
    return tree, preds, varimp_p[:C]


def _sibling_hist(bins_u8, nid, stats, n_pad, n_bins, parent_hist, pair_info,
                  ds: int = 0, expand=None):
    """Sibling subtraction: histogram only the lighter child of each split
    pair (``n_pad // 2`` node slots); the heavier sibling is ``parent −
    built``. Children ``2i``/``2i+1`` share pair slot ``i``. ``ds`` is the
    coarsening shift from the parent's level to this one: the parent's
    histogram is summed down to this level's bins first. ``expand`` maps
    the built histogram of bundled codes (``bins_u8``, EFB) to the real
    columns."""
    half = n_pad // 2
    row_pair = torch.clamp(nid, min=0) >> 1
    row_left = (nid & 1) == 0
    bl = pair_info["build_left"]
    build_row = (nid >= 0) & (row_left == bl[row_pair.long()])
    nid_build = torch.where(build_row, row_pair, -1).to(torch.int32)
    built = histogram(bins_u8, nid_build, stats, half, n_bins)
    if expand is not None:
        built = expand(built)
    psel = torch.where(pair_info["valid"][:, None, None, None],
                       _coarsen_hist(parent_hist, ds)[pair_info["parent_idx"]],
                       0.0)
    sib = psel - built
    blb = bl[:, None, None, None]
    return torch.stack(
        [torch.where(blb, built, sib), torch.where(blb, sib, built)], dim=1
    ).reshape(n_pad, *built.shape[1:])


# ---------------------------------------------------------------------------
# whole-tree build: the counterpart of ``_fused_levels`` and
# ``build_trees_scanned``


def use_fused_trees() -> bool:
    """The whole-tree build, unless ``H2O3_TPU_WHOLE_TREE=0`` asks for the
    eager per-level loop. JAX also sends trees deeper than
    ``H2O3_TPU_FUSED_MAX_DEPTH`` to that loop, since its unrolled program
    grows with the depth; here any depth is at most three graphs (head,
    saturated level, tail), so no depth needs the other path."""
    return config.get_bool("H2O3_TPU_WHOLE_TREE")


def _sat_region(max_depth: int, node_cap: int, shifts=None) -> tuple:
    """``(start, count)`` of the node_cap-saturated levels: from the first
    level whose frontier is pinned at ``node_cap`` and whose coarsening
    shift is that of every level from the one before it on, to the last
    level before the terminal one, when that run has at least two levels
    (JAX's ``_sat_region``); ``(None, 0)`` otherwise. Every saturated level
    has the same shapes, so one body serves them all."""
    shifts = shifts or [0] * (max_depth + 1)
    for d in range(1, max_depth):
        if (min(1 << d, node_cap) == node_cap
                and len(set(shifts[d - 1: max_depth])) == 1):
            if max_depth - d >= 2:
                return d, max_depth - d
            break
    return None, 0


def scan_chunk_cap(max_depth: int, n_bins: int, node_cap: int = 2048,
                   budget_bytes: int = 256 << 20, n_classes: int = 1) -> int:
    """Most iterations per chunk such that the stacked records of their
    ``n_classes`` class trees each fit the budget (``cat_mask`` (T, N, B)
    dominates) — JAX's ``scan_chunk_cap`` at one class."""
    per_tree = 0
    for depth in range(max_depth + 1):
        n = min(1 << depth, node_cap)
        per_tree += n * (n_bins + 40)
    return max(1, int(budget_bytes // max(per_tree * n_classes, 1)))


# record field -> (dtype, the value a skipped level keeps): a skipped level
# is all-leaf, zero-valued and reached by no row, as JAX's placeholders are
_REC_FIELDS = {
    "node_w": (torch.float32, 0.0), "split_col": (torch.int32, 0),
    "split_bin": (torch.int32, 0), "is_cat": (torch.bool, False),
    "cat_mask": (torch.bool, False), "na_left": (torch.bool, False),
    "leaf_now": (torch.bool, True), "leaf_val": (torch.float32, 0.0),
    "child_base": (torch.int32, 0), "gain": (torch.float32, 0.0),
}
_PAIR_FIELDS = ("valid", "parent_idx", "build_left", "Lst", "Rst")


@dataclass(frozen=True)
class _Plan:
    """Everything a whole-tree program depends on besides its buffers'
    contents: the shapes, the static options and the scalars the kernels
    take by value. Equal plans share one set of CUDA graphs."""

    n: int
    C: int
    Cp: int
    n_bins: int
    max_depth: int
    node_cap: int
    cat_cols: tuple
    grad_key: tuple
    T: int  # record capacity: trees per chunk
    subtract: bool
    mono: bool
    min_rows: float
    min_split_improvement: float
    max_abs_leaf: float
    tiles: str  # H2O3_TPU_PALLAS_TILES: B1's geometry is baked in
    K: int = 1  # class trees per iteration, sharing one (n, K) F
    # which keyed draws the bodies make (their rates and seed are device
    # scalars of the state, so one graph serves every rate and seed)
    draw_rows: bool = False
    draw_split_cols: bool = False
    draw_tree_cols: bool = False
    # XGBoost's regularized leaves: lambda and alpha are device scalars of
    # the state, so one graph serves every lambda and alpha
    reg: bool = False
    # the tree variants, each baked into the graphs as JAX bakes them into
    # its program key: GOSS's (a, b), the coarsening shift of every level,
    # lossguide's leaf budget (0 = depth-wise) and the EFB plan's key with
    # its bundled column count (the plan itself rides along uncompared)
    goss: tuple | None = None
    shifts: tuple = ()
    max_leaves: int = 0
    efb: tuple | None = None
    Cb: int = 0
    efb_plan: object = field(default=None, compare=False, hash=False,
                             repr=False)

    def width(self, depth: int) -> int:
        return min(1 << depth, self.node_cap)

    def shift(self, depth: int) -> int:
        return self.shifts[depth] if self.shifts else 0

    def nbins_at(self, depth: int) -> int:
        """The histogram bins of level ``depth`` at its shift."""
        return _coarse_nbins(self.n_bins, self.shift(depth))

    def rec_nbins(self, depth: int) -> int:
        """The ``cat_mask`` width of level ``depth``'s record: its bins, or
        the full count at the terminal level, as JAX records its leaves."""
        return self.n_bins if depth == self.max_depth else self.nbins_at(depth)

    @property
    def sat(self) -> tuple:
        return _sat_region(self.max_depth, self.node_cap,
                           list(self.shifts) or None)


class _TreeState:
    """The fixed tensors one whole-tree program reads and writes: the
    training's inputs (padded bins, y, w), the running ``F`` and ``varimp``,
    the chunk's learning rates and stacked records (leading tree axis), the
    tree slot, and, when the tree reaches a saturated run, the level carry
    the saturated body passes from one level to the next.

    Sampling reads the training's seed key and rates (sample_rate,
    col_sample_rate, col_sample_rate_per_tree) and the chunk's first
    iteration from device scalars; the bootstrapped weights go to
    ``w_tree``, a class tree's columns to ``tree_cols`` and the key of its
    per-split draws to ``tree_key``, which the saturated levels read.

    The variants add their buffers: the coarse code matrices of each
    nonzero shift (made once per training, at :meth:`load`), the bundled
    codes and the expansion tables of an EFB plan, GOSS's count of kept
    rows, and lossguide's leaf budget in the saturated carry.

    With K > 1 classes (multinomial) ``F`` is (n, K); the iteration head
    fills the (n, K) targets ``T`` and hessians ``H`` from it once per
    iteration, and each class tree reads its column through the device
    class slot ``kslot`` (its running scores in ``Fk`` while a saturated
    run carries them) and writes it back. Records take one row per class
    tree: slot = iteration·K + class."""

    def __init__(self, plan: _Plan, dev: torch.device, grad_fn):
        self.plan, self.dev, self.grad_fn = plan, dev, grad_fn
        n, Cp, B, T = plan.n, plan.Cp, plan.n_bins, plan.T

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.bins = z(n, Cp, dtype=torch.uint8)  # pad columns stay code 0
        self.y, self.w = z(n), z(n)
        K = plan.K
        self.F = z(n) if K == 1 else z(n, K)
        self.T = self.H = self.kslot = self.Fk = None
        if K > 1:
            self.T, self.H = z(n, K), z(n, K)
            self.kslot = z(1, dtype=torch.long)  # the body adds one per tree
            self.Fk = z(n)
        self.varimp = z(Cp)
        self.lrs = z(T)
        self.slot = z(1, dtype=torch.long)  # the body adds one per tree
        self.cols_enabled = (torch.arange(Cp, device=dev) < plan.C).float()
        self.seed = z(1, dtype=torch.long)
        self.rates = z(3)
        self.base_iter = z(1, dtype=torch.long)
        self.w_tree = z(n) if plan.draw_rows else self.w
        self.row_hash = (sampling.index_hash(n, dev)
                         if plan.draw_rows or plan.goss else None)
        self.goss_kept = z(1, dtype=torch.int64)
        self.coarse = {s: z(n, Cp, dtype=torch.uint8)
                       for s in sorted(set(plan.shifts)) if s}
        self.bins_b = self.efb = None
        if plan.efb is not None:
            self.bins_b = z(n, plan.Cb, dtype=torch.uint8)
            self.efb = tuple(torch.as_tensor(a, device=dev) for a in
                             expand_arrays(plan.efb_plan, Cp, B))
        self.tree_cols = z(Cp) if plan.draw_tree_cols else self.cols_enabled
        self.tree_key = z(1, dtype=torch.long)
        self.col_hash = None
        if plan.draw_tree_cols or plan.draw_split_cols:
            self.col_hash = sampling.index_hash(plan.node_cap * plan.C, dev)
        is_cat = np.zeros(Cp, bool)
        is_cat[list(plan.cat_cols)] = True
        self.is_cat = torch.as_tensor(is_cat, device=dev)
        self.mono = z(Cp, dtype=torch.int32) if plan.mono else None
        self.reg = z(2) if plan.reg else None  # [reg_lambda, reg_alpha]
        start, n_sat = plan.sat
        self.records = []
        for d in range(plan.max_depth + 1):
            sat = start is not None and start <= d < start + n_sat
            self.records.append(None if sat else self._rec_bufs(
                (T,), plan.width(d), plan.rec_nbins(d)))
        if n_sat:
            cap, half = plan.node_cap, plan.node_cap // 2
            Bs = plan.nbins_at(start)
            self.sat_records = self._rec_bufs((T, n_sat), cap, Bs)
            self.sat_flat = {f: v.view(T * n_sat, *v.shape[2:])
                             for f, v in self.sat_records.items()}
            self.sat_i = z(1, dtype=torch.long)
            self.c_nid = z(n, dtype=torch.int32)
            self.c_stats = z(n, 3)
            self.c_hist = z(cap, Cp, Bs, 3) if plan.subtract else None
            self.c_pair = {"valid": z(half, dtype=torch.bool),
                           "parent_idx": z(half, dtype=torch.long),
                           "build_left": z(half, dtype=torch.bool),
                           "Lst": z(half, 3), "Rst": z(half, 3)}
            self.c_nsplit = z(1, dtype=torch.int32)
            self.c_lo = z(cap) if plan.mono else None
            self.c_hi = z(cap) if plan.mono else None
            self.c_budget = (z(1, dtype=torch.int32) if plan.max_leaves
                             else None)

    def _rec_bufs(self, lead: tuple, width: int, n_bins: int) -> dict:
        out = {}
        for f, (dtype, fill) in _REC_FIELDS.items():
            shape = lead + (width, n_bins) if f == "cat_mask" \
                else lead + (width,)
            out[f] = torch.full(shape, fill, dtype=dtype, device=self.dev)
        return out

    def nbytes(self) -> int:
        bufs = [v for v in vars(self).values() if isinstance(v, torch.Tensor)]
        for group in [*self.records, getattr(self, "sat_records", None),
                      getattr(self, "c_pair", None), self.coarse,
                      dict(enumerate(self.efb or ()))]:
            bufs += list((group or {}).values())
        # an unsampled state's w_tree and tree_cols alias w and cols_enabled
        bufs = {b.data_ptr(): b for b in bufs}.values()
        return sum(b.numel() * b.element_size() for b in bufs)

    def load(self, bins, y, w, F, varimp, mono, seed_key: int,
             rates: tuple, reg=None, bins_b=None) -> None:
        """Copy one training's inputs in (the pad columns stay code 0),
        with its sampling's seed key and rates, on a regularized plan its
        ``(reg_lambda, reg_alpha)``, and on an EFB plan its bundled codes;
        the coarse code matrices are made from the codes here."""
        C = self.plan.C
        self.seed.fill_(int(seed_key))
        self.rates.copy_(torch.tensor(rates, dtype=torch.float32))
        self.bins[:, :C].copy_(bins)
        self.goss_kept.zero_()  # a capture's warm-up tree counted too
        for s, buf in self.coarse.items():
            buf.copy_(_coarsen_bins(self.bins, s))
        if self.bins_b is not None:
            self.bins_b.copy_(bins_b)
        self.y.copy_(y)
        self.w.copy_(w)
        self.F.copy_(F)
        self.varimp.zero_()
        self.varimp[:C].copy_(varimp)
        if self.mono is not None:
            self.mono.zero_()  # pad columns are unconstrained
            self.mono[:C].copy_(torch.as_tensor(np.asarray(mono, np.int32)))
        if self.reg is not None:
            self.reg.copy_(torch.tensor(reg, dtype=torch.float32))

    def new_chunk(self, lrs, first_iteration: int = 0) -> None:
        """Learning rates of the chunk's trees, tree slot 0, the global
        index of the chunk's first iteration (the draws' key), and the
        saturated levels back to placeholders (a tree whose saturated run
        stops early leaves its later levels unwritten)."""
        lrs = torch.as_tensor(np.asarray(lrs, np.float32))
        if len(lrs) > self.plan.T:
            raise ValueError(f"{len(lrs)} trees exceed the chunk capacity "
                             f"{self.plan.T}")
        self.lrs[: len(lrs)].copy_(lrs)
        self.slot.zero_()
        self.base_iter.fill_(int(first_iteration))
        if self.plan.sat[1]:
            for f, (_, fill) in _REC_FIELDS.items():
                self.sat_records[f].fill_(fill)

    def stacked(self, n_trees: int) -> tuple:
        """The chunk's records as JAX stacks them: a tuple over levels of
        ``{field: (n_trees, width, ...)}`` views. They are this state's
        buffers, overwritten by the next chunk."""
        start, _ = self.plan.sat
        out = []
        for d, bufs in enumerate(self.records):
            if bufs is None:
                bufs = {f: v[:, d - start] for f, v in self.sat_records.items()}
            out.append({f: v[:n_trees] for f, v in bufs.items()})
        return tuple(out)


def _put(bufs: dict, idx: torch.Tensor, rec: dict) -> None:
    """Write one level's record at row ``idx`` ((1,) long, on the device)
    of each stacked field: no host read of the slot."""
    for f, buf in bufs.items():
        buf.index_copy_(0, idx, rec[f].unsqueeze(0))


def _iteration(st: _TreeState) -> torch.Tensor:
    """The global index of the iteration the slot is in: (1,) long."""
    K = st.plan.K
    return st.base_iter + (st.slot if K == 1 else
                           torch.div(st.slot, K, rounding_mode="floor"))


def _draw_rows(st: _TreeState) -> torch.Tensor:
    """The iteration's weights: ``w`` times its keyed bootstrap, written to
    ``w_tree``, when rows are sampled; else ``w``."""
    if not st.plan.draw_rows:
        return st.w
    keep = sampling.row_mask(st.seed, _iteration(st), st.rates[0:1],
                             st.row_hash)
    st.w_tree.copy_(st.w * keep)
    return st.w_tree


def _draw_cols(st: _TreeState) -> None:
    """A class tree's keyed column draws: its columns into ``tree_cols``
    (the pad columns stay 0) and the key of its per-split draws."""
    p = st.plan
    it = _iteration(st)
    cls = 0 if p.K == 1 else st.kslot
    if p.draw_tree_cols:
        keep = sampling.tree_cols(st.seed, it, cls, st.rates[2:3], p.C,
                                  st.col_hash)
        st.tree_cols[: p.C].copy_(st.cols_enabled[: p.C] * keep)
    if p.draw_split_cols:
        st.tree_key.copy_(sampling.split_key(st.seed, it, cls))


def _iter_head(st: _TreeState) -> None:
    """Multinomial: the iteration's bootstrap, shared by its K class trees,
    and every class's targets and hessians from F as the iteration found
    it, before any class tree moves a column (JAX's order); the class slot
    back to 0."""
    T, H = st.grad_fn(st.F, st.y, _draw_rows(st))
    st.T.copy_(T)
    st.H.copy_(H)
    st.kslot.zero_()


def _tree_start(st: _TreeState) -> dict:
    """The tree's draws and gradients at the running F (multinomial: the
    class slot's columns of the iteration head's T and H, and of F), and
    the root's level carry."""
    if st.plan.K == 1:
        w = _draw_rows(st)
        t, h = st.grad_fn(st.F, st.y, w)
        preds = st.F
    else:
        w = st.w_tree
        t, h, preds = (m.index_select(1, st.kslot).squeeze(1)
                       for m in (st.T, st.H, st.F))
    if st.plan.draw_tree_cols or st.plan.draw_split_cols:
        _draw_cols(st)
    wy = w * t
    wh = torch.where(w > 0, h, 0.0)  # sampled-out rows carry no hessian
    if st.plan.goss is not None:
        key = sampling.goss_key(st.seed, _iteration(st),
                                0 if st.plan.K == 1 else st.kslot)
        w, wy, wh, kept = _apply_goss(st.plan.goss, w, wy, wh, key,
                                      st.row_hash)
        st.goss_kept.add_(kept)
    c = {"nid": torch.zeros(st.plan.n, dtype=torch.int32, device=st.dev),
         "preds": preds, "stats": torch.stack([w, wy, wh], 1).contiguous(),
         "lr": st.lrs.index_select(0, st.slot), "parent_hist": None,
         "pair_info": None, "lo": None, "hi": None, "n_split": None,
         "budget": None}
    if st.plan.max_leaves:  # the root is one leaf; a split adds one
        c["budget"] = torch.full((1,), st.plan.max_leaves - 1,
                                 dtype=torch.int32, device=st.dev)
    if st.mono is not None:  # the root is unbounded
        c["lo"] = torch.full((1,), -torch.inf, device=st.dev)
        c["hi"] = torch.full((1,), torch.inf, device=st.dev)
    return c


def _level_hist(st: _TreeState, depth: int, c: dict, n_pad: int) -> tuple:
    """Level ``depth``'s histogram from carry ``c`` — direct at the root or
    without subtraction, else the lighter child of each pair and the
    sibling by subtraction — at the level's coarsening shift, over the
    bundled codes expanded to the real columns on an EFB plan. Returns
    ``(hist, the codes the level partitions, its shift)``."""
    p = st.plan
    sd = p.shift(depth)
    nb = p.nbins_at(depth)
    bins = st.coarse[sd] if sd else st.bins
    src = bins if st.bins_b is None else st.bins_b
    expand = None if st.efb is None else (lambda h: expand_hist(st.efb, h))
    if depth == 0 or not p.subtract or c["pair_info"] is None:
        hist = histogram(src, c["nid"], c["stats"], n_pad, nb)
        return (hist if expand is None else expand(hist)), bins, sd
    ds = sd - p.shift(depth - 1)
    return _sibling_hist(src, c["nid"], c["stats"], n_pad, nb,
                         c["parent_hist"], c["pair_info"], ds=ds,
                         expand=expand), bins, sd


def _grow_level(st: _TreeState, depth: int, c: dict, n_pad: int,
                n_pad_next: int, draw_depth=None) -> tuple[dict, dict]:
    """One splitting level from carry ``c``: its histogram
    (:func:`_level_hist`), the per-split column draw, the split scan,
    lossguide's ration, leaf decisions and the partition (on the level's
    coarse codes; the record keeps the split bin at full resolution).
    ``draw_depth`` (a saturated level's depth, a device scalar) keys the
    draw in place of ``depth``. Returns the next carry and the level's
    record."""
    p = st.plan
    hist, bins, sd = _level_hist(st, depth, c, n_pad)
    col_keep = None
    if p.draw_split_cols:
        col_keep = _split_draw(
            st.tree_key, depth if draw_depth is None else draw_depth,
            st.rates[1:2], n_pad, p.C, p.Cp, st.col_hash)
    nid, preds, _, n_split, rec, pair_info, bounds = _level_core(
        hist, bins, c["nid"], c["preds"], st.varimp, st.tree_cols,
        st.is_cat, p.min_rows, p.min_split_improvement, c["lr"],
        p.max_abs_leaf, n_pad=n_pad, n_pad_next=n_pad_next,
        cat_cols=p.cat_cols, mono=st.mono, node_lo=c["lo"], node_hi=c["hi"],
        col_keep=col_keep, reg=st.reg, leaf_budget=c["budget"])
    if sd:  # a coarse prefix split is the full-resolution one at bin << sd
        rec = dict(rec, split_bin=rec["split_bin"] << sd)
    new = dict(c, nid=nid, preds=preds, n_split=n_split, pair_info=pair_info,
               parent_hist=hist, budget=pair_info.pop("budget", None))
    if bounds is not None:
        new["lo"], new["hi"] = bounds
    return new, rec


def _grow(st: _TreeState, c: dict, depths) -> dict:
    for d in depths:
        c, rec = _grow_level(st, d, c, st.plan.width(d), st.plan.width(d + 1))
        _put(st.records[d], st.slot, rec)
    return c


def _tree_end(st: _TreeState, c: dict) -> None:
    """The terminal level (every node a leaf, its stats straight from the
    parents' chosen splits under subtraction), the new F, the next slot."""
    p = st.plan
    n_pad = p.width(p.max_depth)
    if p.subtract and c["pair_info"] is not None:
        pi = c["pair_info"]
        tot = torch.stack([pi["Lst"], pi["Rst"]], dim=1).reshape(n_pad, 3)
    else:
        tot = node_totals(_level_hist(st, p.max_depth, c, n_pad)[0])
    _, preds, _, _, rec = _force_leaf_from_stats(
        st.bins, c["nid"], c["preds"], st.varimp, tot[:, 0], tot[:, 1],
        tot[:, 2], c["lr"], p.max_abs_leaf, n_pad, p.n_bins, c["lo"], c["hi"],
        st.reg)
    _put(st.records[p.max_depth], st.slot, rec)
    if p.K == 1:
        st.F.copy_(preds)
    else:
        st.F.index_copy_(1, st.kslot, preds[:, None])
        st.kslot.add_(1)
    st.slot.add_(1)


def _tree(st: _TreeState) -> None:
    """One whole tree with no saturated run: gradients, every level at its
    padded width, the F update. No host read, no data-dependent shape."""
    c = _tree_start(st)
    c = _grow(st, c, range(st.plan.max_depth))
    _tree_end(st, c)


def _running(st: _TreeState) -> torch.Tensor:
    """The running scores a saturated run carries: F, or the class tree's
    column buffer."""
    return st.F if st.Fk is None else st.Fk


def _store_carry(st: _TreeState, c: dict) -> None:
    st.c_nid.copy_(c["nid"])
    _running(st).copy_(c["preds"])
    st.c_stats.copy_(c["stats"])
    if st.c_hist is not None:  # the first parent may be node_cap/2 wide
        k = c["parent_hist"].shape[0]
        st.c_hist[:k].copy_(c["parent_hist"])
        st.c_hist[k:].zero_()  # gated off by pair_info["valid"]
    for f in _PAIR_FIELDS:
        st.c_pair[f].copy_(c["pair_info"][f])
    st.c_nsplit.copy_(c["n_split"].reshape(1))
    if st.c_lo is not None:
        st.c_lo.copy_(c["lo"])
        st.c_hi.copy_(c["hi"])
    if st.c_budget is not None:
        st.c_budget.copy_(c["budget"])


def _load_carry(st: _TreeState) -> dict:
    return {"nid": st.c_nid, "preds": _running(st), "stats": st.c_stats,
            "lr": st.lrs.index_select(0, st.slot), "parent_hist": st.c_hist,
            "pair_info": st.c_pair, "lo": st.c_lo, "hi": st.c_hi,
            "n_split": st.c_nsplit, "budget": st.c_budget}


def _tree_head(st: _TreeState) -> None:
    """Gradients and the growth levels before the saturated run; the carry
    goes to the state's fixed buffers."""
    c = _tree_start(st)
    c = _grow(st, c, range(st.plan.sat[0]))
    _store_carry(st, c)
    st.sat_i.zero_()


def _sat_level(st: _TreeState) -> None:
    """One saturated level (frontier pinned at node_cap) from the fixed
    carry back into it. A level after one that split nothing records a
    placeholder, as JAX's early-exited ``while_loop`` leaves them; its rows
    are all retired already, so F and varimp do not move."""
    p = st.plan
    c = _load_carry(st)
    alive = c["n_split"] > 0
    new, rec = _grow_level(st, p.sat[0], c, p.node_cap, p.node_cap,
                           draw_depth=p.sat[0] + st.sat_i)
    rec = {f: torch.where(alive, v, _REC_FIELDS[f][1]) for f, v in rec.items()}
    _put(st.sat_flat, st.slot * p.sat[1] + st.sat_i, rec)
    _store_carry(st, new)
    st.sat_i.add_(1)


def _tree_tail(st: _TreeState) -> None:
    _tree_end(st, _load_carry(st))


class _Programs:
    """The CUDA graphs of one plan on one card, with the state they own:
    one graph per tree, or, with a saturated run, a head, a saturated-level
    and a tail graph; with K > 1 classes also the iteration head
    (``_iter_head``), replayed once before each iteration's K class trees,
    which all replay the same tree graphs (the class is the device slot
    ``kslot``, never a Python value baked in at capture). Built by warming
    the bodies up eagerly on a side stream and capturing each once, all
    into one private memory pool (replayed in capture order, never
    concurrently, and no body keeps a pool tensor past its end)."""

    def __init__(self, st: _TreeState):
        from h2o3_tpu_torch.ops import cuda_graph

        self.state = st
        sat = st.plan.sat[1] > 0
        bodies = ((lambda: _tree_head(st), lambda: _sat_level(st),
                   lambda: _tree_tail(st)) if sat else (lambda: _tree(st),))
        head = (lambda: _iter_head(st)) if st.plan.K > 1 else None

        def run_all():
            if head is not None:
                head()
            for b in bodies:
                b()

        self.warmup_launches = cuda_graph.warm_up(run_all, st.dev)
        pool = torch.cuda.graph_pool_handle()
        # the pool's size: what capture adds to the reserved memory once the
        # cache is empty (capture empties it itself; the pool's segments
        # stay while the graphs live)
        torch.cuda.synchronize(st.dev)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(st.dev)
        self.head = (None if head is None
                     else cuda_graph.LaunchGraph(head, pool))
        self.graphs = [cuda_graph.LaunchGraph(b, pool) for b in bodies]
        self.pool_bytes = torch.cuda.memory_reserved(st.dev) - before
        # what the cache keeps alive while it holds these programs
        self.retained_bytes = self.pool_bytes + st.nbytes()

    def stats(self) -> dict:
        graphs = [g for g in (self.head, *self.graphs) if g is not None]
        names = ([] if self.head is None else ["iteration_head"]) + (
            ["tree_head", "saturated_level", "tree_tail"]
            if len(self.graphs) == 3 else ["tree"])
        launched: dict = {}
        for g in graphs:
            for k, v in g.launches.items():
                launched[k] = launched.get(k, 0) + v * g.replays
        p = self.state.plan
        return {"rows": p.n, "cols": p.Cp, "depth": p.max_depth,
                "classes": p.K, "graphs": len(graphs),
                "draws": {"rows": p.draw_rows,
                          "split_cols": p.draw_split_cols,
                          "tree_cols": p.draw_tree_cols},
                "graph_names": names,
                "replays": [g.replays for g in graphs],
                # launches per replay of each graph
                "graph_launches": [dict(g.launches) for g in graphs],
                "capture_seconds": sum(g.capture_seconds for g in graphs),
                "pool_bytes": self.pool_bytes,
                "state_bytes": self.state.nbytes(),
                "retained_bytes": self.retained_bytes,
                "warmup_launches": dict(self.warmup_launches),
                "replay_launches": launched}


_GRAPHS: "dict[tuple, _Programs]" = {}
# the card's whole-tree bodies run as CUDA graphs; False runs them eagerly
# on the card (checks of graph replay against the same bodies)
CAPTURE = True
# the cached plans of a card keep at most this share of its memory (state
# and pool); a plan larger than that alone is released with its training
_GRAPH_CACHE_SHARE = 1 / 32
# captures, the launches the captures' warm-up runs made on the card (the
# kernel counters hold them too: they are real launches), and the sizes of
# the latest capture (``_Programs.stats`` at capture)
GRAPH_EVENTS = {"captures": 0, "warmup_launches": {}, "last_capture": None}


def free_graphs() -> None:
    """Drop every cached whole-tree graph, its memory pool and its state."""
    _GRAPHS.clear()


def graph_stats() -> list[dict]:
    """One dict per cached plan: graphs, replays, capture seconds, pool and
    state bytes, warm-up and replayed launches."""
    return [p.stats() for p in _GRAPHS.values()]


def _capture(plan: _Plan, grad_fn, dev: torch.device, inputs: tuple):
    st = _TreeState(plan, dev, grad_fn)
    st.load(*inputs)
    progs = _Programs(st)
    GRAPH_EVENTS["captures"] += 1
    warm = GRAPH_EVENTS["warmup_launches"]
    for k, v in progs.warmup_launches.items():
        warm[k] = warm.get(k, 0) + v
    GRAPH_EVENTS["last_capture"] = progs.stats()
    return progs


def _programs_for(plan: _Plan, grad_fn, dev: torch.device, inputs: tuple):
    """The cached programs of ``plan`` on ``dev``, loaded with ``inputs``;
    on a miss, warmed up on those inputs and captured (then reloaded: the
    warm-up moved F, varimp and the slot). A capture that runs out of
    memory drops the card's cached plans and tries once more. The cache
    then keeps the most recent plans within ``_GRAPH_CACHE_SHARE`` of the
    card's memory."""
    on_dev = [k for k in _GRAPHS if k[1] == str(dev)]
    key = (plan, str(dev))
    progs = _GRAPHS.pop(key, None)
    if progs is None:
        try:
            progs = _capture(plan, grad_fn, dev, inputs)
        except torch.cuda.OutOfMemoryError:
            if not on_dev:
                raise
        if progs is None:  # outside the handler, whose traceback holds
            for k in on_dev:  # the failed attempt's tensors
                _GRAPHS.pop(k, None)
            torch.cuda.empty_cache()
            progs = _capture(plan, grad_fn, dev, inputs)
    _GRAPHS[key] = progs  # most recently used last
    budget = torch.cuda.get_device_properties(dev).total_memory \
        * _GRAPH_CACHE_SHARE
    while sum(_GRAPHS[k].retained_bytes for k in _GRAPHS
              if k[1] == str(dev)) > budget:
        _GRAPHS.pop(next(k for k in _GRAPHS if k[1] == str(dev)))
    progs.state.load(*inputs)
    return progs


class WholeTreeBuilder:
    """The whole-tree build of one training — the counterpart of
    ``build_trees_scanned`` with its per-training preparation hoisted out:
    the column padding, ``is_cat``, ``mono`` and the fixed buffers are made
    once, then :meth:`build` grows a chunk of trees.

    Each tree runs gradients, then every level at its padded width (a
    level that splits nothing leaves its rows retired, and the levels
    after it record all-leaf, zero-valued nodes), then the ``F`` update,
    reading its learning rate from the chunk's ``lrs`` at the tree slot the
    body itself advances. No step reads the device from the host. With
    ``n_classes`` K > 1 (multinomial: ``grad_fn`` maps the (n, K) F to
    (n, K) targets and hessians) an iteration is the iteration head, then K
    class trees, each on its column (:class:`_TreeState`).

    ``sample`` (:class:`sampling.Sampling`) draws the rows of each
    iteration and the columns of each class tree and node by keys: the
    plan records which draws exist, the state holds the seed and rates.
    ``reg`` (``(reg_lambda, reg_alpha)``, or None) regularizes the leaf
    values: the plan records that it does, the state holds the two.

    The variants: ``H2O3_TPU_TREE_GOSS`` weighs each tree's rows by its
    GOSS factor after the bootstrap, ``H2O3_TPU_BIN_ADAPT`` coarsens the
    deep levels' codes (:func:`_bin_shifts`), ``max_leaves`` > 0 rations
    each level's splits against a leaf budget carried through the tree
    (``grow_policy="lossguide"``), and ``efb`` (an ``EFBPlan``, with the
    bundled codes ``bins_b``) histograms the bundled columns and expands
    them back to the real ones. Each is part of the plan.

    On the CPU the bodies run eagerly. On a card they are CUDA graphs,
    captured once per plan (:class:`_Plan`) and replayed once per tree;
    a tree with a saturated run replays its head, then the saturated level
    once per level until a sparse host read (depth >= 8, every 4th level)
    finds it split nothing, then its tail. A capture or replay error
    raises; nothing falls back to the eager loop. With :data:`CAPTURE`
    False the card runs the same bodies eagerly (the graphs' control in
    checks of graph against eager)."""

    def __init__(self, bins_u8, w, y, preds, varimp, *, grad_fn, grad_key,
                 n_bins: int, is_cat_cols, max_depth: int, min_rows: float,
                 min_split_improvement: float, max_abs_leaf: float,
                 chunk_cap: int, node_cap: int = 2048, monotone=None,
                 n_classes: int = 1,
                 sample: "sampling.Sampling | None" = None, reg=None,
                 max_leaves: int = 0, efb=None, bins_b=None):
        dev = bins_u8.device
        n, C = bins_u8.shape
        node_cap = _clamp_node_cap(node_cap, n, min_rows)
        node_cap = max(2, node_cap - (node_cap % 2))  # pairs: even frontier
        is_cat_np = np.asarray(is_cat_cols, bool)
        mono = None
        if monotone is not None and np.any(np.asarray(monotone) != 0):
            mono = np.asarray(monotone, np.int32)
        sample = sample or sampling.Sampling()
        draw_rows, draw_split, draw_tree = sample.draws
        cat_cols = tuple(int(i) for i in np.nonzero(is_cat_np)[0])
        shifts = tuple(_bin_shifts(max_depth, bucket_nbins(n_bins), cat_cols))
        if efb is not None and any(shifts):
            raise ValueError("EFB requires zero bin-adapt shifts")
        self.plan = _Plan(
            n=n, C=C, Cp=bucket_cols(C), n_bins=bucket_nbins(n_bins),
            max_depth=max_depth, node_cap=node_cap, cat_cols=cat_cols,
            grad_key=tuple(grad_key), T=int(chunk_cap) * n_classes,
            subtract=_subtract_enabled(), mono=mono is not None,
            min_rows=float(min_rows),
            min_split_improvement=float(min_split_improvement),
            max_abs_leaf=float(max_abs_leaf),
            tiles=config.get("H2O3_TPU_PALLAS_TILES").strip(),
            K=int(n_classes), draw_rows=draw_rows, draw_split_cols=draw_split,
            draw_tree_cols=draw_tree, reg=reg is not None, goss=_goss_ab(),
            shifts=shifts if any(shifts) else (), max_leaves=int(max_leaves),
            efb=None if efb is None else efb.key,
            Cb=0 if efb is None else efb.n_cols_b, efb_plan=efb)
        inputs = (bins_u8, y, w, preds, varimp, mono, sample.key,
                  sample.rates, reg, bins_b)
        self.programs = None
        if dev.type == "cuda" and CAPTURE:
            self.programs = _programs_for(self.plan, grad_fn, dev, inputs)
            self.state = self.programs.state
        else:
            self.state = _TreeState(self.plan, dev, grad_fn)
            self.state.load(*inputs)

    @property
    def F(self) -> torch.Tensor:
        """The running prediction, (n,) or (n, K): a buffer of the cached
        state, reused by the next training of this plan."""
        return self.state.F

    @property
    def varimp(self) -> torch.Tensor:
        """The running variable importance over the real columns."""
        return self.state.varimp[: self.plan.C]

    def build(self, learn_rates, first_iteration: int = 0) -> tuple:
        """Grow ``len(learn_rates)`` iterations of K class trees each, the
        first of them iteration ``first_iteration`` of the training (the
        draws' key); returns their stacked records, one row per class tree
        in the order iteration·K + class (:meth:`_TreeState.stacked`, valid
        until the next chunk)."""
        st, K = self.state, self.plan.K
        st.new_chunk(np.repeat(np.asarray(learn_rates, np.float32), K),
                     first_iteration)
        for _ in range(len(learn_rates)):
            if K > 1:
                if self.programs is None:
                    _iter_head(st)
                else:
                    self.programs.head.replay()
            for _ in range(K):
                if self.programs is None:
                    self._tree_eager()
                else:
                    self._tree_replay()
        if self.plan.goss is not None:
            a, b = self.plan.goss
            GOSS_EVENTS["trees"] += len(learn_rates) * K
            GOSS_EVENTS["rows_modeled"] += (a + b) * self.plan.n * len(
                learn_rates) * K
            _goss_count(st.goss_kept)
            st.goss_kept.zero_()
        return st.stacked(len(learn_rates) * K)

    def _tree_eager(self) -> None:
        st, p = self.state, self.plan
        start, n_sat = p.sat
        if not n_sat:
            with record_function(_width_span(p.width(p.max_depth))):
                _tree(st)
            return
        with record_function(_width_span(p.width(start - 1))):
            _tree_head(st)
        with record_function(_width_span(p.node_cap)):
            for _ in range(n_sat):
                if int(st.c_nsplit) == 0:  # the rest stay placeholders
                    break
                _sat_level(st)
            _tree_tail(st)

    def _tree_replay(self) -> None:
        graphs, p = self.programs.graphs, self.plan
        start, n_sat = p.sat
        if not n_sat:
            with record_function(_width_span(p.width(p.max_depth))):
                graphs[0].replay()
            return
        head, sat, tail = graphs
        with record_function(_width_span(p.width(start - 1))):
            head.replay()
        with record_function(_width_span(p.node_cap)):
            for i in range(n_sat):
                sat.replay()
                d = start + i
                # the sparse rule of the eager loop: one blocking read per
                # fourth level past depth 8; levels run after the frontier
                # died record placeholders (_sat_level), so the read only
                # saves work
                if d >= 8 and d % 4 == 0 and int(self.state.c_nsplit) == 0:
                    break
            tail.replay()


def build_trees_scanned(bins_u8, w, y, preds, varimp, n_trees: int, *,
                        grad_fn, grad_key, n_bins: int, is_cat_cols,
                        max_depth: int, min_rows: float,
                        min_split_improvement: float, learn_rates,
                        max_abs_leaf: float = float("inf"),
                        node_cap: int = 2048, monotone=None,
                        n_classes: int = 1, seed: int = 0,
                        tree_offset: int = 0, sample_rate: float = 1.0,
                        col_sample_rate: float = 1.0,
                        col_sample_rate_per_tree: float = 1.0,
                        reg_lambda: float = 0.0, reg_alpha: float = 0.0,
                        max_leaves: int = 0, efb=None, bins_b=None):
    """Build ``n_trees`` whole trees — the signature of JAX's
    ``build_trees_scanned`` for the ported options — or, with
    ``n_classes`` K > 1, ``n_trees`` iterations of K class trees on an
    (n, K) ``preds``. ``grad_fn(F, y, w_tree) -> (t, h)`` at the
    bootstrapped weights; ``grad_key`` names it (a cached CUDA graph keeps
    the first ``grad_fn`` of its key). The three rates draw rows per
    iteration and columns per class tree and per split, keyed by ``seed``
    (JAX's ``base_key``/``row_key``: the K class trees of an iteration
    share its bootstrap) and the global iteration, counted from
    ``tree_offset``. ``reg_lambda``/``reg_alpha`` regularize the leaves
    (both 0: GBM's unregularized path, as in JAX). ``max_leaves`` and
    ``efb``/``bins_b`` are :class:`WholeTreeBuilder`'s. Returns ``(preds,
    varimp, stacked)``, copies the caller owns."""
    b = WholeTreeBuilder(
        bins_u8, w, y, preds, varimp, grad_fn=grad_fn, grad_key=grad_key,
        n_bins=n_bins, is_cat_cols=is_cat_cols, max_depth=max_depth,
        min_rows=min_rows, min_split_improvement=min_split_improvement,
        max_abs_leaf=max_abs_leaf, chunk_cap=n_trees, node_cap=node_cap,
        monotone=monotone, n_classes=n_classes,
        sample=sampling.Sampling(seed, sample_rate, col_sample_rate,
                                 col_sample_rate_per_tree),
        reg=leaf_reg(reg_lambda, reg_alpha), max_leaves=max_leaves, efb=efb,
        bins_b=bins_b)
    stacked = b.build(learn_rates, tree_offset)
    return (b.F.clone(), b.varimp.clone(),
            tuple({f: v.clone() for f, v in lvl.items()} for lvl in stacked))


# the whole chunk flattens into ONE uint8 buffer, pulled to the host in ONE
# transfer: float32/int32 fields travel as their 4 bytes (exact), bools as
# one byte each, in ``_REC_FIELDS`` order
_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.bool: np.bool_}


def _pack_stacked(stacked, n_trees: int) -> torch.Tensor:
    return torch.cat([lvl[k][:n_trees].view(torch.uint8).reshape(n_trees, -1)
                      for lvl in stacked for k in _REC_FIELDS], dim=1)


def trees_from_stacked(stacked, n_trees: int) -> list[Tree]:
    """ONE device-to-host transfer for a whole chunk -> numpy-backed
    Trees (JAX's ``trees_from_stacked``)."""
    packed = _pack_stacked(stacked, n_trees).cpu().numpy()  # (T, X) uint8
    out = [Tree() for _ in range(n_trees)]
    off = 0
    for lvl in stacked:
        flds = {}
        for k in _REC_FIELDS:
            shape = tuple(lvl[k].shape[1:])
            dt = np.dtype(_NP_DTYPES[lvl[k].dtype])
            nbytes = int(np.prod(shape)) * dt.itemsize
            raw = np.ascontiguousarray(packed[:, off: off + nbytes])
            flds[k] = raw.view(dt).reshape(n_trees, *shape)
            off += nbytes
        for ti in range(n_trees):
            out[ti].levels.append(
                TreeLevel(**{k: v[ti] for k, v in flds.items()}))
    return out


def replay_batch(bins_u8, stacked, preds):
    """Add a stacked chunk of trees to ``preds`` on ``bins_u8``'s device,
    with no host read between trees (JAX's ``replay_batch``, as a plain
    PyTorch loop over trees and levels). ``preds`` (n, K) takes a chunk of
    K class trees per iteration: tree t adds to column t mod K."""
    n_trees = stacked[0]["leaf_now"].shape[0]
    cols = [preds] if preds.dim() == 1 else list(preds.unbind(1))
    for t in range(n_trees):
        k = t % len(cols)
        nid = torch.zeros(bins_u8.shape[0], dtype=torch.int32,
                          device=bins_u8.device)
        for rec in stacked:
            nid, cols[k] = _partition_update(
                bins_u8, nid, cols[k], *(rec[f][t] for f in REPLAY_FIELDS))
    return cols[0] if preds.dim() == 1 else torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# the streamed forest build (out of core, ``frame/chunkstore.py``): the
# port of JAX's ``build_trees_streamed``. A level is a loop over the row
# blocks that adds each block's histogram into the level's (kernel B1's
# accumulate form on the card), one split decision on the accumulated
# histogram (B2, or B3 on constrained builds), and a loop that moves each
# block's rows to their children. The per-row state (running scores, node
# ids, gradients) lives in the store between touches, so the device holds
# the window and the frontier-sized state, not the frame.


def _stream_decide(hist, col_mask, is_cat, varimp, *, n_pad: int,
                   n_pad_next: int, force_leaf: bool, cat_cols: tuple,
                   min_rows, min_split_improvement, learn_rate,
                   max_abs_leaf, reg=None, mono=None, node_lo=None,
                   node_hi=None):
    """Split scan and leaf decision on a block-accumulated histogram (JAX's
    ``_stream_decide_prog``: ``_level_core`` without its partition update,
    which runs per block). Returns ``(n_split, record, bounds)``;
    ``varimp`` takes the level's gains in place."""
    dev = hist.device
    if force_leaf:
        tot = node_totals(hist)
        ok = torch.zeros(n_pad, dtype=torch.bool, device=dev)
        zi = torch.zeros(n_pad, dtype=torch.int32, device=dev)
        _, _, _, _, n_split, rec = _leaf_decide(
            ok, torch.zeros(n_pad, dtype=torch.float32, device=dev),
            tot[:, 0], tot[:, 1], tot[:, 2], zi, zi, ok,
            torch.zeros(n_pad, hist.shape[2], dtype=torch.bool, device=dev),
            ok, learn_rate, max_abs_leaf, n_pad, node_lo, node_hi, reg)
        return n_split, rec, None
    sp = fused_split_scan(hist, is_cat, col_mask, min_rows,
                          min_split_improvement, cat_cols, mono=mono,
                          node_lo=node_lo, node_hi=node_hi)
    ok = sp["ok"]
    ok = ok & (2 * torch.cumsum(ok.to(torch.int32), dim=0) <= n_pad_next)
    gain = torch.where(ok, torch.clamp(sp["gain"], min=0.0), 0.0)
    _, _, _, _, n_split, rec = _leaf_decide(
        ok, gain, sp["node_w"], sp["node_wy"], sp["node_wh"], sp["col"],
        sp["split_bin"], sp["is_cat"], sp["cat_mask"], sp["na_left"],
        learn_rate, max_abs_leaf, n_pad, node_lo, node_hi, reg)
    varimp.index_add_(0, sp["col"].long(),
                      torch.where(ok, gain, 0.0).to(varimp.dtype))
    bounds = None
    if mono is not None:
        bounds = _child_bounds(ok, rec["child_base"], sp["mono_col"],
                               sp["mid"], node_lo, node_hi, n_pad_next)
    return n_split, rec, bounds


def _level_to_host(rec: dict, n_split) -> tuple:
    """A level's record and its split count in one device-to-host transfer
    (the per-level read of JAX's streamed loop): ``(TreeLevel, n_split)``."""
    keys = list(_REC_FIELDS)
    parts = [rec[k].reshape(-1).clone(memory_format=torch.contiguous_format)
             .view(torch.uint8) for k in keys]
    parts.append(n_split.reshape(1).to(torch.int32).view(torch.uint8))
    packed = torch.cat(parts).cpu().numpy()
    out, off = {}, 0
    for k, t in zip(keys, parts[:-1]):
        dt = np.dtype(_NP_DTYPES[rec[k].dtype])
        out[k] = packed[off: off + t.numel()].view(dt).reshape(
            tuple(rec[k].shape))
        off += t.numel()
    return TreeLevel(**out), int(packed[off:].view(np.int32)[0])


def _upload(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A small host tensor on ``dev``, on the card through pinned memory
    without a host wait (the streamed loop's only waits are its reads)."""
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def build_trees_streamed(store, n_trees: int, *, grad_fn, n_bins: int,
                         is_cat_cols, max_depth: int, min_rows: float,
                         min_split_improvement: float, learn_rates,
                         max_abs_leaf: float, varimp,
                         sample: "sampling.Sampling | None" = None,
                         tree_offset: int = 0, node_cap: int = 2048,
                         reg=None, monotone=None) -> tuple:
    """Build ``n_trees`` trees over a :class:`~h2o3_tpu_torch.frame.
    chunkstore.ChunkStore` whose rows exceed the window (JAX's
    ``build_trees_streamed``).

    Lanes consumed: ``bins`` (uint8 (npad, C)), ``y``, ``w`` and ``F``
    (float32; ``F``, the running score, is updated per level) and the
    scratch lanes ``wt``, ``wy``, ``wh`` (float32) and ``nid`` (int32).
    Per tree one gradient pass over the blocks, then per level one
    histogram pass (B1 adding each block into the level's histogram), one
    decision (B2, or B3 under ``monotone``) and one partition pass. The
    host reads each level's record and split count once (JAX's read);
    nothing else in the loops waits for the card.

    The draws are the resident build's keyed hashes (``sampling.py``): the
    row bootstrap of iteration g keyed by (seed, g) over the global row
    index, so a streamed and a resident sampled build draw the same rows;
    the per-tree and per-split column draws as ``build_tree`` keys them.
    JAX folds the block index into its streamed bootstrap (so its streamed
    and resident bootstraps are different streams); the port's differ from
    JAX's only in the draws' bits, not their distribution. GOSS
    (``H2O3_TPU_TREE_GOSS``) applies per block, as JAX's
    ``_stream_grad_prog``: the top-a threshold is taken over each block's
    rows, the rest draw keyed as the resident build's over the global row
    index.

    ``varimp`` ((C,) on the store's device) accumulates in place. Returns
    ``(trees, varimp)`` with host-resident records."""
    dev = store.device
    n_bins = bucket_nbins(n_bins)
    node_cap = _clamp_node_cap(node_cap, store.npad, min_rows)
    is_cat_np = np.asarray(is_cat_cols, bool)
    C = len(is_cat_np)
    cat_cols = tuple(int(i) for i in np.nonzero(is_cat_np)[0])
    is_cat_dev = _upload(torch.from_numpy(is_cat_np), dev)
    lrs = np.asarray(learn_rates, np.float32)
    smp = sample or sampling.Sampling()
    draw_rows, draw_split, draw_tree = smp.draws
    idx_hash = (sampling.index_hash(node_cap * C, dev)
                if draw_split or draw_tree else None)
    mono = None
    if monotone is not None and np.any(np.asarray(monotone) != 0):
        mono = _upload(torch.from_numpy(np.asarray(monotone, np.int32)), dev)
    if reg is not None:
        reg = _upload(torch.tensor(reg, dtype=torch.float32), dev)
    goss = _goss_ab()
    trees: list[Tree] = []
    for m in range(n_trees):
        g = m + tree_offset
        cols_enabled = torch.ones(C, dtype=torch.float32, device=dev)
        if draw_tree:
            cols_enabled = cols_enabled * sampling.tree_cols(
                smp.key, g, 0, smp.col_sample_rate_per_tree, C, idx_hash)
        tree_key = sampling.split_key(smp.key, g, 0) if draw_split else None

        # gradient pass, with the iteration's bootstrap over global rows
        for bi, blk in store.stream(("F", "y", "w")):
            w = blk["w"]
            if draw_rows:
                lo, _ = store.span(bi)
                w = w * sampling.row_mask(
                    smp.key, g, smp.sample_rate,
                    sampling.index_hash(w.shape[0], dev, lo))
            t, h = grad_fn(blk["F"], blk["y"], w)
            wy, wh = w * t, torch.where(w > 0, h, 0.0)
            if goss is not None:
                lo, _ = store.span(bi)
                w, wy, wh, kept = _apply_goss(
                    goss, w, wy, wh, sampling.goss_key(smp.key, g, 0),
                    sampling.index_hash(w.shape[0], dev, lo))
                _goss_count(kept)
            store.update(bi, wt=w, wy=wy, wh=wh)
        store.fill("nid", 0)
        if goss is not None:
            GOSS_EVENTS["trees"] += 1
            GOSS_EVENTS["rows_modeled"] += (goss[0] + goss[1]) * store.npad

        tree = Tree()
        node_lo = node_hi = None
        if mono is not None:
            node_lo = torch.full((1,), -torch.inf, device=dev)
            node_hi = torch.full((1,), torch.inf, device=dev)
        for depth in range(max_depth + 1):
            n_pad = min(1 << depth, node_cap)
            n_pad_next = min(2 * n_pad, node_cap)
            force_leaf = depth == max_depth
            with record_function(_width_span(n_pad)):
                hist = torch.zeros(n_pad, C, n_bins, 3, dtype=torch.float32,
                                   device=dev)
                for _bi, blk in store.stream(
                        ("bins", "nid", "wt", "wy", "wh")):
                    stats = torch.stack([blk["wt"], blk["wy"], blk["wh"]], 1)
                    histogram(blk["bins"], blk["nid"], stats, n_pad, n_bins,
                              out=hist)
                col_mask = cols_enabled[None, :].expand(n_pad, C)
                if tree_key is not None and not force_leaf:
                    col_mask = col_mask * _split_draw(
                        tree_key, depth, smp.col_sample_rate, n_pad, C, C,
                        idx_hash)
                n_split, rec, bounds = _stream_decide(
                    hist, col_mask, is_cat_dev, varimp, n_pad=n_pad,
                    n_pad_next=n_pad_next, force_leaf=force_leaf,
                    cat_cols=cat_cols, min_rows=min_rows,
                    min_split_improvement=min_split_improvement,
                    learn_rate=float(lrs[m]), max_abs_leaf=max_abs_leaf,
                    reg=reg, mono=mono, node_lo=node_lo, node_hi=node_hi)
                if force_leaf:
                    node_lo = node_hi = None
                elif bounds is not None:
                    node_lo, node_hi = bounds
                for bi, blk in store.stream(("bins", "nid", "F")):
                    nid_b, F_b = _partition_update(
                        blk["bins"], blk["nid"], blk["F"],
                        *(rec[f] for f in REPLAY_FIELDS))
                    store.update(bi, nid=nid_b, F=F_b)
                level, n_split = _level_to_host(rec, n_split)
            tree.levels.append(level)
            if force_leaf or n_split == 0:
                break
        trees.append(tree)
    return trees, varimp
