"""Level-wise tree builder — the port of ``h2o3_tpu/models/tree/shared_tree.py``
(split scan, leaf decision, partition update, the recorded ``Tree``, and the
per-level ``build_tree`` loop with sibling subtraction).

Per level, eagerly, one Python iteration:

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
parent's chosen-split child stats. Records stay on the device; prediction
replays them with the same partition update.

Monotone constraints carry per-node ``[lo, hi]`` bounds from level to
level, starting unbounded at the root: leaf values clip to their node's
bounds, and the children of a split on a constrained column tighten to the
split's ``mid`` on the constrained side (``_child_bounds``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields

import numpy as np
import torch

from h2o3_tpu_torch import config
from h2o3_tpu_torch.models.tree.binning import bucket_cols, bucket_nbins
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
                 node_lo=None, node_hi=None):
    """Leaf decision + child-id assignment + the replayable record. Leaf
    values clip to ``[node_lo, node_hi]`` on monotone builds, before the
    ``max_abs_leaf`` clamp and the learn rate."""
    leaf_now = ~ok
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
                  learn_rate, max_abs_leaf, n_pad, node_lo=None, node_hi=None):
    """Leaf decision, varimp scatter (in place into ``varimp``), partition
    update, and the replayable record."""
    leaf_now, leaf_val, child_base, cs, n_split, record = _leaf_decide(
        ok, gain, node_w, node_wy, node_wh, split_col, split_bin, is_cat_n,
        cat_mask, na_left, learn_rate, max_abs_leaf, n_pad, node_lo, node_hi)
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
                node_lo=None, node_hi=None):
    """Split scan → decisions → partition for one level, given its histogram.

    Returns ``(nid, preds, varimp, n_split, record, pair_info, bounds)``;
    ``pair_info`` carries, per next-level child pair slot, what sibling
    subtraction needs: ``parent_idx``, ``valid``, ``build_left`` (the
    lighter child) and the chosen split's child stats ``Lst``/``Rst``.
    ``bounds`` is the next level's ``(node_lo, node_hi)`` on monotone builds
    (``mono`` given), else None. Column sampling is not ported: every
    enabled column is a candidate at every node."""
    C = bins_u8.shape[1]
    col_mask = cols_enabled[None, :].expand(n_pad, C)
    sp = fused_split_scan(hist, is_cat, col_mask, min_rows,
                          min_split_improvement, cat_cols, mono=mono,
                          node_lo=node_lo, node_hi=node_hi)
    ok = sp["ok"]
    # frontier cap: children must fit n_pad_next; later nodes go leaf
    ok = ok & (2 * torch.cumsum(ok.to(torch.int32), dim=0) <= n_pad_next)
    gain = torch.where(ok, torch.clamp(sp["gain"], min=0.0), 0.0)
    nid, preds, varimp, n_split, record, cs = _finish_level(
        bins_u8, nid, preds, varimp, ok, gain, sp["node_w"], sp["node_wy"],
        sp["node_wh"], sp["col"], sp["split_bin"], sp["is_cat"],
        sp["cat_mask"], sp["na_left"], learn_rate, max_abs_leaf, n_pad,
        node_lo, node_hi)

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
    bounds = None
    if mono is not None:
        bounds = _child_bounds(ok, record["child_base"], sp["mono_col"],
                               sp["mid"], node_lo, node_hi, n_pad_next)
    return nid, preds, varimp, n_split, record, pair_info, bounds


def _force_leaf_from_stats(bins_u8, nid, preds, varimp, node_w, node_wy,
                           node_wh, learn_rate, max_abs_leaf, n_pad, n_bins,
                           node_lo=None, node_hi=None):
    """Terminal level: every active node becomes a leaf (no split scan).
    ``node_lo``/``node_hi`` clip the leaf values on monotone builds."""
    dev = bins_u8.device
    ok = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    zi = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    nid, preds, varimp, n_split, record, _ = _finish_level(
        bins_u8, nid, preds, varimp, ok,
        torch.zeros(n_pad, dtype=torch.float32, device=dev),
        node_w, node_wy, node_wh, zi, zi, ok,
        torch.zeros(n_pad, n_bins, dtype=torch.bool, device=dev), ok,
        learn_rate, max_abs_leaf, n_pad, node_lo, node_hi)
    return nid, preds, varimp, n_split, record


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
                None if v is None else v.cpu().numpy()
                for v in (getattr(lv, f.name) for f in fields(TreeLevel))]))
        return out

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

    def replay(self, bins_u8, nid, preds):
        """Accumulate this tree's contribution into preds (device walk)."""
        for lv in self.levels:
            nid, preds = _partition_update(
                bins_u8, nid, preds, *(getattr(lv, f) for f in REPLAY_FIELDS))
        return nid, preds


# ---------------------------------------------------------------------------
# the level-wise builder


def _subtract_enabled() -> bool:
    return config.get_bool("H2O3_TPU_HIST_SUBTRACT")


def build_tree(bins_u8, w, t, h, *, n_bins: int, is_cat_cols, max_depth: int,
               min_rows: float, min_split_improvement: float,
               learn_rate: float, preds, varimp, cols_enabled=None,
               max_abs_leaf: float = float("inf"), node_cap: int = 2048,
               monotone=None):
    """Build one tree with one eager Python iteration per level.

    ``bins_u8`` (n, C) uint8 codes, per-row weight ``w`` (0 = out of this
    tree), target ``t`` (residual) and hessian ``h``, all on one device;
    ``varimp`` a (C,) accumulator. ``monotone`` ((C,) ints in {-1, 0, 1},
    or None) constrains the split scans (kernel B3 on the card) and clips
    leaves to the bounds carried from level to level. Returns
    ``(Tree, preds, varimp)``.
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

    wy = w * t
    wh = torch.where(w > 0, h, 0.0)  # sampled-out rows carry no hessian
    stats = torch.stack([w, wy, wh], dim=1).contiguous()
    subtract = _subtract_enabled()
    nid = torch.zeros(bins_u8.shape[0], dtype=torch.int32, device=dev)
    tree = Tree()
    parent_hist = pair_info = None
    for depth in range(max_depth + 1):
        n_pad = min(1 << depth, node_cap)
        n_pad_next = min(2 * n_pad, node_cap)
        force_leaf = depth == max_depth
        if force_leaf and subtract and pair_info is not None:
            # leaf stats straight from the parents' chosen splits
            st = torch.stack([pair_info["Lst"], pair_info["Rst"]],
                             dim=1).reshape(n_pad, 3)
            nid, preds, varimp_p, n_split, rec = _force_leaf_from_stats(
                bins_u8, nid, preds, varimp_p, st[:, 0], st[:, 1], st[:, 2],
                learn_rate, max_abs_leaf, n_pad, n_bins, node_lo, node_hi)
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
                bins_u8, nid, preds, varimp_p, tot[:, 0], tot[:, 1], tot[:, 2],
                learn_rate, max_abs_leaf, n_pad, n_bins, node_lo, node_hi)
        else:
            (nid, preds, varimp_p, n_split, rec, pair_info,
             bounds) = _level_core(
                hist, bins_u8, nid, preds, varimp_p, cols_enabled, is_cat_dev,
                min_rows, min_split_improvement, learn_rate, max_abs_leaf,
                n_pad=n_pad, n_pad_next=n_pad_next, cat_cols=cat_cols,
                mono=mono, node_lo=node_lo, node_hi=node_hi)
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


def _sibling_hist(bins_u8, nid, stats, n_pad, n_bins, parent_hist, pair_info):
    """Sibling subtraction: histogram only the lighter child of each split
    pair (``n_pad // 2`` node slots); the heavier sibling is ``parent −
    built``. Children ``2i``/``2i+1`` share pair slot ``i``."""
    half = n_pad // 2
    row_pair = torch.clamp(nid, min=0) >> 1
    row_left = (nid & 1) == 0
    bl = pair_info["build_left"]
    build_row = (nid >= 0) & (row_left == bl[row_pair.long()])
    nid_build = torch.where(build_row, row_pair, -1).to(torch.int32)
    built = histogram(bins_u8, nid_build, stats, half, n_bins)
    psel = torch.where(pair_info["valid"][:, None, None, None],
                       parent_hist[pair_info["parent_idx"]], 0.0)
    sib = psel - built
    blb = bl[:, None, None, None]
    return torch.stack(
        [torch.where(blb, built, sib), torch.where(blb, sib, built)], dim=1
    ).reshape(n_pad, *built.shape[1:])
