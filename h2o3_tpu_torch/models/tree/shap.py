"""TreeSHAP and tree inspection — the port of
``h2o3_tpu/models/tree/shap.py`` (H2O's ``hex.tree.TreeSHAP`` and
``TreeHandler``).

``predict_contributions`` is the exact TreeSHAP recursion (Lundberg et al.,
Algorithm 2) over the recorded levels: the node covers are the ``node_w``
totals the training recorded, and the split decisions are taken on the bin
codes the trees were built on, so the contributions agree with the
prediction replay (a row's contributions and the bias term sum to its raw
margin).

JAX runs the recursion once per row in Python. Its walk over a tree's
nodes is the same for every row: only the one fractions depend on the row,
through the child it enters. So the port walks each tree's nodes once on
the host (:func:`contributions`), carrying the path's features and zero
fractions as host values and its one fractions and path weights as
float64 tensors of the rows on the frame's device: the left child's one
fraction is the parent's times the row's ``goes_left`` mask, the right
child's times its complement. That is JAX's arithmetic, row by row, so the
two agree to float64 rounding (the leaves' terms add in another order).
Rows go in blocks when the path state would pass ``_BLOCK_BYTES``. JAX's
row-by-row recursion is kept as the plain version
(:func:`contributions_plain`).

``predict_leaf_node_assignment`` walks the flattened node arrays on the
device; only the ``Path`` strings of the distinct paths are made on the
host. ``tree_view`` and the bias term read the host copy of the tree.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import CAT, INT, NUM, Frame, Vec
from h2o3_tpu_torch.models.tree.binning import bin_frame

# the path state's budget a row block (float64 tensors of the rows)
_BLOCK_BYTES = 1 << 30


class _Node:
    __slots__ = ("feature", "thr_bin", "is_cat", "cat_mask", "na_left",
                 "left", "right", "value", "cover", "is_leaf")


def _tree_nodes(tree) -> list[_Node]:
    """Flatten level arrays into an explicit node list (root = 0)."""
    host = tree.to_host()
    nodes: list[_Node] = []
    # frontier ids per level → node-list indices
    prev_ids: list[int] = []
    for li, lv in enumerate(host.levels):
        width = len(lv.split_col)
        cur_ids = []
        for i in range(width):
            nd = _Node()
            nd.is_leaf = bool(lv.leaf_now[i])
            nd.value = float(lv.leaf_val[i])
            nd.cover = float(lv.node_w[i]) if lv.node_w is not None else 0.0
            nd.feature = int(lv.split_col[i])
            nd.thr_bin = int(lv.split_bin[i])
            nd.is_cat = bool(lv.is_cat[i])
            nd.cat_mask = np.asarray(lv.cat_mask[i])
            nd.na_left = bool(lv.na_left[i])
            nd.left = nd.right = -1
            cur_ids.append(len(nodes))
            nodes.append(nd)
        if li > 0:
            plv = host.levels[li - 1]
            for pi, pid in enumerate(prev_ids):
                if not nodes[pid].is_leaf:
                    base = int(plv.child_base[pi])
                    nodes[pid].left = cur_ids[base]
                    nodes[pid].right = cur_ids[base + 1]
        prev_ids = cur_ids
    return nodes


def _expected_value(nodes: list[_Node], j: int) -> float:
    nd = nodes[j]
    if nd.is_leaf:
        return nd.value
    lc, rc = nodes[nd.left].cover, nodes[nd.right].cover
    tot = lc + rc
    if tot <= 0:
        return nd.value
    return (lc * _expected_value(nodes, nd.left)
            + rc * _expected_value(nodes, nd.right)) / tot


def _check_model(model) -> None:
    if model.output.get("n_tree_classes", 1) > 1:
        raise ValueError(
            "predict_contributions supports regression/binomial models only")


def _bias(model, trees_nodes) -> float:
    """The bias term: each tree's expected value under its covers, plus
    the init score for GBM (JAX adds it for ``algo == "gbm"`` alone, so
    XGBoost's bias lacks it, and no bias has the offset), over the tree
    count for DRF and XRT."""
    bias = 0.0
    for nodes in trees_nodes:
        bias += _expected_value(nodes, 0)
    if model.algo == "gbm":
        bias += float(np.asarray(model.output["init_f"]))
    if model.algo in ("drf", "xrt"):
        bias /= max(model.output["ntrees_actual"], 1)
    return bias


# ---------------------------------------------------------------------------
# the plain version: JAX's recursion, one row at a time


def _goes_left(nd: _Node, b: int) -> bool:
    if b == 0:
        return nd.na_left
    if nd.is_cat:
        return bool(nd.cat_mask[b])
    return b <= nd.thr_bin


def _shap_one_tree(nodes: list[_Node], bins_row: np.ndarray, phi: np.ndarray):
    """Exact TreeSHAP (Lundberg Alg. 2) for one row over one tree."""

    # unique-path arrays: feature index d, fraction zero z, fraction one o,
    # weight w
    def recurse(j, m, pd, pz, po, pw, pi1, pz1, po1):
        pd = pd + [pi1]
        pz = pz + [pz1]
        po = po + [po1]
        pw = pw + [1.0 if m == 0 else 0.0]
        for i in range(m - 1, -1, -1):
            pw[i + 1] += po1 * pw[i] * (i + 1) / (m + 1)
            pw[i] = pz1 * pw[i] * (m - i) / (m + 1)

        nd = nodes[j]
        if nd.is_leaf:
            for i in range(1, m + 1):
                wsum = _unwound_sum(pd, pz, po, pw, m, i)
                phi[pd[i]] += wsum * (po[i] - pz[i]) * nd.value
            return
        b = int(bins_row[nd.feature])
        hot, cold = ((nd.left, nd.right) if _goes_left(nd, b)
                     else (nd.right, nd.left))
        hot_cover = nodes[hot].cover
        cold_cover = nodes[cold].cover
        parent_cover = nd.cover if nd.cover > 0 else hot_cover + cold_cover
        iz, io = 1.0, 1.0
        k = _path_index(pd, nd.feature, m)
        if k >= 0:  # feature already on the path: unwind it first
            iz, io = pz[k], po[k]
            pd, pz, po, pw, m = _unwind(pd, pz, po, pw, m, k)
        denom = parent_cover if parent_cover > 0 else 1.0
        recurse(hot, m + 1, pd, pz, po, pw, nd.feature,
                iz * hot_cover / denom, io)
        recurse(cold, m + 1, pd, pz, po, pw, nd.feature,
                iz * cold_cover / denom, 0.0)

    recurse(0, 0, [], [], [], [], -1, 1.0, 1.0)


def _path_index(pd, feature, m):
    for i in range(1, m + 1):
        if pd[i] == feature:
            return i
    return -1


def _unwind(pd, pz, po, pw, m, i):
    pd, pz, po, pw = list(pd), list(pz), list(po), list(pw)
    n = pw[m]
    for j in range(m - 1, -1, -1):
        if po[i] != 0:
            t = pw[j]
            pw[j] = n * (m + 1) / ((j + 1) * po[i])
            n = t - pw[j] * pz[i] * (m - j) / (m + 1)
        else:
            pw[j] = (pw[j] * (m + 1) / (pz[i] * (m - j))
                     if pz[i] * (m - j) != 0 else pw[j])
    for j in range(i, m):
        pd[j] = pd[j + 1]
        pz[j] = pz[j + 1]
        po[j] = po[j + 1]
    return pd[:m], pz[:m], po[:m], pw[:m], m - 1


def _unwound_sum(pd, pz, po, pw, m, i):
    total = 0.0
    n = pw[m]
    if po[i] != 0:
        for j in range(m - 1, -1, -1):
            tmp = n / ((j + 1) * po[i]) * (m + 1)
            total += tmp
            n = pw[j] - tmp * pz[i] * (m - j) / (m + 1)
    else:
        for j in range(m - 1, -1, -1):
            if pz[i] * (m - j) != 0:
                total += pw[j] * (m + 1) / (pz[i] * (m - j))
    return total


def plain_phi(trees_nodes: list, bins: np.ndarray, C: int) -> np.ndarray:
    """(n, C) float64: every tree's contributions for the rows of ``bins``
    (host codes), summed over the trees, by JAX's row-by-row recursion.
    Plain data in and out, so a caller can split the rows over
    processes."""
    phi = np.zeros((bins.shape[0], C))
    for nodes in trees_nodes:
        for r in range(bins.shape[0]):
            row_phi = np.zeros(C + 1)
            _shap_one_tree(nodes, bins[r], row_phi[:C])
            phi[r] += row_phi[:C]
    return phi


def contributions_plain(model, frame: Frame) -> np.ndarray:
    """(n, C + 1) float64 contributions and bias term by JAX's row-by-row
    recursion on the host — the plain version of :func:`contributions`."""
    _check_model(model)
    out = model.output
    bins = bin_frame(out["bin_spec"], frame).cpu().numpy()
    C = len(out["names"])
    trees_nodes = [_tree_nodes(group[0]) for group in out["trees"]]
    phi = np.zeros((frame.nrow, C + 1))
    phi[:, :C] = plain_phi(trees_nodes, bins, C)
    if model.algo in ("drf", "xrt"):
        phi[:, :C] /= max(out["ntrees_actual"], 1)
    phi[:, C] = _bias(model, trees_nodes)
    return phi


# ---------------------------------------------------------------------------
# the device version: one walk of each tree for all the rows


def _goes_left_rows(nd: _Node, bins: torch.Tensor) -> torch.Tensor:
    """The rows' ``_goes_left`` at node ``nd``: (n,) bool."""
    b = bins[:, nd.feature].long()
    if nd.is_cat:
        mask = np.zeros(max(256, len(nd.cat_mask)), bool)
        mask[: len(nd.cat_mask)] = nd.cat_mask
        gl = torch.as_tensor(mask, device=bins.device)[b]
    else:
        gl = b <= nd.thr_bin
    return torch.where(b == 0, nd.na_left, gl)


def _unwind_rows(pd, pz, po, pw, m, i):
    """:func:`_unwind` with the one fractions ``po`` and weights ``pw`` as
    (m + 1, n) tensors; a row's branch is its ``po[i]``."""
    nz = po[i] != 0
    po_s = torch.where(nz, po[i], 1.0)
    pz_i = pz[i]
    n_ = pw[m]
    new = [None] * m
    for j in range(m - 1, -1, -1):
        t = pw[j]
        a = n_ * (m + 1) / ((j + 1) * po_s)
        zd = pz_i * (m - j)
        b = t * (m + 1) / zd if zd != 0 else t
        new[j] = torch.where(nz, a, b)
        n_ = torch.where(nz, t - new[j] * pz_i * (m - j) / (m + 1), n_)
    keep = [j for j in range(m + 1) if j != i]
    return (pd[:i] + pd[i + 1:], pz[:i] + pz[i + 1:], po[keep],
            torch.stack(new), m - 1)


def _unwound_sums(pz, po, pw, m) -> torch.Tensor:
    """:func:`_unwound_sum` for every path element i = 1..m at once:
    (m, n)."""
    pz_i = torch.as_tensor(pz[1:], dtype=torch.float64,
                           device=pw.device)[:, None]
    nz = po[1:] != 0
    po_s = torch.where(nz, po[1:], 1.0)
    n_ = pw[m].expand(m, -1)
    total_nz = torch.zeros_like(po_s)
    total_z = torch.zeros_like(po_s)
    for j in range(m - 1, -1, -1):
        tmp = n_ / ((j + 1) * po_s) * (m + 1)
        total_nz = total_nz + tmp
        n_ = pw[j] - tmp * pz_i * (m - j) / (m + 1)
        zd = pz_i * (m - j)
        ok = zd != 0
        total_z = total_z + torch.where(
            ok, pw[j] * (m + 1) / torch.where(ok, zd, 1.0), 0.0)
    return torch.where(nz, total_nz, total_z)


def _shap_tree_rows(nodes: list[_Node], bins: torch.Tensor,
                    phiT: torch.Tensor) -> None:
    """Add one tree's contributions of every row of ``bins`` into
    ``phiT`` ((C, n) float64): JAX's recursion with the row-dependent
    choice of the hot child replaced by both children, each with the
    rows' one fractions masked by the side they take."""
    n, dev = bins.shape[0], bins.device
    f64 = torch.float64

    def recurse(j, m, pd, pz, po, pw, pi1, pz1, po1):
        pd = pd + [pi1]
        pz = pz + [pz1]
        po = torch.cat([po, po1[None]])
        if m == 0:
            pw = torch.ones((1, n), dtype=f64, device=dev)
        else:
            k = torch.arange(m, dtype=f64, device=dev)[:, None]
            A = pz1 * pw * (m - k) / (m + 1)
            B = po1[None] * pw * (k + 1) / (m + 1)
            pw = torch.cat([A[:1], A[1:] + B[:-1], B[-1:]])
        nd = nodes[j]
        if nd.is_leaf:
            if m > 0:
                wsum = _unwound_sums(pz, po, pw, m)
                pz_t = torch.as_tensor(pz[1:], dtype=f64, device=dev)
                phiT.index_add_(
                    0, torch.as_tensor(pd[1:], device=dev),
                    wsum * (po[1:] - pz_t[:, None]) * nd.value)
            return
        go = _goes_left_rows(nd, bins).to(f64)
        lc, rc = nodes[nd.left].cover, nodes[nd.right].cover
        parent_cover = nd.cover if nd.cover > 0 else lc + rc
        iz, io = 1.0, None
        k = _path_index(pd, nd.feature, m)
        if k >= 0:  # feature already on the path: unwind it first
            iz, io = pz[k], po[k]
            pd, pz, po, pw, m = _unwind_rows(pd, pz, po, pw, m, k)
        denom = parent_cover if parent_cover > 0 else 1.0
        o_left = go if io is None else io * go
        o_right = 1.0 - go if io is None else io * (1.0 - go)
        recurse(nd.left, m + 1, pd, pz, po, pw, nd.feature,
                iz * lc / denom, o_left)
        recurse(nd.right, m + 1, pd, pz, po, pw, nd.feature,
                iz * rc / denom, o_right)

    recurse(0, 0, [], [], torch.empty((0, n), dtype=f64, device=dev),
            None, -1, 1.0, torch.ones(n, dtype=f64, device=dev))


def contributions(model, frame: Frame) -> torch.Tensor:
    """(n, C + 1) float64 contributions and bias term on the frame's
    device: per tree one walk of its nodes over all the rows (in blocks
    of the path state's budget)."""
    _check_model(model)
    out = model.output
    bins = bin_frame(out["bin_spec"], frame)
    C, n, dev = len(out["names"]), frame.nrow, bins.device
    trees_nodes = [_tree_nodes(group[0]) for group in out["trees"]]
    depth = max([len(g[0].levels) for g in out["trees"]] or [1])
    block = max(1, _BLOCK_BYTES // (8 * (depth + 2) ** 2))
    phiT = torch.zeros((C + 1, n), dtype=torch.float64, device=dev)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        for nodes in trees_nodes:
            tree_phi = torch.zeros((C, hi - lo), dtype=torch.float64,
                                   device=dev)
            _shap_tree_rows(nodes, bins[lo:hi], tree_phi)
            phiT[:C, lo:hi] += tree_phi
    if model.algo in ("drf", "xrt"):
        phiT[:C] /= max(out["ntrees_actual"], 1)
    phiT[C] = _bias(model, trees_nodes)
    return phiT.t()


def predict_contributions(model, frame: Frame) -> Frame:
    """Per-feature SHAP contributions on the margin scale + ``BiasTerm``,
    on the frame's device (H2O's predict_contributions contract: regression
    and binomial models). Each row sums to the raw margin that the replay
    gives (without an offset)."""
    phi = contributions(model, frame).to(torch.float32)
    return Frame([Vec(phi[:, j].contiguous(), NUM)
                  for j in range(phi.shape[1])],
                 list(model.output["names"]) + ["BiasTerm"])


# ---------------------------------------------------------------------------
# leaf assignment and the node table


def _flat_nodes(tree, dev) -> dict:
    """The level-flattened node arrays of ``tree`` (the numbering of
    :func:`_tree_nodes`) as tensors on ``dev``: split column, bin, kind,
    NA side, leaf flag, the (N, W) level masks and the children (-1 for a
    leaf)."""
    levels = tree.to_host().levels
    widths = [len(lv.split_col) for lv in levels]
    offs = np.concatenate([[0], np.cumsum(widths)]).astype(np.int64)
    N = int(offs[-1])
    left = np.full(N, -1, np.int64)
    for li in range(len(levels) - 1):
        lv = levels[li]
        inner = np.flatnonzero(~np.asarray(lv.leaf_now, bool))
        left[offs[li] + inner] = offs[li + 1] + np.asarray(
            lv.child_base, np.int64)[inner]
    right = np.where(left >= 0, left + 1, -1)
    W = max(np.asarray(lv.cat_mask).shape[1] for lv in levels)
    cat_mask = np.concatenate([
        np.pad(np.asarray(lv.cat_mask, bool),
               ((0, 0), (0, W - np.asarray(lv.cat_mask).shape[1])))
        for lv in levels])

    def cat(f, dt):
        return torch.as_tensor(np.concatenate(
            [np.asarray(getattr(lv, f)) for lv in levels]).astype(dt),
            device=dev)

    return {"feat": cat("split_col", np.int64),
            "thr": cat("split_bin", np.int64),
            "is_cat": cat("is_cat", bool), "na_left": cat("na_left", bool),
            "is_leaf": cat("leaf_now", bool),
            "cat_mask": torch.as_tensor(cat_mask, device=dev),
            "left": torch.as_tensor(left, device=dev),
            "right": torch.as_tensor(right, device=dev), "depth": len(levels)}


def _walk(fn: dict, bins: torch.Tensor) -> tuple:
    """Every row from the root to its leaf: ``(node id, path code)``, the
    code a base-3 number of the steps (1 left, 2 right, 0 once at the
    leaf)."""
    n = bins.shape[0]
    cur = torch.zeros(n, dtype=torch.int64, device=bins.device)
    code = torch.zeros_like(cur)
    W = fn["cat_mask"].shape[1]
    for _ in range(fn["depth"]):
        adv = ~fn["is_leaf"][cur]
        b = bins.gather(1, fn["feat"][cur][:, None]).squeeze(1).long()
        hit = fn["cat_mask"][cur, b.clamp(max=W - 1)] & (b < W)
        gl = torch.where(b == 0, fn["na_left"][cur],
                         torch.where(fn["is_cat"][cur], hit,
                                     b <= fn["thr"][cur]))
        code = code * 3 + torch.where(adv, torch.where(gl, 1, 2), 0)
        cur = torch.where(adv, torch.where(gl, fn["left"][cur],
                                           fn["right"][cur]), cur)
    return cur, code


def _path_vec(code: torch.Tensor, depth: int, name: str) -> Vec:
    """The enum column of the decision strings of ``code`` (domain: the
    sorted distinct strings, as JAX's): only the distinct codes go to the
    host."""
    uniq, inv = torch.unique(code, return_inverse=True)
    steps = max(depth, 1)
    strings = []
    for c in uniq.cpu().numpy().tolist():
        digits = []
        for _ in range(steps):
            digits.append(c % 3)
            c //= 3
        strings.append("".join("LR"[d - 1] for d in reversed(digits) if d))
    domain = sorted(set(strings))
    lut = torch.as_tensor(np.searchsorted(domain, strings),
                          device=code.device)
    dt, _ = Vec.device_dtype(CAT, domain)
    return Vec(lut[inv].to(getattr(torch, dt.name)), CAT, name=name,
               domain=tuple(domain))


def predict_leaf_node_assignment(model, frame: Frame,
                                 type: str = "Path") -> Frame:
    """Per-row terminal leaf of every tree (upstream
    ``Model.LeafNodeAssignment``): one column per (tree, class) named
    ``T{i}.C{k}``, the root-to-leaf decision string ("LRLL",
    ``type="Path"``) or the node's index in the level-flattened node list
    (``type="Node_ID"``), walked on the frame's device."""
    if type not in ("Path", "Node_ID"):
        raise ValueError(f"type must be 'Path' or 'Node_ID', got {type!r}")
    out = model.output
    bins = bin_frame(out["bin_spec"], frame)
    K = out.get("n_tree_classes", 1)
    vecs, names = [], []
    for ti, group in enumerate(out["trees"]):
        for k in range(K):
            fn = _flat_nodes(group[k], bins.device)
            cur, code = _walk(fn, bins)
            name = f"T{ti + 1}.C{k + 1}"
            names.append(name)
            if type == "Node_ID":
                vecs.append(Vec(cur.to(torch.float32), INT, name=name))
            else:
                vecs.append(_path_vec(code, fn["depth"], name))
    return Frame(vecs, names)


def tree_view(model, tree_number: int = 0, tree_class: int = 0) -> dict:
    """TreeHandler-style node table of one tree: parallel arrays keyed by
    node id (root 0, the level-flattened numbering)."""
    out = model.output
    tree = out["trees"][tree_number][tree_class]
    nodes = _tree_nodes(tree)
    names = out["names"]
    spec = out["bin_spec"]
    # reachability from the root: the levels are padded slot arrays and
    # their phantom nodes stay out of the table
    reachable = set()
    stack = [0] if nodes else []
    while stack:
        i = stack.pop()
        reachable.add(i)
        nd = nodes[i]
        if not nd.is_leaf:
            stack.extend([nd.left, nd.right])
    rows = {
        "node_id": [], "left_child": [], "right_child": [], "feature": [],
        "threshold": [], "na_direction": [], "prediction": [], "cover": [],
        "is_leaf": [], "levels": [],
    }
    for i, nd in enumerate(nodes):
        if i not in reachable:
            continue
        rows["node_id"].append(i)
        rows["left_child"].append(nd.left)
        rows["right_child"].append(nd.right)
        rows["is_leaf"].append(nd.is_leaf)
        rows["prediction"].append(nd.value if nd.is_leaf else None)
        rows["cover"].append(nd.cover)
        if nd.is_leaf:
            rows["feature"].append(None)
            rows["threshold"].append(None)
            rows["na_direction"].append(None)
            rows["levels"].append(None)
            continue
        rows["feature"].append(names[nd.feature])
        rows["na_direction"].append("LEFT" if nd.na_left else "RIGHT")
        if nd.is_cat:
            dom = (spec.domains[nd.feature] or ()) if spec.domains else ()
            left_levels = [
                dom[b - 1] for b in range(1, len(nd.cat_mask))
                if nd.cat_mask[b] and b - 1 < len(dom)
            ]
            rows["threshold"].append(None)
            rows["levels"].append(left_levels)
        else:
            e = spec.edges[nd.feature]
            t = nd.thr_bin - 1  # left iff bin <= thr_bin; edge index
            thr = (float(e[t]) if 0 <= t < len(e) and np.isfinite(e[t])
                   else float("inf"))
            rows["threshold"].append(thr)
            rows["levels"].append(None)
    return rows
