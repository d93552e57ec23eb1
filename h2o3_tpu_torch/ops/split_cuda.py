"""Kernels B2 and B3, the numeric split scan: the ports of the Pallas TPU
kernels ``h2o3_tpu/ops/split_pallas.py::_split_kernel`` and
``_split_kernel_mono`` (driven by ``split_candidates``), each with its plain
PyTorch version beside it, and :func:`fused_split_scan`, the counterpart of
``split_pallas.fused_split_scan`` that turns the per-(node, column)
candidates into per-node split decisions.

For every (node, column) of a dense ``(N, C, B, 3)`` {w, wy, wh} histogram:
bin prefix sums over data bins 1..B-1, the NA bin (bin 0) tried on the left
and on the right, ``min_rows`` feasibility on both children, and
``gain = fit(parent) - fit(L) - fit(R)`` with ``fit(s) = -wy²/max(w, 1e-30)``
against the caller's node totals (infeasible candidates get ``_NEG``); the
lowest-index argmax over candidates, the NA direction there, and the folded
child stats. The arithmetic is ``shared_tree._split_scan``'s numeric branch
op for op, so on integer-exact data (the tie suites) the kernel and the plain
version decide bit-identically.

B3 (monotone constraints) is B2 plus a feasibility mask: each child's
Newton value ``wy/wh`` (0 where ``wh <= 0``) is clipped to the node's
``[lo, hi]``, and a candidate whose clipped values run against the column's
direction ``mono`` ∈ {-1, 0, 1} gets ``_NEG`` — the ``mono`` branch of
``shared_tree._split_scan``, op for op.

On the card both run one block per (node, column) with one thread per
candidate (:func:`split_geometry`, ``csrc/split.cu``), and write every
element of their five outputs, which the wrapper hands out as views of one
``torch.empty`` buffer (:func:`output_layout`): no memset.

Categorical columns keep the mean-sorted plain branch on every device, as
they do in JAX (argsorts are not a kernel-friendly shape).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from h2o3_tpu_torch.ops import cuda_build, histogram
from h2o3_tpu_torch.ops.cuda_graph import check_not_capturing

_NEG = -1e30  # the sentinel of shared_tree._NEG, same compares


def _fit(s: torch.Tensor) -> torch.Tensor:
    """SE with the cancelling wy² term dropped: ``-wy²/max(w, 1e-30)``."""
    w = s[..., 0]
    return -torch.where(w > 0, s[..., 1] ** 2 / torch.clamp(w, min=1e-30), 0.0)


def _gain_with_na(parent_fit, L, R, min_rows):
    ok = (L[..., 0] >= min_rows) & (R[..., 0] >= min_rows)
    g = parent_fit[:, None, None] - _fit(L) - _fit(R)
    return torch.where(ok, g, _NEG)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(a, idx[..., None], axis=2).squeeze(2)`` for an
    (N, C, T) or (N, C, T, S) array and (N, C) indices."""
    if a.dim() == 3:
        return a.gather(2, idx[:, :, None]).squeeze(2)
    S = a.shape[3]
    return a.gather(2, idx[:, :, None, None].expand(-1, -1, 1, S)).squeeze(2)


def _scan_plain(hist, node_totals, min_rows, mono_args=None):
    """The plain scan of B2, and of B3 when ``mono_args`` is
    ``(mono, node_lo, node_hi)``."""
    na = hist[:, :, 0, :]
    data = hist[:, :, 1:, :]
    parent_fit = _fit(node_totals)
    cum = torch.cumsum(data, dim=2)
    tot_nonna = cum[:, :, -1:, :]
    left = cum[:, :, :-1, :]  # split after data-bin t: left = bins 1..t+1
    right = tot_nonna - left
    na_b = na[:, :, None, :]
    g_nal = _gain_with_na(parent_fit, left + na_b, right, min_rows)
    g_nar = _gain_with_na(parent_fit, left, right + na_b, min_rows)
    if mono_args is not None:
        # monotone feasibility, the ops of split_pallas.py:96-116
        mono, node_lo, node_hi = mono_args
        lo = node_lo[:, None, None]
        hi = node_hi[:, None, None]
        m = mono.to(torch.int32)[None, :, None]
        ok_nl = (m == 0) | (m * (_child_val(right, lo, hi)
                                 - _child_val(left + na_b, lo, hi)) >= 0)
        ok_nr = (m == 0) | (m * (_child_val(right + na_b, lo, hi)
                                 - _child_val(left, lo, hi)) >= 0)
        g_nal = torch.where(ok_nl, g_nal, _NEG)
        g_nar = torch.where(ok_nr, g_nar, _NEG)
    g = torch.maximum(g_nal, g_nar)
    tbest = torch.argmax(g, dim=2)  # lowest index on ties
    nal = _take(g_nal, tbest) >= _take(g_nar, tbest)
    Lst = _take(left, tbest) + torch.where(nal[:, :, None], na, 0.0)
    Rst = _take(right, tbest) + torch.where(~nal[:, :, None], na, 0.0)
    return _take(g, tbest), tbest.to(torch.int32), nal, Lst, Rst


def _child_val(s: torch.Tensor, lo: torch.Tensor,
               hi: torch.Tensor) -> torch.Tensor:
    """Newton child value ``wy/wh`` (0 where ``wh <= 0``) clipped to the
    node bounds; ``lo``/``hi`` broadcast against ``s[..., 0]``."""
    wh = s[..., 2]
    v = torch.where(wh > 0, s[..., 1] / torch.clamp(wh, min=1e-30), 0.0)
    return torch.minimum(torch.maximum(v, lo), hi)


def _on_busy_nodes(fn, hist: torch.Tensor, node_totals: torch.Tensor,
                   *per_node: torch.Tensor):
    """``fn(hist, node_totals, *per_node)`` for a per-node scan, run on the
    CPU only over the nodes that hold data. Each node's result depends on
    its own rows of the inputs alone, and a node whose histogram and totals
    are all zero gets the same result whatever its other inputs (no
    candidate is feasible, or every one ties at zero with every bound
    met), so one such node is scanned and stands for all of them. The
    result is the full scan's, bit for bit: deep trees cap their levels at
    hundreds of nodes of which a few hold rows. On the card the scan runs
    whole (a kernel, or a comparison against one)."""
    N = hist.shape[0]
    if hist.device.type != "cpu" or N < 16:
        return fn(hist, node_totals, *per_node)
    busy = (hist.reshape(N, -1).ne(0).any(1)
            | node_totals.reshape(N, -1).ne(0).any(1))
    idx = torch.nonzero(busy).squeeze(1)
    nb = idx.numel()
    if nb > N // 2:
        return fn(hist, node_totals, *per_node)
    take = torch.cat([idx, torch.nonzero(~busy)[:1, 0]])
    sub = fn(*(t.index_select(0, take) for t in (hist, node_totals)
               + per_node))
    pos = torch.full((N,), nb, dtype=torch.long)
    pos[idx] = torch.arange(nb)
    if isinstance(sub, dict):
        return {k: v.index_select(0, pos) for k, v in sub.items()}
    return tuple(v.index_select(0, pos) for v in sub)


def split_candidates_plain(hist: torch.Tensor, node_totals: torch.Tensor,
                           min_rows: float):
    """Plain PyTorch version of B2: ``(gain, tbest, na_left, Lst, Rst)`` with
    shapes (N, C), (N, C) int32, (N, C) bool, (N, C, 3), (N, C, 3)."""
    return _on_busy_nodes(
        lambda h, t: _scan_plain(h, t, min_rows), hist, node_totals)


def split_candidates_mono_plain(hist: torch.Tensor, node_totals: torch.Tensor,
                                min_rows: float, mono: torch.Tensor,
                                node_lo: torch.Tensor, node_hi: torch.Tensor):
    """Plain PyTorch version of B3: B2's scan with the monotone feasibility
    mask. ``mono`` (C,) int in {-1, 0, 1}, ``node_lo``/``node_hi`` (N,)
    float; same returns as B2."""
    return _on_busy_nodes(
        lambda h, t, lo, hi: _scan_plain(h, t, min_rows, (mono, lo, hi)),
        hist, node_totals, node_lo, node_hi)


_MAX_THREADS = 256  # one thread per data bin: B <= 257 (csrc/split.cu)


def split_geometry(N: int, C: int, B: int) -> dict:
    """The launch geometry of B2/B3 (``csrc/split.cu``): a one-dimensional
    grid of one block per (node, column), each of ``round_up(B - 1, 32)``
    threads, one per data bin and candidate."""
    if not 3 <= B <= _MAX_THREADS + 1:
        raise ValueError(f"split kernel takes 3..{_MAX_THREADS + 1} bins, "
                         f"got {B}")
    if N * C > 2 ** 31 - 1:
        raise ValueError(f"split kernel takes fewer than 2**31 (node, "
                         f"column) pairs, got {N * C}")
    return {"grid": N * C, "threads": 32 * -(-(B - 1) // 32)}


@functools.lru_cache(maxsize=256)
def output_layout(N: int, C: int) -> tuple[tuple, int]:
    """Where the five outputs lie in the wrapper's one buffer:
    ``((dtype, shape, byte offset), ...), total bytes`` for gain, t,
    na_left, Lst and Rst, each contiguous at a 16-byte aligned offset."""
    out, off = [], 0
    for dtype, shape in ((torch.float32, (N, C)), (torch.int32, (N, C)),
                         (torch.bool, (N, C)), (torch.float32, (N, C, 3)),
                         (torch.float32, (N, C, 3))):
        out.append((dtype, shape, off))
        off += -(-dtype.itemsize * math.prod(shape) // 16) * 16
    return tuple(out), off


def _outputs(N: int, C: int, dev) -> tuple:
    """``(gain, tbest, na_left, Lst, Rst)`` as views of one ``torch.empty``
    buffer: the kernel writes every element, so nothing is zeroed. Each view
    is one ``as_strided`` of the buffer seen as its dtype (tensor ops cost
    the host microseconds each, and this runs once per tree level)."""
    layout, total = output_layout(N, C)
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    typed = {dt: buf.view(dt) for dt in (torch.float32, torch.int32,
                                          torch.bool)}
    return tuple(typed[dtype].as_strided(
        shape, (C, 1) if len(shape) == 2 else (3 * C, 3, 1),
        off // dtype.itemsize) for dtype, shape, off in layout)


_ARGTYPES = {
    "h2o3_split_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ],
    "h2o3_split_mono_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ],
}


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("split")
    if not getattr(lib, "_h2o3_typed", False):
        for fn, argtypes in _ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib._h2o3_typed = True
    return lib


def _check_inputs(hist: torch.Tensor, node_totals: torch.Tensor, who: str,
                  mono_args: tuple = ()):
    """Raise ``ValueError`` on what the kernels do not take. ``mono_args``
    are B3's ``(mono, node_lo, node_hi)``, which must already be int32 (C,)
    and float32 (N,) as the tree loop hands them over: they are checked,
    never converted. The device is checked last."""
    if hist.dtype != torch.float32 or hist.dim() != 4 or hist.shape[3] != 3:
        raise ValueError(f"hist must be float32 (N, C, B, 3), got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    N, C = hist.shape[:2]
    for name, t, dtype, shape in zip(
            ("node_totals", "mono", "node_lo", "node_hi"),
            (node_totals, *mono_args),
            (torch.float32, torch.int32, torch.float32, torch.float32),
            ((N, 3), (C,), (N,), (N,))):
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != hist.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {hist.device}")
    if not hist.is_contiguous():
        raise ValueError("hist must be contiguous")
    if hist.device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors")


def split_candidates_cuda(hist: torch.Tensor, node_totals: torch.Tensor,
                          min_rows: float):
    """Launch kernel B2 on CUDA tensors; same returns as the plain version."""
    _check_inputs(hist, node_totals, "split_candidates_cuda")
    N, C, B, _ = hist.shape
    g = split_geometry(N, C, B)
    out = _outputs(N, C, hist.device)
    if g["grid"] == 0:
        return out
    lib = _lib()
    err = lib.h2o3_split_launch(
        hist.data_ptr(), node_totals.data_ptr(), float(min_rows), N, C, B,
        g["grid"], g["threads"], *(o.data_ptr() for o in out),
        cuda_build.stream_handle(hist.device))
    cuda_build.check(lib, err, "split kernel launch")
    split_candidates_cuda.launches += 1
    return out


split_candidates_cuda.launches = 0


def split_candidates_mono_cuda(hist: torch.Tensor, node_totals: torch.Tensor,
                               min_rows: float, mono: torch.Tensor,
                               node_lo: torch.Tensor, node_hi: torch.Tensor):
    """Launch kernel B3 on CUDA tensors; same returns as the plain version.
    ``mono``/``node_lo``/``node_hi`` must already be int32 (C,) and float32
    (N,) on the card: they are checked, not converted."""
    _check_inputs(hist, node_totals, "split_candidates_mono_cuda",
                  (mono, node_lo, node_hi))
    N, C, B, _ = hist.shape
    g = split_geometry(N, C, B)
    out = _outputs(N, C, hist.device)
    if g["grid"] == 0:
        return out
    lib = _lib()
    err = lib.h2o3_split_mono_launch(
        hist.data_ptr(), node_totals.data_ptr(), float(min_rows),
        mono.data_ptr(), node_lo.data_ptr(), node_hi.data_ptr(), N, C, B,
        g["grid"], g["threads"], *(o.data_ptr() for o in out),
        cuda_build.stream_handle(hist.device))
    cuda_build.check(lib, err, "monotone split kernel launch")
    split_candidates_mono_cuda.launches += 1
    return out


split_candidates_mono_cuda.launches = 0

# the wrappers whose ``.launches`` count card launches (``ops/cuda_graph.py``
# adds a graph's share at every replay)
COUNTERS = (split_candidates_cuda, split_candidates_mono_cuda)


def split_candidates(hist: torch.Tensor, node_totals: torch.Tensor,
                     min_rows: float):
    """Dispatch: a CUDA histogram goes to kernel B2, a CPU one to the plain
    version — never the plain version on the card."""
    if hist.device.type == "cuda":
        return split_candidates_cuda(hist, node_totals, min_rows)
    if hist.device.type != "cpu":
        raise ValueError(f"no split route for device {hist.device}")
    check_not_capturing("split_candidates")
    return split_candidates_plain(hist, node_totals, min_rows)


def split_candidates_mono(hist: torch.Tensor, node_totals: torch.Tensor,
                          min_rows: float, mono: torch.Tensor,
                          node_lo: torch.Tensor, node_hi: torch.Tensor):
    """Dispatch: a CUDA histogram goes to kernel B3, a CPU one to the plain
    version — never the plain version on the card."""
    args = (hist, node_totals, min_rows, mono, node_lo, node_hi)
    if hist.device.type == "cuda":
        return split_candidates_mono_cuda(*args)
    if hist.device.type != "cpu":
        raise ValueError(f"no split route for device {hist.device}")
    check_not_capturing("split_candidates_mono")
    return split_candidates_mono_plain(*args)


_CAT_INDEX: dict = {}


def _cat_index(cat_cols: tuple, dev) -> torch.Tensor:
    """The categorical column ids as a long tensor on ``dev``, made once per
    (columns, device): a host-to-device copy cannot run inside a CUDA graph
    capture, so the whole-tree warm-up makes it and the capture reuses it."""
    key = (tuple(cat_cols), str(dev))
    t = _CAT_INDEX.get(key)
    if t is None:
        t = _CAT_INDEX[key] = torch.as_tensor(cat_cols, dtype=torch.long,
                                              device=dev)
    return t


def _cat_candidates(hist, cat_cols, node_totals, min_rows):
    """Mean-sorted prefix split on the categorical column subset — the
    categorical branch of ``shared_tree._split_scan``, plain on every
    device."""
    idx = _cat_index(cat_cols, hist.device)
    return _on_busy_nodes(
        lambda h, t: _cat_scan(h[:, idx], _fit(t), min_rows),
        hist, node_totals)


def _cat_scan(hist_c, parent_fit, min_rows):
    data_c = hist_c[:, :, 1:, :]
    na_c = hist_c[:, :, 0, :]
    w_bins = data_c[..., 0]
    mean = torch.where(w_bins > 0, data_c[..., 1] / torch.clamp(w_bins, min=1e-30),
                       torch.inf)
    order = torch.sort(mean, dim=2, stable=True).indices  # empty bins last
    S = hist_c.shape[3]
    sdata = data_c.gather(2, order[..., None].expand(-1, -1, -1, S))
    scum = torch.cumsum(sdata, dim=2)
    s_left = scum[:, :, :-1, :]
    s_right = scum[:, :, -1:, :] - s_left
    g_nal = _gain_with_na(parent_fit, s_left + na_c[:, :, None, :], s_right, min_rows)
    g_nar = _gain_with_na(parent_fit, s_left, s_right + na_c[:, :, None, :], min_rows)
    g = torch.maximum(g_nal, g_nar)
    k = torch.argmax(g, dim=2)
    return {
        "gain": _take(g, k), "k": k,
        "na_left": _take(g_nal, k) >= _take(g_nar, k),
        "order": order, "s_left": s_left, "s_right": s_right, "na": na_c,
    }


def fused_split_scan(hist: torch.Tensor, is_cat: torch.Tensor,
                     col_mask: torch.Tensor, min_rows: float,
                     min_split_improvement: float, cat_cols: tuple = (),
                     node_totals: torch.Tensor | None = None,
                     plain: bool = False, mono: torch.Tensor | None = None,
                     node_lo: torch.Tensor | None = None,
                     node_hi: torch.Tensor | None = None) -> dict:
    """Best split per node from an (N, C, B, 3) histogram — the counterpart
    of ``split_pallas.fused_split_scan``: numeric candidates per (node,
    column) (kernel B2 on the card, B3 when ``mono`` is given; the plain
    versions on the CPU or with ``plain=True``), categorical columns
    (static ``cat_cols``) through the mean-sorted plain branch, then the
    lowest-index column argmax under ``col_mask``. Returns the decision dict
    of ``shared_tree._split_scan``.

    ``mono`` ((C,) int {-1, 0, 1}) with per-node ``node_lo``/``node_hi``
    bounds masks infeasible numeric candidates, and the result then carries
    ``mid`` and ``mono_col`` for child-bound propagation (categorical
    winners carry ``mono_col`` 0: the categorical branch is unconstrained,
    as in JAX)."""
    N, C, B, _ = hist.shape
    dev = hist.device
    if node_totals is None:
        node_totals = histogram.node_totals(hist)
    node_totals = node_totals.contiguous()
    if mono is None:
        scan = split_candidates_plain if plain else split_candidates
        gain_n, t_n, nal_n, Lst_n, Rst_n = scan(hist, node_totals, min_rows)
    else:
        scan = split_candidates_mono_plain if plain else split_candidates_mono
        gain_n, t_n, nal_n, Lst_n, Rst_n = scan(
            hist, node_totals, min_rows, mono, node_lo, node_hi)
    rows = torch.arange(N, device=dev)

    if cat_cols:
        cat = _cat_candidates(hist, cat_cols, node_totals, min_rows)
        cat_idx = _cat_index(cat_cols, dev)
        cat_gain = torch.full((N, C), _NEG, dtype=hist.dtype, device=dev)
        cat_gain[:, cat_idx] = cat["gain"]
        col_gain = torch.where(is_cat[None, :], cat_gain, gain_n)
    else:
        col_gain = gain_n
    col_gain = torch.where(col_mask > 0, col_gain, _NEG)
    best_col = torch.argmax(col_gain, dim=1)
    best_gain = col_gain[rows, best_col]
    split_bin = t_n[rows, best_col].to(torch.int32) + 1
    Lst = Lst_n[rows, best_col]
    Rst = Rst_n[rows, best_col]

    if cat_cols:
        pos_of_col = torch.zeros(C, dtype=torch.long, device=dev)
        pos_of_col[cat_idx] = torch.arange(len(cat_cols), device=dev)
        bc_is_cat = is_cat[best_col]
        best_pos = pos_of_col[best_col]
        bc_k = cat["k"][rows, best_pos]
        bc_na_left = torch.where(bc_is_cat, cat["na_left"][rows, best_pos],
                                 nal_n[rows, best_col])
        order = cat["order"]
        ranks = torch.empty_like(order).scatter_(
            2, order, torch.arange(order.shape[2], device=dev).expand_as(order))
        cat_left = ranks[rows, best_pos] <= bc_k[:, None]
        cat_mask = torch.cat([bc_na_left[:, None], cat_left], dim=1)
        cat_mask = cat_mask & bc_is_cat[:, None]
        nl = bc_na_left[:, None]
        na_best = cat["na"][rows, best_pos]
        Lst_c = cat["s_left"][rows, best_pos, bc_k] + torch.where(nl, na_best, 0.0)
        Rst_c = cat["s_right"][rows, best_pos, bc_k] + torch.where(~nl, na_best, 0.0)
        Lst = torch.where(bc_is_cat[:, None], Lst_c, Lst)
        Rst = torch.where(bc_is_cat[:, None], Rst_c, Rst)
    else:
        bc_is_cat = torch.zeros(N, dtype=torch.bool, device=dev)
        bc_na_left = nal_n[rows, best_col]
        cat_mask = torch.zeros(N, B, dtype=torch.bool, device=dev)

    out = {
        "Lst": Lst, "Rst": Rst, "gain": best_gain,
        "ok": best_gain >= min_split_improvement,
        "col": best_col.to(torch.int32), "is_cat": bc_is_cat,
        "split_bin": split_bin, "na_left": bc_na_left, "cat_mask": cat_mask,
        "node_w": node_totals[:, 0], "node_wy": node_totals[:, 1],
        "node_wh": node_totals[:, 2],
    }
    if mono is not None:
        # the chosen split's clipped child values -> mid for the children's
        # bounds (split_pallas.py:426-441)
        vL = _child_val(Lst, node_lo, node_hi)
        vR = _child_val(Rst, node_lo, node_hi)
        out["mid"] = 0.5 * (vL + vR)
        out["mono_col"] = torch.where(
            bc_is_cat, 0, mono.to(torch.int32)[best_col]).to(torch.int32)
    return out
