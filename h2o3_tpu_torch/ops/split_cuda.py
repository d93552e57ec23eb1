"""Kernel B2, the numeric split scan: the port of the Pallas TPU kernel
``h2o3_tpu/ops/split_pallas.py::_split_kernel`` (driven by
``split_candidates``), with its plain PyTorch version beside it, and
:func:`fused_split_scan`, the counterpart of ``split_pallas.fused_split_scan``
that turns the per-(node, column) candidates into per-node split decisions.

For every (node, column) of a dense ``(N, C, B, 3)`` {w, wy, wh} histogram:
bin prefix sums over data bins 1..B-1, the NA bin (bin 0) tried on the left
and on the right, ``min_rows`` feasibility on both children, and
``gain = fit(parent) - fit(L) - fit(R)`` with ``fit(s) = -wy²/max(w, 1e-30)``
against the caller's node totals (infeasible candidates get ``_NEG``); the
lowest-index argmax over candidates, the NA direction there, and the folded
child stats. The arithmetic is ``shared_tree._split_scan``'s numeric branch
op for op, so on integer-exact data (the tie suites) the kernel and the plain
version decide bit-identically.

Categorical columns keep the mean-sorted plain branch on every device, as
they do in JAX (argsorts are not a kernel-friendly shape).
"""

from __future__ import annotations

import ctypes

import torch

from h2o3_tpu_torch.ops import cuda_build, histogram

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


def split_candidates_plain(hist: torch.Tensor, node_totals: torch.Tensor,
                           min_rows: float):
    """Plain PyTorch version of B2: ``(gain, tbest, na_left, Lst, Rst)`` with
    shapes (N, C), (N, C) int32, (N, C) bool, (N, C, 3), (N, C, 3)."""
    na = hist[:, :, 0, :]
    data = hist[:, :, 1:, :]
    parent_fit = _fit(node_totals)
    cum = torch.cumsum(data, dim=2)
    tot_nonna = cum[:, :, -1:, :]
    left = cum[:, :, :-1, :]  # split after data-bin t: left = bins 1..t+1
    right = tot_nonna - left
    g_nal = _gain_with_na(parent_fit, left + na[:, :, None, :], right, min_rows)
    g_nar = _gain_with_na(parent_fit, left, right + na[:, :, None, :], min_rows)
    g = torch.maximum(g_nal, g_nar)
    tbest = torch.argmax(g, dim=2)  # lowest index on ties
    nal = _take(g_nal, tbest) >= _take(g_nar, tbest)
    Lst = _take(left, tbest) + torch.where(nal[:, :, None], na, 0.0)
    Rst = _take(right, tbest) + torch.where(~nal[:, :, None], na, 0.0)
    return _take(g, tbest), tbest.to(torch.int32), nal, Lst, Rst


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("split")
    if not getattr(lib, "_h2o3_typed", False):
        lib.h2o3_split_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.h2o3_split_launch.restype = ctypes.c_int
        lib._h2o3_typed = True
    return lib


def split_candidates_cuda(hist: torch.Tensor, node_totals: torch.Tensor,
                          min_rows: float):
    """Launch kernel B2 on CUDA tensors; same returns as the plain version."""
    if hist.device.type != "cuda":
        raise ValueError("split_candidates_cuda takes CUDA tensors")
    dev = hist.device
    if hist.dtype != torch.float32 or hist.dim() != 4 or hist.shape[3] != 3:
        raise ValueError(f"hist must be float32 (N, C, B, 3), got "
                         f"{hist.dtype} {tuple(hist.shape)}")
    N, C, B, _ = hist.shape
    if not 3 <= B <= 257:
        raise ValueError(f"split kernel takes 3..257 bins, got {B}")
    if (node_totals.dtype != torch.float32 or node_totals.shape != (N, 3)
            or node_totals.device != dev):
        raise ValueError("node_totals must be float32 (N, 3) on the "
                         "histogram's device")
    if not hist.is_contiguous() or not node_totals.is_contiguous():
        raise ValueError("hist and node_totals must be contiguous")
    gain = torch.empty(N, C, dtype=torch.float32, device=dev)
    tbest = torch.empty(N, C, dtype=torch.int32, device=dev)
    nal = torch.empty(N, C, dtype=torch.uint8, device=dev)
    Lst = torch.zeros(N, C, 3, dtype=torch.float32, device=dev)
    Rst = torch.zeros(N, C, 3, dtype=torch.float32, device=dev)
    if N == 0 or C == 0:
        return gain, tbest, nal.bool(), Lst, Rst
    lib = _lib()
    err = lib.h2o3_split_launch(
        hist.data_ptr(), node_totals.data_ptr(), float(min_rows), N, C, B,
        gain.data_ptr(), tbest.data_ptr(), nal.data_ptr(), Lst.data_ptr(),
        Rst.data_ptr(), cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "split kernel launch")
    split_candidates_cuda.launches += 1
    return gain, tbest, nal.view(torch.bool), Lst, Rst


split_candidates_cuda.launches = 0


def split_candidates(hist: torch.Tensor, node_totals: torch.Tensor,
                     min_rows: float):
    """Dispatch: a CUDA histogram goes to kernel B2, a CPU one to the plain
    version — never the plain version on the card."""
    if hist.device.type == "cuda":
        return split_candidates_cuda(hist, node_totals, min_rows)
    if hist.device.type != "cpu":
        raise ValueError(f"no split route for device {hist.device}")
    return split_candidates_plain(hist, node_totals, min_rows)


def _cat_candidates(hist, cat_cols, parent_fit, min_rows):
    """Mean-sorted prefix split on the categorical column subset — the
    categorical branch of ``shared_tree._split_scan``, plain on every
    device."""
    idx = torch.as_tensor(cat_cols, dtype=torch.long, device=hist.device)
    data_c = hist[:, idx, 1:, :]
    na_c = hist[:, idx, 0, :]
    w_bins = data_c[..., 0]
    mean = torch.where(w_bins > 0, data_c[..., 1] / torch.clamp(w_bins, min=1e-30),
                       torch.inf)
    order = torch.sort(mean, dim=2, stable=True).indices  # empty bins last
    S = hist.shape[3]
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
                     candidates=split_candidates) -> dict:
    """Best split per node from an (N, C, B, 3) histogram — the counterpart
    of ``split_pallas.fused_split_scan``: numeric candidates from
    ``candidates`` (kernel B2 on the card by default), categorical columns
    (static ``cat_cols``) through the mean-sorted plain branch, then the
    lowest-index column argmax under ``col_mask``. Returns the decision dict
    of ``shared_tree._split_scan``."""
    N, C, B, _ = hist.shape
    dev = hist.device
    if node_totals is None:
        node_totals = histogram.node_totals(hist)
    node_totals = node_totals.contiguous()
    gain_n, t_n, nal_n, Lst_n, Rst_n = candidates(hist, node_totals, min_rows)
    rows = torch.arange(N, device=dev)

    if cat_cols:
        parent_fit = _fit(node_totals)
        cat = _cat_candidates(hist, cat_cols, parent_fit, min_rows)
        cat_idx = torch.as_tensor(cat_cols, dtype=torch.long, device=dev)
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

    return {
        "Lst": Lst, "Rst": Rst, "gain": best_gain,
        "ok": best_gain >= min_split_improvement,
        "col": best_col.to(torch.int32), "is_cat": bc_is_cat,
        "split_bin": split_bin, "na_left": bc_na_left, "cat_mask": cat_mask,
        "node_w": node_totals[:, 0], "node_wy": node_totals[:, 1],
        "node_wh": node_totals[:, 2],
    }
