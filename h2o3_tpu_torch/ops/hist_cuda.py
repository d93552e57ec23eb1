"""Kernel B1, the histogram: the port of the Pallas TPU kernel
``h2o3_tpu/ops/hist_pallas.py::_hist_kernel`` (driven by
``hist_pallas_local``), with its plain PyTorch version beside it.

Per (node, column, bin) it sums each row's S stat lanes over the rows with
``nid == node`` and ``bins[row, col] == bin``; rows with ``nid < 0``
(retired leaves, sampled-out sibling rows) or ``nid >= n_nodes`` add
nothing, and so do codes ``>= n_bins``. Both versions return the dense
``(n_nodes, C, n_bins, S)`` float32 histogram — the layout the split kernel
(B2, ``split_cuda.py``) reads with one warp per (node, column).

The CUDA kernel (``csrc/hist.cu``) keeps a block-private histogram in
shared memory, filled with float atomics, and merges it into the zeroed
output with one global atomic per non-empty cell. Global atomics make the
float summation order change from run to run, so two CUDA runs can differ
in the last bits (sums of integer-valued stats stay exact in any order).
"""

from __future__ import annotations

import ctypes

import torch

from h2o3_tpu_torch.ops import cuda_build

_SMEM_BUDGET = 96 * 1024  # bytes of shared memory per block (2 blocks/SM)
_THREADS = 512
_NODE_TILE = 8


def hist_plain(bins_u8: torch.Tensor, nid: torch.Tensor, stats: torch.Tensor,
               n_nodes: int, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version: the ``index_add_`` form of
    ``h2o3_tpu.ops.histogram._hist_scatter_local``, one scatter per column.
    Unlike the JAX scatter it skips ``nid < 0`` rows itself, so their stats
    need no masking by the caller. It sums in the dtype of ``stats``
    (float32 on the main path; float64 gives an exact-sum reference)."""
    n, C = bins_u8.shape
    S = stats.shape[1]
    keep = (nid >= 0) & (nid < n_nodes)
    nd = nid[keep].long()
    b = bins_u8[keep].long()
    st = stats[keep]
    out = torch.zeros(C, n_nodes * n_bins, S, dtype=stats.dtype,
                      device=bins_u8.device)
    for c in range(C):
        bc = b[:, c]
        ok = bc < n_bins
        out[c].index_add_(0, (nd * n_bins + bc)[ok], st[ok])
    return out.reshape(C, n_nodes, n_bins, S).permute(1, 0, 2, 3).contiguous()


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("hist")
    if not getattr(lib, "_h2o3_typed", False):
        lib.h2o3_hist_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.h2o3_hist_launch.restype = ctypes.c_int
        lib._h2o3_typed = True
    return lib


def launch_geometry(n: int, C: int, n_nodes: int, n_bins: int, S: int,
                    n_sm: int) -> dict:
    """Block tiling of one launch: ``nt`` nodes x ``cg`` columns of
    shared-memory histogram per block (under the budget), and row stripes
    sized so one wave of two blocks per SM covers the grid."""
    cell = n_bins * S * 4
    if cell > _SMEM_BUDGET:
        raise ValueError(f"hist_cuda: {n_bins} bins x {S} stats exceed the "
                         f"{_SMEM_BUDGET} B shared-memory budget of one block")
    nt = min(n_nodes, _NODE_TILE)
    while nt > 1 and nt * cell > _SMEM_BUDGET:
        nt //= 2
    cg = min(C, _SMEM_BUDGET // (nt * cell))
    if cg >= 4:
        cg -= cg % 4
    tiles = -(-C // cg) * -(-n_nodes // nt)
    stripes = max(1, min(-(-n // 1024), -(-2 * n_sm // tiles)))
    rows_per_block = -(-n // stripes)
    return {"nt": nt, "cg": cg, "rows_per_block": rows_per_block,
            "smem": nt * cg * cell, "blocks": stripes * tiles}


def hist_cuda(bins_u8: torch.Tensor, nid: torch.Tensor, stats: torch.Tensor,
              n_nodes: int, n_bins: int) -> torch.Tensor:
    """Launch kernel B1 on CUDA tensors; returns (n_nodes, C, n_bins, S)."""
    if bins_u8.device.type != "cuda":
        raise ValueError("hist_cuda takes CUDA tensors")
    dev = bins_u8.device
    if bins_u8.dtype != torch.uint8 or bins_u8.dim() != 2:
        raise ValueError("bins must be a 2-D uint8 tensor")
    if nid.dtype != torch.int32 or stats.dtype != torch.float32:
        raise ValueError("nid must be int32 and stats float32")
    n, C = bins_u8.shape
    if nid.shape != (n,) or stats.dim() != 2 or stats.shape[0] != n:
        raise ValueError(f"shape mismatch: bins {tuple(bins_u8.shape)}, "
                         f"nid {tuple(nid.shape)}, stats {tuple(stats.shape)}")
    S = stats.shape[1]
    if not 1 <= S <= 4:
        raise ValueError(f"hist_cuda takes 1..4 stat lanes, got {S}")
    for name, t in (("bins", bins_u8), ("nid", nid), ("stats", stats)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bins on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.zeros(n_nodes, C, n_bins, S, dtype=torch.float32, device=dev)
    if n == 0 or n_nodes == 0 or C == 0:
        return out
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = launch_geometry(n, C, n_nodes, n_bins, S, n_sm)
    vec4 = int(C % 4 == 0 and g["cg"] % 4 == 0 and bins_u8.data_ptr() % 4 == 0)
    lib = _lib()
    err = lib.h2o3_hist_launch(
        bins_u8.data_ptr(), nid.data_ptr(), stats.data_ptr(), out.data_ptr(),
        n, C, n_nodes, n_bins, S, g["nt"], g["cg"], g["rows_per_block"], vec4,
        _THREADS, cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "hist kernel launch")
    hist_cuda.launches += 1
    return out


hist_cuda.launches = 0
