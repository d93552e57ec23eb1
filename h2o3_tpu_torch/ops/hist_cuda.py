"""Kernel B1, the histogram: the port of the Pallas TPU kernel
``h2o3_tpu/ops/hist_pallas.py::_hist_kernel`` (driven by
``hist_pallas_local``), with its plain PyTorch version beside it.

Per (node, column, bin) it sums each row's S stat lanes over the rows with
``nid == node`` and ``bins[row, col] == bin``; rows with ``nid < 0``
(retired leaves, sampled-out sibling rows) or ``nid >= n_nodes`` add
nothing, and so do codes ``>= n_bins``. Both versions return the dense
``(n_nodes, C, n_bins, S)`` float32 histogram — the layout the split
kernels (B2, B3, ``split_cuda.py``) read with one thread block per (node,
column).

B1's bound on an H100 is the bytes its inputs need: ``4n`` for ``nid``
read once, ``C + 4S`` for each active row and ``4·N·C·B·S`` written; in
practice the
``C·S`` shared-memory float atomics of each active row bound it (each a
compare-and-swap loop on sm_90). One launch of :func:`hist_cuda` runs four
kernels of ``csrc/hist.cu``:

- the compaction (:func:`compact_cuda`, a kernel with its own plain version
  :func:`compact_plain` and launch count) groups the active row ids by node;
  its two kernels read ``nid`` three times in all, and a dead sibling row
  costs those reads and nothing more;
- ``b1_hist_tile`` splits the active rows evenly over thread-block clusters
  (at most one cluster per active row, so none has an empty range);
  each block fills a shared-memory histogram of ``nt`` nodes x ``cg``
  columns with neighbouring lanes on neighbouring code words, and each
  cluster sums its blocks' histograms through distributed shared memory
  into one partial per node tile it met;
- ``b1_hist_reduce`` sums those partials per cell in cluster order and
  writes every cell: no global atomics and no memset of the output.

The launch geometry is three numbers, ``(rows per block, columns per group,
nodes per tile)``: built in by :func:`builtin_tiles`, or set or tuned
through ``H2O3_TPU_PALLAS_TILES`` (``ops/hist_tiles.py``). Two CUDA runs
can differ in the last bits of a float sum: the compaction reserves each
block's share of a node with a global atomic, so the rows a cluster sums
change from run to run, and the shared-memory atomics add in any order.
Sums of integer-valued stats are exact.

Each wrapper's ``.launches`` counts its launches on the card: one per call
outside a CUDA graph, and a graph's share at each replay
(``ops/cuda_graph.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from h2o3_tpu_torch.ops import cuda_build, hist_tiles

# The card's shared-memory limits, kept here alone: ``csrc/hist.cu`` has no
# copy (the runtime refuses a block over its limit).
SMEM_LIMIT = 232448  # bytes of dynamic shared memory one sm_90 block may use
SMEM_PER_SM = 233472  # shared memory of one H100 SM (228 KB)
SMEM_RESERVED = 1024  # per block, kept by the runtime
_BUILTIN_SMEM = SMEM_PER_SM // 2 - SMEM_RESERVED  # two blocks per SM
_COMPACT_THREADS = 512
_CLUSTER = 2  # blocks per thread-block cluster (measured best, PERF.md)
_MAX_COLS = 128  # columns per group: one row's words fit in one warp
_BUILTIN_COLS = 16  # four code words per row, eight rows per warp step
_MAX_NODES = SMEM_LIMIT // 8  # the compaction keeps 2 ints per node in shared memory

_WAVE: dict[tuple, int] = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _wave_clusters(dev: torch.device, S: int, smem: int) -> int:
    """Clusters of ``_CLUSTER`` histogram blocks with ``smem`` bytes of
    shared memory that ``dev`` holds at once (one wave), asked of the
    runtime once per device and shape."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, S, smem, _CLUSTER)
    n = _WAVE.get(key)
    if n is None:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):  # the query reads the current device
            err = lib.h2o3_hist_wave_clusters(S, smem, _CLUSTER,
                                              ctypes.byref(out))
        cuda_build.check(lib, err, "hist occupancy query")
        if out.value <= 0:
            raise RuntimeError(f"hist: the card holds no cluster of "
                               f"{_CLUSTER} blocks with {smem} B each")
        n = _WAVE[key] = out.value
    return n


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


def compact_plain(nid: torch.Tensor, n_nodes: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the compaction: ``(rows, start)``, int32. The ids of
    the rows with ``0 <= nid < n_nodes`` fill ``rows[:start[-1]]`` grouped
    by node (node ``k`` at ``rows[start[k]:start[k + 1]]``, in row order
    here, in any order from the kernel); entries past ``start[-1]`` are
    unspecified (-1 here)."""
    keep = (nid >= 0) & (nid < n_nodes)
    idx = torch.nonzero(keep).squeeze(1)
    nd = nid[idx].long()
    rows = torch.full_like(nid, -1, dtype=torch.int32)
    rows[: idx.numel()] = idx[torch.argsort(nd, stable=True)].to(torch.int32)
    start = torch.zeros(n_nodes + 1, dtype=torch.int32, device=nid.device)
    start[1:] = torch.cumsum(torch.bincount(nd, minlength=n_nodes), 0)
    return rows, start


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("hist")
    if not getattr(lib, "_h2o3_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.h2o3_compact_launch.argtypes = [p, ll, i, ll, i, p, p, p, p]
        lib.h2o3_compact_launch.restype = i
        lib.h2o3_hist_launch.argtypes = [p, p, p, p, p, p] + [i] * 10 + [p]
        lib.h2o3_hist_launch.restype = i
        lib.h2o3_hist_wave_clusters.argtypes = [i, i, i,
                                                ctypes.POINTER(i)]
        lib.h2o3_hist_wave_clusters.restype = i
        lib._h2o3_typed = True
    return lib


def _check_cuda(name: str, t: torch.Tensor, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_compact(nid: torch.Tensor, n_nodes: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    n = nid.shape[0]
    dev = nid.device
    rows = torch.empty(n, dtype=torch.int32, device=dev)
    start = torch.empty(n_nodes + 1, dtype=torch.int32, device=dev)
    work = torch.empty(2 * n_nodes, dtype=torch.int32, device=dev)
    lib = _lib()
    err = lib.h2o3_compact_launch(
        nid.data_ptr(), n, n_nodes, max(4096, 16 * n_nodes), _COMPACT_THREADS,
        rows.data_ptr(), start.data_ptr(), work.data_ptr(),
        cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "hist compaction launch")
    return rows, start


def compact_cuda(nid: torch.Tensor, n_nodes: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the compaction kernels on a CUDA ``nid``: the contract of
    :func:`compact_plain`, with the rows of one node in any order."""
    if nid.device.type != "cuda":
        raise ValueError("compact_cuda takes CUDA tensors")
    if nid.dtype != torch.int32 or nid.dim() != 1:
        raise ValueError("nid must be a 1-D int32 tensor")
    _check_cuda("nid", nid, nid.device)
    if not 1 <= n_nodes <= _MAX_NODES:
        raise ValueError(f"compact_cuda takes 1..{_MAX_NODES} nodes, "
                         f"got {n_nodes}")
    if nid.shape[0] >= 2 ** 31:
        raise ValueError("compact_cuda takes fewer than 2**31 rows")
    out = _launch_compact(nid, n_nodes)
    compact_cuda.launches += 1
    return out


compact_cuda.launches = 0


def rows_per_wave(n: int, colgroups: int, wave: int) -> int:
    """Rows per block such that one launch of ``colgroups`` column groups
    fills ``wave`` clusters once."""
    return max(1, _cdiv(n, max(1, wave // colgroups) * _CLUSTER))


def _cols_fitting(C: int, n_bins: int, S: int, cap: int) -> int:
    """Columns per group: at most ``cap`` and what fits two blocks per SM,
    a multiple of 4 (aligned 4-byte code loads) unless it is all of C."""
    cg = min(C, cap, max(1, _BUILTIN_SMEM // (n_bins * S * 4)))
    return cg - cg % 4 if 4 <= cg < C else cg


def builtin_tiles(n: int, C: int, n_nodes: int, n_bins: int, S: int,
                  wave) -> tuple[int, int, int]:
    """The built-in ``(rows per block, columns per group, nodes per tile)``:
    one node per tile, 16 columns per group (the headline's 28 in two
    groups of 48 KB; the autotuner's sweep found it best at the headline
    buckets, ``PERF.md``), and rows per block so that the launch is one
    wave. ``wave(smem)`` is the number of clusters the card holds at once
    at ``smem`` bytes of shared memory per block (:func:`_wave_clusters`)."""
    cg = _cols_fitting(C, n_bins, S, _BUILTIN_COLS)
    return (rows_per_wave(n, _cdiv(C, cg), wave(cg * n_bins * S * 4)), cg, 1)


def launch_geometry(n: int, C: int, n_nodes: int, n_bins: int, S: int,
                    wave, tiles: tuple[int, int, int] | None = None
                    ) -> dict:
    """One launch's geometry from ``tiles = (rows per block, columns per
    group, nodes per tile)`` (None: :func:`builtin_tiles`, which reads
    ``wave``). Columns and nodes clamp to the problem. The grid is
    ``clusters x cluster`` blocks by column groups (on the card only the
    first ``min(clusters, active rows)`` clusters take rows);
    ``part_floats`` is the partials' scratch, one ``nt x cg x B x S`` tile
    per column group and slot, and there are ``clusters + tiles - 1`` slots
    (``csrc/hist.cu``)."""
    if tiles is None:
        tiles = builtin_tiles(n, C, n_nodes, n_bins, S, wave)
    rpb, cg, nt = (int(v) for v in tiles)
    if min(rpb, cg, nt) <= 0:
        raise ValueError(f"hist tiles must be positive, got {tiles}")
    cg, nt = min(cg, C, _MAX_COLS), min(nt, n_nodes)
    smem = nt * cg * n_bins * S * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"hist tiles {tiles}: {smem} B of shared memory "
                         f"exceed the {SMEM_LIMIT} B of one block")
    colgroups = _cdiv(C, cg)
    n_tiles = _cdiv(n_nodes, nt)
    clusters = max(1, _cdiv(n, rpb * _CLUSTER))
    slots = clusters + n_tiles - 1
    return {"rows_per_block": rpb, "cg": cg, "nt": nt, "cluster": _CLUSTER,
            "clusters": clusters, "colgroups": colgroups, "tiles": n_tiles,
            "slots": slots, "grid": (clusters * _CLUSTER, colgroups),
            "smem": smem,
            "part_floats": colgroups * slots * nt * cg * n_bins * S}


def _launch_hist(bins_u8: torch.Tensor, stats: torch.Tensor,
                 rows: torch.Tensor, start: torch.Tensor, n_nodes: int,
                 n_bins: int, g: dict) -> torch.Tensor:
    n, C = bins_u8.shape
    S = stats.shape[1]
    dev = bins_u8.device
    part = torch.empty(g["part_floats"], dtype=torch.float32, device=dev)
    out = torch.empty(n_nodes, C, n_bins, S, dtype=torch.float32, device=dev)
    vec4 = int(C % 4 == 0 and g["cg"] % 4 == 0 and bins_u8.data_ptr() % 4 == 0)
    lib = _lib()
    err = lib.h2o3_hist_launch(
        bins_u8.data_ptr(), stats.data_ptr(), rows.data_ptr(), start.data_ptr(),
        part.data_ptr(), out.data_ptr(), C, n_nodes, n_bins, S, g["nt"],
        g["cg"], g["clusters"], g["cluster"], g["slots"], vec4,
        cuda_build.stream_handle(dev))
    cuda_build.check(lib, err, "hist kernel launch")
    return out


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
        _check_cuda(name, t, dev)
    if n == 0 or n_nodes == 0 or C == 0:
        return torch.zeros(n_nodes, C, n_bins, S, dtype=torch.float32,
                           device=dev)
    tiles = hist_tiles.tiles_for(n, C, n_nodes, n_bins, S, dev)
    g = launch_geometry(n, C, n_nodes, n_bins, S,
                        functools.partial(_wave_clusters, dev, S), tiles)
    rows, start = compact_cuda(nid, n_nodes)
    out = _launch_hist(bins_u8, stats, rows, start, n_nodes, n_bins, g)
    hist_cuda.launches += 1
    return out


hist_cuda.launches = 0

# the wrappers whose ``.launches`` count card launches (``ops/cuda_graph.py``
# adds a graph's share at every replay)
COUNTERS = (hist_cuda, compact_cuda)
