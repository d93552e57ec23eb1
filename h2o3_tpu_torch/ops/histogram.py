"""Histogram accumulation — the port of ``h2o3_tpu/ops/histogram.py``.

The hot loop of tree building: for every row, look up its current node
``nid`` and add its stat lanes ({w, wy, wh} for GBM) into (node, col, bin)
cells. One device holds every row, so there is no cross-device reduction.

:func:`histogram` is the dispatch: a CUDA tensor goes to kernel B1
(:func:`~h2o3_tpu_torch.ops.hist_cuda.hist_cuda`), a CPU tensor to its plain
PyTorch version (:func:`~h2o3_tpu_torch.ops.hist_cuda.hist_plain`, the
``index_add_`` form of ``_hist_scatter_local``). There is no other route:
a CUDA tensor never falls back to the plain version, and a CPU tensor
during a CUDA graph capture raises.

``H2O3_TPU_HIST_I16`` wraps the plain version in JAX's int16 lane
(:func:`_i16_local`, after ``h2o3_tpu.ops.histogram._i16_local``), the
accumulate form included. Kernel B1 is left as it is, as JAX leaves its
Pallas kernel (``_maybe_i16``): on the card the knob changes nothing.
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch import config
from h2o3_tpu_torch.ops.cuda_graph import check_not_capturing
from h2o3_tpu_torch.ops.hist_cuda import hist_cuda, hist_plain


def histogram(bins_u8: torch.Tensor, nid: torch.Tensor, stats: torch.Tensor,
              n_nodes: int, n_bins: int,
              out: torch.Tensor | None = None) -> torch.Tensor:
    """(n_nodes, C, n_bins, S) float32 histogram of ``stats`` (n, S) — the
    layout of ``histogram_in_jit``'s result. Rows with ``nid < 0`` add
    nothing. Given ``out`` (a caller's histogram of that shape), the
    histogram is added into it and ``out`` returned: one row block's
    contribution to a streamed level (JAX's ``_stream_hist_prog``)."""
    if bins_u8.device.type == "cuda":
        return hist_cuda(bins_u8, nid, stats, n_nodes, n_bins, out=out)
    if bins_u8.device.type != "cpu":
        raise ValueError(f"no histogram route for device {bins_u8.device}")
    check_not_capturing("histogram")
    if config.get_bool("H2O3_TPU_HIST_I16"):
        h = _i16_local(bins_u8, nid, stats, n_nodes, n_bins)
        return h if out is None else out.add_(h)
    return hist_plain(bins_u8, nid, stats, n_nodes, n_bins, out=out)


# the i16 lane's histograms, and those whose quantized cells passed the
# int16 budget so that the float32 pass ran (JAX's
# tree_hist_i16_overflows_total)
I16_EVENTS = {"histograms": 0, "overflows": 0}


def _i16_local(bins_u8, nid, stats, n_nodes: int, n_bins: int):
    """The int16 lane of the plain histogram: each node's stat lanes
    rescaled so that its rows fit int8-range codes (scale 1, exact, where
    the lane is already integers within 127), the codes summed and the
    sums rescaled back; if any summed cell passes 32,767 the float32
    histogram is returned instead. Rows with ``nid < 0`` carry no stats,
    as JAX masks them before its local impl."""
    S = stats.shape[1]
    stats = torch.where((nid >= 0)[:, None], stats, 0.0)
    nd = nid.clamp(min=0).long()
    idx = nd[:, None].expand(-1, S)
    zero = torch.zeros(n_nodes, S, dtype=stats.dtype, device=stats.device)
    absmax = zero.scatter_reduce(0, idx, stats.abs(), "amax")
    nonint = zero.scatter_reduce(
        0, idx, (stats != torch.round(stats)).to(stats.dtype), "amax")
    exact = (absmax <= 127.0) & (nonint == 0.0)
    scale = torch.where(exact, 1.0, absmax.clamp(min=1e-30) / 127.0)
    q = torch.round(stats / scale[nd])
    hq = hist_plain(bins_u8, nid, q, n_nodes, n_bins)  # (N, C, B, S)
    I16_EVENTS["histograms"] += 1
    if bool((hq.abs() > 32767.0).any()):
        I16_EVENTS["overflows"] += 1
        return hist_plain(bins_u8, nid, stats, n_nodes, n_bins)
    return hq * scale[:, None, None, :]


def dense_view(hist: torch.Tensor) -> torch.Tensor:
    """(N, C, B, S) -> (C, N·B, S): the dense layout of
    ``hist_pallas_local(..., blocked=False)`` and ``_hist_scatter_local``."""
    N, C, B, S = hist.shape
    return hist.permute(1, 0, 2, 3).reshape(C, N * B, S)


def node_totals(hist: torch.Tensor) -> torch.Tensor:
    """(N, S) per-node stat totals from column 0 (every row lights exactly
    one bin per column, so any column's bin sum is the node total)."""
    return hist[:, 0, :, :].sum(dim=1)
