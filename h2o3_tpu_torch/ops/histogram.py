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
"""

from __future__ import annotations

import torch

from h2o3_tpu_torch.ops.cuda_graph import check_not_capturing
from h2o3_tpu_torch.ops.hist_cuda import hist_cuda, hist_plain


def histogram(bins_u8: torch.Tensor, nid: torch.Tensor, stats: torch.Tensor,
              n_nodes: int, n_bins: int) -> torch.Tensor:
    """(n_nodes, C, n_bins, S) float32 histogram of ``stats`` (n, S) — the
    layout of ``histogram_in_jit``'s result. Rows with ``nid < 0`` add
    nothing."""
    if bins_u8.device.type == "cuda":
        return hist_cuda(bins_u8, nid, stats, n_nodes, n_bins)
    if bins_u8.device.type != "cpu":
        raise ValueError(f"no histogram route for device {bins_u8.device}")
    check_not_capturing("histogram")
    return hist_plain(bins_u8, nid, stats, n_nodes, n_bins)


def dense_view(hist: torch.Tensor) -> torch.Tensor:
    """(N, C, B, S) -> (C, N·B, S): the dense layout of
    ``hist_pallas_local(..., blocked=False)`` and ``_hist_scatter_local``."""
    N, C, B, S = hist.shape
    return hist.permute(1, 0, 2, 3).reshape(C, N * B, S)


def node_totals(hist: torch.Tensor) -> torch.Tensor:
    """(N, S) per-node stat totals from column 0 (every row lights exactly
    one bin per column, so any column's bin sum is the node total)."""
    return hist[:, 0, :, :].sum(dim=1)
