"""The port's histogram (kernel B1's plain version, ``h2o3_tpu_torch.ops``)
against the JAX package's Pallas histogram kernel in the interpreter
(``hist_pallas_local(..., interpret=True)``, dense and blocked) and against
an exact float64 numpy sum, over the shapes ``tests/test_hist_pallas.py``
probes. Inputs are made with numpy from a seed and handed to both.

Tolerances: the port accumulates in float32, so against float64 it is held
to 1e-5 relative to the cell mass (max(|ref|, 1)); the Pallas kernel splits
its stats into two bf16 terms (~16 mantissa bits), so port vs Pallas is held
to that kernel's own 5e-5 envelope. Integer-valued stats are exact in any
summation order and are compared bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from h2o3_tpu.ops.histogram import _hist_scatter_local  # noqa: E402
from h2o3_tpu.ops.hist_pallas import (  # noqa: E402
    NODE_TILE,
    ROW_TILE,
    dense_from_blocked,
    hist_pallas_local,
    plan_layout,
)
from h2o3_tpu_torch.ops import hist_cuda as hc  # noqa: E402
from h2o3_tpu_torch.ops.histogram import dense_view, histogram, node_totals  # noqa: E402


def _make_case(n, c, n_nodes, n_bins, seed, na_frac=0.1, retired_frac=0.1,
               zero_w_frac=0.1):
    rng = np.random.default_rng(seed)
    bins = rng.integers(1, n_bins, size=(n, c)).astype(np.uint8)
    bins[rng.random((n, c)) < na_frac] = 0  # NA bin 0 occupied
    nid = rng.integers(0, n_nodes, size=n).astype(np.int32)
    nid[rng.random(n) < retired_frac] = -1  # retired rows
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < zero_w_frac] = 0.0  # sampled-out rows
    t = rng.normal(size=n).astype(np.float32)
    stats = np.stack([w, w * t, w * rng.random(n).astype(np.float32)], axis=1)
    # the JAX kernel's contract: retired rows arrive with zero stats (the
    # port skips nid < 0 itself; see the masked-rows cases below)
    stats[nid < 0] = 0.0
    return bins, nid, stats


def _port(bins, nid, stats, n_nodes, n_bins):
    return dense_view(histogram(
        torch.from_numpy(bins), torch.from_numpy(nid),
        torch.from_numpy(stats), n_nodes, n_bins)).numpy()


def _f64(bins, nid, stats, n_nodes, n_bins):
    C = bins.shape[1]
    ref = np.zeros((C, n_nodes * n_bins, stats.shape[1]), np.float64)
    act = nid >= 0
    for col in range(C):
        np.add.at(ref[col], nid[act] * n_bins + bins[act, col],
                  stats[act].astype(np.float64))
    return ref


def _rel_err(got, ref):
    return (np.abs(got - ref) / np.maximum(np.abs(ref), 1.0)).max()


CASES = [
    # (n_rows, n_cols, n_nodes, n_bins) — test_hist_pallas's boundaries,
    # plus its f64-accuracy shape
    pytest.param(1000, 4, 8, 256, id="rows-not-row-tile-multiple"),
    pytest.param(ROW_TILE, 3, 1, 256, id="single-node-exact-tile"),
    pytest.param(700, 5, NODE_TILE + 16, 256, id="nodes-over-node-tile"),
    pytest.param(1300, 11, 8, 64, id="cols-over-col-tile-small-bins"),
    pytest.param(257, 2, 4, 17, id="odd-bins-lane-padding"),
    pytest.param(4096, 6, 32, 256, id="f64-accuracy-bound"),
]


@pytest.mark.parametrize("n,c,n_nodes,n_bins", CASES)
def test_hist_matches_pallas_and_f64(n, c, n_nodes, n_bins):
    bins, nid, stats = _make_case(n, c, n_nodes, n_bins, seed=n + c)
    got = _port(bins, nid, stats, n_nodes, n_bins)
    assert got.shape == (c, n_nodes * n_bins, 3) and got.dtype == np.float32
    assert _rel_err(got, _f64(bins, nid, stats, n_nodes, n_bins)) < 1e-5

    args = (jnp.asarray(bins), jnp.asarray(nid), jnp.asarray(stats))
    dense = np.asarray(hist_pallas_local(*args, n_nodes, n_bins, interpret=True))
    assert _rel_err(got, dense) < 5e-5
    blk = hist_pallas_local(*args, n_nodes, n_bins, interpret=True, blocked=True)
    lay = plan_layout(c, n_nodes, n_bins, 3)
    assert _rel_err(got, np.asarray(dense_from_blocked(blk, lay))) < 5e-5


def _masked_case(kind):
    """(bins, nid, stats, n_nodes, n_bins, reference) for the row-masking
    and code-layout contracts of test_hist_pallas."""
    if kind == "retired":
        bins, _, stats = _make_case(800, 3, 4, 64, seed=3, retired_frac=0.0)
        # every row retired, WITH nonzero stats: the port skips them itself
        nid = np.full(800, -1, np.int32)
        return bins, nid, stats, 4, 64, np.zeros((3, 4 * 64, 3))
    if kind == "zero-stat":
        bins, nid, stats = _make_case(800, 3, 4, 64, seed=3, retired_frac=0.0,
                                      zero_w_frac=0.0)
        mask = np.zeros(800, bool)
        mask[::5] = True
        stats[mask] = 0.0  # sampled-out rows keep their nid
        kept = [jnp.asarray(a[~mask]) for a in (bins, nid, stats)]
        ref = np.asarray(_hist_scatter_local(*kept, 4, 64))
        return bins, nid, stats, 4, 64, ref
    rng = np.random.default_rng(4)  # categorical codes 1..7, S = 4 lanes
    n, k = 1536, 7
    bins = rng.integers(1, k + 1, size=(n, 1)).astype(np.uint8)
    nid = rng.integers(0, 3, size=n).astype(np.int32)
    w = np.ones(n, np.float32)
    stats = np.stack([w, w, np.zeros(n, np.float32), w], axis=1)
    args = (jnp.asarray(bins), jnp.asarray(nid), jnp.asarray(stats))
    ref = np.asarray(hist_pallas_local(*args, 3, k + 1, interpret=True))
    return bins, nid, stats, 3, k + 1, ref


@pytest.mark.parametrize("kind", ["retired", "zero-stat", "categorical"])
def test_hist_masked_rows_and_codes(kind):
    """Retired rows add nothing, zero-stat rows equal the JAX scatter with
    those rows removed (float sums: 1e-6), and categorical codes land in
    their own cells (integer-exact: bit for bit)."""
    bins, nid, stats, n_nodes, n_bins, ref = _masked_case(kind)
    got = _port(bins, nid, stats, n_nodes, n_bins)
    if kind == "zero-stat":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)
    if kind == "categorical":  # every row accounted for
        assert got[0, :, 0].sum() == len(nid)


def test_dispatch_and_layout_helpers():
    """A CPU tensor takes the plain version (no kernel launch), the CUDA
    wrapper refuses CPU tensors, and the node totals equal every column's
    bin sum."""
    bins, nid, stats = _make_case(600, 4, 4, 32, seed=5)
    b, n_, s = (torch.from_numpy(a) for a in (bins, nid, stats))
    before = hc.hist_cuda.launches
    h = histogram(b, n_, s, 4, 32)
    assert hc.hist_cuda.launches == before
    assert torch.equal(h, hc.hist_plain(b, n_, s, 4, 32))
    with pytest.raises(ValueError):
        hc.hist_cuda(b, n_, s, 4, 32)
    tot = node_totals(h)
    for col in range(4):
        torch.testing.assert_close(h[:, col].sum(dim=1), tot, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_nodes", [1, 8, 32])
def test_launch_geometry_fits_shared_memory(n_nodes):
    """B1's block tiling at the headline shape (1M x 28, 256 bins, 3 lanes):
    every block's shared-memory histogram fits the budget, column groups
    keep 4-byte code loads aligned, and the stripes cover every row."""
    n, C = 1_000_000, 28
    g = hc.launch_geometry(n, C, n_nodes, 256, 3, n_sm=132)
    assert g["smem"] <= hc._SMEM_BUDGET
    assert g["cg"] % 4 == 0 and g["nt"] <= n_nodes
    stripes = -(-n // g["rows_per_block"])
    assert stripes * g["rows_per_block"] >= n
    assert g["blocks"] == stripes * -(-C // g["cg"]) * -(-n_nodes // g["nt"])
