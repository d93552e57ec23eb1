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

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

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


def _kernel_assignment(start, g):
    """What ``b1_hist_tile`` and ``b1_hist_reduce`` (``csrc/hist.cu``) do
    with the compacted rows, step for step: per (cluster, rank) the
    non-empty ranges of compacted positions it adds and the node of each,
    per touched (cluster, tile) its partial slot, and per non-empty tile the
    clusters the reduce sums (``owner``). Only the first ``min(clusters,
    active rows)`` clusters take rows."""
    N, nt, Q, CS = len(start) - 1, g["nt"], g["clusters"], g["cluster"]
    T, n_act = g["tiles"], int(start[-1])
    Qe = min(Q, n_act)

    def tile_of(p):
        return max(t for t in range(T) if start[t * nt] <= p)

    def owner(p):
        return ((p + 1) * Qe - 1) // n_act

    ranges, slots = [], {}
    for c in range(Qe):
        lo, hi = c * n_act // Qe, (c + 1) * n_act // Qe
        for t in range(tile_of(lo), tile_of(hi - 1) + 1):
            node0 = t * nt
            nn = min(nt, N - node0)
            if start[node0] == start[node0 + nn]:
                continue
            slots[(c, t)] = c + t
            for k in range(nn):
                a = max(lo, int(start[node0 + k]))
                b = min(hi, int(start[node0 + k + 1]))
                for r in range(CS):
                    ra, rb = a + (b - a) * r // CS, a + (b - a) * (r + 1) // CS
                    if ra < rb:
                        ranges.append((ra, rb, node0 + k))
    readers = {t: set(range(owner(int(start[t * nt])),
                            owner(int(start[min((t + 1) * nt, N)]) - 1) + 1))
               for t in range(T)
               if start[min((t + 1) * nt, N)] > start[t * nt]}
    return ranges, slots, readers


def _check_assignment(nid, n_nodes, g):
    """Every active row is added exactly once under its own node, each
    (cluster, tile) that meets has its own partial slot inside the scratch,
    and the reduce reads exactly the clusters that wrote."""
    counts = np.bincount(nid[nid >= 0], minlength=n_nodes)
    start = np.concatenate([[0], np.cumsum(counts)])
    ranges, slots, readers = _kernel_assignment(start, g)
    ranges.sort()
    assert sum(b - a for a, b, _ in ranges) == start[-1]
    for (a0, b0, _), (a1, _, _) in zip(ranges, ranges[1:]):
        assert b0 == a1  # contiguous, no overlap
    for a, b, node in ranges:
        assert start[node] <= a < b <= start[node + 1]
    assert len(set(slots.values())) == len(slots)
    assert all(s < g["slots"] for s in slots.values())
    for t, cs in readers.items():
        assert cs == {c for (c, tt) in slots if tt == t}
    assert set(readers) == {t for (_, t) in slots}


def _WAVE(smem):
    """Clusters an H100 holds at once: at most two blocks per SM (64
    registers x 512 threads each), fewer where shared memory runs out,
    give or take what its GPCs leave over (the card's own count comes from
    cudaOccupancyMaxActiveClusters)."""
    return (132 * min(2, hc.SMEM_PER_SM // (smem + hc.SMEM_RESERVED))
            // hc._CLUSTER)


@pytest.mark.parametrize("n_nodes", [1, 2, 4, 8, 16, 32])
def test_launch_geometry_fits_shared_memory(n_nodes):
    """B1's geometry at the headline shape (1M x 28, 256 bins, 3 lanes, 132
    SMs) with half of the rows dead, as in a sibling launch: the block's
    shared memory fits one block and two per SM, clusters divide the grid
    into one wave, every active row is added exactly once under its own
    node, each (cluster, tile) that meets has its own partial slot inside
    the scratch, and the reduce reads exactly the clusters that wrote."""
    n, C, B, S = 1_000_000, 28, 256, 3
    g = hc.launch_geometry(n, C, n_nodes, B, S, wave=_WAVE)
    assert g["smem"] <= hc.SMEM_LIMIT
    assert 2 * (g["smem"] + hc.SMEM_RESERVED) <= hc.SMEM_PER_SM
    assert (g["cg"], g["nt"], g["colgroups"]) == (16, 1, 2)  # 48 KB
    assert g["grid"][0] % g["cluster"] == 0
    assert g["clusters"] * g["colgroups"] == _WAVE(g["smem"])  # one wave
    assert g["slots"] == g["clusters"] + g["tiles"] - 1
    assert g["part_floats"] == (g["colgroups"] * g["slots"] * g["nt"]
                                * g["cg"] * B * S)

    rng = np.random.default_rng(n_nodes)
    nid = rng.integers(0, n_nodes, n)
    nid[rng.random(n) < 0.5] = -1
    _check_assignment(nid, n_nodes, g)


@pytest.mark.parametrize("n,C,n_nodes,active,tiles", [
    (150, 16, 1, 60, None),          # a small frame's sibling launch
    (150, 28, 4, 30, None),
    (1_000_000, 28, 8, 50, None),    # a late level: fewer rows than clusters
    (1_000_000, 28, 32, 1, None),
    (1_000_000, 28, 8, 0, None),     # nothing left to add
    (1_000_000, 28, 16, 70, (64, 8, 4)),  # node tiles of 4
])
def test_launch_geometry_fewer_active_rows_than_clusters(n, C, n_nodes,
                                                         active, tiles):
    """When fewer rows are active than the grid has clusters, the clusters
    past the active rows take none, and the reduce still reads exactly the
    clusters that wrote a partial."""
    g = hc.launch_geometry(n, C, n_nodes, 256, 3, wave=_WAVE, tiles=tiles)
    assert g["clusters"] > active
    rng = np.random.default_rng(n + active)
    nid = np.full(n, -1)
    rows = rng.choice(n, active, replace=False)
    nid[rows] = rng.integers(0, n_nodes, active)
    _check_assignment(nid, n_nodes, g)


def test_launch_geometry_tiles_and_limits():
    """Explicit tiles clamp columns and nodes to the problem, tiles over
    one block's shared memory are refused, and the built-in rows per block
    shrink as the column groups multiply the blocks."""
    g = hc.launch_geometry(1000, 5, 3, 256, 4, wave=_WAVE, tiles=(64, 16, 8))
    assert (g["cg"], g["nt"], g["colgroups"], g["tiles"]) == (5, 3, 1, 1)
    assert g["clusters"] == -(-1000 // (64 * hc._CLUSTER))
    with pytest.raises(ValueError):
        hc.launch_geometry(1000, 64, 8, 256, 4, wave=_WAVE, tiles=(64, 64, 8))
    with pytest.raises(ValueError):
        hc.launch_geometry(1000, 8, 8, 256, 4, wave=_WAVE, tiles=(0, 8, 1))
    wide = hc.builtin_tiles(1_000_000, 100, 4, 256, 4, wave=_WAVE)
    assert wide[1] % 4 == 0 and wide[1] * 256 * 4 * 4 <= hc._BUILTIN_SMEM
    groups = -(-100 // wide[1])  # 4 groups share one wave's clusters
    per_group = _WAVE(wide[1] * 256 * 4 * 4) // groups
    assert wide[0] == -(-1_000_000 // (per_group * hc._CLUSTER))


def _compact_numpy(nid, n_nodes):
    keep = (nid >= 0) & (nid < n_nodes)
    start = np.concatenate([[0], np.cumsum(np.bincount(nid[keep],
                                                       minlength=n_nodes))])
    return [np.flatnonzero(nid == k) for k in range(n_nodes)], start


@pytest.mark.parametrize("n,n_nodes,dead", [
    (1000, 1, 0.0), (5000, 8, 0.5), (4099, 33, 0.1), (300, 4, 1.0),
    (0, 3, 0.0)])
def test_compact_plain_matches_numpy(n, n_nodes, dead):
    """The compaction's plain version: each node gets exactly its rows,
    offsets are the cumulative bincount, and rows with nid < 0 or
    nid >= n_nodes are dropped."""
    rng = np.random.default_rng(n + n_nodes)
    nid = rng.integers(0, n_nodes + 2, n).astype(np.int32)  # some >= N
    nid[rng.random(n) < dead] = -1
    rows, start = hc.compact_plain(torch.from_numpy(nid), n_nodes)
    assert rows.dtype == start.dtype == torch.int32 and rows.shape == (n,)
    want_rows, want_start = _compact_numpy(nid, n_nodes)
    np.testing.assert_array_equal(start.numpy(), want_start)
    for k in range(n_nodes):
        got = rows[start[k]:start[k + 1]].numpy()
        np.testing.assert_array_equal(np.sort(got), want_rows[k])


def test_cuda_wrappers_refuse_cpu_and_cache_the_wave(monkeypatch):
    """The compaction wrapper refuses CPU tensors like hist_cuda does, and
    the card's clusters per wave are asked once per device and shape, not
    on every launch."""
    with pytest.raises(ValueError):
        hc.compact_cuda(torch.zeros(10, dtype=torch.int32), 2)
    calls = []

    class _Lib:
        def h2o3_hist_wave_clusters(self, S, smem, cluster, out):
            calls.append((S, smem, cluster))
            out._obj.value = 30
            return 0

    monkeypatch.setattr(hc, "_lib", _Lib)
    monkeypatch.setattr(hc, "_WAVE", {})
    monkeypatch.setattr(torch.cuda, "device", lambda idx: contextlib.nullcontext())
    dev = torch.device("cuda", 0)
    assert hc._wave_clusters(dev, 3, 86016) == 30
    assert hc._wave_clusters(dev, 3, 86016) == 30
    assert hc._wave_clusters(dev, 3, 43008) == 30
    assert calls == [(3, 86016, hc._CLUSTER), (3, 43008, hc._CLUSTER)]


@pytest.mark.parametrize("threads", [1, 8])
def test_plain_hist_sums_each_cell_in_row_order(threads):
    """The plain histogram scatters every (column, row) pair at once, and
    each cell still adds its rows in row order: float sums bit-equal to
    one float32 scatter per column, rows added one after another, whatever
    torch's thread count (codes past ``n_bins`` and rows out of the node
    range skipped)."""
    rng = np.random.default_rng(6)
    n, C, N, B = 5_000, 7, 4, 9
    bins = torch.from_numpy(rng.integers(0, B + 2, (n, C)).astype(np.uint8))
    nid = torch.from_numpy(rng.integers(-1, N + 1, n).astype(np.int32))
    stats = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    want = torch.zeros(N, C, B, 3)
    for c in range(C):
        h = torch.zeros(N * B, 3)
        for i in np.flatnonzero((nid.numpy() >= 0) & (nid.numpy() < N)
                                & (bins[:, c].numpy() < B)):
            h[int(nid[i]) * B + int(bins[i, c])] += stats[i]
        want[:, c] = h.reshape(N, B, 3)
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        got = hc.hist_plain(bins, nid, stats, N, B)
    finally:
        torch.set_num_threads(old)
    assert torch.equal(got, want)
