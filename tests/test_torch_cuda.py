"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a GPU. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the histogram kernel merges with float atomics, so with float
stats it is held against an exact float64 sum to 1e-5 of the cell's absolute
mass (float32 rounding in any summation order stays far inside that);
integer-valued stats sum exactly in any order, and there the kernels must
match their plain versions bit for bit. The monotone split kernel (B3) is
held bit-equal too, with integer hessians of 1 to 3 per row (so ``wh == 0``
is exact) and node bounds mixing ±inf with quarter-integers.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

from h2o3_tpu_torch.models.tree.shared_tree import build_tree  # noqa: E402
from h2o3_tpu_torch.ops import hist_tiles  # noqa: E402
from h2o3_tpu_torch.ops.hist_cuda import (  # noqa: E402
    _wave_clusters,
    compact_cuda,
    compact_plain,
    hist_cuda,
    hist_plain,
)
from h2o3_tpu_torch.ops.split_cuda import (  # noqa: E402
    fused_split_scan,
    output_layout,
    split_candidates_cuda,
    split_candidates_mono_cuda,
    split_candidates_mono_plain,
    split_candidates_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(n, C, N, B, seed, integer, code_dtype=np.uint8):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, C)).astype(code_dtype)
    nid = rng.integers(0, N, n).astype(np.int32)
    nid[rng.random(n) < 0.1] = -1
    if integer:
        w = np.ones(n, np.float32)
        t = rng.integers(-3, 4, n).astype(np.float32)
        stats = np.stack([w, t, w], axis=1)
    else:
        w = rng.random(n).astype(np.float32)
        stats = np.stack([w, w * rng.normal(size=n).astype(np.float32),
                          w * rng.random(n).astype(np.float32)], axis=1)
    return bins, nid, stats


@pytest.mark.parametrize("n_nodes,n_bins,C", [(1, 256, 28), (8, 256, 28),
                                              (32, 256, 7), (5, 17, 6)])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_hist_kernel_matches_plain(dev, n_nodes, n_bins, C, integer):
    bins, nid, stats = _case(100_003, C, n_nodes, n_bins, seed=n_nodes,
                             integer=integer)
    args = [torch.from_numpy(a).to(dev) for a in (bins, nid, stats)]
    before = hist_cuda.launches
    _check_hist(args, n_nodes, n_bins, integer)
    assert hist_cuda.launches == before + 1


def _check_hist(args, n_nodes, n_bins, integer):
    """B1 against its plain version: float stats to 1e-5 of cell mass
    against float64, integer stats bit-equal."""
    b, n_, st = args
    got = hist_cuda(b, n_, st, n_nodes, n_bins)
    if integer:
        assert torch.equal(got, hist_plain(b, n_, st, n_nodes, n_bins))
    else:
        ref64 = hist_plain(b, n_, st.double(), n_nodes, n_bins)
        mass = hist_plain(b, n_, st.double().abs(), n_nodes, n_bins)
        err = ((got.double() - ref64).abs() / mass.clamp(min=1.0)).max().item()
        assert err < 1e-5, err


@pytest.mark.parametrize("n,C,N,S,dead", [
    (1_000_003, 28, 16, 3, 0.5),  # the depth-5 sibling launch
    (200_001, 28, 33, 3, 0.1),    # 33 nodes: a tile past a power of two
    (100_003, 5, 8, 3, 0.1),      # C = 5: unaligned rows, byte loads
    (100_003, 12, 4, 1, 0.1),     # S = 1
    (100_003, 12, 4, 4, 0.1),     # S = 4
    (100, 28, 3, 3, 0.1),         # fewer rows than one block
])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_hist_kernel_shapes(dev, n, C, N, S, dead, integer):
    """B1 against its plain version on the shapes of the redesign: float
    stats to 1e-5 of cell mass against float64, integer stats bit-equal;
    codes reach past n_bins = 200 and nid past n_nodes."""
    rng = np.random.default_rng(n + C + N + S)
    bins = rng.integers(0, 256, (n, C)).astype(np.uint8)
    nid = rng.integers(0, N + 1, n).astype(np.int32)
    nid[rng.random(n) < dead] = -1
    if integer:
        stats = rng.integers(-3, 4, (n, S)).astype(np.float32)
    else:
        stats = (rng.random((n, S)) * rng.normal(size=(n, S))).astype(
            np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (bins, nid, stats)]
    _check_hist(args, N, 200, integer)


@pytest.mark.parametrize("n,C,N,active,tiles", [
    (150, 16, 1, 60, ""),           # a small frame's sibling launch
    (150, 28, 4, 30, ""),
    (1_000_003, 28, 8, 50, ""),     # a late level: fewer rows than clusters
    (1_000_003, 28, 33, 1, ""),
    (1_000_003, 28, 8, 0, ""),      # nothing left to add
    (1_000_003, 28, 16, 70, "64,8,4"),  # node tiles of 4
])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_hist_kernel_fewer_active_rows_than_clusters(dev, monkeypatch, n, C,
                                                     N, active, tiles,
                                                     integer):
    """B1 when fewer rows are active than the grid has clusters: the
    partials' scratch comes from torch.empty, so the caching allocator is
    first handed a block of NaNs to give back; a cluster with no rows must
    neither write a partial nor be read by the reduce."""
    monkeypatch.setenv("H2O3_TPU_PALLAS_TILES", tiles)
    rng = np.random.default_rng(n + N + active)
    bins = rng.integers(0, 256, (n, C)).astype(np.uint8)
    nid = np.full(n, -1, np.int32)
    nid[rng.choice(n, active, replace=False)] = rng.integers(0, N, active)
    if integer:
        stats = rng.integers(-3, 4, (n, 3)).astype(np.float32)
    else:
        stats = rng.normal(size=(n, 3)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (bins, nid, stats)]
    torch.full((16 << 20,), float("nan"), device=dev)  # freed at once
    _check_hist(args, N, 256, integer)


@pytest.mark.parametrize("n,N,dead",[(1_000_003, 1, 0.0), (1_000_003, 16, 0.5),
                                      (50_001, 33, 0.1), (77, 5, 0.2)])
def test_compact_kernel_matches_plain(dev, n, N, dead):
    """The compaction kernel: offsets equal the plain version's, and each
    node holds exactly its rows (in any order)."""
    rng = np.random.default_rng(n + N)
    nid = rng.integers(0, N + 1, n).astype(np.int32)
    nid[rng.random(n) < dead] = -1
    t = torch.from_numpy(nid).to(dev)
    before = compact_cuda.launches
    rows, start = compact_cuda(t, N)
    assert compact_cuda.launches == before + 1
    prow, pstart = compact_plain(t, N)
    assert torch.equal(start, pstart)
    for k in range(N):
        a, b = int(pstart[k]), int(pstart[k + 1])
        assert torch.equal(torch.sort(rows[a:b]).values, prow[a:b])


def test_tile_autotuner_real_sweep(dev, tmp_path, monkeypatch):
    """One real 'auto' sweep: its winner is one of the candidates, a second
    resolve adds no sweep, and B1 at the winner is bit-equal to the plain
    version on integer stats."""
    monkeypatch.setattr(hist_tiles, "CACHE_PATH", tmp_path / "tiles.json")
    monkeypatch.setattr(hist_tiles, "_TUNED", {})
    monkeypatch.setenv("H2O3_TPU_PALLAS_TILES", "auto")
    n, C, N = 300_000, 28, 8
    s0 = hist_tiles.tiles_for.sweeps
    win = hist_tiles.tiles_for(n, C, N, 256, 3, dev)
    assert hist_tiles.tiles_for.sweeps == s0 + 1
    (times,) = [v for k, v in hist_tiles.SWEEP_TIMES.items()
                if k[1] == 1 << 19 and k[0][1] == N]
    wave = functools.partial(_wave_clusters, dev, 3)
    assert win in times
    assert win in hist_tiles._sweep_grid(1 << 19, 32, N, 256, 3, wave)
    assert hist_tiles.tiles_for(n, C, N, 256, 3, dev) == win
    assert hist_tiles.tiles_for.sweeps == s0 + 1
    bins, nid, stats = _case(n, C, N, 256, seed=3, integer=True)
    args = [torch.from_numpy(a).to(dev) for a in (bins, nid, stats)]
    _check_hist(args, N, 256, integer=True)


_SPLIT_BINS = [257, 256, 129, 33, 16, 4, 3]


def _split_case(n_nodes, n_bins, seed, C=13, n=50_000):
    """An integer-stat (N, C, B, 3) histogram on the CPU (codes up to 256,
    two duplicated columns: exact ties across columns) and its node
    totals."""
    bins, nid, stats = _case(n, C, n_nodes, n_bins, seed=seed, integer=True,
                             code_dtype=np.int16)
    bins[:, 5] = bins[:, 2]
    stats[:, 2] = np.random.default_rng(1).integers(1, 4, len(stats))
    h = hist_plain(*(torch.from_numpy(a) for a in (bins, nid, stats)),
                   n_nodes, n_bins)
    return h, h[:, 0].sum(dim=1)


def _run_bit_equal(dev, kernel, plain, h, tot, min_rows, *extra):
    """``kernel`` on the card against ``plain`` on the CPU, bit for bit, one
    launch. The outputs come from one torch.empty buffer, so the caching
    allocator is first handed a block of that size full of NaNs: an element
    the kernel left unwritten shows."""
    N, C = h.shape[:2]
    nan_floats = -(-output_layout(N, C)[1] // 4)
    args = [a.to(dev) for a in (h, tot)] + [min_rows] + [a.to(dev)
                                                         for a in extra]
    torch.full((nan_floats,), float("nan"), device=dev)  # freed at once
    before = kernel.launches
    got = kernel(*args)
    assert kernel.launches == before + 1
    for a, b in zip(got, plain(h, tot, min_rows, *extra)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n_bins", _SPLIT_BINS)
def test_split_kernel_bit_equal_on_integer_histograms(dev, n_bins):
    h, tot = _split_case(8, n_bins, seed=n_bins)
    _run_bit_equal(dev, split_candidates_cuda, split_candidates_plain, h, tot,
                   10.0)


_SPLIT_EDGES = {  # (nodes, bins, min_rows)
    "wide_frontier": (2048, 256, 10.0),
    "all_infeasible": (8, 256, 1e9),
    "min_rows_0": (8, 256, 0.0),
}


@pytest.mark.parametrize("mono", [False, True], ids=["b2", "b3"])
@pytest.mark.parametrize("edge", list(_SPLIT_EDGES))
def test_split_kernels_bit_equal_at_edges(dev, edge, mono):
    """B2 and B3 on integer stats with a frontier of 2048 nodes (node_cap),
    with no feasible candidate anywhere (t = 0, gain -1e30, children folded
    at t = 0) and with min_rows 0 (empty children allowed)."""
    N, n_bins, min_rows = _SPLIT_EDGES[edge]
    h, tot = _split_case(N, n_bins, seed=N, n=200_000)
    if not mono:
        _run_bit_equal(dev, split_candidates_cuda, split_candidates_plain, h,
                       tot, min_rows)
    else:
        _run_bit_equal(dev, split_candidates_mono_cuda,
                       split_candidates_mono_plain, h, tot, min_rows,
                       *_mono_inputs(N, 13, seed=N))
    if edge == "all_infeasible":
        g, t, nal, _, _ = split_candidates_plain(h, tot, min_rows)
        assert (g == -1e30).all() and (t == 0).all() and nal.all()


def test_fused_scan_on_card_equals_cpu(dev):
    """The whole per-node decision (kernel candidates + categorical branch
    + column argmax) on the card equals the CPU one on integer data."""
    bins, nid, stats = _case(50_000, 9, 4, 32, seed=7, integer=True)
    bins[:, 3] = bins[:, 3] % 6  # a categorical column
    h = hist_plain(*(torch.from_numpy(a) for a in (bins, nid, stats)), 4, 32)
    is_cat = torch.zeros(9, dtype=torch.bool)
    is_cat[3] = True
    mask = torch.ones(4, 9)
    cpu = fused_split_scan(h, is_cat, mask, 10.0, 0.0, (3,))
    gpu = fused_split_scan(h.to(dev), is_cat.to(dev), mask.to(dev), 10.0, 0.0,
                           (3,))
    for k, v in cpu.items():
        assert torch.equal(gpu[k].cpu(), v), k


def _mono_inputs(N, C, seed):
    rng = np.random.default_rng(seed)
    mono = torch.from_numpy(rng.integers(-1, 2, C).astype(np.int32))
    lo = np.where(rng.random(N) < 0.5, -np.inf,
                  rng.integers(-8, 0, N) / 4).astype(np.float32)
    hi = np.where(rng.random(N) < 0.5, np.inf,
                  rng.integers(1, 8, N) / 4).astype(np.float32)
    return mono, torch.from_numpy(lo), torch.from_numpy(hi)


@pytest.mark.parametrize("n_bins", _SPLIT_BINS)
def test_mono_split_kernel_bit_equal_on_integer_histograms(dev, n_bins):
    h, tot = _split_case(8, n_bins, seed=n_bins)
    _run_bit_equal(dev, split_candidates_mono_cuda,
                   split_candidates_mono_plain, h, tot, 10.0,
                   *_mono_inputs(8, 13, seed=n_bins))


def test_mono_fused_scan_on_card_equals_cpu(dev):
    bins, nid, stats = _case(50_000, 9, 4, 32, seed=7, integer=True)
    stats[:, 2] = np.random.default_rng(2).integers(1, 4, len(stats))
    bins[:, 3] = bins[:, 3] % 6
    h = hist_plain(*(torch.from_numpy(a) for a in (bins, nid, stats)), 4, 32)
    is_cat = torch.zeros(9, dtype=torch.bool)
    is_cat[3] = True
    mask = torch.ones(4, 9)
    mono, lo, hi = _mono_inputs(4, 9, seed=3)
    cpu = fused_split_scan(h, is_cat, mask, 10.0, 0.0, (3,), mono=mono,
                           node_lo=lo, node_hi=hi)
    gpu = fused_split_scan(*(a.to(dev) for a in (h, is_cat, mask)), 10.0, 0.0,
                           (3,), mono=mono.to(dev), node_lo=lo.to(dev),
                           node_hi=hi.to(dev))
    assert {"mid", "mono_col"} <= cpu.keys()
    for k, v in cpu.items():
        assert torch.equal(gpu[k].cpu(), v), k


def test_mono_build_on_card_runs_b3_only(dev):
    """A constrained tree on the card runs B3 at every split level and B2
    never, and records what the CPU build records (integer data)."""
    rng = np.random.default_rng(31)
    n = 20_000
    bins = rng.integers(1, 16, (n, 6)).astype(np.uint8)
    t = (16.0 - bins[:, 0] + rng.integers(-2, 3, n)).astype(np.float32)
    mono = np.array([1, 0, -1, 0, 0, 0], np.int32)
    kw = dict(n_bins=16, is_cat_cols=np.zeros(6, bool), max_depth=5,
              min_rows=1.0, min_split_improvement=0.0, learn_rate=0.1,
              monotone=mono)

    def build(d):
        ones = torch.ones(n, device=d)
        return build_tree(torch.from_numpy(bins).to(d), ones,
                          torch.from_numpy(t).to(d), ones,
                          preds=torch.zeros(n, device=d),
                          varimp=torch.zeros(6, device=d), **kw)

    b2, b3 = split_candidates_cuda.launches, split_candidates_mono_cuda.launches
    gt, gp, _ = build(dev)
    torch.cuda.synchronize()
    assert split_candidates_cuda.launches == b2
    assert split_candidates_mono_cuda.launches - b3 == len(gt.levels) - 1
    ct, cp, _ = build(torch.device("cpu"))
    for a, b in zip(gt.to_host().levels, ct.to_host().levels):
        for f in ("split_col", "split_bin", "na_left", "leaf_now", "leaf_val"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(gp.cpu(), cp)


# ---------------------------------------------------------------------------
# whole-tree build: CUDA graphs against the eager paths

from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.ops import cuda_graph  # noqa: E402
from h2o3_tpu_torch.ops.histogram import histogram  # noqa: E402


def _graph_suite(name):
    """Integer-exact inputs for the whole-tree build: (bins, targets,
    max_depth, min_split_improvement, node_cap). ``sat-*`` cap the frontier
    at 8 nodes so depths 3..8 are a saturated run (head, saturated-level
    and tail graphs); ``sat-dies`` stops splitting inside it."""
    rng = np.random.default_rng(3)
    n = 960
    if name == "duplicated-columns":
        base = rng.integers(1, 16, n).astype(np.uint8)
        return (np.tile(base[:, None], (1, 16)),
                (rng.integers(0, 2, n) * 2 - 1).astype(np.float32), 4, 0.0,
                2048)
    bins = rng.integers(0, 16, (n, 7)).astype(np.uint8)
    t = rng.integers(-3, 4, n).astype(np.float32)
    if name == "integer-targets-na":
        return bins, t, 4, 0.0, 2048
    if name == "sat-alive":
        return bins, t, 7, 0.0, 8
    t = (2.0 * (bins[:, 0] > 8) + (bins[:, 1] > 4)
         - (bins[:, 2] > 10)).astype(np.float32)
    return bins, t, 9, 1e-5, 8  # sat-dies


def _whole(dev, name, mono=None):
    bins, t, depth, msi, cap = _graph_suite(name)
    n, C = bins.shape
    return pst.build_trees_scanned(
        torch.from_numpy(bins).to(dev), torch.ones(n, device=dev),
        torch.from_numpy(t).to(dev), torch.zeros(n, device=dev),
        torch.zeros(C, device=dev), 3,
        grad_fn=lambda F, y, w: (y, torch.ones_like(F)),
        grad_key=("card-test", name), n_bins=16,
        is_cat_cols=np.zeros(C, bool), max_depth=depth, min_rows=1.0,
        min_split_improvement=msi, learn_rates=[0.1, 0.05, 0.025],
        node_cap=cap, monotone=mono)


@pytest.mark.parametrize("mono", [False, True], ids=["b2", "b3"])
@pytest.mark.parametrize("suite", ["duplicated-columns", "integer-targets-na",
                                   "sat-alive", "sat-dies"])
def test_whole_tree_graphs_bit_equal_to_eager(dev, suite, mono):
    """The whole-tree build replayed as CUDA graphs, on integer-exact
    suites, against (1) the same bodies run eagerly on the CPU: every field
    of every tree and level bit-equal (placeholders of skipped saturated
    levels included), and F; (2) the eager per-level loop on the card
    (``build_tree``): the levels it built bit-equal up to the first that
    split nothing; after it, every level of either build all-leaf with zero
    values (the eager loop on the card reads ``n_split`` only at depth 8,
    12, ..., so it runs such levels and records them as computed, where the
    whole-tree build keeps JAX's placeholders in a saturated run); and F.
    varimp is held to 1e-6 relative: the
    card's ``index_add_`` adds the gains of nodes splitting one column with
    float atomics, in any order. The saturated suites run the head /
    saturated-level / tail graphs; ``sat-dies`` replays dead levels that
    must record placeholders."""
    bins, t, depth, msi, cap = _graph_suite(suite)
    n, C = bins.shape
    mv = np.array([1, 0, -1] + [0] * (C - 3), np.int32) if mono else None
    gF, gv, gs = _whole(dev, suite, mv)
    cF, cv, cs = _whole(torch.device("cpu"), suite, mv)
    assert torch.equal(gF.cpu(), cF)
    torch.testing.assert_close(gv.cpu(), cv, rtol=1e-6, atol=0)
    for li, (a, b) in enumerate(zip(gs, cs)):
        for f in a:
            assert torch.equal(a[f].cpu(), b[f]), (li, f)
    F, vi = torch.zeros(n, device=dev), torch.zeros(C, device=dev)
    ones = torch.ones(n, device=dev)
    for k, lr in enumerate([0.1, 0.05, 0.025]):
        tree, F, vi = build_tree(
            torch.from_numpy(bins).to(dev), ones, torch.from_numpy(t).to(dev),
            ones, n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=depth,
            min_rows=1.0, min_split_improvement=msi, learn_rate=lr, preds=F,
            varimp=vi, node_cap=cap, monotone=mv)
        levels = tree.to_host().levels
        dead = next((i for i, lv in enumerate(levels) if lv.leaf_now.all()),
                    len(levels) - 1)
        for li, lv in enumerate(levels[: dead + 1]):
            for f in gs[li]:
                assert np.array_equal(getattr(lv, f),
                                      gs[li][f][k].cpu().numpy()), (k, li, f)
        for lv in levels[dead + 1:]:
            assert lv.leaf_now.all() and not lv.leaf_val.any()
        for rec in gs[dead + 1:]:
            assert rec["leaf_now"][k].all() and not rec["leaf_val"][k].any()
    assert torch.equal(F, gF)
    torch.testing.assert_close(vi, gv, rtol=1e-6, atol=0)


def _train(dev_name, df, **kw):
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    fr = h2o3_tpu_torch.upload_file(df, device=dev_name)
    est = H2OGradientBoostingEstimator(**{
        "ntrees": 6, "max_depth": 5, "min_rows": 10.0, "seed": 42,
        "score_tree_interval": 3, **kw})
    est.train(y="label", training_frame=fr)
    return est


def _float_df(n=30_000, seed=0):
    from h2o3_tpu_torch.datasets import higgs_like

    return higgs_like(n, 12, seed=seed)


def _splits(est, k=0):
    tree = est.model.output["trees"][k][0].to_host()
    return [lv.split_col[~lv.leaf_now & m].tolist()
            for lv, m in zip(tree.levels,
                             est.model.output["trees"][k][0]
                             .real_level_masks())]


def test_graph_gbm_matches_eager_loop_on_float_data(dev, monkeypatch):
    """A GBM by graph replay against the eager per-level loop
    (H2O3_TPU_WHOLE_TREE=0) on the card, float data: training AUC within
    1e-5 (B1's float sums vary in the last bits from run to run) and tree
    0's splits equal."""
    df = _float_df()
    g = _train("cuda", df)
    monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", "0")
    e = _train("cuda", df)
    assert abs(g.auc() - e.auc()) < 1e-5
    assert _splits(g) == _splits(e)
    assert [h["ntrees"] for h in g.scoring_history] == [3, 6]


def test_second_training_captures_nothing_and_counters_count_replays(dev):
    """A second training of one shape reuses the cached graphs, and every
    launch counter moves by what the replays launched on the card (one B1,
    one compaction and one B2 per split level) and nothing else."""
    df = _float_df(20_000, seed=5)
    _train("cuda", df)  # captures (or reuses) this shape's graph
    before = cuda_graph.snapshot()
    caps = pst.GRAPH_EVENTS["captures"]
    est = _train("cuda", df)
    torch.cuda.synchronize()
    assert pst.GRAPH_EVENTS["captures"] == caps
    moved = {k: cuda_graph.snapshot()[k] - v for k, v in before.items()}
    levels = sum(len(g[0].levels) - 1 for g in est.model.output["trees"])
    assert levels == 6 * 5
    assert moved == {"hist_cuda": levels, "compact_cuda": levels,
                     "split_candidates_cuda": levels,
                     "split_candidates_mono_cuda": 0}


def test_capture_raises_instead_of_computing_on_the_host(dev):
    """A CPU tensor reaching a kernel's dispatch during capture raises (the
    graph would replay without it); so does a CUDA wrapper handed a CPU
    tensor. Nothing falls back."""
    bins = torch.zeros(64, 4, dtype=torch.uint8)
    nid = torch.zeros(64, dtype=torch.int32)
    stats = torch.ones(64, 3)
    with pytest.raises(RuntimeError, match="capture"):
        cuda_graph.LaunchGraph(lambda: histogram(bins, nid, stats, 1, 8))
    bins_d = bins.to(dev)
    with pytest.raises(ValueError):
        cuda_graph.LaunchGraph(lambda: hist_cuda(bins_d, nid, stats, 1, 8))
    x = torch.ones(4, device=dev)  # the card still works after both
    assert float(x.sum()) == 4.0


def test_device_metrics_on_card_match_cpu_stats(dev):
    """The device-stats metrics on CUDA tensors against the same function
    on CPU tensors: sums and bucket tables within 1e-5 relative (float32
    sums in another order), nobs exact."""
    from h2o3_tpu_torch.models import metrics as MM

    rng = np.random.default_rng(4)
    n = 200_000
    y = (rng.random(n) < 0.3).astype(np.float32)
    p = np.clip(rng.random(n) * 0.6 + 0.4 * y, 0, 1).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0
    p[rng.random(n) < 0.01] = np.nan
    args = [torch.from_numpy(a) for a in (y, p, w)]
    got = MM._binom_device_stats(*(a.to(dev) for a in args)).cpu().numpy()
    ref = MM._binom_device_stats(*args).numpy()
    assert got[3:4].view(np.int32)[0] == ref[3:4].view(np.int32)[0]
    for a, b in ((got[:3], ref[:3]), (got[4:], ref[4:])):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    m = MM.binomial_metrics(args[0].to(dev), args[1].to(dev),
                            args[2].to(dev))
    assert "gains_lift_table" in m._v  # the device path answered
    assert abs(m.auc - MM.binomial_metrics(y, p, w).auc) < 1e-3


def _cat_df(n, seed):
    """The float frame plus an enum column with NAs whose level leans on
    the label, so categorical splits win."""
    rng = np.random.default_rng(seed)
    df = _float_df(n, seed)
    levels = np.array(["lo", "mid", "hi", "top"])
    lean = (df["label"].to_numpy() == "s") * rng.integers(0, 3, n)
    df["cat"] = np.where(rng.random(n) < 0.07, None,
                         levels[(rng.integers(0, 2, n) + lean) % 4])
    return df


def test_graph_gbm_categorical_validation_stopping_matches_eager(
        dev, monkeypatch):
    """A GBM with a categorical column (its candidates and index inside
    capture), a validation frame (``replay_batch`` over the graph state's
    stacked records) and early stopping on validation AUC, by graph replay
    against the eager loop on the card: the same scoring-history tree
    counts and stop tree count, every history entry and the validation
    AUC and logloss within 1e-5 (B1's float sums vary in the last bits from
    run to run), and in tree 0 the same columns split at each level with a
    gain of 1 or more, the categorical root split among them. Smaller
    gains are left out: this frame has label-pure nodes, where every
    candidate's gain is rounding noise (1e-5 to 1e-1 on the CPU), so the
    last bits decide whether and where such a node splits, and a split
    there renumbers the level below."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    fr = h2o3_tpu_torch.upload_file(_cat_df(30_000, 0), device="cuda")
    fv = h2o3_tpu_torch.upload_file(_cat_df(10_000, 1), device="cuda")
    kw = dict(ntrees=40, max_depth=5, min_rows=10.0, seed=42,
              score_tree_interval=2, stopping_rounds=2,
              stopping_metric="AUC", stopping_tolerance=0.01)
    out = {}
    for path in ("1", "0"):
        monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", path)
        caps = pst.GRAPH_EVENTS["captures"]
        est = H2OGradientBoostingEstimator(**kw)
        est.train(y="label", training_frame=fr, validation_frame=fv)
        if path == "1":  # built by graph replay: this plan was captured
            assert pst.GRAPH_EVENTS["captures"] == caps + 1
            assert pst.GRAPH_EVENTS["last_capture"]["rows"] == 30_000
        out[path] = est
    g, e = out["1"], out["0"]
    hg, he = g.model.scoring_history, e.model.scoring_history
    assert [h["ntrees"] for h in hg] == [h["ntrees"] for h in he]
    assert g.model.output["ntrees_actual"] == \
        e.model.output["ntrees_actual"] < 40
    for a, b in zip(hg, he):
        assert a.keys() == b.keys() == {"ntrees", "training_auc",
                                        "validation_auc"}
        for k in ("training_auc", "validation_auc"):
            assert abs(a[k] - b[k]) < 1e-5, (a, b)
    vg, ve = g.model.validation_metrics, e.model.validation_metrics
    assert abs(vg.auc - ve.auc) < 1e-5 and abs(vg.logloss - ve.logloss) < 1e-5

    def strong(est):
        tree = est.model.output["trees"][0][0]
        return [sorted(lv.split_col[~lv.leaf_now & m & (lv.gain >= 1.0)])
                for lv, m in zip(tree.to_host().levels,
                                 tree.real_level_masks())]

    cat = g.model.output["names"].index("cat")
    assert strong(g) == strong(e) and strong(g)[0] == [cat]


def test_graph_cache_keeps_plans_within_its_byte_budget(dev, monkeypatch):
    """With no room in the cache, a training's graphs, pool and state go
    with it (nothing cached, the next training of the shape captures
    again); at the default share the second training reuses the first's
    capture."""
    df = _float_df(20_000, seed=7)
    monkeypatch.setattr(pst, "_GRAPH_CACHE_SHARE", 0.0)
    caps = pst.GRAPH_EVENTS["captures"]
    for k in (1, 2):
        _train("cuda", df, max_depth=4)
        assert pst.GRAPH_EVENTS["captures"] == caps + k
        assert pst.graph_stats() == []
    last = pst.GRAPH_EVENTS["last_capture"]
    assert last["pool_bytes"] > 0 and last["state_bytes"] > 0
    monkeypatch.undo()
    for _ in range(2):
        _train("cuda", df, max_depth=4)
    assert pst.GRAPH_EVENTS["captures"] == caps + 3
    assert [s["rows"] for s in pst.graph_stats()].count(20_000) == 1


def test_capture_out_of_memory_drops_cached_plans_and_retries(
        dev, monkeypatch):
    """A capture that runs out of memory drops the card's cached plans and
    captures once more; with nothing cached to drop, the error raises."""
    df = _float_df(20_000, seed=8)
    _train("cuda", df)  # at least one cached plan
    real, cached = pst._capture, []

    def flaky(*args):
        cached.append(len(pst._GRAPHS))
        if len(cached) == 1:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return real(*args)

    monkeypatch.setattr(pst, "_capture", flaky)
    _train("cuda", df, max_depth=3)  # a new plan: a miss
    assert cached[0] >= 1 and cached[1:] == [0]

    def never(*args):
        raise torch.cuda.OutOfMemoryError("out of memory")

    pst.free_graphs()
    monkeypatch.setattr(pst, "_capture", never)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        _train("cuda", df, max_depth=2)


# ---------------------------------------------------------------------------
# multinomial on the card: K class trees per iteration, metrics, export


def _strong(tree) -> list:
    """Per level, the sorted columns of the real split nodes with a gain of
    1 or more (smaller gains are rounding noise in label-pure nodes)."""
    host = tree.to_host()
    return [sorted(lv.split_col[~lv.leaf_now & m & (lv.gain >= 1.0)].tolist())
            for lv, m in zip(host.levels, tree.real_level_masks())]


def _int_grad3(F, y, w):
    """Integer-valued (n, 3) targets that depend on F and unit hessians:
    every histogram sum is exact in any order, and a class tree that read
    a column moved earlier in its iteration would see other targets."""
    Y1h = (y[:, None] == torch.arange(3, device=y.device)).to(torch.float32)
    return 4 * Y1h - torch.floor(2 * F), torch.ones_like(F) * w[:, None]


@pytest.mark.parametrize("suite", ["integer-targets-na", "sat-alive"])
def test_multinomial_graphs_bit_equal_to_eager(dev, suite):
    """Three iterations of three class trees replayed as CUDA graphs (the
    iteration head, then the tree graphs at the device class slot; the
    saturated suite through head / saturated-level / tail graphs) against
    the same bodies run eagerly on the CPU, and against the eager control
    on the card (targets of every class from F as the iteration found it,
    then ``build_tree`` per class), on integer-valued targets: every
    record field of every class tree bit-equal up to the level the eager
    loop stopped at, F equal."""
    bins, _, depth, _, cap = _graph_suite(suite)
    n, C = bins.shape
    y = ((bins[:, 0] > 7).astype(int) + (bins[:, 1] > 11)
         + np.arange(n) % 2) % 3
    lrs = [0.5, 0.25, 0.125]
    kw = dict(n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=depth,
              min_rows=1.0, min_split_improvement=0.0, node_cap=cap)

    def whole(d):
        return pst.build_trees_scanned(
            torch.from_numpy(bins).to(d), torch.ones(n, device=d),
            torch.from_numpy(y.astype(np.float32)).to(d),
            torch.zeros(n, 3, device=d), torch.zeros(C, device=d), 3,
            grad_fn=_int_grad3, grad_key=("card-int3", suite),
            learn_rates=lrs, n_classes=3, **kw)

    gF, _, gs = whole(dev)
    cF, _, cs = whole(torch.device("cpu"))
    assert torch.equal(gF.cpu(), cF)
    for li, (a, b) in enumerate(zip(gs, cs)):
        for f in a:
            assert torch.equal(a[f].cpu(), b[f]), (li, f)
    b, w = torch.from_numpy(bins).to(dev), torch.ones(n, device=dev)
    yt = torch.from_numpy(y.astype(np.float32)).to(dev)
    F, vi = torch.zeros(n, 3, device=dev), torch.zeros(C, device=dev)
    for it, lr in enumerate(lrs):
        T, H = _int_grad3(F, yt, w)
        cols = []
        for k in range(3):
            tree, fk, vi = build_tree(b, w, T[:, k], H[:, k], learn_rate=lr,
                                      preds=F[:, k], varimp=vi, **kw)
            cols.append(fk)
            levels = tree.to_host().levels
            dead = next((i for i, lv in enumerate(levels)
                         if lv.leaf_now.all()), len(levels) - 1)
            for li, lv in enumerate(levels[: dead + 1]):
                for f in gs[li]:
                    assert np.array_equal(
                        getattr(lv, f), gs[li][f][3 * it + k].cpu().numpy()
                    ), (it, k, li, f)
        F = torch.stack(cols, dim=1)
    assert torch.equal(F, gF)


# repeated multinomial trainings of one frame on the card land on a few
# distinct loglosses: B1's float sums vary in the last bits from run to run
# and decide near-tie splits (two candidates whose gains agree to 1e-5), the
# eager control as much as the graph path. On the Covertype-shaped headline
# the spread between runs of either path reached 8.45e-5
# (h2o3_tpu_torch/tools/repeat_multinomial.py). Graph against eager is held
# to 2e-4 on float data; the bit-equal test above holds the paths exactly.
MN_PATH_TOL = 2e-4


def test_multinomial_graph_matches_eager_on_card(dev, monkeypatch):
    """A multinomial GBM (a 30,000-row Covertype-shaped frame, 7 classes,
    3 iterations at depth 5) by graph replay against the eager control on
    the card: training logloss within ``MN_PATH_TOL`` and class tree
    (0, 0)'s strong splits equal; a second graph training of the shape
    captures nothing and moves each kernel's counter by iterations x
    classes x depth."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import covtype_like
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    fr = h2o3_tpu_torch.upload_file(covtype_like(30_000, seed=3),
                                    device="cuda")
    kw = dict(ntrees=3, max_depth=5, min_rows=10.0, seed=42,
              score_tree_interval=3)

    def run(mode):
        monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", mode)
        est = H2OGradientBoostingEstimator(**kw)
        est.train(y="cover_type", training_frame=fr)
        torch.cuda.synchronize()
        return est

    g, e = run("1"), run("0")
    assert [len(grp) for grp in g.model.output["trees"]] == [7, 7, 7]
    assert abs(g.logloss() - e.logloss()) < MN_PATH_TOL
    assert _strong(g.model.output["trees"][0][0]) == \
        _strong(e.model.output["trees"][0][0])
    before = cuda_graph.snapshot()
    caps = pst.GRAPH_EVENTS["captures"]
    run("1")
    assert pst.GRAPH_EVENTS["captures"] == caps
    moved = {k: cuda_graph.snapshot()[k] - v for k, v in before.items()}
    assert moved == {"hist_cuda": 105, "compact_cuda": 105,
                     "split_candidates_cuda": 105,
                     "split_candidates_mono_cuda": 0}


def test_multinomial_device_metrics_on_card_match_host(dev):
    """The device-stats multinomial metrics on CUDA tensors against the
    exact host metrics of the same probabilities: logloss within 1e-6, the
    confusion matrix equal (unit weights: every cell is an exact count),
    hit ratios within 1e-6."""
    from h2o3_tpu_torch.models import metrics as MM

    rng = np.random.default_rng(6)
    n, K = 300_000, 7
    y = rng.integers(0, K, n)
    z = rng.normal(size=(n, K)) + 2.0 * (y[:, None] == np.arange(K))
    P = (np.exp(z) / np.exp(z).sum(1, keepdims=True)).astype(np.float32)
    dm = MM.multinomial_metrics(torch.from_numpy(y).to(dev),
                                torch.from_numpy(P).to(dev))
    hm = MM.multinomial_metrics(y, P)
    assert dm.nobs == hm.nobs == n
    assert abs(dm.logloss - hm.logloss) <= 1e-6
    np.testing.assert_array_equal(dm.confusion_matrix, hm.confusion_matrix)
    np.testing.assert_allclose(dm.hit_ratios, hm.hit_ratios, atol=1e-6)


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_export_round_trip_on_card(dev, tmp_path, kind):
    """A GBM trained on the card, exported with ``download_mojo`` and
    scored by the port's offline scorer: probabilities within 1e-5 of the
    model's ``predict`` on the card; labels equal wherever the scorer's
    probabilities are more than 1e-5 from the decision (the max-F1
    threshold, or a tie between the two likeliest classes), since the
    scorer adds leaves in float64 and the card in float32."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch import genmodel
    from h2o3_tpu_torch.datasets import covtype_like
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    if kind == "binomial":
        df, y, classes = _float_df(20_000, seed=9), "label", ("b", "s")
    else:
        df, y = covtype_like(20_000, seed=9), "cover_type"
        classes = tuple(str(k) for k in range(1, 8))
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    est = H2OGradientBoostingEstimator(ntrees=4, max_depth=5, seed=42)
    est.train(y=y, training_frame=fr)
    path = est.download_mojo(str(tmp_path))
    scored = genmodel.MojoModel.load(path).predict(df.drop(columns=y))
    pred = est.predict(fr)
    want = np.stack([pred.vec(c).data.double().cpu().numpy()
                     for c in classes], 1)
    got = np.stack([scored[c] for c in classes], 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    labels = pred.vec("predict").data.long().cpu().numpy()
    if kind == "binomial":
        thr = est.model.training_metrics.default_threshold
        margin = np.abs(got[:, 1] - thr)
    else:
        top2 = np.sort(got, axis=1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
    same = scored["predict"] == np.asarray(classes, object)[labels]
    assert same[margin > 1e-5].all() and same.mean() > 0.999


# ---------------------------------------------------------------------------
# keyed row and column sampling, and DRF, on the card


def test_keyed_masks_on_card_equal_cpu(dev):
    """The keyed draws on the card, from device scalars as a replayed graph
    reads them, equal the CPU's from Python ints, bit for bit: the row
    bootstrap at 1M rows, and the per-tree and per-split columns at 2048
    nodes x 28 columns."""
    from h2o3_tpu_torch.models.tree import sampling

    def on(v, dtype=torch.int64):
        return torch.tensor([v], dtype=dtype, device=dev)

    key = sampling.seed_key(42)
    rows_c = sampling.index_hash(1_000_003, "cpu")
    rows_g = sampling.index_hash(1_000_003, dev)
    assert torch.equal(rows_g.cpu(), rows_c)
    cols_c = sampling.index_hash(2048 * 28, "cpu")
    cols_g = sampling.index_hash(2048 * 28, dev)
    for it, k, depth in ((0, 0, 0), (7, 3, 11), (49, 6, 19)):
        got = sampling.row_mask(on(key), on(it), on(0.632, torch.float32),
                                rows_g)
        assert torch.equal(got.cpu(), sampling.row_mask(key, it, 0.632,
                                                        rows_c))
        tk = sampling.split_key(on(key), on(it), on(k))
        assert int(tk) == sampling.split_key(key, it, k)
        got = sampling.split_cols(tk, on(depth), on(5 / 28, torch.float32),
                                  2048, 28, cols_g)
        want = sampling.split_cols(sampling.split_key(key, it, k), depth,
                                   5 / 28, 2048, 28, cols_c)
        assert torch.equal(got.cpu(), want)
        got = sampling.tree_cols(on(key), on(it), on(k),
                                 on(0.5, torch.float32), 28, cols_g)
        assert torch.equal(got.cpu(), sampling.tree_cols(key, it, k, 0.5, 28,
                                                         cols_c))


def _drf_grad(F, y, w):
    return y, w  # leaf = the node's mean target


def _sampled_whole(d, rates, suite="sat-alive", seed=13):
    """Three DRF-style trees with keyed draws at ``rates`` (rows, per
    split, per tree) on an integer-exact suite."""
    bins, t, depth, _, cap = _graph_suite(suite)
    n, C = bins.shape
    return pst.build_trees_scanned(
        torch.from_numpy(bins).to(d), torch.ones(n, device=d),
        torch.from_numpy(t).to(d), torch.zeros(n, device=d),
        torch.zeros(C, device=d), 3, grad_fn=_drf_grad,
        grad_key=("card-sampled", suite), n_bins=16,
        is_cat_cols=np.zeros(C, bool), max_depth=depth, min_rows=1.0,
        min_split_improvement=0.0, learn_rates=[1.0, 0.5, 0.25],
        node_cap=cap, seed=seed, sample_rate=rates[0],
        col_sample_rate=rates[1], col_sample_rate_per_tree=rates[2])


@pytest.mark.parametrize("suite", ["integer-targets-na", "sat-alive"])
def test_sampled_graphs_equal_cpu_and_each_replay_draws_anew(dev, suite):
    """Three sampled trees replayed as CUDA graphs (the saturated suite
    through head / saturated-level / tail graphs) against the same bodies
    run on the CPU: every record field and F bit-equal (the card draws the
    CPU's masks); and each replay drew its own bootstrap: the roots cover
    three different row sets, each the keyed mask of its iteration."""
    from h2o3_tpu_torch.models.tree import sampling

    rates = (0.632, 0.5, 0.8)
    gF, _, gs = _sampled_whole(dev, rates, suite)
    cF, _, cs = _sampled_whole(torch.device("cpu"), rates, suite)
    assert torch.equal(gF.cpu(), cF)
    for li, (a, b) in enumerate(zip(gs, cs)):
        for f in a:
            assert torch.equal(a[f].cpu(), b[f]), (li, f)
    n = gF.shape[0]
    h = sampling.index_hash(n, "cpu")
    want = [float(sampling.row_mask(sampling.seed_key(13), m, 0.632,
                                    h).sum()) for m in range(3)]
    covers = gs[0]["node_w"][:, 0].cpu().tolist()
    assert covers == want and len(set(covers)) == 3


def test_sampled_gbm_graphs_bit_equal_to_eager_on_card(dev):
    """GBM's three draws at 0.8 on integer-valued targets (every
    histogram sum exact), saturated suite: the graph replays and the eager
    per-level loop on the card record the same trees up to the level that
    split nothing (all-leaf and zero-valued after it), and F equal."""
    from h2o3_tpu_torch.models.tree.sampling import Sampling

    rates = (0.8, 0.8, 0.8)
    gF, _, gs = _sampled_whole(dev, rates, "sat-alive", seed=5)
    bins, t, depth, _, cap = _graph_suite("sat-alive")
    n, C = bins.shape
    smp = Sampling(5, *rates)
    b, yt = torch.from_numpy(bins).to(dev), torch.from_numpy(t).to(dev)
    F, vi = torch.zeros(n, device=dev), torch.zeros(C, device=dev)
    for it, lr in enumerate([1.0, 0.5, 0.25]):
        w = smp.rows(it, torch.ones(n, device=dev))
        tree, F, vi = build_tree(
            b, w, yt, w, n_bins=16, is_cat_cols=np.zeros(C, bool),
            max_depth=depth, min_rows=1.0, min_split_improvement=0.0,
            learn_rate=lr, preds=F, varimp=vi, node_cap=cap, sample=smp,
            iteration=it)
        levels = tree.to_host().levels
        dead = next((i for i, lv in enumerate(levels) if lv.leaf_now.all()),
                    len(levels) - 1)
        for li, lv in enumerate(levels[: dead + 1]):
            for f in gs[li]:
                assert np.array_equal(getattr(lv, f),
                                      gs[li][f][it].cpu().numpy()), (it, li, f)
        for rec in gs[dead + 1:]:
            assert rec["leaf_now"][it].all() and not rec["leaf_val"][it].any()
    assert torch.equal(F, gF)


def _forests_equal(a, b) -> bool:
    """Every replay field of every class tree equal up to its first level
    that split nothing, every later level of either all-leaf and
    zero-valued."""
    for ga, gb in zip(a.model.output["trees"], b.model.output["trees"]):
        for ta, tb in zip(ga, gb):
            la, lb = ta.to_host().levels, tb.to_host().levels
            dead = next((i for i, lv in enumerate(la) if lv.leaf_now.all()),
                        len(la) - 1)
            if len(lb) <= dead or not all(
                    np.array_equal(getattr(x, f), getattr(z, f))
                    for x, z in zip(la[: dead + 1], lb)
                    for f in pst.REPLAY_FIELDS):
                return False
            if not all(lv.leaf_now.all() and not lv.leaf_val.any()
                       for lv in la[dead + 1:] + lb[dead + 1:]):
                return False
    return len(a.model.output["trees"]) == len(b.model.output["trees"])


def test_binomial_drf_graph_equals_eager_on_card(dev, monkeypatch):
    """Binomial DRF at its defaults (depth 20, min_rows 1, bootstrap 0.632,
    mtries √C) on 30,000 rows with unit weights: 0/1 targets and 0/1
    weights make B1's sums exact, so the graph replays (saturated levels at
    2048 nodes included: the saturated-level graph replays) and the eager
    loop grow the same forest, split for split, and the same AUC."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator

    df = _float_df(n=30_000, seed=4)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", mode)
        est = H2ORandomForestEstimator(ntrees=4, seed=3)
        est.train(y="label", training_frame=fr)
        out[mode] = est
    assert _forests_equal(out["1"], out["0"])
    assert out["1"].auc() == out["0"].auc()
    (plan,) = [s for s in pst.graph_stats()
               if (s["rows"], s["depth"]) == (30_000, 20)]
    sat = plan["graph_names"].index("saturated_level")
    assert plan["replays"][sat] > 0 and plan["draws"]["rows"]


# -- GLM (slice 8): the Gram, the rung test, ADMM graph against eager, card
# against CPU. Tolerances: the Gram within 1e-5 relative (Frobenius) of a
# float64 Gram of the same float32 inputs (full float32, TF32 off); the
# Cholesky rungs taken exactly as on the CPU; ADMM by graph replay equal to
# the eager steps to the bit (the same kernels in the same order); whole
# GLMs card against CPU: coefficients within 1e-4, iteration counts equal.


def test_glm_gram_full_float32_against_float64(dev):
    from h2o3_tpu_torch.ops.gram import weighted_gram

    torch.set_float32_matmul_precision("high")  # TF32: the module overrides
    try:
        g = torch.Generator(device="cpu").manual_seed(0)
        X = torch.randn(300_000, 96, generator=g).to(dev)
        w = torch.rand(300_000, generator=g).to(dev)
        z = torch.randn(300_000, generator=g).to(dev)
        G, b, _ = weighted_gram(X, w, z)
        assert torch.backends.cuda.matmul.fp32_precision == "tf32"  # restored
    finally:
        torch.set_float32_matmul_precision("highest")
    X64 = X.double()
    G64 = (X64 * w.double()[:, None]).T @ X64
    b64 = (X64 * w.double()[:, None]).T @ z.double()
    assert float(torch.linalg.norm(G.double() - G64)
                 / torch.linalg.norm(G64)) <= 1e-5
    assert float(torch.linalg.norm(b.double() - b64)
                 / torch.linalg.norm(b64)) <= 1e-5


@pytest.mark.parametrize("case", ["spd", "singular", "late_rung"])
def test_glm_cholesky_rungs_on_card_match_cpu(dev, case):
    """``cholesky_ex``'s ``info`` decides the rung as on the CPU: an SPD
    Gram takes rung 0; two equal ±1 columns give an exact zero pivot at
    every rung (ok False, x zero); diag(0, 1) fails bare and is taken at
    the 1e-10 rung, where x = (1, 1) to float32 rounding."""
    from h2o3_tpu_torch.ops.gram import cho_solve_jitter_device

    rng = np.random.default_rng(1)
    if case == "late_rung":
        G = np.diag([0.0, 1.0]).astype(np.float32)
        b = np.array([1e-10, 1.0], np.float32)
    else:
        X = rng.normal(size=(400, 6)).astype(np.float32)
        w = np.full(400, 0.25, np.float32)
        if case == "singular":
            X[:, 0] = np.where(rng.random(400) < 0.5, -1.0, 1.0)
            X[:, 1] = X[:, 0]
        G = (X * w[:, None]).T @ X
        b = (X * w[:, None]).T @ rng.normal(size=400).astype(np.float32)
    xc, okc = cho_solve_jitter_device(torch.from_numpy(G), torch.from_numpy(b))
    xg, okg = cho_solve_jitter_device(torch.from_numpy(G).to(dev),
                                      torch.from_numpy(b).to(dev))
    assert bool(okg) == bool(okc) == (case != "singular")
    if case == "late_rung":
        np.testing.assert_allclose(xg.cpu().numpy(), [1.0, 1.0], rtol=1e-6)
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), rtol=1e-5,
                               atol=1e-5 * max(1.0, float(xc.abs().max())))


def test_glm_admm_graph_bit_equal_to_eager(dev):
    from h2o3_tpu_torch.ops.gram import AdmmSolver

    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.normal(size=(5000, 40)).astype(np.float32)).to(dev)
    X[:, -1] = 1.0
    X[:, -3:-1] = 0.0  # two padded (all-zero) columns
    G = X.T @ X
    b = X.T @ torch.from_numpy(rng.normal(size=5000).astype(np.float32)).to(dev)
    pad = torch.zeros(40, device=dev)
    pad[-3:-1] = 1.0  # two padded columns
    l1, l2 = torch.tensor(50.0, device=dev), torch.tensor(20.0, device=dev)
    out = {}
    for use_graph in (False, True):
        s = AdmmSolver(40, dev, use_graph=use_graph)
        out[use_graph], blocks = [], 0
        for _ in range(2):  # the graph: capture, then replay
            out[use_graph].append(s.solve(G, b, l1, l2, 39, pad, 38))
            blocks += -(-int(s.i) // s.block)
        assert s.reads == blocks  # one host read per block of steps
    for (ze, oke), (zg, okg) in zip(out[False], out[True]):
        assert bool(oke) and bool(okg)
        assert torch.equal(ze, zg)
        assert float(zg[-3:-1].abs().max()) == 0.0  # padded columns stay 0


@pytest.mark.parametrize("frame", ["higgs", "airlines"])
def test_glm_card_against_cpu_10k(dev, frame):
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import airlines_like, higgs_like
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    df, y = ((higgs_like(10_000, seed=2), "label") if frame == "higgs"
             else (airlines_like(10_000, seed=2), "IsDepDelayed"))
    kw = dict(family="binomial", lambda_=1e-4, max_iterations=20)
    models = {}
    for d in ("cuda", "cpu"):
        est = H2OGeneralizedLinearEstimator(**kw)
        est.train(y=y, training_frame=h2o3_tpu_torch.upload_file(df, device=d))
        models[d] = est.model
    g, c = models["cuda"], models["cpu"]
    assert g.output["irls_stats"]["fallbacks"] == 0
    assert [e["iters"] for e in g.regularization_path] == \
        [e["iters"] for e in c.regularization_path]
    assert max(abs(g.coef[k] - c.coef[k]) for k in c.coef) <= 1e-4


# -- GLM (slice 9): multinomial, ordinal, interactions and hashed columns,
# card against CPU. Tolerances: multinomial Beta within 1e-4 and iteration
# counts equal (float32 lanes on both sides of a convergent fit); ordinal
# beta and cuts within 2e-3 (JAX's bound between its two ordinal lanes) on
# the 1M-row headline, where BFGS stops early at the same place on both
# devices; the hashed Airlines shape as the single-response GLMs above.


def _card_and_cpu(df, y, **kw):
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    models = {}
    for d in ("cuda", "cpu"):
        est = H2OGeneralizedLinearEstimator(**kw)
        est.train(y=y, training_frame=h2o3_tpu_torch.upload_file(df, device=d))
        models[d] = est.model
    return models["cuda"], models["cpu"]


@pytest.mark.parametrize("lam", [None, 1e-4], ids=["cholesky", "admm"])
def test_glm_multinomial_card_against_cpu_10k(dev, lam):
    from h2o3_tpu_torch.datasets import ordinal_like

    g, c = _card_and_cpu(ordinal_like(10_000, seed=2), "rating",
                         family="multinomial", lambda_=lam)
    gs, cs = g.output["irls_stats"], c.output["irls_stats"]
    assert gs["fallbacks"] == 0 and gs["iterations"] == cs["iterations"]
    np.testing.assert_allclose(g.output["beta_multinomial_std"],
                               c.output["beta_multinomial_std"], atol=1e-4)


def test_glm_ordinal_bfgs_headline_stop(dev):
    """The ordinal headline (1M rows x 28, standardize off): BFGS ends by
    a failed line search, as JAX's does on this frame (its zoom's bracket
    reaches the absolute 1e-5 floor while the NLL's gradient is ~1e6
    wide), with a finite optimum, no fallback and at most one host read
    per iteration; the CPU's fit of the same frame stops at the same place
    (beta and cuts within 2e-3)."""
    from h2o3_tpu_torch.datasets import ordinal_like

    g, c = _card_and_cpu(ordinal_like(1_000_000), "rating",
                         family="ordinal", standardize=False)
    st = g.output["irls_stats"]
    assert st["fallbacks"] == 0 and np.isfinite(g.residual_deviance)
    assert st["bfgs"]["stop"] == "line_search"
    assert st["bfgs"]["reads"] <= st["iterations"]
    for k in ("beta_std", "theta"):
        np.testing.assert_allclose(g.output[k], c.output[k], atol=2e-3)


def test_glm_hashed_interactions_card_against_cpu_10k(dev):
    from h2o3_tpu_torch.datasets import airlines_like

    g, c = _card_and_cpu(
        airlines_like(10_000, seed=2), "IsDepDelayed", family="binomial",
        lambda_=1e-4, hash_buckets=64,
        interaction_pairs=[("UniqueCarrier", "Distance"),
                           ("CRSDepTime", "Distance")])
    assert g.output["irls_stats"]["fallbacks"] == 0
    assert [e["iters"] for e in g.regularization_path] == \
        [e["iters"] for e in c.regularization_path]
    assert max(abs(g.coef[k] - c.coef[k]) for k in c.coef) <= 1e-4


# -- slice 11: cross-validation and XGBoost on the card. The fold weights
# and XGBoost's lambda and alpha are loaded state of the cached graphs, so
# neither adds a capture.


def _cv_est(cls, fr, y="label", **kw):
    est = cls(**kw)
    est.train(y=y, training_frame=fr)
    torch.cuda.synchronize()
    return est


def test_cv_folds_capture_nothing_and_holdout_is_the_fold_models(dev):
    """GBM with nfolds=3 on the card: the main model and its fold models
    share one plan (the fold weights are loaded, not captured), so the CV
    captures once, for the main model of a new shape, and a repeated CV
    not at all; the holdout is each fold model's own prediction on its
    fold's rows, bit for bit."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.models import model_base as pmb

    fr = h2o3_tpu_torch.upload_file(_float_df(20_000, seed=7), device="cuda")
    kw = dict(ntrees=6, max_depth=5, min_rows=10.0, seed=42,
              score_tree_interval=3, nfolds=3,
              keep_cross_validation_predictions=True)
    pst.free_graphs()
    caps = pst.GRAPH_EVENTS["captures"]
    est = _cv_est(H2OGradientBoostingEstimator, fr, **kw)
    assert pst.GRAPH_EVENTS["captures"] == caps + 1
    _cv_est(H2OGradientBoostingEstimator, fr, **kw)
    assert pst.GRAPH_EVENTS["captures"] == caps + 1
    fold, folds = pmb.fold_ids(est.model.params, fr)
    hold = est.cv_predictions
    assert hold.device.type == "cuda"
    for f, m in zip(folds, est.cv_models):
        te = torch.from_numpy(fold == f).cuda()
        assert torch.equal(hold[te], m._predict_raw(fr)[te])
    assert 0.5 < est.auc(xval=True) < est.auc()


def test_glm_cv_folds_reuse_the_admm_graph(dev):
    """GLM with ADMM and nfolds=3: the folds solve on the cached solver of
    the training's width, whose block graph was captured by the main
    model; a repeated CV captures nothing."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
    from h2o3_tpu_torch.ops import gram

    fr = h2o3_tpu_torch.upload_file(_float_df(20_000, seed=8), device="cuda")
    kw = dict(family="binomial", lambda_=1e-4, nfolds=3)
    _cv_est(H2OGeneralizedLinearEstimator, fr, **kw)
    caps = gram.ADMM_EVENTS["captures"]
    est = _cv_est(H2OGeneralizedLinearEstimator, fr, **kw)
    assert gram.ADMM_EVENTS["captures"] == caps
    assert all(m.output["irls_stats"]["fallbacks"] == 0
               for m in [est.model] + est.cv_models)


def test_xgboost_lambda_alpha_are_loaded_state(dev):
    """Two XGBoost trainings of one shape with different lambda and alpha
    replay one captured plan, and each equals its CPU training in AUC
    (within 1e-4) and tree 0's splits."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator

    df = _float_df(20_000, seed=9)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    cpu = h2o3_tpu_torch.upload_file(df, device="cpu")
    kw = dict(ntrees=4, max_depth=4, seed=3, score_tree_interval=2)
    pst.free_graphs()
    caps = pst.GRAPH_EVENTS["captures"]
    runs = []
    for reg in (dict(reg_lambda=1.0), dict(reg_lambda=20.0, reg_alpha=0.5)):
        g = _cv_est(H2OXGBoostEstimator, fr, **kw, **reg)
        c = _cv_est(H2OXGBoostEstimator, cpu, **kw, **reg)
        assert abs(g.auc() - c.auc()) < 1e-4
        assert _splits(g) == _splits(c)
        runs.append(g)
    assert pst.GRAPH_EVENTS["captures"] == caps + 1
    p0, p1 = (r.model._predict_raw(fr)[:, 1] for r in runs)
    assert not torch.equal(p0, p1)


def _dl_frame(dev, n=3000, d=20):
    from h2o3_tpu_torch.datasets import mnist_like

    return mnist_like(n, d=d, k=4, seed=2, device=dev)


def _dl_train(fr, **kw):
    from h2o3_tpu_torch.estimators import H2ODeepLearningEstimator

    est = H2ODeepLearningEstimator(**{**dict(
        hidden=(32, 32), epochs=2, mini_batch_size=64, seed=3), **kw})
    est.train(x=fr.names[:-1], y="label", training_frame=fr)
    return est.model


def test_dl_graphs_bit_equal_to_eager_and_warm_captures_nothing(
        dev, monkeypatch):
    """A DeepLearning training by CUDA-graph replay (46 steps an epoch: two
    blocks of 16 and a tail of 14) ends bit-equal to the eager step loop
    with dropout off, and a second training of the shape (another l2)
    replays the cached graphs without a capture."""
    from h2o3_tpu_torch.models import deeplearning as pdl

    pdl.free_graphs()
    fr = _dl_frame(dev)
    caps = pdl.SGD_EVENTS["captures"]
    g = _dl_train(fr)
    st = g.output["sgd_stats"]
    assert st["mode"] == "graph" and st["captures"] == 1
    assert st["nbatch"] == 46 and st["replays"] == 2 * 3
    monkeypatch.setattr(pdl, "STEP_MODE", "eager")
    e = _dl_train(fr)
    for a, b in zip(g.output["net"].tensors(), e.output["net"].tensors()):
        assert torch.equal(a, b)
    assert g.scoring_history == e.scoring_history
    monkeypatch.setattr(pdl, "STEP_MODE", "auto")
    w = _dl_train(fr, l2=1e-4)
    assert w.output["sgd_stats"]["captures"] == 0
    assert pdl.SGD_EVENTS["captures"] == caps + 1


def test_dl_dropout_graphs_equal_eager_on_card(dev, monkeypatch):
    """With input and hidden dropout the graph draws the eager loop's
    masks: the same weights within 1e-6 (the masked rows make the same
    floats; only cuBLAS's choices could differ)."""
    from h2o3_tpu_torch.models import deeplearning as pdl

    fr = _dl_frame(dev)
    kw = dict(input_dropout_ratio=0.1, hidden_dropout_ratios=(0.3, 0.2),
              activation="RectifierWithDropout")
    g = _dl_train(fr, **kw)
    monkeypatch.setattr(pdl, "STEP_MODE", "eager")
    e = _dl_train(fr, **kw)
    for a, b in zip(g.output["net"].tensors(), e.output["net"].tensors()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["ce", "autoencoder"])
def test_dl_card_against_cpu(dev, kind):
    """The same frame and initial weights on the card and the CPU: final
    weights within 1e-4 of the largest (float32 steps; cuBLAS and the
    CPU's BLAS sum in other orders, over 2 epochs of 46 steps), epoch
    losses within 1e-5 relative."""
    from h2o3_tpu_torch.estimators import H2OAutoEncoderEstimator
    from h2o3_tpu_torch.frame.frame import Frame, Vec

    fr = _dl_frame(dev)
    cpu = Frame([Vec(v.data.cpu(), v.kind, domain=v.domain)
                 for v in (fr.vec(n) for n in fr.names)], fr.names)
    if kind == "ce":
        a, b = _dl_train(fr), _dl_train(cpu)
    else:
        ms = []
        for f in (fr, cpu):
            est = H2OAutoEncoderEstimator(hidden=(8,), epochs=2, seed=3,
                                          mini_batch_size=64)
            est.train(x=f.names[:-1], training_frame=f)
            ms.append(est.model)
        a, b = ms
    for x, y in zip(a.output["net"].tensors(), b.output["net"].tensors()):
        y = y.to(dev)
        torch.testing.assert_close(x, y, rtol=0, atol=1e-4 * float(
            y.abs().max()))
    np.testing.assert_allclose([h["loss"] for h in a.scoring_history],
                               [h["loss"] for h in b.scoring_history],
                               rtol=1e-5)


def _automl_frame(dev, n=8_000):
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like

    return h2o3_tpu_torch.upload_file(higgs_like(n, 8, seed=4), device=dev)


def test_automl_warm_run_captures_nothing(dev):
    """A second AutoML of the same configuration on the card replays the
    first one's graphs: no whole-tree, ADMM or DeepLearning capture in any
    step, and the same leaderboard."""
    from h2o3_tpu_torch.automl import AutoML

    fr = _automl_frame(dev)
    kw = dict(max_models=3, nfolds=2, seed=3, include_algos=["GBM", "GLM"])
    runs = [AutoML(**kw) for _ in range(2)]
    for aml in runs:
        aml.train(y="label", training_frame=fr)
    caps = [sum(r["counters"][k] for r in aml.step_log
                for k in ("tree_graphs", "admm_blocks", "dl_plans"))
            for aml in runs]
    assert caps[0] > 0 and caps[1] == 0
    assert [len(a.leaderboard.models) for a in runs] == [3, 3]
    assert all(r["counters"]["hist_cuda"] > 0 for r in runs[1].step_log
               if r["algo"] == "gbm" and r["models"])


def _stacked(dev):
    from h2o3_tpu_torch.models.ensemble import StackedEnsemble
    from h2o3_tpu_torch.models.glm import GLM
    from h2o3_tpu_torch.models.tree.gbm import GBM

    fr = _automl_frame(dev)
    cv = dict(nfolds=3, keep_cross_validation_predictions=True, seed=5)
    base = [GBM(ntrees=10, max_depth=4, **cv).train(y="label",
                                                    training_frame=fr),
            GLM(family="binomial", **cv).train(y="label", training_frame=fr)]
    se = StackedEnsemble(base_models=base, seed=5).train(y="label",
                                                         training_frame=fr)
    return fr, base, se


def test_level_one_matrix_stays_on_the_card(dev):
    """The level-one CV matrix, the metalearner's holdout predictions and
    the ensemble's predictions are tensors on the card."""
    from h2o3_tpu_torch.models import ensemble as E

    fr, base, se = _stacked(dev)
    L = E._level_one_cv_matrix(base)
    assert L.device.type == "cuda" and L.shape == (fr.nrow, 2)
    assert se.metalearner.cv_predictions.device.type == "cuda"
    raw = se._predict_raw(fr)
    assert raw.device.type == "cuda" and raw.shape == (fr.nrow, 2)
    assert bool(((raw >= 0) & (raw <= 1)).all())


def test_metalearner_card_against_cpu(dev):
    """The ensemble's level-one matrix, response and weights copied to the
    CPU, the metalearner fit there with the same parameters: coefficients
    within 1e-4, deviance within 1e-5 relative (the GLM's card-against-CPU
    bounds)."""
    from h2o3_tpu_torch.models import ensemble as E

    fr, base, se = _stacked(dev)
    L = E._level_one_cv_matrix(base)
    y, w = base[0]._response_and_weights(fr)
    b = E.StackedEnsemble(base_models=base, seed=5)
    b._meta_weights = w is not None
    cpu = b._make_metalearner(True, 2).train(
        y="y", training_frame=E._matrix_frame(
            L.cpu(), y.cpu(), base[0].output["response_domain"]))
    card = se.metalearner
    for k, v in card.coef.items():
        assert abs(float(v) - float(cpu.coef[k])) <= 1e-4, k
    assert float(card.residual_deviance) == pytest.approx(
        float(cpu.residual_deviance), rel=1e-5)


def test_model_saved_on_card_loads_on_cpu(dev, tmp_path):
    """A GBM and a DeepLearning model trained on the card, saved, and
    loaded on the CPU: every tensor there, predictions within 1e-6 of the
    card's on the same rows; loaded back on the card, equal."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import (
        H2ODeepLearningEstimator,
        H2OGradientBoostingEstimator,
    )

    df = _float_df(20_000, seed=11)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    cf = h2o3_tpu_torch.upload_file(df, device="cpu")
    for cls, kw in ((H2OGradientBoostingEstimator, dict(ntrees=5,
                                                        max_depth=4)),
                    (H2ODeepLearningEstimator, dict(hidden=(8,),
                                                    epochs=1.0))):
        est = cls(seed=3, **kw)
        est.train(y="label", training_frame=fr)
        card = est.model._predict_raw(fr)
        path = h2o3_tpu_torch.save_model(est.model, str(tmp_path) + "/")
        cpu = h2o3_tpu_torch.load_model(path, device="cpu")
        got = cpu._predict_raw(cf)
        assert got.device.type == "cpu"
        assert float((got.double() - card.double().cpu()).abs().max()) <= 1e-6
        again = h2o3_tpu_torch.load_model(path)
        assert torch.equal(again._predict_raw(fr), card)


def test_resumed_gbm_of_a_cached_shape_captures_nothing(dev):
    """A GBM resumed with ``checkpoint=`` on a shape whose plan is cached
    captures no graph (F and varimp are loaded state), launches B1 once a
    level of each new tree inside replays, and ends within 1e-5 of the
    uninterrupted training's AUC."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.ops import cuda_graph

    fr = h2o3_tpu_torch.upload_file(_float_df(20_000, seed=12),
                                    device="cuda")
    kw = dict(max_depth=5, min_rows=10.0, seed=42, score_tree_interval=3)

    def train(**more):
        est = H2OGradientBoostingEstimator(**kw, **more)
        est.train(y="label", training_frame=fr)
        return est

    full = train(ntrees=9)
    part = train(ntrees=3)
    caps = pst.GRAPH_EVENTS["captures"]
    for f in cuda_graph.counters():
        f.launches = 0
    res = train(ntrees=9, checkpoint=part.model.key)
    torch.cuda.synchronize()
    assert pst.GRAPH_EVENTS["captures"] == caps
    assert cuda_graph.snapshot()["hist_cuda"] == 6 * kw["max_depth"]
    assert abs(res.auc() - full.auc()) <= 1e-5


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_hist_accumulate_form_matches_plain(dev, integer):
    """B1's accumulate form (``out=acc``, the streamed build's launch per
    row block) adds into a non-zero histogram: bit-equal to
    ``hist_plain(..., out=acc)`` on integer stats, within 1e-5 of cell
    mass of a float64 sum on float stats; ``out`` is the tensor
    returned."""
    bins, nid, stats = _case(100_003, 28, 8, 256, seed=31, integer=integer)
    _, _, other = _case(100_003, 28, 8, 256, seed=32, integer=integer)
    b, n_, st, ot = [torch.from_numpy(a).to(dev)
                     for a in (bins, nid, stats, other)]
    acc = hist_plain(b, n_, ot, 8, 256)
    out = acc.clone()
    got = hist_cuda(b, n_, st, 8, 256, out=out)
    assert got.data_ptr() == out.data_ptr()
    if integer:
        assert torch.equal(got, hist_plain(b, n_, st, 8, 256,
                                           out=acc.clone()))
    else:
        ref64 = acc.double() + hist_plain(b, n_, st.double(), 8, 256)
        mass = acc.double().abs() + hist_plain(b, n_, st.double().abs(), 8,
                                               256)
        err = ((got.double() - ref64).abs() / mass.clamp(min=1.0)).max()
        assert err.item() < 1e-5


def test_streamed_gbm_on_card_matches_resident(dev, monkeypatch):
    """A GBM through a window that cuts its lanes into 6 blocks on the
    card: B1 launched once per block and level, every split equal to the
    resident graph build's but for float near-ties, predictions within
    1e-5 where no tree parted, the store's peak within the window and the
    features released."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.frame import chunkstore as cs
    from h2o3_tpu_torch.tools.tree_parity import divergences

    df = _float_df(30_000, seed=13)
    kw = dict(ntrees=4, max_depth=4, min_rows=10.0, seed=42,
              score_tree_interval=2)

    def train():
        fr = h2o3_tpu_torch.upload_file(df, device="cuda")
        est = H2OGradientBoostingEstimator(**kw)
        est.train(y="label", training_frame=fr)
        return est, fr

    res, _ = train()
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(30_000 * 40 // 3))
    for f in cuda_graph.counters():
        f.launches = 0
    est, fr = train()
    torch.cuda.synchronize()
    st = cs.LAST_STORE_STATS
    assert st["n_blocks"] >= 4 and st["peak_hbm"] <= st["window"]
    levels = sum(len(g[0].levels) for g in est.model.output["trees"])
    assert cuda_graph.snapshot()["hist_cuda"] == levels * st["n_blocks"]
    assert all(fr.vec(f"f{i}")._data is None for i in range(12))
    div = divergences(est, res)
    if div["class_trees_equal"] == kw["ntrees"]:
        p_s, p_r = (e.predict(fr).vec("s").data for e in (est, res))
        assert float((p_s - p_r).abs().max()) <= 1e-5


def _card_gbm(df, **kw):
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    est = H2OGradientBoostingEstimator(ntrees=5, max_depth=5, min_rows=10.0,
                                       seed=42, **kw)
    est.train(y="label", training_frame=fr)
    return est.model, fr


def test_contributions_on_card_match_plain_recursion(dev):
    """TreeSHAP's one walk per tree on the card against JAX's row-by-row
    recursion (the plain version, float64 on the host) on 300 rows:
    within 1e-9; every row's sum within 1e-5 of the float32 raw margin."""
    from h2o3_tpu_torch.models.tree import shap

    m, fr = _card_gbm(_float_df(20_000, seed=21))
    phi = shap.contributions(m, fr)
    assert phi.is_cuda and phi.dtype == torch.float64
    sub = fr.subset_rows(np.arange(300))
    plain = shap.contributions_plain(m, sub)
    assert float(np.abs(phi[:300].cpu().numpy() - plain).max()) <= 1e-9
    margin = m._replay_all(fr).double() + m.output["init_f"]
    assert float((phi.sum(dim=1) - margin).abs().max()) <= 1e-5


def test_calibration_on_card_matches_host_float64(dev):
    """``cal_p1`` on the card against the calibrator applied in float64 on
    the host (numpy, JAX's formulas) to the card's own p1: within 1e-6,
    Platt scaling and isotonic regression."""
    import h2o3_tpu_torch

    df = _float_df(20_000, seed=22)
    cal = h2o3_tpu_torch.upload_file(_float_df(10_000, seed=23),
                                     device="cuda")
    for method in ("PlattScaling", "IsotonicRegression"):
        m, fr = _card_gbm(df, calibrate_model=True, calibration_frame=cal,
                          calibration_method=method)
        out = m.predict(fr)
        assert out.vec("cal_p1").data.is_cuda
        p1 = out.vec("s").data.double().cpu().numpy()
        c = m.output["calibration"]
        if method == "PlattScaling":
            q = np.clip(p1, 1e-12, 1 - 1e-12)
            eta = np.clip(c["a"] * np.log(q / (1 - q)) + c["b"], -30, 30)
            want = 1 / (1 + np.exp(-eta))
        else:
            want = np.clip(np.interp(p1, c["thresholds_x"],
                                     c["thresholds_y"]), 0, 1)
        got = out.vec("cal_p1").data.double().cpu().numpy()
        assert float(np.abs(got - want).max()) <= 1e-6


def test_target_encoder_on_card_matches_cpu(dev):
    """The encoder's tables and ``_te`` columns fit and transformed on the
    card against the CPU on the same frame (kfold, blending, seeded
    noise): within 1e-9 relative (the card's float64 sums add by atomics
    in any order)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import airlines_like
    from h2o3_tpu_torch.models.target_encoding import TargetEncoder

    df = airlines_like(50_000, seed=3)
    cols = ["UniqueCarrier", "Origin", "Dest"]
    out = {}
    for d in ("cuda", "cpu"):
        fr = h2o3_tpu_torch.upload_file(df, device=d)
        te = TargetEncoder(holdout_type="kfold", nfolds=5, blending=True,
                           noise=0.01, seed=7).fit(fr, "IsDepDelayed", cols)
        enc = te.transform(fr, as_training=True)
        out[d] = (te, [enc.vec(c + "_te").data.double().cpu().numpy()
                       for c in cols])
        assert enc.vec("Origin_te").device.type == d
    (gte, gcols), (cte, ccols) = out["cuda"], out["cpu"]
    for c in cols:
        for a, b in zip(gte._stats[c][:2], cte._stats[c][:2]):
            np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    for a, b in zip(gcols, ccols):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)


def test_ingest_lanes_on_card_equal_cpu(dev, tmp_path, monkeypatch):
    """A CSV parsed onto the card by the native, pandas and streamed lanes
    (each asserted from ``PARSE_LANES``) equals the same lane's CPU parse,
    and the three are equal to the bit."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.frame import parse

    path = str(tmp_path / "h.csv")
    higgs_like(20_000, 6, seed=4).to_csv(path, index=False)
    frames = {}
    for lane, env in (("native", {}), ("pandas", {"H2O3_TPU_NATIVE_PARSE":
                                                  "0"}),
                      ("stream", {"H2O3_TPU_STREAM_BYTES": "1000"})):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for d in ("cuda", "cpu"):
            frames[lane, d] = h2o3_tpu_torch.import_file(path, device=d)
            assert parse.PARSE_LANES[path] == lane
        for k in env:
            monkeypatch.delenv(k)
    ref = frames["native", "cpu"]
    for fr in frames.values():
        assert fr.names == ref.names
        for n in ref.names:
            assert fr.vec(n).domain == ref.vec(n).domain
            assert torch.equal(fr.vec(n).data.cpu(), ref.vec(n).data)


def test_deferred_chain_on_card_bit_equal_to_eager(dev, monkeypatch):
    """A deferred chain of arithmetic, comparisons, a libm op and ifelse on
    the card equals the eager operators to the bit, resident and streamed
    through a window (on the card every row's op takes one path)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.frame import lazy, ops

    fr = h2o3_tpu_torch.upload_file(higgs_like(100_003, 6, seed=5),
                                    device="cuda")
    x, y, z = fr.vec("f0"), fr.vec("f1"), fr.vec("f2")

    def chain():
        return ops.ifelse(x > y, (z * 0.5 + y).exp(), (x - z).abs().log1p())

    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "0")
    eager = chain().data
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")
    deferred = chain()
    assert isinstance(deferred, lazy.LazyExprVec)
    assert torch.equal(deferred.data.view(torch.int32), eager.view(torch.int32))
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(256 * 1024))
    streamed = chain()
    host = torch.from_numpy(streamed.host_values())
    assert streamed._data is None
    assert torch.equal(host.view(torch.int32), eager.cpu().view(torch.int32))


# the tree variants' shapes (coarsened bins, bundled columns, four lanes)
# and GOSS inside a captured graph


@pytest.mark.parametrize("case", ["65_bins", "129_bins", "4_lanes",
                                  "bundled"])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_hist_kernel_on_tree_variant_shapes(dev, case, integer):
    """B1 against its plain version where the variants send it: 65 and
    129 bins (bin coarsening's levels, the codes coarsened from 256), four
    stat lanes (UpliftDRF) and the bundled codes of an EFB plan of one-hot
    columns."""
    from h2o3_tpu_torch.models.tree import binning as pbin
    from h2o3_tpu_torch.models.tree.shared_tree import _coarsen_bins

    rng = np.random.default_rng(19)
    n, N = 200_003, 16
    bins = torch.from_numpy(rng.integers(0, 256, (n, 12)).astype(np.uint8))
    S, B = 3, 256
    if case in ("65_bins", "129_bins"):
        s = 2 if case == "65_bins" else 1
        bins, B = _coarsen_bins(bins, s), 65 if s == 2 else 129
    elif case == "4_lanes":
        S = 4
    else:
        lv = rng.integers(0, 30, n)
        onehot = np.stack([(lv == k) for k in range(30)], 1).astype(np.uint8)
        codes = np.concatenate([onehot + 1, bins.numpy()[:, :2]], axis=1)
        spec = pbin.BinSpec([f"c{i}" for i in range(32)], np.zeros(32, bool),
                            np.array([2] * 30 + [255, 255]),
                            np.zeros((32, 254), np.float32),
                            np.zeros(32, np.int64))
        plan = pbin.fit_efb(spec, codes)
        assert plan is not None and plan.n_cols_b == 3
        bins = pbin.bundle_bins(plan, torch.from_numpy(codes))
    nid = rng.integers(0, N, n).astype(np.int32)
    nid[rng.random(n) < 0.1] = -1
    if integer:
        stats = rng.integers(0, 4, (n, S)).astype(np.float32)
    else:
        stats = rng.random((n, S)).astype(np.float32)
    args = [t.to(dev) for t in (bins, torch.from_numpy(nid),
                                torch.from_numpy(stats))]
    _check_hist(args, N, B, integer)


@pytest.mark.parametrize("n_bins", [65, 129])
def test_split_kernel_at_coarse_bins(dev, n_bins):
    """B2 against its plain version on a coarsened level's histogram:
    integer stats, so every gain and decision is equal."""
    rng = np.random.default_rng(n_bins)
    N, C = 32, 28
    h = np.zeros((N, C, n_bins, 3), np.float32)
    h[..., 0] = rng.integers(0, 40, (N, C, n_bins))
    h[..., 1] = rng.integers(-20, 21, (N, C, n_bins))
    h[..., 2] = h[..., 0]
    hist = torch.from_numpy(h).to(dev)
    tot = hist[:, 0].sum(dim=1).contiguous()
    gk = split_candidates_cuda(hist, tot, 10.0)
    gp = split_candidates_plain(hist, tot, 10.0)
    for a, b in zip(gk, gp):
        assert torch.equal(a, b)


def test_goss_graph_equals_eager_bodies(dev, monkeypatch):
    """GOSS inside the captured whole-tree graph (the threshold a device
    sort, the rest draw keyed on the device) against the same bodies run
    eagerly on the card: every record of three trees equal (integer
    targets), F and the kept-row count equal."""
    from h2o3_tpu_torch.models.tree import shared_tree as pst

    monkeypatch.setenv("H2O3_TPU_TREE_GOSS", "0.3,0.2")
    rng = np.random.default_rng(23)
    n, C = 60_000, 6
    bins = torch.from_numpy(rng.integers(0, 32, (n, C)).astype(np.uint8))
    t = torch.from_numpy(rng.integers(-3, 4, n).astype(np.float32))
    lrs = np.array([0.5, 0.5, 0.5], np.float32)
    out = {}
    for capture in (True, False):
        pst.free_graphs()
        monkeypatch.setattr(pst, "CAPTURE", capture)
        kept0 = pst.goss_stats()["rows_kept"]
        b = pst.WholeTreeBuilder(
            bins.to(dev), torch.ones(n, device=dev), t.to(dev),
            torch.zeros(n, device=dev), torch.zeros(C, device=dev),
            grad_fn=lambda F, y, w: (y, torch.ones_like(F)),
            grad_key=("goss-card",), n_bins=32,
            is_cat_cols=np.zeros(C, bool), max_depth=4, min_rows=1.0,
            min_split_improvement=0.0, max_abs_leaf=float("inf"),
            chunk_cap=len(lrs))
        assert (b.programs is not None) == capture
        stk = b.build(lrs)
        out[capture] = ({(li, f): v.cpu() for li, lvl in enumerate(stk)
                         for f, v in lvl.items()},
                        b.F.clone().cpu(),
                        pst.goss_stats()["rows_kept"] - kept0)
    pst.free_graphs()
    (rg, Fg, kg), (re, Fe, ke) = out[True], out[False]
    assert kg == ke > 0
    assert torch.equal(Fg, Fe)
    for f in rg:
        assert torch.equal(rg[f], re[f]), f


# --- slice 20: the other algorithms and the native tree walk -------------


def _slice20_frames(df):
    import h2o3_tpu_torch

    return (h2o3_tpu_torch.upload_file(df, device="cuda"),
            h2o3_tpu_torch.upload_file(df, device="cpu"))


def _slice20_df(n=20_000, seed=8):
    from h2o3_tpu_torch.datasets import higgs_like

    return higgs_like(n, 8, seed=seed)


def test_decision_tree_on_card_launches_kernels(dev):
    """The decision tree on a CUDA frame: every splitting level launches
    B1, its compaction and B2 (the eager per-level loop), the splits equal
    the CPU twin's but for float near-ties, AUC within 1e-3."""
    from h2o3_tpu_torch.estimators import H2ODecisionTreeEstimator
    from h2o3_tpu_torch.ops import cuda_graph
    from h2o3_tpu_torch.tools.tree_parity import divergences

    card, cpu = _slice20_frames(_slice20_df())
    for f in cuda_graph.counters():
        f.launches = 0
    g = H2ODecisionTreeEstimator(max_depth=6)
    g.train(y="label", training_frame=card)
    torch.cuda.synchronize()
    got = cuda_graph.snapshot()
    c = H2ODecisionTreeEstimator(max_depth=6)
    c.train(y="label", training_frame=cpu)
    splitting = len(g.model.output["trees"][0][0].levels) - 1
    assert got["hist_cuda"] == got["compact_cuda"] >= splitting
    assert got["split_candidates_cuda"] >= splitting
    assert got["split_candidates_mono_cuda"] == 0
    divergences(g, c, boosted=False)
    assert abs(g.auc() - c.auc()) <= 1e-3
    import tempfile

    import h2o3_tpu_torch

    with tempfile.TemporaryDirectory() as d:
        back = h2o3_tpu_torch.load_model(
            h2o3_tpu_torch.save_model(g.model, d + "/"))
    assert torch.equal(back._predict_raw(card), g.model._predict_raw(card))


@pytest.mark.parametrize("algo", ["kmeans", "naive_bayes", "pca", "svd",
                                  "glrm", "isolation_forest",
                                  "extended_isolation_forest"])
def test_slice20_builder_on_card_matches_cpu(dev, algo):
    """Each builder trains on a CUDA frame (its outputs on the card) and
    matches its CPU twin under the chip run's bounds."""
    from h2o3_tpu_torch import estimators as E

    df = _slice20_df()
    card, cpu = _slice20_frames(df)
    x = [c for c in df.columns if c != "label"]
    cls, kw, y = {
        "kmeans": (E.H2OKMeansEstimator, dict(k=5, seed=1), None),
        "naive_bayes": (E.H2ONaiveBayesEstimator, {}, "label"),
        "pca": (E.H2OPrincipalComponentAnalysisEstimator, dict(k=4), None),
        "svd": (E.H2OSingularValueDecompositionEstimator,
                dict(nv=3, svd_method="Randomized"), None),
        "glrm": (E.H2OGeneralizedLowRankEstimator,
                 dict(k=3, max_iterations=30), None),
        "isolation_forest": (E.H2OIsolationForestEstimator,
                             dict(ntrees=10, seed=1), None),
        "extended_isolation_forest": (E.H2OExtendedIsolationForestEstimator,
                                      dict(ntrees=10, seed=1), None),
    }[algo]
    models = []
    for fr in (card, cpu):
        est = cls(**kw)
        est.train(x=x if y is None else None, y=y, training_frame=fr)
        models.append(est.model)
    g, c = models
    if algo == "kmeans":
        np.testing.assert_allclose(g.output["centers_std"],
                                   c.output["centers_std"], atol=1e-4)
    elif algo == "naive_bayes":
        diff = (g._predict_raw(card).double().cpu()
                - c._predict_raw(cpu).double()).abs().max()
        assert float(diff) <= 1e-6
    elif algo == "pca":
        np.testing.assert_allclose(g.output["eigenvalues"],
                                   c.output["eigenvalues"], rtol=1e-5)
    elif algo == "svd":
        np.testing.assert_allclose(g.output["d"], c.output["d"], rtol=1e-4)
    elif algo == "glrm":
        assert g.output["x_factor"].is_cuda
        assert g.output["objective"] == pytest.approx(c.output["objective"],
                                                      rel=1e-4)
    else:
        raw_g = g._predict_raw(card)
        assert raw_g.is_cuda
        np.testing.assert_allclose(raw_g.double().cpu().numpy(),
                                   c._predict_raw(cpu).double().numpy(),
                                   atol=1e-6 if algo == "isolation_forest"
                                   else 1e-5)


def test_native_walk_taken_on_the_card_machine(dev, tmp_path):
    """A GBM trained on the card, its tmojo scored by the native walk (the
    lane recorded in ``genmodel.SCORE_LANES``), bit-equal to the numpy
    walk."""
    import os

    from h2o3_tpu_torch import genmodel, native_tmojo
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    df = _slice20_df(5_000)
    card, _ = _slice20_frames(df)
    est = H2OGradientBoostingEstimator(ntrees=5, max_depth=4, seed=1)
    est.train(y="label", training_frame=card)
    path = est.download_mojo(str(tmp_path))
    rows = df.drop(columns="label")
    lanes = dict(genmodel.SCORE_LANES)
    nat = genmodel.MojoModel.load(path).predict(rows)
    assert native_tmojo.enabled(), native_tmojo.BUILD_ERROR
    assert genmodel.SCORE_LANES["native"] == lanes["native"] + 1
    os.environ["H2O3_TPU_NATIVE"] = "0"
    try:
        plain = genmodel.MojoModel.load(path).predict(rows)
    finally:
        del os.environ["H2O3_TPU_NATIVE"]
    for k in nat:
        np.testing.assert_array_equal(nat[k], plain[k])


def _no_plain_kernel_calls(monkeypatch):
    """Counts the plain histogram, compaction and split scan called on CUDA
    tensors (the dispatchers never route there)."""
    from h2o3_tpu_torch.ops import hist_cuda as hc
    from h2o3_tpu_torch.ops import histogram as ph
    from h2o3_tpu_torch.ops import split_cuda as sc

    seen = {"calls": 0}
    for mod, name in ((ph, "hist_plain"), (hc, "hist_plain"),
                      (hc, "compact_plain"), (sc, "split_candidates_plain")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, **kw):
            if any(isinstance(t, torch.Tensor) and t.is_cuda for t in a):
                seen["calls"] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)
    return seen


@pytest.mark.parametrize("algo", ["adaboost", "rulefit"])
def test_slice21_trees_on_card_launch_kernels(dev, algo, monkeypatch):
    """AdaBoost's stumps and RuleFit's forests on a CUDA frame launch B1,
    its compaction and B2 and never their plain versions; AdaBoost's
    stumps equal the CPU twin's but for float near-ties (alphas within
    1e-5 up to the first parting), RuleFit's rules equal the CPU twin's
    where no forest parted (coefficients within 1e-4); a save/load round
    trip predicts the same on the card."""
    import tempfile
    from types import SimpleNamespace

    import h2o3_tpu_torch
    from h2o3_tpu_torch import estimators as E
    from h2o3_tpu_torch.ops import cuda_graph
    from h2o3_tpu_torch.tools.tree_parity import divergences

    card, cpu = _slice20_frames(_slice20_df())
    cls, kw = {
        "adaboost": (E.H2OAdaBoostEstimator, dict(nlearners=10, seed=1)),
        "rulefit": (E.H2ORuleFitEstimator,
                    dict(algorithm="GBM", rule_generation_ntrees=5,
                         lambda_=1e-3, seed=1)),
    }[algo]
    plain = _no_plain_kernel_calls(monkeypatch)
    for f in cuda_graph.counters():
        f.launches = 0
    g = cls(**kw)
    g.train(y="label", training_frame=card)
    torch.cuda.synchronize()
    got = cuda_graph.snapshot()
    c = cls(**kw)
    c.train(y="label", training_frame=cpu)
    assert plain["calls"] == 0
    assert min(got["hist_cuda"], got["compact_cuda"],
               got["split_candidates_cuda"]) > 0
    assert got["split_candidates_mono_cuda"] == 0
    if algo == "adaboost":
        parts = divergences(g, c, boosted=True)
        first = (parts["partings"][0]["iteration"] if parts["partings"]
                 else len(c.model.output["alphas"]))
        np.testing.assert_allclose(g.model.output["alphas"][:first],
                                   c.model.output["alphas"][:first],
                                   atol=1e-5)
    else:
        parts = [divergences(SimpleNamespace(model=a),
                             SimpleNamespace(model=b), boosted=True)
                 for a, b in zip(g.model.output["forests"],
                                 c.model.output["forests"])]
        if not any(p["partings"] for p in parts):
            # the same conditions (a printed edge may part in its last digit)
            for k in ("rule_cols", "rule_masks", "rule_valid"):
                np.testing.assert_array_equal(g.model.output[k],
                                              c.model.output[k])
            gc, cc = (m.output["glm_model"].coef for m in (g.model, c.model))
            assert max(abs(gc[k] - cc[k]) for k in cc) <= 1e-4
    with tempfile.TemporaryDirectory() as d:
        back = h2o3_tpu_torch.load_model(
            h2o3_tpu_torch.save_model(g.model, d + "/"))
    assert torch.equal(back._predict_raw(card), g.model._predict_raw(card))


@pytest.mark.parametrize("algo", ["aggregator", "gam", "model_selection",
                                  "coxph"])
def test_slice21_builder_on_card_matches_cpu(dev, algo):
    """The aggregator, GAM, model selection and CoxPH train on a CUDA frame
    and match their CPU twins under the chip run's bounds: the exemplars
    and mapping equal; GAM coefficients within 1e-4 (plus 1e-4 of their
    magnitude); subsets equal with R² within 1e-6; CoxPH coefficients
    within 1e-6 (float64 on both)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch import datasets
    from h2o3_tpu_torch import estimators as E

    if algo == "model_selection":
        df = datasets.linear_like(20_000, seed=3)
    elif algo == "coxph":
        df = datasets.survival_like(20_000, 8, seed=3)
    else:
        df = _slice20_df()
    card = h2o3_tpu_torch.upload_file(df, device="cuda")
    cpu = h2o3_tpu_torch.upload_file(df, device="cpu")
    x = [c for c in df.columns if c != "label"]
    cls, kw, y = {
        "aggregator": (E.H2OAggregatorEstimator,
                       dict(target_num_exemplars=200), None),
        "gam": (E.H2OGeneralizedAdditiveEstimator,
                dict(gam_columns=["f0", "f1"]), "label"),
        "model_selection": (E.H2OModelSelectionEstimator,
                            dict(max_predictor_number=4), "y"),
        "coxph": (E.H2OCoxProportionalHazardsEstimator,
                  dict(stop_column="time"), "event"),
    }[algo]
    models = []
    for fr in (card, cpu):
        est = cls(**kw)
        est.train(x=x if y is None else None, y=y, training_frame=fr)
        models.append(est.model)
    g, c = models
    if algo == "aggregator":
        assert g.output["num_exemplars"] == c.output["num_exemplars"]
        np.testing.assert_array_equal(g.mapping, c.mapping)
        assert g.aggregated_frame.vec("counts").data.is_cuda
    elif algo == "gam":
        bg, bc = g.output["beta"], c.output["beta"]
        assert np.all(np.abs(bg - bc) <= 1e-4 * (1 + np.abs(bc)))
        assert g._predict_raw(card).is_cuda
    elif algo == "model_selection":
        assert (g.get_best_model_predictors()
                == c.get_best_model_predictors())
        np.testing.assert_allclose(g.get_best_r2_values(),
                                   c.get_best_r2_values(), atol=1e-6)
    else:
        np.testing.assert_allclose(g.output["coefficients"],
                                   c.output["coefficients"], atol=1e-6)
        assert g.output["loglik"] == pytest.approx(c.output["loglik"],
                                                   rel=1e-8)


def test_slice22_infogram_on_card_launches_kernels(dev, monkeypatch):
    """The core Infogram's GBMs on a CUDA frame launch B1, its compaction
    and B2 and never their plain versions; every index within 1e-3 of the
    CPU twin's and the admissible sets equal but where an index lies
    within 1e-3 of its threshold."""
    from h2o3_tpu_torch.estimators import H2OInfogramEstimator
    from h2o3_tpu_torch.ops import cuda_graph

    card, cpu = _slice20_frames(_slice20_df(n=5_000)[
        ["f0", "f1", "f2", "f3", "label"]])
    plain = _no_plain_kernel_calls(monkeypatch)
    for f in cuda_graph.counters():
        f.launches = 0
    models = []
    for fr in (card, cpu):
        est = H2OInfogramEstimator(ntrees=5, max_depth=3, seed=1)
        est.train(y="label", training_frame=fr)
        models.append(est.model)
        torch.cuda.synchronize()
        if fr is card:
            got = cuda_graph.snapshot()
    assert plain["calls"] == 0
    gbms = 1 + 2 * 4
    assert min(got["hist_cuda"], got["compact_cuda"],
               got["split_candidates_cuda"]) >= gbms * 5
    assert got["split_candidates_mono_cuda"] == 0
    g, c = ({r["column"]: (r["total_information"], r["net_information"])
             for r in m.get_admissible_score_frame()} for m in models)
    assert max(abs(a - b) for f in g for a, b in zip(g[f], c[f])) <= 1e-3
    near = {f for f in c if any(abs(v - 0.1) <= 1e-3 for v in c[f])}
    assert (set(models[0].get_admissible_features()) - near
            == set(models[1].get_admissible_features()) - near)


@pytest.mark.parametrize("algo", ["anovaglm_binomial", "anovaglm_gaussian",
                                  "hglm", "psvm", "word2vec", "generic"])
def test_slice22_builder_on_card_matches_cpu(dev, algo, tmp_path):
    """ANOVAGLM, HGLM, PSVM, Word2Vec and the generic model on a CUDA
    frame against their CPU twins under the chip run's bounds: ANOVAGLM's
    F within 1e-4 relative (gaussian) or deviances within 1e-8 relative
    and p-values within 1e-6 (binomial); HGLM's β and BLUPs within 1e-4
    and σ²s within 1e-5 relative; PSVM's w, b and decisions within 1e-4 of
    the largest; Word2Vec's embeddings within 1e-4 of the largest; the
    generic model's probabilities within 1e-5 of the trained model's, its
    labels equal. Each model's save/load round trip is equal on the
    card."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch import datasets
    from h2o3_tpu_torch import estimators as E

    types = None
    if algo == "anovaglm_binomial":
        df = datasets.airlines_like(20_000, seed=3)
        cls, y = E.H2OANOVAGLMEstimator, "IsDepDelayed"
        kw = dict(family="binomial", lambda_=0.0)
        x = ["UniqueCarrier", "Distance", "CRSDepTime"]
    elif algo == "anovaglm_gaussian":
        df = datasets.linear_like(20_000, seed=3)
        cls, y, x = E.H2OANOVAGLMEstimator, "y", ["f0", "f3", "f7"]
        kw = dict(family="gaussian", lambda_=0.0)
    elif algo == "hglm":
        df = datasets.grouped_like(20_000, n_groups=50, seed=3)
        cls, y, x = E.H2OHGLMEstimator, "y", None
        kw = dict(random_columns=["grp"])
    elif algo == "psvm":  # the headline's 28 features: a well-conditioned
        #                   K_mm for its 200 landmarks
        df = datasets.higgs_like(20_000, 28, seed=8)
        cls, y, x, kw = E.H2OSupportVectorMachineEstimator, "label", None, {}
    elif algo == "word2vec":
        df = datasets.text_like(30_000, 2_000, seed=3)
        cls, y, x, kw = E.H2OWord2vecEstimator, None, None, dict(epochs=2)
        types = {"word": "string"}
    else:
        df = _slice20_df()
        cls, y, x = E.H2OGradientBoostingEstimator, "label", None
        kw = dict(ntrees=10, max_depth=4, seed=1)
    frames = [h2o3_tpu_torch.upload_file(df, col_types=types, device=d)
              for d in ("cuda", "cpu")]
    models = []
    for fr in frames:
        est = cls(**kw)
        est.train(x=x, y=y, training_frame=fr)
        models.append(est.model)
    g, c = models
    card, cpu = frames
    if algo == "generic":  # the card's GBM against its own tmojo
        path = g.download_mojo(str(tmp_path / "gbm.zip"))
        c = h2o3_tpu_torch.import_mojo(path)
        pa, pb = g.predict(card), c.predict(card)
        np.testing.assert_allclose(pb.vec("s").data.cpu().numpy(),
                                   pa.vec("s").data.cpu().numpy(), atol=1e-5)
        assert torch.equal(pa.vec("predict").data, pb.vec("predict").data)
        g = c
    elif algo == "anovaglm_gaussian":
        ft, pt = g.anova_table(), c.anova_table()
        for a, b in zip(ft[:-1], pt[:-1]):
            assert abs(a["f"] - b["f"]) <= 1e-4 * abs(b["f"])
    elif algo == "anovaglm_binomial":
        np.testing.assert_allclose(g.output["deviances"],
                                   c.output["deviances"], rtol=1e-8)
        for a, b in zip(g.anova_table(), c.anova_table()):
            assert abs(a["p_value"] - b["p_value"]) <= 1e-6
    elif algo == "hglm":
        go, co = g.output, c.output
        assert np.abs(go["beta"] - co["beta"]).max() <= 1e-4
        assert np.abs(go["random_effects"]["grp"][1]
                      - co["random_effects"]["grp"][1]).max() <= 1e-4
        assert go["sigma_e2"] == pytest.approx(co["sigma_e2"], rel=1e-5)
        assert go["sigma_u2"]["grp"] == pytest.approx(co["sigma_u2"]["grp"],
                                                      rel=1e-5)
    elif algo == "psvm":
        wmax = np.abs(c.output["w"]).max()
        assert np.abs(g.output["w"] - c.output["w"]).max() <= 1e-4 * wmax
        assert abs(g.output["b"] - c.output["b"]) <= 1e-4 * wmax
        dg = g._decision(card).double().cpu().numpy()
        dc = c._decision(cpu).double().numpy()
        assert np.abs(dg - dc).max() <= 1e-4 * np.abs(dc).max()
    else:
        eg, ec = g.output["embeddings"], c.output["embeddings"]
        assert np.abs(eg - ec).max() <= 1e-4 * np.abs(ec).max()
    back = h2o3_tpu_torch.load_model(
        h2o3_tpu_torch.save_model(g, str(tmp_path) + "/saved/"))
    if algo == "word2vec":
        np.testing.assert_array_equal(back.output["embeddings"],
                                      g.output["embeddings"])
    else:
        out = back._predict_raw(card)
        assert out.is_cuda and torch.equal(out, g._predict_raw(card))
