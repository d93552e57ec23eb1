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


def _case(n, C, N, B, seed, integer):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, C)).astype(np.uint8)
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


@pytest.mark.parametrize("n_bins", [256, 16, 3])
def test_split_kernel_bit_equal_on_integer_histograms(dev, n_bins):
    bins, nid, stats = _case(50_000, 13, 8, n_bins, seed=n_bins, integer=True)
    bins[:, 5] = bins[:, 2]  # duplicated columns: exact ties across columns
    h = hist_plain(*(torch.from_numpy(a) for a in (bins, nid, stats)), 8,
                   n_bins)
    tot = h[:, 0].sum(dim=1)
    got = split_candidates_cuda(h.to(dev), tot.to(dev), 10.0)
    for a, b in zip(got, split_candidates_plain(h, tot, 10.0)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


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


@pytest.mark.parametrize("n_bins", [256, 16, 3])
def test_mono_split_kernel_bit_equal_on_integer_histograms(dev, n_bins):
    bins, nid, stats = _case(50_000, 13, 8, n_bins, seed=n_bins, integer=True)
    stats[:, 2] = np.random.default_rng(1).integers(1, 4, len(stats))
    h = hist_plain(*(torch.from_numpy(a) for a in (bins, nid, stats)), 8,
                   n_bins)
    tot = h[:, 0].sum(dim=1)
    mono, lo, hi = _mono_inputs(8, 13, seed=n_bins)
    before = split_candidates_mono_cuda.launches
    got = split_candidates_mono_cuda(h.to(dev), tot.to(dev), 10.0,
                                     mono.to(dev), lo.to(dev), hi.to(dev))
    assert split_candidates_mono_cuda.launches == before + 1
    for a, b in zip(got, split_candidates_mono_plain(h, tot, 10.0, mono, lo,
                                                     hi)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)


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
