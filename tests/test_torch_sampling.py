"""Row and column sampling in the port (``models/tree/sampling.py`` and the
draws of the whole-tree build and the eager per-level loop), on the CPU at
small sizes. Inputs are made with numpy from seeds.

The draws are keyed hashes, not ``jax.random`` streams, so they are held
here to their own contracts: one key gives one mask, the K class trees of
an iteration share its bootstrap and draw their own columns, the fractions
match the rates, the column padding cannot move a draw, a node that draws
no column keeps all, and a forest does not depend on how its iterations
were chunked. Against JAX, which draws from ``jax.random`` streams, they
are compared by distribution: a sampled model's held-out metric lies
within the spread of JAX's own over 5 seeds, widened by a stated margin.

Tolerances, with their reasons:
- mask fractions: within 4 standard deviations of the rate (a Bernoulli
  count over m draws has standard deviation sqrt(m·p·(1-p)));
- whole-tree build against the eager loop: every record field bit-equal
  on integer-valued targets and unit weights (every histogram sum is
  exact, and the two paths draw the same masks and run the same float32
  leaf arithmetic); levels the eager loop skipped (it stops at the first
  level that splits nothing) all-leaf and zero-valued;
- chunking: records and predictions bit-equal (the same trees);
- by distribution: the mean of the port's held-out AUC over seeds 1-3
  within [min - m, max + m] of JAX's over seeds 1-5, the margin m 1.5
  standard deviations of one seed's AUC: 0.015 for DRF, 0.004 for GBM.
  Measured when written: over 30 seeds DRF's AUC was 0.7409 +- 0.0090 in
  JAX and 0.7435 +- 0.0107 in the port, over 20 seeds GBM's 0.8250 +-
  0.0027 and 0.8252 +- 0.0027; JAX's seeds 1-5 spread 0.7301-0.7413 (DRF)
  and 0.8181-0.8260 (GBM), the port's means over seeds 1-3 were 0.7522
  and 0.8227. A port whose draws ran at other rates than JAX's would sit
  further out than the margin.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree.drf import DRF as JDRF  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OGradientBoostingEstimator,
    H2ORandomForestEstimator,
)
from h2o3_tpu_torch.models import metrics as PM  # noqa: E402
from h2o3_tpu_torch.models.tree import sampling  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from test_torch_multinomial import multiclass_df  # noqa: E402
from test_torch_slice import _frame_df  # noqa: E402


def _within_4_sigma(mask: torch.Tensor, rate: float) -> bool:
    m = mask.numel()
    frac = float(mask.float().mean())
    return abs(frac - rate) <= 4 * np.sqrt(rate * (1 - rate) / m)


def test_hash_is_32_bit_and_equal_on_ints_and_tensors():
    """``mix`` stays in [0, 2^32) and gives the same bits on Python ints
    as on int64 tensors (the eager loop keys by ints, the graphs by device
    scalars); it is a bijection on a sample (no two inputs collide)."""
    xs = [0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 123456789]
    got = sampling.mix(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert got == [sampling.mix(x) for x in xs]
    h = sampling.index_hash(1 << 20, "cpu")
    assert int(h.min()) >= 0 and int(h.max()) <= sampling.M32
    assert torch.unique(h).numel() == 1 << 20
    key = sampling.fold(sampling.seed_key(42), 3, 7)
    tkey = sampling.fold(torch.tensor([sampling.seed_key(42)]),
                         torch.tensor([3]), torch.tensor([7]))
    assert int(tkey) == key


def test_same_key_same_mask_different_keys_differ():
    """A mask depends on its key only; other iterations, seeds and classes
    draw other masks."""
    h = sampling.index_hash(50_000, "cpu")
    k = sampling.seed_key(42)
    a = sampling.row_mask(k, 3, 0.632, h)
    assert torch.equal(a, sampling.row_mask(k, 3, 0.632, h))
    assert not torch.equal(a, sampling.row_mask(k, 4, 0.632, h))
    assert not torch.equal(a, sampling.row_mask(sampling.seed_key(43), 3,
                                                0.632, h))
    c0 = sampling.split_cols(sampling.split_key(k, 3, 0), 5, 0.3, 64, 10, h)
    c1 = sampling.split_cols(sampling.split_key(k, 3, 1), 5, 0.3, 64, 10, h)
    c2 = sampling.split_cols(sampling.split_key(k, 3, 0), 6, 0.3, 64, 10, h)
    assert not torch.equal(c0, c1) and not torch.equal(c0, c2)


@pytest.mark.parametrize("rate", [0.632, 0.1, 0.8])
def test_mask_fractions_within_4_sigma_of_the_rate(rate):
    """Rows over 200,000 draws, per-tree columns over 500 trees of 28
    columns, per-split columns over a 2048 x 28 level (the draws before
    the none-drawn fallback, which is checked apart)."""
    k = sampling.seed_key(7)
    h = sampling.index_hash(200_000, "cpu")
    assert _within_4_sigma(sampling.row_mask(k, 0, rate, h), rate)
    per_tree = torch.stack([
        sampling.uniform(sampling.fold(k, sampling.TREE_COLS, m, 0), h[:28])
        < rate for m in range(500)])
    assert _within_4_sigma(per_tree, rate)
    u = sampling.uniform(sampling.fold(sampling.split_key(k, 0, 0), 11),
                         h[: 2048 * 28])
    assert _within_4_sigma(u < rate, rate)
    # the keyed uniforms are uniform: mean 1/2, variance 1/12
    assert abs(float(u.mean()) - 0.5) <= 4 * np.sqrt(1 / 12 / u.numel())


def test_none_drawn_keeps_all_at_a_tiny_rate():
    """At a rate no draw passes, a tree keeps every column and every node
    every column; a sampled build at that rate equals the unsampled one."""
    k = sampling.seed_key(1)
    h = sampling.index_hash(4096, "cpu")
    assert bool(sampling.tree_cols(k, 0, 0, 1e-9, 28, h).all())
    assert bool(sampling.split_cols(sampling.split_key(k, 0, 0), 4, 1e-9,
                                    64, 28, h).all())
    # a node drawing some columns keeps just those
    some = sampling.split_cols(sampling.split_key(k, 0, 0), 4, 0.2, 64, 28, h)
    assert 0 < int(some.sum()) < some.numel()
    bins, t, _ = _int_suite()
    base = _scanned(bins, t, 2, 4, 16, pst_sample=None)
    tiny = _scanned(bins, t, 2, 4, 16, pst_sample=(1.0, 1e-9, 1e-9))
    for a, b in zip(base[2], tiny[2]):
        for f in pst._REC_FIELDS:
            assert torch.equal(a[f], b[f]), f


def test_split_draw_does_not_depend_on_column_padding(monkeypatch):
    """Columns pad to a multiple of 4 (``bucket_cols``); the per-split and
    per-tree draws run at the real column count, so a sampled build with
    the padding and one without it grow the same trees."""
    bins, t, _ = _int_suite(C=6)
    rates = (0.7, 0.5, 0.8)
    padded = _scanned(bins, t, 3, 5, 16, pst_sample=rates)
    monkeypatch.setenv("H2O3_TPU_SHAPE_BUCKETS", "0")
    plain = _scanned(bins, t, 3, 5, 16, pst_sample=rates)
    assert torch.equal(padded[0], plain[0])
    for a, b in zip(padded[2], plain[2]):
        for f in ("split_col", "split_bin", "leaf_now", "leaf_val", "node_w",
                  "child_base", "na_left"):
            assert torch.equal(a[f], b[f]), f
    # the level's draw itself: the pad columns are never kept
    h = sampling.index_hash(64 * 6, "cpu")
    keep = pst._split_draw(sampling.split_key(9, 0, 0), 3, 0.5, 64, 6, 8, h)
    assert keep.shape == (64, 8) and not keep[:, 6:].any()
    assert torch.equal(keep[:, :6].bool(), sampling.split_cols(
        sampling.split_key(9, 0, 0), 3, 0.5, 64, 6, h))


def _int_suite(n=960, C=6, seed=3):
    """Codes and integer targets that keep every histogram sum exact."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, 16, (n, C)).astype(np.uint8)
    t = (2.0 * (bins[:, 0] > 8) + (bins[:, 1] > 4) - (bins[:, 2] > 10)
         + rng.integers(-1, 2, n)).astype(np.float32)
    return bins, t, rng


def _drf_grad(K):
    if K == 1:
        return lambda F, y, w: (y, w)

    def grad(F, y, w):
        return ((y[:, None] == torch.arange(K)).float(),
                w[:, None].expand(-1, K))
    return grad


def _scanned(bins, t, n_iters, depth, cap, pst_sample=None, K=1, offset=0,
             seed=11):
    """``build_trees_scanned`` on the CPU with a DRF-style gradient (leaf =
    node mean), rates ``pst_sample`` = (rows, per split, per tree)."""
    n, C = bins.shape
    rates = pst_sample or (1.0, 1.0, 1.0)
    F = torch.zeros(n) if K == 1 else torch.zeros(n, K)
    return pst.build_trees_scanned(
        torch.from_numpy(bins), torch.ones(n), torch.from_numpy(t), F,
        torch.zeros(C), n_iters, grad_fn=_drf_grad(K), grad_key=("drf", K),
        n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=depth,
        min_rows=1.0, min_split_improvement=0.0,
        learn_rates=np.ones(n_iters, np.float32), node_cap=cap, n_classes=K,
        seed=seed, tree_offset=offset, sample_rate=rates[0],
        col_sample_rate=rates[1], col_sample_rate_per_tree=rates[2])


def _eager(bins, t, n_iters, depth, cap, rates, K=1, seed=11, grad=None,
           learn_rate=1.0):
    """The eager per-level loop over the same iterations: the row
    bootstrap per iteration, then K class trees keyed by class."""
    n, C = bins.shape
    smp = sampling.Sampling(seed, *rates)
    grad = grad or _drf_grad(K)
    F = torch.zeros(n, K)
    vi = torch.zeros(C)
    y, w = torch.from_numpy(t), torch.ones(n)
    trees = []
    for m in range(n_iters):
        w_tree = smp.rows(m, w)
        T, H = grad(F if K > 1 else F[:, 0], y, w_tree)
        if K == 1:
            T, H = T[:, None], H[:, None]
        cols = []
        for k in range(K):
            tree, fk, vi = pst.build_tree(
                torch.from_numpy(bins), w_tree, T[:, k], H[:, k], n_bins=16,
                is_cat_cols=np.zeros(C, bool), max_depth=depth, min_rows=1.0,
                min_split_improvement=0.0, learn_rate=learn_rate,
                preds=F[:, k].clone(), varimp=vi, node_cap=cap, sample=smp,
                iteration=m, cls=k)
            trees.append(tree)
            cols.append(fk)
        F = torch.stack(cols, 1)
    return trees, (F[:, 0] if K == 1 else F), vi


def _assert_whole_equals_eager(stk, eager_trees):
    whole = pst.trees_from_stacked(stk, len(eager_trees))
    for i, tree in enumerate(eager_trees):
        levels = tree.to_host().levels
        for li, lv in enumerate(levels):
            for f in pst._REC_FIELDS:
                assert getattr(lv, f).tobytes() == \
                    getattr(whole[i].levels[li], f).tobytes(), (i, li, f)
        for lv in whole[i].levels[len(levels):]:
            assert lv.leaf_now.all() and not lv.leaf_val.any()


@pytest.mark.parametrize("K", [1, 3], ids=["binomial-drf", "multinomial-drf"])
@pytest.mark.parametrize("cap", [2048, 8], ids=["open", "saturated"])
def test_whole_tree_draws_what_the_eager_loop_draws(K, cap):
    """DRF-style trees (bootstrap 0.632, per-split rate 0.5) at depth 8:
    the whole-tree build and the eager loop record the same trees, every
    field bit-equal, with a saturated run (node_cap 8: levels 3..7) and
    without; F and varimp equal."""
    bins, t, _ = _int_suite()
    if K > 1:
        t = np.clip(t, 0, K - 1).astype(np.float32)
    rates = (0.632, 0.5, 1.0)
    wF, wvi, stk = _scanned(bins, t, 3, 8, cap, rates, K=K)
    trees, F, vi = _eager(bins, t, 3, 8, cap, rates, K=K)
    _assert_whole_equals_eager(stk, trees)
    assert torch.equal(wF, F) and torch.equal(wvi, vi)


@pytest.mark.parametrize("cap", [2048, 8], ids=["open", "saturated"])
def test_whole_tree_gbm_with_all_three_rates_equals_eager(cap):
    """Trees at learn rate 0.5 with all three rates at 0.8 (GBM's draws),
    each from F = 0 on integer targets, at depth 8: whole-tree and eager
    records bit-equal, saturated run included."""
    bins, t, _ = _int_suite()
    n, C = bins.shape

    def grad(F, y, w):
        return y, w  # integer targets, hessian = the bootstrapped weight

    rates = (0.8, 0.8, 0.8)
    smp = sampling.Sampling(5, *rates)
    for it in range(3):  # one tree per iteration, each from F = 0
        _, _, stk = pst.build_trees_scanned(
            torch.from_numpy(bins), torch.ones(n), torch.from_numpy(t),
            torch.zeros(n), torch.zeros(C), 1, grad_fn=grad,
            grad_key=("gbm-int",), n_bins=16, is_cat_cols=np.zeros(C, bool),
            max_depth=8, min_rows=1.0, min_split_improvement=0.0,
            learn_rates=np.float32([0.5]), node_cap=cap, seed=5,
            tree_offset=it, sample_rate=rates[0], col_sample_rate=rates[1],
            col_sample_rate_per_tree=rates[2])
        w_tree = smp.rows(it, torch.ones(n))
        tree, _, _ = pst.build_tree(
            torch.from_numpy(bins), w_tree, torch.from_numpy(t), w_tree,
            n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=8,
            min_rows=1.0, min_split_improvement=0.0, learn_rate=0.5,
            preds=torch.zeros(n), varimp=torch.zeros(C), node_cap=cap,
            sample=smp, iteration=it)
        _assert_whole_equals_eager(stk, [tree])
        # the tree really sampled: its root holds the bootstrap's rows
        assert float(stk[0]["node_w"][0, 0]) == float(w_tree.sum()) < n


def test_trees_of_a_chunk_draw_different_bootstraps():
    """Three iterations of one chunk: each root covers its own keyed
    bootstrap (root cover = the mask's row count), and no two agree."""
    bins, t, _ = _int_suite()
    n = len(t)
    _, _, stk = _scanned(bins, t, 3, 4, 16, (0.632, 1.0, 1.0), seed=21)
    h = sampling.index_hash(n, "cpu")
    covers = stk[0]["node_w"][:, 0].tolist()
    want = [float(sampling.row_mask(sampling.seed_key(21), m, 0.632, h).sum())
            for m in range(3)]
    assert covers == want and len(set(covers)) == 3


def test_class_trees_share_the_bootstrap_and_draw_their_own_columns():
    """Multinomial DRF-style iteration (K = 3, per-tree column rate 0.5):
    the three class trees' roots cover the same bootstrap, each tree
    splits only on the columns keyed to its class, and the classes draw
    different column sets."""
    bins, t, _ = _int_suite(C=8)
    t = np.clip(t, 0, 2).astype(np.float32)
    n, C = bins.shape
    _, _, stk = _scanned(bins, t, 2, 5, 32, (0.632, 1.0, 0.5), K=3, seed=4)
    covers = stk[0]["node_w"][:, 0].reshape(2, 3)
    assert torch.equal(covers, covers[:, :1].expand(2, 3))
    h = sampling.index_hash(C, "cpu")
    trees = pst.trees_from_stacked(stk, 6)
    drawn = []
    for slot, tree in enumerate(trees):
        m, k = divmod(slot, 3)
        cols = sampling.tree_cols(sampling.seed_key(4), m, k, 0.5, C, h)
        drawn.append(tuple(cols.tolist()))
        for lv, real in zip(tree.levels, tree.real_level_masks()):
            used = lv.split_col[~lv.leaf_now & real]
            assert cols[torch.from_numpy(used).long()].all(), (slot, used)
    assert len(set(drawn[:3])) > 1


def test_chunks_of_2_and_5_grow_the_same_forest():
    """The keys are global iterations, so scoring every 2 trees or every 5
    (chunks of 2 and 5 whole trees) grows the same sampled GBM and the
    same DRF, tree for tree."""
    df = _frame_df(n=1500, seed=4)
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    for est_cls, kw in (
            (H2OGradientBoostingEstimator,
             dict(ntrees=10, max_depth=4, sample_rate=0.7,
                  col_sample_rate=0.6, col_sample_rate_per_tree=0.8,
                  seed=9)),
            (H2ORandomForestEstimator, dict(ntrees=10, max_depth=6,
                                            seed=9))):
        models = []
        for interval in (2, 5):
            est = est_cls(score_tree_interval=interval, **kw)
            est.train(y="label", training_frame=fr)
            models.append(est)
        a, b = (m.model.output["trees"] for m in models)
        assert len(a) == len(b) == 10
        for ga, gb in zip(a, b):
            for la, lb in zip(ga[0].to_host().levels, gb[0].to_host().levels):
                for f in pst.REPLAY_FIELDS:
                    assert np.array_equal(getattr(la, f), getattr(lb, f)), f
        pa, pb = (m.predict(fr).vec("s").to_numpy() for m in models)
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.parametrize("algo", ["gbm", "drf-multinomial"])
def test_sampled_training_whole_tree_equals_eager(algo, monkeypatch):
    """Through the estimators: a sampled GBM (all three rates 0.8) and a
    multinomial DRF at its defaults, trained by the whole-tree build and
    by the eager loop (``H2O3_TPU_WHOLE_TREE=0``), grow the same trees and
    predict the same (the same masks drawn on both paths)."""
    if algo == "gbm":
        df, y, cls = _frame_df(n=1500, seed=6), "label", ("b", "s")
        make = lambda: H2OGradientBoostingEstimator(  # noqa: E731
            ntrees=6, max_depth=4, sample_rate=0.8, col_sample_rate=0.8,
            col_sample_rate_per_tree=0.8, seed=2, score_tree_interval=4)
    else:
        df, y, cls = multiclass_df(n=1500, seed=6), "label", ("u", "v", "w")
        make = lambda: H2ORandomForestEstimator(  # noqa: E731
            ntrees=4, max_depth=8, seed=2, score_tree_interval=3)
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    out = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", mode)
        est = make()
        est.train(y=y, training_frame=fr)
        out[mode] = est
    g, e = out["1"], out["0"]
    for gg, ge in zip(g.model.output["trees"], e.model.output["trees"]):
        for tg, te in zip(gg, ge):
            levels = te.to_host().levels
            for la, lb in zip(levels, tg.to_host().levels):
                for f in pst.REPLAY_FIELDS:
                    assert np.array_equal(getattr(la, f), getattr(lb, f)), f
    pg = np.stack([g.predict(fr).vec(c).to_numpy() for c in cls], 1)
    pe = np.stack([e.predict(fr).vec(c).to_numpy() for c in cls], 1)
    np.testing.assert_array_equal(pg, pe)


# (JAX builder, port estimator, parameters, training rows, margin): DRF at
# its defaults (depth 20, min_rows 1, sample_rate 0.632, mtries sqrt(C))
# cut to 5 trees and 400 rows, since JAX's depth-20 program takes ~20 s to
# compile and ~4 s a training on the CPU; GBM with all three rates at 0.8
_BY_DIST = {
    "drf-defaults": (JDRF, H2ORandomForestEstimator, dict(ntrees=5), 400,
                     0.015),
    "gbm-rates-0.8": (JGBM, H2OGradientBoostingEstimator,
                      dict(ntrees=20, max_depth=5, sample_rate=0.8,
                           col_sample_rate=0.8, col_sample_rate_per_tree=0.8),
                      2000, 0.004),
}


@pytest.mark.parametrize("case", list(_BY_DIST))
def test_sampled_models_match_jax_by_distribution(case):
    """Held-out AUC (2,000 rows) of models trained with their draws: the
    port's mean over seeds 1-3 within JAX's spread over seeds 1-5 widened
    by the margin (module docstring)."""
    jcls, pcls, kw, n, margin = _BY_DIST[case]
    train, test = _frame_df(n=n, seed=0), _frame_df(n=2000, seed=1)
    y = (test["label"].to_numpy() == "s").astype(np.float64)

    def auc(p):
        return PM.binomial_metrics(y, np.asarray(p, np.float64))._v["auc"]

    jtr, jte = JFrame.from_pandas(train), JFrame.from_pandas(test)
    jax_aucs = []
    for seed in range(1, 6):
        m = jcls(seed=seed, **kw).train(y="label", training_frame=jtr)
        jax_aucs.append(auc(m.predict(jte).vec("s").to_numpy()[:2000]))
    ptr, pte = (h2o3_tpu_torch.upload_file(d, device="cpu")
                for d in (train, test))
    port_aucs = []
    for seed in range(1, 4):
        est = pcls(seed=seed, **kw)
        est.train(y="label", training_frame=ptr)
        port_aucs.append(auc(est.predict(pte).vec("s").to_numpy()))
    got = float(np.mean(port_aucs))
    assert min(jax_aucs) - margin <= got <= max(jax_aucs) + margin, (
        port_aucs, jax_aucs)
