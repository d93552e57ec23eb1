"""The port's whole-tree build (``shared_tree.WholeTreeBuilder``,
``build_trees_scanned``, ``trees_from_stacked``, ``replay_batch``) and the
GBM interval loop (scoring history, early stopping, validation frame)
against the JAX package and against the port's eager per-level loop, on the
CPU at small sizes. Inputs are made with numpy from seeds.

Tolerances, with their reasons:
- whole-tree records on integer-exact suites: every field of every tree and
  level bit-equal, placeholders included, and F and varimp equal (each tree
  sees the same integer targets, so every histogram sum is exact and the
  float32 leaf arithmetic runs the same ops in the same order);
- replay of stacked records: exact (the same adds in the same order);
- whole GBMs against JAX: training metrics within 1e-5, validation AUC
  within 1e-3 and logloss within 1e-5 (JAX sums histograms across an
  8-device mesh, the port on one device, so float32 sums round
  differently); scoring-history tree counts and the early-stop tree count
  exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree import GBM as JGBM  # noqa: E402
from h2o3_tpu.models.tree import shared_tree as jst  # noqa: E402
from h2o3_tpu.parallel import mesh as pm  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator  # noqa: E402
from h2o3_tpu_torch.models.model_base import ScoreKeeper  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from test_torch_slice import _frame_df, _tie_suite  # noqa: E402

_LRS = np.array([0.1, 0.05, 0.025], np.float32)  # annealed: lrs by slot


def _suite(name):
    """(bins, integer targets, max_depth, min_split_improvement, node_cap).
    ``stops-early`` is pure after one split, so every later level splits
    nothing; ``sat-*`` cap the frontier at 8 nodes so depths 3.. form a
    saturated run, which ``sat-dies`` stops splitting inside; ``deep`` is
    24 levels, deeper than JAX builds whole (``H2O3_TPU_FUSED_MAX_DEPTH``,
    20), which the port builds whole at any depth."""
    if name in ("duplicated-columns", "integer-targets-na"):
        bins, t = _tie_suite(name)
        return bins, t, 3, 0.0, 2048
    rng = np.random.default_rng(3)
    bins = rng.integers(0, 16, (960, 6)).astype(np.uint8)
    if name == "stops-early":
        return bins, np.where(bins[:, 0] > 8, 2.0, -1.0).astype(
            np.float32), 5, 1e-5, 2048
    if name in ("sat-alive", "deep"):  # deep: past JAX's whole-tree bound
        return bins, rng.integers(-3, 4, 960).astype(np.float32), \
            7 if name == "sat-alive" else 24, 0.0, 8
    t = (2.0 * (bins[:, 0] > 8) + (bins[:, 1] > 4) - (bins[:, 2] > 10))
    return bins, t.astype(np.float32), 6, 1e-5, 8  # sat-dies


def _mono(C):
    return np.array([1, 0, -1] + [0] * (C - 3), np.int32)


def _port_scanned(name, mono=None):
    bins, t, depth, msi, cap = _suite(name)
    n, C = bins.shape
    return pst.build_trees_scanned(
        torch.from_numpy(bins), torch.ones(n), torch.from_numpy(t),
        torch.zeros(n), torch.zeros(C), len(_LRS),
        grad_fn=lambda F, y, w: (y, torch.ones_like(F)),
        grad_key=("tie", name), n_bins=16, is_cat_cols=np.zeros(C, bool),
        max_depth=depth, min_rows=1.0, min_split_improvement=msi,
        learn_rates=_LRS, node_cap=cap, monotone=mono)


@pytest.mark.parametrize("suite,mono", [
    ("duplicated-columns", False), ("integer-targets-na", False),
    ("stops-early", False), ("sat-dies", False), ("integer-targets-na", True),
])
def test_whole_tree_bit_equal_to_jax_build_trees_scanned(suite, mono):
    """The port's whole-tree build on the CPU against JAX's
    ``build_trees_scanned`` (default CPU settings, 8-device mesh), three
    trees at annealed learning rates: every stacked record field bit-equal
    (levels after the tree stopped splitting, and the saturated run's
    placeholders, included), F and varimp equal."""
    bins, t, depth, msi, cap = _suite(suite)
    n, C = bins.shape
    mv = _mono(C) if mono else None
    jF, jvi, jstk = jst.build_trees_scanned(
        pm.shard_rows(jnp.asarray(bins)), pm.shard_rows(jnp.ones(n)),
        pm.shard_rows(jnp.asarray(t)), pm.shard_rows(jnp.zeros(n)),
        jnp.zeros(C, jnp.float32), jax.random.PRNGKey(0), len(_LRS),
        grad_fn=lambda F_, y_, w_: (y_, jnp.ones_like(F_)),
        grad_key=("tie", suite), sample_rate=1.0, n_bins=16,
        is_cat_cols=np.zeros(C, bool), max_depth=depth, min_rows=1.0,
        min_split_improvement=msi, learn_rates=_LRS,
        max_abs_leaf=float("inf"), col_sample_rate=1.0,
        col_sample_rate_per_tree=1.0, node_cap=cap, monotone=mv)
    pF, pvi, pstk = _port_scanned(suite, mv)
    assert len(pstk) == len(jstk) == depth + 1
    for li, (a, b) in enumerate(zip(pstk, jstk)):
        assert a.keys() == b.keys()
        for f in a:
            bv = np.asarray(b[f])
            assert a[f].numpy().dtype == bv.dtype, (li, f)
            assert a[f].numpy().tobytes() == bv.tobytes(), (li, f)
    assert pF.numpy().tobytes() == np.asarray(jF).tobytes()
    assert pvi.numpy().tobytes() == np.asarray(jvi).tobytes()
    if suite == "sat-dies":  # the run died inside: placeholders follow
        last = pstk[-2]
        assert last["leaf_now"].all() and not last["split_bin"].any()
        assert not last["na_left"].any() and not last["node_w"].any()


@pytest.mark.parametrize("mono", [False, True], ids=["b2", "b3"])
@pytest.mark.parametrize("suite", ["duplicated-columns", "integer-targets-na",
                                   "stops-early", "sat-alive", "sat-dies",
                                   "deep"])
def test_whole_tree_matches_eager_build_tree(suite, mono):
    """The whole-tree build against the port's eager ``build_tree`` tree by
    tree: the levels the eager loop built bit-equal; the levels it skipped
    (it stops once a level splits nothing) all-leaf with zero leaf values;
    F and varimp equal."""
    bins, t, depth, msi, cap = _suite(suite)
    n, C = bins.shape
    mv = _mono(C) if mono else None
    wF, wvi, stk = _port_scanned(suite, mv)
    trees = pst.trees_from_stacked(stk, len(_LRS))
    F, vi = torch.zeros(n), torch.zeros(C)
    ones = torch.ones(n)
    for k, lr in enumerate(_LRS):
        tree, F, vi = pst.build_tree(
            torch.from_numpy(bins), ones, torch.from_numpy(t), ones,
            n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=depth,
            min_rows=1.0, min_split_improvement=msi, learn_rate=float(lr),
            preds=F, varimp=vi, node_cap=cap, monotone=mv)
        eager = tree.to_host().levels
        whole = trees[k].levels
        for li, lv in enumerate(eager):
            for f in pst._REC_FIELDS:
                assert getattr(lv, f).tobytes() == \
                    getattr(whole[li], f).tobytes(), (k, li, f)
        for lv in whole[len(eager):]:
            assert lv.leaf_now.all() and not lv.leaf_val.any()
    assert torch.equal(F, wF) and torch.equal(vi, wvi)


def test_saturated_replay_schedule_equals_early_exit():
    """The card's schedule (every saturated level replayed until a sparse
    host read, so levels after the frontier died run and must record
    placeholders) against the CPU's early exit, on the same bodies."""
    bins, t, depth, msi, cap = _suite("sat-dies")
    n, C = bins.shape
    kw = dict(grad_fn=lambda F, y, w: (y, torch.ones_like(F)),
              grad_key=("tie",), n_bins=16, is_cat_cols=np.zeros(C, bool),
              max_depth=depth, min_rows=1.0, min_split_improvement=msi,
              max_abs_leaf=float("inf"), chunk_cap=len(_LRS), node_cap=cap)
    args = (torch.from_numpy(bins), torch.ones(n), torch.from_numpy(t),
            torch.zeros(n), torch.zeros(C))
    early = pst.WholeTreeBuilder(*args, **kw)
    s_early = early.build(_LRS)
    every = pst.WholeTreeBuilder(*args, **kw)
    st = every.state
    st.new_chunk(_LRS)
    start, n_sat = every.plan.sat
    assert (start, n_sat) == (3, 3)
    for _ in _LRS:
        pst._tree_head(st)
        for _ in range(n_sat):
            pst._sat_level(st)
        pst._tree_tail(st)
    s_every = st.stacked(len(_LRS))
    assert int(early.state.c_nsplit) == 0  # the early exit did skip levels
    for a, b in zip(s_early, s_every):
        for f in a:
            assert torch.equal(a[f], b[f]), f
    assert torch.equal(early.F, every.F)
    assert torch.equal(early.varimp, every.varimp)


def test_trees_from_stacked_round_trip_and_replay_batch():
    """One pull per chunk gives every field of every tree and level back
    (dtype and bytes); replaying the stacked chunk equals replaying its
    trees one by one, and both give the build's F (all exact)."""
    bins, t, depth, msi, cap = _suite("integer-targets-na")
    F, _, stk = _port_scanned("integer-targets-na")
    trees = pst.trees_from_stacked(stk, len(_LRS))
    assert len(trees) == len(_LRS)
    for k, tree in enumerate(trees):
        assert len(tree.levels) == len(stk)
        for lv, rec in zip(tree.levels, stk):
            for f, v in rec.items():
                got = getattr(lv, f)
                assert isinstance(got, np.ndarray)
                assert got.dtype == v.numpy().dtype
                assert got.tobytes() == v[k].numpy().tobytes(), f
    b = torch.from_numpy(bins)
    batch = pst.replay_batch(b, stk, torch.zeros(len(b)))
    one = torch.zeros(len(b))
    for tree in trees:
        _, one = tree.replay(b, torch.zeros(len(b), dtype=torch.int32), one)
    assert torch.equal(batch, one) and torch.equal(batch, F)


@pytest.mark.parametrize("depth,n_bins,node_cap", [
    (6, 256, 2048), (4, 16, 2048), (12, 256, 2048), (20, 64, 1024),
    (3, 1024, 8)])
def test_scan_chunk_cap_and_saturated_run_match_jax(depth, n_bins, node_cap):
    assert pst.scan_chunk_cap(depth, n_bins, node_cap) == \
        jst.scan_chunk_cap(depth, n_bins, node_cap)
    assert pst._sat_region(depth, node_cap) == \
        jst._sat_region(depth, node_cap, [0] * (depth + 1))


@pytest.mark.parametrize("value,expect", [
    ("1", True), ("0", False)])
def test_use_fused_trees_follows_the_jax_knobs(monkeypatch, value, expect):
    """Both read ``H2O3_TPU_WHOLE_TREE``; JAX's depth bound
    (``H2O3_TPU_FUSED_MAX_DEPTH``, 20) has no counterpart in the port."""
    monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", value)
    assert pst.use_fused_trees() == expect
    for depth in (6, 20):
        assert jst.use_fused_trees(depth) == expect
    assert not jst.use_fused_trees(21)


# ---------------------------------------------------------------------------
# whole GBMs: scoring history, early stopping, validation frame

_GBM = dict(ntrees=7, max_depth=3, learn_rate=0.2, min_rows=10.0, seed=42,
            score_tree_interval=3)


@pytest.fixture(scope="module")
def frames():
    df = _frame_df(n=3000, seed=0)
    dv = _frame_df(n=1000, seed=1)
    return ((JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")),
            (JFrame.from_pandas(dv), h2o3_tpu_torch.upload_file(dv, device="cpu")))


@pytest.fixture(scope="module")
def jax_gbm(frames):
    """One JAX GBM (its default scanned path) with a validation frame."""
    (jt, _), (jv, _) = frames
    return JGBM(**_GBM).train(y="label", training_frame=jt,
                              validation_frame=jv)


def _port_gbm(frames, monkeypatch, path, **kw):
    monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", "1" if path == "whole" else "0")
    (_, pt), (_, pv) = frames
    est = H2OGradientBoostingEstimator(**{**_GBM, **kw})
    est.train(y="label", training_frame=pt, validation_frame=pv)
    return est.model


@pytest.mark.parametrize("path", ["whole", "eager"])
def test_gbm_scoring_history_and_validation_match_jax(frames, jax_gbm,
                                                      monkeypatch, path):
    """7 trees at score_tree_interval 3 score after 3, 6 and 7 trees (the
    whole-tree path builds chunks of 3/3/1); each entry's training and
    validation logloss within 1e-5 of JAX's; the validation metrics within
    1e-3 (AUC) and 1e-5 (logloss)."""
    m = _port_gbm(frames, monkeypatch, path)
    jh = jax_gbm.scoring_history
    assert [h["ntrees"] for h in m.scoring_history] == \
        [h["ntrees"] for h in jh] == [3, 6, 7]
    for a, b in zip(m.scoring_history, jh):
        assert a.keys() == b.keys() == {
            "ntrees", "training_logloss", "validation_logloss"}
        for k in ("training_logloss", "validation_logloss"):
            assert abs(a[k] - b[k]) < 1e-5, (a, b)
    jvm = jax_gbm.validation_metrics
    assert abs(m.validation_metrics.auc - jvm.auc) < 1e-3
    assert abs(m.validation_metrics.logloss - jvm.logloss) < 1e-5
    assert abs(m.training_metrics.logloss
               - jax_gbm.training_metrics.logloss) < 1e-5
    assert len(m.output["trees"]) == m.output["ntrees_actual"] == 7


def test_gbm_early_stopping_matches_jax(frames, monkeypatch):
    """stopping_rounds with stopping_metric AUC on the validation frame:
    the same stop tree count as JAX, before ntrees."""
    kw = dict(ntrees=30, score_tree_interval=1, stopping_rounds=2,
              stopping_metric="AUC", stopping_tolerance=0.01)
    (jt, _), (jv, _) = frames
    jm = JGBM(**{**_GBM, **kw}).train(y="label", training_frame=jt,
                                      validation_frame=jv)
    pmod = _port_gbm(frames, monkeypatch, "whole", **kw)
    assert pmod.output["ntrees_actual"] == jm.output["ntrees_actual"] < 30
    assert [h["ntrees"] for h in pmod.scoring_history] == \
        [h["ntrees"] for h in jm.scoring_history]


def test_gbm_stops_on_mean_per_class_error_as_jax(frames, monkeypatch):
    """stopping_metric mean_per_class_error on the CPU (the exact host
    metrics carry it, so no fallback to logloss): the same scoring history
    and stop tree count as JAX."""
    kw = dict(ntrees=30, score_tree_interval=1, stopping_rounds=2,
              stopping_metric="mean_per_class_error", stopping_tolerance=0.01)
    (jt, _), (jv, _) = frames
    jm = JGBM(**{**_GBM, **kw}).train(y="label", training_frame=jt,
                                      validation_frame=jv)
    pmod = _port_gbm(frames, monkeypatch, "whole", **kw)
    assert pmod.output["ntrees_actual"] == jm.output["ntrees_actual"] < 30
    for a, b in zip(pmod.scoring_history, jm.scoring_history, strict=True):
        assert a.keys() == b.keys() == {
            "ntrees", "training_mean_per_class_error",
            "validation_mean_per_class_error"}
        for k in a:
            assert abs(a[k] - b[k]) < 1e-5, (a, b)


@pytest.mark.parametrize("rounds,tol,larger,scores,stop", [
    (2, 1e-3, False, [0.5, 0.4, 0.3, 0.29, 0.3, 0.31], True),
    (2, 1e-3, False, [0.5, 0.4, 0.3, 0.2], False),
    (1, 0.01, True, [0.7, 0.8, 0.805], True),
    (0, 0.0, True, [0.1, 0.1, 0.1], False),
])
def test_score_keeper_matches_jax(rounds, tol, larger, scores, stop):
    from h2o3_tpu.models.model_base import ScoreKeeper as JKeeper

    a, b = ScoreKeeper(rounds, tol, larger), JKeeper(rounds, tol, larger)
    for v in scores:
        a.record(v)
        b.record(v)
        assert a.should_stop() == b.should_stop()
    assert a.should_stop() is stop


@pytest.mark.parametrize("metric,classification", [
    ("AUTO", True), ("AUTO", False), ("deviance", True),
    ("deviance", False), ("AUC", True), ("r2", False), ("MSE", False)])
def test_stopping_metric_direction_matches_jax(metric, classification):
    from h2o3_tpu.models.model_base import stopping_metric_direction as jdir
    from h2o3_tpu_torch.models.model_base import stopping_metric_direction

    assert stopping_metric_direction(metric, classification, 2) == \
        jdir(metric, classification, 2)
