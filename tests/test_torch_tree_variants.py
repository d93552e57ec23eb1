"""The tree builder's variants in the port (``h2o3_tpu_torch``) against the
JAX package on the CPU, at small sizes, inputs made with numpy from seeds:
GOSS (``H2O3_TPU_TREE_GOSS``), the int16 histogram lane
(``H2O3_TPU_HIST_I16``), per-level bin coarsening (``H2O3_TPU_BIN_ADAPT``),
exclusive feature bundling (``H2O3_TPU_TREE_EFB``), lossguide growth
(``grow_policy``/``max_leaves``) and the u8 code cache
(``H2O3_TPU_TREE_U8CACHE``).

Tolerances, with their reasons:
- knob parsing, bin shifts, coarsened codes and histograms, the EFB plan
  and its expansion, the i16 histogram on integer stats: equal exactly
  (integer arithmetic, or float sums of integers below 2^24);
- the i16 histogram on float stats: JAX's envelope, the quantization step
  times half the cell's row count (``tests/test_wave2.py``);
- GOSS's factor: equal at ``b = 1 - a`` (every rest row kept at
  amplification 1); at ``b < 1 - a`` the top set equal and the kept share
  of the rest within 5 binomial standard deviations of ``b / (1 - a)``
  (torch cannot reproduce ``jax.random``'s draw);
- whole-tree records and GBMs on integer-valued features and targets
  (learning rate 0.5): split columns, bins, NA directions and leaves equal,
  predictions within 1e-5 (every histogram sum is an exact integer sum).

JAX's reference trainings are module fixtures, so that each compiles once.
"""

import contextlib
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.frame import ops as jops  # noqa: E402,F401  (frame[...] = v)
from h2o3_tpu.models.tree import GBM as JGBM  # noqa: E402
from h2o3_tpu.models.tree import binning as jbin  # noqa: E402
from h2o3_tpu.models.tree import shared_tree as jst  # noqa: E402
from h2o3_tpu.ops import histogram as jh  # noqa: E402
from h2o3_tpu.parallel import mesh as pm  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator  # noqa: E402
from h2o3_tpu_torch.frame import ops as pops  # noqa: E402,F401
from h2o3_tpu_torch.models.tree import binning as pbin  # noqa: E402
from h2o3_tpu_torch.models.tree import sampling  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.ops import histogram as ph  # noqa: E402

_VARIANT_KNOBS = ("H2O3_TPU_TREE_GOSS", "H2O3_TPU_TREE_EFB",
                  "H2O3_TPU_HIST_I16", "H2O3_TPU_BIN_ADAPT",
                  "H2O3_TPU_WHOLE_TREE", "H2O3_TPU_TREE_U8CACHE")


@contextlib.contextmanager
def _env(**values):
    """The variant knobs unset but for ``values`` in the block."""
    old = {k: os.environ.get(k) for k in (*_VARIANT_KNOBS, *values)}
    for k in _VARIANT_KNOBS:
        os.environ.pop(k, None)
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _int_df(n=2400, c=4, hi=20, seed=0) -> pd.DataFrame:
    """Integer-valued features in [0, hi) and an integer target."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, hi, (n, c)).astype(np.float32)
    y = (2 * (X[:, 0] > hi // 2) + (X[:, 1] > hi // 3) - (X[:, 2] > hi // 4)
         + rng.integers(-1, 2, n)).astype(np.float32)
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(c)])
    df["y"] = y
    return df


_GBM_KW = dict(ntrees=3, max_depth=3, min_rows=5.0, learn_rate=0.5,
               seed=3, distribution="gaussian")


def _train_both(df, env, **kw):
    """(JAX model, port model, JAX predictions, port predictions) of one
    GBM on ``df`` under the knobs ``env``."""
    kw = {**_GBM_KW, **kw}
    with _env(**env):
        jm = JGBM(**kw).train(y="y", training_frame=JFrame.from_pandas(df))
        pm_ = H2OGradientBoostingEstimator(**kw).train(
            y="y", training_frame=h2o3_tpu_torch.upload_file(
                df, device="cpu")).model
    jf = JFrame.from_pandas(df)
    jp = jm.predict(jf).vec("predict").to_numpy()[: len(df)]
    pp = pm_.predict(h2o3_tpu_torch.upload_file(df, device="cpu")).vec(
        "predict").to_numpy()
    return jm, pm_, jp, pp


def _splits(tree) -> list:
    """(level, node, column, bin, NA left) of every real split and (level,
    node) of every real leaf, from host arrays of either package."""
    out, n_real = [], 1
    for li, lv in enumerate(tree.levels):
        leaf = np.asarray(lv.leaf_now)
        real = np.arange(len(leaf)) < n_real
        for node in np.nonzero(real)[0]:
            if leaf[node]:
                out.append((li, int(node), "leaf"))
            else:
                out.append((li, int(node), int(np.asarray(lv.split_col)[node]),
                            int(np.asarray(lv.split_bin)[node]),
                            bool(np.asarray(lv.na_left)[node])))
        n_real = 2 * int(np.sum(~leaf & real))
    return out


def _forest_splits(model) -> list:
    return [_splits(t) for g in model.output["trees"] for t in g]


# ---------------------------------------------------------------------------
# GOSS


@pytest.mark.parametrize("raw", ["", "  ", "0.2,0.1", "0,0.5", "0.3,0.7",
                                 "0.2", "a,b", "1.0,0.1", "0.2,0", "0.5,0.6"])
def test_goss_ab_parses_as_jax(monkeypatch, raw):
    """The knob's value, or its error and message, as JAX's ``_goss_ab``."""
    monkeypatch.setenv("H2O3_TPU_TREE_GOSS", raw)
    try:
        want = jst._goss_ab()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pst._goss_ab()
        assert str(got.value) == str(e)
    else:
        assert pst._goss_ab() == want


def _goss_inputs(n=4000, seed=0):
    """Weights with bootstrap zeros, |wy| with ties at several values."""
    rng = np.random.default_rng(seed)
    w = (rng.random(n) < 0.8).astype(np.float32)
    wy = (rng.integers(-40, 41, n) / 8.0).astype(np.float32) * w
    return w, wy


def test_goss_factor_exact_at_b_one_minus_a():
    """At ``b = 1 - a`` the factor is fully determined: 1 on every valid
    row, 0 elsewhere, as JAX's, top set included (ties at the threshold
    kept)."""
    w, wy = _goss_inputs()
    for a in (0.0, 0.2, 0.37):
        j = np.asarray(jst._goss_factor(jnp.asarray(w), jnp.asarray(wy),
                                        jax.random.PRNGKey(1), a, 1.0 - a))
        p = pst._goss_factor(torch.from_numpy(w), torch.from_numpy(wy),
                             sampling.goss_key(5, 0, 0), a, 1.0 - a,
                             sampling.index_hash(len(w), "cpu")).numpy()
        np.testing.assert_array_equal(p, j)


def test_goss_factor_top_set_and_rest_share():
    """At ``b < 1 - a``: the rows at factor 1 (the top set, rank-k
    threshold over the valid rows, half-to-even k, ties kept) are JAX's;
    the amplification is JAX's (1-a)/b; the kept share of the rest is
    within 5 binomial standard deviations of b/(1-a); invalid rows get 0."""
    w, wy = _goss_inputs(20000, seed=1)
    a, b = 0.2, 0.1
    j = np.asarray(jst._goss_factor(jnp.asarray(w), jnp.asarray(wy),
                                    jax.random.PRNGKey(2), a, b))
    p = pst._goss_factor(torch.from_numpy(w), torch.from_numpy(wy),
                         sampling.goss_key(7, 3, 0), a, b,
                         sampling.index_hash(len(w), "cpu")).numpy()
    np.testing.assert_array_equal(p == 1.0, j == 1.0)
    amp = np.float32((1.0 - a) / b)
    assert set(np.unique(p)) <= {0.0, 1.0, amp}
    assert not p[w == 0].any()
    rest = (w > 0) & (p != 1.0)
    q = b / (1.0 - a)
    share = (p[rest] == amp).mean()
    assert abs(share - q) < 5 * np.sqrt(q * (1 - q) / rest.sum())


def test_goss_applies_after_the_bootstrap(monkeypatch):
    """GOSS ranks only the rows the iteration's bootstrap kept: a row out
    of the bootstrap has factor 0 in the whole-tree build, and the kept
    rows are at least the top share of the bootstrapped rows."""
    monkeypatch.setenv("H2O3_TPU_TREE_GOSS", "0.3,0.2")
    rng = np.random.default_rng(4)
    n, C = 3000, 4
    bins = torch.from_numpy(rng.integers(0, 16, (n, C)).astype(np.uint8))
    t = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    smp = sampling.Sampling(11, sample_rate=0.6)
    b = pst.WholeTreeBuilder(
        bins, torch.ones(n), t, torch.zeros(n), torch.zeros(C),
        grad_fn=lambda F, y, w: (y - F, torch.ones_like(F)),
        grad_key=("goss-test",), n_bins=16, is_cat_cols=np.zeros(C, bool),
        max_depth=2, min_rows=1.0, min_split_improvement=0.0,
        max_abs_leaf=float("inf"), chunk_cap=1, sample=smp)
    st = b.state
    boot = pst._draw_rows(st)
    wy = boot * (t - st.F)
    key = sampling.goss_key(st.seed, pst._iteration(st), 0)
    gf = pst._goss_factor(boot, wy, key, 0.3, 0.2, st.row_hash)
    assert not gf[boot == 0].any()
    n_boot = int((boot > 0).sum())
    assert int((gf == 1.0).sum()) >= round(0.3 * n_boot)
    kept0 = pst.goss_stats()["rows_kept"]
    b.build([0.1])
    assert pst.goss_stats()["rows_kept"] - kept0 == int((gf > 0).sum())


@pytest.fixture(scope="module")
def goss_pair():
    df = _int_df(seed=1)
    return _train_both(df, {"H2O3_TPU_TREE_GOSS": "0.2,0.8"})


def test_goss_gbm_matches_jax(goss_pair):
    """A GBM with ``H2O3_TPU_TREE_GOSS="0.2,0.8"`` (b = 1 - a: the factor
    is determined) against JAX's: splits equal, predictions within 1e-5."""
    jm, pm_, jp, pp = goss_pair
    assert _forest_splits(pm_) == _forest_splits(jm)
    np.testing.assert_allclose(pp, jp, atol=1e-5)


def test_goss_eager_loop_equals_whole_tree(goss_pair):
    """The eager per-level loop (``H2O3_TPU_WHOLE_TREE=0``) draws GOSS by
    the same keys as the whole-tree build: the same forest at ``b <
    1 - a``."""
    df = _int_df(seed=1)
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    out = {}
    for mode in ("1", "0"):
        with _env(H2O3_TPU_TREE_GOSS="0.3,0.2", H2O3_TPU_WHOLE_TREE=mode):
            out[mode] = H2OGradientBoostingEstimator(**_GBM_KW).train(
                y="y", training_frame=fr).model
    assert _forest_splits(out["1"]) == _forest_splits(out["0"])
    assert _forest_splits(out["1"]) != _forest_splits(goss_pair[1])


def test_goss_streamed_lane_samples_each_block(monkeypatch):
    """Out of core, GOSS applies per row block (JAX's
    ``_stream_grad_prog``): every tree is sampled, each block keeps at
    least the top share of its valid rows, and the streamed model trains
    through several blocks."""
    from h2o3_tpu_torch.frame import chunkstore as cs

    df = _int_df(n=3000, seed=10)
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    with _env(H2O3_TPU_TREE_GOSS="0.2,0.1",
              H2O3_TPU_HBM_WINDOW_BYTES=str(48 * 1024)):
        before = pst.goss_stats()
        cs.LAST_STORE_STATS.clear()
        m = H2OGradientBoostingEstimator(**_GBM_KW).train(
            y="y", training_frame=fr).model
        after = pst.goss_stats()
        blocks = cs.LAST_STORE_STATS["n_blocks"]
    assert blocks > 1
    trees = after["trees"] - before["trees"]
    assert trees == _GBM_KW["ntrees"] == len(m.output["trees"])
    kept = (after["rows_kept"] - before["rows_kept"]) / trees
    assert 0.2 * len(df) <= kept <= len(df)


# ---------------------------------------------------------------------------
# the int16 lane


def _hist_case(seed=0, integer=True, n=3000, C=5, N=4, B=16):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, C)).astype(np.uint8)
    nid = rng.integers(-1, N, n).astype(np.int32)
    if integer:
        stats = rng.integers(-3, 4, (n, 3)).astype(np.float32)
        stats[:, 0] = np.abs(stats[:, 0])
    else:
        stats = rng.normal(size=(n, 3)).astype(np.float32)
    return bins, nid, stats


def _jax_i16(bins, nid, stats, N, B):
    s = jnp.where(jnp.asarray(nid >= 0)[:, None], jnp.asarray(stats), 0.0)
    h = jh._i16_local(jh._hist_scatter_local, jnp.asarray(bins),
                      jnp.asarray(nid), s, N, B)  # (C, N*B, S)
    C = bins.shape[1]
    return np.asarray(h).reshape(C, N, B, -1).transpose(1, 0, 2, 3)


def test_i16_histogram_equals_jax_on_integer_stats(monkeypatch):
    """Integer stats within 127 quantize at scale 1: the port's i16 lane,
    JAX's ``_i16_local`` over its scatter local and the float32 histogram
    are equal exactly; the accumulate form adds the same."""
    bins, nid, stats = _hist_case()
    monkeypatch.setenv("H2O3_TPU_HIST_I16", "1")
    args = (torch.from_numpy(bins), torch.from_numpy(nid),
            torch.from_numpy(stats))
    got = ph.histogram(*args, 4, 16)
    np.testing.assert_array_equal(got.numpy(), _jax_i16(bins, nid, stats, 4,
                                                        16))
    monkeypatch.setenv("H2O3_TPU_HIST_I16", "0")
    assert torch.equal(got, ph.histogram(*args, 4, 16))
    monkeypatch.setenv("H2O3_TPU_HIST_I16", "1")
    acc = torch.ones_like(got)
    assert torch.equal(ph.histogram(*args, 4, 16, out=acc), got + 1)


def test_i16_histogram_float_stats_within_jax_envelope(monkeypatch):
    """Float stats quantize at absmax/127 per (node, lane): within JAX's
    envelope of the float32 histogram (``test_wave2.py``), and equal to
    JAX's i16 histogram to float32 rounding."""
    bins, nid, stats = _hist_case(seed=9, integer=False)
    args = (torch.from_numpy(bins), torch.from_numpy(nid),
            torch.from_numpy(stats))
    h32 = ph.histogram(*args, 4, 16).numpy()
    monkeypatch.setenv("H2O3_TPU_HIST_I16", "1")
    h16 = ph.histogram(*args, 4, 16).numpy()
    scale = np.abs(stats).max() / 127.0
    rows = ph.histogram(args[0], args[1], torch.ones(len(nid), 3), 4, 16)
    np.testing.assert_allclose(h16, h32, atol=float(scale) * (
        float(rows.max()) / 2 + 1))
    np.testing.assert_allclose(h16, _jax_i16(bins, nid, stats, 4, 16),
                               rtol=1e-5, atol=1e-5)
    assert not np.array_equal(h16, h32)


def test_i16_overflow_latch_runs_float32(monkeypatch):
    """A quantized cell past 32,767 trips the latch: the float32 histogram
    comes back, and the tally counts it."""
    rng = np.random.default_rng(2)
    n = 2000
    bins = np.zeros((n, 2), np.uint8)  # every row in one cell
    nid = np.zeros(n, np.int32)
    stats = rng.normal(size=(n, 3)).astype(np.float32) + 100.0
    args = (torch.from_numpy(bins), torch.from_numpy(nid),
            torch.from_numpy(stats))
    h32 = ph.histogram(*args, 1, 8)
    monkeypatch.setenv("H2O3_TPU_HIST_I16", "1")
    before = ph.I16_EVENTS["overflows"]
    assert torch.equal(ph.histogram(*args, 1, 8), h32)
    assert ph.I16_EVENTS["overflows"] == before + 1
    j = _jax_i16(bins, nid, stats, 1, 8)
    np.testing.assert_allclose(j, h32.numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# per-level bin coarsening


@pytest.mark.parametrize("depth,nbins", [(6, 256), (8, 256), (20, 256),
                                         (6, 128), (6, 64), (5, 200)])
def test_bin_shifts_equal_jax(monkeypatch, depth, nbins):
    monkeypatch.setenv("H2O3_TPU_BIN_ADAPT", "1")
    assert pst._bin_shifts(depth, nbins, ()) == jst._bin_shifts(depth, nbins,
                                                                ())
    assert pst._bin_shifts(depth, nbins, (1,)) == [0] * (depth + 1)
    monkeypatch.setenv("H2O3_TPU_BIN_ADAPT", "0")
    assert pst._bin_shifts(depth, nbins, ()) == [0] * (depth + 1)


def test_coarsen_bins_and_hist_equal_jax():
    """Coarse codes and histograms (the NA bin passing, a ragged last
    group) equal JAX's; the coarse histogram is the histogram of the
    coarse codes."""
    rng = np.random.default_rng(5)
    bins = rng.integers(0, 256, (1000, 3)).astype(np.uint8)
    nid = rng.integers(0, 2, 1000).astype(np.int32)
    stats = rng.integers(0, 5, (1000, 3)).astype(np.float32)
    h = ph.histogram(torch.from_numpy(bins), torch.from_numpy(nid),
                     torch.from_numpy(stats), 2, 256)
    for s in (1, 2, 3):
        cb = pst._coarsen_bins(torch.from_numpy(bins), s)
        np.testing.assert_array_equal(
            cb.numpy(), np.asarray(jst._coarsen_bins(jnp.asarray(bins), s)))
        ch = pst._coarsen_hist(h, s)
        np.testing.assert_array_equal(
            ch.numpy(), np.asarray(jst._coarsen_hist(jnp.asarray(h.numpy()),
                                                     s)))
        nb = pst._coarse_nbins(256, s)
        assert nb == jst._coarse_nbins(256, s) and ch.shape[2] == nb
        assert torch.equal(ch, ph.histogram(cb, torch.from_numpy(nid),
                                            torch.from_numpy(stats), 2, nb))


@pytest.fixture(scope="module")
def adapt_pair():
    df = _int_df(n=3000, c=4, hi=400, seed=2)
    return _train_both(df, {"H2O3_TPU_BIN_ADAPT": "1"}, max_depth=6)


def test_bin_adapt_gbm_matches_jax(adapt_pair):
    """A depth-6 GBM on 255-bin integer features with the knob (shifts
    [0, 0, 0, 1, 2, 2, 2]: levels at 129 and 65 bins) against JAX's:
    splits equal, every split bin in the full code space, predictions
    within 1e-5; the tmojo's scorer gives the same predictions."""
    jm, pm_, jp, pp = adapt_pair
    assert _forest_splits(pm_) == _forest_splits(jm)
    np.testing.assert_allclose(pp, jp, atol=1e-5)
    assert pm_.output["bin_spec"].max_bins == 256
    deep = [s for t in _forest_splits(pm_) for s in t
            if s[2] != "leaf" and s[0] >= 4]
    assert deep and all(s[3] % 4 == 0 for s in deep)  # bin << 2


def test_bin_adapt_saturated_run_matches_jax():
    """Depth 8 with the frontier capped at 16 nodes: levels 5-7 form the
    saturated run at 65 bins (its carry coarsened once, at level 4). Every
    stacked record field of three trees bit-equal to JAX's, cat_mask
    widths (129, 65, then the terminal 256) included."""
    rng = np.random.default_rng(3)
    n, C = 960, 6
    bins = rng.integers(0, 256, (n, C)).astype(np.uint8)
    t = rng.integers(-3, 4, n).astype(np.float32)
    lrs = np.array([0.5, 0.5, 0.25], np.float32)
    kw = dict(n_bins=256, is_cat_cols=np.zeros(C, bool), max_depth=8,
              min_rows=1.0, min_split_improvement=0.0, learn_rates=lrs,
              node_cap=16)
    with _env(H2O3_TPU_BIN_ADAPT="1"):
        _, _, jstk = jst.build_trees_scanned(
            pm.shard_rows(jnp.asarray(bins)), pm.shard_rows(jnp.ones(n)),
            pm.shard_rows(jnp.asarray(t)), pm.shard_rows(jnp.zeros(n)),
            jnp.zeros(C, jnp.float32), jax.random.PRNGKey(0), len(lrs),
            grad_fn=lambda F_, y_, w_: (y_, jnp.ones_like(F_)),
            grad_key=("adapt-sat",), sample_rate=1.0,
            max_abs_leaf=float("inf"), col_sample_rate=1.0,
            col_sample_rate_per_tree=1.0, **kw)
        pF, _, pstk = pst.build_trees_scanned(
            torch.from_numpy(bins), torch.ones(n), torch.from_numpy(t),
            torch.zeros(n), torch.zeros(C), len(lrs),
            grad_fn=lambda F_, y_, w_: (y_, torch.ones_like(F_)),
            grad_key=("adapt-sat",), **kw)
        assert pst._sat_region(8, 16, pst._bin_shifts(8, 256, ())) == (5, 3)
    assert [lvl["cat_mask"].shape[-1] for lvl in pstk] == \
        [256, 256, 256, 129, 65, 65, 65, 65, 256]
    for li, (a, b) in enumerate(zip(pstk, jstk)):
        for f in a:
            assert a[f].numpy().tobytes() == np.asarray(b[f]).tobytes(), \
                (li, f)


# ---------------------------------------------------------------------------
# exclusive feature bundling


def _onehot_df(n=2400, levels=10, seed=4) -> pd.DataFrame:
    """One-hot columns of a 10-level factor, two sparse indicator columns
    and two integer numeric columns; an integer target."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(0, levels, n)
    df = pd.DataFrame({f"oh{k}": (lv == k).astype(np.float32)
                       for k in range(levels)})
    df["s0"] = (rng.random(n) < 0.03).astype(np.float32)
    df["num0"] = rng.integers(0, 30, n).astype(np.float32)
    df["num1"] = rng.integers(0, 30, n).astype(np.float32)
    df["y"] = (2.0 * (lv % 3 == 0) + (df["num0"] > 15) - (lv == 7)
               + rng.integers(-1, 2, n)).astype(np.float32)
    return df


def _specs(df):
    cols = [c for c in df.columns if c != "y"]
    jf = JFrame.from_pandas(df)
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    return (jbin.fit_bins(jf, cols), jbin.bin_frame(jbin.fit_bins(jf, cols),
                                                    jf),
            pbin.fit_bins(pf, cols), pbin.bin_frame(pbin.fit_bins(pf, cols),
                                                    pf))


def test_fit_efb_plan_equals_jax_and_expands_exactly():
    """On a one-hot frame the plan (bundles, offsets, defaults, code
    counts) equals JAX's and removes columns; the bundled codes equal
    JAX's; the histogram over the bundled columns, expanded, equals the
    histogram of the real columns exactly (integer stats), pad columns
    included."""
    df = _onehot_df()
    jspec, jbins, pspec, pbins = _specs(df)
    n = len(df)
    jplan = jbin.fit_efb(jspec, jbins, nrow=n)
    pplan = pbin.fit_efb(pspec, pbins, nrow=n)
    assert pplan is not None and pplan.n_cols_b < pspec.ncols
    assert pplan.bundles == jplan.bundles and pplan.key == jplan.key
    pb = pbin.bundle_bins(pplan, pbins)
    np.testing.assert_array_equal(
        pb.numpy(), np.asarray(jbin.bundle_bins(jplan, jbins))[:n])
    rng = np.random.default_rng(0)
    nid = torch.from_numpy(rng.integers(-1, 3, n).astype(np.int32))
    stats = torch.from_numpy(rng.integers(0, 4, (n, 3)).astype(np.float32))
    B = pbin.bucket_nbins(pspec.max_bins)
    Cp = pbin.bucket_cols(pspec.ncols)
    real = ph.histogram(torch.nn.functional.pad(pbins, (0, Cp - pspec.ncols)),
                        nid, stats, 3, B)
    arrs = tuple(torch.from_numpy(a) for a in
                 pbin.expand_arrays(pplan, Cp, B))
    for p_a, j_a in zip(arrs, jbin.expand_arrays(jplan, Cp, B)):
        np.testing.assert_array_equal(p_a.numpy(), j_a)
    assert torch.equal(pbin.expand_hist(arrs, ph.histogram(pb, nid, stats,
                                                           3, B)), real)


def test_fit_efb_skips_a_dense_frame():
    """Dense numeric columns bundle nothing: no plan, in either package."""
    rng = np.random.default_rng(1)
    df = pd.DataFrame(rng.normal(size=(1500, 5)).astype(np.float32),
                      columns=list("abcde"))
    df["y"] = rng.normal(size=1500).astype(np.float32)
    jspec, jbins, pspec, pbins = _specs(df)
    assert jbin.fit_efb(jspec, jbins, nrow=1500) is None
    assert pbin.fit_efb(pspec, pbins, nrow=1500) is None


@pytest.fixture(scope="module")
def efb_pair():
    return _train_both(_onehot_df(), {"H2O3_TPU_TREE_EFB": "1"},
                       max_depth=4)


def test_efb_gbm_matches_jax_and_the_unbundled_forest(efb_pair):
    """A GBM with the knob on the one-hot frame against JAX's: splits
    equal, predictions within 1e-5; and equal to the port's forest with the
    knob off, varimp within 1e-5 of the largest importance (the expansion
    is exact on the first tree's integer stats; later residuals are not
    integers)."""
    jm, pm_, jp, pp = efb_pair
    assert _forest_splits(pm_) == _forest_splits(jm)
    np.testing.assert_allclose(pp, jp, atol=1e-5)
    with _env():
        off = H2OGradientBoostingEstimator(**{**_GBM_KW, "max_depth": 4}) \
            .train(y="y", training_frame=h2o3_tpu_torch.upload_file(
                _onehot_df(), device="cpu")).model
    assert _forest_splits(off) == _forest_splits(pm_)
    # the later trees' residuals are not integers: the default cell's
    # rebuilt sums round apart from the direct ones, and a gain cancels fit
    # terms of the node's size, so it is held to 1e-5 of the largest
    vi = pm_.output["varimp"]
    np.testing.assert_allclose(off.output["varimp"], vi,
                               atol=1e-5 * float(vi.max()))


# ---------------------------------------------------------------------------
# lossguide growth


def test_lossguide_max_leaves_honoured_and_huge_budget_is_depthwise():
    """Every tree has at most ``max_leaves`` leaves; a budget past the
    leaves a depth-wise tree can have grows the depth-wise forest to the
    bit."""
    fr = h2o3_tpu_torch.upload_file(_int_df(seed=5), device="cpu")
    kw = {**_GBM_KW, "max_depth": 5}
    with _env():
        lg = H2OGradientBoostingEstimator(
            grow_policy="lossguide", max_leaves=7, **kw).train(
                y="y", training_frame=fr).model
        big = H2OGradientBoostingEstimator(
            grow_policy="lossguide", max_leaves=1 << 12, **kw).train(
                y="y", training_frame=fr).model
        dw = H2OGradientBoostingEstimator(**kw).train(
            y="y", training_frame=fr).model
    leaves = [t.n_leaves for g in lg.output["trees"] for t in g]
    assert max(leaves) <= 7 and max(leaves) > 2
    assert max(t.n_leaves for g in dw.output["trees"] for t in g) > 7
    for ga, gb in zip(big.output["trees"], dw.output["trees"]):
        for la, lb in zip(ga[0].levels, gb[0].levels):
            for f in pst._REC_FIELDS:
                assert np.array_equal(getattr(la, f), getattr(lb, f)), f


def test_lossguide_gbm_matches_jax():
    """Lossguide with ``max_leaves=6`` against JAX's on integer targets:
    splits equal (the ration by gain rank, ties to the lower slot),
    predictions within 1e-5."""
    jm, pm_, jp, pp = _train_both(_int_df(seed=6), {}, max_depth=4,
                                  grow_policy="lossguide", max_leaves=6)
    assert _forest_splits(pm_) == _forest_splits(jm)
    np.testing.assert_allclose(pp, jp, atol=1e-5)


@pytest.mark.parametrize("kw,env", [
    (dict(grow_policy="bogus"), {}),
    (dict(grow_policy="lossguide"), {}),
    (dict(grow_policy="lossguide", max_leaves=1), {}),
    (dict(grow_policy="lossguide", max_leaves=8),
     {"H2O3_TPU_WHOLE_TREE": "0"}),
])
def test_lossguide_validation_errors_as_jax(kw, env):
    """JAX's checks, with the port's messages naming the same parameter:
    an unknown policy, ``max_leaves < 2``, and the eager per-level loop
    (JAX's job reraises its builder's ValueError as a RuntimeError)."""
    df = _int_df(n=200, seed=7)
    with _env(**env):
        with pytest.raises((ValueError, RuntimeError)) as jerr:
            JGBM(**_GBM_KW, **kw).train(y="y",
                                        training_frame=JFrame.from_pandas(df))
        with pytest.raises(ValueError) as perr:
            H2OGradientBoostingEstimator(**_GBM_KW, **kw).train(
                y="y", training_frame=h2o3_tpu_torch.upload_file(
                    df, device="cpu"))
    key = "max_leaves" if "max_leaves >= 2" in str(jerr.value) else (
        "grow_policy")
    assert key in str(jerr.value) and key in str(perr.value)


def test_lossguide_refused_by_xgboost_and_streamed(monkeypatch):
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator

    fr = h2o3_tpu_torch.upload_file(_int_df(n=400, seed=8), device="cpu")
    with pytest.raises(ValueError, match="lossguide"):
        H2OXGBoostEstimator(grow_policy="lossguide").train(
            y="y", training_frame=fr)
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(4096))
    with pytest.raises(ValueError, match="resident-only"):
        H2OGradientBoostingEstimator(
            grow_policy="lossguide", max_leaves=4, **_GBM_KW).train(
                y="y", training_frame=fr)


# ---------------------------------------------------------------------------
# the u8 code cache


def test_u8_cache_hit_off_and_replaced_column(monkeypatch):
    """A second ``bin_frame`` of one (spec, frame) is the same tensor;
    ``H2O3_TPU_TREE_U8CACHE=0`` bins again to equal codes; a column
    replaced by ``frame[name] = ...`` misses and bins the new values. JAX's
    cache keys by the spec alone and returns the replaced column's stale
    codes (a fault of the reference, ROADMAP Queue C)."""
    df = _int_df(n=500, seed=9)
    cols = [c for c in df.columns if c != "y"]
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    spec = pbin.fit_bins(pf, cols)
    monkeypatch.delenv("H2O3_TPU_TREE_U8CACHE", raising=False)
    b0 = pbin.bin_frame(spec, pf)
    assert pbin.bin_frame(spec, pf) is b0
    monkeypatch.setenv("H2O3_TPU_TREE_U8CACHE", "0")
    b2 = pbin.bin_frame(spec, pf)
    assert b2 is not b0 and torch.equal(b2, b0)
    monkeypatch.delenv("H2O3_TPU_TREE_U8CACHE")
    new = np.asarray(df["x0"][::-1], np.float32).copy()
    pf["x0"] = new
    b3 = pbin.bin_frame(spec, pf)
    assert b3 is not b0
    monkeypatch.setenv("H2O3_TPU_TREE_U8CACHE", "0")
    assert torch.equal(b3, pbin.bin_frame(spec, pf))
    assert not torch.equal(b3[:, 0], b0[:, 0])
    monkeypatch.delenv("H2O3_TPU_TREE_U8CACHE")
    jf = JFrame.from_pandas(df)
    jspec = jbin.fit_bins(jf, cols)
    j0 = jbin.bin_frame(jspec, jf)
    jf["x0"] = new
    assert jbin.bin_frame(jspec, jf) is j0  # JAX: stale codes
