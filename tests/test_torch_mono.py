"""The port's monotone-constrained GBM path and its distributions against
the JAX package, on the CPU at small sizes: kernel B3's plain version
(``split_candidates_mono_plain``), the constrained split scans, the bound
propagation (``_child_bounds``) and leaf clip, whole constrained GBMs, the
newly ported distributions and deviances, the validation messages, and
weights carried over from a JAX model.

Tolerances, with their reasons:
- split scans on the tie suites (unit weights, integer targets, hessians of
  1, 2 or 3 per row, bounds mixing ±inf with quarter-integers): gains,
  bins, NA directions, child stats, ``mid`` and ``mono_col`` bit-equal —
  every sum is exact in float32 and both sides do the same divisions;
- ``_child_bounds`` and the leaf clip: exact (selections and one division);
- per-level constrained tree build on integer data: decisions bit-equal;
- whole GBMs on float data: tree 0's split columns equal, predictions
  within 1e-5 absolute (gaussian, bernoulli, quantile, laplace, huber) or
  1e-5 relative (tweedie, poisson, gamma: ``torch.exp`` and ``jnp.exp``
  differ by an ulp). On the CPU the JAX constrained build histograms every
  level directly and sums across an 8-device mesh; the port subtracts
  siblings on one device, so float32 sums round differently;
- distributions: 1e-6 relative or absolute (targets like ``e - 1`` cancel
  O(1) terms); deviances: 1e-12 relative (both float64);
- weights converted from a JAX model: predictions within 1e-6 relative (the
  same trees replayed with the same float32 adds, then one ``exp``).
"""

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
from h2o3_tpu.models import metrics as jmetrics  # noqa: E402
from h2o3_tpu.models.tree import GBM as JGBM  # noqa: E402
from h2o3_tpu.models.tree import distributions as jdist  # noqa: E402
from h2o3_tpu.models.tree import shared_tree as jst  # noqa: E402
from h2o3_tpu.ops.hist_pallas import blocked_from_dense, plan_layout  # noqa: E402
from h2o3_tpu.ops.histogram import _hist_scatter_local  # noqa: E402
from h2o3_tpu.ops.split_pallas import (  # noqa: E402
    fused_split_scan as jax_fused_split_scan,
    split_candidates as jax_split_candidates,
)
from h2o3_tpu.parallel import mesh as pm  # noqa: E402
from h2o3_tpu_torch.datasets import claims_like  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator  # noqa: E402
from h2o3_tpu_torch.models import metrics as pmetrics  # noqa: E402
from h2o3_tpu_torch.models.tree import distributions as pdist  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import gbm_from_numpy  # noqa: E402
from h2o3_tpu_torch.ops import split_cuda as sc  # noqa: E402
from h2o3_tpu_torch.ops.histogram import histogram  # noqa: E402

_N, _B = 4, 16
_LO = np.array([-np.inf, -0.25, -np.inf, 0.25], np.float32)
_HI = np.array([np.inf, 0.75, 1.5, np.inf], np.float32)
_SUITES = ["constant-target", "duplicated-columns", "integer-targets-with-na",
           "mixed-categorical"]


def _suite(name):
    """(bins, nid, stats, is_cat, mono) of one integer-exact tie suite of
    ``tests/test_torch_split.py``, with hessians of 1, 2 or 3 per row and a
    direction per column drawn from {-1, 0, 1}."""
    n = 960
    rng = np.random.default_rng(3)
    nid = rng.integers(0, _N, n).astype(np.int32)
    is_cat = None
    if name == "constant-target":
        base = rng.integers(1, _B, n).astype(np.uint8)
        bins = np.tile(base[:, None], (1, 13))
        t = np.ones(n, np.float32)
    elif name == "duplicated-columns":
        base = np.random.default_rng(3).integers(1, _B, n).astype(np.uint8)
        bins = np.tile(base[:, None], (1, 16))
        t = (rng.integers(0, 2, n) * 2 - 1).astype(np.float32)
    elif name == "integer-targets-with-na":
        bins = rng.integers(0, _B, (n, 7)).astype(np.uint8)  # bin 0 = NA
        t = rng.integers(-3, 4, n).astype(np.float32)
    else:  # mixed categorical / numeric
        bins = rng.integers(0, _B, (n, 7)).astype(np.uint8)
        bins[:, 2] = rng.integers(0, 7, n)
        bins[:, 5] = rng.integers(0, 5, n)
        is_cat = np.zeros(7, bool)
        is_cat[[2, 5]] = True
        t = rng.integers(-3, 4, n).astype(np.float32)
    C = bins.shape[1]
    if is_cat is None:
        is_cat = np.zeros(C, bool)
    w = np.ones(n, np.float32)
    wh = rng.integers(1, 4, n).astype(np.float32)
    stats = np.stack([w, w * t, wh], axis=1)
    mono = np.resize(np.array([1, -1, 0], np.int32), C)
    rng.shuffle(mono)
    return bins, nid, stats, is_cat, mono


def _hists(bins, nid, stats):
    hp = histogram(torch.from_numpy(bins), torch.from_numpy(nid),
                   torch.from_numpy(stats), _N, _B)
    d = _hist_scatter_local(jnp.asarray(bins), jnp.asarray(nid),
                            jnp.asarray(stats), _N, _B)
    hj = jnp.transpose(d.reshape(bins.shape[1], _N, _B, 3), (1, 0, 2, 3))
    return hp, hj


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


_KEYS = ("gain", "col", "split_bin", "na_left", "is_cat", "cat_mask", "Lst",
         "Rst", "ok", "node_w", "node_wy", "node_wh", "mid", "mono_col")


def _assert_same_decisions(port: dict, ref: dict, what: str):
    for k in _KEYS:
        a = port[k].numpy()
        b = np.asarray(ref[k]).astype(a.dtype)
        assert a.shape == b.shape and _bits(a) == _bits(b), (
            f"{what}: field {k} differs\nport {a}\nref  {b}")


@pytest.mark.parametrize("suite", _SUITES)
def test_mono_split_bit_exact_on_tie_suites(suite):
    """B3's plain version against the Pallas kernel in the interpreter, and
    the port's plain and dispatching scans against the dense ``_split_scan``
    and JAX's fused assembly, all with ``mono`` and node bounds."""
    bins, nid, stats, is_cat, mono = _suite(suite)
    C = bins.shape[1]
    hp, hj = _hists(bins, nid, stats)
    assert _bits(hp) == _bits(hj)
    cat_cols = tuple(int(i) for i in np.nonzero(is_cat)[0])
    col_mask = np.ones((_N, C), np.float32)
    col_mask[:, -1] = 0.0
    mono_t, lo_t, hi_t = (torch.from_numpy(a) for a in (mono, _LO, _HI))
    mono_j, lo_j, hi_j = (jnp.asarray(a) for a in (mono, _LO, _HI))
    args_p = (torch.from_numpy(is_cat), torch.from_numpy(col_mask), 1.0, 0.0)
    args_j = (jnp.asarray(is_cat), jnp.asarray(col_mask), 1.0, 0.0)

    ref = jst._split_scan(hj, *args_j, cat_cols, mono=mono_j, node_lo=lo_j,
                          node_hi=hi_j)
    _assert_same_decisions(
        pst._split_scan(hp, *args_p, cat_cols, mono=mono_t, node_lo=lo_t,
                        node_hi=hi_t), ref, "_split_scan")
    _assert_same_decisions(
        sc.fused_split_scan(hp, *args_p, cat_cols, mono=mono_t, node_lo=lo_t,
                            node_hi=hi_t), ref, "fused_split_scan")

    lay = plan_layout(C, _N, _B, 3)
    blk = blocked_from_dense(
        jnp.transpose(hj, (1, 0, 2, 3)).reshape(C, _N * _B, 3), lay)
    tot_j = jnp.asarray(hj)[:, 0].sum(axis=1)
    mono_pad = jnp.asarray(np.pad(mono, (0, lay.cpad - C)))
    g, t, nal, L, R = jax_split_candidates(
        blk, tot_j, 1.0, layout=lay, interpret=True, mono=mono_pad,
        node_lo=lo_j, node_hi=hi_j)
    out_p = sc.split_candidates_mono_plain(hp, hp[:, 0].sum(dim=1), 1.0,
                                           mono_t, lo_t, hi_t)
    for a, b in zip(out_p, (g, t, nal, L, R)):
        b = np.asarray(b)[:, :C]
        assert _bits(a) == _bits(b.astype(a.numpy().dtype))
    # the mask fires: constrained candidates differ from the free ones
    free = sc.split_candidates_plain(hp, hp[:, 0].sum(dim=1), 1.0)
    assert not (torch.equal(free[0], out_p[0]) and torch.equal(free[1], out_p[1]))
    # the dispatch sends CPU tensors to the plain version, no launch
    before = sc.split_candidates_mono_cuda.launches
    for a, b in zip(sc.split_candidates_mono(hp, hp[:, 0].sum(dim=1), 1.0,
                                             mono_t, lo_t, hi_t), out_p):
        assert torch.equal(a, b)
    assert sc.split_candidates_mono_cuda.launches == before

    if not cat_cols:
        fj = jax_fused_split_scan(blk, lay, jnp.asarray(is_cat),
                                  jnp.asarray(col_mask), 1.0, 0.0, (),
                                  interpret=True, mono=mono_j, node_lo=lo_j,
                                  node_hi=hi_j)
        _assert_same_decisions(
            sc.fused_split_scan(hp, *args_p, mono=mono_t, node_lo=lo_t,
                                node_hi=hi_t), fj,
            "vs split_pallas.fused_split_scan")


def test_mono_cuda_wrapper_refuses_cpu_tensors():
    bins, nid, stats, _, mono = _suite("integer-targets-with-na")
    hp, _ = _hists(bins, nid, stats)
    with pytest.raises(ValueError, match="CUDA"):
        sc.split_candidates_mono_cuda(
            hp, hp[:, 0].sum(dim=1), 1.0, torch.from_numpy(mono),
            torch.from_numpy(_LO), torch.from_numpy(_HI))


def test_child_bounds_and_leaf_clip_exact():
    rng = np.random.default_rng(5)
    N, n_pad_next = 16, 32
    ok = rng.random(N) < 0.6
    cs = np.cumsum(ok.astype(np.int32))
    child_base = np.where(ok, 2 * (cs - 1), 0).astype(np.int32)
    mono_col = rng.integers(-1, 2, N).astype(np.int32)
    mid = (rng.integers(-8, 9, N) / 4).astype(np.float32)
    lo = np.where(rng.random(N) < 0.5, -np.inf,
                  rng.integers(-12, 0, N) / 4).astype(np.float32)
    hi = np.where(rng.random(N) < 0.5, np.inf,
                  rng.integers(1, 12, N) / 4).astype(np.float32)
    jl, jh = jst._child_bounds(*(jnp.asarray(a) for a in
                                 (ok, child_base, mono_col, mid, lo, hi)),
                               n_pad_next)
    pl_, ph = pst._child_bounds(*(torch.from_numpy(a) for a in
                                  (ok, child_base, mono_col, mid, lo, hi)),
                                n_pad_next)
    assert _bits(pl_) == _bits(jl) and _bits(ph) == _bits(jh)
    assert np.isinf(pl_.numpy()[2 * ok.sum():]).all()  # unused slots stay free

    node = {k: rng.normal(size=N).astype(np.float32) * s for k, s in
            (("node_w", 50), ("node_wy", 3), ("node_wh", 2))}
    node["node_wh"] = np.abs(node["node_wh"])
    node["node_wh"][0] = 0.0
    rest = (np.zeros(N, np.int32), np.ones(N, np.int32), np.zeros(N, bool),
            np.zeros((N, 8), bool), np.zeros(N, bool))
    args = [node["node_w"], node["node_wy"], node["node_wh"], *rest]
    jout = jst._leaf_decide(jnp.asarray(ok), jnp.zeros(N), *map(jnp.asarray, args),
                            0.1, 2.0, N, node_lo=jnp.asarray(lo),
                            node_hi=jnp.asarray(hi))
    pout = pst._leaf_decide(torch.from_numpy(ok), torch.zeros(N),
                            *map(torch.from_numpy, args), 0.1, 2.0, N,
                            node_lo=torch.from_numpy(lo),
                            node_hi=torch.from_numpy(hi))
    assert _bits(pout[1]) == _bits(jout[1])
    # the clip binds somewhere, and comes before the max_abs_leaf clamp
    free = pst._leaf_decide(torch.from_numpy(ok), torch.zeros(N),
                            *map(torch.from_numpy, args), 0.1, 2.0, N)
    assert not torch.equal(free[1], pout[1])


def _signal_bins(n=960):
    rng = np.random.default_rng(31)
    bins = rng.integers(1, 16, (n, 6)).astype(np.uint8)
    # target anti-monotone in column 0, which carries a +1 constraint
    t = 16.0 - bins[:, 0] + rng.integers(-2, 3, n)
    return bins, t.astype(np.float32)


@pytest.mark.parametrize("suite", ["duplicated-columns", "anti-signal"])
def test_per_level_mono_build_tree_decisions_equal(suite):
    """JAX's per-level monotone loop and the port's eager loop (with
    sibling subtraction and the terminal level from the parents' child
    stats) record the same splits, leaves and leaf values on integer data."""
    if suite == "duplicated-columns":
        bins = _suite(suite)[0]
        t = np.where(np.arange(bins.shape[0]) % 3 == 0, -1.0, 1.0)
        t = (t * bins[:, 0]).astype(np.float32)
        mono = np.resize(np.array([1, -1, 0], np.int32), bins.shape[1])
    else:
        bins, t = _signal_bins()
        mono = np.array([1, 0, -1, 0, 0, 0], np.int32)
    n, C = bins.shape
    kw = dict(n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=4,
              min_rows=1.0, min_split_improvement=0.0, learn_rate=0.1)
    jt, jp, _ = jst.build_tree(
        pm.shard_rows(jnp.asarray(bins)), pm.shard_rows(jnp.ones(n)),
        pm.shard_rows(jnp.asarray(t)), pm.shard_rows(jnp.ones(n)),
        preds=pm.shard_rows(jnp.zeros(n)), key=jax.random.PRNGKey(5),
        varimp=jnp.zeros(C, jnp.float32), monotone=mono, **kw)
    ones = torch.ones(n)
    pt, pp, _ = pst.build_tree(
        torch.from_numpy(bins), ones, torch.from_numpy(t), ones,
        preds=torch.zeros(n), varimp=torch.zeros(C), monotone=mono, **kw)
    jh, ph = jt.to_host(), pt.to_host()
    assert len(ph.levels) == len(jh.levels)
    for li, (a, b) in enumerate(zip(ph.levels, jh.levels)):
        for f in ("split_col", "split_bin", "na_left", "leaf_now", "leaf_val",
                  "child_base"):
            assert _bits(getattr(a, f)) == _bits(getattr(b, f)), (li, f)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    free, _, _ = pst.build_tree(
        torch.from_numpy(bins), ones, torch.from_numpy(t), ones,
        preds=torch.zeros(n), varimp=torch.zeros(C), **kw)
    assert any(_bits(a.leaf_val) != _bits(b.leaf_val) for a, b in
               zip(free.to_host().levels, ph.levels))  # constraints bind


# ---------------------------------------------------------------------------
# whole GBMs


_FEATS = [f"f{i}" for i in range(6)]
_MONO = {"f0": 1, "f1": -1}
_KW = dict(ntrees=4, max_depth=3, learn_rate=0.1, min_rows=10.0, seed=42)
_EXP_LINK = ("tweedie", "poisson", "gamma")


def _mono_df(n=5000) -> pd.DataFrame:
    """``claims_like`` features and claim amount, plus a gaussian target, a
    positive (gamma) target and a binary label, each rising in f0 and
    falling in f1 with a non-monotone part."""
    df = claims_like(n, c=6, seed=3)
    rng = np.random.default_rng(4)
    X = df[_FEATS].to_numpy()
    df["yg"] = (1.5 * X[:, 0] - X[:, 1] + np.sin(2 * X[:, 2])
                + 0.5 * rng.normal(size=n)).astype(np.float32)
    df["ypos"] = np.exp(0.4 * X[:, 0] - 0.3 * X[:, 1]
                        + 0.3 * rng.normal(size=n)).astype(np.float32)
    eta = 1.2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    df["lab"] = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "s", "b")
    return df


@pytest.fixture(scope="module")
def frames():
    df = _mono_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


def _train_both(frames, y, **kw):
    _, jf, pf = frames
    jm = JGBM(**_KW, **kw).train(x=_FEATS, y=y, training_frame=jf)
    est = H2OGradientBoostingEstimator(**_KW, **kw)
    est.train(x=_FEATS, y=y, training_frame=pf)
    return jm, est


def _pred_col(dist):
    return "s" if dist == "bernoulli" else "predict"


def _assert_gbm_matches(frames, jm, est, dist):
    _, jf, pf = frames
    col = _pred_col(dist)
    jp = np.asarray(jm.predict(jf).vec(col).to_numpy())[: jf.nrow]
    pp = est.predict(pf).vec(col).to_numpy()
    assert np.isfinite(pp).all()
    if dist in _EXP_LINK:
        np.testing.assert_allclose(pp, jp, rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-5)
    jt = jm.output["trees"][0][0].to_host()
    pt = est.model.output["trees"][0][0].to_host()
    assert len(pt.levels) == len(jt.levels)
    for a, b in zip(pt.levels, jt.levels):
        np.testing.assert_array_equal(a.split_col, np.asarray(b.split_col))
    assert est.model.output["distribution"] == jm.output["distribution"]
    assert abs(est.model.output["init_f"] - jm.output["init_f"]) <= 1e-12


_MONO_CASES = {
    "gaussian": ("yg", {}),
    "bernoulli": ("lab", {}),
    "tweedie": ("claim", {"tweedie_power": 1.5}),
    "quantile": ("yg", {"quantile_alpha": 0.8}),
}


@pytest.fixture(scope="module")
def tweedie_pair(frames):
    return _train_both(frames, "claim", distribution="tweedie",
                       tweedie_power=1.5, monotone_constraints=_MONO)


@pytest.mark.parametrize("dist", list(_MONO_CASES))
def test_constrained_gbm_matches_jax(frames, tweedie_pair, dist):
    """upload_file → H2OGradientBoostingEstimator(monotone_constraints=...)
    .train → predict, one +1 and one -1 column, against the JAX GBM."""
    y, extra = _MONO_CASES[dist]
    if dist == "tweedie":
        jm, est = tweedie_pair
    else:
        jm, est = _train_both(frames, y, distribution=dist,
                              monotone_constraints=_MONO, **extra)
    _assert_gbm_matches(frames, jm, est, dist)
    jmm, pmm = jm.training_metrics, est.model.training_metrics
    for k in ("auc", "logloss", "mean_residual_deviance", "rmse"):
        if k in jmm._v:
            assert abs(pmm._v[k] - jmm._v[k]) <= 1e-5 * max(1.0, abs(jmm._v[k])), k


@pytest.mark.parametrize("dist", ["gaussian", "bernoulli", "tweedie"])
def test_constrained_predictions_are_monotone(dist):
    """``tests/test_trees.py``'s enforcement probe on the port: a sweep of
    each constrained column with the others fixed gives predictions that
    never move against the column's direction (by more than 1e-6)."""
    rng = np.random.default_rng(1)
    n = 5000
    x = rng.uniform(-3, 3, n)
    z = rng.normal(size=n)
    sig = x + 0.8 * np.sin(3 * x) - 0.7 * z + 0.4 * np.cos(4 * z)
    if dist == "gaussian":
        y = sig + 0.2 * rng.normal(size=n)
    elif dist == "bernoulli":
        y = np.where(rng.random(n) < 1 / (1 + np.exp(-sig)), "Y", "N")
    else:
        y = rng.poisson(np.exp(0.5 * sig - 1.0)) * rng.gamma(2.0, 1.0, n)
    fr = h2o3_tpu_torch.upload_file(pd.DataFrame({"x": x, "z": z, "y": y}),
                                    device="cpu")
    kw = dict(ntrees=30, max_depth=4, learn_rate=0.2, seed=1,
              distribution=dist)
    mono = {"x": 1, "z": -1}
    est = H2OGradientBoostingEstimator(monotone_constraints=mono, **kw)
    est.train(x=["x", "z"], y="y", training_frame=fr)
    free = H2OGradientBoostingEstimator(**kw)
    free.train(x=["x", "z"], y="y", training_frame=fr)
    col = "Y" if dist == "bernoulli" else "predict"
    grid = np.linspace(-3, 3, 300)
    wiggles = 0
    for swept, fixed, sign in (("x", "z", 1), ("z", "x", -1)):
        for v in (-1.0, 0.0, 1.5):
            gf = h2o3_tpu_torch.upload_file(
                pd.DataFrame({swept: grid, fixed: np.full(300, v)}),
                device="cpu")
            d = np.diff(est.predict(gf).vec(col).to_numpy().astype(np.float64))
            assert (sign * d < -1e-6).sum() == 0, (swept, v)
            df_ = np.diff(free.predict(gf).vec(col).to_numpy())
            wiggles += int((sign * df_ < -1e-6).sum())
    assert wiggles > 0  # the unconstrained model does move against them


@pytest.mark.parametrize("dist,y,extra", [
    ("poisson", "claim", {}), ("gamma", "ypos", {}), ("laplace", "yg", {}),
    ("huber", "yg", {"huber_alpha": 0.9})])
def test_new_distributions_match_jax(frames, dist, y, extra):
    jm, est = _train_both(frames, y, distribution=dist, **extra)
    _assert_gbm_matches(frames, jm, est, dist)
    jd = jm.training_metrics._v["mean_residual_deviance"]
    pd_ = est.model.training_metrics._v["mean_residual_deviance"]
    assert abs(pd_ - jd) <= 1e-5 * max(1.0, abs(jd))
    # model_performance re-scores through predict with the same deviance
    perf = est.model_performance(frames[2]).value("mean_residual_deviance")
    assert abs(perf - pd_) <= 1e-5 * max(1.0, abs(pd_))


@pytest.mark.parametrize("kw,y", [
    (dict(distribution="poisson", monotone_constraints={"f0": 1}), "claim"),
    (dict(monotone_constraints={"nope": 1}), "yg"),
    (dict(monotone_constraints={"cat": -1}), "yg"),
    (dict(monotone_constraints={"f0": 2}), "yg"),
], ids=["distribution", "unknown-column", "categorical", "direction"])
def test_validation_messages_match_jax(kw, y):
    df = _mono_df(400)
    df["cat"] = np.where(np.arange(400) % 3 == 0, "a", "b")
    feats = _FEATS + ["cat"]
    jf = JFrame.from_pandas(df)
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    # the JAX builder runs in a Job, which re-raises with the traceback
    with pytest.raises(RuntimeError) as je:
        JGBM(ntrees=1, max_depth=2, **kw).train(x=feats, y=y, training_frame=jf)
    with pytest.raises(ValueError) as pe:
        H2OGradientBoostingEstimator(ntrees=1, max_depth=2, **kw).train(
            x=feats, y=y, training_frame=pf)
    assert str(je.value).rstrip().endswith(f"ValueError: {pe.value}")


def test_all_zero_directions_mean_no_constraint(frames):
    _, _, pf = frames
    a = H2OGradientBoostingEstimator(**_KW, monotone_constraints={"f0": 0})
    a.train(x=_FEATS, y="yg", training_frame=pf)
    b = H2OGradientBoostingEstimator(**_KW)
    b.train(x=_FEATS, y="yg", training_frame=pf)
    assert torch.equal(a.predict(pf).vec("predict").data,
                       b.predict(pf).vec("predict").data)


def test_estimator_accepts_tweedie_monotone(frames):
    _, _, pf = frames
    est = H2OGradientBoostingEstimator(
        monotone_constraints={"f0": 1, "f1": -1}, distribution="tweedie",
        tweedie_power=1.3, ntrees=2, max_depth=3)
    est.train(x=_FEATS, y="claim", training_frame=pf)
    assert est.model.params.tweedie_power == 1.3
    assert est.model.output["distribution"] == "tweedie"
    assert (est.predict(pf).vec("predict").to_numpy() > 0).all()


def test_gbm_from_numpy_monotone_tweedie(frames, tweedie_pair):
    """A JAX-trained monotone tweedie GBM's weights, handed over as numpy,
    predict in the port what they predict in JAX."""
    _, jf, pf = frames
    jm, _ = tweedie_pair
    spec = jm.output["bin_spec"]
    out = {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards", "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f)) for f in pst.REPLAY_FIELDS}
                    for lv in t.levels] for t in group]
                  for group in jm.output["trees"]],
        "init_f": jm.output["init_f"],
        "distribution": jm.output["distribution"],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
    }
    m = gbm_from_numpy(out, device="cpu")
    jp = np.asarray(jm.predict(jf).vec("predict").to_numpy())[: jf.nrow]
    np.testing.assert_allclose(m.predict(pf).vec("predict").to_numpy(), jp,
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# distributions and deviance


@pytest.mark.parametrize("dist,aux", [
    ("gaussian", 0.0), ("bernoulli", 0.0), ("poisson", 0.0), ("gamma", 0.0),
    ("tweedie", 1.5), ("laplace", 0.0), ("quantile", 0.8), ("huber", 0.9)])
def test_distribution_zoo_within_1e6(dist, aux):
    rng = np.random.default_rng(1)
    f = (0.5 * rng.normal(size=1000)).astype(np.float32)
    y = (rng.random(1000) < 0.4).astype(np.float32) if dist == "bernoulli" \
        else rng.gamma(1.5, 1.0, 1000).astype(np.float32)
    w = rng.random(1000).astype(np.float32)
    tj, hj = jdist.grad_hess(dist, jnp.asarray(f), jnp.asarray(y),
                             jnp.asarray(w), aux)
    tp, hp = pdist.grad_hess(dist, *(torch.from_numpy(a) for a in (f, y, w)),
                             aux)
    # e - 1 and a - b cancel: 1e-6 of the O(1) terms, not of the result
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), rtol=1e-6, atol=1e-6)
    assert pdist.init_score(dist, y, w, aux) == pytest.approx(
        jdist.init_score(dist, y, w, aux), rel=1e-12, abs=1e-12)
    np.testing.assert_allclose(
        pdist.response_transform(dist, torch.from_numpy(f)).numpy(),
        np.asarray(jdist.response_transform(dist, jnp.asarray(f))),
        rtol=1e-6, atol=1e-6)


def test_resolve_distribution_and_unported(frames):
    _, jf, pf = frames
    for d in ("AUTO", "gaussian", "tweedie", "quantile", "huber", "poisson"):
        assert pdist.resolve_distribution(d, pf.vec("yg"), 0.7, 1.2, 0.8) == \
            jdist.resolve_distribution(d, jf.vec("yg"), 0.7, 1.2, 0.8)
    assert pdist.resolve_distribution("AUTO", pf.vec("lab")) == ("bernoulli", 0.0)
    # multinomial is ported: it resolves as in JAX, and the single-class
    # entry points send it to its own (multinomial_grad_hess / _init)
    assert pdist.resolve_distribution("multinomial", pf.vec("lab")) == \
        jdist.resolve_distribution("multinomial", jf.vec("lab"), 0.5, 1.5,
                                   0.9) == ("multinomial", 0.0)
    with pytest.raises(ValueError, match="multinomial_grad_hess"):
        pdist.grad_hess("multinomial", torch.zeros(2), torch.zeros(2),
                        torch.ones(2))
    with pytest.raises(ValueError, match="unknown distribution"):
        pdist.grad_hess("nope", torch.zeros(2), torch.zeros(2), torch.ones(2))


@pytest.mark.parametrize("dist", ["gaussian", "poisson", "gamma", "laplace",
                                  "tweedie"])
def test_regression_deviance_matches_jax(dist):
    rng = np.random.default_rng(6)
    a = np.where(rng.random(500) < 0.3, 0.0, rng.gamma(2.0, 1.5, 500))
    p = rng.gamma(2.0, 1.5, 500)
    w = rng.random(500)
    jm_ = jmetrics.regression_metrics(a, p, w, dist)._v
    pm_ = pmetrics.regression_metrics(a, p, w, distribution=dist)._v
    assert pm_.keys() == jm_.keys()
    for k, v in jm_.items():
        assert pm_[k] == pytest.approx(v, rel=1e-12, nan_ok=True), k
