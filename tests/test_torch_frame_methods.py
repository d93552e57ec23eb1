"""The port's core frame methods (``h2o3_tpu_torch.frame.frame``) against
``h2o3_tpu.frame.frame`` on the CPU: selection, ``drop``, ``cbind``,
``rbind`` (domain unions, one past 127 levels), ``head``/``tail``/
``describe``, ``subset_rows``, ``gather_rows`` (host and device indices,
invalid rows, time columns' exact copies), ``split_frame`` (the same rows
in the same order for a seed) and ``frame[name] = value``. Gathers, splits,
domains and codes must be equal exactly; ``describe``'s float32 moments to
1e-6 relative.

Also JAX's tree knobs (GOSS, EFB, the i16 lane, bin coarsening): set,
each acts on a GBM, XGBoost, DRF or XRT training as JAX's builders act on
it; at their defaults the training runs.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

import h2o3_tpu  # noqa: E402
from h2o3_tpu.frame import ops as jops  # noqa: E402,F401  (JAX's operators)

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.frame.frame import Vec  # noqa: E402


def frame_df(n=2000, seed=0) -> pd.DataFrame:
    """Numbers with NaN, an int, two enums with NA and unequal domains, a
    near-unique string column and a time column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    e = np.array(["lo", "mid", "hi"], dtype=object)[rng.integers(0, 3, n)]
    e[rng.random(n) < 0.05] = None
    f = np.array(["b", "c", "d", "z"], dtype=object)[rng.integers(0, 4, n)]
    f[rng.random(n) < 0.05] = None
    t = pd.Timestamp("2020-01-01") + pd.to_timedelta(
        rng.integers(0, 10 ** 9, n), "s")
    return pd.DataFrame({
        "x": x,
        "k": rng.integers(0, 50, n),
        "e": e,
        "f": f,
        "s": [f"id{i:05d}" for i in range(n)],
        "t": t,
    })


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """The JAX programs compiled here are not written to the persistent
    compilation cache that the test processes share: it writes an entry
    in place, with no lock and no atomic rename, so a process that reads
    an entry while another is still writing it may load a truncated
    program (JAX's tree programs are shared across nearby shapes). Reads
    stay on."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the frames are small, and under six test
    workers PyTorch's pool would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    df = frame_df()
    return df, (h2o3_tpu_torch.upload_file(df, device="cpu"),
                h2o3_tpu.upload_file(df))


def assert_same(pf, jf, rtol=0.0):
    """Names, kinds, domains and host values equal to JAX's (``rtol`` for
    float columns)."""
    assert pf.names == jf.names
    assert pf.nrow == jf.nrow
    for name in jf.names:
        pv, jv = pf.vec(name), jf.vec(name)
        assert pv.kind == jv.kind, name
        assert pv.domain == jv.domain, name
        a, b = pv.to_numpy(), jv.to_numpy()
        if pv.kind == "string":
            assert list(a) == list(b), name
        elif rtol:
            np.testing.assert_allclose(a, b, rtol=rtol, equal_nan=True,
                                       err_msg=name)
        else:
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_types_selection_drop_cbind(frames):
    _, (pf, jf) = frames
    assert pf.types == jf.types
    for sel in ("x", 2, ["t", "e", 0], ("s", "k")):
        assert_same(pf[sel], jf[sel])
    assert_same(pf.drop("s"), jf.drop("s"))
    assert_same(pf.drop(["x", "t"]), jf.drop(["x", "t"]))
    assert_same(pf[["x"]].cbind(pf[["e", "s"]]),
                jf[["x"]].cbind(jf[["e", "s"]]))
    assert pf[["x"]].vec(0) is pf.vec("x")  # a selection shares columns
    with pytest.raises(TypeError):
        pf[1.5]


def test_rbind_unions_domains(frames):
    df, (pf, jf) = frames
    other = df.iloc[:300].copy()
    other["e"] = np.array(["hi", "new", None], dtype=object)[
        np.arange(300) % 3]
    po = h2o3_tpu_torch.upload_file(other, device="cpu")
    jo = h2o3_tpu.upload_file(other)
    got = pf.rbind(po)
    assert_same(got, jf.rbind(jo))
    assert got.vec("e").domain == ("hi", "lo", "mid", "new")
    assert got.vec("t")._host is not None  # the exact copy came along


def test_rbind_past_127_levels_widens_codes():
    a = pd.DataFrame({"c": [f"a{i:03d}" for i in range(100)] + [None]})
    b = pd.DataFrame({"c": [f"b{i:03d}" for i in range(60)] + ["a005"]})
    pa, pb = (h2o3_tpu_torch.upload_file(d, device="cpu") for d in (a, b))
    ja, jb = h2o3_tpu.upload_file(a), h2o3_tpu.upload_file(b)
    assert pa.vec("c").data.dtype == torch.int8
    got = pa.rbind(pb)
    assert got.vec("c").data.dtype == torch.int16  # 160 levels
    assert got.vec("c").cardinality == 160
    assert_same(got, ja.rbind(jb))
    codes = got.vec("c").to_numpy()
    assert codes[100] == -1 and codes.max() == 159 and codes[-1] == 5


def test_rbind_refuses_mismatches(frames):
    _, (pf, _) = frames
    with pytest.raises(ValueError):  # other names
        pf.rbind(pf[["x", "k"]])
    with pytest.raises(ValueError):  # a real column against an enum
        pf[["x"]].rbind(h2o3_tpu_torch.Frame([pf.vec("e")], ["x"]))


def test_head_tail_describe(frames):
    _, (pf, jf) = frames
    pd.testing.assert_frame_equal(pf.head(7), jf.head(7))
    pd.testing.assert_frame_equal(pf.tail(5), jf.tail(5))
    pdsc, jdsc = pf.describe(), jf.describe()
    assert list(pdsc.columns) == list(jdsc.columns)
    for c in ("column", "type", "missing", "cardinality"):
        pd.testing.assert_series_equal(pdsc[c], jdsc[c])
    for c in ("mean", "sigma", "min", "max"):
        np.testing.assert_allclose(pdsc[c].to_numpy(np.float64),
                                   jdsc[c].to_numpy(np.float64),
                                   rtol=1e-6, equal_nan=True, err_msg=c)


@pytest.mark.parametrize("kind", ["mask", "index", "negative", "tensor_mask",
                                  "tensor_index"])
def test_subset_rows(frames, kind):
    df, (pf, jf) = frames
    rng = np.random.default_rng(7)
    mask = rng.random(len(df)) < 0.3
    idx = rng.permutation(len(df))[:500]
    sel = {"mask": mask, "index": idx, "negative": -1 - idx,
           "tensor_mask": mask, "tensor_index": idx}[kind]
    want = jf.subset_rows(sel)
    if kind.startswith("tensor"):
        sel = torch.from_numpy(sel)
    assert_same(pf.subset_rows(sel), want)


def test_gather_rows_invalid_rows_are_na(frames):
    df, (pf, jf) = frames
    rng = np.random.default_rng(3)
    rows = rng.integers(-1, len(df), 700)
    valid = rng.random(700) < 0.9
    assert_same(pf.gather_rows(rows), jf.gather_rows(rows))
    assert_same(pf.gather_rows(rows, valid=valid),
                jf.gather_rows(rows, valid=valid))
    got = pf.gather_rows(torch.from_numpy(rows))  # a device index
    assert_same(got, jf.gather_rows(rows))
    bad = rows < 0
    assert (got.vec("e").to_numpy()[bad] == -1).all()
    assert np.isnan(got.vec("x").to_numpy()[bad]).all()
    assert np.isnan(got.vec("t").to_numpy()[bad]).all()
    assert all(s is None for s in got.vec("s").to_numpy()[bad])
    # the time column's exact float64 copy, not its float32 device values
    ok = ~bad
    np.testing.assert_array_equal(
        got.vec("t").to_numpy()[ok],
        pf.vec("t").to_numpy()[rows[ok]])


def test_gather_rows_one_pass_per_dtype(frames, monkeypatch):
    """The device columns are gathered in one ``index_select`` per storage
    dtype (float32 and the int8 enums), not one per column."""
    _, (pf, _) = frames
    calls = []
    real = torch.Tensor.index_select

    def spy(self, dim, index):
        calls.append(self.shape)
        return real(self, dim, index)

    monkeypatch.setattr(torch.Tensor, "index_select", spy)
    pf.gather_rows(np.arange(10))
    assert len(calls) == 2 and sorted(s[0] for s in calls) == [2, 3]


@pytest.mark.parametrize("ratios,seed", [([0.8], 1234), ([0.5, 0.3], 7),
                                         ([0.25, 0.25, 0.5], 42)])
def test_split_frame_same_rows_as_jax(frames, ratios, seed):
    _, (pf, jf) = frames
    got, want = pf.split_frame(ratios, seed=seed), jf.split_frame(ratios,
                                                                  seed=seed)
    assert len(got) == len(want)
    assert sum(p.nrow for p in got) == pf.nrow
    for p, j in zip(got, want):
        assert_same(p, j)
    with pytest.raises(ValueError):
        pf.split_frame([0.8, 0.5])


def test_setitem(frames):
    df, _ = frames
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    jf = h2o3_tpu.upload_file(df)
    for f in (pf, jf):
        f["one"] = 1
        f["x2"] = f.vec("x") * 2
        f["arr"] = np.arange(len(df), dtype=np.float64)
        f["strs"] = np.array([str(i) for i in range(len(df))], dtype=object)
        f["x"] = f[["k"]]
    assert_same(pf, jf)
    with pytest.raises(ValueError):
        pf["short"] = Vec.from_numpy(np.zeros(3), "real", device="cpu")


# ---------------------------------------------------------------------------
# JAX's tree knobs, ported in the tree variants (ROADMAP Queue A 10b)

_KNOBS = {"H2O3_TPU_TREE_GOSS": "0.2,0.1", "H2O3_TPU_TREE_EFB": "1",
          "H2O3_TPU_HIST_I16": "1", "H2O3_TPU_BIN_ADAPT": "1"}


def _tree_df(n=300):
    """Three dense normal columns and two sparse indicators that are never
    set on the same row (EFB bundles them)."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, 3))
    pick = rng.integers(0, 10, n)
    return pd.DataFrame({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                         "d0": (pick == 0).astype(np.float64),
                         "d1": (pick == 1).astype(np.float64),
                         "y": np.where(X[:, 0] + X[:, 1] > 0, "s", "b")})


def _knob_forest(cls, fr):
    m = cls(ntrees=2, max_depth=4, seed=1).train(y="y", training_frame=fr)
    return [[(lv.split_col.copy(), lv.split_bin.copy(), lv.leaf_now.copy(),
              lv.cat_mask.shape[-1]) for lv in t.to_host().levels]
            for g in m.model.output["trees"] for t in g]


def _same_forest(a, b) -> bool:
    return len(a) == len(b) and all(
        len(ta) == len(tb) and all(
            all(np.array_equal(x, y) for x, y in zip(la[:3], lb[:3]))
            and la[3] == lb[3] for la, lb in zip(ta, tb))
        for ta, tb in zip(a, b))


@pytest.mark.parametrize("algo", ["gbm", "xgboost", "drf", "xrt"])
@pytest.mark.parametrize("knob", sorted(_KNOBS))
def test_tree_knob_runs_as_jax(monkeypatch, algo, knob):
    """Each of JAX's tree knobs does for each tree algorithm what JAX's
    builders do with it: GOSS samples every algorithm's trees; EFB bundles
    the sparse pair for GBM and XGBoost and is not read by DRF and XRT (the
    same forest as without it, no plan fitted); the i16
    lane runs every CPU histogram; bin coarsening takes every algorithm's
    depth-3 level to 129 bins."""
    from h2o3_tpu_torch import estimators as E
    from h2o3_tpu_torch.models.tree import binning as pbin
    from h2o3_tpu_torch.models.tree import shared_tree as pst
    from h2o3_tpu_torch.ops import histogram as ph

    cls = {"gbm": E.H2OGradientBoostingEstimator,
           "xgboost": E.H2OXGBoostEstimator,
           "drf": E.H2ORandomForestEstimator, "xrt": E.H2OXRTEstimator}[algo]
    fr = h2o3_tpu_torch.upload_file(_tree_df(), device="cpu")
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    off = _knob_forest(cls, fr)
    before = (pst.goss_stats()["trees"], dict(pbin.EFB_EVENTS),
              ph.I16_EVENTS["histograms"])
    monkeypatch.setenv(knob, _KNOBS[knob])
    on = _knob_forest(cls, fr)
    if knob == "H2O3_TPU_TREE_GOSS":
        assert pst.goss_stats()["trees"] - before[0] == 2
        assert not _same_forest(on, off)
    elif knob == "H2O3_TPU_TREE_EFB":
        bundled = algo in ("gbm", "xgboost")
        assert pbin.EFB_EVENTS["plans"] - before[1]["plans"] == int(bundled)
        assert pbin.EFB_EVENTS["fits"] - before[1]["fits"] == int(bundled)
        # bundled, the default cell is rebuilt as the node total less the
        # other cells: on these float residuals a zero-gain split can part
        # from the unbundled forest, so only the root's split is held there
        assert _same_forest(on, off) if not bundled else _same_forest(
            [t[:1] for t in on], [t[:1] for t in off])
    elif knob == "H2O3_TPU_HIST_I16":
        assert ph.I16_EVENTS["histograms"] > before[2]
    else:
        assert [lv[3] for lv in on[0]] == [256, 256, 256, 129, 256]
        assert [lv[3] for lv in off[0]] == [256] * 5


@pytest.mark.parametrize("algo", ["gbm", "drf"])
def test_tree_knobs_at_defaults_train(monkeypatch, algo):
    from h2o3_tpu_torch import config
    from h2o3_tpu_torch import estimators as E

    for knob in _KNOBS:
        monkeypatch.delenv(knob, raising=False)
        assert config._KNOBS[knob][0] in ("", "0")
    monkeypatch.setenv("H2O3_TPU_TREE_EFB", "0")  # set, at its default
    monkeypatch.setenv("H2O3_TPU_TREE_GOSS", "  ")  # blank, as JAX reads it
    cls = (E.H2OGradientBoostingEstimator if algo == "gbm"
           else E.H2ORandomForestEstimator)
    fr = h2o3_tpu_torch.upload_file(_tree_df(), device="cpu")
    m = cls(ntrees=2, max_depth=2, seed=1)
    m.train(y="y", training_frame=fr)
    assert 0.5 < m.auc() <= 1.0


def test_split_then_gbm_with_validation_matches_jax():
    """The slice end to end: ``split_frame``, a GBM trained on the first
    part with the second as its validation frame, and ``predict`` on it,
    in both packages (integer-valued features: no float near-tie splits).
    Validation logloss and predictions within 1e-5."""
    from h2o3_tpu.models.tree import GBM as JGBM
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    rng = np.random.default_rng(4)
    n = 3000
    X = rng.integers(0, 16, size=(n, 3)).astype(np.float64)
    X[rng.random(n) < 0.05, 1] = np.nan
    cat = rng.integers(0, 3, n)
    eta = 0.3 * X[:, 0] - 0.2 * np.nan_to_num(X[:, 1], nan=8.0) + cat - 1.5
    df = pd.DataFrame({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                       "g": np.array(["u", "v", "w"])[cat],
                       "y": np.where(rng.random(n) < 1 / (1 + np.exp(-eta)),
                                     "yes", "no")})
    jt, jv = h2o3_tpu.upload_file(df).split_frame([0.8], seed=11)
    pt, pv = h2o3_tpu_torch.upload_file(df, device="cpu").split_frame(
        [0.8], seed=11)
    assert_same(pv, jv)
    kw = dict(ntrees=4, max_depth=3, learn_rate=0.1, min_rows=10.0, seed=42)
    jm = JGBM(**kw).train(y="y", training_frame=jt, validation_frame=jv)
    est = H2OGradientBoostingEstimator(**kw)
    est.train(y="y", training_frame=pt, validation_frame=pv)
    assert abs(est.logloss(valid=True) - jm.validation_metrics.logloss) < 1e-5
    np.testing.assert_allclose(
        est.predict(pv).vec("yes").to_numpy(),
        np.asarray(jm.predict(jv).vec("yes").to_numpy())[: jv.nrow],
        atol=1e-5)
