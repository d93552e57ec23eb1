"""The trained-model surface of the port's tree models against the JAX
package, on the CPU at small sizes: ``offset_column`` in GBM (gaussian,
bernoulli, poisson and multinomial; resident and streamed, with a
validation frame, and a checkpoint resume), TreeSHAP
(``predict_contributions``), leaf assignment, ``tree_view``,
``model_summary`` and ``varimp`` of GBM, XGBoost, DRF and XRT models
carried across from JAX, ``h2o3_tpu_torch.explain`` and the estimators'
analysis calls.

Tolerances, with their reasons:
- an offset training against JAX's: trees equal (no parting at all), the
  predictions within 1e-5 (float32 sums of the same leaves in another
  order), the validation metrics within 1e-5;
- the streamed lane against the resident one, and a resumed training
  against the uninterrupted one: trees equal, predictions within 1e-6;
- contributions: within 1e-9 of JAX's recursion run in float64 on the same
  carried-across model (the same arithmetic row by row; the leaves' terms
  add in another order), and the port's device walk within 1e-12 of its
  plain row-by-row version; a row's sum within 1e-5 of the float32 raw
  margin (local accuracy);
- leaf assignment, ``tree_view``, ``model_summary`` and ``varimp``:
  exactly equal;
- explain's numeric results: within 1e-6 (float32 predictions of equal
  trees).
"""

from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

from h2o3_tpu import explain as jexplain  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree import shap as jshap  # noqa: E402
from h2o3_tpu.models.tree.drf import DRF as JDRF  # noqa: E402
from h2o3_tpu.models.tree.drf import XRT as JXRT  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402
from h2o3_tpu.models.tree.xgboost import XGBoost as JXGB  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import explain as pexplain  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OGradientBoostingEstimator,
    H2OIsotonicRegressionEstimator,
)
from h2o3_tpu_torch.models.tree import shap as pshap  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.binning import bin_frame  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import (  # noqa: E402
    drf_from_numpy,
    gbm_from_numpy,
)
from h2o3_tpu_torch.models.tree.drf import DRF, XRT  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM  # noqa: E402
from h2o3_tpu_torch.models.tree.xgboost import XGBoost  # noqa: E402
from h2o3_tpu_torch.tools.tree_parity import divergences  # noqa: E402
from test_torch_slice import _frame_df  # noqa: E402

KW = dict(ntrees=4, max_depth=3, learn_rate=0.3, min_rows=5.0, seed=42)
# DRF and XRT without draws, so both packages grow the same trees
FOREST_KW = dict(ntrees=3, max_depth=4, min_rows=5.0, sample_rate=1.0,
                 mtries=-2, seed=42)
WINDOW = 6 * 1024  # streams the 400-row training frame in row blocks


def surface_df(n=400, seed=0) -> pd.DataFrame:
    """``_frame_df`` (5 numeric columns with NAs and ties, an enum with NAs,
    a binary label) with an offset column, a numeric and a count response
    and a 3-class response."""
    df = _frame_df(n=n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    x0 = np.nan_to_num(df["x0"].to_numpy(np.float64))
    df["off"] = (0.1 * rng.normal(size=n)).astype(np.float32)
    df["yreg"] = (2.0 * x0 - df["x2"].to_numpy() + rng.normal(0, 0.3, n)
                  ).astype(np.float32)
    df["ycount"] = rng.poisson(np.exp(0.4 * x0)).astype(np.float32)
    df["k3"] = np.array(["u", "v", "w"])[
        np.digitize(x0 + rng.normal(0, 0.5, n), [-0.5, 0.5])]
    return df


RESPONSES = {"bernoulli": "label", "gaussian": "yreg", "poisson": "ycount",
             "multinomial": "k3"}
OTHER_Y = [c for c in RESPONSES.values()]


def frames(df, y):
    """The JAX and port frames of ``df`` without the responses but ``y``."""
    d = df.drop(columns=[c for c in OTHER_Y if c != y])
    return JFrame.from_pandas(d), h2o3_tpu_torch.upload_file(d, device="cpu")


def jax_numpy(jm) -> dict:
    """A JAX tree model's output as the numpy dict ``convert`` takes,
    with the covers, the importances and the calibration."""
    spec = jm.output["bin_spec"]
    levels = pst.REPLAY_FIELDS + ("node_w", "gain")
    out = {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards",
                      "domains")},
        "trees": [[[{f: None if getattr(lv, f) is None
                     else np.asarray(getattr(lv, f)) for f in levels}
                    for lv in t.levels] for t in group]
                  for group in jm.output["trees"]],
        "n_tree_classes": jm.output.get("n_tree_classes", 1),
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
        "varimp": jm.output.get("varimp"),
    }
    for k in ("init_f", "distribution", "calibration"):
        if k in jm.output:
            out[k] = jm.output[k]
    return out


def carried(jm, algo):
    """The JAX model ``jm`` as a port model on the CPU."""
    params = {"response_column": jm.params.response_column,
              "offset_column": jm.params.offset_column}
    if algo in ("gbm", "xgboost"):
        return gbm_from_numpy(jax_numpy(jm), device="cpu", algo=algo,
                              params=params)
    return drf_from_numpy(jax_numpy(jm), device="cpu", algo=algo,
                          params=params)


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """The JAX programs compiled here are not written to the persistent
    compilation cache the test processes share (it writes entries in
    place, without a lock: a reader in another process may load a
    truncated program). Reads stay on."""
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
def df():
    return surface_df()


@pytest.fixture(scope="module")
def valid_df():
    return surface_df(n=200, seed=1)


# ---------------------------------------------------------------------------
# offset_column


OFFSET_DISTS = ["gaussian", "bernoulli", "poisson"]


@pytest.fixture(scope="module")
def offset_pairs(df, valid_df):
    """Per distribution, the offset GBM with a validation frame in both
    packages (trained once per worker that asks)."""
    out = {}
    for dist in OFFSET_DISTS:
        y = RESPONSES[dist]
        jtr, ptr = frames(df, y)
        jva, pva = frames(valid_df, y)
        kw = dict(KW, distribution=dist, offset_column="off")
        jm = JGBM(**kw).train(y=y, training_frame=jtr, validation_frame=jva)
        pm = GBM(**kw).train(y=y, training_frame=ptr, validation_frame=pva)
        out[dist] = (jm, pm, jva, pva)
    return out


def _pred(model, frame, col):
    return model.predict(frame).vec(col).to_numpy().astype(np.float64)


@pytest.mark.parametrize("dist", OFFSET_DISTS)
def test_offset_gbm_equals_jax(offset_pairs, dist):
    """The offset enters F, never the init score: the port grows JAX's
    trees, keeps its init score, predicts with the scored frame's offset
    and reports its validation metrics."""
    jm, pm, jva, pva = offset_pairs[dist]
    d = divergences(SimpleNamespace(model=pm), SimpleNamespace(model=jm))
    assert d["partings"] == []
    assert pm.output["init_f"] == pytest.approx(float(jm.output["init_f"]),
                                                abs=1e-6)
    col = "s" if dist == "bernoulli" else "predict"
    np.testing.assert_allclose(_pred(pm, pva, col), _pred(jm, jva, col),
                               atol=1e-5)
    for name in ("rmse", "mse"):
        assert pm.validation_metrics.value(name) == pytest.approx(
            jm.validation_metrics.value(name), abs=1e-5)
    # the scored frame's offset shifts the margin
    no_off = pva.drop("off")
    assert not np.allclose(_pred(pm, no_off, col), _pred(pm, pva, col))


@pytest.mark.parametrize("dist", OFFSET_DISTS)
def test_offset_streamed_equals_resident(offset_pairs, df, valid_df, dist,
                                         monkeypatch):
    """The streamed lane starts its score lane at f0 + offset block by
    block: the same trees and predictions as the resident lane."""
    _, pm, _, pva = offset_pairs[dist]
    y = RESPONSES[dist]
    _, ptr = frames(df, y)
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(WINDOW))
    from h2o3_tpu_torch.frame import chunkstore as cs

    cs.LAST_STORE_STATS.clear()
    sm = GBM(**KW, distribution=dist, offset_column="off").train(
        y=y, training_frame=ptr, validation_frame=pva)
    assert cs.LAST_STORE_STATS.get("n_blocks", 0) > 1
    assert divergences(SimpleNamespace(model=sm),
                       SimpleNamespace(model=pm))["partings"] == []
    col = "s" if dist == "bernoulli" else "predict"
    np.testing.assert_allclose(_pred(sm, pva, col), _pred(pm, pva, col),
                               atol=1e-6)
    assert sm.validation_metrics.value("rmse") == pytest.approx(
        pm.validation_metrics.value("rmse"), abs=1e-6)


@pytest.mark.parametrize("dist", OFFSET_DISTS)
def test_offset_checkpoint_resume_equals_uninterrupted(offset_pairs, df,
                                                       valid_df, dist):
    """A resumed offset training starts F at f0 + offset + the prior's
    trees: the resumed model equals the uninterrupted one."""
    _, pm, _, pva = offset_pairs[dist]
    y = RESPONSES[dist]
    _, ptr = frames(df, y)
    kw = dict(KW, distribution=dist, offset_column="off")
    half = GBM(**dict(kw, ntrees=2)).train(y=y, training_frame=ptr,
                                            validation_frame=pva)
    res = GBM(**kw, checkpoint=half).train(y=y, training_frame=ptr,
                                           validation_frame=pva)
    assert divergences(SimpleNamespace(model=res),
                       SimpleNamespace(model=pm))["partings"] == []
    col = "s" if dist == "bernoulli" else "predict"
    np.testing.assert_allclose(_pred(res, pva, col), _pred(pm, pva, col),
                               atol=1e-6)
    assert res.training_metrics.value("rmse") == pytest.approx(
        pm.training_metrics.value("rmse"), abs=1e-6)


def test_offset_multinomial_keeps_jax_rule(df):
    """Multinomial: JAX adds the offset to every class's training F but
    returns its prediction before adding it; the port does the same (the
    trees equal JAX's, the probabilities too, and they ignore the scored
    frame's offset). An offset shared by every class leaves the softmax
    and its gradients as they were, up to rounding."""
    jtr, ptr = frames(df, "k3")
    kw = dict(KW, ntrees=2, max_depth=2, min_rows=20.0, offset_column="off")
    jm = JGBM(**kw).train(y="k3", training_frame=jtr)
    pm = GBM(**kw).train(y="k3", training_frame=ptr)
    assert divergences(SimpleNamespace(model=pm),
                       SimpleNamespace(model=jm))["partings"] == []
    for c in ("u", "v", "w"):
        np.testing.assert_allclose(_pred(pm, ptr, c), _pred(jm, jtr, c),
                                   atol=1e-5)
        np.testing.assert_array_equal(_pred(pm, ptr.drop("off"), c),
                                      _pred(pm, ptr, c))


def test_offset_column_missing_from_training_frame(df):
    _, ptr = frames(df, "label")
    with pytest.raises(ValueError, match="offset_column"):
        GBM(**KW, offset_column="nope").train(y="label", training_frame=ptr)


# ---------------------------------------------------------------------------
# the analysis calls on models carried across from JAX


ALGOS = ["gbm", "xgboost", "drf", "xrt"]
_JAX_BUILDERS = {"gbm": (JGBM, KW), "xgboost": (JXGB, dict(KW, ntrees=3)),
                 "drf": (JDRF, FOREST_KW), "xrt": (JXRT, FOREST_KW)}


@pytest.fixture(scope="module")
def carried_models(df):
    """Per algo, a binomial JAX model, its port copy, and both frames."""
    jtr, ptr = frames(df, "label")
    out = {}
    for algo, (cls, kw) in _JAX_BUILDERS.items():
        jm = cls(**kw).train(y="label", training_frame=jtr)
        out[algo] = (jm, carried(jm, algo), jtr, ptr)
    return out


def jax_contributions64(jm, jfr) -> np.ndarray:
    """JAX's ``predict_contributions`` recursion, run with JAX's own
    functions, kept in float64 (its Frame rounds to float32)."""
    from h2o3_tpu.models.tree.binning import bin_frame as jbin

    out = jm.output
    bins = np.asarray(jbin(out["bin_spec"], jfr))[: jfr.nrow]
    C = len(out["names"])
    phi = np.zeros((jfr.nrow, C + 1))
    bias = 0.0
    for group in out["trees"]:
        nodes = jshap._tree_nodes(group[0])
        bias += jshap._expected_value(nodes, 0)
        for r in range(jfr.nrow):
            row = np.zeros(C + 1)
            jshap._shap_one_tree(nodes, bins[r], row[:C])
            phi[r, :C] += row[:C]
    if jm.algo == "gbm":
        bias += float(np.asarray(out["init_f"]))
    if jm.algo in ("drf", "xrt"):
        phi[:, :C] /= max(out["ntrees_actual"], 1)
        bias /= max(out["ntrees_actual"], 1)
    phi[:, C] = bias
    return phi


@pytest.mark.parametrize("algo", ALGOS)
def test_contributions_equal_jax(carried_models, algo):
    """Device walk (here on CPU tensors) within 1e-9 of JAX's float64
    recursion; the Frame equals JAX's float32 Frame; the plain version
    within 1e-12 of the device walk."""
    jm, pm, jtr, ptr = carried_models[algo]
    got = pshap.contributions(pm, ptr).numpy()
    want = jax_contributions64(jm, jtr)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    fr = pm.predict_contributions(ptr)
    jfr = jm.predict_contributions(jtr)
    assert fr.names == jfr.names and fr.names[-1] == "BiasTerm"
    for c in fr.names:
        np.testing.assert_allclose(fr.vec(c).to_numpy(),
                                   jfr.vec(c).to_numpy(), rtol=0, atol=1e-9)
    plain = pshap.contributions_plain(pm, ptr)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-12)


@pytest.mark.parametrize("algo", ALGOS)
def test_contributions_local_accuracy(carried_models, algo):
    """A row's contributions and bias sum to its raw margin: the replay's
    sum of trees plus init score (GBM), the same without the init score
    (XGBoost, JAX's bias rule), or the tree average (DRF, XRT)."""
    _, pm, _, ptr = carried_models[algo]
    total = pshap.contributions(pm, ptr).numpy().sum(axis=1)
    raw = pm._replay_all(ptr).double().numpy()
    if algo == "gbm":
        raw = raw + pm.output["init_f"]
    if algo in ("drf", "xrt"):
        raw = raw / pm.output["ntrees_actual"]
    np.testing.assert_allclose(total, raw, rtol=0, atol=1e-5)


def test_contributions_stump_closed_form():
    """Depth-1 stump: the split feature's contribution is f(x) - E[f], the
    other features' 0, the bias constant."""
    rng = np.random.default_rng(22)
    n = 500
    d = pd.DataFrame({"a": rng.normal(size=n), "b": rng.normal(size=n)})
    d["y"] = np.where(d["a"] > 0, 2.0, -1.0)
    fr = h2o3_tpu_torch.upload_file(d, device="cpu")
    m = GBM(ntrees=1, max_depth=1, learn_rate=1.0, distribution="gaussian",
            seed=1).train(y="y", training_frame=fr)
    c = m.predict_contributions(fr)
    np.testing.assert_allclose(c.vec("b").to_numpy(), 0.0, atol=1e-6)
    pred = m.predict(fr).vec("predict").to_numpy().astype(np.float64)
    bias = c.vec("BiasTerm").to_numpy()
    np.testing.assert_allclose(c.vec("a").to_numpy() + bias, pred, atol=1e-5)
    assert np.all(bias == bias[0])


def test_contributions_refuse_multinomial(df):
    _, ptr = frames(df, "k3")
    m = GBM(**dict(KW, ntrees=1)).train(y="k3", training_frame=ptr)
    with pytest.raises(ValueError, match="regression/binomial"):
        m.predict_contributions(ptr)
    with pytest.raises(ValueError, match="regression/binomial"):
        pshap.contributions_plain(m, ptr)


def test_contributions_in_row_blocks(carried_models, monkeypatch):
    """Rows in blocks (a small path-state budget) give the same
    contributions."""
    _, pm, _, ptr = carried_models["gbm"]
    whole = pshap.contributions(pm, ptr).numpy()
    monkeypatch.setattr(pshap, "_BLOCK_BYTES", 8 * 25 * 64)
    np.testing.assert_array_equal(pshap.contributions(pm, ptr).numpy(),
                                  whole)


@pytest.mark.parametrize("kind", ["Path", "Node_ID"])
@pytest.mark.parametrize("algo", ALGOS)
def test_leaf_assignment_equals_jax(carried_models, algo, kind):
    """Both types exactly equal to JAX's: column names, the Path domain
    and codes, the node ids."""
    jm, pm, jtr, ptr = carried_models[algo]
    got = pm.predict_leaf_node_assignment(ptr, type=kind)
    want = jm.predict_leaf_node_assignment(jtr, type=kind)
    assert got.names == want.names
    for c in got.names:
        g, w = got.vec(c), want.vec(c)
        assert g.kind == w.kind and g.domain == w.domain
        np.testing.assert_array_equal(g.to_numpy(), w.to_numpy())


def test_leaf_assignment_matches_replay_and_paths(carried_models):
    """Each Node_ID is a leaf whose value is what the replay adds for
    that tree; Path and Node_ID name the same leaves one to one; a bad
    type raises."""
    _, pm, _, ptr = carried_models["gbm"]
    ids = pm.predict_leaf_node_assignment(ptr, type="Node_ID")
    paths = pm.predict_leaf_node_assignment(ptr, type="Path")
    bins = bin_frame(pm.output["bin_spec"], ptr)
    for ti, (t,) in enumerate(pm.output["trees"]):
        nodes = pshap._tree_nodes(t)
        nid = ids.vec(ti).to_numpy().astype(int)
        assert all(nodes[j].is_leaf for j in np.unique(nid))
        _, add = t.replay(bins, torch.zeros(ptr.nrow, dtype=torch.int32),
                          torch.zeros(ptr.nrow))
        np.testing.assert_array_equal(
            np.array([nodes[j].value for j in nid], np.float32),
            add.numpy())
        pv = paths.vec(ti)
        s = np.asarray(pv.domain, object)[pv.to_numpy().astype(int)]
        assert len(set(zip(s, nid))) == len(set(s)) == len(set(nid))
    with pytest.raises(ValueError, match="Path"):
        pm.predict_leaf_node_assignment(ptr, type="leaf")


@pytest.mark.parametrize("algo", ALGOS)
def test_tree_view_summary_varimp_equal_jax(carried_models, algo):
    jm, pm, _, _ = carried_models[algo]
    for ti in range(pm.output["ntrees_actual"]):
        assert pm.tree_view(ti) == jm.tree_view(ti)
    assert pm.model_summary() == jm.model_summary()
    assert pm.model_summary() is pm.model_summary()  # cached
    assert pm.varimp() == jm.varimp()
    for pt, (jt,) in zip((g[0] for g in pm.output["trees"]),
                         jm.output["trees"]):
        assert (pt.depth, pt.n_leaves) == (jt.depth, jt.n_leaves)


def test_port_trained_surface_on_cpu(df):
    """A model the port trains has every call: its tree table names its
    features, the summary counts its trees, varimp ranks the signal."""
    _, ptr = frames(df, "label")
    m = XGBoost(**dict(KW, ntrees=3)).train(y="label", training_frame=ptr)
    tv = m.tree_view(0)
    assert tv["node_id"][0] == 0 and not tv["is_leaf"][0]
    assert set(f for f in tv["feature"] if f) <= set(m.output["names"])
    assert m.model_summary()["number_of_trees"] == 3
    assert m.varimp()[0]["variable"] in ("x0", "x2", "cat")
    assert m.summary()["algo"] == "xgboost"
    c = pshap.contributions(m, ptr).numpy()
    np.testing.assert_allclose(c, pshap.contributions_plain(m, ptr),
                               rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# explain


@pytest.fixture(scope="module")
def explain_pair(df, offset_pairs):
    """The bernoulli offset GBMs (equal trees, scoring histories) and a
    second model each for the cross-model calls."""
    jm, pm, _, _ = offset_pairs["bernoulli"]
    jtr, ptr = frames(df, "label")
    kw = dict(KW, ntrees=2, max_depth=2)
    j2 = JGBM(**kw).train(y="label", training_frame=jtr)
    p2 = GBM(**kw).train(y="label", training_frame=ptr)
    return (jm, j2, jtr), (pm, p2, ptr)


def _close(a, b):
    """Equal structure, numbers within 1e-6."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)) and len(a) and isinstance(
            a[0], (dict, list, tuple, str)):
        assert len(a) == len(b)
        for x, z in zip(a, b):
            _close(x, z)
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64), atol=1e-6)
    elif isinstance(a, float):
        assert a == pytest.approx(b, abs=1e-6)
    else:
        assert a == b


def _explain_parts(out) -> dict:
    """``explain`` output without model keys (each package mints its
    own): the importances in model order, and the other artifacts."""
    parts = {k: v for k, v in out.items()
             if k not in ("varimp", "varimp_heatmap", "model_correlation")}
    parts["varimp"] = list(out["varimp"].values())
    parts["varimp_heatmap"] = {k: v for k, v in out["varimp_heatmap"].items()
                               if k != "models"}
    parts["model_correlation"] = out["model_correlation"]["correlation"]
    return parts


EXPLAIN_CALLS = {
    "varimp": lambda ex, m, m2, fr: ex.varimp(m),
    "varimp_heatmap": lambda ex, m, m2, fr: {
        k: v for k, v in ex.varimp_heatmap([m, m2]).items()
        if k != "models"},
    "partial_dependence": lambda ex, m, m2, fr: ex.partial_dependence(
        m, fr, "x0", nbins=5, sample_rows=300),
    "partial_dependence_enum": lambda ex, m, m2, fr: ex.partial_dependence(
        m, fr, "cat"),
    "ice": lambda ex, m, m2, fr: ex.ice(m, fr, "x2", nbins=4,
                                        sample_rows=20),
    "shap_summary": lambda ex, m, m2, fr: ex.shap_summary(m, fr, top_n=4),
    "model_correlation": lambda ex, m, m2, fr: ex.model_correlation(
        [m, m2], fr)["correlation"],
    "residual_analysis": lambda ex, m, m2, fr: ex.residual_analysis(m, fr),
    "learning_curve": lambda ex, m, m2, fr: ex.learning_curve(m),
    "explain": lambda ex, m, m2, fr: _explain_parts(ex.explain([m, m2], fr)),
}


@pytest.mark.parametrize("call", list(EXPLAIN_CALLS))
def test_explain_equals_jax(explain_pair, call):
    (jm, j2, jfr), (pm, p2, pfr) = explain_pair
    fn = EXPLAIN_CALLS[call]
    _close(fn(pexplain, pm, p2, pfr), fn(jexplain, jm, j2, jfr))


@pytest.mark.parametrize("plot", ["varimp_plot", "learning_curve_plot",
                                  "roc_plot", "pd_plot", "shap_summary_plot"])
def test_explain_plots_render(explain_pair, plot, tmp_path):
    """The matplotlib renderings (skipped where matplotlib is absent)."""
    pytest.importorskip("matplotlib")
    _, (pm, _, pfr) = explain_pair
    fn = getattr(pexplain, plot)
    args = {"pd_plot": (pm, pfr, "x0"), "shap_summary_plot": (pm, pfr)}.get(
        plot, (pm,))
    out = tmp_path / f"{plot}.png"
    fn(*args, save=str(out))
    assert out.stat().st_size > 0


# ---------------------------------------------------------------------------
# estimators


def test_estimator_analysis_calls(df):
    """The estimator proxies: contributions, leaf assignment, varimp as
    pandas, gains/lift and KS of the training metrics."""
    _, ptr = frames(df, "label")
    est = H2OGradientBoostingEstimator(**KW)
    est.train(y="label", training_frame=ptr)
    m = est.model
    c = est.predict_contributions(ptr)
    np.testing.assert_array_equal(c.vec("BiasTerm").to_numpy(),
                                  m.predict_contributions(ptr).vec(
                                      "BiasTerm").to_numpy())
    assert est.predict_leaf_node_assignment(ptr, type="Node_ID").names == \
        [f"T{i + 1}.C1" for i in range(KW["ntrees"])]
    vi = est.varimp(use_pandas=True)
    assert list(vi["variable"]) == [r["variable"] for r in m.varimp()]
    assert est.gains_lift() == m.training_metrics.gains_lift()
    assert est.kolmogorov_smirnov() == m.training_metrics.value("ks")


def test_isotonic_estimator(df):
    d = df[["x0", "yreg"]]
    fr = h2o3_tpu_torch.upload_file(d, device="cpu")
    est = H2OIsotonicRegressionEstimator()
    est.train(x=["x0"], y="yreg", training_frame=fr)
    p = est.predict(fr).vec("predict").to_numpy()
    x = d["x0"].to_numpy()
    ok = ~np.isnan(x)
    assert np.all(np.diff(p[ok][np.argsort(x[ok])]) >= 0)
    assert np.isnan(p[~ok]).all()
    with pytest.raises(AssertionError, match="one feature"):
        H2OIsotonicRegressionEstimator().train(
            y="yreg", training_frame=h2o3_tpu_torch.upload_file(
                df[["x0", "x2", "yreg"]], device="cpu"))
