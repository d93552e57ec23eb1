"""DRF and XRT in the port (``models/tree/drf.py``) against the JAX package,
on the CPU at small sizes: exact parity where neither package draws
(``sample_rate=1.0``, ``mtries=-2``), a sampled JAX DRF carried across with
``drf_from_numpy``, the tmojo export scored by both offline scorers, and
the estimators' surface. Parity by distribution, where both packages
draw, is in ``tests/test_torch_sampling.py``. Inputs are made with numpy
from seeds and handed to both packages.

Tolerances, with their reasons:
- exact parity: every split field equal and leaf values within 1e-6, on
  responses whose histogram sums are exact in float32 in any order (0/1
  labels, one-hot classes, small integers), since JAX sums histograms
  across an 8-device mesh and the port on one device; predictions within
  1e-6 (the same float32 adds in another order);
- conversion: predictions within 1e-6 (the same trees replayed);
- export: both scorers within 1e-6 of ``predict`` (float64 sums of the
  same float32 leaves).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu import genmodel as jgen  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree import drf as jdrf  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2ORandomForestEstimator,
    H2OXRTEstimator,
)
from h2o3_tpu_torch.models.tree import drf as pdrf  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import drf_from_numpy  # noqa: E402

_RESPONSES = ("label", "yreg", "yk")
_CLASSES = {"label": ("b", "s"), "yk": ("u", "v", "w"), "yreg": None}
# one tree shape for every model of the exact suite, so JAX compiles its
# scanned program once: the same frame, depth and chunk, only the
# response differs
_EXACT_KW = dict(ntrees=5, max_depth=7, sample_rate=1.0, mtries=-2, seed=3)
_KINDS = {"binomial": ("drf", "label"), "regression": ("drf", "yreg"),
          "multinomial": ("drf", "yk"), "xrt": ("xrt", "label")}


def drf_df(n=2000, seed=0) -> pd.DataFrame:
    """5 numeric columns (NAs in one, ties in one), an enum column with
    NAs, and three responses of those features: a binary label, a small
    integer (regression) and a 3-class label."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(5)])
    df.loc[rng.random(n) < 0.1, "x1"] = np.nan
    df["x3"] = np.round(df["x3"] * 2)
    levels = np.array(["lo", "mid", "hi", "top"])
    cat = rng.integers(0, 4, n)
    df["cat"] = np.where(rng.random(n) < 0.07, None, levels[cat])
    eta = 1.2 * X[:, 0] - X[:, 2] + 0.7 * (cat - 1.5) + X[:, 3] * X[:, 4]
    df["label"] = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "s", "b")
    df["yreg"] = np.round(2 * eta + rng.normal(size=n)).astype(np.float32)
    df["yk"] = np.array(["u", "v", "w"])[np.digitize(
        eta + rng.normal(size=n), [-0.7, 0.7])]
    return df


def _probs(pred_frame, response, n) -> np.ndarray:
    classes = _CLASSES[response]
    cols = classes or ("predict",)
    return np.stack([np.asarray(pred_frame.vec(c).to_numpy())[:n]
                     for c in cols], 1).astype(np.float64)


def _train_both(algo, response, df, jf, pf, **kw):
    ignored = [r for r in _RESPONSES if r != response]
    jcls = {"drf": jdrf.DRF, "xrt": jdrf.XRT}[algo]
    jm = jcls(ignored_columns=ignored, **kw).train(y=response,
                                                   training_frame=jf)
    est = {"drf": H2ORandomForestEstimator, "xrt": H2OXRTEstimator}[algo](
        ignored_columns=ignored, **kw)
    est.train(y=response, training_frame=pf)
    return jm, est


@pytest.fixture(scope="module")
def data():
    df = drf_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


@pytest.fixture(scope="module")
def exact(data):
    """A JAX and a port model of each kind, trained with no draws."""
    df, jf, pf = data
    return {kind: _train_both(algo, resp, df, jf, pf, **_EXACT_KW)
            for kind, (algo, resp) in _KINDS.items()}


@pytest.mark.parametrize("kind", list(_KINDS))
def test_drf_equals_jax_without_draws(data, exact, kind):
    """Binomial, regression, 3-class and XRT at ``sample_rate=1.0`` and
    ``mtries=-2`` (every row and column in every tree): every tree's splits
    equal JAX's, level by level, leaf values within 1e-6, predictions
    within 1e-6."""
    df, jf, pf = data
    jm, est = exact[kind]
    resp = _KINDS[kind][1]
    K = 3 if resp == "yk" else 1
    assert est.model.algo == _KINDS[kind][0]
    assert len(jm.output["trees"]) == len(est.model.output["trees"]) == 5
    for jg, pg in zip(jm.output["trees"], est.model.output["trees"]):
        assert len(jg) == len(pg) == K
        for jt, pt in zip(jg, pg):
            host = pt.to_host()
            assert len(jt.levels) == len(host.levels) == 8
            for li, (jl, pl) in enumerate(zip(jt.levels, host.levels)):
                for f in ("split_col", "split_bin", "is_cat", "cat_mask",
                          "na_left", "leaf_now", "child_base"):
                    np.testing.assert_array_equal(
                        getattr(pl, f), np.asarray(getattr(jl, f)),
                        err_msg=f"{kind} level {li} {f}")
                np.testing.assert_allclose(pl.leaf_val,
                                           np.asarray(jl.leaf_val),
                                           atol=1e-6)
    n = len(df)
    np.testing.assert_allclose(_probs(est.predict(pf), resp, n),
                               _probs(jm.predict(jf), resp, n), atol=1e-6)
    # the training metrics of the averaged sums, as JAX reports them
    name = {"regression": "rmse"}.get(kind, "logloss")
    assert abs(est.model.training_metrics.value(name)
               - jm.training_metrics.value(name)) <= 1e-6


def _numpy_output(jm) -> dict:
    """A JAX DRF's ``output`` as numpy (what ``drf_from_numpy`` reads)."""
    spec = jm.output["bin_spec"]
    return {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards", "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f)) for f in pst.REPLAY_FIELDS}
                    for lv in t.levels] for t in group]
                  for group in jm.output["trees"]],
        "n_tree_classes": jm.output["n_tree_classes"],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
    }


@pytest.mark.parametrize("case", ["sampled-binomial", "multinomial"])
def test_jax_drf_carried_across_predicts_like_jax(data, exact, case):
    """A JAX DRF handed over as numpy predicts in the port what it
    predicts in JAX: a binomial one trained with its default draws
    (bootstrap 0.632, mtries √C), and the exact suite's 3-class one (K
    trees per iteration)."""
    df, jf, pf = data
    if case == "multinomial":
        jm, response = exact["multinomial"][0], "yk"
    else:
        response = "label"
        jm = jdrf.DRF(ntrees=5, max_depth=7, seed=5,
                      ignored_columns=["yreg", "yk"]).train(
            y=response, training_frame=jf)
    pm = drf_from_numpy(_numpy_output(jm), device="cpu")
    n = len(df)
    np.testing.assert_allclose(_probs(pm.predict(pf), response, n),
                               _probs(jm.predict(jf), response, n),
                               atol=1e-6)
    assert pm.algo == "drf"


@pytest.mark.parametrize("kind", ["binomial", "regression", "multinomial",
                                  "xrt"])
def test_drf_and_xrt_tmojo_score_like_predict(data, exact, kind, tmp_path):
    """The port's DRF and XRT models through ``download_mojo``: JAX's
    ``genmodel.MojoModel`` and the port's scorer both score them within
    1e-6 of the port's ``predict``; the artifact has no init score and no
    distribution, as JAX writes DRF's."""
    import json
    import zipfile

    df, _, pf = data
    _, est = exact[kind]
    resp = _KINDS[kind][1]
    path = est.download_mojo(str(tmp_path))
    meta = json.loads(zipfile.ZipFile(path).read("model.json"))
    assert meta["algo"] == _KINDS[kind][0]
    assert meta["init_f"] is None and meta["distribution"] is None
    want = _probs(est.predict(pf), resp, len(df))
    table = df.drop(columns=list(_RESPONSES))
    for mod in (jgen, pgen):
        out = mod.MojoModel.load(path).predict(table)
        cols = _CLASSES[resp] or ("predict",)
        got = np.stack([np.asarray(out[c], np.float64) for c in cols], 1)
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=mod.__name__)


def test_validation_metrics_equal_model_performance(data):
    """A sampled DRF with a validation frame: the validation metrics the
    interval loop keeps (the trees replayed onto the validation bins,
    averaged) equal ``model_performance`` of its ``predict``, and the
    scoring history has one entry per interval."""
    df, _, pf = data
    valid = h2o3_tpu_torch.upload_file(drf_df(n=700, seed=9), device="cpu")
    est = H2ORandomForestEstimator(ntrees=6, max_depth=8, seed=1,
                                   score_tree_interval=2,
                                   ignored_columns=["yreg", "yk"])
    est.train(y="label", training_frame=pf, validation_frame=valid)
    vm, perf = est.model.validation_metrics, est.model_performance(valid)
    for k in ("auc", "logloss", "rmse"):
        assert abs(vm.value(k) - perf.value(k)) <= 1e-6, k
    hist = est.model.scoring_history
    assert [h["ntrees"] for h in hist] == [2, 4, 6]
    assert hist[-1]["validation_logloss"] == pytest.approx(vm.logloss,
                                                           abs=1e-6)


def test_estimators_have_jax_names_and_defaults():
    """Every parameter of the port's DRF exists in JAX's with the same
    default, and DRF's own ones are all there; both estimators take them
    and refuse an unknown name; the options not ported raise."""
    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.default is not dataclasses.MISSING}

    jd, pd_ = defaults(jdrf.DRFParams), defaults(pdrf.DRFParams)
    assert {k: jd[k] for k in pd_} == pd_
    own = {"ntrees": 50, "max_depth": 20, "min_rows": 1.0, "mtries": -1,
           "sample_rate": 0.632, "binomial_double_trees": False,
           "col_sample_rate_per_tree": 1.0, "nbins": 255,
           "min_split_improvement": 1e-5, "score_tree_interval": 5,
           "calibrate_model": False}
    assert {k: pd_[k] for k in own} == own
    for cls in (H2ORandomForestEstimator, H2OXRTEstimator):
        cls(**pd_)
        with pytest.raises(TypeError):
            cls(learn_rate=0.1)
    fr = h2o3_tpu_torch.upload_file(drf_df(n=50), device="cpu")
    for kw, err in ((dict(checkpoint="m"), ValueError),
                    (dict(calibrate_model=True), NotImplementedError)):
        with pytest.raises(err):
            H2ORandomForestEstimator(**kw).train(y="label",
                                                 training_frame=fr)
