"""Isotonic regression and probability calibration in the port
(``h2o3_tpu_torch.models.isotonic``, ``h2o3_tpu_torch.models.calibration``)
against the JAX package, on the CPU at small sizes: PAV and its knots, the
interpolation (numpy's answers at ties, repeated knots, out of range and
NaN), the isotonic model with weights, NAs and ties, Platt scaling and
isotonic calibration fits and their application, ``calibrate_model`` on
GBM, XGBoost, DRF and XRT with JAX's refusals before the build, the
calibrator in the tmojo and through save/load.

Tolerances, with their reasons:
- PAV, the knots, the fits and their application, the isotonic model's
  float64 predictions: within 1e-12 (the same float64 arithmetic; numpy's
  and PyTorch's ``exp``/``log`` may differ in the last bit);
- a calibrated model trained in both packages: trees equal (no parting),
  so the predictions on the calibration frame agree to float32 rounding;
  the calibrators within 1e-6 and ``cal_p1`` within 1e-6;
- a JAX model carried across: ``cal_p1`` within 1e-7 of JAX's (the same
  float32 p1, calibrated in float64, stored as float32);
- the tmojo's p1 within 1e-6 of ``predict``'s (float64 sums of float32
  leaves against float32 sums), its ``cal_p1`` within 1e-12 of the
  calibrator applied to that p1 and, for Platt scaling, within 1e-6 of
  ``predict``'s; a loaded model's equal.
"""

import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

import h2o3_tpu.genmodel as jgen  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import calibration as jcal  # noqa: E402
from h2o3_tpu.models import isotonic as jiso  # noqa: E402
from h2o3_tpu.models.tree.drf import DRF as JDRF  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OGradientBoostingEstimator,
    H2ORandomForestEstimator,
    H2OXGBoostEstimator,
    H2OXRTEstimator,
)
from h2o3_tpu_torch.models import calibration as pcal  # noqa: E402
from h2o3_tpu_torch.models import isotonic as piso  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import (  # noqa: E402
    gbm_from_numpy,
    isotonic_from_numpy,
)
from h2o3_tpu_torch.models.tree.drf import DRF  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM  # noqa: E402
from h2o3_tpu_torch.tools.tree_parity import divergences  # noqa: E402
from test_torch_model_surface import jax_numpy  # noqa: E402

KW = dict(ntrees=6, max_depth=3, learn_rate=0.3, min_rows=5.0, seed=1)
DRF_KW = dict(ntrees=3, max_depth=4, min_rows=5.0, sample_rate=1.0, mtries=-2,
              seed=1)
METHODS = {"platt": "AUTO", "isotonic": "IsotonicRegression"}


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """No writes to the persistent JAX compilation cache the test processes
    share (entries are written in place, without a lock). Reads stay on."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cal_df(n=1500, seed=2) -> pd.DataFrame:
    """JAX's calibration test frame, cut to size: 5 normal features, a
    binary label from two of them."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    eta = 0.8 * X[:, 0] - 0.5 * X[:, 1]
    y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int)
    df = pd.DataFrame(X, columns=list("abcde"))
    df["y"] = np.where(y == 1, "Y", "N")
    return df


@pytest.fixture(scope="module")
def parts():
    """(train, calibration, test) pandas frames."""
    df = cal_df()
    return (df.iloc[:500].reset_index(drop=True),
            df.iloc[500:1000].reset_index(drop=True),
            df.iloc[1000:].reset_index(drop=True))


def _up(d):
    return h2o3_tpu_torch.upload_file(d, device="cpu")


# ---------------------------------------------------------------------------
# PAV, interpolation, the isotonic model


@pytest.mark.parametrize("case", ["random", "ties", "monotone", "reversed"])
def test_pav_and_knots_equal_jax(case):
    rng = np.random.default_rng(3)
    y = {"random": rng.normal(size=200),
         "ties": np.repeat(rng.normal(size=20), 10),
         "monotone": np.arange(50.0),
         "reversed": -np.arange(50.0)}[case]
    w = rng.uniform(0.2, 3.0, len(y))
    got, want = piso._pav(y, w), jiso._pav(y, w)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(piso.pav_block_knots(got),
                                  jiso.pav_block_knots(want))
    assert np.all(np.diff(got) >= -1e-12)


INTERP_CASES = {
    "inside": (np.array([0.0, 1.0, 2.5, 4.0]), np.array([0.0, 2.0, 2.0, 5.0])),
    "repeated_knots": (np.array([0.0, 1.0, 1.0, 1.0, 3.0]),
                       np.array([1.0, 2.0, 4.0, 8.0, 9.0])),
    "one_knot": (np.array([2.0]), np.array([7.0])),
    "two_knots_equal": (np.array([1.0, 1.0]), np.array([3.0, 5.0])),
}


@pytest.mark.parametrize("case", list(INTERP_CASES))
def test_interp_gives_numpy_answers(case):
    """At the knots (and repeated knots), between them, outside the range
    on both sides and at NaN."""
    xp, fp = INTERP_CASES[case]
    x = np.concatenate([xp, np.linspace(xp[0] - 2, xp[-1] + 2, 41),
                        [np.nan, -np.inf, np.inf]])
    got = piso.interp(torch.as_tensor(x), xp, fp).numpy()
    np.testing.assert_allclose(got, np.interp(x, xp, fp), rtol=0, atol=1e-12)


ISO_CASES = {
    "plain": dict(),
    "weights_and_na": dict(weights_column="w"),
    "ties": dict(round_x=True),
    "out_of_bounds_na": dict(out_of_bounds="na"),
}


@pytest.mark.parametrize("case", list(ISO_CASES))
def test_isotonic_model_equals_jax(case):
    """The knots, the float64 predictions (on rows outside the training
    range too) and the training RMSE equal JAX's; the model carried across
    predicts the same."""
    kw = dict(ISO_CASES[case])
    rng = np.random.default_rng(1)
    n = 500
    x = rng.uniform(0, 5, n)
    if kw.pop("round_x", False):
        x = np.round(x, 1)
    y = x + np.sin(3 * x) + rng.normal(0, 0.3, n)
    d = pd.DataFrame({"x": x, "y": y, "w": rng.uniform(0.5, 2.0, n)})
    d.loc[:4, "x"] = np.nan
    d.loc[5:7, "y"] = np.nan
    if "weights_column" not in kw:
        d = d.drop(columns="w")
    jm = jiso.IsotonicRegression(**kw).train(x=["x"], y="y",
                                             training_frame=JFrame.from_pandas(d))
    pm = piso.IsotonicRegression(**kw).train(x=["x"], y="y",
                                             training_frame=_up(d))
    for k in ("thresholds_x", "thresholds_y"):
        np.testing.assert_allclose(pm.output[k], jm.output[k], rtol=0,
                                   atol=1e-12)
    score = pd.DataFrame({"x": np.linspace(-1, 6, 71), "y": 0.0})
    jp = jm._predict_raw(JFrame.from_pandas(score))
    pp = pm._predict_raw(_up(score)).numpy()
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-12, equal_nan=True)
    assert pm.training_metrics.value("rmse") == pytest.approx(
        jm.training_metrics.value("rmse"), abs=1e-9)
    conv = isotonic_from_numpy(jm.output, params=kw)
    np.testing.assert_array_equal(conv._predict_raw(_up(score)).numpy(), pp)


def test_isotonic_tracks_sklearn():
    from sklearn.isotonic import IsotonicRegression as SkIso

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, 2000)
    y = np.log1p(x) + rng.normal(0, 0.3, 2000)
    fr = _up(pd.DataFrame({"x": x, "y": y}))
    m = piso.IsotonicRegression().train(x=["x"], y="y", training_frame=fr)
    ours = m.predict(fr).vec("predict").to_numpy()
    sk = SkIso(out_of_bounds="clip").fit(x, y).predict(x)
    np.testing.assert_allclose(ours, sk, atol=1e-6)
    with pytest.raises(ValueError, match="classification"):
        piso.IsotonicRegression().train(
            x=["x"], y="c", training_frame=_up(pd.DataFrame(
                {"x": x[:50], "c": np.where(x[:50] > 5, "a", "b")})))


# ---------------------------------------------------------------------------
# the calibrators


@pytest.mark.parametrize("method", ["platt", "isotonic"])
def test_fits_and_application_equal_jax(method):
    """The fitted calibrator and its application (on p1 values inside and
    outside the fitted range, 0 and 1 included) equal JAX's."""
    rng = np.random.default_rng(5)
    n = 800
    p1 = np.clip(rng.beta(0.5, 0.5, n), 1e-4, 1 - 1e-4)
    y = (rng.random(n) < 0.2 + 0.6 * p1).astype(np.float64)
    w = rng.uniform(0.5, 2.0, n)
    fit_p = {"platt": pcal.fit_platt, "isotonic": pcal.fit_isotonic}[method]
    fit_j = {"platt": jcal.fit_platt, "isotonic": jcal.fit_isotonic}[method]
    got, want = fit_p(p1, y, w), fit_j(p1, y, w)
    assert got.keys() == want.keys() and got["method"] == want["method"]
    for k in got:
        if k != "method":
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12)
    q = np.concatenate([np.linspace(0, 1, 101), [1e-9, 1 - 1e-9]])
    np.testing.assert_allclose(
        pcal.apply_calibration(got, torch.as_tensor(q)).numpy(),
        jcal.apply_calibration(want, q), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# calibrate_model on the tree builders


@pytest.fixture(scope="module", params=list(METHODS))
def calibrated(request, parts):
    """A calibrated GBM in both packages."""
    tr, cal, _ = parts
    kw = dict(KW, calibrate_model=True,
              calibration_method=METHODS[request.param])
    jm = JGBM(**kw, calibration_frame=JFrame.from_pandas(cal)).train(
        y="y", training_frame=JFrame.from_pandas(tr))
    pm = GBM(**kw, calibration_frame=_up(cal)).train(
        y="y", training_frame=_up(tr))
    return request.param, jm, pm


def test_calibrated_gbm_equals_jax(calibrated, parts):
    """The same trees, the same calibrator, the same ``cal_p0``/``cal_p1``
    (summing to 1) on a test frame."""
    method, jm, pm = calibrated
    _, _, te = parts
    assert divergences(SimpleNamespace(model=pm),
                       SimpleNamespace(model=jm))["partings"] == []
    gc, jc = pm.output["calibration"], jm.output["calibration"]
    assert gc["method"] == jc["method"]
    for k in gc:
        if k != "method":
            np.testing.assert_allclose(gc[k], jc[k], rtol=0, atol=1e-6)
    got = pm.predict(_up(te))
    want = jm.predict(JFrame.from_pandas(te))
    assert got.names == want.names and got.names[-2:] == ["cal_p0", "cal_p1"]
    cp1 = got.vec("cal_p1").to_numpy().astype(np.float64)
    np.testing.assert_allclose(cp1, want.vec("cal_p1").to_numpy(), atol=1e-6)
    np.testing.assert_allclose(cp1 + got.vec("cal_p0").to_numpy(), 1.0,
                               atol=1e-6)


def test_carried_calibration_predicts_like_jax(calibrated, parts):
    method, jm, _ = calibrated
    _, _, te = parts
    pm = gbm_from_numpy(jax_numpy(jm), device="cpu",
                        params={"response_column": "y"})
    np.testing.assert_allclose(
        pm.predict(_up(te)).vec("cal_p1").to_numpy(),
        jm.predict(JFrame.from_pandas(te)).vec("cal_p1").to_numpy(),
        rtol=0, atol=1e-7)


def test_calibration_in_tmojo_and_save_load(calibrated, parts, tmp_path):
    """The tmojo carries the calibrator: JAX's scorer and the port's give
    ``predict``'s p1, its calibration of their own p1 and, with Platt
    scaling, ``predict``'s ``cal_p1`` (an isotonic calibrator's slope
    between close knots multiplies the scorers' float64 p1 gap); a saved
    and loaded model predicts the same columns."""
    method, _, pm = calibrated
    _, _, te = parts
    want = pm.predict(_up(te))
    path = pm.download_mojo(str(tmp_path / "m.zip"))
    feats = te.drop(columns="y")
    p1 = want.vec("Y").to_numpy().astype(np.float64)
    cal = pm.output["calibration"]
    for gen in (jgen, pgen):
        off = gen.MojoModel.load(path).predict(feats)
        np.testing.assert_allclose(off["Y"], p1, atol=1e-6)
        np.testing.assert_allclose(
            off["cal_p1"], pcal.apply_calibration(
                cal, torch.as_tensor(off["Y"])).numpy(), rtol=0, atol=1e-12)
        if method == "platt":
            np.testing.assert_allclose(
                off["cal_p1"], want.vec("cal_p1").to_numpy(), atol=1e-6)
    p = h2o3_tpu_torch.save_model(pm, str(tmp_path) + os.sep)
    loaded = h2o3_tpu_torch.load_model(p, device="cpu")
    assert loaded.params.calibration_frame == pm.params.calibration_frame.key
    got = loaded.predict(_up(te))
    for c in ("cal_p0", "cal_p1"):
        np.testing.assert_array_equal(got.vec(c).to_numpy(),
                                      want.vec(c).to_numpy())


def test_calibrated_drf_equals_jax(parts):
    tr, cal, te = parts
    kw = dict(DRF_KW, calibrate_model=True)
    jm = JDRF(**kw, calibration_frame=JFrame.from_pandas(cal)).train(
        y="y", training_frame=JFrame.from_pandas(tr))
    pm = DRF(**kw, calibration_frame=_up(cal)).train(
        y="y", training_frame=_up(tr))
    assert divergences(SimpleNamespace(model=pm), SimpleNamespace(model=jm),
                       boosted=False)["partings"] == []
    for k in ("a", "b"):
        assert pm.output["calibration"][k] == pytest.approx(
            jm.output["calibration"][k], abs=1e-6)
    np.testing.assert_allclose(
        pm.predict(_up(te)).vec("cal_p1").to_numpy(),
        jm.predict(JFrame.from_pandas(te)).vec("cal_p1").to_numpy(),
        atol=1e-6)


ESTIMATORS = {"gbm": H2OGradientBoostingEstimator,
              "xgboost": H2OXGBoostEstimator,
              "drf": H2ORandomForestEstimator, "xrt": H2OXRTEstimator}
SMALL = {"gbm": dict(ntrees=2, max_depth=2), "xgboost": dict(ntrees=2,
                                                              max_depth=2),
         "drf": dict(ntrees=2, max_depth=3), "xrt": dict(ntrees=2,
                                                         max_depth=3)}


@pytest.mark.parametrize("algo", list(ESTIMATORS))
def test_calibrate_model_on_every_tree_estimator(algo, parts):
    """XGBoost and XRT inherit the calibration: both methods append the
    calibrated columns; fold models do not calibrate."""
    tr, cal, _ = parts
    fr, cf = _up(tr), _up(cal)
    for method in METHODS.values():
        est = ESTIMATORS[algo](**SMALL[algo], calibrate_model=True,
                               calibration_frame=cf,
                               calibration_method=method, nfolds=2)
        est.train(y="y", training_frame=fr)
        assert est.model.output["calibration"]["method"] in (
            "PlattScaling", "IsotonicRegression")
        assert all("calibration" not in m.output for m in est.cv_models)
        out = est.predict(fr)
        assert out.names[-2:] == ["cal_p0", "cal_p1"]
        assert np.all((out.vec("cal_p1").to_numpy() >= 0)
                      & (out.vec("cal_p1").to_numpy() <= 1))


REFUSALS = {
    "no_frame": (dict(calibrate_model=True), "label",
                 "calibration_frame"),
    "regression": (dict(calibrate_model=True, with_frame=True), "a",
                   "binary classification only"),
    "multiclass": (dict(calibrate_model=True, with_frame=True), "k3",
                   "binary classification only"),
    "frame_key": (dict(calibrate_model=True, calibration_frame="fr_key"),
                  "label", "no frame under key"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
@pytest.mark.parametrize("algo", list(ESTIMATORS))
def test_calibration_refused_before_the_build(algo, case, parts,
                                              monkeypatch):
    """JAX's ``ValueError``s, raised by ``_validate`` before any tree is
    built (``_build`` is never called)."""
    tr, _, _ = parts
    kw, y, msg = REFUSALS[case]
    kw = dict(kw)
    d = tr.assign(label=tr["y"], k3=np.array(["p", "q", "r"])[
        np.arange(len(tr)) % 3])
    fr = _up(d.drop(columns="y"))
    if kw.pop("with_frame", False):
        kw["calibration_frame"] = fr
    est = ESTIMATORS[algo](**SMALL[algo], **kw)
    monkeypatch.setattr(est._BUILDER, "_build", lambda *a: pytest.fail(
        "built before the calibration check"))
    with pytest.raises(ValueError, match=msg):
        est.train(y=y, training_frame=fr)


def test_unknown_calibration_method(parts):
    tr, cal, _ = parts
    with pytest.raises(ValueError, match="calibration_method"):
        GBM(**dict(KW, ntrees=1), calibrate_model=True,
            calibration_frame=_up(cal), calibration_method="spline").train(
            y="y", training_frame=_up(tr))
