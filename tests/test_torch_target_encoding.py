"""Target encoding in the port (``h2o3_tpu_torch.models.target_encoding``)
and AutoML's ``preprocessing=["target_encoding"]`` against the JAX
package, on the CPU at small sizes: the ``none``, ``loo`` and ``kfold``
holdouts (with a fold column too), blending, seeded noise, a numeric
target, an unseen level and a domain that differs from fit time,
re-application, an encoder carried across from JAX, the estimator, and
an AutoML run whose leader scores raw frames through its encoder, saved
and loaded.

Tolerances, with their reasons:
- the encoder's tables, prior and ``_te`` columns: within 1e-12 (the same
  float64 sums and means on the same rows, stored as float32 by both);
- AutoML: the same leaderboard order and ``_te`` columns as JAX's, each
  model's AUC and predictions within 1e-5 where its trees equal JAX's,
  its AUC within 1e-2 where a tree parts at a float near-tie.
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

from h2o3_tpu.automl import automl as jam  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.target_encoding import TargetEncoder as JTE  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.automl import automl as pam  # noqa: E402
from h2o3_tpu_torch.estimators import H2OTargetEncoderEstimator  # noqa: E402
from h2o3_tpu_torch.models.model_base import get_model  # noqa: E402
from h2o3_tpu_torch.models.target_encoding import TargetEncoder  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import te_from_numpy  # noqa: E402
from h2o3_tpu_torch.tools.tree_parity import divergences  # noqa: E402


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


def te_df(n=900, seed=8) -> pd.DataFrame:
    """Two enum columns (a skewed 3-level one with NAs, a 12-level one), a
    binary target with NAs, a numeric target, a fold column and a
    numeric feature."""
    rng = np.random.default_rng(seed)
    g = rng.choice(["a", "b", "c"], n, p=[0.5, 0.3, 0.2]).astype(object)
    g[rng.random(n) < 0.05] = None
    h = rng.choice([f"L{i}" for i in range(12)], n)
    p = np.select([g == "a", g == "b"], [0.8, 0.4], 0.1)
    y = np.where(rng.random(n) < p, "T", "F").astype(object)
    y[rng.random(n) < 0.03] = None
    return pd.DataFrame({
        "g": g, "h": h, "y": y,
        "yreg": (rng.normal(size=n) + (g == "a")).astype(np.float32),
        "fold": (np.arange(n) % 3).astype(np.float32),
        "x": rng.normal(size=n).astype(np.float32)})


@pytest.fixture(scope="module")
def df():
    return te_df()


def _pair(d):
    return JFrame.from_pandas(d), h2o3_tpu_torch.upload_file(d, device="cpu")


def _col(fr, name):
    return fr.vec(name).to_numpy().astype(np.float64)


def _same_encoder(pte, jte):
    assert pte._stats.keys() == jte._stats.keys()
    for c, (cnt, ssum, dom) in pte._stats.items():
        jc, js, jd = jte._stats[c]
        np.testing.assert_allclose(cnt, jc, rtol=0, atol=1e-12)
        np.testing.assert_allclose(ssum, js, rtol=0, atol=1e-12)
        assert dom == tuple(jd)
    assert pte._prior == pytest.approx(jte._prior, abs=1e-12)


CASES = {
    "none": dict(holdout_type="none"),
    "none_blend": dict(holdout_type="none", blending=True,
                       inflection_point=40.0, smoothing=10.0),
    "loo": dict(holdout_type="loo"),
    "loo_blend_noise": dict(holdout_type="loo", blending=True, noise=0.05,
                            seed=11),
    "kfold": dict(holdout_type="kfold", nfolds=4),
    "kfold_fold_column": dict(holdout_type="kfold", fold_column="fold",
                              blending=True),
    "kfold_noise": dict(holdout_type="kfold", nfolds=3, noise=0.02, seed=5),
}


@pytest.mark.parametrize("as_training", [False, True])
@pytest.mark.parametrize("y", ["y", "yreg"])
@pytest.mark.parametrize("case", list(CASES))
def test_encoding_equals_jax(df, case, y, as_training):
    """The fitted tables and the ``_te`` columns of a training or test
    transform equal JAX's."""
    jfr, pfr = _pair(df)
    kw = CASES[case]
    jte = JTE(**kw).fit(jfr, y, ["g", "h"])
    pte = TargetEncoder(**kw).fit(pfr, y, ["g", "h"])
    _same_encoder(pte, jte)
    got = pte.transform(pfr, as_training=as_training)
    want = jte.transform(jfr, as_training=as_training)
    assert got.names == want.names
    for c in ("g_te", "h_te"):
        np.testing.assert_allclose(_col(got, c), _col(want, c), rtol=0,
                                   atol=1e-12)
        assert got.vec(c).device.type == "cpu"


def test_default_columns_and_reapplication(df):
    """Without columns every enum but the target is encoded; transforming
    an encoded frame again adds nothing; a numeric column named is
    skipped."""
    jfr, pfr = _pair(df)
    pte = TargetEncoder().fit(pfr, "y")
    jte = JTE().fit(jfr, "y")
    _same_encoder(pte, jte)
    once = pte.transform(pfr)
    twice = pte.transform(once)
    assert twice.names == once.names == pfr.names + ["g_te", "h_te"]
    assert TargetEncoder().fit(pfr, "y", ["x", "g"])._stats.keys() == {"g"}


def test_unseen_level_and_other_domain(df):
    """A frame whose enum has levels in another order and one the fit
    never saw: codes remapped to the fit-time domain, the unseen level
    and NA at the prior — as JAX's."""
    jfr, pfr = _pair(df)
    kw = dict(holdout_type="none", blending=True)
    jte = JTE(**kw).fit(jfr, "y", ["g"])
    pte = TargetEncoder(**kw).fit(pfr, "y", ["g"])
    test = pd.DataFrame({"g": ["zz", "c", None, "a", "b", "zz", "a"],
                         "x": np.zeros(7, np.float32)})
    jt, pt = _pair(test)
    got = _col(pte.transform(pt), "g_te")
    np.testing.assert_allclose(got, _col(jte.transform(jt), "g_te"),
                               rtol=0, atol=1e-12)
    assert got[0] == got[2] == got[5] == np.float32(pte._prior)


def test_multiclass_target_refused(df):
    d = df.assign(k=np.array(["p", "q", "r"])[np.arange(len(df)) % 3])
    with pytest.raises(ValueError, match="numeric or binary"):
        TargetEncoder().fit(h2o3_tpu_torch.upload_file(d, device="cpu"), "k")


def test_encoder_from_numpy_transforms_like_jax(df):
    jfr, pfr = _pair(df)
    kw = dict(holdout_type="kfold", nfolds=3, blending=True, noise=0.01,
              seed=4)
    jte = JTE(**kw).fit(jfr, "y", ["g", "h"])
    pte = te_from_numpy(jte._stats, jte._prior, jte._y, params=kw)
    got = pte.transform(pfr, as_training=True)
    want = jte.transform(jfr, as_training=True)
    for c in ("g_te", "h_te"):
        np.testing.assert_allclose(_col(got, c), _col(want, c), rtol=0,
                                   atol=1e-12)


def test_estimator_and_builder_entry(df):
    """``H2OTargetEncoderEstimator.train`` fits on ``x``, registers the
    encoder under a key, and ``transform`` comes through the proxy."""
    _, pfr = _pair(df)
    est = H2OTargetEncoderEstimator(holdout_type="none")
    est.train(x=["h"], y="y", training_frame=pfr)
    assert est.model_id.startswith("targetencoder_")
    assert get_model(est.model_id) is est.model
    out = est.transform(pfr)
    assert out.names[-1] == "h_te"
    with pytest.raises(TypeError):
        H2OTargetEncoderEstimator(ntrees=3)


# ---------------------------------------------------------------------------
# AutoML with target encoding


def automl_te_df(n=600, seed=14) -> pd.DataFrame:
    """JAX's AutoML target-encoding frame (``test_algos_wave2``), cut to
    600 rows: a 12-level enum carrying the signal and a noise feature."""
    rng = np.random.default_rng(seed)
    lev = rng.choice([f"L{i}" for i in range(12)], n)
    strength = {f"L{i}": i / 11 for i in range(12)}
    y = (rng.random(n) < np.vectorize(strength.get)(lev)).astype(int)
    return pd.DataFrame({"g": lev, "x": rng.normal(size=n).astype(np.float32),
                         "y": np.where(y == 1, "T", "F")})


def _unsampled(plan_fn):
    """``plan_fn``'s plan with the GBM presets' sampling rates at 1 (the
    keyed draws of the two packages differ by design) and 10 trees."""
    def plan():
        steps = plan_fn()
        for st in steps:
            if st.algo == "gbm" and st.kind == "model":
                st.params.update(sample_rate=1.0, col_sample_rate=1.0,
                                 ntrees=10)
        return steps
    return plan


def _te_runs():
    """The same AutoML (2 GBMs, no folds, target encoding) in both
    packages, on the plan without sampling."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jam, "_default_plan", _unsampled(jam._default_plan))
    mp.setattr(pam, "_default_plan", _unsampled(pam._default_plan))
    try:
        d = automl_te_df()
        kw = dict(max_models=2, nfolds=0, seed=3,
                  preprocessing=["target_encoding"], include_algos=["GBM"],
                  max_runtime_secs=3000.0)
        j = jam.AutoML(**kw)
        j.train(y="y", training_frame=JFrame.from_pandas(d))
        p = pam.AutoML(**kw)
        p.train(y="y", training_frame=h2o3_tpu_torch.upload_file(
            d, device="cpu"))
    finally:
        mp.undo()
    return d, j, p


def _steps(aml) -> list:
    """The plan step of each leaderboard model, in leaderboard order."""
    by_key = {}
    for e in aml.event_log:
        if e["stage"] == "model" and " -> " in e["message"]:
            step, rest = e["message"].split(" -> ")
            by_key[rest.split()[0]] = step
    return [by_key[m.key] for m in aml.leaderboard.models]


def test_automl_target_encoding_equals_jax(tmp_path):
    """JAX's encoder set-up (kfold, 2 folds, blending, the run's seed) and
    tables, the ``_te`` column on every model, the same leaderboard order
    of the plan's steps; each model's encoder is its preprocessor, so
    ``predict`` takes the raw frame, also after save/load. The models'
    trees equal JAX's or part at float near-ties only (``g`` and ``g_te``
    split the rows alike, so their gains tie up to rounding): the AUCs
    within 1e-5 where no tree parts, 1e-2 where one does."""
    d, j, p = _te_runs()
    assert (p._te.params.holdout_type, p._te.params.nfolds,
            p._te.params.blending, p._te.params.seed) == ("kfold", 2, True, 3)
    _same_encoder(p._te, j._te)
    assert _steps(p) == _steps(j)
    raw = h2o3_tpu_torch.upload_file(d.drop(columns="y"), device="cpu")
    jraw = JFrame.from_pandas(d.drop(columns="y"))
    for pm, jm in zip(p.leaderboard.models, j.leaderboard.models):
        assert "g_te" in pm.output["names"]
        assert pm.output["names"] == jm.output["names"]
        assert pm.preprocessors == [p._te]
        parted = divergences(SimpleNamespace(model=pm),
                             SimpleNamespace(model=jm))["partings"]
        assert pm.training_metrics.value("auc") == pytest.approx(
            jm.training_metrics.value("auc"), abs=1e-2 if parted else 1e-5)
        got = pm.predict(raw).vec("T").to_numpy()
        assert got.shape == (len(d),) and np.isfinite(got).all()
        if not parted:
            np.testing.assert_allclose(
                got, jm.predict(jraw).vec("T").to_numpy(), atol=1e-5)
    assert [e["message"] for e in p.event_log
            if e["stage"] == "preprocessing"] == [
        "target encoding applied to ['g']"]
    # the leader with its encoder through save/load
    want = p.leader.predict(raw).vec("T").to_numpy()
    path = h2o3_tpu_torch.save_model(p.leader, str(tmp_path) + os.sep)
    loaded = h2o3_tpu_torch.load_model(path, device="cpu")
    assert [type(q).__name__ for q in loaded.preprocessors] == \
        ["TargetEncoder"]
    np.testing.assert_array_equal(loaded.predict(raw).vec("T").to_numpy(),
                                  want)


def test_automl_multiclass_skips_target_encoding():
    """A multiclass response skips the encoding with JAX's log line."""
    d = automl_te_df(n=120).assign(
        y=np.array(["p", "q", "r"])[np.arange(120) % 3])
    aml = pam.AutoML(max_models=1, nfolds=0, seed=1,
                     preprocessing=["target_encoding"], include_algos=["GLM"])
    aml.train(y="y", training_frame=h2o3_tpu_torch.upload_file(
        d, device="cpu"))
    assert aml._te is None
    assert [e["message"] for e in aml.event_log
            if e["stage"] == "preprocessing"] == [
        "target_encoding skipped: multiclass targets unsupported"]
