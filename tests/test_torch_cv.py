"""Cross-validation in the port (``model_base._cross_validate``) against the
JAX package's driver, on the CPU at test size: fold ids, holdout
predictions, cross-validation metrics and fold models of GBM, DRF, XRT and
GLM (binomial, gaussian, multinomial, ordinal) with ``nfolds=3`` under ``modulo``,
``random`` and a ``fold_column``; user weights times the fold mask; the
kept predictions; ``max_runtime_secs``; the estimators' ``xval=``
accessors; a JAX CV model's fold models carried across.

Tolerances, with their reasons:
- fold ids: equal (the same numpy formulas);
- GBM holdout predictions and CV metrics: 1e-5 absolute — float32
  histogram sums in another order (JAX sums across an 8-device mesh);
- DRF without draws (``sample_rate=1.0``, ``mtries=-2``): 1e-6 — 0/1
  labels make every histogram sum exact, so only the final float32 means
  differ in order;
- GLM fold coefficients: 1e-5 relative to the largest coefficient (the
  ``_close`` rule of ``tests/test_torch_glm.py``), holdout predictions and
  CV metrics 1e-5; ordinal GLM: the bounds of
  ``tests/test_torch_glm_ordinal.py`` (beta and cuts 2e-3, logloss 1e-4
  relative: a float32 BFGS ends where rounding lets it).
"""

import time

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu.models.tree.drf import DRF as JDRF  # noqa: E402
from h2o3_tpu.models.tree.drf import XRT as JXRT  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OGeneralizedLinearEstimator,
    H2OGradientBoostingEstimator,
    H2ORandomForestEstimator,
)
from h2o3_tpu_torch.models import model_base as pmb  # noqa: E402
from h2o3_tpu_torch.models.glm import GLM as PGLM  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import gbm_from_numpy  # noqa: E402
from h2o3_tpu_torch.models.tree.drf import DRF as PDRF  # noqa: E402
from h2o3_tpu_torch.models.tree.drf import XRT as PXRT  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM as PGBM  # noqa: E402

X_COLS = ["x0", "x1", "x2", "x3", "c1"]
N = 900


def cv_df(n=N, seed=0) -> pd.DataFrame:
    """Four numeric columns on a 0.1 grid (NAs in x1), a categorical, a
    binary label, a gaussian response, a 3-class response, user weights
    and a fold column of three uneven values. The grid keeps the split
    candidates few (~60 a column), so no two of them tie within the
    float32 noise of the histogram sums' order: a near-tie decided by that
    order would move a whole leaf in one package and not the other."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 4)), 1).astype(np.float32)
    df = pd.DataFrame(X, columns=["x0", "x1", "x2", "x3"])
    df.loc[rng.random(n) < 0.08, "x1"] = np.nan
    c1 = rng.integers(0, 3, n)
    df["c1"] = np.array(["a", "b", "c"])[c1]
    lin = 0.9 * X[:, 0] - 0.6 * X[:, 2] + 0.4 * (c1 - 1)
    df["label"] = np.where(rng.random(n) < 1 / (1 + np.exp(-lin)), "s", "b")
    df["yreg"] = (1.5 + lin + 0.5 * rng.normal(size=n)).astype(np.float32)
    df["ymn"] = np.array(["u", "v", "w"])[np.digitize(
        lin + 0.5 * rng.normal(size=n), [-0.5, 0.5])]
    df["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    df["fold"] = rng.choice([3, 7, 11], size=n, p=[0.3, 0.3, 0.4])
    return df


@pytest.fixture(scope="module")
def data():
    df = cv_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


def _assign(builder, how):
    if how == "random":
        builder.params.fold_assignment = "random"
    elif how == "fold_column":
        builder.params.fold_column = "fold"
    return builder


def _train_both(jcls, pcls, data, y, how="modulo", x=X_COLS, **kw):
    _, jf, pf = data
    kw = dict(nfolds=3, keep_cross_validation_predictions=True, **kw)
    jm = _assign(jcls(**kw), how).train(x=x, y=y, training_frame=jf)
    pm = _assign(pcls(**kw), how).train(x=x, y=y, training_frame=pf)
    return jm, pm


def _holdout(model) -> np.ndarray:
    h = model.cv_predictions
    return np.asarray(h.numpy() if isinstance(h, torch.Tensor) else h,
                      np.float64)


def _check_cv(jm, pm, atol, names=("auc", "logloss", "rmse")):
    assert len(pm.cv_models) == len(jm.cv_models)
    np.testing.assert_allclose(_holdout(pm), _holdout(jm)[:N], atol=atol)
    for name in names:
        assert pm.cross_validation_metrics.value(name) == pytest.approx(
            jm.cross_validation_metrics.value(name), abs=atol), name


def _fold_rows(jf, jm, fold, folds):
    """JAX's own holdout agrees with its fold models on the fold ids the
    port computes: fold f's rows of the holdout are cv_models[f]'s
    predictions there."""
    hold = _holdout(jm)[:N]
    for f, m in zip(folds, jm.cv_models):
        raw = np.asarray(m._predict_raw(jf), np.float64)[:N]
        np.testing.assert_array_equal(hold[fold == f], raw[fold == f])


@pytest.mark.parametrize("how", ["modulo", "random", "fold_column"])
def test_fold_ids_equal_jax(data, how):
    """The port's fold ids are JAX's: the formulas for modulo and random
    (seed 12345 when unset), the fold column's values with its sorted
    distinct values as the folds; JAX's holdout splits on them."""
    df, jf, pf = data
    b = _assign(PGBM(nfolds=3), how)
    fold, folds = pmb.fold_ids(b.params, pf)
    if how == "modulo":
        np.testing.assert_array_equal(fold, np.arange(N) % 3)
    elif how == "random":
        np.testing.assert_array_equal(
            fold, np.random.default_rng(12345).integers(0, 3, N))
    else:
        np.testing.assert_array_equal(fold, df["fold"].to_numpy())
        assert folds == [3, 7, 11]
    jm = _assign(JGBM(ntrees=2, max_depth=2, nfolds=3,
                      keep_cross_validation_predictions=True), how).train(
        x=X_COLS, y="label", training_frame=jf)
    _fold_rows(jf, jm, fold, folds)


@pytest.mark.parametrize("how", ["modulo", "random", "fold_column"])
def test_gbm_cv_matches_jax(data, how):
    jm, pm = _train_both(JGBM, PGBM, data, "label", how, ntrees=5,
                         max_depth=3, seed=5)
    _check_cv(jm, pm, 1e-5)
    for jfm, pfm in zip(jm.cv_models, pm.cv_models):
        assert pfm.output["ntrees_actual"] == jfm.output["ntrees_actual"]
        assert pfm.params.weights_column == pmb._CV_WEIGHTS


def test_gbm_cv_holdout_is_the_fold_models_predictions(data):
    """The holdout, assembled on the frame's device, is each fold model's
    own prediction on its fold's rows, bit for bit."""
    _, _, pf = data
    est = H2OGradientBoostingEstimator(ntrees=4, max_depth=3, nfolds=3,
                                       keep_cross_validation_predictions=True)
    est.train(x=X_COLS, y="label", training_frame=pf)
    fold, folds = pmb.fold_ids(est.model.params, pf)
    hold = est.cv_predictions.numpy()
    assert hold.shape == (N, 2) and est.cv_predictions.dtype == torch.float32
    for f, m in zip(folds, est.cv_models):
        raw = m._predict_raw(pf).numpy()
        np.testing.assert_array_equal(hold[fold == f], raw[fold == f])


@pytest.mark.parametrize("how", ["modulo", "random", "fold_column"])
def test_gbm_regression_cv_with_user_weights_matches_jax(data, how):
    """User weights times the fold mask train the folds, and the CV
    metrics carry the user weights."""
    jm, pm = _train_both(JGBM, PGBM, data, "yreg", how, ntrees=4,
                         max_depth=3, seed=2, weights_column="w")
    _check_cv(jm, pm, 1e-5, names=("rmse", "mse", "mae", "r2",
                                   "mean_residual_deviance"))


def test_fold_weights_are_mask_times_user_weights(data, monkeypatch):
    """The fold column each fold model trains on: 0 on the fold's rows,
    the user weight (NaN as 0) elsewhere, float32."""
    df, _, pf = data
    seen = []
    real = pmb._with_cv_weights

    def spy(train, w_np, dev):
        seen.append(w_np.copy())
        return real(train, w_np, dev)

    monkeypatch.setattr(pmb, "_with_cv_weights", spy)
    PGBM(ntrees=1, max_depth=2, nfolds=3, weights_column="w").train(
        x=X_COLS, y="label", training_frame=pf)
    w = df["w"].to_numpy(np.float32)
    for f, got in enumerate(seen):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(
            got, np.where(np.arange(N) % 3 == f, 0.0, w).astype(np.float32))


@pytest.mark.parametrize("how", ["modulo", "random", "fold_column"])
def test_drf_cv_without_draws_matches_jax(data, how):
    jm, pm = _train_both(JDRF, PDRF, data, "label", how, ntrees=4,
                         max_depth=6, sample_rate=1.0, mtries=-2, seed=3)
    _check_cv(jm, pm, 1e-6)


def test_xrt_cv_matches_jax(data):
    jm, pm = _train_both(JXRT, PXRT, data, "label", ntrees=3, max_depth=5,
                         sample_rate=1.0, mtries=-2, seed=3)
    assert [m.algo for m in pm.cv_models] == ["xrt"] * 3
    _check_cv(jm, pm, 1e-6)


def _close(a, b, rtol=1e-5):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1e-30, np.abs(b).max()))


GLM_CASES = {
    "binomial": ("label", dict(family="binomial", lambda_=1e-3)),
    "binomial_admm": ("label", dict(family="binomial", lambda_=1e-2,
                                    alpha=0.5)),
    "gaussian": ("yreg", dict(family="gaussian", lambda_=0.0)),
    "multinomial": ("ymn", dict(family="multinomial")),
}


@pytest.mark.parametrize("how", ["modulo", "random", "fold_column"])
@pytest.mark.parametrize("case", list(GLM_CASES))
def test_glm_cv_matches_jax(data, case, how):
    y, kw = GLM_CASES[case]
    jm, pm = _train_both(JGLM, PGLM, data, y, how, **kw)
    key = "beta_multinomial_std" if case == "multinomial" else "beta_std"
    for jfm, pfm in zip(jm.cv_models, pm.cv_models):
        _close(pfm.output[key], jfm.output[key])
    names = ("rmse", "mse", "r2") if case == "gaussian" else (
        "logloss", "rmse") + (("auc",) if case.startswith("binomial") else ())
    _check_cv(jm, pm, 1e-5, names=names)


def test_ordinal_glm_cv_matches_jax(data):
    """Ordinal GLM with nfolds=3 on the 3-level response: each fold's beta
    and cuts within 2e-3 of JAX's, the CV logloss within 1e-4 relative —
    the whole-training bounds of ``tests/test_torch_glm_ordinal.py`` (a
    float32 BFGS ends where rounding lets it) — and the holdout within
    1e-4."""
    jm, pm = _train_both(JGLM, PGLM, data, "ymn", family="ordinal")
    for jfm, pfm in zip(jm.cv_models, pm.cv_models):
        for k in ("beta_std", "theta"):
            np.testing.assert_allclose(pfm.output[k], jfm.output[k],
                                       atol=2e-3)
    np.testing.assert_allclose(_holdout(pm), _holdout(jm)[:N], atol=1e-4)
    assert pm.cross_validation_metrics.value("logloss") == pytest.approx(
        jm.cross_validation_metrics.value("logloss"), rel=1e-4)


def test_glm_cv_reuses_the_admm_solver(data):
    """Every fold's design has the training's width, so the folds solve
    on the one cached ADMM solver of that width."""
    _, _, pf = data
    from h2o3_tpu_torch.models import glm as pglm

    pglm._ADMM_SOLVERS.clear()
    est = H2OGeneralizedLinearEstimator(family="binomial", lambda_=1e-2,
                                        alpha=0.5, nfolds=3)
    est.train(x=X_COLS, y="label", training_frame=pf)
    assert len(pglm._ADMM_SOLVERS) == 1
    assert len(est.cv_models) == 3


def test_cv_predictions_only_when_kept(data):
    _, _, pf = data
    est = H2OGradientBoostingEstimator(ntrees=2, max_depth=2, nfolds=3)
    est.train(x=X_COLS, y="label", training_frame=pf)
    assert est.cv_predictions is None
    assert len(est.cv_models) == 3
    assert est.cross_validation_metrics is not None
    for m in est.cv_models:  # fold models hold no CV of their own
        assert m.cross_validation_metrics is None and not m.cv_models
        assert m.params.nfolds == 0
    plain = H2OGradientBoostingEstimator(ntrees=2, max_depth=2)
    plain.train(x=X_COLS, y="label", training_frame=pf)
    assert plain.cv_models == [] and plain.cross_validation_metrics is None
    assert np.isnan(plain.auc(xval=True))


def test_xval_accessors(data):
    """``auc``/``logloss``/``rmse``/``mse``/``mae``/``r2`` take ``valid``
    and ``xval`` as in JAX's estimators."""
    df, jf, pf = data
    est = H2OGradientBoostingEstimator(ntrees=3, max_depth=3, nfolds=3,
                                       seed=1)
    est.train(x=X_COLS, y="yreg", training_frame=pf)
    jm = JGBM(ntrees=3, max_depth=3, nfolds=3, seed=1).train(
        x=X_COLS, y="yreg", training_frame=jf)
    for name in ("rmse", "mse", "mae", "r2"):
        got = getattr(est, name)(xval=True)
        assert got == est.cross_validation_metrics.value(name)
        assert got == pytest.approx(
            jm.cross_validation_metrics.value(name), abs=1e-5), name
        assert getattr(est, name)() == est.model.training_metrics.value(name)
    clf = H2OGradientBoostingEstimator(ntrees=3, max_depth=3, nfolds=3)
    clf.train(x=X_COLS, y="label", training_frame=pf,
              validation_frame=pf)
    for name in ("auc", "logloss"):
        assert getattr(clf, name)(xval=True) == \
            clf.cross_validation_metrics.value(name)
        assert getattr(clf, name)(valid=True) == \
            clf.model.validation_metrics.value(name)


def test_max_runtime_keeps_a_partial_model(data):
    """A deadline that passes at once: the interval loop still builds its
    first chunk, and stops there, keeping the partial model — GBM and
    DRF, main model and fold models (which inherit the deadline)."""
    _, _, pf = data
    for cls in (PGBM, PDRF):
        m = cls(ntrees=1000, max_depth=2, score_tree_interval=3,
                max_runtime_secs=1e-9, nfolds=2).train(
            x=X_COLS, y="label", training_frame=pf)
        assert m.output["ntrees_actual"] == 3
        assert [f.output["ntrees_actual"] for f in m.cv_models] == [3, 3]
        assert m.training_metrics is not None
        assert np.isfinite(m.cross_validation_metrics.value("auc"))


def test_fold_builders_inherit_the_parent_deadline(data, monkeypatch):
    """A fold builder stops at its parent's deadline even with no
    ``max_runtime_secs`` of its own, as JAX reads deadlines through the
    parent job chain; on the eager loop the deadline is read per
    iteration."""
    _, _, pf = data
    b = PGBM(ntrees=50, max_depth=2, score_tree_interval=4)
    b._parent_deadline = time.time() - 1.0
    m = b.train(x=X_COLS, y="label", training_frame=pf)
    assert m.output["ntrees_actual"] == 4
    monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", "0")
    b = PGBM(ntrees=50, max_depth=2, score_tree_interval=4,
             max_runtime_secs=1e-9)
    assert b.train(x=X_COLS, y="label",
                   training_frame=pf).output["ntrees_actual"] == 1


def test_glm_ignores_max_runtime(data):
    """GLM never reads the deadline, as in JAX's GLM."""
    _, _, pf = data
    a = PGLM(family="binomial", lambda_=1e-3).train(
        x=X_COLS, y="label", training_frame=pf)
    b = PGLM(family="binomial", lambda_=1e-3, max_runtime_secs=1e-9).train(
        x=X_COLS, y="label", training_frame=pf)
    np.testing.assert_array_equal(a.output["beta_std"], b.output["beta_std"])


def test_checkpoint_with_cv_raises_first(data):
    """JAX's refusal of a checkpoint with cross-validation comes before the
    port's own refusal of checkpoints."""
    _, _, pf = data
    for cls in (PGBM, PDRF, PGLM):
        with pytest.raises(ValueError, match="cross-validation"):
            cls(nfolds=3, checkpoint="m").train(x=X_COLS, y="label",
                                                training_frame=pf)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        PGBM(checkpoint="m").train(x=X_COLS, y="label", training_frame=pf)


def test_fold_column_is_not_a_feature(data):
    """``fold_column`` is read from the builder's params, as JAX reads it,
    and dropped from the features; it is no parameter of the estimators."""
    _, _, pf = data
    b = PGBM(ntrees=2, max_depth=2, nfolds=3)
    b.params.fold_column = "fold"
    m = b.train(y="label", training_frame=pf)
    assert "fold" not in m.output["names"]
    assert pmb._CV_WEIGHTS not in m.output["names"]
    with pytest.raises(TypeError):
        H2OGradientBoostingEstimator(fold_column="fold")
    with pytest.raises(ValueError, match="unknown"):
        PGBM(fold_column="fold")


def test_new_common_params_equal_jax():
    """The fields JAX's CommonParams has and the port's lacked until now,
    with JAX's defaults."""
    from h2o3_tpu.models.model_base import CommonParams as JCP

    j, p = JCP(), pmb.CommonParams()
    for f in ("nfolds", "fold_assignment",
              "keep_cross_validation_predictions", "seed",
              "max_runtime_secs"):
        assert getattr(p, f) == getattr(j, f), f
    for est in (H2OGradientBoostingEstimator, H2ORandomForestEstimator,
                H2OGeneralizedLinearEstimator):
        est(fold_assignment="random", keep_cross_validation_predictions=True,
            max_runtime_secs=5.0)


@pytest.mark.parametrize("kind", ["binomial", "multinomial"])
def test_jax_cv_models_carried_across(data, kind):
    """A JAX-trained CV model's fold models carry across one by one with
    ``gbm_from_numpy`` and predict what they predict in JAX."""
    df, jf, pf = data
    y = "label" if kind == "binomial" else "ymn"
    jm = JGBM(ntrees=3, max_depth=3, nfolds=3, seed=6).train(
        x=X_COLS, y=y, training_frame=jf)
    for jfm in jm.cv_models:
        spec = jfm.output["bin_spec"]
        out = {
            "bin_spec": {f: getattr(spec, f) for f in (
                "names", "is_cat", "nbins", "edges", "cards", "domains")},
            "trees": [[[{f: np.asarray(getattr(lv, f))
                         for f in pst.REPLAY_FIELDS} for lv in t.levels]
                       for t in group] for group in jfm.output["trees"]],
            "init_f": jfm.output["init_f"],
            "n_tree_classes": jfm.output["n_tree_classes"],
            "distribution": jfm.output["distribution"],
            "names": jfm.output["names"],
            "response_domain": jfm.output["response_domain"],
        }
        pm = gbm_from_numpy(out, device="cpu")
        np.testing.assert_allclose(
            pm._predict_raw(pf).numpy(),
            np.asarray(jfm._predict_raw(jf))[:N], atol=1e-6)
