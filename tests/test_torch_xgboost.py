"""XGBoost in the port (``h2o3_tpu_torch.models.tree.xgboost`` on the GBM
engine) against the JAX package, on the CPU at test size: the cases of
``tests/test_xgboost.py`` (aliases, defaults, refusals, the regularized
leaf, ``scale_pos_weight``, the estimator, the tmojo) with every trained
model also held against JAX's model of the same parameters on the same
numpy frame, a JAX XGBoost carried across with ``gbm_from_numpy``, and
XGBoost with ``nfolds``.

Tolerances, with their reasons:
- predictions against JAX: 1e-5 absolute — the same float32 histogram
  sums (added in another order across JAX's 8-device mesh), leaf values
  and sigmoid;
- XGBoost with λ = α = 0 against the port's GBM: exact (the same plan and
  the same leaf, as in JAX);
- the tmojo scored offline (the port's ``genmodel.MojoModel``): 1e-6
  (float64 sums of the same float32 leaves).
"""

import dataclasses

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree import xgboost as jxgb  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch.estimators import H2OXGBoostEstimator  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree import xgboost as pxgb  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import gbm_from_numpy  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM as PGBM  # noqa: E402

XGBoost, XGBoostParams = pxgb.XGBoost, pxgb.XGBoostParams


def xgb_df(n=3000, seed=7) -> pd.DataFrame:
    """The frame of ``tests/test_xgboost.py``: 5 normal features and a
    binary label ``y``/``n`` from a quadratic signal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    y = X[:, 0] + 0.6 * X[:, 1] ** 2 + rng.normal(size=n) * 0.4 > 0.4
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(5)])
    df["label"] = np.where(y, "y", "n")
    return df


@pytest.fixture(scope="module")
def frames():
    df = xgb_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


def _p_yes(model, frame, n) -> np.ndarray:
    return np.asarray(model.predict(frame).vec("y").to_numpy())[:n]


def _train_both(frames, **kw):
    df, jf, pf = frames
    jm = jxgb.XGBoost(**kw).train(y="label", training_frame=jf)
    pm = XGBoost(**kw).train(y="label", training_frame=pf)
    return jm, pm, _p_yes(jm, jf, len(df)), _p_yes(pm, pf, len(df))


def test_alias_translation():
    kw = dict(eta=0.2, subsample=0.8, colsample_bytree=0.7,
              colsample_bylevel=0.9, min_child_weight=3, max_bin=64,
              gamma=0.01, n_estimators=7, response_column="label")
    p, j = XGBoost(**kw).params, jxgb.XGBoost(**kw).params
    assert (p.learn_rate, p.sample_rate, p.col_sample_rate_per_tree,
            p.col_sample_rate, p.min_rows, p.nbins, p.min_split_improvement,
            p.ntrees) == (0.2, 0.8, 0.7, 0.9, 3, 64, 0.01, 7)
    for f in ("learn_rate", "sample_rate", "col_sample_rate_per_tree",
              "col_sample_rate", "min_rows", "nbins",
              "min_split_improvement", "ntrees"):
        assert getattr(p, f) == getattr(j, f), f
    assert pxgb._ALIASES == jxgb._ALIASES


def test_alias_conflict_rejected():
    with pytest.raises(ValueError, match="aliases"):
        XGBoost(eta=0.2, learn_rate=0.3)
    with pytest.raises(ValueError, match="aliases"):
        XGBoost(max_delta_step=0.5, max_abs_leafnode_pred=0.3)


def test_defaults_equal_jax():
    """Every field of the port's XGBoostParams has JAX's default, and
    xgboost's defaults differ from GBM's where JAX's do."""
    def defaults(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)
                if f.default is not dataclasses.MISSING}

    jd, pd_ = defaults(jxgb.XGBoostParams), defaults(XGBoostParams)
    assert {k: jd[k] for k in pd_} == pd_
    p = XGBoostParams()
    assert (p.ntrees, p.learn_rate, p.max_depth, p.min_rows, p.reg_lambda,
            p.reg_alpha, p.min_split_improvement) == (50, 0.3, 6, 1.0, 1.0,
                                                      0.0, 0.0)


@pytest.mark.parametrize("kw,match", [
    (dict(booster="gblinear"), "gbtree"),
    (dict(booster="dart"), "gbtree"),
    (dict(grow_policy="lossguide"), "lossguide"),
    (dict(tree_method="gpu_hist_nope"), "tree_method"),
    (dict(scale_pos_weight=0.0), "scale_pos_weight"),
    (dict(scale_pos_weight=-1.0), "scale_pos_weight"),
    (dict(max_delta_step=-1.0), ">= 0"),
])
def test_refusals_as_jax(kw, match):
    for cls in (XGBoost, jxgb.XGBoost):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_tree_method_and_max_bin():
    """exact/approx run as hist with a warning; max_bin clamps to 255;
    max_delta_step 0 means unlimited."""
    for tm in ("exact", "approx"):
        with pytest.warns(UserWarning, match="hist"):
            XGBoost(tree_method=tm)
    XGBoost(tree_method="hist")
    with pytest.warns(UserWarning, match="clamped"):
        b = XGBoost(max_bin=4096)
    assert b.params.nbins == 255
    assert XGBoost(max_delta_step=0.0).params.max_abs_leafnode_pred == \
        float("inf")
    assert XGBoost(max_delta_step=0.7).params.max_abs_leafnode_pred == 0.7


def test_unregularized_xgboost_equals_gbm(frames):
    """λ = α = 0 with GBM's parameters: the port's XGBoost grows GBM's
    trees exactly (the same plan, no regularization in it), and both agree
    with JAX's XGBoost."""
    df, jf, pf = frames
    shared = dict(ntrees=5, max_depth=4, min_rows=10.0, seed=11,
                  min_split_improvement=1e-5)
    g = PGBM(learn_rate=0.3, **shared).train(y="label", training_frame=pf)
    x = XGBoost(eta=0.3, reg_lambda=0.0, reg_alpha=0.0, **shared).train(
        y="label", training_frame=pf)
    np.testing.assert_array_equal(_p_yes(x, pf, len(df)),
                                  _p_yes(g, pf, len(df)))
    for tg, tx in zip(g.output["trees"], x.output["trees"]):
        for lg, lx in zip(tg[0].levels, tx[0].levels):
            for f in pst.REPLAY_FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(lg, f)),
                                              np.asarray(getattr(lx, f)))
    jx = jxgb.XGBoost(eta=0.3, reg_lambda=0.0, reg_alpha=0.0,
                      **shared).train(y="label", training_frame=jf)
    np.testing.assert_allclose(_p_yes(x, pf, len(df)),
                               _p_yes(jx, jf, len(df)), atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(ntrees=5, max_depth=4, seed=11),  # λ = 1 (the default)
    dict(ntrees=5, max_depth=4, seed=11, reg_lambda=50.0),
    dict(ntrees=5, max_depth=4, seed=11, reg_lambda=0.0, reg_alpha=2.0),
    dict(ntrees=5, max_depth=4, seed=11, reg_lambda=3.0, reg_alpha=0.5,
         max_delta_step=0.4),
    dict(ntrees=4, max_depth=3, seed=11, reg_lambda=2.0, reg_alpha=0.5,
         monotone_constraints={"f0": 1, "f1": -1}),
], ids=["defaults", "lambda50", "alpha2", "lambda-alpha-maxdelta",
        "monotone"])
def test_regularized_leaves_match_jax(frames, kw):
    """The regularized leaf, soft-threshold(Σwy, α) / (Σwh + λ) before the
    monotone clamp and max_delta_step, on the whole-tree path, against
    JAX's XGBoost of the same parameters."""
    jm, pm, pj, pp = _train_both(frames, **kw)
    np.testing.assert_allclose(pp, pj, atol=1e-5)
    assert pm.training_metrics.value("auc") == pytest.approx(
        jm.training_metrics.value("auc"), abs=1e-5)


def test_regularized_eager_path_matches_graph_path(frames, monkeypatch):
    """The eager per-level loop (``H2O3_TPU_WHOLE_TREE=0``) takes λ and α
    as the whole-tree build does: the same predictions."""
    df, _, pf = frames
    kw = dict(ntrees=3, max_depth=4, seed=11, reg_lambda=3.0, reg_alpha=0.5)
    whole = XGBoost(**kw).train(y="label", training_frame=pf)
    monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", "0")
    eager = XGBoost(**kw).train(y="label", training_frame=pf)
    np.testing.assert_allclose(_p_yes(eager, pf, len(df)),
                               _p_yes(whole, pf, len(df)), atol=1e-6)


def test_reg_lambda_shrinks_leaves(frames):
    df, _, pf = frames
    kw = dict(ntrees=5, max_depth=4, seed=11, reg_alpha=0.0)
    m0 = XGBoost(reg_lambda=0.0, **kw).train(y="label", training_frame=pf)
    m5 = XGBoost(reg_lambda=50.0, **kw).train(y="label", training_frame=pf)
    assert np.std(_p_yes(m5, pf, len(df))) < np.std(_p_yes(m0, pf, len(df)))
    assert m5.training_metrics.value("auc") > 0.6


def test_reg_alpha_large_kills_leaves(frames):
    df, _, pf = frames
    m = XGBoost(ntrees=3, max_depth=3, seed=11, reg_lambda=0.0,
                reg_alpha=1e9).train(y="label", training_frame=pf)
    assert float(np.ptp(_p_yes(m, pf, len(df)))) < 1e-6


def test_scale_pos_weight_matches_jax(frames):
    """Positives weigh 5 in the training weights only: predictions as
    JAX's, a higher mean than at 1, and training metrics (unweighted by
    it) as JAX's."""
    df, _, pf = frames
    jm, pm, pj, pp = _train_both(frames, ntrees=5, max_depth=3, seed=3,
                                 scale_pos_weight=5.0)
    np.testing.assert_allclose(pp, pj, atol=1e-5)
    m1 = XGBoost(ntrees=5, max_depth=3, seed=3).train(y="label",
                                                      training_frame=pf)
    assert pp.mean() > _p_yes(m1, pf, len(df)).mean()
    for name in ("auc", "logloss"):
        assert pm.training_metrics.value(name) == pytest.approx(
            jm.training_metrics.value(name), abs=1e-5)
    assert pm.output["init_f"] == pytest.approx(jm.output["init_f"],
                                                abs=1e-7)


def test_scale_pos_weight_needs_binary_response(frames):
    df = frames[0].copy()
    df["yreg"] = df["f0"] * 2.0
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    with pytest.raises(ValueError, match="binary"):
        XGBoost(ntrees=2, scale_pos_weight=2.0).train(
            y="yreg", training_frame=pf, x=["f1", "f2"])


def test_estimator_surface(frames):
    """``H2OXGBoostEstimator`` takes the xgboost names; the model's algo is
    ``xgboost``; other names raise TypeError."""
    df, jf, pf = frames
    est = H2OXGBoostEstimator(ntrees=3, max_depth=3, eta=0.3, seed=1,
                              max_delta_step=0.0)
    est.train(y="label", training_frame=pf)
    assert est.model.algo == "xgboost"
    assert est.model_performance().value("auc") > 0.6
    with pytest.raises(TypeError):
        H2OXGBoostEstimator(learning_rate=0.1)
    jm = jxgb.XGBoost(ntrees=3, max_depth=3, eta=0.3, seed=1).train(
        y="label", training_frame=jf)
    assert est.auc() == pytest.approx(jm.training_metrics.value("auc"),
                                      abs=1e-5)


def test_mojo_scores_like_predict(frames, tmp_path):
    """The XGBoost tmojo, algo ``xgboost``, scored by the port's offline
    scorer within 1e-6 of ``predict`` on new rows."""
    _, _, pf = frames
    m = XGBoost(ntrees=3, max_depth=3, seed=5, reg_alpha=0.3).train(
        y="label", training_frame=pf)
    path = m.download_mojo(str(tmp_path / "xgb.zip"))
    scorer = pgen.MojoModel.load(path)
    assert scorer.algo == "xgboost"
    rng = np.random.default_rng(0)
    df = pd.DataFrame({f"f{i}": rng.normal(size=200) for i in range(5)})
    server = _p_yes(m, h2o3_tpu_torch.upload_file(df, device="cpu"), 200)
    np.testing.assert_allclose(scorer.predict(df)["y"], server, atol=1e-6)


def _numpy_output(jm) -> dict:
    spec = jm.output["bin_spec"]
    return {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards", "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f)) for f in pst.REPLAY_FIELDS}
                    for lv in t.levels] for t in group]
                  for group in jm.output["trees"]],
        "init_f": jm.output["init_f"],
        "n_tree_classes": jm.output["n_tree_classes"],
        "distribution": jm.output["distribution"],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
    }


def test_jax_xgboost_carried_across(frames):
    """A JAX XGBoost (regularized, positives weighted) handed over as numpy
    with ``algo="xgboost"`` predicts what it predicts in JAX."""
    df, jf, pf = frames
    jm = jxgb.XGBoost(ntrees=4, max_depth=4, seed=2, reg_alpha=0.5,
                      scale_pos_weight=2.0).train(y="label",
                                                  training_frame=jf)
    pm = gbm_from_numpy(_numpy_output(jm), device="cpu", algo="xgboost")
    assert pm.algo == "xgboost" and isinstance(pm, pxgb.XGBoostModel)
    np.testing.assert_allclose(_p_yes(pm, pf, len(df)),
                               _p_yes(jm, jf, len(df)), atol=1e-5)


def test_checkpoint_refused(frames):
    """XGBoost refuses a checkpoint as JAX's does: an unknown key, a
    changed regime parameter (``reg_lambda`` is frozen) and ``ntrees`` not
    above the prior's."""
    _, _, pf = frames
    with pytest.raises(ValueError, match="checkpoint"):
        XGBoost(ntrees=2, checkpoint="m").train(y="label", training_frame=pf)
    prior = XGBoost(ntrees=2, max_depth=2).train(y="label",
                                                 training_frame=pf)
    with pytest.raises(ValueError, match="reg_lambda"):
        XGBoost(ntrees=4, max_depth=2, reg_lambda=2.0,
                checkpoint=prior.key).train(y="label", training_frame=pf)
    with pytest.raises(ValueError, match="ntrees > 2"):
        XGBoost(ntrees=2, max_depth=2, checkpoint=prior.key).train(
            y="label", training_frame=pf)


def test_xgboost_cross_validation_matches_jax(frames):
    """XGBoost with ``nfolds=3`` through the CV driver: the holdout
    predictions and the CV AUC as JAX's."""
    df, jf, pf = frames
    kw = dict(ntrees=3, max_depth=3, seed=4, nfolds=3,
              keep_cross_validation_predictions=True)
    jm = jxgb.XGBoost(**kw).train(y="label", training_frame=jf)
    est = H2OXGBoostEstimator(**kw)
    est.train(y="label", training_frame=pf)
    assert [m.algo for m in est.cv_models] == ["xgboost"] * 3
    np.testing.assert_allclose(est.cv_predictions.numpy(),
                               np.asarray(jm.cv_predictions), atol=1e-5)
    assert est.auc(xval=True) == pytest.approx(
        jm.cross_validation_metrics.value("auc"), abs=1e-5)


def test_one_plan_serves_every_lambda_and_alpha(frames, monkeypatch):
    """λ and α are state of the whole-tree plan, not part of it: two
    XGBoost trainings with other λ and α build equal plans (on the card:
    one capture), flagged ``reg``; with λ = α = 0 the plan is GBM's, whose
    ``reg`` stays False."""
    _, _, pf = frames
    plans = []
    real = pst.WholeTreeBuilder.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        plans.append(self.plan)

    monkeypatch.setattr(pst.WholeTreeBuilder, "__init__", spy)
    kw = dict(ntrees=1, max_depth=3, seed=1, min_rows=10.0,
              min_split_improvement=1e-5, learn_rate=0.3)
    for reg in (dict(reg_lambda=1.0), dict(reg_lambda=20.0, reg_alpha=0.5),
                dict(reg_lambda=0.0, reg_alpha=0.0)):
        XGBoost(**kw, **reg).train(y="label", training_frame=pf)
    PGBM(**kw).train(y="label", training_frame=pf)
    a, b, unreg, gbm = plans
    assert a == b and a.reg
    assert unreg == gbm and not gbm.reg
    assert pst.leaf_reg(0.0, 0.0) is None
    assert pst.leaf_reg(0.0, 0.5) == (0.0, 0.5)
