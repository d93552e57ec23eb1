"""Stacked ensembles in the port (``h2o3_tpu_torch.models.ensemble``)
against the JAX package's (``h2o3_tpu/models/ensemble.py``), on the CPU at
test size: the level-one CV matrix, the non-negative GLM metalearner
(through the whole build, and alone on one level-one matrix given to
both), the ensemble's metrics and predictions; regression, multinomial (K
columns per base model) and ``weights_column``; every ``_validate``
refusal with JAX's message; ``base_models`` given by key; and
``H2OStackedEnsembleEstimator``.

The frames are JAX's ensemble test frames (``tests/test_grid_ensemble.py``:
a logistic binary label on four normal features; a regression response
with a sine term) with a 3-class response added, features rounded to a
0.1 grid so that no float near-tie splits a GBM differently in the two
packages (``tests/test_torch_cv.py``). DRF runs without draws
(``sample_rate=1.0``, ``mtries=-2``): the port's draws are keyed hashes,
not ``jax.random`` streams (``tests/test_torch_sampling.py``).

Tolerances, with their reasons:
- the level-one CV matrix: 1e-5 absolute, the base models' holdout
  predictions' own bound (``tests/test_torch_cv.py``);
- the metalearner given one level-one matrix in both packages:
  coefficients 1e-4 absolute, training and CV metrics 1e-5 relative (the
  GLM tests' bounds for a whole training, ``tests/test_torch_glm.py``);
- through the whole build, where the level-one inputs already differ by up
  to 1e-5: coefficients 1e-4, ensemble metrics 1e-4 (the optimum moves
  with its inputs);
- refusal messages: equal, with each package's model keys in them.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import ensemble as jens  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu.models.tree.drf import DRF as JDRF  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.estimators import H2OStackedEnsembleEstimator  # noqa: E402
from h2o3_tpu_torch.models import ensemble as pens  # noqa: E402
from h2o3_tpu_torch.models.glm import GLM as PGLM  # noqa: E402
from h2o3_tpu_torch.models.model_base import get_model  # noqa: E402
from h2o3_tpu_torch.models.tree.drf import DRF as PDRF  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM as PGBM  # noqa: E402

X = list("abcd")
CV = dict(nfolds=3, keep_cross_validation_predictions=True, seed=5)


def se_df(n=1500, seed=11) -> pd.DataFrame:
    """JAX's ensemble frames on a 0.1 grid: the binary ``y`` of
    ``_binary_df``, a regression ``yreg`` shaped as its regression test's, a
    3-class ``ymn``, user weights ``w`` and a second binary ``y2``."""
    rng = np.random.default_rng(seed)
    Xn = np.round(rng.normal(size=(n, 4)), 1)
    eta = Xn[:, 0] * 2 + Xn[:, 1] ** 2 - Xn[:, 2] - 1
    df = pd.DataFrame(Xn.astype(np.float32), columns=X)
    df["y"] = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)), "Y", "N")
    df["yreg"] = (1.5 * Xn[:, 0] + np.sin(3 * Xn[:, 1])
                  + 0.1 * rng.normal(size=n)).astype(np.float32)
    df["ymn"] = np.array(["u", "v", "w"])[np.digitize(
        eta + 0.5 * rng.normal(size=n), [-0.5, 0.8])]
    df["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    df["y2"] = np.where(Xn[:, 3] + rng.normal(size=n) > 0, "P", "Q")
    return df


@pytest.fixture(scope="module")
def data():
    df = se_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


def _both(data, specs, y, x=X):
    """Each (JAX class, port class, kwargs) trained in both packages."""
    _, jf, pf = data
    jms = [jc(**kw).train(x=x, y=y, training_frame=jf) for jc, _, kw in specs]
    pms = [pc(**kw).train(x=x, y=y, training_frame=pf) for _, pc, kw in specs]
    return jms, pms


def _np(t) -> np.ndarray:
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t,
                      np.float64)


def _coefs(model) -> dict:
    return {k: float(v) for k, v in model.coef.items()}


def _close_coefs(pm, jm, atol):
    pc, jc = _coefs(pm), _coefs(jm)
    assert pc.keys() == jc.keys()
    np.testing.assert_allclose([pc[k] for k in jc], list(jc.values()),
                               atol=atol)


BINOMIAL = [(JGBM, PGBM, dict(ntrees=10, max_depth=3, **CV)),
            (JDRF, PDRF, dict(ntrees=5, max_depth=5, sample_rate=1.0,
                              mtries=-2, **CV)),
            (JGLM, PGLM, dict(family="binomial", **CV))]


@pytest.fixture(scope="module")
def binomial(data):
    """The port's GBM, DRF and GLM base models on ``y`` (JAX's are built by
    the one test that needs them)."""
    _, _, pf = data
    return [pc(**kw).train(x=X, y="y", training_frame=pf)
            for _, pc, kw in BINOMIAL]


def test_binomial_level_one_and_metalearner_match_jax(data, binomial):
    """GBM + DRF + GLM, 3 folds: the level-one CV matrix (one P(Y) column
    per base model), the metalearner's non-negative coefficients, the
    ensemble's training and CV metrics, and ``predict``'s layout."""
    _, jf, pf = data
    jms = [jc(**kw).train(x=X, y="y", training_frame=jf)
           for jc, _, kw in BINOMIAL]
    pms = binomial
    Lj = jens._level_one_cv_matrix(jms)
    Lp = pens._level_one_cv_matrix(pms)
    assert Lp.shape == (pf.nrow, 3) and Lp.dtype == torch.float32
    np.testing.assert_allclose(_np(Lp), Lj[: pf.nrow], atol=1e-5)
    jse = jens.StackedEnsemble(base_models=jms).train(y="y", training_frame=jf)
    # base models given by key, as JAX's test gives its DRF
    pse = pens.StackedEnsemble(base_models=[pms[0], pms[1].key, pms[2]]
                               ).train(y="y", training_frame=pf)
    assert pse.base_models == pms
    meta = pse.metalearner
    assert meta.params.non_negative and meta.params.family == "binomial"
    assert meta.params.nfolds == 5 and len(meta.cv_models) == 5
    _close_coefs(meta, jse.metalearner, 1e-4)
    assert all(v >= 0 for k, v in _coefs(meta).items() if k != "Intercept")
    for mm in ("training_metrics", "cross_validation_metrics"):
        for name in ("auc", "logloss"):
            assert getattr(pse, mm).value(name) == pytest.approx(
                getattr(jse, mm).value(name), abs=1e-4), (mm, name)
    best = max(m.cross_validation_metrics.value("auc") for m in pms)
    assert pse.training_metrics.value("auc") >= best - 0.02
    pred = pse.predict(pf)
    assert pred.names == ["predict", "N", "Y"]
    p = _np(pred.vec("Y").data)
    jp = np.asarray(jse.predict(jf).vec("Y").to_numpy())[: pf.nrow]
    assert np.all((p >= 0) & (p <= 1))
    np.testing.assert_allclose(p, jp, atol=1e-4)
    assert pse.output["base_model_keys"] == [m.key for m in pms]
    assert get_model(pse.output["metalearner_key"]) is meta


def _metalearner_pair(L, y_codes, domain, w):
    """The metalearner each package's builder makes, trained on the same
    level-one matrix."""
    classification = domain is not None
    jb = jens.StackedEnsemble()
    jb._meta_weights = w is not None
    jf = jens._matrix_frame(L, y_codes, domain, weights=w)
    jm = jb._make_metalearner(classification, len(domain) if domain else 1
                              ).train(y="y", training_frame=jf)
    pb = pens.StackedEnsemble()
    pb._meta_weights = w is not None
    pframe = pens._matrix_frame(
        torch.from_numpy(L.astype(np.float32)),
        torch.from_numpy(np.asarray(y_codes, np.float32)), domain,
        weights=None if w is None else torch.from_numpy(w.copy()))
    pm = pb._make_metalearner(classification, len(domain) if domain else 1
                              ).train(y="y", training_frame=pframe)
    return jm, pm


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weights"])
def test_metalearner_alone_matches_jax(data, binomial, weighted):
    """The port's level-one CV matrix and response given to both packages'
    metalearners (non-negative binomial GLM, 5 folds; with weights, the
    ``__se_weights`` column): coefficients within 1e-4, metrics within
    1e-5 relative, CV holdout predictions within 1e-5."""
    df, _, pf = data
    pms = binomial
    L = _np(pens._level_one_cv_matrix(pms))
    y, _ = pms[0]._response_and_weights(pf)
    w = df["w"].to_numpy(np.float32) if weighted else None
    jm, pm = _metalearner_pair(L, _np(y).astype(np.int32), ("N", "Y"), w)
    assert pm.params.weights_column == (
        "__se_weights" if weighted else None)
    _close_coefs(pm, jm, 1e-4)
    for mm in ("training_metrics", "cross_validation_metrics"):
        for name in ("auc", "logloss"):
            assert getattr(pm, mm).value(name) == pytest.approx(
                getattr(jm, mm).value(name), rel=1e-5), (mm, name)
    np.testing.assert_allclose(_np(pm.cv_predictions),
                               _np(jm.cv_predictions)[: pf.nrow], atol=1e-5)


def test_regression_ensemble_matches_jax(data):
    """GBM + gaussian GLM on ``yreg``: one column per base model, a
    gaussian metalearner, metrics against JAX's."""
    _, jf, pf = data
    specs = [(JGBM, PGBM, dict(ntrees=10, max_depth=3, **CV)),
             (JGLM, PGLM, dict(family="gaussian", **CV))]
    jms, pms = _both(data, specs, "yreg")
    Lp = pens._level_one_cv_matrix(pms)
    assert Lp.shape == (pf.nrow, 2)
    np.testing.assert_allclose(_np(Lp), jens._level_one_cv_matrix(jms)
                               [: pf.nrow], atol=1e-5)
    jse = jens.StackedEnsemble(base_models=jms).train(y="yreg",
                                                      training_frame=jf)
    pse = pens.StackedEnsemble(base_models=pms).train(y="yreg",
                                                      training_frame=pf)
    assert not pse.is_classifier and pse.metalearner.params.family == "gaussian"
    _close_coefs(pse.metalearner, jse.metalearner, 1e-4)
    for name in ("rmse", "r2"):
        assert pse.training_metrics.value(name) == pytest.approx(
            jse.training_metrics.value(name), abs=1e-4), name
    assert pse.training_metrics.value("r2") > 0.8
    pred = pse.predict(pf)
    assert pred.names == ["predict"]


def test_multinomial_ensemble_matches_jax(data):
    """GBM + multinomial GLM on the 3-class ``ymn``: K = 3 columns per base
    model, a multinomial metalearner, metrics against JAX's."""
    _, jf, pf = data
    specs = [(JGBM, PGBM, dict(ntrees=5, max_depth=3, **CV)),
             (JGLM, PGLM, dict(family="multinomial", **CV))]
    jms, pms = _both(data, specs, "ymn")
    Lp = pens._level_one_cv_matrix(pms)
    assert Lp.shape == (pf.nrow, 6)
    np.testing.assert_allclose(_np(Lp), jens._level_one_cv_matrix(jms)
                               [: pf.nrow], atol=1e-5)
    jse = jens.StackedEnsemble(base_models=jms).train(y="ymn",
                                                      training_frame=jf)
    pse = pens.StackedEnsemble(base_models=pms).train(y="ymn",
                                                      training_frame=pf)
    assert pse.metalearner.params.family == "multinomial"
    assert pse.nclasses == 3
    for mm in ("training_metrics", "cross_validation_metrics"):
        for name in ("logloss", "mean_per_class_error"):
            assert getattr(pse, mm).value(name) == pytest.approx(
                getattr(jse, mm).value(name), abs=1e-4), (mm, name)
    probs = _np(torch.stack([pse.predict(pf).vec(c).data
                             for c in ("u", "v", "w")], dim=1))
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)


def test_weighted_base_models_ensemble_matches_jax(data):
    """Base models with ``weights_column``: the level-one frame carries
    ``__se_weights``, the metalearner trains on it, metrics against
    JAX's."""
    _, jf, pf = data
    specs = [(JGBM, PGBM, dict(ntrees=10, max_depth=3, weights_column="w",
                               **CV)),
             (JGLM, PGLM, dict(family="binomial", weights_column="w", **CV))]
    jms, pms = _both(data, specs, "y")
    jse = jens.StackedEnsemble(base_models=jms).train(y="y", training_frame=jf)
    pse = pens.StackedEnsemble(base_models=pms).train(y="y", training_frame=pf)
    assert pse.metalearner.params.weights_column == "__se_weights"
    _close_coefs(pse.metalearner, jse.metalearner, 1e-4)
    for mm in ("training_metrics", "cross_validation_metrics"):
        for name in ("auc", "logloss"):
            assert getattr(pse, mm).value(name) == pytest.approx(
                getattr(jse, mm).value(name), abs=1e-4), (mm, name)


@pytest.fixture(scope="module")
def refusal_models(data):
    """Cheap GLMs in both packages for every refusal: cross-validated on
    ``y`` and on ``y2``, without CV, with 2 folds, and under random fold
    assignment with seeds 1 and 2."""
    glm = dict(family="binomial")
    specs = {
        "cv": dict(CV, **glm),
        "cv_b": dict(CV, **glm),
        "no_cv": dict(glm),
        "two_folds": dict(CV, nfolds=2, **glm),
        "rand_1": dict(CV, fold_assignment="random", seed=1, **glm),
        "rand_2": dict(CV, fold_assignment="random", seed=2, **glm),
    }
    _, jf, pf = data
    out = {}
    for name, kw in specs.items():
        out[name] = (JGLM(**kw).train(x=X, y="y", training_frame=jf),
                     PGLM(**kw).train(x=X, y="y", training_frame=pf))
    out["y2"] = (JGLM(**dict(CV, **glm)).train(x=X, y="y2", training_frame=jf),
                 PGLM(**dict(CV, **glm)).train(x=X, y="y2", training_frame=pf))
    return out


def _message(train, keys, jax: bool) -> str:
    """The ValueError ``train`` raises, each model key replaced by
    ``<model>`` (longest first: one key can prefix another). JAX's builder
    runs in a job, which raises a RuntimeError holding the traceback: its
    last line is the ValueError."""
    with pytest.raises(RuntimeError if jax else ValueError) as e:
        train()
    msg = str(e.value)
    if jax:
        last = msg.strip().splitlines()[-1]
        assert last.startswith("ValueError: "), msg
        msg = last[len("ValueError: "):]
    for k in sorted(keys, key=len, reverse=True):
        msg = msg.replace(k, "<model>")
    return msg


REFUSALS = {
    "no_models": ([], "y", None),
    "unknown_key": (["no_such_model"], "y", None),
    "response_differs": (["cv", "cv_b"], "y2", None),
    "no_cv_predictions": (["cv", "no_cv"], "y", None),
    "rows_differ": (["cv", "cv_b"], "y", 600),
    "responses_disagree": (["cv", "y2"], "y", None),
    "fold_plan_differs": (["cv", "two_folds"], "y", None),
    "random_seeds_differ": (["rand_1", "rand_2"], "y", None),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_validate_refusals_match_jax(data, refusal_models, case):
    """Each ``_validate`` refusal raises ValueError with JAX's message (the
    models' keys put in their place)."""
    df, jf, pf = data
    names, y, rows = REFUSALS[case]
    if rows:  # a frame that is not the one the base models saw
        cut = df.iloc[:rows].reset_index(drop=True)
        jf, pf = JFrame.from_pandas(cut), h2o3_tpu_torch.upload_file(
            cut, device="cpu")
    msgs = []
    for side, frame in ((0, jf), (1, pf)):
        models = [refusal_models[n][side] if n in refusal_models else n
                  for n in names]
        cls = (jens if side == 0 else pens).StackedEnsemble
        keys = [m.key for m in models if not isinstance(m, str)]
        msgs.append(_message(
            lambda: cls(base_models=models).train(y=y, training_frame=frame),
            keys, jax=side == 0))
    assert msgs[1] == msgs[0]


def test_stacked_ensemble_estimator(data, binomial):
    """``H2OStackedEnsembleEstimator``: base models by key, the metric
    accessors through the model proxy, ``predict``."""
    _, _, pf = data
    pms = binomial
    est = H2OStackedEnsembleEstimator(base_models=[m.key for m in pms],
                                      metalearner_nfolds=3, seed=1)
    est.train(y="y", training_frame=pf)
    assert est.model.algo == "stackedensemble"
    assert est.model_id == est.model.key
    assert est.auc() == est.model.training_metrics.value("auc") > 0.7
    assert est.auc(xval=True) == pytest.approx(
        est.model.cross_validation_metrics.value("auc"))
    assert len(est.metalearner.cv_models) == 3
    pred = est.predict(pf)
    p = _np(pred.vec("Y").data)
    assert pred.nrow == pf.nrow and np.all((p >= 0) & (p <= 1))
    with pytest.raises(TypeError):
        H2OStackedEnsembleEstimator(base_model=[])
    with pytest.raises(ValueError, match="unknown metalearner_algorithm"):
        H2OStackedEnsembleEstimator(base_models=pms,
                                    metalearner_algorithm="svm").train(
            y="y", training_frame=pf)


@pytest.mark.parametrize("algo", ["gbm", "drf", "deeplearning"])
def test_other_metalearners(data, binomial, algo):
    """``metalearner_algorithm`` gbm, drf and deeplearning train their
    builder on the level-one frame (as in JAX's ``_make_metalearner``)."""
    _, _, pf = data
    pms = binomial
    params = {"gbm": dict(ntrees=3, max_depth=2),
              "drf": dict(ntrees=3, max_depth=3),
              "deeplearning": dict(hidden=(4,), epochs=1)}[algo]
    se = pens.StackedEnsemble(base_models=pms, metalearner_algorithm=algo,
                              metalearner_params=params,
                              metalearner_nfolds=2, seed=3).train(
        y="y", training_frame=pf)
    assert se.metalearner.algo == algo
    assert 0.5 < se.cross_validation_metrics.value("auc") <= 1.0
