"""AutoML in the port (``h2o3_tpu_torch.automl``) against the JAX package's
(``h2o3_tpu/automl``), on the CPU at test size: the default plan field for
field, ``_algo_allowed``, the per-model budgets of ``_common``, the
leaderboard's stable sort, ``as_table`` and ``get_leaderboard``, the
refusals, and small end-to-end runs in both packages: the same model
sequence, the same leaderboard order and the same metrics.

The end-to-end runs are JAX's AutoML scenario (``include_algos`` GBM and
GLM, ``max_models`` 4, ``nfolds`` 3, seed 7) on ``tests/test_automl.py``'s
frame shape (600 rows x 4 normal features, a logistic label), features on
a 0.1 grid (``tests/test_torch_cv.py``: no float near-tie splits a GBM
differently in the two packages), and once more with the ensembles
(``max_models`` 2). In both packages the plan's GBM presets run with
``sample_rate`` and ``col_sample_rate`` 1: the port's row and column draws
are keyed hashes, not ``jax.random`` streams, so a sampled GBM can only be
compared by distribution (``tests/test_torch_sampling.py``); every other
value of the plan is the default plan's, and ``test_default_plan_equals_jax``
holds that plan itself to JAX's.

Tolerances, with their reasons:
- plan, allowed algorithms, model sequence, leaderboard order: equal;
- ``_common``'s budgets: 0.5 s (the two calls read the clock apart);
- cross-validation metrics, holdout predictions and leaderboard values:
  1e-5 absolute (GBM holdouts' bound in ``tests/test_torch_cv.py``; the
  GLM's coefficients are held to 1e-4 there, its metrics to 1e-5) and
  1e-4 for the ensembles, whose metalearner fits level-one inputs that
  already differ by up to 1e-5 (``tests/test_torch_ensemble.py``);
- deep GBMs on 600 rows part from JAX's at float near-ties (two columns
  that split a node into the same rows, decided by the rounding of sums
  added in another order): every parting must pass
  ``tools/tree_parity.divergences``' near-tie rule on JAX's trees, a
  parted model's CV AUC is held within 1e-2, and the two leaderboards'
  orders are compared when no model parted.
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from h2o3_tpu.automl import automl as jam  # noqa: E402
from h2o3_tpu.automl import get_leaderboard as jget_leaderboard  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.automl import automl as pam  # noqa: E402
from h2o3_tpu_torch.automl import get_leaderboard  # noqa: E402
from h2o3_tpu_torch.tools.tree_parity import divergences  # noqa: E402

ALGOS = ("gbm", "xgboost", "glm", "drf", "xrt", "deeplearning",
         "stackedensemble")


def automl_df(n=600, seed=7) -> pd.DataFrame:
    """``_binary_frame`` of JAX's AutoML tests, features on a 0.1 grid."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 4)), 1)
    eta = X[:, 0] * 2 - X[:, 1] + 0.5 * X[:, 2]
    y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int)
    df = pd.DataFrame(X.astype(np.float32), columns=list("abcd"))
    df["y"] = np.where(y == 1, "yes", "no")
    return df


def _fields(step) -> dict:
    return {f.name: getattr(step, f.name) for f in dataclasses.fields(step)}


def test_default_plan_equals_jax():
    """Every step of the default plan: name, kind, algorithm, presets,
    hyperparameter space and weight, in JAX's order."""
    got = [_fields(s) for s in pam._default_plan()]
    want = [_fields(s) for s in jam._default_plan()]
    assert got == want
    assert [f.name for f in dataclasses.fields(pam._Step)] == \
        [f.name for f in dataclasses.fields(jam._Step)]


def test_spec_defaults_equal_jax():
    """``AutoMLSpec``'s fields and defaults are JAX's."""
    got = {f.name: f.default for f in dataclasses.fields(pam.AutoMLSpec)}
    want = {f.name: f.default for f in dataclasses.fields(jam.AutoMLSpec)}
    assert got == want


@pytest.mark.parametrize("kw", [
    {}, {"include_algos": ["GBM", "GLM"]},
    {"exclude_algos": ["DeepLearning", "StackedEnsemble"]},
    {"include_algos": ["XGBoost"], "exclude_algos": ["XGBoost"]},
    {"include_algos": []}])
def test_algo_allowed_equals_jax(kw):
    p, j = pam.AutoML(**kw), jam.AutoML(**kw)
    assert [p._algo_allowed(a) for a in ALGOS] == \
        [j._algo_allowed(a) for a in ALGOS]


@pytest.mark.parametrize("kw,elapsed", [
    ({}, 0.0), ({"max_runtime_secs": 40.0}, 12.0),
    ({"max_runtime_secs": 40.0}, 45.0),
    ({"max_runtime_secs": 0.0, "max_runtime_secs_per_model": 7.0}, 3.0),
    ({"max_runtime_secs": 100.0, "max_runtime_secs_per_model": 7.0}, 95.5),
    ({"nfolds": 0, "seed": 3}, 0.0)])
def test_common_budgets_equal_jax(kw, elapsed):
    """The keyword arguments every step's builder gets: folds, kept
    predictions, seed, and the per-model deadline capped by what remains
    of the whole budget (at least 1 s)."""
    p, j = pam.AutoML(**kw), jam.AutoML(**kw)
    p._t0 = j._t0 = time.time() - elapsed
    pc, jc = p._common(), j._common()
    assert pc.keys() == jc.keys()
    for k in pc:
        assert pc[k] == pytest.approx(jc[k], abs=0.5), k


class _Metrics:
    def __init__(self, **vals):
        self.vals = vals

    def value(self, name):
        return self.vals.get(name, float("nan"))


class _Model:
    """What a leaderboard reads of a model."""

    def __init__(self, i, auc):
        self.key = f"m{i}"
        self.algo = ("gbm", "glm")[i % 2]
        self.run_time_ms = 100 * i
        self.cross_validation_metrics = _Metrics(auc=auc, logloss=1.0 - auc)
        self.validation_metrics = self.training_metrics = None


AUCS = [0.8, 0.9, 0.8, float("nan"), 0.9, 0.7, 0.8]


@pytest.mark.parametrize("larger", [True, False])
def test_leaderboard_stable_sort_equals_jax(larger):
    """Ties keep the order in which the models were added (a stable sort
    on ``(isnan, -value)``), NaN last; the same order, table and extra
    columns as JAX's."""
    models = [_Model(i, a) for i, a in enumerate(AUCS)]
    p = pam.Leaderboard("auc", larger)
    j = jam.Leaderboard("auc", larger)
    for m in models:  # one at a time, as AutoML adds them
        p.add(m)
        j.add(m)
    assert [m.key for m in p.models] == [m.key for m in j.models]
    want = (["m1", "m4", "m0", "m2", "m6", "m5", "m3"] if larger
            else ["m5", "m0", "m2", "m6", "m1", "m4", "m3"])
    assert [m.key for m in p.models] == want
    assert p.leader is models[int(want[0][1:])]
    for extra in ((), "ALL", ("training_time_ms",)):
        got, exp = p.as_table(extra), j.as_table(extra)
        assert [r.keys() for r in got] == [r.keys() for r in exp]
        for r, e in zip(got, exp):
            np.testing.assert_array_equal(list(r.values()), list(e.values()))
    assert repr(p).splitlines()[0] == "Leaderboard (sorted by auc):"


def test_refusals():
    """Target encoding and checkpoint directories raise, naming their
    ROADMAP item, before any model is built."""
    fr = h2o3_tpu_torch.upload_file(automl_df(60), device="cpu")
    for kw, item in (({"preprocessing": ["target_encoding"]}, "Queue A 10"),
                     ({"export_checkpoints_dir": "ck"}, "Queue A 5")):
        aml = pam.AutoML(max_models=1, nfolds=0, **kw)
        with pytest.raises(NotImplementedError, match=item):
            aml.train(y="y", training_frame=fr)
        assert aml.leaderboard is None and not aml.step_log


def _unsampled(plan_fn):
    """``plan_fn``'s plan with the GBM presets' sampling rates at 1."""
    def plan():
        steps = plan_fn()
        for st in steps:
            if st.algo == "gbm" and st.kind == "model":
                st.params.update(sample_rate=1.0, col_sample_rate=1.0)
        return steps
    return plan


RUNS = {
    "gbm_glm": dict(include_algos=["GBM", "GLM"], max_models=4),
    "with_ensembles": dict(include_algos=["GBM", "GLM", "StackedEnsemble"],
                           max_models=2),
}


@pytest.fixture(scope="module", params=list(RUNS))
def runs(request):
    """One AutoML run in each package, on the plan without sampling."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jam, "_default_plan", _unsampled(jam._default_plan))
    mp.setattr(pam, "_default_plan", _unsampled(pam._default_plan))
    try:
        df = automl_df()
        kw = dict(nfolds=3, seed=7, max_runtime_secs=3000.0,
                  **RUNS[request.param])
        j = jam.AutoML(**kw)
        j.train(y="y", training_frame=JFrame.from_pandas(df))
        p = pam.AutoML(**kw)
        p.train(y="y", training_frame=h2o3_tpu_torch.upload_file(
            df, device="cpu"))
    finally:
        mp.undo()
    return request.param, j, p


def _steps(aml) -> dict:
    """model key -> the plan step that built it, from the event log."""
    out = {}
    for e in aml.event_log:
        if e["stage"] in ("model", "ensemble") and " -> " in e["message"]:
            step, rest = e["message"].split(" -> ")
            out[rest.split()[0]] = step
    return out


def _parting(pm, jm) -> int:
    """Class trees of a GBM (its main model and each fold model) that part
    from JAX's model of the same step; ``divergences`` raises unless each
    parting is a float near-tie (``tools/tree_parity.py``)."""
    if pm.algo != "gbm":
        return 0
    parted = 0
    for p, j in zip([pm, *pm.cv_models], [jm, *jm.cv_models]):
        d = divergences(SimpleNamespace(model=p), SimpleNamespace(model=j))
        parted += len(d["partings"])
    return parted


def _check_metrics(j, p):
    """Each step's model: its CV metrics and kept holdout predictions
    within 1e-5 of JAX's (ensembles 1e-4) where its trees and its base
    models' trees equal JAX's; where a GBM parts at a float near-tie, its
    CV AUC within 1e-2 (a near-tie moves a whole leaf of one tree and
    every tree grown after it);
    ``get_leaderboard`` rows with ``extra_columns="ALL"``."""
    js = {s: m for m in j.leaderboard.models for s in [_steps(j)[m.key]]}
    ps = {s: m for m in p.leaderboard.models for s in [_steps(p)[m.key]]}
    assert ps.keys() == js.keys()
    parted = {s: _parting(pm, js[s]) for s, pm in ps.items()}
    for step, pm in ps.items():
        jm = js[step]
        if pm.algo == "stackedensemble":
            exact = not any(parted[_steps(p)[b.key]] for b in pm.base_models)
            tol = 1e-4
        else:
            exact, tol = not parted[step], 1e-5
        if not exact:
            assert pm.cross_validation_metrics.value("auc") == pytest.approx(
                jm.cross_validation_metrics.value("auc"), abs=1e-2), step
            continue
        for name in ("auc", "logloss", "rmse"):
            assert pm.cross_validation_metrics.value(name) == pytest.approx(
                jm.cross_validation_metrics.value(name), abs=tol), (step, name)
        if pm.cv_predictions is not None:
            np.testing.assert_allclose(
                pm.cv_predictions.numpy(),
                np.asarray(jm.cv_predictions)[: pm.cv_predictions.shape[0]],
                atol=tol)
    assert not parted["def_glm" if "def_glm" in parted else "def_gbm_2"]
    rows, jrows = get_leaderboard(p, extra_columns="ALL"), \
        jget_leaderboard(j, extra_columns="ALL")
    assert [r.keys() for r in rows] == [r.keys() for r in jrows]
    assert all(r["training_time_ms"] >= 0 for r in rows)
    assert all("training_time_ms" not in r for r in get_leaderboard(p))
    assert get_leaderboard(pam.AutoML()) == []


def test_automl_end_to_end_equals_jax(runs):
    """The same steps build the same algorithms in the same order; each
    package's leaderboard ranks the other's models in that package's own
    order (the ranking code on real models); the port's leaderboard is
    sorted by AUC; and where no GBM of the run parts from JAX's at a float
    near-tie, the two leaderboards rank the steps alike. Then the models'
    metrics (:func:`_check_metrics`). One test per run: a module fixture is
    built anew in every worker that runs one of its tests."""
    name, j, p = runs
    stages = [(e["stage"], e["message"].split(" -> ")[0])
              for e in p.event_log]
    assert stages == [(e["stage"], e["message"].split(" -> ")[0])
                      for e in j.event_log]
    built = [r["step"] for r in p.step_log if r["models"]]
    assert built == [s for st, s in stages if st == "model"]
    js, ps = _steps(j), _steps(p)
    for mine, other, cls in ((p, j, pam.Leaderboard),
                             (j, p, jam.Leaderboard)):
        lb = cls(mine.leaderboard.sort_metric, mine.leaderboard.larger)
        for m in sorted(other.leaderboard.models,
                        key=lambda m: list(_steps(other)).index(m.key)):
            lb.add(m)
        assert lb.models == other.leaderboard.models
    aucs = [r["auc"] for r in p.leaderboard.as_table()]
    assert aucs == sorted(aucs, reverse=True)
    jm = {s: m for m in j.leaderboard.models for s in [js[m.key]]}
    if not any(_parting(m, jm[ps[m.key]]) for m in p.leaderboard.models):
        assert [ps[m.key] for m in p.leaderboard.models] == \
            [js[m.key] for m in j.leaderboard.models]
    if name == "with_ensembles":
        assert "stackedensemble" in {m.algo for m in p.leaderboard.models}
    _check_metrics(j, p)
