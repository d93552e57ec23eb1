"""RuleFit and AdaBoost in the port (``h2o3_tpu_torch.models.rulefit``,
``models.adaboost``) against the JAX package's on the CPU, at small sizes,
inputs made with numpy from seeds. The features sit on an integer grid, so
both packages' bins and histogram sums are exact and a split cannot turn
on a float sum's order.

Tolerances, with their reasons:
- RuleFit on GBM forests, at an explicit ``lambda_`` and through the
  holdout pick: the same rule texts in the same order, supports within
  1e-7 (numpy's float32 mean against the port's exact count over n), the
  same lambda within 1e-6 relative (``lambda_max`` from a float32
  gradient), the GLM's coefficients within 1e-4 and predictions within
  1e-5; the DRF lane (whose row draws differ from JAX's by design) is held
  on structure: each rule's support equals its bin masks evaluated on the
  binned frame in numpy;
- AdaBoost's stumps equal in every split, the alphas within 1e-6 and the
  probabilities within 1e-5 (the weighted errors are float32 sums in
  another order), and both stop at ``err >= 0.5``;
- each JAX model carried across predicts within these bounds, and each
  save/load round trip is exact.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
import h2o3_tpu.models.rulefit as jrulefit  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.adaboost import AdaBoost as JAdaBoost  # noqa: E402
from h2o3_tpu_torch import estimators as E  # noqa: E402
from h2o3_tpu_torch.models import convert_more as cm  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.binning import bin_frame  # noqa: E402

from test_torch_glm import jax_glm_numpy  # noqa: E402

SPLIT_FIELDS = ("split_col", "split_bin", "na_left", "leaf_now")


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """No entries written to JAX's shared persistent compilation cache
    (it writes in place without a lock; see test_torch_frame_ops.py)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


def _fit(est_cls, pf, y=None, **kw):
    est = est_cls(**kw)
    est.train(y=y, training_frame=pf)
    return est.model


def _round_trip(model, tmp_path):
    path = h2o3_tpu_torch.save_model(model, str(tmp_path) + "/")
    back = h2o3_tpu_torch.load_model(path, device="cpu")
    assert type(back) is type(model) and back.key == model.key
    return back


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    n = 1500
    X = rng.integers(0, 12, (n, 4)).astype(np.float64)
    X[rng.random((n, 4)) < 0.02] = np.nan
    Xf = np.nan_to_num(X)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    df["g"] = pd.Categorical(rng.choice(["a", "b", "c"], n))
    eta = ((Xf[:, 0] > 5) * 1.0 - (Xf[:, 1] > 7) * 0.8 + 0.1 * Xf[:, 2] - 1
           + (df["g"] == "b") * 0.7)
    df["y"] = pd.Categorical.from_codes(
        (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int), ["n", "p"])
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


# --------------------------------------------------------------------------
# RuleFit


@pytest.fixture(scope="module")
def rulefit_pairs(data):
    """JAX's and the port's RuleFit on GBM forests, at an explicit lambda
    and through the holdout pick, with JAX's rules (text and support, in
    order) read by a spy on its ``_rule_text``."""
    df, jf, pf = data
    seen: list = []
    orig = jrulefit._rule_text

    def spy(r, spec):
        t = orig(r, spec)
        seen.append((t, r.support))
        return t

    jrulefit._rule_text = spy
    out = {}
    try:
        for name, kw in (
                ("explicit", dict(algorithm="GBM", rule_generation_ntrees=4,
                                  lambda_=1e-3, seed=3)),
                ("holdout", dict(algorithm="GBM", rule_generation_ntrees=4,
                                 seed=3, min_rule_length=2,
                                 max_rule_length=3))):
            seen.clear()
            jm = jrulefit.RuleFit(**kw).train(y="y", training_frame=jf)
            out[name] = (jm, list(seen), _fit(E.H2ORuleFitEstimator, pf, "y",
                                               **kw))
    finally:
        jrulefit._rule_text = orig
    return out


@pytest.mark.parametrize("case", ["explicit", "holdout"])
def test_rulefit_gbm_equals_jax(data, rulefit_pairs, case):
    df, jf, pf = data
    jm, jrules, pm = rulefit_pairs[case]
    prules = pm.output["rules"]
    assert [t for t, _ in jrules] == [r["text"] for r in prules]
    np.testing.assert_allclose([r["support"] for r in prules],
                               [s for _, s in jrules], rtol=0, atol=1e-7)
    assert pm.output["lambda"] == pytest.approx(jm.output["lambda"],
                                                rel=1e-6)
    if case == "holdout":
        assert len(pm.output["lambdas_tried"]) == 8
    jc, pc = jm.output["glm_model"].coef, pm.output["glm_model"].coef
    assert set(jc) == set(pc)
    for k in jc:
        assert pc[k] == pytest.approx(jc[k], abs=1e-4)
    want = np.asarray(jm._predict_raw(jf))[: len(df)]
    np.testing.assert_allclose(pm._predict_raw(pf).numpy(), want, rtol=0,
                               atol=1e-5)
    assert [d["variable"] for d in pm.rule_importance()] == [
        d["variable"] for d in jm.rule_importance()]


def test_rulefit_carried_across_and_round_trip(data, rulefit_pairs,
                                               tmp_path):
    df, jf, pf = data
    jm, _, pm = rulefit_pairs["explicit"]
    spec = jm.output["bin_spec"]
    out = {k: jm.output[k] for k in (
        "rule_cols", "rule_masks", "rule_valid", "rule_names",
        "linear_names", "rule_importance", "lambda", "names",
        "response_domain")}
    out["bin_spec"] = {f: getattr(spec, f) for f in (
        "names", "is_cat", "nbins", "edges", "cards", "domains")}
    out["glm_model"] = jax_glm_numpy(jm.output["glm_model"])
    carried = cm.rulefit_from_numpy(out, device="cpu",
                                    params={"response_column": "y"})
    want = np.asarray(jm._predict_raw(jf))[: len(df)]
    np.testing.assert_allclose(carried._predict_raw(pf).numpy(), want,
                               rtol=0, atol=1e-5)
    back = _round_trip(pm, tmp_path)
    assert torch.equal(back._predict_raw(pf), pm._predict_raw(pf))


def test_rulefit_drf_rules_match_their_masks(data):
    """The DRF lane (rule length 1 to 3): every rule's support is the share
    of rows whose bin codes its masks admit, evaluated in numpy."""
    df, jf, pf = data
    pm = _fit(E.H2ORuleFitEstimator, pf, "y", rule_generation_ntrees=6,
              min_rule_length=1, max_rule_length=3, seed=2, lambda_=1e-3)
    o = pm.output
    assert o["rules"] and o["rulefit_stats"]["rules_extracted"] >= len(
        o["rules"])
    codes = bin_frame(o["bin_spec"], pf).numpy().astype(np.int64)
    for ri, r in enumerate(o["rules"]):
        hit = np.ones(len(df), bool)
        for li in np.flatnonzero(o["rule_valid"][ri]):
            hit &= o["rule_masks"][ri, li][codes[:, o["rule_cols"][ri, li]]]
        assert r["support"] == pytest.approx(hit.mean(), abs=1e-7)
        assert 0 < hit.mean() < 1
    assert pm.training_metrics.value("auc") > 0.6


# --------------------------------------------------------------------------
# AdaBoost


@pytest.fixture(scope="module")
def ada_pair(data):
    df, jf, pf = data
    kw = dict(nlearners=8, seed=1)
    return (JAdaBoost(**kw).train(y="y", training_frame=jf),
            _fit(E.H2OAdaBoostEstimator, pf, "y", **kw))


def _levels(tree):
    return tree.to_host().levels


def test_adaboost_equals_jax(data, ada_pair):
    """Every stump equal in its splits, alphas within 1e-6, leaves within
    1e-6 of their alpha, probabilities within 1e-5."""
    df, jf, pf = data
    jm, pm = ada_pair
    assert pm.output["ntrees_actual"] == jm.output["ntrees_actual"] == 8
    np.testing.assert_allclose(pm.output["alphas"], jm.output["alphas"],
                               rtol=0, atol=1e-6)
    for tj, tp in zip(jm.output["trees"], pm.output["trees"]):
        for a, b in zip(_levels(tj[0]), _levels(tp[0])):
            for f in SPLIT_FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                              np.asarray(getattr(b, f)))
            np.testing.assert_allclose(np.asarray(b.leaf_val),
                                       np.asarray(a.leaf_val), rtol=0,
                                       atol=1e-6)
    want = np.asarray(jm._predict_raw(jf))[: len(df)]
    np.testing.assert_allclose(pm._predict_raw(pf).numpy(), want, rtol=0,
                               atol=1e-5)
    assert pm.training_metrics.value("auc") == pytest.approx(
        jm.training_metrics.value("auc"), abs=1e-6)


def test_adaboost_stops_at_chance():
    """A balanced response and a constant feature: the first stump's error
    is not below 0.5, so both packages stop with no learner."""
    df = pd.DataFrame({"c": np.ones(200)})
    df["y"] = pd.Categorical.from_codes(np.arange(200) % 2, ["a", "b"])
    jm = JAdaBoost(nlearners=5).train(y="y",
                                       training_frame=JFrame.from_pandas(df))
    pm = _fit(E.H2OAdaBoostEstimator,
              h2o3_tpu_torch.upload_file(df, device="cpu"), "y", nlearners=5)
    assert jm.output["ntrees_actual"] == pm.output["ntrees_actual"] == 0


def test_adaboost_carried_across_and_round_trip(data, ada_pair, tmp_path):
    df, jf, pf = data
    jm, pm = ada_pair
    spec = jm.output["bin_spec"]
    out = {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards",
                      "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f))
                     for f in pst.REPLAY_FIELDS} for lv in _levels(t[0])]]
                  for t in jm.output["trees"]],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
        "alphas": jm.output["alphas"],
    }
    carried = cm.adaboost_from_numpy(out, device="cpu",
                                     params={"response_column": "y"})
    want = np.asarray(jm._predict_raw(jf))[: len(df)]
    np.testing.assert_allclose(carried._predict_raw(pf).numpy(), want,
                               rtol=0, atol=1e-6)
    back = _round_trip(pm, tmp_path)
    assert torch.equal(back._predict_raw(pf), pm._predict_raw(pf))


def test_adaboost_refuses_more_than_two_classes(data):
    df, _, _ = data
    d = df.assign(k=pd.Categorical.from_codes(np.arange(len(df)) % 3,
                                              ["u", "v", "w"]))
    pf = h2o3_tpu_torch.upload_file(d.drop(columns=["y"]), device="cpu")
    with pytest.raises(ValueError, match="binary classifier"):
        _fit(E.H2OAdaBoostEstimator, pf, "k")
