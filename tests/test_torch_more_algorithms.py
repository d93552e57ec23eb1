"""The aggregator, GAM, model selection and CoxPH in the port
(``h2o3_tpu_torch.models``) against the JAX package's on the CPU, at small
sizes, inputs made with numpy from seeds: each model trained in both
packages, carried across from JAX (``models.convert_more``) and through a
save/load round trip.

Tolerances, with their reasons:
- the aggregator's exemplars, counts, mapping and aggregated frame (a
  string column included) equal under NONE, STANDARDIZE and NORMALIZE,
  with a categorical column and with runs that pass the budget and
  re-aggregate: both packages take the same float32 distances through
  the same host decisions (the features are continuous, so no two
  distances tie exactly);
- GAM's knots, F and Z within 1e-12 (the same float64 host algebra, Z from
  column sums added in another order); coefficients within 1e-4 plus
  1e-4 of their magnitude and predictions within 1e-5 of the largest
  prediction's magnitude (each IRLS step solves a float32 Gram summed in
  another order through the penalized solve, so the gap scales with the
  coefficient);
- model selection's subsets equal and R² within 1e-6 in every gaussian
  mode (JAX's float32 Gram and sums against the port's float64 sums of
  float32 products, on a centred response), the binomial ``maxr`` subsets
  equal;
- CoxPH within 1e-4 of JAX's float32 Newton and within 1e-8 of a float64
  numpy evaluation of JAX's formula, the concordance equal; a 40-event
  tie group is truncated at 32 Efron terms by both packages.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import (  # noqa: E402,F401
    share_cores,
    torch_default_threads,
)

share_cores()

import jax  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.aggregator import Aggregator as JAggregator  # noqa: E402
from h2o3_tpu.models.coxph import CoxPH as JCoxPH  # noqa: E402
from h2o3_tpu.models.gam import GAM as JGAM  # noqa: E402
from h2o3_tpu.models.model_selection import (  # noqa: E402
    ModelSelection as JModelSelection,
)
from h2o3_tpu_torch import estimators as E  # noqa: E402
from h2o3_tpu_torch.models import convert_more as cm  # noqa: E402
from h2o3_tpu_torch.models import coxph as pcox  # noqa: E402
from h2o3_tpu_torch.models.export import _datainfo_meta  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """No entries written to JAX's shared persistent compilation cache
    (it writes in place without a lock; see test_torch_frame_ops.py)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


def _frames(df):
    return JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df,
                                                              device="cpu")


def _fit(est_cls, pf, y=None, x=None, **kw):
    est = est_cls(**kw)
    est.train(x=x, y=y, training_frame=pf)
    return est.model


def _round_trip(model, tmp_path):
    path = h2o3_tpu_torch.save_model(model, str(tmp_path) + "/")
    back = h2o3_tpu_torch.load_model(path, device="cpu")
    assert type(back) is type(model) and back.key == model.key
    return back


# --------------------------------------------------------------------------
# the aggregator


@pytest.fixture(scope="module")
def agg_frames():
    rng = np.random.default_rng(3)
    n = 2500
    X = rng.normal(size=(n, 4))
    X[rng.random((n, 4)) < 0.03] = np.nan
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    df["g"] = pd.Categorical(rng.choice(["a", "b", "c", "d"], n))
    df["s"] = [f"r{i}" for i in range(n)]  # a string column, carried
    return _frames(df)


def _agg_frame_equal(jm, pm):
    ja = jm.output["aggregated_frame"].to_pandas()
    pa = pm.aggregated_frame.to_pandas()
    pd.testing.assert_frame_equal(ja, pa, check_dtype=False,
                                  check_categorical=False)


@pytest.mark.parametrize("transform,target", [
    ("NONE", 40), ("STANDARDIZE", 40), ("NORMALIZE", 40),
    ("NORMALIZE", 400)])
def test_aggregator_equals_jax(agg_frames, transform, target):
    """Every transform, a categorical column, and runs that overflow the
    budget (the radius doubles and the exemplars re-aggregate): the same
    exemplars, counts, mapping and frame."""
    jf, pf = agg_frames
    kw = dict(target_num_exemplars=target, transform=transform, seed=5)
    jm = JAggregator(**kw).train(training_frame=jf)
    pm = _fit(E.H2OAggregatorEstimator, pf, **kw)
    st = pm.output["aggregator_stats"]
    assert st["reaggregations"] > 0 and st["passes"] > 0
    assert jm.output["num_exemplars"] == pm.output["num_exemplars"]
    assert jm.output["radius"] == pm.output["radius"]
    np.testing.assert_array_equal(jm.output["mapping"], pm.output["mapping"])
    _agg_frame_equal(jm, pm)
    counts = pm.aggregated_frame.vec("counts").to_numpy()
    assert counts.sum() == pf.nrow


def test_aggregator_carried_across_and_round_trip(agg_frames, tmp_path):
    jf, pf = agg_frames
    jm = JAggregator(target_num_exemplars=40, seed=5).train(training_frame=jf)
    out = {k: jm.output[k] for k in ("mapping", "num_exemplars", "nobs",
                                     "radius", "names")}
    out["aggregated_frame"] = jm.output["aggregated_frame"].to_pandas()
    pm = cm.aggregator_from_numpy(out, device="cpu")
    _agg_frame_equal(jm, pm)
    back = _round_trip(pm, tmp_path)
    pd.testing.assert_frame_equal(back.aggregated_frame.to_pandas(),
                                  pm.aggregated_frame.to_pandas())
    np.testing.assert_array_equal(back.mapping, pm.mapping)


# --------------------------------------------------------------------------
# GAM


@pytest.fixture(scope="module")
def gam_data():
    rng = np.random.default_rng(4)
    n = 1500
    X = rng.normal(size=(n, 4))
    X[rng.random((n, 4)) < 0.02] = np.nan
    Xf = np.nan_to_num(X)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    eta = np.sin(2 * Xf[:, 0]) + Xf[:, 1] ** 2 - 1 + 0.5 * Xf[:, 2]
    df["yr"] = eta + rng.normal(size=n)
    df["yb"] = pd.Categorical.from_codes(
        (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int), ["n", "p"])
    return df, *_frames(df)


GAM_KW = dict(gam_columns=["f0", "f1"], num_knots=[6, 8], scale=[1.0, 0.5],
              lambda_=1e-3)


@pytest.fixture(scope="module")
def gam_pairs(gam_data):
    df, jf, pf = gam_data
    x = [f"f{i}" for i in range(4)]
    return {y: (JGAM(**GAM_KW).train(y=y, x=x, training_frame=jf),
                _fit(E.H2OGeneralizedAdditiveEstimator, pf, y, x, **GAM_KW))
            for y in ("yr", "yb")}


def _gam_pred_close(jm, jf, pm, pf, n):
    want = np.asarray(jm._predict_raw(jf))[:n]
    got = pm._predict_raw(pf).double().numpy()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("y", ["yr", "yb"])
def test_gam_equals_jax(gam_data, gam_pairs, y):
    """Gaussian and binomial with 2 gam columns: the spline algebra within
    1e-12, coefficients within 1e-4, predictions within 1e-5."""
    df, jf, pf = gam_data
    jm, pm = gam_pairs[y]
    for a, b in zip(jm.output["gam_terms"], pm.output["gam_terms"]):
        for f in ("knots", "F", "Z"):
            np.testing.assert_allclose(b[f], a[f], rtol=0, atol=1e-12)
        assert a["impute"] == pytest.approx(b["impute"], abs=1e-12)
    assert jm.output["coef_names"] == pm.output["coef_names"]
    np.testing.assert_allclose(pm.output["beta"], jm.output["beta"],
                               rtol=1e-4, atol=1e-4)
    _gam_pred_close(jm, jf, pm, pf, len(df))
    if y == "yb":
        assert pm.training_metrics.value("auc") == pytest.approx(
            jm.training_metrics.value("auc"), abs=1e-4)


def _gam_numpy(jm) -> dict:
    keep = ("beta", "coef_names", "linear_names", "linear_info",
            "gam_terms", "family", "intercept", "deviance", "names",
            "response_domain")
    return {k: jm.output[k] for k in keep}


def test_gam_carried_across_and_round_trip(gam_data, gam_pairs, tmp_path):
    df, jf, pf = gam_data
    for y, (jm, _) in gam_pairs.items():
        pm = cm.gam_from_numpy(_gam_numpy(jm), params={"response_column": y})
        _gam_pred_close(jm, jf, pm, pf, len(df))
        back = _round_trip(pm, tmp_path)
        assert torch.equal(back._predict_raw(pf), pm._predict_raw(pf))


def test_gam_needs_gam_columns(gam_data):
    _, _, pf = gam_data
    with pytest.raises(ValueError, match="gam_columns"):
        _fit(E.H2OGeneralizedAdditiveEstimator, pf, "yr")


# --------------------------------------------------------------------------
# model selection


@pytest.fixture(scope="module")
def ms_data():
    rng = np.random.default_rng(6)
    n = 1500
    X = rng.normal(size=(n, 5))
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(5)])
    df["g"] = pd.Categorical(rng.choice(["a", "b", "c"], n))
    eta = X[:, 0] - 0.6 * X[:, 2] + 0.3 * X[:, 3] + 0.7 * (df["g"] == "b")
    df["yr"] = eta - eta.mean() + rng.normal(size=n)
    df["yb"] = pd.Categorical.from_codes(
        (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int), ["n", "p"])
    return df, *_frames(df)


MS_X = [f"f{i}" for i in range(5)] + ["g"]


@pytest.mark.parametrize("mode", ["maxr", "allsubsets", "forward",
                                  "backward"])
def test_model_selection_gaussian_equals_jax(ms_data, mode, tmp_path):
    """Every gaussian mode: the same best subsets, R² within 1e-6, the
    coefficients per size within 1e-4, predictions within 1e-5."""
    df, jf, pf = ms_data
    kw = dict(mode=mode, max_predictor_number=3)
    jm = JModelSelection(**kw).train(y="yr", x=MS_X, training_frame=jf)
    pm = _fit(E.H2OModelSelectionEstimator, pf, "yr", MS_X, **kw)
    assert (pm.get_best_model_predictors()
            == [list(s) for s in jm.output["best_predictor_subsets"]])
    np.testing.assert_allclose(pm.get_best_r2_values(),
                               jm.output["best_r2_values"], rtol=0,
                               atol=1e-6)
    for a, b in zip(jm.output["coef_per_size"], pm.output["coef_per_size"]):
        assert set(a) == set(b)
        for k in a:
            assert b[k] == pytest.approx(a[k], abs=1e-4)
    want = np.asarray(jm._predict_raw(jf))[: len(df)]
    np.testing.assert_allclose(pm._predict_raw(pf).numpy(), want, rtol=0,
                               atol=1e-5)
    if mode == "maxr":
        out = {k: jm.output[k] for k in (
            "beta_std_final", "best_predictor_subsets", "best_r2_values",
            "coef_per_size", "family", "mode", "names", "response_domain")}
        out["datainfo"] = _datainfo_meta(jm.output["datainfo"])
        cm_ = cm.modelselection_from_numpy(out,
                                           params={"response_column": "yr"})
        np.testing.assert_allclose(cm_._predict_raw(pf).numpy(), want,
                                   rtol=0, atol=1e-5)
        back = _round_trip(pm, tmp_path)
        assert torch.equal(back._predict_raw(pf), pm._predict_raw(pf))
        assert back.coef(2) == pm.coef(2)


def test_model_selection_binomial_maxr_equals_jax(ms_data, tmp_path):
    """Binomial ``maxr`` (one GLM per candidate): the same subsets, R²
    (1 - deviance ratio) within 1e-5, and an exact round trip."""
    df, jf, pf = ms_data
    x = ["f0", "f1", "f2", "g"]
    kw = dict(mode="maxr", max_predictor_number=2)
    jm = JModelSelection(**kw).train(y="yb", x=x, training_frame=jf)
    pm = _fit(E.H2OModelSelectionEstimator, pf, "yb", x, **kw)
    assert (pm.get_best_model_predictors()
            == [list(s) for s in jm.output["best_predictor_subsets"]])
    np.testing.assert_allclose(pm.get_best_r2_values(),
                               jm.output["best_r2_values"], rtol=0,
                               atol=1e-5)
    back = _round_trip(pm, tmp_path)
    assert torch.equal(back._predict_raw(pf), pm._predict_raw(pf))


# --------------------------------------------------------------------------
# CoxPH


def _cox_df(rng, n, groups40: bool = False):
    X = rng.normal(size=(n, 4))
    t = rng.exponential(np.exp(-(0.5 * X[:, 0] - 0.3 * X[:, 1])))
    c = rng.exponential(3.0, n)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    df["time"] = np.ceil(np.minimum(t, c) * 20) / 20  # ties on a grid
    df["event"] = (t <= c).astype(float)
    if groups40:  # one tie group of 40 events
        df.loc[:39, "time"] = 0.333  # off the 0.05 grid
        df.loc[:39, "event"] = 1.0
    return df


def numpy_cox(df, ties: str, maxd: int | None = 32,
              iterations: int = 20, tol: float = 1e-8):
    """JAX's Newton on JAX's formula in float64 numpy, with the per-row
    outer products and the Efron loop capped at ``maxd`` events (None: no
    cap)."""
    times = df["time"].to_numpy(np.float64)
    event = df["event"].to_numpy(np.float64)
    X = df[[f"f{i}" for i in range(4)]].to_numpy(np.float64)
    Xc = X - X.mean(0)
    order = np.argsort(-times, kind="mergesort")
    times, event, Xc = times[order], event[order], Xc[order]
    n, d = Xc.shape
    _, start = np.unique(-times, return_index=True)
    gid = np.zeros(n, np.int64)
    gid[start] = 1
    gid = np.cumsum(gid) - 1
    G = gid.max() + 1
    glast = np.zeros(G, np.int64)
    np.maximum.at(glast, gid, np.arange(n))
    def seg(v):
        z = np.zeros((G,) + v.shape[1:])
        np.add.at(z, gid, v)
        return z

    beta = np.zeros(d)
    ll_prev = -np.inf
    for _ in range(iterations):
        eta = Xc @ beta
        r = np.exp(eta)
        S0 = np.cumsum(r)[glast]
        S1 = np.cumsum(Xc * r[:, None], 0)[glast]
        S2 = np.cumsum(r[:, None, None] * Xc[:, :, None] * Xc[:, None, :],
                       0)[glast]
        dg, e0 = seg(event), seg(r * event)
        e1 = seg(Xc * (r * event)[:, None])
        e2 = seg((r * event)[:, None, None] * Xc[:, :, None] * Xc[:, None, :])
        ll = seg(eta * event).sum()
        grad = seg(Xc * event[:, None]).sum(0)
        H = np.zeros((d, d))
        top = int(dg.max()) if maxd is None else maxd
        for l_ in range(top):
            act = l_ < dg
            frac = np.where(dg > 0, l_ / np.maximum(dg, 1), 0) \
                if ties == "efron" else 0 * dg
            p0 = S0 - frac * e0
            p1 = S1 - frac[:, None] * e1
            p2 = S2 - frac[:, None, None] * e2
            ll -= np.log(p0[act]).sum()
            grad -= (p1[act] / p0[act, None]).sum(0)
            H -= (p2[act] / p0[act, None, None]
                  - p1[act, :, None] * p1[act, None, :]
                  / p0[act, None, None] ** 2).sum(0)
        beta = beta + np.linalg.solve(H - 1e-9 * np.eye(d), -grad)
        if abs(ll - ll_prev) < tol * (abs(ll) + 1e-9):
            break
        ll_prev = ll
    return beta, ll


@pytest.fixture(scope="module")
def cox_data():
    df = _cox_df(np.random.default_rng(8), 1200)
    return df, *_frames(df)


@pytest.mark.parametrize("ties", ["efron", "breslow"])
def test_coxph_equals_jax_and_float64(cox_data, ties, tmp_path):
    """Efron and Breslow: coefficients within 1e-4 of JAX's float32 Newton
    and within 1e-8 of the float64 reference, the log-likelihood within
    1e-8 relative of it, the concordance equal to JAX's; the carried-across
    model and a round trip predict the same."""
    df, jf, pf = cox_data
    kw = dict(stop_column="time", ties=ties)
    jm = JCoxPH(**kw).train(y="event", training_frame=jf)
    pm = _fit(E.H2OCoxProportionalHazardsEstimator, pf, "event", **kw)
    np.testing.assert_allclose(pm.output["coefficients"],
                               jm.output["coefficients"], rtol=0, atol=1e-4)
    beta64, ll64 = numpy_cox(df, ties)
    np.testing.assert_allclose(pm.output["coefficients"], beta64, rtol=0,
                               atol=1e-8)
    assert pm.output["loglik"] == pytest.approx(ll64, rel=1e-8)
    assert pm.concordance() == jm.training_metrics.value("concordance")
    want = np.asarray(jm._predict_raw(jf))[: len(df)]
    got = pm._predict_raw(pf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    out = {k: jm.output[k] for k in ("coefficients", "x_means", "names",
                                     "coef_names", "loglik", "n",
                                     "n_events")}
    carried = cm.coxph_from_numpy(out)
    np.testing.assert_allclose(carried._predict_raw(pf).numpy(), want,
                               rtol=0, atol=1e-9)
    back = _round_trip(pm, tmp_path)
    assert torch.equal(back._predict_raw(pf), got_t := pm._predict_raw(pf))
    assert got_t.dtype == torch.float64


def test_coxph_truncates_a_40_event_group_at_32(tmp_path):
    """JAX unrolls at most 32 Efron terms a tie group: with one group of
    40 events both packages drop the last 8 (the port equals the capped
    float64 reference and parts from the uncapped one)."""
    df = _cox_df(np.random.default_rng(9), 600, groups40=True)
    jf, pf = _frames(df)
    kw = dict(stop_column="time", ties="efron")
    jm = JCoxPH(**kw).train(y="event", training_frame=jf)
    pm = _fit(E.H2OCoxProportionalHazardsEstimator, pf, "event", **kw)
    assert pm.output["largest_group_events"] == 40
    assert pm.output["efron_terms"] == pcox.MAXD == 32
    capped, _ = numpy_cox(df, "efron", maxd=32)
    full, _ = numpy_cox(df, "efron", maxd=None)
    np.testing.assert_allclose(pm.output["coefficients"], capped, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(jm.output["coefficients"], capped, rtol=0,
                               atol=1e-4)
    assert np.abs(full - capped).max() > 1e-3


def test_coxph_needs_stop_column(cox_data):
    _, _, pf = cox_data
    with pytest.raises(ValueError, match="stop_column"):
        _fit(E.H2OCoxProportionalHazardsEstimator, pf, "event")
