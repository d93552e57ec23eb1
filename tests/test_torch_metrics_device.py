"""The port's device-stats metrics (``metrics._binomial_metrics_device``,
``_regression_metrics_device`` and their packed statistics) against the JAX
package's device-stats functions, both called directly on the CPU (the
port's on CPU tensors, JAX's on CPU ``jax`` arrays), and the port's exact
host binomial metrics against JAX's host function. Inputs are made with
numpy from seeds and carry NaN responses, NaN predictions and zero weights,
which both must leave out.

Tolerances: the float32 sums and the 1024-bucket table within 1e-5
relative (float32 sums added in another order), ``nobs`` exact; the
metrics assembled from them within 1e-5 relative (AUC, PR-AUC, logloss,
thresholds, KS, gains/lift). The host path reduces in float64 as JAX's
does: within 1e-9 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from h2o3_tpu.models import metrics as JM  # noqa: E402
from h2o3_tpu_torch.models import metrics as PM  # noqa: E402


def _binomial_inputs(n=20_000, seed=0, weights=True):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.3).astype(np.float32)
    p = np.clip(rng.random(n) * 0.6 + 0.4 * y, 0, 1).astype(np.float32)
    p[:3] = [0.0, 1.0, 1.0 - 1e-9]  # the clip ends
    w = (rng.random(n) * 2).astype(np.float32) if weights else \
        np.ones(n, np.float32)
    w[rng.random(n) < 0.05] = 0
    p[rng.random(n) < 0.02] = np.nan
    y[rng.random(n) < 0.02] = np.nan
    return y, p, w


def _close(a, b, rel=1e-5):
    """Within ``rel`` relative; equal infinities (a logloss at a clipped
    probability of 1) and NaNs (an empty criterion) match themselves."""
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rel, atol=0)


@pytest.mark.parametrize("weights", [True, False], ids=["weighted", "ones"])
def test_binomial_packed_stats_match_jax(weights):
    """Sums, nobs and the (wpos, wneg) bucket table against JAX's packed
    device statistics; nobs counts exactly the rows with a response, a
    prediction and a positive weight."""
    y, p, w = _binomial_inputs(weights=weights)
    if JM._BINOM_STATS is None:
        JM._BINOM_STATS = JM._binom_device_stats()
    ref = np.asarray(JM._BINOM_STATS(*(jnp.asarray(a) for a in (y, p, w))))
    got = PM._binom_device_stats(*(torch.from_numpy(a) for a in (y, p, w)))
    got = got.numpy()
    assert got.shape == ref.shape == (4 + 2 * 1024,)
    nobs = int(got[3:4].view(np.int32)[0])
    assert nobs == int(ref[3:4].view(np.int32)[0])
    assert nobs == int((~np.isnan(y) & ~np.isnan(p) & (w > 0)).sum())
    _close(got[:3], ref[:3])
    scale = np.abs(ref[4:]).max()
    assert np.abs(got[4:] - ref[4:]).max() <= 1e-5 * scale


@pytest.mark.parametrize("weights", [True, False], ids=["weighted", "ones"])
def test_binomial_metrics_device_match_jax(weights):
    y, p, w = _binomial_inputs(seed=1, weights=weights)
    wj = jnp.asarray(w) if weights else None
    wp = torch.from_numpy(w) if weights else None
    ref = JM._binomial_metrics_device(jnp.asarray(y), jnp.asarray(p), wj,
                                      ("b", "s"))._v
    got = PM._binomial_metrics_device(torch.from_numpy(y),
                                      torch.from_numpy(p), wp, ("b", "s"))._v
    assert set(ref) <= set(got)
    for k in ("auc", "pr_auc", "gini", "logloss", "mse", "rmse", "ks",
              "mean_per_class_error", "default_threshold"):
        _close(got[k], ref[k])
    assert got["nobs"] == ref["nobs"]
    _close(got["confusion_matrix"], ref["confusion_matrix"])
    for name, v in ref["max_criteria"].items():
        _close([got["max_criteria"][name]["threshold"],
                got["max_criteria"][name]["value"]],
               [v["threshold"], v["value"]])
    assert len(got["gains_lift_table"]) == len(ref["gains_lift_table"])
    for a, b in zip(got["gains_lift_table"], ref["gains_lift_table"]):
        assert a.keys() == b.keys()
        _close([a[k] for k in a], [b[k] for k in a])
    assert got["max_f1"] == got["max_criteria"]["max_f1"]["value"]


@pytest.mark.parametrize("dist", ["gaussian", "poisson", "gamma", "laplace"])
def test_regression_metrics_device_match_jax(dist):
    """Regression sums (centred second moment, deviances) against JAX's
    device statistics, with NaN actuals, NaN predictions, zero weights, and
    a negative actual that turns rmsle off."""
    rng = np.random.default_rng(2)
    n = 20_000
    a = rng.gamma(2.0, 1.0, n).astype(np.float32) + 100.0
    p = (a * 0.8 + rng.random(n) + 20.0).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0
    a[rng.random(n) < 0.02] = np.nan
    p[rng.random(n) < 0.02] = np.nan
    for neg in (False, True):
        if neg:
            a[5], w[5] = -3.0, 1.0
        ref = JM._regression_metrics_device(
            *(jnp.asarray(x) for x in (a, p, w)), dist)._v
        got = PM._regression_metrics_device(
            *(torch.from_numpy(x) for x in (a, p, w)), dist)._v
        assert got.keys() == ref.keys()
        assert got["nobs"] == ref["nobs"] == int(
            (~np.isnan(a) & ~np.isnan(p) & (w > 0)).sum())
        assert np.isnan(got["rmsle"]) == np.isnan(ref["rmsle"]) == neg
        for k, v in ref.items():
            if k != "nobs" and not np.isnan(v):
                _close(got[k], v)


def test_device_path_is_for_cuda_tensors_only():
    """CPU tensors and numpy take the exact host path (as JAX keeps it on
    its CPU backend); only a CUDA tensor routes to the device statistics.
    The sign of the host path: gains/lift rows indexed by distinct score
    (the device table has at most 1024 buckets) and JAX's host threshold,
    a score quantile."""
    y, p, w = _binomial_inputs(n=2000, seed=3)
    host = PM.binomial_metrics(torch.from_numpy(y), torch.from_numpy(p),
                               torch.from_numpy(w))
    assert host.gains_lift()[-1]["lower_threshold_index"] >= PM._NBUCKETS
    assert not PM._on_device(torch.from_numpy(p), y, None)
    ref = JM.binomial_metrics(y, p, w)._v
    assert abs(host.auc - ref["auc"]) < 1e-12
    assert host.default_threshold == ref["default_threshold"]
    dev = PM._binomial_metrics_device(*(torch.from_numpy(a)
                                        for a in (y, p, w)), ("0", "1"))
    assert abs(dev.auc - host.auc) < 1e-3  # 1024 buckets as tie groups


@pytest.mark.parametrize("weights", [True, False], ids=["weighted", "ones"])
def test_binomial_host_metrics_match_jax(weights):
    """The exact host path, every key JAX's host ``binomial_metrics``
    returns: AUC, PR-AUC, logloss, the threshold table's max criteria, the
    confusion matrix at the max-F1 threshold, mean per-class error,
    gains/lift over distinct scores and KS, within 1e-9 relative; ties in
    the scores included."""
    y, p, w = _binomial_inputs(n=5000, seed=4, weights=weights)
    p = np.round(p, 2)  # tied scores: gains/lift and KS collapse them
    wt = w if weights else None
    ref = JM.binomial_metrics(y, p, wt, ("b", "s"))._v
    got = PM.binomial_metrics(y, p, wt, ("b", "s"))._v
    assert set(ref) <= set(got)
    for k in ("auc", "pr_auc", "gini", "logloss", "mse", "rmse", "ks",
              "mean_per_class_error", "default_threshold"):
        _close(got[k], ref[k], rel=1e-9)
    assert got["nobs"] == ref["nobs"]
    _close(got["confusion_matrix"], ref["confusion_matrix"], rel=1e-9)
    assert got["max_criteria"].keys() == ref["max_criteria"].keys()
    for name, v in ref["max_criteria"].items():
        _close([got["max_criteria"][name]["threshold"],
                got["max_criteria"][name]["value"]],
               [v["threshold"], v["value"]], rel=1e-9)
    assert len(got["gains_lift_table"]) == len(ref["gains_lift_table"]) > 1
    for a, b in zip(got["gains_lift_table"], ref["gains_lift_table"]):
        assert a.keys() == b.keys()
        _close([a[k] for k in a], [b[k] for k in a], rel=1e-9)
    mm = PM.binomial_metrics(y, p, wt)
    assert mm.gains_lift() == got["gains_lift_table"]
    assert mm.kolmogorov_smirnov() == got["ks"]
    d = mm.to_dict()
    assert d["kind"] == "binomial" and d["auc"] == got["auc"]
