"""Ordinal GLM in the port (``h2o3_tpu_torch.models.glm``'s proportional-
odds likelihood, ``models/bfgs.py``'s device BFGS, the host L-BFGS-B lane)
against the JAX package's, on the CPU at 3,000 rows with ``device="cpu"``:
the same numpy inputs through both.

Tolerances, with their reasons:
- the NLL and its gradient: 1e-5 relative — the same float32 operations,
  summed in another order;
- BFGS against ``jax.scipy.optimize.minimize(method="BFGS")`` on a fixed
  float32 function (Rosenbrock): iterations, evaluations and status equal,
  the optimum within 1e-5 — the same algorithm, the same branches;
- BFGS against ``_ordinal_fused_fit`` on the same design: x within 2e-3 —
  JAX's own bound between its two ordinal lanes
  (``tests/test_glm_dl_fuse.py``); float32 sums in another order move the
  trajectory, and both end where float32 line searches fail;
- whole trainings (the fused and the host lane) against JAX: beta and the
  cuts within 2e-3, the same reason, and the training logloss within 1e-4
  relative (what a 2e-3 move of the optimum changes it by at most);
- predictions of a JAX model carried across: within 1e-6 (the same
  float64 formula on the same coefficients).
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.scipy.optimize as jso  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import glm as jglm  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu_torch.datasets import ORDINAL_BETA, ORDINAL_CUTS, ordinal_like  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator  # noqa: E402
from h2o3_tpu_torch.models import bfgs  # noqa: E402
from h2o3_tpu_torch.models import glm as pglm  # noqa: E402


@pytest.fixture(scope="module")
def data():
    df = ordinal_like(3000, c=8, seed=0)
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


def _design(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    lat = X @ np.array([1.0, -0.5, 0.3, 0.0, 0.2]) + rng.logistic(size=n)
    y = np.digitize(lat, [-1.5, 0.0, 1.5]).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return X, y, w, 4


def test_nll_and_gradient_match_jax():
    X, y, w, K = _design()
    rng = np.random.default_rng(2)
    beta = rng.normal(0, 0.3, 5).astype(np.float32)
    raw = np.array([-1.2, 0.1, 0.3], np.float32)
    val, g = jglm._ordinal_nll_grad(jnp.asarray(X), jnp.asarray(y),
                                    jnp.asarray(w), jnp.asarray(beta),
                                    jnp.asarray(raw), K)
    fg = bfgs.value_and_grad(lambda prm: pglm.ordinal_nll(
        torch.from_numpy(X), torch.from_numpy(y).long(), torch.from_numpy(w),
        prm, K))
    pv, pg = fg(torch.from_numpy(np.concatenate([beta, raw])))
    assert float(pv) == pytest.approx(float(val), rel=1e-5)
    g = np.asarray(g)
    np.testing.assert_allclose(pg.numpy(), g, atol=1e-5 * np.abs(g).max())


@pytest.mark.parametrize("d", [2, 5])
def test_bfgs_follows_jax_branch_for_branch(d):
    """Rosenbrock from (-1.2, 1, ...) in float32: JAX's BFGS ends there by
    a failed zoom; the port's takes the same iterations, evaluations and
    status, and its optimum is within float32 rounding of JAX's."""
    x0 = np.full(d, -1.2, np.float32)
    x0[1::2] = 1.0

    def rosen(x, lib):
        return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    r = jso.minimize(lambda x: rosen(x, jnp), jnp.asarray(x0), method="BFGS",
                     options={"maxiter": 200, "gtol": 1e-6})
    p = bfgs.minimize_bfgs(bfgs.value_and_grad(lambda x: rosen(x, torch)),
                           torch.from_numpy(x0), 200)
    assert (p.iterations, p.evaluations, p.status) == (
        int(r.nit), int(r.nfev), int(r.status))
    np.testing.assert_allclose(p.x, np.asarray(r.x), atol=1e-5)
    assert p.reads == -(-p.steps // bfgs.BLOCK)
    assert p.masked_steps == p.steps - (p.evaluations - 1)


def test_bfgs_float64_converges_like_jax():
    """In float64 (JAX with x64 on) the 6-d Rosenbrock converges on the
    gradient test: the same iterations, evaluations and optimum."""
    x0 = np.full(6, -1.2)
    x0[1::2] = 1.0

    def rosen(x, lib):
        return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    with jax.enable_x64(True):
        r = jso.minimize(lambda x: rosen(x, jnp), jnp.asarray(x0),
                         method="BFGS", options={"maxiter": 200, "gtol": 1e-6})
        want = (int(r.nit), int(r.nfev), int(r.status), np.asarray(r.x))
    p = bfgs.minimize_bfgs(bfgs.value_and_grad(lambda x: rosen(x, torch)),
                           torch.from_numpy(x0), 200)
    assert (p.iterations, p.evaluations, p.status) == want[:3]
    assert p.stop == "gtol"
    np.testing.assert_allclose(p.x, want[3], rtol=1e-10, atol=1e-10)


def test_bfgs_matches_ordinal_fused_fit():
    X, y, w, K = _design()
    P = X.shape[1]
    x0 = np.concatenate([np.zeros(P), [-1.0, 0.0, 0.0]]).astype(np.float32)
    xj, fj, okj = jglm._ordinal_fused_fit(jnp.asarray(X), jnp.asarray(y),
                                          jnp.asarray(w), jnp.asarray(x0),
                                          K, 200)
    res = bfgs.minimize_bfgs(bfgs.value_and_grad(lambda prm: pglm.ordinal_nll(
        torch.from_numpy(X), torch.from_numpy(y).long(), torch.from_numpy(w),
        prm, K)), torch.from_numpy(x0), 200)
    assert res.ok == bool(okj)
    np.testing.assert_allclose(res.x, np.asarray(xj), atol=2e-3)
    assert res.fun == pytest.approx(float(fj), rel=1e-5)
    assert res.reads <= res.iterations


@pytest.mark.parametrize("standardize,fuse", [(True, "auto"), (False, "auto"),
                                              (True, "0")],
                         ids=["std", "raw", "fuse0"])
def test_ordinal_training_matches_jax(data, standardize, fuse, monkeypatch):
    df, jf, pf = data
    monkeypatch.setenv("H2O3_TPU_GLM_FUSE", fuse)
    kw = dict(family="ordinal", standardize=standardize)
    jm = JGLM(**kw).train(y="rating", training_frame=jf)
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(y="rating", training_frame=pf)
    m = est.model
    st = m.output["irls_stats"]
    assert m.output["coef_names"] == jm.output["coef_names"]
    for k in ("beta_std", "beta_orig", "theta", "theta_orig"):
        np.testing.assert_allclose(m.output[k], jm.output[k], atol=2e-3)
    assert m.residual_deviance == pytest.approx(
        jm.output["residual_deviance"], rel=1e-5)
    assert np.isnan(m.null_deviance)
    assert st["fallbacks"] == 0
    if fuse == "0":
        assert "bfgs" not in st and st["host_iterations"] == st["iterations"]
        assert st["host_reads"] >= st["iterations"]
    else:
        assert st["host_iterations"] == 0
        assert st["bfgs"]["reads"] <= st["iterations"]
        assert st["bfgs"]["stop"] in ("gtol", "line_search", "maxiter")
    assert m.training_metrics.logloss == pytest.approx(
        jm.training_metrics.logloss, rel=1e-4)
    if not standardize:  # the frame's true model, within sampling error
        np.testing.assert_allclose(m.output["beta_orig"], ORDINAL_BETA,
                                   atol=0.15)
        np.testing.assert_allclose(m.output["theta"], ORDINAL_CUTS, atol=0.15)


def test_non_finite_bfgs_goes_to_the_host_lane(data, monkeypatch):
    """A BFGS result that is not finite (JAX's ``ok`` False) sends the fit
    to the host L-BFGS-B lane, counted as one fallback: the fit is the
    ``H2O3_TPU_GLM_FUSE=0`` lane's."""
    _, _, pf = data
    real = bfgs.minimize_bfgs

    def broken(*a, **k):
        res = real(*a, **k)
        res.x = res.x * np.nan
        res.ok = False
        return res

    monkeypatch.setattr(bfgs, "minimize_bfgs", broken)
    est = H2OGeneralizedLinearEstimator(family="ordinal")
    est.train(y="rating", training_frame=pf)
    monkeypatch.setattr(bfgs, "minimize_bfgs", real)
    monkeypatch.setenv("H2O3_TPU_GLM_FUSE", "0")
    ref = H2OGeneralizedLinearEstimator(family="ordinal")
    ref.train(y="rating", training_frame=pf)
    st = est.model.output["irls_stats"]
    assert st["fallbacks"] == 1 and st["host_iterations"] > 0
    np.testing.assert_array_equal(est.model.output["beta_std"],
                                  ref.model.output["beta_std"])


def test_glm_ordinal_recovers_proportional_odds():
    """JAX's ``test_glm_ordinal_recovers_proportional_odds`` on the port:
    against an independent Nelder-Mead fit of the same likelihood and the
    generating truth; the predicted class probabilities are proper."""
    from scipy import optimize as spo

    rng = np.random.default_rng(2)
    n = 4000
    x0, x1 = rng.normal(size=(2, n))
    lat = 1.5 * x0 - x1 + rng.logistic(size=n)
    yo = np.digitize(lat, [-1.0, 0.5])
    df = pd.DataFrame({"x0": x0, "x1": x1, "y": yo.astype(str)})
    fr = h2o3_tpu_torch.upload_file(df, col_types={"y": "enum"}, device="cpu")
    est = H2OGeneralizedLinearEstimator(family="ordinal", standardize=False)
    est.train(y="y", training_frame=fr)
    m = est.model
    beta = np.array([m.coef["x0"], m.coef["x1"]])
    theta = np.asarray(m.output["theta"])
    X = np.stack([x0, x1], axis=1)

    def nll(params):
        b, t1, dt = params[:2], params[2], params[3]
        th = np.array([t1, t1 + np.exp(dt)])
        e = X @ b
        cum = 1 / (1 + np.exp(-(th[None, :] - e[:, None])))
        pk = np.diff(np.concatenate([np.zeros((n, 1)), cum, np.ones((n, 1))],
                                    axis=1), axis=1)
        return -np.log(np.clip(pk[np.arange(n), yo], 1e-12, 1)).sum()

    ref = spo.minimize(nll, np.zeros(4), method="Nelder-Mead",
                       options={"maxiter": 4000, "fatol": 1e-10})
    np.testing.assert_allclose(beta, ref.x[:2], atol=0.05)
    np.testing.assert_allclose(
        theta, [ref.x[2], ref.x[2] + np.exp(ref.x[3])], atol=0.05)
    np.testing.assert_allclose(beta, [1.5, -1.0], atol=0.15)
    np.testing.assert_allclose(theta, [-1.0, 0.5], atol=0.15)
    P = m._predict_raw(fr)
    np.testing.assert_allclose(P.sum(1).numpy(), 1.0, atol=1e-6)


def test_glm_ordinal_standardized_coefs_consistent():
    """JAX's ``test_glm_ordinal_standardized_coefs_consistent`` on the
    port: standardize on and off give the same original-scale slopes,
    cuts (``theta_orig`` against the raw fit's ``theta``) and class
    probabilities."""
    rng = np.random.default_rng(3)
    n = 3000
    x0 = rng.normal(2.0, 3.0, n)
    x1 = rng.normal(-1.0, 0.5, n)
    lat = 0.8 * x0 + 1.1 * x1 + rng.logistic(size=n)
    yo = np.digitize(lat, [0.0, 2.5])
    df = pd.DataFrame({"x0": x0, "x1": x1, "y": yo.astype(str)})
    fr = h2o3_tpu_torch.upload_file(df, col_types={"y": "enum"}, device="cpu")
    fits = []
    for std in (True, False):
        est = H2OGeneralizedLinearEstimator(family="ordinal", standardize=std)
        est.train(y="y", training_frame=fr)
        fits.append(est.model)
    ms, mu = fits
    np.testing.assert_allclose([ms.coef["x0"], ms.coef["x1"]],
                               [mu.coef["x0"], mu.coef["x1"]], atol=0.03)
    np.testing.assert_allclose(ms.output["theta_orig"], mu.output["theta"],
                               atol=0.08)
    np.testing.assert_allclose(ms._predict_raw(fr).numpy(),
                               mu._predict_raw(fr).numpy(), atol=0.02)


def test_ordinal_raises_jax_errors(data):
    _, _, pf = data
    for kw, msg in ((dict(offset_column="f7"), "offset_column"),
                    (dict(compute_p_values=True), "compute_p_values"),
                    (dict(lambda_search=True), "lambda_search")):
        with pytest.raises(ValueError, match=msg):
            H2OGeneralizedLinearEstimator(family="ordinal", **kw).train(
                y="rating", training_frame=pf)
    with pytest.warns(UserWarning, match="unpenalized"):
        H2OGeneralizedLinearEstimator(family="ordinal", lambda_=0.1).train(
            y="rating", training_frame=pf)


def test_glm_from_numpy_ordinal_predicts_like_jax(data):
    from test_torch_glm import jax_glm_numpy

    df, jf, pf = data
    jm = JGLM(family="ordinal").train(y="rating", training_frame=jf)
    out = jax_glm_numpy(jm)
    out["theta"] = np.asarray(jm.output["theta"])
    pm = pglm.glm_from_numpy(out, params=dict(response_column="rating"),
                             device="cpu")
    jp, pp = jm.predict(jf), pm.predict(pf)
    for c in ("1", "3", "5"):
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   np.asarray(jp.vec(c).to_numpy())[:len(df)],
                                   rtol=1e-6, atol=1e-6)
