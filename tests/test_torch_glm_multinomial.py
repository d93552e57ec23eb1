"""Multinomial GLM in the port (``h2o3_tpu_torch.models.glm``: the class
pass, the fused cycling lane, the host float64 cycling lane) against the
JAX package's, on the CPU at 2,500 rows with ``device="cpu"``: the same
numpy inputs through both.

Tolerances, with their reasons:
- the class pass (G, b and -2LL): 1e-5 relative to the largest entry —
  float32 products summed in another order (the port's Gram adds 4,096-
  row chunks in float64, JAX's is one float32 product);
- whole trainings: Beta within 1e-4 absolute and iteration counts equal
  (float32 device lanes on both sides of a convergent fit; the optimum
  moves by less than that), training logloss within 1e-5 relative;
- ``H2O3_TPU_GLM_FUSE=2`` against the default: Beta within 1e-6 and the
  same iterations (masked iterations change nothing; only the chunk
  boundaries move, where the state is read and written back unchanged);
- a JAX model carried across (``glm_from_numpy``): predictions within
  1e-6 (the same float32 design and Beta).
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import glm as jglm  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator  # noqa: E402
from h2o3_tpu_torch.models import glm as pglm  # noqa: E402
from test_torch_glm import X_COLS, glm_df, jax_glm_numpy  # noqa: E402


def mn_df(n=2500, seed=0) -> pd.DataFrame:
    """``glm_df``'s columns and a 3-class response ``ymn`` ("u", "v", "w")
    drawn from a softmax of the numerics and ``c2`` (drawn, not argmaxed:
    the classes overlap, so the fit converges)."""
    df = glm_df(n, seed)
    rng = np.random.default_rng(seed + 11)
    X = np.nan_to_num(df[["x0", "x1", "x2", "x3"]].to_numpy(np.float64))
    L = X @ rng.normal(0, 0.8, (4, 3)) + 0.7 * (
        df["c2"].to_numpy()[:, None] == np.array(["p", "q", "r"])[None, :])
    P = np.exp(L)
    P /= P.sum(1, keepdims=True)
    cls = (rng.random(n)[:, None] > P.cumsum(1)).sum(1)
    df["ymn"] = np.array(["u", "v", "w"])[np.minimum(cls, 2)]
    return df


@pytest.fixture(scope="module")
def data():
    df = mn_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


@pytest.mark.parametrize("k", [0, 2])
def test_multinomial_pass_matches_jax(k):
    """One class pass at a random Beta, weights with zeros and the one-hot
    zeroed on weight-0 rows (as the trainings build it)."""
    rng = np.random.default_rng(4)
    n, p, K = 3000, 6, 3
    X = rng.normal(size=(n, p)).astype(np.float32)
    X[:, -1] = 1.0
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    w[rng.random(n) < 0.05] = 0.0
    y = rng.integers(0, K, n)
    Y = ((y[:, None] == np.arange(K)[None, :]) * (w[:, None] > 0)).astype(
        np.float32)
    B = rng.normal(0, 0.5, (p, K)).astype(np.float32)
    G, b, m2ll = jglm._multinomial_pass(
        jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w), jnp.asarray(B), K, k)
    Gp, bp, m2llp = pglm._multinomial_pass(
        *(torch.from_numpy(a) for a in (X, Y, w, B)), k)
    G, b = np.asarray(G), np.asarray(b)
    np.testing.assert_allclose(Gp.numpy(), G, atol=1e-5 * np.abs(G).max())
    np.testing.assert_allclose(bp.numpy(), b, atol=1e-5 * np.abs(b).max())
    assert float(m2llp) == pytest.approx(float(m2ll), rel=1e-5)


def _jax_iterations(monkeypatch) -> list:
    """JAX's multinomial lane reports its iteration count only through its
    interval snapshots: record each snapshot's ``it``."""
    seen = []

    def record(self, job, make_model):
        seen.append(int(make_model("probe").output["irls_state"]["it"]))

    monkeypatch.setattr(JGLM, "_export_interval_checkpoint", record)
    return seen


CASES = {
    "cholesky": (dict(), {}),
    "admm": (dict(lambda_=1e-4), {}),
    "ridge": (dict(lambda_=1e-3, alpha=0.0), {}),
    "weights": (dict(lambda_=1e-4, weights_column="w"), {}),
    "skip": (dict(missing_values_handling="skip"), {}),
    "non_negative": (dict(non_negative=True), {}),
    "fuse0": (dict(), {"H2O3_TPU_GLM_FUSE": "0"}),
    "fuse0_admm": (dict(lambda_=1e-4), {"H2O3_TPU_GLM_FUSE": "0"}),
}


def _train_both(data, kw, env, monkeypatch):
    df, jf, pf = data
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    its = _jax_iterations(monkeypatch)
    jm = JGLM(family="multinomial", **kw).train(x=X_COLS, y="ymn",
                                                training_frame=jf)
    est = H2OGeneralizedLinearEstimator(family="multinomial", **kw)
    est.train(x=X_COLS, y="ymn", training_frame=pf)
    return jm, est.model, its[-1]


@pytest.mark.parametrize("case", list(CASES))
def test_multinomial_training_matches_jax(data, case, monkeypatch):
    kw, env = CASES[case]
    jm, pm, jit = _train_both(data, kw, env, monkeypatch)
    st = pm.output["irls_stats"]
    assert pm.output["coef_names"] == jm.output["coef_names"]
    np.testing.assert_allclose(pm.output["beta_multinomial_std"],
                               jm.output["beta_multinomial_std"], atol=1e-4)
    assert st["iterations"] == jit
    assert st["fallbacks"] == 0
    assert pm.residual_deviance == pytest.approx(
        jm.output["residual_deviance"], rel=1e-5)
    assert pm.training_metrics.logloss == pytest.approx(
        jm.training_metrics.logloss, rel=1e-5)
    np.testing.assert_array_equal(pm.output["beta_std"],
                                  pm.output["beta_multinomial_std"][:, -1])
    if case.startswith("fuse0"):
        assert st["chunks"] == 0 and st["host_iterations"] == jit
    else:
        assert st["host_iterations"] == 0 and st["chunks"] >= 1


def test_fuse2_equals_default(data, monkeypatch):
    """Two iterations a chunk against the default eight: the same fit."""
    _, _, pf = data
    fits = []
    for mode in ("auto", "2"):
        monkeypatch.setenv("H2O3_TPU_GLM_FUSE", mode)
        est = H2OGeneralizedLinearEstimator(family="multinomial", lambda_=1e-4)
        est.train(x=X_COLS, y="ymn", training_frame=pf)
        fits.append(est.model)
    a, b = fits
    np.testing.assert_allclose(b.output["beta_multinomial_std"],
                               a.output["beta_multinomial_std"], atol=1e-6)
    assert b.output["irls_stats"]["iterations"] == \
        a.output["irls_stats"]["iterations"]
    assert b.output["irls_stats"]["chunks"] > a.output["irls_stats"]["chunks"]


def test_singular_class_solve_goes_to_the_host_lane(data, monkeypatch):
    """Two equal ±1 columns, unstandardized, with a ridge of 1e-9 (l2 =
    2.5e-6, lost beside the Gram's entries in float32): every rung of the
    float32 ladder fails at the exact zero pivot in both packages, so both
    discard the first iteration and cycle on the host in float64 (one
    fallback each), where the ridge splits each class's coefficient evenly
    between the equal columns: the same coefficients and iterations."""
    from h2o3_tpu.utils import metrics as jmx

    df, _, _ = data
    rng = np.random.default_rng(9)
    d2 = df[["x2", "ymn"]].copy()
    d2["s0"] = np.where(rng.random(len(d2)) < 0.5, -1.0, 1.0).astype(
        np.float32)
    d2["s1"] = d2["s0"]
    kw = dict(family="multinomial", standardize=False, lambda_=1e-9,
              alpha=0.0)
    its = _jax_iterations(monkeypatch)
    f0 = jmx.counter_value("glm_fuse_fallbacks_total", reason="singular")
    jm = JGLM(**kw).train(x=["s0", "s1", "x2"], y="ymn",
                          training_frame=JFrame.from_pandas(d2))
    assert jmx.counter_value("glm_fuse_fallbacks_total",
                             reason="singular") == f0 + 1
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(x=["s0", "s1", "x2"], y="ymn",
              training_frame=h2o3_tpu_torch.upload_file(d2, device="cpu"))
    st = est.model.output["irls_stats"]
    assert st["fallbacks"] == 1 and st["host_iterations"] == st["iterations"]
    assert st["iterations"] == its[-1]
    np.testing.assert_allclose(est.model.output["beta_multinomial_std"],
                               jm.output["beta_multinomial_std"], atol=1e-4)


def test_auto_family_on_three_levels(data):
    """``family="AUTO"`` on a 3-level response trains a multinomial model:
    predict gives the label and one probability column per class, rows
    summing to 1, and the metrics are multinomial."""
    _, _, pf = data
    est = H2OGeneralizedLinearEstimator()
    est.train(x=X_COLS, y="ymn", training_frame=pf)
    m = est.model
    assert m.output["family"] == "multinomial" and m.output["multinomial"]
    pred = est.predict(pf)
    assert pred.names == ["predict", "u", "v", "w"]
    P = torch.stack([pred.vec(c).data for c in "uvw"], 1)
    np.testing.assert_allclose(P.sum(1).numpy(), 1.0, atol=1e-6)
    assert m.training_metrics.kind == "multinomial"
    assert np.isfinite(m.training_metrics.logloss)


def test_glm_from_numpy_multinomial_predicts_like_jax(data):
    df, jf, pf = data
    jm = JGLM(family="multinomial", lambda_=1e-4).train(
        x=X_COLS, y="ymn", training_frame=jf)
    out = jax_glm_numpy(jm)
    out["beta_multinomial_std"] = np.asarray(jm.output["beta_multinomial_std"])
    pm = pglm.glm_from_numpy(out, params=dict(response_column="ymn"),
                             device="cpu")
    jp = jm.predict(jf)
    pp = pm.predict(pf)
    for c in "uvw":
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   np.asarray(jp.vec(c).to_numpy())[:len(df)],
                                   rtol=1e-6, atol=1e-6)


def _counting_admm(steps: list):
    """JAX's ``admm_elastic_net_device`` that also reports its step count:
    the original solve gives the result, and a copy of its loop with a
    counter sends (steps, whether its z equals the original's bit for
    bit) to the host through ``jax.debug.callback``."""
    import jax

    from h2o3_tpu.ops import gram as jgram

    orig = jgram.admm_elastic_net_device

    def counted(G, b, l1, l2, icpt, pad_diag, real_p, rho=None, iters=500,
                tol=1e-6, non_negative=False):
        z, ok = orig(G, b, l1, l2, icpt, pad_diag, real_p, iters=iters,
                     tol=tol, non_negative=non_negative)
        p = G.shape[0]
        ar = jnp.arange(p)
        rho = jnp.maximum(1e-3, jnp.sum(jnp.diagonal(G) * (1.0 - pad_diag))
                          / jnp.maximum(real_p, 1.0))
        A = G + jnp.diag(pad_diag) + (l2 + rho) * jnp.eye(p, dtype=G.dtype)
        c = jax.scipy.linalg.cho_factor(A, lower=True)
        thr = jnp.where(ar == icpt, 0.0, l1 / rho)

        def body(cr):
            _, zz, u, i, _ = cr
            x = jax.scipy.linalg.cho_solve(c, b + rho * (zz - u))
            v = x + u
            zn = jnp.sign(v) * jnp.maximum(jnp.abs(v) - thr, 0.0)
            if non_negative:
                zn = jnp.where((ar != icpt) & (zn < 0), 0.0, zn)
            done = ((jnp.max(jnp.abs(zn - zz)) < tol)
                    & (jnp.max(jnp.abs(x - zn)) < tol))
            return x, zn, u + x - zn, i + 1, done

        z0 = jnp.zeros_like(b)
        _, zc, _, i, _ = jax.lax.while_loop(
            lambda cr: (cr[3] < iters) & ~cr[4], body,
            (z0, z0, z0, jnp.int32(0), jnp.asarray(False)))
        jax.debug.callback(lambda i, same: steps.append((int(i), bool(same))),
                           i, jnp.all(zc == z))
        return z, ok

    return counted


def test_admm_fold_weights_stop_is_decided_by_one_ulp(monkeypatch):
    """The multinomial ADMM case that parted from JAX: ``lambda_`` 1e-3,
    ``alpha`` 0.5, on ``tests/test_torch_cv.py``'s frame weighted by the
    second ``random`` fold's training mask (seed 12345). Both packages run
    one iteration a chunk, so each iteration's Beta and -2LL are read.

    Where the trajectories part, and why it is the reference's fault:
    - every iteration both ran agrees: Beta under ``_close`` (1e-5 of the
      largest coefficient), the -2LL within 1e-6 relative;
    - the ADMM step counts agree in the first iteration and part from
      iteration 2 by a few steps: the float32 stop (``max|dz| < 1e-6``,
      ~8 ulps near 1) falls at another step when the Cholesky rounds
      differently, which it does given the same Gram (checked below);
    - JAX stops where its relative -2LL change passes under
      ``objective_epsilon``; the port takes one more iteration, and its
      change at JAX's last iteration is within 2 float32 ulps of the -2LL
      from the threshold. The cycle still moves there (Beta ~1e-2 an
      iteration), so one ulp decides a 1.4e-2 gap;
    - JAX's own coefficients move as far under a one-ulp change of its
      input (the weights one ulp under 1) and on its own float64 host lane
      (``H2O3_TPU_GLM_FUSE=0``): both end where the port ends, under
      ``_close``, at the port's iteration count.
    What both packages agree on at the setting itself: the deviance within
    1e-5 relative and the count of non-zero coefficients of each class.
    """
    import jax.numpy  # noqa: F401  (the counting solver traces with it)

    from test_torch_cv import X_COLS as CV_COLS
    from test_torch_cv import _close, cv_df

    from h2o3_tpu_torch.models.glm import GLM as PGLM

    df = cv_df()
    fold = np.random.default_rng(12345).integers(0, 3, size=len(df))
    df["fw"] = (fold != 1).astype(np.float32)
    kw = dict(family="multinomial", lambda_=1e-3, alpha=0.5,
              weights_column="fw")
    monkeypatch.setenv("H2O3_TPU_GLM_FUSE", "1")

    steps: list = []
    monkeypatch.setattr(jglm, "admm_elastic_net_device",
                        _counting_admm(steps))
    monkeypatch.setattr(jglm, "_GLM_PROGRAMS", {})
    jtraj: list = []
    monkeypatch.setattr(
        JGLM, "_export_interval_checkpoint",
        lambda self, job, mk: jtraj.append(mk("p").output["irls_state"]))

    def train_jax(d):
        jtraj.clear()
        m = JGLM(**kw).train(x=CV_COLS, y="ymn",
                             training_frame=JFrame.from_pandas(d))
        return m, [dict(s) for s in jtraj]

    jm, jt = train_jax(df)
    jsteps = [s for s, _ in steps]
    assert steps and all(same for _, same in steps)

    ptraj: list = []
    orig_chunk = PGLM._multinomial_chunk

    def spy(*a, **k):
        r = orig_chunk(*a, **k)
        ptraj.append(r[2].copy())
        return r

    monkeypatch.setattr(PGLM, "_multinomial_chunk", staticmethod(spy))
    pm = PGLM(**kw).train(x=CV_COLS, y="ymn",
                          training_frame=h2o3_tpu_torch.upload_file(
                              df, device="cpu"))
    st = pm.output["irls_stats"]
    P, K = len(pm.output["coef_names"]), 3

    # the fault reproduced: the port runs one more iteration and ends
    # outside _close of JAX
    n_j, n_p = len(jt), st["iterations"]
    assert n_p == n_j + 1
    gap = np.abs(pm.output["beta_multinomial_std"]
                 - np.asarray(jm.output["beta_multinomial_std"])).max()
    assert gap > 1e-3
    # every common iteration agrees
    for j, q in zip(jt, ptraj[:n_j]):
        _close(q[4:].reshape(P, K), j["Beta"])
    for j, q in zip(jt[:-1], ptraj[: n_j - 1]):
        assert q[3] == pytest.approx(j["ll_prev"], rel=1e-6)
    # the step counts: equal in iteration 1, then a few steps apart
    ps = st["admm_steps"]
    assert jsteps[:K] == ps[:K]
    assert max(abs(a - b) for a, b in zip(jsteps, ps)) <= 5
    # the port's stop test at JAX's last iteration: its relative change
    # lies within 2 ulps of the -2LL above objective_epsilon
    ll_before, ll_at = ptraj[n_j - 2][3], ptraj[n_j - 1][3]
    eps = pm.params.objective_epsilon
    ulp = float(np.spacing(np.float32(ll_at)))
    assert 0 < abs(ll_before - ll_at) - eps * abs(ll_at) <= 2 * ulp
    # JAX's own sensitivity: a one-ulp input change, and its float64 lane
    d_ulp = df.copy()
    d_ulp["fw"] = np.where(df["fw"] > 0, np.nextafter(np.float32(1),
                                                       np.float32(0)),
                           np.float32(0)).astype(np.float32)
    for d, env in ((d_ulp, "1"), (df, "0")):
        monkeypatch.setenv("H2O3_TPU_GLM_FUSE", env)
        jm2, jt2 = train_jax(d)
        b2 = np.asarray(jm2.output["beta_multinomial_std"])
        assert np.abs(b2 - np.asarray(
            jm.output["beta_multinomial_std"])).max() > 0.5 * gap
        assert len(jt2) == n_p
        _close(pm.output["beta_multinomial_std"], b2)
    # what both packages agree on at the setting itself
    assert pm.residual_deviance == pytest.approx(
        jm.output["residual_deviance"], rel=1e-5)
    np.testing.assert_array_equal(
        (pm.output["beta_multinomial_std"] != 0).sum(0),
        (np.asarray(jm.output["beta_multinomial_std"]) != 0).sum(0))
