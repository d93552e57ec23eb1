"""GLM in the port (``h2o3_tpu_torch.models.glm`` and the modules it runs:
``glm_families``, ``datainfo``, ``ops/gram``) against the JAX package's, on
the CPU at small sizes (2-3k rows), with ``device="cpu"``: the same numpy
inputs through both.

Tolerances, with their reasons:
- families (link, inverse, derivative, variance, deviance): 1e-6
  relative — the same float32 operations; ``exp``/``log``/``pow`` of the
  two libraries may differ in the last bit, and the deviance sums add in
  another order;
- ``DataInfo.transform``: exact — the same float32 subtraction and
  division by the same float32-rounded mean and sigma, and 0/1 indicators;
- the Gram: 1e-5 relative to its largest entry (float32 products summed
  in another order);
- the solves: the same ``ok`` flags, and solutions within 1e-5 — float32
  factorizations of a well-conditioned Gram (the ADMM's stopping rule is
  1e-6 per step);
- whole trainings: coefficients within 1e-4 absolute, IRLS iteration
  counts equal, training metrics within 1e-5 relative (float32 device
  lanes on both sides; the optimum moves by less than that);
- a JAX model carried across (``glm_from_numpy``): predictions within
  1e-6 (the same float32 design and beta).
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

import jax.numpy as jnp  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import datainfo as jdi  # noqa: E402
from h2o3_tpu.models import glm_families as jfam  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu.ops import gram as jgram  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator  # noqa: E402
from h2o3_tpu_torch.models import datainfo as pdi  # noqa: E402
from h2o3_tpu_torch.models import glm_families as pfam  # noqa: E402
from h2o3_tpu_torch.models.glm import glm_from_numpy  # noqa: E402
from h2o3_tpu_torch.ops import gram as pgram  # noqa: E402

X_COLS = ["x0", "x1", "x2", "x3", "c1", "c2"]


def glm_df(n=2500, seed=0) -> pd.DataFrame:
    """Four numeric columns (NAs in x1), two categoricals (NAs in c1), and
    a response of each kind: ybin (yes/no), ygauss, ycount (Poisson),
    ypos (positive, gamma), yclaim (zero-inflated, tweedie); a weight and
    an offset column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    df = pd.DataFrame(X, columns=["x0", "x1", "x2", "x3"])
    df.loc[rng.random(n) < 0.08, "x1"] = np.nan
    c1 = rng.integers(0, 4, n)
    df["c1"] = np.where(rng.random(n) < 0.05, None,
                        np.array(["a", "b", "c", "d"])[c1])
    c2 = rng.integers(0, 3, n)
    df["c2"] = np.array(["p", "q", "r"])[c2]
    lin = 0.8 * X[:, 0] - 0.5 * X[:, 2] + 0.3 * (c1 - 1.5) + 0.4 * (c2 == 1)
    df["ybin"] = np.where(rng.random(n) < 1 / (1 + np.exp(-lin)), "yes", "no")
    df["ygauss"] = (2.0 + lin + 0.5 * rng.normal(size=n)).astype(np.float32)
    mu = np.exp(0.3 + 0.4 * lin)
    df["ycount"] = rng.poisson(mu).astype(np.float32)
    # gamma's default (inverse) link: 1/mu linear and positive
    mu_inv = 1.0 / (0.7 + 0.15 * np.clip(lin, -3.0, 3.0))
    df["ypos"] = rng.gamma(2.0, mu_inv / 2.0).astype(np.float32)
    df["yclaim"] = np.where(rng.random(n) < 0.6, 0.0,
                            rng.gamma(2.0, mu)).astype(np.float32)
    df["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    df["off"] = (0.1 * rng.normal(size=n)).astype(np.float32)
    return df


@pytest.fixture(scope="module")
def frames():
    df = glm_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


# -- families ----------------------------------------------------------------

FAMILIES = [
    ("gaussian", {}), ("binomial", {}), ("quasibinomial", {}),
    ("fractionalbinomial", {}), ("poisson", {}), ("gamma", {}),
    ("tweedie", dict(tweedie_variance_power=1.5, tweedie_link_power=0.0)),
    ("tweedie", dict(tweedie_variance_power=1.3, tweedie_link_power=0.5)),
    ("negativebinomial", dict(theta=0.5)),
    ("gaussian", dict(link="log")),
]


def _close(a, b, rtol=1e-6):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(1e-30, np.abs(b).max()))


@pytest.mark.parametrize("name,kw", FAMILIES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(FAMILIES)])
def test_family_functions_match_jax(name, kw):
    """Link inverse, derivative and forward, variance, deviance and the
    initial mu, elementwise on the same float32 inputs."""
    rng = np.random.default_rng(1)
    eta = rng.normal(0.2, 1.0, 500).astype(np.float32)
    binom = "binomial" in name
    y = (rng.random(500) < 0.4).astype(np.float32) if binom else \
        rng.gamma(2.0, 1.0, 500).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 500).astype(np.float32)
    jf = jfam.get_family(name, **kw)
    pf = pfam.get_family(name, **kw)
    if jf.link.name == "inverse" or jf.link.name.startswith("tweedie"):
        eta = np.abs(eta) + 0.2  # the links' positive domain
    te, ty, tw = (torch.from_numpy(a) for a in (eta, y, w))
    mu = np.asarray(jf.link.inv(jnp.asarray(eta)))
    _close(pf.link.inv(te).numpy(), mu)
    _close(pf.link.dinv(te).numpy(), np.asarray(jf.link.dinv(jnp.asarray(eta))))
    _close(pf.link.fwd(torch.from_numpy(mu)).numpy(),
           np.asarray(jf.link.fwd(jnp.asarray(mu))))
    _close(pf.variance(torch.from_numpy(mu)).numpy(),
           np.asarray(jf.variance(jnp.asarray(mu))))
    _close(float(pf.deviance(ty, torch.from_numpy(mu), tw)),
           float(jf.deviance(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(w))))
    _close(pf.init_mu(ty, tw).numpy(),
           np.asarray(jf.init_mu(jnp.asarray(y), jnp.asarray(w))))
    assert pf.dispersion_fixed == jf.dispersion_fixed


# -- DataInfo ----------------------------------------------------------------


@pytest.mark.parametrize("handling", ["mean_imputation", "skip"])
def test_datainfo_transform_exact(frames, handling):
    """Fit on the training frame, transform a scoring frame with NAs, an
    unseen level of c1 ('e') and a level of c2 missing: specs and names
    equal, the rollup mean and sigma within 1e-6 (float32 sums in another
    order, as the frame tests hold them); with JAX's mean and sigma the
    matrices and validity masks are equal."""
    df, jf, pf = frames
    kw = dict(standardize=True, use_all_factor_levels=False,
              missing_handling=handling, add_intercept=True)
    jd = jdi.DataInfo.fit(jf, X_COLS, **kw)
    pd_ = pdi.DataInfo.fit(pf, X_COLS, **kw)
    assert pd_.coef_names() == jd.coef_names()
    assert pd_.ncols_expanded == jd.ncols_expanded
    for a, b in zip(pd_.columns, jd.columns):
        assert (a.name, a.kind, a.offset, a.width, a.domain) == \
            (b.name, b.kind, b.offset, b.width, b.domain)
        assert abs(a.mean - b.mean) <= 1e-6 * max(1.0, abs(b.mean))
        assert abs(a.sigma - b.sigma) <= 1e-6 * max(1.0, abs(b.sigma))
        a.mean, a.sigma = b.mean, b.sigma
    sdf = glm_df(n=300, seed=5)
    sdf.loc[:20, "c1"] = "e"
    sdf["c2"] = sdf["c2"].replace("q", "p")
    for j_frame, p_frame in ((jf, pf),
                             (JFrame.from_pandas(sdf),
                              h2o3_tpu_torch.upload_file(sdf, device="cpu"))):
        JX, jv = jd.transform(j_frame)
        PX, pv = pd_.transform(p_frame)
        n = p_frame.nrow
        np.testing.assert_array_equal(PX.numpy(), np.asarray(JX)[:n])
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv)[:n])


def test_datainfo_unported_options_raise(frames):
    """``hash_buckets`` and ``interaction_pairs`` raised before slice 9;
    both fit now, with JAX's widths and coefficient names (their
    transforms are held exactly in test_torch_datainfo_interactions.py)."""
    _, jf, pf = frames
    for kw in (dict(hash_buckets=2), dict(interaction_pairs=[("x0", "x2")])):
        jd = jdi.DataInfo.fit(jf, X_COLS, **kw)
        pd_ = pdi.DataInfo.fit(pf, X_COLS, **kw)
        assert pd_.coef_names() == jd.coef_names()
        assert pd_.ncols_expanded == jd.ncols_expanded


# -- the Gram and the solves -------------------------------------------------


def _gram_inputs(singular: bool, n: int = 400):
    """400 rows x 7 columns (the last the intercept). The singular case
    has two equal ±1 columns and weights of 1/4: their Gram entries are 100
    exactly, so the second pivot is 100 - 10·10 = 0 in every Cholesky and
    every rung fails (the jitters vanish beside 100 in float32) — a
    singular Gram whose outcome does not hang on rounding."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(n, 7)).astype(np.float32)
    X[:, -1] = 1.0
    w = rng.uniform(0.1, 0.3, n).astype(np.float32)
    if singular:
        X[:, 0] = np.where(rng.random(400) < 0.5, -1.0, 1.0)
        X[:, 1] = X[:, 0]
        w[:] = 0.25
    z = rng.normal(size=n).astype(np.float32)
    return X, w, z


@pytest.mark.parametrize("n", [400, 140_003], ids=["one-chunk", "chunks"])
def test_weighted_gram_matches_jax(n):
    """Below and above the port's chunk of 4,096 rows (whole chunks by one
    batched product and a remainder, added in float64)."""
    X, w, z = _gram_inputs(False, n)
    G, b, sw = jgram.weighted_gram(jnp.asarray(X), jnp.asarray(w), jnp.asarray(z))
    Gp, bp, swp = pgram.weighted_gram(*(torch.from_numpy(a) for a in (X, w, z)))
    G = np.asarray(G)
    np.testing.assert_allclose(Gp.numpy(), G, atol=1e-5 * np.abs(G).max())
    np.testing.assert_allclose(bp.numpy(), np.asarray(b),
                               atol=1e-5 * np.abs(np.asarray(b)).max())
    assert abs(float(swp) - float(sw)) <= 1e-5 * float(sw)


@pytest.mark.parametrize("singular", [False, True], ids=["spd", "singular"])
def test_solves_match_jax(singular):
    """The four solves on a well-conditioned and on a singular Gram: device
    Cholesky with the jitter ladder (no ridge), device ADMM, host float64
    Cholesky and ADMM — the same ok flags, solutions within 1e-5."""
    X, w, z = _gram_inputs(singular)
    G, b, _ = jgram.weighted_gram(jnp.asarray(X), jnp.asarray(w), jnp.asarray(z))
    Gn, bn = np.asarray(G), np.asarray(b)
    p = Gn.shape[0]
    Gt, bt = torch.from_numpy(Gn.copy()), torch.from_numpy(bn.copy())

    xj, okj = jgram.cho_solve_jitter_device(G, b)
    xp, okp = pgram.cho_solve_jitter_device(Gt, bt)
    assert bool(okp) == bool(okj)
    if bool(okj):
        np.testing.assert_allclose(xp.numpy(), np.asarray(xj), atol=1e-5 * max(
            1.0, np.abs(np.asarray(xj)).max()))

    l1, l2 = 2.0, 1.0
    pad = np.zeros(p, np.float32)
    zj, okj = jgram.admm_elastic_net_device(
        G, b, jnp.float32(l1), jnp.float32(l2), jnp.int32(p - 1),
        jnp.asarray(pad), jnp.float32(p))
    solver = pgram.AdmmSolver(p, "cpu")
    zp, okp = solver.solve(Gt, bt, torch.tensor(l1), torch.tensor(l2), p - 1,
                           torch.from_numpy(pad), p)
    assert bool(okp) == bool(okj)
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), atol=1e-5)
    assert solver.reads == -(-int(solver.i) // solver.block)  # one per block

    np.testing.assert_allclose(
        pgram.solve_cholesky(Gn, bn, ridge=1e-3),
        jgram.solve_cholesky(Gn, bn, ridge=1e-3), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(
        pgram.admm_elastic_net(Gn, bn, l1, l2, p - 1),
        jgram.admm_elastic_net(Gn, bn, l1, l2, p - 1), rtol=1e-10, atol=1e-10)


def test_singular_gram_goes_to_the_host_lane(frames):
    """Two equal ±1 columns, unstandardized, with a ridge of 1e-9 (l2 =
    2.5e-6, lost beside the Gram's 2500 in float32): every rung of the
    float32 ladder fails at the exact zero pivot in both packages, so both
    send the lambda to the host float64 lane (one fallback each), where the
    ridge splits the coefficient evenly between the equal columns: the
    same model, iteration counts and metrics."""
    from h2o3_tpu.utils import metrics as jmx

    df, _, _ = frames
    rng = np.random.default_rng(9)
    d2 = df[["x2", "ygauss"]].copy()
    d2["s0"] = np.where(rng.random(len(d2)) < 0.5, -1.0, 1.0).astype(np.float32)
    d2["s1"] = d2["s0"]
    d2["ygauss"] += 0.7 * d2["s0"]
    kw = dict(family="gaussian", lambda_=1e-9, alpha=0.0, standardize=False)
    f0 = jmx.counter_value("glm_fuse_fallbacks_total", reason="singular")
    jm = JGLM(**kw).train(x=["s0", "s1", "x2"], y="ygauss",
                          training_frame=JFrame.from_pandas(d2))
    assert jmx.counter_value("glm_fuse_fallbacks_total",
                             reason="singular") == f0 + 1
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(x=["s0", "s1", "x2"], y="ygauss",
              training_frame=h2o3_tpu_torch.upload_file(d2, device="cpu"))
    pm = est.model
    assert pm.output["irls_stats"]["fallbacks"] == 1
    jc, pc = jm.coef, pm.coef
    for k in ("s0", "s1", "x2", "Intercept"):
        assert pc[k] == pytest.approx(jc[k], abs=1e-4)
    assert [e["iters"] for e in pm.regularization_path] == \
        [e["iters"] for e in jm.output["regularization_path"]]
    for k in ("rmse", "r2", "mean_residual_deviance"):
        assert pm.training_metrics._v[k] == pytest.approx(
            jm.training_metrics._v[k], rel=1e-5)


# -- whole trainings ---------------------------------------------------------

TRAININGS = {
    "binomial_l1": (dict(family="binomial", lambda_=1e-3), "ybin", {}),
    "binomial_ridge": (dict(family="binomial", lambda_=1e-3, alpha=0.0),
                       "ybin", {}),
    "binomial_default_lambda": (dict(family="binomial"), "ybin", {}),
    "gaussian": (dict(family="gaussian"), "ygauss", {}),
    "poisson": (dict(family="poisson", lambda_=0.0), "ycount", {}),
    "gamma": (dict(family="gamma", lambda_=1e-4), "ypos", {}),
    "tweedie": (dict(family="tweedie", tweedie_variance_power=1.5,
                     tweedie_link_power=0.0, lambda_=1e-4), "yclaim", {}),
    "negativebinomial": (dict(family="negativebinomial", theta=0.5,
                              lambda_=1e-4), "ycount", {}),
    "lambda_search": (dict(family="gaussian", lambda_search=True,
                           nlambdas=6), "ygauss", {}),
    "non_negative": (dict(family="gaussian", lambda_=0.0,
                          non_negative=True), "ygauss", {}),
    "weights": (dict(family="binomial", lambda_=1e-3, weights_column="w"),
                "ybin", {}),
    "offset": (dict(family="poisson", lambda_=1e-4, offset_column="off"),
               "ycount", {}),
    "skip": (dict(family="gaussian", lambda_=1e-3,
                  missing_values_handling="skip"), "ygauss", {}),
    "p_values": (dict(family="gaussian", lambda_=0.0,
                      compute_p_values=True), "ygauss", {}),
    "fuse0": (dict(family="binomial", lambda_=1e-3), "ybin",
              {"H2O3_TPU_GLM_FUSE": "0"}),
    "fuse2": (dict(family="binomial", lambda_=1e-3), "ybin",
              {"H2O3_TPU_GLM_FUSE": "2"}),
}

_METRICS = ("auc", "logloss", "mse", "rmse", "mae", "r2",
            "mean_residual_deviance")


def _compare_training(df, kw, y, x, env=None, monkeypatch=None):
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    jm = JGLM(**kw).train(x=x, y=y, training_frame=JFrame.from_pandas(df))
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(x=x, y=y, training_frame=pf)
    pm = est.model
    assert list(pm.coef) == list(jm.coef)
    jc = np.array(list(jm.coef.values()))
    pc = np.array(list(pm.coef.values()))
    np.testing.assert_allclose(pc, jc, atol=1e-4)
    jpath, ppath = jm.output["regularization_path"], pm.regularization_path
    assert [e.get("iters") for e in ppath] == [e.get("iters") for e in jpath]
    assert [e["lambda"] for e in ppath] == pytest.approx(
        [e["lambda"] for e in jpath], rel=1e-6)
    for k in _METRICS:
        jv = jm.training_metrics._v.get(k)
        if jv is None:
            continue
        pv = pm.training_metrics._v[k]
        assert abs(pv - jv) <= 1e-5 * max(1.0, abs(jv)), k
    assert pm.null_deviance == pytest.approx(jm.output["null_deviance"], rel=1e-5)
    assert pm.residual_deviance == pytest.approx(
        jm.output["residual_deviance"], rel=1e-5)
    return jm, pm


@pytest.mark.parametrize("case", list(TRAININGS))
def test_training_matches_jax(frames, case, monkeypatch):
    kw, y, env = TRAININGS[case]
    df, _, _ = frames
    jm, pm = _compare_training(df, kw, y, X_COLS, env, monkeypatch)
    st = pm.output["irls_stats"]
    assert st["fallbacks"] == 0
    if case == "fuse0":
        assert st["chunks"] == 0 and st["host_iterations"] == st["iterations"]
    else:
        assert st["host_iterations"] == 0
        k = 2 if case == "fuse2" else 8
        assert st["chunks"] >= -(-st["iterations"] // k)
    if case == "p_values":
        for k in ("std_errs", "z_values", "p_values"):
            np.testing.assert_allclose(pm.output[k], jm.output[k],
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.5], ids=["ridge", "elastic_net"])
def test_lbfgs_matches_jax(frames, alpha):
    """L_BFGS, ridge and elastic net (L1 as the bound-constrained split b =
    b+ - b-). scipy's L-BFGS-B stops when the relative objective change
    falls below 2.2e-9, under the float32 noise of a deviance of ~3000
    (~2e-4): both packages stop at that noise floor, where the
    coefficients move by up to ~5e-4 for a change of the objective at its
    noise. So these cases hold the residual deviance (what L-BFGS-B
    minimizes) within 1e-5 relative, as the training metrics, and the
    coefficients within 1e-3, not 1e-4."""
    df, jf, pf = frames
    kw = dict(family="binomial", solver="L_BFGS", lambda_=1e-3, alpha=alpha)
    jm = JGLM(**kw).train(x=X_COLS, y="ybin", training_frame=jf)
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(x=X_COLS, y="ybin", training_frame=pf)
    assert est.model.output["solver"] == "L_BFGS"
    assert est.residual_deviance == pytest.approx(
        jm.output["residual_deviance"], rel=1e-5)
    np.testing.assert_allclose(np.array(list(est.coef.values())),
                               np.array(list(jm.coef.values())), atol=1e-3)


def test_unported_glm_options_raise(frames):
    """Checkpoints are ported (tests/test_torch_checkpoint.py); what GLM
    still refuses of them raises JAX's ValueErrors: an unknown checkpoint,
    a completed fit (no ``irls_state``) and an L_BFGS resume."""
    _, _, pf = frames
    done = H2OGeneralizedLinearEstimator(family="binomial").train(
        x=X_COLS, y="ybin", training_frame=pf).model
    for kw, msg in ((dict(checkpoint="a_model"), "not a model"),
                    (dict(family="binomial", checkpoint=done.key),
                     "COMPLETED"),
                    (dict(family="binomial", solver="L_BFGS",
                          checkpoint=done.key), "IRLSM paths only")):
        with pytest.raises(ValueError, match=msg):
            H2OGeneralizedLinearEstimator(**kw).train(
                x=X_COLS, y="ybin", training_frame=pf)


def test_lambda_alias_and_proxy(frames):
    """``lambda`` is accepted as in h2o-py; the proxy exposes coef,
    coef_norm, the deviances and the path; predict and model_performance
    agree with the training metrics."""
    _, _, pf = frames
    est = H2OGeneralizedLinearEstimator(family="binomial", **{"lambda": 1e-3})
    est.train(x=X_COLS, y="ybin", training_frame=pf)
    assert est.model.params.lambda_ == 1e-3
    assert set(est.coef_norm()) == set(est.coef)
    assert est.residual_deviance < est.null_deviance
    assert len(est.regularization_path) == 1
    perf = est.model_performance(pf)
    assert perf.value("auc") == pytest.approx(est.auc(), abs=1e-12)
    pred = est.predict(pf)
    assert pred.names == ["predict", "no", "yes"]


def jax_glm_numpy(jm) -> dict:
    """A JAX GLM's outputs as plain numpy / Python values, the input of
    ``glm_from_numpy``."""
    di = jm.output["datainfo"]
    return {
        "beta_std": np.asarray(jm.output["beta_std"]),
        "beta_orig": np.asarray(jm.output["beta_orig"]),
        "coef_names": jm.output["coef_names"],
        "family": jm.output["family"], "link": "family_default",
        "tweedie_variance_power": jm.params.tweedie_variance_power,
        "tweedie_link_power": jm.params.tweedie_link_power,
        "theta": jm.params.theta,
        "response_domain": jm.output["response_domain"],
        "names": jm.output["names"],
        "datainfo": {
            "standardize": di.standardize,
            "use_all_factor_levels": di.use_all_factor_levels,
            "missing_handling": di.missing_handling,
            "add_intercept": di.add_intercept,
            "ncols_expanded": di.ncols_expanded,
            "columns": [dict(name=c.name, kind=c.kind, mean=c.mean,
                             sigma=c.sigma, domain=list(c.domain),
                             offset=c.offset, width=c.width)
                        for c in di.columns]},
    }


def test_glm_from_numpy_predicts_like_jax(frames):
    """A JAX model's outputs carried across as numpy predict within 1e-6 of
    JAX's predict."""
    df, jf, pf = frames
    for kw, y in ((dict(family="binomial", lambda_=1e-3), "ybin"),
                  (dict(family="poisson", lambda_=1e-4,
                        offset_column="off"), "ycount")):
        jm = JGLM(**kw).train(x=X_COLS, y=y, training_frame=jf)
        out = jax_glm_numpy(jm)
        pm = glm_from_numpy(out, params=dict(response_column=y,
                                             offset_column=kw.get(
                                                 "offset_column")),
                            device="cpu")
        col = "yes" if y == "ybin" else "predict"
        jp = np.asarray(jm.predict(jf).vec(col).to_numpy())[: jf.nrow]
        pp = pm.predict(pf).vec(col).to_numpy()
        np.testing.assert_allclose(pp, jp, rtol=1e-6, atol=1e-6)


def test_glm_entry_points_need_a_card_without_device(frames, monkeypatch):
    """With no GPU, ``glm_from_numpy`` without ``device`` raises instead of
    running on the CPU; a frame uploaded with ``device="cpu"`` trains."""
    df, jf, pf = frames
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jm = JGLM(family="gaussian", lambda_=1e-3).train(
        x=X_COLS, y="ygauss", training_frame=jf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        glm_from_numpy(jax_glm_numpy(jm))
    est = H2OGeneralizedLinearEstimator(family="gaussian", lambda_=1e-3)
    est.train(x=X_COLS, y="ygauss", training_frame=pf)
    assert est.predict(pf).vec("predict").data.device.type == "cpu"
