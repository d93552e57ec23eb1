"""ANOVAGLM, HGLM, Infogram and PSVM in the port (``h2o3_tpu_torch.models``)
against the JAX package's on the CPU, at small sizes, inputs made with
numpy from seeds: each model trained in both packages, carried across from
JAX (``models.convert_more``), through a save/load round trip and through
its estimator class.

Tolerances, with their reasons:
- ANOVAGLM, gaussian: F, the sums of squares and the p-values within
  1e-4 relative (JAX's float32 Gram against the port's float32 chunk
  products added in float64; the solves are float64 on both sides); a
  p-value below 1e-10 by its logarithm within 1e-4 relative, since a far
  tail's relative error grows with F (at p = 1e-106 an F that is 5e-7
  off moves p by 1.2e-4 of itself); ``beta_full`` within 1e-4 and the
  predictions within 1e-5 (float64 on both sides from those
  coefficients);
- ANOVAGLM, binomial: the deviances within 1e-8 relative (float64 IRLS on
  both sides, sums taken in another order), ``beta_full`` within 1e-4 and
  the probabilities within 1e-5;
- HGLM: β, the BLUPs and the σ²s within 1e-4 (the Gram in float32 on both
  sides, the EM in float64 on both), the EM iterations equal, and a level
  unseen in training predicted with a BLUP of 0 in both packages;
- Infogram: the score tables within 1e-5 and the admissible sets equal
  (each index is 1 − a GBM's training loss over the null loss, and the
  port's GBM matches JAX's trees on these data);
- PSVM: the landmarks equal (the same draws and the same float32 design),
  ``w``, ``b`` and the decisions within 1e-4 relative to the largest
  (float32 products summed in another order, through 60 accelerated
  steps);
- a model carried across predicts within the same bounds as the trained
  one, and a save/load round trip predicts the same bits.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.anovaglm import ANOVAGLM as JANOVAGLM  # noqa: E402
from h2o3_tpu.models.hglm import HGLM as JHGLM  # noqa: E402
from h2o3_tpu.models.infogram import Infogram as JInfogram  # noqa: E402
from h2o3_tpu.models.psvm import PSVM as JPSVM  # noqa: E402
from h2o3_tpu_torch import estimators as E  # noqa: E402
from h2o3_tpu_torch.models import convert_more as cm  # noqa: E402
from h2o3_tpu_torch.models import psvm as ppsvm  # noqa: E402
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


def _pred(model, fr, col):
    return model.predict(fr).vec(col).to_numpy().astype(np.float64)


@pytest.fixture(scope="module")
def frames():
    """Two numerics (with NAs), a 4-level categorical, a gaussian and a
    binary response, and two grouping factors."""
    rng = np.random.default_rng(7)
    n = 1500
    f0, f1 = rng.normal(size=n), rng.normal(size=n)
    g = rng.choice(["a", "b", "c", "d"], n)
    geff = pd.Series(g).map({"a": 0.5, "b": -0.3, "c": 0.1, "d": 0.0}).values
    r1 = rng.integers(0, 6, n)
    r2 = rng.integers(0, 9, n)
    u1, u2 = rng.normal(size=6) * 0.8, rng.normal(size=9) * 0.5
    eta = 0.8 * f0 - 0.5 * f1 + geff + 0.4 * f0 * f1
    df = pd.DataFrame({"f0": f0, "f1": f1})
    df.loc[rng.random(n) < 0.02, "f0"] = np.nan
    df["g"] = pd.Categorical(g)
    df["y"] = eta + u1[r1] + u2[r2] + rng.normal(size=n)
    df["yb"] = pd.Categorical.from_codes(
        (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int), ["n", "p"])
    df["r1"] = pd.Categorical([f"u{i}" for i in r1])
    df["r2"] = pd.Categorical([f"v{i}" for i in r2])
    return df, _frames(df)


# --------------------------------------------------------------------------
# ANOVAGLM


def _anova_output(jm):
    o = jm.output
    return dict(o, beta_full=np.asarray(o["beta_full"]))


@pytest.mark.parametrize("family,y", [("gaussian", "y"), ("binomial", "yb")])
def test_anovaglm_equals_jax(frames, family, y, tmp_path):
    """Three predictors (one categorical) to order 2: the tables, the
    coefficients and the predictions as JAX's; carried across and round
    tripped."""
    _, (jf, pf) = frames
    x = ["f0", "g", "f1"]
    kw = dict(family=family, highest_interaction_term=2)
    jm = JANOVAGLM(**kw).train(y=y, x=x, training_frame=jf)
    pm = _fit(E.H2OANOVAGLMEstimator, pf, y=y, x=x, **kw)
    jt, pt = jm.output["anova_table"], pm.anova_table()
    assert [r["term"] for r in jt] == [r["term"] for r in pt]
    assert [r["df"] for r in jt] == [r["df"] for r in pt]
    assert len(pt) == 6 + (family == "gaussian")
    for a, b in zip(jt, pt):
        if family == "gaussian":
            for k in ("f", "p_value", "ss"):
                if np.isnan(a[k]):
                    assert np.isnan(b[k])
                elif k == "p_value" and a[k] < 1e-10:
                    np.testing.assert_allclose(np.log(b[k]), np.log(a[k]),
                                               rtol=1e-4)
                else:
                    np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=0)
        else:
            np.testing.assert_allclose(b["ss"], a["ss"], rtol=1e-8,
                                       atol=1e-8 * abs(a["ss"]) + 1e-10)
    np.testing.assert_allclose(pm.output["beta_full"],
                               np.asarray(jm.output["beta_full"]), atol=1e-4)
    col = "predict" if family == "gaussian" else "p"
    want = jm.predict(jf).vec(col).to_numpy()[: jf.nrow].astype(np.float64)
    np.testing.assert_allclose(_pred(pm, pf, col), want, atol=1e-5)
    carried = cm.anovaglm_from_numpy(_anova_output(jm))
    np.testing.assert_allclose(_pred(carried, pf, col), want, atol=1e-5)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(_pred(back, pf, col), _pred(pm, pf, col))
    pd.testing.assert_frame_equal(pd.DataFrame(back.anova_table()),
                                  pd.DataFrame(pt))


# --------------------------------------------------------------------------
# HGLM


def test_hglm_equals_jax_and_unseen_level(frames, tmp_path):
    """Two random columns: β, the BLUPs, the σ²s and the EM iterations as
    JAX's; a frame with a level unseen in training predicts with BLUP 0."""
    df, (jf, pf) = frames
    kw = dict(random_columns=["r1", "r2"])
    x = ["f0", "f1", "g", "r1", "r2"]
    jm = JHGLM(**kw).train(y="y", x=x, training_frame=jf)
    pm = _fit(E.H2OHGLMEstimator, pf, y="y", x=x, **kw)
    jo, po = jm.output, pm.output
    assert po["em_iterations"] == jo["em_iterations"]
    assert po["coef_names"] == jo["coef_names"]
    np.testing.assert_allclose(po["beta"], jo["beta"], atol=1e-4)
    for rc in ("r1", "r2"):
        assert list(pm.coefs_random(rc)) == list(jm.coefs_random(rc))
        np.testing.assert_allclose(list(pm.coefs_random(rc).values()),
                                   list(jm.coefs_random(rc).values()),
                                   atol=1e-4)
        np.testing.assert_allclose(po["sigma_u2"][rc], jo["sigma_u2"][rc],
                                   rtol=1e-4)
    np.testing.assert_allclose(po["sigma_e2"], jo["sigma_e2"], rtol=1e-4)
    np.testing.assert_allclose(list(pm.coef.values()), list(jm.coef.values()),
                               atol=1e-4)
    # a scoring frame with an unseen level of r1 and an NA in r2
    te = df.head(40).copy()
    te["r1"] = te["r1"].astype(str)
    te.loc[te.index[:5], "r1"] = "unseen"
    te["r1"] = pd.Categorical(te["r1"])
    te.loc[te.index[5:8], "r2"] = np.nan
    tj, tp = _frames(te)
    want = jm.predict(tj).vec("predict").to_numpy()[:40]
    got = _pred(pm, tp, "predict")
    np.testing.assert_allclose(got, want, atol=1e-4)
    # the unseen rows: the fixed part and r2's BLUP only
    fixed = cm.hglm_from_numpy(dict(
        po, datainfo=_datainfo_meta(po["datainfo"]),
        random_effects={"r2": po["random_effects"]["r2"]}))
    np.testing.assert_allclose(got[:5], _pred(fixed, tp, "predict")[:5],
                               atol=1e-12)
    carried = cm.hglm_from_numpy(dict(
        jo, datainfo=_datainfo_meta(jo["datainfo"])))
    np.testing.assert_allclose(_pred(carried, tp, "predict"), want,
                               atol=1e-4)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(_pred(back, tp, "predict"), got)


# --------------------------------------------------------------------------
# Infogram


@pytest.fixture(scope="module")
def info_frames():
    rng = np.random.default_rng(11)
    n = 600
    X = rng.normal(size=(n, 4))
    prot = (X[:, 2] + 0.5 * rng.normal(size=n) > 0).astype(int)
    eta = 1.5 * X[:, 0] - X[:, 1] + 0.7 * prot
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(4)])
    df["sex"] = pd.Categorical.from_codes(prot, ["F", "M"])
    df["y"] = pd.Categorical.from_codes(
        (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(int), ["n", "p"])
    return _frames(df)


@pytest.mark.parametrize("protected", [[], ["sex"]], ids=["core", "fair"])
def test_infogram_equals_jax(info_frames, protected, tmp_path):
    """Core and fair mode on 4 features, 5 trees of depth 3: the score
    tables and the admissible sets as JAX's."""
    jf, pf = info_frames
    x = ["f0", "f1", "f2", "f3"] + protected
    kw = dict(protected_columns=protected, ntrees=5, max_depth=3, seed=3)
    jm = JInfogram(**kw).train(y="y", x=x, training_frame=jf)
    pm = _fit(E.H2OInfogramEstimator, pf, y="y", x=x, **kw)
    jt, pt = jm.output["score_table"], pm.get_admissible_score_frame()
    assert [r["column"] for r in jt] == [r["column"] for r in pt]
    xk, yk = pm.output["x_axis"], pm.output["y_axis"]
    assert (xk, yk) == (jm.output["x_axis"], jm.output["y_axis"])
    for a, b in zip(jt, pt):
        np.testing.assert_allclose([b[xk], b[yk]], [a[xk], a[yk]], atol=1e-5)
    assert pm.get_admissible_features() == jm.get_admissible_features()
    assert pm.get_admissible_features()  # the signal columns pass
    carried = cm.infogram_from_numpy(jm.output)
    assert carried.get_admissible_features() == jm.get_admissible_features()
    back = _round_trip(pm, tmp_path)
    assert back.get_admissible_score_frame() == pt


# --------------------------------------------------------------------------
# PSVM


def _jax_step(Phi, sw, C):
    """JAX's step rule (``h2o3_tpu/models/psvm.py`` ``_sq_hinge_fit``): 1/L
    with L from 8 power iterations on ΦᵀSΦ, ``w``'s curvature alone."""
    v = torch.ones(Phi.shape[1]) / torch.sqrt(torch.tensor(
        float(Phi.shape[1])))
    for _ in range(8):
        u = Phi.T @ (sw * (Phi @ v))
        v = u / torch.clamp(torch.linalg.norm(u), min=1e-30)
    return 1.0 / (1.0 + 2.0 * C * torch.linalg.norm(Phi.T @ (sw * (Phi @ v))))


def test_psvm_with_class_weights_equals_jax(tmp_path, monkeypatch):
    """Class weights, a categorical feature, 60 steps: the same landmarks,
    ``w``, ``b`` and decisions as JAX's.

    ``K_mm^{-1/2}`` amplifies rounding (``K_mm`` has eigenvalues down to
    its 1e-6 ridge), so one float32 ulp in the design moves ``whalf``.
    Each package's frame statistics are float32 sums taken in another
    order (a column's mean and deviation agree to 1e-6 of the deviation,
    checked here, yet can round to another float32), so the port's frame
    is handed JAX's means and deviations before the training: both
    designs are then the same floats. The frame has 11 design columns for
    its 120 landmarks: with 5 columns for 150 landmarks ``K_mm`` is so
    near singular that a last-bit change in Φ moves ``w`` by 10%. The port
    takes its steps with JAX's step rule here (its own also counts the
    bias's curvature: :func:`test_psvm_converges_where_jax_diverges`)."""
    monkeypatch.setattr(ppsvm, "step_size", _jax_step)
    rng = np.random.default_rng(5)
    n = 1200
    df = pd.DataFrame(rng.normal(size=(n, 8)),
                      columns=[f"f{i}" for i in range(8)])
    df.loc[rng.random(n) < 0.02, "f0"] = np.nan
    df["g"] = pd.Categorical(rng.choice(["a", "b", "c"], n))
    eta = (np.nan_to_num(df["f0"]) - df["f1"] + 0.5 * df["f2"] * df["f3"]
           + (df["g"] == "a"))
    df["yb"] = pd.Categorical.from_codes(
        (rng.random(n) < 1 / (1 + np.exp(-2 * eta))).astype(int), ["n", "p"])
    jf, pf = _frames(df)
    x = [f"f{i}" for i in range(8)] + ["g"]
    for c in x[:8]:
        js, ps = jf.vec(c).stats(), pf.vec(c).stats()
        np.testing.assert_allclose([ps["mean"], ps["sigma"]],
                                   [js["mean"], js["sigma"]], rtol=1e-6,
                                   atol=1e-6 * js["sigma"])
        ps.update(mean=js["mean"], sigma=js["sigma"])
    kw = dict(positive_weight=2.0, negative_weight=0.5, max_iterations=60,
              seed=4)
    jm = JPSVM(**kw).train(y="yb", x=x, training_frame=jf)
    pm = _fit(E.H2OSupportVectorMachineEstimator, pf, y="yb", x=x, **kw)
    jo, po = jm.output, pm.output
    np.testing.assert_array_equal(po["landmarks"], jo["landmarks"])
    np.testing.assert_array_equal(po["whalf"], jo["whalf"])
    wmax = np.abs(jo["w"]).max()
    np.testing.assert_allclose(po["w"], jo["w"], atol=1e-4 * wmax)
    np.testing.assert_allclose(po["b"], jo["b"], atol=1e-4 * wmax)
    jd = np.asarray(jm._decision(jf), np.float64)
    pd_ = pm._decision(pf).numpy().astype(np.float64)
    dmax = np.abs(jd).max()
    np.testing.assert_allclose(pd_, jd, atol=1e-4 * dmax)
    assert abs(po["svs_count"] - jo["svs_count"]) <= 2
    obj = po["objectives"]
    assert obj[-1] < obj[0]
    want = jm.predict(jf).vec("p").to_numpy()[: jf.nrow]
    np.testing.assert_allclose(_pred(pm, pf, "p"), want, atol=1e-4)
    carried = cm.psvm_from_numpy(dict(
        jo, datainfo=_datainfo_meta(jo["datainfo"])))
    np.testing.assert_allclose(carried._decision(pf).numpy(), jd,
                               atol=1e-5 * dmax)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(_pred(back, pf, "p"), _pred(pm, pf, "p"))


def test_psvm_converges_where_jax_diverges():
    """A fault of the reference: JAX's step 1/L takes L from ΦᵀSΦ alone,
    but the bias adds 2C·Σs to the curvature, more than ΦᵀSΦ's top
    eigenvalue on the headline's features, so at JAX's defaults its
    accelerated steps grow without bound and the model is NaN (JAX's
    training fails). The port's L is that of the whole (w, b) Hessian:
    its objective falls and its model scores."""
    from h2o3_tpu_torch.datasets import higgs_like

    df = higgs_like(1200, 28, seed=0)
    jf, pf = _frames(df)
    with pytest.raises(Exception):
        JPSVM(seed=1).train(y="label", training_frame=jf)
    pm = _fit(E.H2OSupportVectorMachineEstimator, pf, y="label", seed=1)
    obj = pm.output["objectives"]
    assert np.isfinite(obj).all() and obj[-1] <= obj[-101] < obj[0]
    assert pm.training_metrics.value("auc") > 0.7
