"""K-means, PCA, SVD, GLRM, naive Bayes and the two isolation forests in the
port (``h2o3_tpu_torch.models``) against the JAX package's on the CPU, at
small sizes, inputs made with numpy from seeds: each model trained in both
packages, carried across from JAX (``models.convert_more``) and through a
save/load round trip; the k-means tmojo exported by each package and scored
by the port's scorer.

Tolerances, with their reasons:
- k-means centers within 1e-5 (standardized units) and assignments equal
  on separated blobs: both packages run the same float32 Lloyd steps from
  the same drawn start;
- PCA eigenvalues within 1e-5 relative and eigenvectors within 1e-4 up to
  sign (float32 Grams summed in other orders, then float64 eigh); SVD's
  singular values within 1e-5 relative on the Gram path and 1e-4 on the
  randomized one (a QR's signs and a float32 product chain);
- GLRM's objective within 1e-4 relative and X·Y within 1e-3 (float32
  alternating solves in another order);
- naive Bayes probabilities within 1e-6 on features on a grid of
  quarters, where JAX's float32 class sums are exact as the port's float64
  ones are (on other data JAX's float32 sums round, so there the port's
  statistics are held to a float64 host computation instead);
- the isolation forests' trees equal (the same draws on the same float32
  sample rows) and scores within 1e-5 (JAX adds the path lengths tree by
  tree in float32, the port in float64).
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu import genmodel as jgen  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import export as jexport  # noqa: E402
from h2o3_tpu.models.extended_isolation_forest import (  # noqa: E402
    ExtendedIsolationForest as JEIF,
)
from h2o3_tpu.models.glrm import GLRM as JGLRM  # noqa: E402
from h2o3_tpu.models.isolation_forest import IsolationForest as JIF  # noqa: E402
from h2o3_tpu.models.kmeans import KMeans as JKMeans  # noqa: E402
from h2o3_tpu.models.naive_bayes import NaiveBayes as JNB  # noqa: E402
from h2o3_tpu.models.pca import PCA as JPCA  # noqa: E402
from h2o3_tpu.models.pca import SVD as JSVD  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch import estimators as E  # noqa: E402
from h2o3_tpu_torch.models import convert_more as cm  # noqa: E402
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
def blobs():
    """Four separated Gaussian blobs in 6 columns, and an enum column."""
    rng = np.random.default_rng(3)
    n = 2000
    cent = rng.normal(size=(4, 6)) * 5
    X = cent[rng.integers(0, 4, n)] + rng.normal(size=(n, 6))
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(6)])
    df["c"] = pd.Categorical(rng.choice(["a", "b", "c"], n))
    return df


# --- k-means -----------------------------------------------------------


@pytest.mark.parametrize("init,k", [("Furthest", 4), ("PlusPlus", 4),
                                    ("Random", 4), ("Furthest", 9)])
def test_kmeans_equals_jax(blobs, init, k, tmp_path):
    """Centers within 1e-5, assignments equal, from each start; k 9 on
    four blobs splits them."""
    jf, pf = _frames(blobs)
    jm = JKMeans(k=k, init=init, seed=5).train(training_frame=jf)
    pm = _fit(E.H2OKMeansEstimator, pf, k=k, init=init, seed=5)
    np.testing.assert_allclose(pm.output["centers_std"],
                               jm.output["centers_std"], rtol=0, atol=1e-5)
    assert pm.output["size"] == pytest.approx(jm.output["size"])
    want = jm.predict(jf).vec("predict").to_numpy()[: len(blobs)]
    got = pm.predict(pf).vec("predict").to_numpy()
    np.testing.assert_array_equal(got, want)
    tm, jtm = pm.training_metrics._v, jm.training_metrics._v
    for key in ("tot_withinss", "betweenss", "totss"):
        assert tm[key] == pytest.approx(jtm[key], rel=1e-5)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back.predict(pf).vec("predict").to_numpy(),
                                  got)


def test_kmeans_reseeds_a_dead_cluster():
    """Four points repeated 15 times each, k 4 from a Random start: the
    start draws a point twice, the tie leaves a cluster empty, and both
    packages seed it again from the same draws (the port counts each
    reseed's row read in ``host_reads``)."""
    rng = np.random.default_rng(3)
    pts = np.round(rng.normal(size=(4, 3)) * 5, 2)
    df = pd.DataFrame(pts[np.arange(60) % 4], columns=["a", "b", "c"])
    jf, pf = _frames(df)
    jm = JKMeans(k=4, init="Random", seed=6).train(training_frame=jf)
    pm = _fit(E.H2OKMeansEstimator, pf, k=4, init="Random", seed=6)
    o = pm.output
    assert o["host_reads"] - o["iterations"] - 4 >= 1  # a reseed's read
    np.testing.assert_allclose(o["centers_std"], jm.output["centers_std"],
                               rtol=0, atol=1e-5)
    assert o["size"] == pytest.approx(jm.output["size"])


def test_kmeans_tmojo_scored_by_the_port_and_carried_across(blobs, tmp_path):
    """The port's k-means tmojo and JAX's, scored by the port's scorer, give
    JAX's cluster ids; a JAX model carried across predicts as JAX does."""
    jf, pf = _frames(blobs)
    jm = JKMeans(k=4, seed=5).train(training_frame=jf)
    pm = _fit(E.H2OKMeansEstimator, pf, k=4, seed=5)
    want = jm.predict(jf).vec("predict").to_numpy()[: len(blobs)]
    rows = blobs.iloc[:500]
    jpath = jexport.export_mojo(jm, str(tmp_path / "jax.zip"))
    ppath = pm.download_mojo(str(tmp_path / "port.zip"))
    for path in (jpath, ppath):
        got = pgen.MojoModel.load(path).predict(rows)["cluster"]
        np.testing.assert_array_equal(got, want[:500])
    np.testing.assert_array_equal(
        jgen.MojoModel.load(ppath).predict(rows)["cluster"], want[:500])
    out = {k: jm.output[k] for k in ("centers_std", "centers", "names", "k",
                                     "size")}
    out["datainfo"] = _datainfo_meta(jm.output["datainfo"])
    cm_model = cm.kmeans_from_numpy(out, params={"k": 4})
    np.testing.assert_array_equal(
        cm_model.predict(pf).vec("predict").to_numpy(), want)


# --- PCA and SVD -------------------------------------------------------


@pytest.fixture(scope="module")
def lowrank():
    rng = np.random.default_rng(5)
    n = 2000
    Z = rng.normal(size=(n, 3))
    X = Z @ rng.normal(size=(3, 8)) + 0.3 * rng.normal(size=(n, 8)) + 2
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(8)])
    df["c"] = pd.Categorical(rng.choice(["a", "b", "c"], n))
    return df


def _up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    s = np.sign((a * b).sum(0))
    np.testing.assert_allclose(a * s, b, rtol=0, atol=atol)


@pytest.mark.parametrize("transform", ["NONE", "DEMEAN", "DESCALE",
                                       "STANDARDIZE"])
def test_pca_equals_jax(lowrank, transform, tmp_path):
    jf, pf = _frames(lowrank)
    jm = JPCA(k=3, transform=transform).train(training_frame=jf)
    pm = _fit(E.H2OPrincipalComponentAnalysisEstimator, pf, k=3,
              transform=transform)
    np.testing.assert_allclose(pm.output["eigenvalues"],
                               jm.output["eigenvalues"], rtol=1e-5)
    _up_to_sign(pm.output["eigenvectors"], jm.output["eigenvectors"], 1e-4)
    js = np.asarray(jm._predict_raw(jf))[: len(lowrank)]
    ps = pm.predict(pf)
    got = np.stack([ps.vec(f"PC{i}").to_numpy() for i in (1, 2, 3)], 1)
    np.testing.assert_allclose(np.abs(got), np.abs(js), rtol=0, atol=1e-3)
    out = {k: jm.output[k] for k in ("eigenvectors", "eigenvalues",
                                     "std_deviation", "names")}
    out["datainfo"] = _datainfo_meta(jm.output["datainfo"])
    carried = cm.pca_from_numpy(out)
    np.testing.assert_allclose(carried._predict_raw(pf).numpy(), js,
                               rtol=0, atol=1e-4)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back._predict_raw(pf).numpy(),
                                  pm._predict_raw(pf).numpy())


@pytest.mark.parametrize("path", ["gram", "randomized"])
def test_svd_equals_jax(lowrank, path, tmp_path):
    """The Gram path (8 + 3 design columns) and the randomized one (78
    columns: past the Gram path's 64)."""
    df = lowrank
    if path == "randomized":
        rng = np.random.default_rng(9)
        wide = pd.DataFrame(rng.normal(size=(len(df), 70)),
                            columns=[f"w{i}" for i in range(70)])
        df = pd.concat([df.drop(columns="c"), wide], axis=1)
    jf, pf = _frames(df)
    jm = JSVD(nv=3, seed=3).train(training_frame=jf)
    pm = _fit(E.H2OSingularValueDecompositionEstimator, pf, nv=3, seed=3)
    assert pm.output["method"] == path
    np.testing.assert_allclose(pm.output["d"], jm.output["d"],
                               rtol=1e-5 if path == "gram" else 1e-4)
    _up_to_sign(pm.output["v"], jm.output["v"], 1e-3)
    out = {k: jm.output[k] for k in ("v", "d", "names")}
    out["datainfo"] = _datainfo_meta(jm.output["datainfo"])
    want = np.asarray(jm._predict_raw(jf))[: len(df)]
    np.testing.assert_allclose(cm.svd_from_numpy(out)._predict_raw(
        pf).numpy(), want, rtol=0, atol=1e-4)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back._predict_raw(pf).numpy(),
                                  pm._predict_raw(pf).numpy())


# --- GLRM --------------------------------------------------------------


@pytest.mark.parametrize("reg", ["None", "NonNegative"])
def test_glrm_equals_jax(lowrank, reg, tmp_path):
    """Unregularized (the alternating ridge path) and NonNegative on both
    factors (the proximal path)."""
    df = lowrank.drop(columns="c").copy()
    df.iloc[::17, 2] = np.nan
    jf, pf = _frames(df)
    kw = dict(k=3, regularization_x=reg, regularization_y=reg,
              max_iterations=40)
    jm = JGLRM(**kw).train(training_frame=jf)
    pm = _fit(E.H2OGeneralizedLowRankEstimator, pf, **kw)
    assert pm.output["objective"] == pytest.approx(jm.output["objective"],
                                                   rel=1e-4)
    assert isinstance(pm.output["x_factor"], torch.Tensor)
    jxy = np.asarray(jm.output["x_factor"]) @ jm.output["archetypes"]
    pxy = pm.output["x_factor"].numpy() @ pm.output["archetypes"]
    np.testing.assert_allclose(pxy, jxy[: len(df)], rtol=0, atol=1e-3)
    want = jm.reconstruct(jf)
    got = pm.reconstruct(pf)
    for c in ("x0", "x5"):
        np.testing.assert_allclose(
            got.vec(f"reconstr_{c}").to_numpy(),
            want.vec(f"reconstr_{c}").to_numpy()[: len(df)], rtol=0,
            atol=1e-3)
    out = {k: jm.output[k] for k in ("names", "archetypes", "x_factor",
                                     "means", "sigmas", "objective")}
    out["x_factor"] = np.asarray(out["x_factor"])
    carried = cm.glrm_from_numpy(out, device="cpu")
    jt = jm.transform_frame(jf)
    np.testing.assert_allclose(
        carried.transform_frame(pf).vec("Arch1").to_numpy(),
        jt.vec("Arch1").to_numpy()[: len(df)], rtol=0, atol=1e-4)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back.output["x_factor"].numpy(),
                                  pm.output["x_factor"].numpy())


# --- naive Bayes -------------------------------------------------------


@pytest.fixture(scope="module")
def nb_data():
    """Numeric columns on a grid of quarters (some NA), two enum columns
    (one with NAs), a 3-class response."""
    rng = np.random.default_rng(4)
    n = 3000
    lab = rng.integers(0, 3, n)
    a = np.round((rng.normal(size=n) + lab) * 4) / 4
    a[rng.random(n) < 0.05] = np.nan
    c = np.where(rng.random(n) < 0.5, lab, rng.integers(0, 4, n)).astype(str)
    d = rng.choice(["p", "q"], n).astype(object)
    d[rng.random(n) < 0.04] = None
    return pd.DataFrame({
        "a": a, "b": np.round((rng.normal(size=n) * 2 - lab) * 4) / 4,
        "c": pd.Categorical(c), "d": pd.Categorical(d),
        "y": pd.Categorical.from_codes(lab, ["u", "v", "w"])})


@pytest.mark.parametrize("laplace", [0.0, 1.0])
def test_naive_bayes_equals_jax(nb_data, laplace, tmp_path):
    jf, pf = _frames(nb_data)
    jm = JNB(laplace=laplace).train(y="y", training_frame=jf)
    pm = _fit(E.H2ONaiveBayesEstimator, pf, y="y", laplace=laplace)
    want = np.asarray(jm._predict_raw(jf))[: len(nb_data)]
    got = pm._predict_raw(pf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    out = {k: jm.output[k] for k in ("priors", "num_stats", "cat_stats",
                                     "names", "response_domain")}
    carried = cm.naive_bayes_from_numpy(out, params={"laplace": laplace})
    np.testing.assert_allclose(carried._predict_raw(pf).numpy(), want,
                               rtol=0, atol=1e-6)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back._predict_raw(pf).numpy(), got)


def test_naive_bayes_statistics_are_float64(blobs):
    """Off the grid the port's class means and deviations match a float64
    host computation (JAX's float32 sums round there)."""
    df = blobs.assign(y=pd.Categorical.from_codes(
        (blobs["x0"] > blobs["x0"].median()).astype(int), ["lo", "hi"]))
    pm = _fit(E.H2ONaiveBayesEstimator,
              h2o3_tpu_torch.upload_file(df, device="cpu"), y="y")
    x = df["x1"].to_numpy(np.float32).astype(np.float64)
    for k, lvl in enumerate(["lo", "hi"]):
        xs = x[(df["y"] == lvl).to_numpy()]
        st = pm.output["num_stats"]["x1"]
        assert st["mean"][k] == pytest.approx(xs.mean(), rel=1e-12)
        assert st["sdev"][k] == pytest.approx(xs.std(ddof=1), rel=1e-10)


# --- isolation forests -------------------------------------------------


@pytest.fixture(scope="module")
def outliers():
    rng = np.random.default_rng(6)
    n = 2000
    X = rng.normal(size=(n, 6))
    X[:20] += 6
    X[rng.random((n, 6)) < 0.02] = np.nan
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(6)])
    df["c"] = pd.Categorical(rng.choice(["a", "b", "c"], n))
    return df


def test_isolation_forest_equals_jax(outliers, tmp_path):
    jf, pf = _frames(outliers)
    jm = JIF(ntrees=20, seed=3).train(training_frame=jf)
    pm = _fit(E.H2OIsolationForestEstimator, pf, ntrees=20, seed=3)
    for ta, tb in zip(jm.output["trees"], pm.output["trees"]):
        for a, b in zip(ta, tb):
            np.testing.assert_array_equal(a, b)
    want = jm._predict_raw(jf)[: len(outliers)]
    got = pm._predict_raw(pf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert list(pm.predict(pf).names) == ["predict", "mean_length"]
    out = {k: jm.output[k] for k in ("trees", "names", "feature_domains")}
    carried = cm.iforest_from_numpy(out, params={"ntrees": 20})
    np.testing.assert_allclose(carried._predict_raw(pf).numpy(), want,
                               rtol=0, atol=1e-5)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back._predict_raw(pf).numpy(), got)


def test_extended_isolation_forest_equals_jax(outliers, tmp_path):
    df = outliers.drop(columns="c")
    jf, pf = _frames(df)
    jm = JEIF(ntrees=25, seed=3).train(training_frame=jf)
    pm = _fit(E.H2OExtendedIsolationForestEstimator, pf, ntrees=25, seed=3)
    np.testing.assert_allclose(pm.output["col_means"],
                               jm.output["col_means"], rtol=1e-12)
    for la, lb in zip(jm.output["stacked_trees"], pm.output["stacked_trees"]):
        assert len(la) == len(lb)
        for a, b in zip(la, lb):
            for x, z in zip(a, b):
                np.testing.assert_array_equal(x, z)
    want = jm._predict_raw(jf)[: len(df)]
    got = pm._predict_raw(pf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    out = {k: jm.output[k] for k in ("names", "col_means", "stacked_trees",
                                     "sample_size")}
    carried = cm.eif_from_numpy(out)
    np.testing.assert_allclose(carried._predict_raw(pf).numpy(), want,
                               rtol=0, atol=1e-5)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back._predict_raw(pf).numpy(), got)
