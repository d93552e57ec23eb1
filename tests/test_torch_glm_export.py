"""GLM tmojo export in the port (``h2o3_tpu_torch.models.export``) and its
offline scorer (``h2o3_tpu_torch.genmodel``) against the JAX package's, on
the CPU at small sizes: port GLMs (binomial with categoricals and NAs, a
poisson and a tweedie regression) exported and scored by both packages'
``genmodel``; a JAX GLM carried across with ``glm_from_numpy`` and
exported by the port against JAX's own export of it.

Tolerances, with their reasons:
- scorer against ``predict``: within 1e-5 (the scorers build the design
  and the linear predictor in float64, ``predict`` in float32; JAX's
  MOJO-parity tolerance);
- the two scorers, and the arrays of two exports of one model: exact (the
  same numpy code on the same payload; the same float64 coefficients);
- multinomial, ordinal, interaction and hashed GLMs: the port's scorer
  against the port's ``predict`` within 1e-6 (the scorer in float64, the
  softmax and the linear predictors of ``predict`` in float32, ordinal
  ``predict`` in float64 cast to float32 in the prediction frame), JAX's
  scorer on the port's artifact within 1e-6 of the port's scorer (the
  same float64 formulas). JAX's scorer multiplies a multinomial design by
  the transpose of the (P, K) coefficients it writes and cannot score a
  multinomial artifact, its own included (ROADMAP Queue C): the
  multinomial case holds the port's scorer alone.
"""

import io
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import h2o3_tpu.genmodel as jgen  # noqa: E402
import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import export as jexport  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator  # noqa: E402
from h2o3_tpu_torch.models.export import export_mojo  # noqa: E402
from h2o3_tpu_torch.models.glm import glm_from_numpy  # noqa: E402
from test_torch_datainfo_interactions import ia_df  # noqa: E402
from test_torch_glm import X_COLS, glm_df, jax_glm_numpy  # noqa: E402
from test_torch_glm_multinomial import mn_df  # noqa: E402

CASES = {
    "binomial": (dict(family="binomial", lambda_=1e-3), "ybin"),
    "poisson": (dict(family="poisson", lambda_=1e-4), "ycount"),
    "tweedie": (dict(family="tweedie", tweedie_variance_power=1.5,
                     tweedie_link_power=0.0, lambda_=1e-4), "yclaim"),
}


@pytest.fixture(scope="module")
def data():
    df = glm_df(n=2000, seed=3)
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


def _probs(out: dict, y: str) -> np.ndarray:
    return np.asarray(out["yes"] if y == "ybin" else out["predict"], np.float64)


@pytest.mark.parametrize("case", list(CASES))
def test_glm_tmojo_scores_like_predict_in_both_scorers(data, case, tmp_path):
    df, _, pf = data
    kw, y = CASES[case]
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(x=X_COLS, y=y, training_frame=pf)
    path = est.download_mojo(str(tmp_path))
    col = "yes" if y == "ybin" else "predict"
    want = est.predict(pf).vec(col).to_numpy()
    rows = df[X_COLS]
    jout = jgen.MojoModel.load(path).predict(rows)
    pout = pgen.MojoModel.load(path).predict(rows)
    np.testing.assert_allclose(_probs(pout, y), want, atol=1e-5)
    np.testing.assert_allclose(_probs(jout, y), want, atol=1e-5)
    assert jout.keys() == pout.keys()
    for k in jout:
        assert np.array_equal(jout[k], pout[k]), k
    if y == "ybin":
        np.testing.assert_array_equal(
            pout["predict"],
            np.asarray(est.model.output["response_domain"], dtype=object)[
                est.predict(pf).vec("predict").to_numpy()])


def _unzip(path):
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("model.json"))
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        return meta, {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("case", ["binomial", "poisson"])
def test_converted_jax_glm_exports_like_jax(data, case, tmp_path):
    """A JAX GLM exported by JAX, and carried across with
    ``glm_from_numpy`` and exported by the port: the arrays are equal, the
    metadata equal but for the model key and the threshold (the port model
    carries no training metrics)."""
    _, jf, pf = data
    kw, y = CASES[case]
    jm = JGLM(**kw).train(x=X_COLS, y=y, training_frame=jf)
    pm = glm_from_numpy(jax_glm_numpy(jm), params=dict(response_column=y),
                        device="cpu")
    jpath, ppath = str(tmp_path / "j.zip"), str(tmp_path / "p.zip")
    jexport.export_mojo(jm, jpath)
    export_mojo(pm, ppath)
    jmeta, jarr = _unzip(jpath)
    pmeta, parr = _unzip(ppath)
    assert jarr.keys() == parr.keys()
    for k in jarr:
        assert jarr[k].dtype == parr[k].dtype, k
        np.testing.assert_array_equal(parr[k], jarr[k])
    for k in set(jmeta) - {"model_key", "default_threshold"}:
        assert pmeta[k] == jmeta[k], k


NEW_KINDS = {
    "multinomial": (lambda: mn_df(2000, 3), dict(family="multinomial",
                                                 lambda_=1e-4),
                    "ymn", X_COLS),
    "ordinal": (lambda: _ordinal_df(), dict(family="ordinal"), "rating",
                None),
    "interactions": (lambda: glm_df(2000, 3), dict(
        family="binomial", lambda_=1e-3,
        interaction_pairs=[("c1", "c2"), ("x0", "x1"), ("c1", "x2")]),
        "ybin", X_COLS),
    "hashed": (lambda: ia_df(2000, 3), dict(
        family="gaussian", lambda_=1e-4, hash_buckets=16,
        interactions=["x0", "x3"]), "ygauss", X_COLS + ["h"]),
}


def _ordinal_df():
    from h2o3_tpu_torch.datasets import ordinal_like

    return ordinal_like(2000, c=8, seed=3)


@pytest.mark.parametrize("kind", list(NEW_KINDS))
def test_new_glm_kinds_tmojo_scores_like_predict(kind, tmp_path):
    make, kw, y, x = NEW_KINDS[kind]
    df = make()
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(x=x, y=y, training_frame=pf)
    path = est.download_mojo(str(tmp_path))
    meta, arrays = _unzip(path)
    rows = df.drop(columns=[y])
    pout = pgen.MojoModel.load(path).predict(rows)
    pred = est.predict(pf)
    cols = [c for c in pred.names if c != "predict"] or ["predict"]
    for c in cols:
        np.testing.assert_allclose(np.asarray(pout[c], np.float64),
                                   pred.vec(c).to_numpy(), atol=1e-6)
    if kind == "multinomial":
        assert arrays["beta_multinomial_std"].shape == (
            est.model.output["datainfo"].ncols_expanded, 3)
        return
    jout = jgen.MojoModel.load(path).predict(rows)
    for c in cols:
        np.testing.assert_allclose(np.asarray(jout[c], np.float64),
                                   np.asarray(pout[c], np.float64), atol=1e-6)
    if kind == "ordinal":
        assert "theta" in arrays and not meta["datainfo"]["add_intercept"]
    if kind == "hashed":
        assert meta["datainfo"]["hash_buckets"] == 16
    if kind in ("interactions", "hashed"):
        assert any(c["pair"] for c in meta["datainfo"]["columns"])


@pytest.mark.parametrize("algo", ["deeplearning", "kmeans"])
def test_unported_artifacts_still_raise(tmp_path, algo):
    """K-means artifacts still raise; DeepLearning artifacts, ported in
    slice 12, load into the DeepLearning scorer."""
    path = str(tmp_path / f"{algo}.zip")
    buf = io.BytesIO()
    np.savez_compressed(buf, w=np.zeros(1))
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("model.json", json.dumps({"algo": algo}))
        z.writestr("arrays.npz", buf.getvalue())
    if algo == "deeplearning":
        assert type(pgen.MojoModel.load(path)).__name__ == \
            "_DeepLearningMojo"
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        pgen.MojoModel.load(path)
