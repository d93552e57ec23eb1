"""DeepLearning tmojo export in the port (``h2o3_tpu_torch.models.export``)
and its offline scorer (``h2o3_tpu_torch.genmodel``) against the JAX
package's, on the CPU at small sizes: port models (binomial, multinomial,
regression on a shape-bucketed width, tanh, the autoencoder) exported and
scored by both packages' ``genmodel``; a JAX model carried across with
``dl_from_numpy``, predicting like JAX and exported like JAX.

Tolerances, with their reasons:
- the port's scorer against the port's ``predict``: 1e-6 (both run every
  layer in float64; the scorer builds its design in float64 from the raw
  values, ``predict`` from the frame's float32 design, and ``predict``'s
  probabilities are float32);
- JAX's scorer against the port's on a supervised artifact: 1e-6 (the
  same float64 formulas; JAX's scorer gives an autoencoder only its first
  output, which is held against the port's first reconstruction column);
- a JAX model carried across: predictions within 1e-6 of JAX's (the same
  float32 weights and design; JAX's pass is float32, the port's float64),
  and the port's export of it equal to JAX's own export, array for array.
"""

import io
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import h2o3_tpu.genmodel as jgen  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import deeplearning as jdl  # noqa: E402
from h2o3_tpu.models import export as jexport  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OAutoEncoderEstimator,
    H2ODeepLearningEstimator,
)
from h2o3_tpu_torch.models.deeplearning import dl_from_numpy  # noqa: E402
from h2o3_tpu_torch.models.export import export_mojo  # noqa: E402
from test_torch_deeplearning import BASE, NUMS, X_COLS, _np_tree, dl_df  # noqa: E402

CASES = {
    "binomial": ("label", dict()),
    "multinomial": ("ymn", dict(activation="Tanh")),
    "regression": ("yreg", dict(l2=1e-3)),
}


@pytest.fixture(scope="module")
def data():
    df = dl_df(n=1500, seed=4)
    return df, h2o3_tpu_torch.upload_file(df, device="cpu")


def _mojo_bytes(model) -> bytes:
    buf = io.BytesIO()
    export_mojo(model, buf)
    return buf.getvalue()


def _load(mod, raw: bytes):
    return mod.MojoModel.load(io.BytesIO(raw))


@pytest.mark.parametrize("case", list(CASES))
def test_port_artifact_scores_like_predict(data, case):
    df, pf = data
    y, kw = CASES[case]
    est = H2ODeepLearningEstimator(**{**BASE, **kw})
    est.train(x=X_COLS, y=y, training_frame=pf)
    raw = _mojo_bytes(est.model)
    with zipfile.ZipFile(io.BytesIO(raw)) as z:
        meta = json.loads(z.read("model.json"))
    assert meta["algo"] == "deeplearning" and meta["n_layers"] == 3
    pred = est.predict(pf)
    mine = _load(pgen, raw).predict(df)
    theirs = _load(jgen, raw).predict(df)
    cols = (["predict"] if y == "yreg"
            else [str(d) for d in est.model.output["response_domain"]])
    for c in cols:
        np.testing.assert_allclose(mine[c], pred.vec(c).to_numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(theirs[c], mine[c], atol=1e-6)
    if y != "yreg":
        assert list(mine["predict"]) == list(theirs["predict"])


def test_autoencoder_artifact(data):
    df, pf = data
    est = H2OAutoEncoderEstimator(hidden=(6,), epochs=2, seed=3)
    est.train(x=NUMS, training_frame=pf)
    raw = _mojo_bytes(est.model)
    recon = torch.stack([v.data for v in (est.predict(pf).vec(i)
                                          for i in range(10))], 1).numpy()
    mine = _load(pgen, raw).score_raw(
        {c: df[c].to_numpy() for c in NUMS})
    assert mine.shape == (len(df), 10)
    np.testing.assert_allclose(mine, recon, atol=1e-6)
    theirs = _load(jgen, raw).predict(df)["predict"]
    np.testing.assert_allclose(theirs, recon[:, 0], atol=1e-6)


def _jax_dl_numpy(jm) -> dict:
    """A JAX DeepLearning model's outputs as plain numpy / Python values,
    the input of ``dl_from_numpy``."""
    di = jm.output["datainfo"]
    return {
        "params": _np_tree(jm.output["params"]),
        "activation": jm.params.activation,
        "response_domain": jm.output["response_domain"],
        "names": jm.output["names"],
        "input_pad": jm.output.get("input_pad"),
        "datainfo": {
            "standardize": di.standardize,
            "use_all_factor_levels": di.use_all_factor_levels,
            "missing_handling": di.missing_handling,
            "add_intercept": di.add_intercept,
            "ncols_expanded": di.ncols_expanded,
            "hash_buckets": di.hash_buckets,
            "columns": [dict(name=c.name, kind=c.kind, mean=c.mean,
                             sigma=c.sigma, domain=list(c.domain),
                             offset=c.offset, width=c.width)
                        for c in di.columns]},
    }


def test_jax_model_carried_across(data, monkeypatch):
    """A JAX DL (13 design columns, its first kernel padded to 16) through
    ``dl_from_numpy``: predictions within 1e-6 of JAX's, and the port's
    export equal to JAX's own, array for array (W0 cut to 13 rows)."""
    monkeypatch.setenv("H2O3_TPU_DL_GRAD_SHARD", "0")
    df, pf = data
    jf = JFrame.from_pandas(df)
    jm = jdl.DeepLearning(**BASE).train(x=X_COLS, y="ymn", training_frame=jf)
    pm = dl_from_numpy(_jax_dl_numpy(jm),
                       params=dict(response_column="ymn", **BASE),
                       device="cpu")
    jp, pp = jm.predict(jf), pm.predict(pf)
    for c in ("u", "v", "w"):
        np.testing.assert_allclose(pp.vec(c).to_numpy(),
                                   np.asarray(jp.vec(c).to_numpy())[:len(df)],
                                   atol=1e-6)
    jbuf = io.BytesIO()
    jexport.export_mojo(jm, jbuf)
    mine, theirs = _load(pgen, _mojo_bytes(pm)), _load(pgen, jbuf.getvalue())
    assert sorted(mine.arrays) == sorted(theirs.arrays)
    assert mine.arrays["W0"].shape == (13, 16)
    for k in theirs.arrays:
        np.testing.assert_array_equal(mine.arrays[k], theirs.arrays[k])
    for k in ("activation", "n_layers", "response_domain"):
        assert mine.meta[k] == theirs.meta[k]


def test_kmeans_artifacts_still_refused():
    """K-means artifacts were refused until k-means was ported; they now
    load into the k-means scorer."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        z.writestr("model.json", json.dumps({"algo": "kmeans"}))
        ab = io.BytesIO()
        np.savez(ab)
        z.writestr("arrays.npz", ab.getvalue())
    m = pgen.MojoModel.load(io.BytesIO(buf.getvalue()))
    assert type(m).__name__ == "_KMeansMojo" and m.algo == "kmeans"
