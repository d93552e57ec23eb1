"""tmojo export in the port (``h2o3_tpu_torch.models.export``) and its
offline scorer (``h2o3_tpu_torch.genmodel``) against the JAX package's, on
the CPU at small sizes: artifacts the port writes, scored by the JAX
package's ``genmodel.MojoModel`` and by the port's copy; the bin codes of
both scorers against the port's ``bin_frame``; a JAX model carried across
and exported by the port against JAX's own export of it; the single-file
``export_pojo`` scorer in a subprocess.

Tolerances, with their reasons:
- scorer against ``predict``: probabilities within 1e-5 (the scorers add
  float32 leaves in float64, ``predict`` in float32; JAX's MOJO-parity
  tolerance);
- the two scorers, bin codes, and arrays of the same model: exact (the
  same numpy code on the same payload; the same float32 binning).
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import h2o3_tpu.genmodel as jgen  # noqa: E402
import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import export as jexport  # noqa: E402
from h2o3_tpu.models.tree import GBM as JGBM  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator  # noqa: E402
from h2o3_tpu_torch.models.export import export_pojo  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.binning import bin_frame  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import gbm_from_numpy  # noqa: E402
from test_torch_multinomial import multiclass_df  # noqa: E402
from test_torch_slice import _frame_df  # noqa: E402

_KW = dict(ntrees=3, max_depth=3, learn_rate=0.1, min_rows=10.0, seed=42)
_KINDS = {"binomial": (_frame_df, ("b", "s")),
          "multinomial": (multiclass_df, ("u", "v", "w"))}


@pytest.fixture(scope="module", params=list(_KINDS))
def trained(request):
    """A port model of each kind trained on the CPU, with its frame."""
    make, classes = _KINDS[request.param]
    df = make(n=2000, seed=0)
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    est = H2OGradientBoostingEstimator(**_KW)
    est.train(y="label", training_frame=fr)
    probs = np.stack([est.predict(fr).vec(c).to_numpy() for c in classes], 1)
    return request.param, df, fr, est, classes, probs


def _scored(mojo, df, classes):
    out = mojo.predict(df)
    return out, np.stack([out[c] for c in classes], 1)


def test_tmojo_scores_like_predict_in_both_scorers(trained, tmp_path):
    """download_mojo into a directory writes ``<model key>.zip``; JAX's
    scorer and the port's score it within 1e-5 of the port's predict, and
    agree with each other bit for bit (labels included)."""
    kind, df, fr, est, classes, probs = trained
    path = est.download_mojo(str(tmp_path))
    assert path == os.path.join(str(tmp_path), f"{est.model_id}.zip")
    jout, jp = _scored(jgen.MojoModel.load(path), df, classes)
    pout, pp = _scored(pgen.MojoModel.load(path), df, classes)
    np.testing.assert_allclose(pp, probs, atol=1e-5)
    np.testing.assert_allclose(jp, probs, atol=1e-5)
    assert jout.keys() == pout.keys()
    for k in jout:
        assert np.array_equal(jout[k], pout[k]), k
    labels = est.predict(fr).vec("predict").to_numpy()
    np.testing.assert_array_equal(pout["predict"],
                                  np.asarray(classes, object)[labels])
    meta = json.loads(zipfile.ZipFile(path).read("model.json"))
    assert meta["n_tree_classes"] == (3 if kind == "multinomial" else 1)
    assert np.ndim(meta["init_f"]) == (1 if kind == "multinomial" else 0)
    if kind == "binomial":  # the max-F1 threshold of the training metrics
        assert meta["default_threshold"] == \
            est.model.training_metrics.default_threshold


def test_bin_codes_equal_across_scorers_and_bin_frame(trained, tmp_path):
    """Both scorers' ``_bin_features`` give the codes the port's
    ``bin_frame`` gives, on a frame with NAs in every column and a level
    the training never saw."""
    kind, df, _, est, _, _ = trained
    path = est.download_mojo(str(tmp_path / "m.zip"))
    score = df.drop(columns="label").iloc[:300].copy()
    score.iloc[::7, :] = np.nan
    score.loc[score.index[1::5], "cat"] = "never-seen"
    codes = bin_frame(est.model.output["bin_spec"],
                      h2o3_tpu_torch.upload_file(score, device="cpu")).numpy()
    table = {c: score[c].to_numpy() for c in score.columns}
    for mod in (jgen, pgen):
        got = mod.MojoModel.load(path)._bin_features(table)
        np.testing.assert_array_equal(got, codes.astype(np.int64))


def _numpy_output(jm) -> dict:
    spec = jm.output["bin_spec"]
    return {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards", "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f)) for f in pst.REPLAY_FIELDS}
                    for lv in t.levels] for t in group]
                  for group in jm.output["trees"]],
        "init_f": jm.output["init_f"],
        "n_tree_classes": jm.output["n_tree_classes"],
        "distribution": jm.output["distribution"],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
    }


def _read(path):
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("model.json"))
        npz = np.load(io.BytesIO(z.read("arrays.npz")))
        return meta, {k: npz[k] for k in npz.files}


@pytest.mark.parametrize("kind", list(_KINDS))
def test_converted_jax_model_exports_as_jax_does(kind, tmp_path):
    """A JAX GBM carried across with gbm_from_numpy and exported by the
    port: ``arrays.npz`` equal to JAX's own export of that model key by key
    (dtype and bytes), ``model.json`` with the same keys and values. The
    one difference allowed is ``default_threshold``: a converted model has
    no training metrics, so the port writes None where JAX writes its
    max-F1 threshold."""
    make, _ = _KINDS[kind]
    df = make(n=2000, seed=0)
    jm = JGBM(**_KW).train(y="label", training_frame=JFrame.from_pandas(df))
    pm = gbm_from_numpy(_numpy_output(jm), device="cpu")
    pm.key, pm.params.response_column = jm.key, "label"  # its identity
    jpath, ppath = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
    jexport.export_mojo(jm, jpath)
    pm.download_mojo(ppath)
    (jmeta, jarr), (pmeta, parr) = _read(jpath), _read(ppath)
    assert jarr.keys() == parr.keys()
    for k in jarr:
        assert parr[k].dtype == jarr[k].dtype, k
        assert parr[k].tobytes() == jarr[k].tobytes(), k
    assert pmeta.keys() == jmeta.keys()
    assert pmeta["default_threshold"] is None
    for k in jmeta:
        if k != "default_threshold":
            assert pmeta[k] == jmeta[k], k


def test_export_pojo_scores_in_a_subprocess(trained, tmp_path):
    """The single-file scorer (the port's genmodel source plus the
    payload) run as ``python model.py data.csv`` in a fresh interpreter on
    1,000 rows: probabilities within 1e-5 of predict."""
    import pandas as pd

    kind, df, _, est, classes, probs = trained
    src = export_pojo(est.model, str(tmp_path / "model.py"))
    csv = tmp_path / "rows.csv"
    df.drop(columns="label").iloc[:1000].to_csv(csv, index=False)
    r = subprocess.run([sys.executable, src, str(csv)], capture_output=True,
                       text=True, timeout=120, cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr
    out = pd.read_csv(io.StringIO(r.stdout))
    assert list(out.columns) == ["predict", *classes]
    np.testing.assert_allclose(out[list(classes)].to_numpy(), probs[:1000],
                               atol=1e-5)


def test_scorer_refuses_unported_algorithms(tmp_path):
    """Deep-learning and k-means artifacts are not scored yet; GLM artifacts
    are, multinomial ones too since slice 9: an intercept-only multinomial
    GLM with zero coefficients gives every class 1/3."""
    buf = io.BytesIO()
    np.savez_compressed(buf, beta_multinomial_std=np.zeros((1, 3)))
    for algo in ("deeplearning", "kmeans", "glm"):
        path = tmp_path / f"{algo}.zip"
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("model.json", json.dumps({
                "algo": algo, "response_domain": ["a", "b", "c"],
                "datainfo": {"columns": [], "add_intercept": True,
                             "use_all_factor_levels": False,
                             "standardize": True, "hash_buckets": None}}))
            z.writestr("arrays.npz", buf.getvalue())
        if algo != "glm":
            with pytest.raises(NotImplementedError, match=algo):
                pgen.MojoModel.load(str(path))
            continue
        out = pgen.MojoModel.load(str(path)).predict({"x": [1.0, 2.0]})
        for c in "abc":
            np.testing.assert_allclose(out[c], 1 / 3)