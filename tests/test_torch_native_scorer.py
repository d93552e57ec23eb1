"""The offline scorer's native tree walk (``h2o3_tpu_torch.native_tmojo``,
``native/tmojo_score.cpp``) against its numpy level replay
(``h2o3_tpu_torch.genmodel``), on the CPU, at small sizes, inputs made with
numpy from seeds.

Both walks add the float32 leaves into float64 tree by tree in export
order, so they are held to the bit: every score column of the GBM
(binomial and multinomial), DRF, XGBoost, EFB-trained, bin-coarsened,
lossguide and calibrated GBM artifacts, with ``genmodel.SCORE_LANES``
showing which walk ran. The native cases skip where ``g++`` is absent.
Also: JAX's k-means artifact and the port's score the same through the
port's scorer, and the ``export_pojo`` file, which embeds the scorer's
source, still scores standalone in numpy.
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import genmodel as pgen  # noqa: E402
from h2o3_tpu_torch import native_tmojo  # noqa: E402
from h2o3_tpu_torch.datasets import covtype_like, higgs_like  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OGradientBoostingEstimator,
    H2OKMeansEstimator,
    H2ORandomForestEstimator,
    H2OXGBoostEstimator,
)
from h2o3_tpu_torch.models.export import export_pojo  # noqa: E402
from h2o3_tpu_torch.models.tree import binning as pbin  # noqa: E402

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the native walk is built by g++")

_KW = dict(ntrees=5, max_depth=4, seed=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _onehot_df(n=1500, levels=8, seed=4) -> pd.DataFrame:
    """One-hot columns of an 8-level factor (which EFB bundles), two
    numeric columns and a binary label."""
    rng = np.random.default_rng(seed)
    lv = rng.integers(0, levels, n)
    df = pd.DataFrame({f"oh{k}": (lv == k).astype(np.float32)
                       for k in range(levels)})
    df["num0"] = rng.normal(size=n).astype(np.float32)
    df["num1"] = rng.normal(size=n).astype(np.float32)
    y = (lv % 3 == 0) ^ (df["num0"].to_numpy() > 0.5)
    df["label"] = pd.Categorical.from_codes(y.astype(int), ["b", "s"])
    return df


def _train(kind):
    """(model, scoring rows) of one artifact kind, trained on the CPU."""
    df = higgs_like(1500, 8, seed=2)
    env, y = {}, "label"
    if kind == "gbm":
        est = H2OGradientBoostingEstimator(**_KW)
    elif kind == "multinomial":
        df = covtype_like(1500, seed=2).iloc[:, [0, 1, 2, 5, 9, 10, 11]
                                              + [54]]
        y = "cover_type"
        est = H2OGradientBoostingEstimator(**_KW)
    elif kind == "drf":
        est = H2ORandomForestEstimator(ntrees=5, max_depth=6, seed=1)
    elif kind == "xgboost":
        est = H2OXGBoostEstimator(**_KW)
    elif kind == "efb":
        df, env = _onehot_df(), {"H2O3_TPU_TREE_EFB": "1"}
        est = H2OGradientBoostingEstimator(**_KW)
    elif kind == "coarsened":
        env = {"H2O3_TPU_BIN_ADAPT": "1"}
        est = H2OGradientBoostingEstimator(ntrees=3, max_depth=6, seed=1)
    elif kind == "lossguide":
        est = H2OGradientBoostingEstimator(grow_policy="lossguide",
                                           max_leaves=7, **_KW)
    else:  # calibrated
        cal = h2o3_tpu_torch.upload_file(higgs_like(800, 8, seed=3),
                                         device="cpu")
        est = H2OGradientBoostingEstimator(
            calibrate_model=True, calibration_frame=cal,
            calibration_method="IsotonicRegression", **_KW)
    efb_before = pbin.EFB_EVENTS["plans"]
    with _env(**env):
        est.train(y=y, training_frame=h2o3_tpu_torch.upload_file(
            df, device="cpu"))
    if kind == "efb":
        assert pbin.EFB_EVENTS["plans"] > efb_before  # columns bundled
    return est, df.drop(columns=y)


_KINDS = ["gbm", "multinomial", "drf", "xgboost", "efb", "coarsened",
          "lossguide", "calibrated"]


@needs_gxx
@pytest.mark.parametrize("kind", _KINDS)
def test_native_walk_bit_equal_to_numpy(kind, tmp_path):
    est, rows = _train(kind)
    path = est.download_mojo(str(tmp_path))
    before = dict(pgen.SCORE_LANES)
    native = pgen.MojoModel.load(path).predict(rows)
    assert pgen.SCORE_LANES["native"] == before["native"] + 1
    with _env(H2O3_TPU_NATIVE="0"):
        plain = pgen.MojoModel.load(path).predict(rows)
    assert pgen.SCORE_LANES["numpy"] == before["numpy"] + 1
    assert native.keys() == plain.keys()
    for k in native:
        np.testing.assert_array_equal(native[k], plain[k])
    if kind == "calibrated":
        assert "cal_p1" in native
    # and the bins the native binning gives equal numpy's searchsorted
    m = pgen.MojoModel.load(path)
    table = m._rows_to_table(rows)
    nat_bins = m._bin_features(table)
    with _env(H2O3_TPU_NATIVE="0"):
        np.testing.assert_array_equal(nat_bins, m._bin_features(table))


@needs_gxx
def test_library_built_under_the_package_build_dir():
    assert native_tmojo.enabled()
    assert native_tmojo.BUILD_ERROR is None
    built = [p for p in native_tmojo.BUILD_DIR.glob("libtmojo_*.so")]
    assert built and all(p.parent == native_tmojo.BUILD_DIR for p in built)
    with _env(H2O3_TPU_NATIVE="0"):
        assert not native_tmojo.enabled()
        assert pgen._native_mod() is None


def test_jax_and_port_kmeans_artifacts_score_the_same(tmp_path):
    """JAX's k-means tmojo and the port's, of models trained on one frame
    from one seed, scored by the port's scorer: the same cluster ids."""
    import jax

    from h2o3_tpu.frame.frame import Frame as JFrame
    from h2o3_tpu.models import export as jexport
    from h2o3_tpu.models.kmeans import KMeans as JKMeans

    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    try:
        rng = np.random.default_rng(7)
        X = rng.normal(size=(800, 4)) + 4 * rng.integers(0, 3, (800, 1))
        df = pd.DataFrame(X, columns=list("abcd"))
        jm = JKMeans(k=3, seed=2).train(training_frame=JFrame.from_pandas(df))
        jpath = jexport.export_mojo(jm, str(tmp_path / "jax.zip"))
    finally:
        jax.config.update(key, old)
    est = H2OKMeansEstimator(k=3, seed=2)
    est.train(training_frame=h2o3_tpu_torch.upload_file(df, device="cpu"))
    ppath = est.download_mojo(str(tmp_path / "port.zip"))
    got_j = pgen.MojoModel.load(jpath).predict(df)["cluster"]
    got_p = pgen.MojoModel.load(ppath).predict(df)["cluster"]
    np.testing.assert_array_equal(got_j, got_p)
    want = est.predict(h2o3_tpu_torch.upload_file(df, device="cpu")).vec(
        "predict").to_numpy()
    np.testing.assert_array_equal(got_p, want)


def test_export_pojo_still_scores_standalone_in_numpy(tmp_path):
    """The single-file scorer imported in a fresh interpreter outside the
    package: no native module is found, the numpy walk scores, and its
    scores equal the package's (native) scorer's to the bit."""
    est, rows = _train("gbm")
    src = export_pojo(est.model, str(tmp_path / "model.py"))
    rows.iloc[:300].to_csv(tmp_path / "rows.csv", index=False)
    code = (
        "import sys, csv, json\n"
        "sys.path.insert(0, '.')\n"
        "import model\n"
        "rows = list(csv.DictReader(open('rows.csv')))\n"
        "table = {k: [r[k] for r in rows] for k in rows[0]}\n"
        "out = model.MODEL.predict(table)\n"
        "print(json.dumps({'lanes': model.SCORE_LANES,\n"
        "                  'native': model._native_mod() is not None,\n"
        "                  's': [float(v).hex() for v in out['s']]}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    import json

    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["native"] is False
    assert got["lanes"] == {"native": 0, "numpy": 1}
    assert os.path.basename(src) == "model.py"
    table = pd.read_csv(io.StringIO((tmp_path / "rows.csv").read_text()))
    want = pgen.MojoModel.load(est.download_mojo(str(tmp_path)))
    want_s = want.predict({k: table[k].to_numpy() for k in table.columns})
    np.testing.assert_array_equal(
        np.array([float.fromhex(h) for h in got["s"]]), want_s["s"])
