"""Model persistence in the port (``h2o3_tpu_torch.persist``) against the
JAX package's (``h2o3_tpu/persist.py``), on the CPU at test size: save and
load round trips of every port model class, the file format (magic, a JAX
file and a truncated file refused by name, ``force``, directory naming),
the atomic publish, the retries of transient IO errors, the cloud schemes'
errors, and ``export_file`` against JAX's export of the same frame.

Tolerances, with their reasons:
- a round trip: predictions equal (the same tensors back on the same
  device, the same scoring code);
- error messages: JAX's text, with the package's name in the hint;
- exported frames: equal (both write the same float64 and label columns).
"""

import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import h2o3_tpu  # noqa: E402
from h2o3_tpu import persist as jpersist  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import persist  # noqa: E402
from h2o3_tpu_torch.models.deeplearning import DeepLearning  # noqa: E402
from h2o3_tpu_torch.models.ensemble import StackedEnsemble  # noqa: E402
from h2o3_tpu_torch.models.glm import GLM  # noqa: E402
from h2o3_tpu_torch.models.model_base import get_model, remove_model  # noqa: E402
from h2o3_tpu_torch.models.tree.drf import DRF  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM  # noqa: E402
from h2o3_tpu_torch.models.tree.xgboost import XGBoost  # noqa: E402

X = ["a", "b", "c", "d"]


def persist_df(n=600, seed=9) -> pd.DataFrame:
    """Three numeric features on a 0.1 grid (NAs in b), a categorical with
    an NA, a binary, a 3-class and an ordered 3-level response."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame(np.round(rng.normal(size=(n, 3)), 1).astype(np.float32),
                      columns=["a", "b", "c"])
    df.loc[rng.random(n) < 0.05, "b"] = np.nan
    d = rng.integers(0, 3, n)
    df["d"] = np.where(rng.random(n) < 0.03, None,
                       np.array(["x", "y", "z"])[d])
    lin = df["a"].to_numpy() - 0.7 * df["c"].to_numpy() + 0.5 * (d == 1)
    df["y"] = np.where(lin + rng.logistic(size=n) > 0, "pos", "neg")
    df["ymn"] = np.array(["u", "v", "w"])[np.digitize(
        lin + 0.4 * rng.normal(size=n), [-0.5, 0.5])]
    df["yord"] = np.array(["r1", "r2", "r3"])[np.digitize(
        lin + rng.logistic(size=n), [-1.0, 1.0])]
    return df


@pytest.fixture(scope="module")
def frames():
    df = persist_df()
    return df, h2o3_tpu_torch.upload_file(df, device="cpu")


def _cv(**kw):
    return dict(nfolds=3, keep_cross_validation_predictions=True, seed=3,
                **kw)


def _ensemble(pf):
    base = [GBM(ntrees=3, max_depth=2, **_cv()).train(x=X, y="y",
                                                       training_frame=pf),
            GLM(family="binomial", **_cv()).train(x=X, y="y",
                                                  training_frame=pf)]
    return StackedEnsemble(base_models=[m.key for m in base]).train(
        y="y", training_frame=pf)


CASES = {
    "gbm": lambda pf: GBM(ntrees=4, max_depth=3, seed=2).train(
        x=X, y="y", training_frame=pf),
    "gbm_multinomial": lambda pf: GBM(ntrees=3, max_depth=3).train(
        x=X, y="ymn", training_frame=pf),
    "xgboost": lambda pf: XGBoost(ntrees=3, max_depth=3, reg_alpha=0.5).train(
        x=X, y="y", training_frame=pf),
    "drf": lambda pf: DRF(ntrees=3, max_depth=5, seed=1).train(
        x=X, y="y", training_frame=pf),
    "glm_binomial": lambda pf: GLM(family="binomial", lambda_=1e-3).train(
        x=X, y="y", training_frame=pf),
    "glm_multinomial": lambda pf: GLM(family="multinomial").train(
        x=X, y="ymn", training_frame=pf),
    "glm_ordinal": lambda pf: GLM(family="ordinal").train(
        x=X, y="yord", training_frame=pf),
    "dl": lambda pf: DeepLearning(hidden=(6,), epochs=2, seed=2).train(
        x=X, y="ymn", training_frame=pf),
    "autoencoder": lambda pf: DeepLearning(
        hidden=(3,), epochs=2, seed=2, autoencoder=True).train(
        x=X, training_frame=pf),
    "gbm_cv": lambda pf: GBM(ntrees=3, max_depth=2, **_cv()).train(
        x=X, y="y", training_frame=pf),
    "ensemble": _ensemble,
}


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_predicts_equal(frames, case, tmp_path):
    """Save, drop from the registry, load on the CPU: the same class, key,
    parameters, metrics and predictions; a CV'd model keeps its fold models
    and holdout predictions; a loaded ensemble predicts with its base
    models dropped from the registry."""
    _, pf = frames
    m = CASES[case](pf)
    before = m._predict_raw(pf)
    path = h2o3_tpu_torch.save_model(m, str(tmp_path) + "/")
    assert os.path.basename(path) == m.key
    remove_model(m.key)
    if case == "ensemble":
        for k in m.output["base_model_keys"]:
            remove_model(k)
    m2 = h2o3_tpu_torch.load_model(path, device="cpu")
    assert type(m2) is type(m) and m2.key == m.key and m2 is not m
    assert get_model(m.key) is m2
    assert torch.equal(m2._predict_raw(pf), before)
    tm, tm2 = m.training_metrics, m2.training_metrics
    assert tm2.to_dict() == tm.to_dict() if case != "autoencoder" else \
        tm2._v == tm._v
    assert m2.scoring_history == m.scoring_history
    assert m2.params.training_frame == pf.key  # a key, not the frame
    if case == "gbm_cv":
        assert len(m2.cv_models) == 3
        assert torch.equal(m2.cv_predictions, m.cv_predictions)
        assert m2.cross_validation_metrics.auc == \
            m.cross_validation_metrics.auc
        for a, b in zip(m.cv_models, m2.cv_models):
            assert torch.equal(a._predict_raw(pf), b._predict_raw(pf))
    if case == "ensemble":
        assert all(get_model(k) is None for k in m.output["base_model_keys"])
        assert [b.key for b in m2.base_models] == m.output["base_model_keys"]
        assert m2.params.base_models == m.output["base_model_keys"]


def test_trees_stay_host_numpy_and_drop_device_caches(frames, tmp_path):
    """Tree records load as host numpy (each tree's per-device replay
    cache is not saved); a DeepLearning network comes back as an ``MLP``
    on the load device with its optimizer state."""
    _, pf = frames
    m = CASES["gbm"](pf)
    m._predict_raw(pf)  # fills the trees' replay caches
    assert "_on_device" in m.output["trees"][0][0].__dict__
    m2 = persist.load_model(persist.save_model(m, str(tmp_path / "g")),
                            device="cpu")
    t = m2.output["trees"][0][0]
    assert "_on_device" not in t.__dict__ or not t.__dict__["_on_device"]
    assert all(isinstance(lv.split_col, np.ndarray) for lv in t.levels)
    d = CASES["dl"](pf)
    d2 = persist.load_model(persist.save_model(d, str(tmp_path / "d")),
                            device="cpu")
    assert type(d2.output["net"]) is type(d.output["net"])
    for name, v in d.output["opt_state"].items():
        assert torch.equal(d2.output["opt_state"][name], v)


def test_file_format(frames, tmp_path):
    """The port's magic; a JAX model file and a truncated file each raise
    a named ValueError; ``force=False`` refuses an existing target; a
    directory (existing, or a path ending in ``/``) names the file after
    the model key."""
    df, pf = frames
    m = CASES["gbm"](pf)
    p = persist.save_model(m, str(tmp_path / "new") + "/")
    assert p == str(tmp_path / "new" / m.key)
    with open(p, "rb") as f:
        blob = f.read()
    assert blob.startswith(persist.FORMAT_MAGIC)
    assert persist.FORMAT_MAGIC != jpersist.FORMAT_MAGIC
    assert persist.save_model(m, str(tmp_path / "new")) == p  # existing dir
    with pytest.raises(FileExistsError):
        persist.save_model(m, p, force=False)
    persist.save_model(m, str(tmp_path / "named.bin"))
    assert os.path.exists(tmp_path / "named.bin")
    trunc = tmp_path / "trunc"
    trunc.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="corrupt or truncated"):
        persist.load_model(str(trunc), device="cpu")
    jm = JGBM(ntrees=2, max_depth=2).train(x=X, y="y",
                                           training_frame=JFrame.from_pandas(df))
    jp = jpersist.save_model(jm, str(tmp_path / "jax") + "/")
    with pytest.raises(ValueError, match="JAX package"):
        persist.load_model(jp, device="cpu")
    (tmp_path / "other").write_bytes(b"PK\x03\x04 not a model")
    with pytest.raises(ValueError, match="not an h2o3_tpu_torch model file"):
        persist.load_model(str(tmp_path / "other"), device="cpu")


def test_write_is_atomic(tmp_path):
    """An exception inside the write leaves no file at the target and no
    temp file beside it; a clean write publishes the bytes."""
    backend, p = persist._backend_for(str(tmp_path / "x.bin"))
    with pytest.raises(RuntimeError):
        with backend.open_write(p) as f:
            f.write(b"partial")
            raise RuntimeError("crash mid-write")
    assert os.listdir(tmp_path) == []
    persist.write_bytes(b"whole", str(tmp_path / "x.bin"))
    assert os.listdir(tmp_path) == ["x.bin"]
    assert persist.read_bytes(str(tmp_path / "x.bin")) == b"whole"


def test_transient_errors_retried_deterministic_fail_at_once(
        tmp_path, monkeypatch):
    """A transient OSError is retried ``H2O3_TPU_PERSIST_RETRIES`` times
    (then succeeds, or surfaces on the last attempt), while
    FileNotFoundError fails on the first attempt: injected in the FS
    backend's ``open_write``."""
    monkeypatch.setenv("H2O3_TPU_PERSIST_RETRIES", "3")
    monkeypatch.setenv("H2O3_TPU_PERSIST_BACKOFF", "0")
    backend, _ = persist._backend_for(str(tmp_path))
    real = type(backend).open_write
    calls = []

    def flaky(fail_times, exc):
        def open_write(self, path):
            calls.append(path)
            if len(calls) <= fail_times:
                raise exc
            return real(self, path)
        return open_write

    monkeypatch.setattr(type(backend), "open_write",
                        flaky(2, OSError(5, "EIO")))
    persist.write_bytes(b"ok", str(tmp_path / "a"))
    assert len(calls) == 3 and (tmp_path / "a").read_bytes() == b"ok"
    calls.clear()
    monkeypatch.setattr(type(backend), "open_write",
                        flaky(10, OSError(5, "EIO")))
    with pytest.raises(OSError):
        persist.write_bytes(b"no", str(tmp_path / "b"))
    assert len(calls) == 4  # the first attempt and 3 retries
    calls.clear()
    monkeypatch.setattr(type(backend), "open_write",
                        flaky(10, FileNotFoundError("gone")))
    with pytest.raises(FileNotFoundError):
        persist.write_bytes(b"no", str(tmp_path / "c"))
    assert len(calls) == 1
    assert persist._retry_delays("w") == jpersist._retry_delays("w")


def test_cloud_scheme_without_sdk_and_unknown_scheme(monkeypatch):
    """``s3:`` without boto3 and an unknown scheme raise JAX's messages
    (the hint names the port's ``register_backend``). The message lists
    the registered schemes, so both registries hold only their built-in
    backends here (another test may have registered one more in this
    process: ``tests/test_infra_r3.py`` registers JAX's ``mem``)."""
    for mod in (persist, jpersist):
        monkeypatch.setattr(mod, "_BACKENDS", {
            k: v for k, v in mod._BACKENDS.items() if k in ("", "file")})
    for uri in ("s3://bucket/model", "nosuch://x/y"):
        with pytest.raises(ValueError) as pe:
            persist._backend_for(uri)
        with pytest.raises(ValueError) as je:
            jpersist._backend_for(uri)
        assert str(pe.value) == str(je.value).replace(
            "h2o3_tpu.persist", "h2o3_tpu_torch.persist")


def test_export_file_matches_jax(frames, tmp_path):
    """``export_file`` writes the frame as JAX's ``export_file`` writes
    the same frame, as CSV and as Parquet; ``force=False`` refuses an
    existing file."""
    df, pf = frames
    jf = JFrame.from_pandas(df)
    for ext in ("csv", "parquet"):
        pp, jp = str(tmp_path / f"p.{ext}"), str(tmp_path / f"j.{ext}")
        h2o3_tpu_torch.export_file(pf, pp)
        h2o3_tpu.export_file(jf, jp)
        read = pd.read_csv if ext == "csv" else pd.read_parquet
        pd.testing.assert_frame_equal(read(pp), read(jp))
        with pytest.raises(FileExistsError):
            h2o3_tpu_torch.export_file(pf, pp)
    with open(tmp_path / "p.csv") as a, open(tmp_path / "j.csv") as b:
        assert a.read() == b.read()
    pd.testing.assert_frame_equal(pf.to_pandas(), jf.to_pandas())
