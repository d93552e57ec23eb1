"""Checkpoints in the port against the JAX package's, on the CPU at test
size: every case of JAX's ``tests/test_checkpoint.py`` (GBM, sampled GBM
and DRF resumed as an uninterrupted run, the refusals, DeepLearning epochs
continued, a grid recovered from its checkpoint directory), GLM resumed
from an interval snapshot (binomial with a lambda search, and
multinomial), AutoML recovered from its manifest and its poison-step
guard, and the snapshots a directory receives.

Tolerances, with their reasons:
- a resumed model against the port's uninterrupted run: GBM logloss 1e-6
  and rows 1e-5 (JAX's bounds: the resumed scores are the init score plus
  the prior's trees replayed, summed in another order than the running
  scores); DRF AUC 1e-6 with every split equal; GLM and DeepLearning
  equal (the loop restarts from the state it stopped in);
- against JAX's resumed model: trees equal but for float near-ties
  (``tools/tree_parity.divergences``), metrics 1e-5; GLM coefficients
  1e-4 absolute and iterations equal (``test_torch_glm.py``'s whole-
  training bounds); DeepLearning weights 1e-5 relative from JAX's initial
  weights (``test_torch_deeplearning.py``);
- refusals: JAX's messages.
"""

import os
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

from h2o3_tpu import persist as jpersist  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import deeplearning as jdl  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu.models.tree.drf import DRF as JDRF  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import persist  # noqa: E402
from h2o3_tpu_torch.automl import automl as pam  # noqa: E402
from h2o3_tpu_torch.models import deeplearning as pdl  # noqa: E402
from h2o3_tpu_torch.models.glm import GLM  # noqa: E402
from h2o3_tpu_torch.models.grid import GridSearch, load_grid  # noqa: E402
from h2o3_tpu_torch.models.model_base import get_model  # noqa: E402
from h2o3_tpu_torch.models.tree.drf import DRF  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM  # noqa: E402
from h2o3_tpu_torch.tools.tree_parity import divergences  # noqa: E402


def ck_df(n=2500, seed=3) -> pd.DataFrame:
    """JAX's ``tests/test_checkpoint.py`` frame with its normals on a 0.1
    grid (float near-ties otherwise part the packages' trees, as in
    ``test_torch_cv.py``)."""
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "a": np.round(rng.normal(size=n), 1).astype(np.float32),
        "b": np.round(rng.normal(size=n), 1).astype(np.float32),
        "c": rng.choice(["x", "y", "z"], n),
    })
    eta = df["a"] * 1.5 + (df["c"] == "x") * 2 - df["b"]
    df["y"] = np.where(eta + rng.normal(size=n) > 0, "p", "n")
    df["m"] = np.array(["u", "v", "w"])[np.digitize(
        eta + rng.normal(size=n), [-0.5, 1.0])]
    return df


@pytest.fixture(scope="module")
def frames():
    df = ck_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


def _p(model, frame, col="p"):
    return model.predict(frame).vec(col).to_numpy()


def _resumed(builder, kw, part_n, full_n, frame, y="y"):
    part = builder(ntrees=part_n, **kw).train(y=y, training_frame=frame)
    return part, builder(ntrees=full_n, checkpoint=part.key, **kw).train(
        y=y, training_frame=frame)


def test_gbm_resume_equals_uninterrupted_and_jax(frames):
    """JAX's ``test_gbm_checkpoint_resume_identical_to_uninterrupted`` in
    the port, and the port's resumed model against JAX's."""
    _, jf, pf = frames
    kw = dict(max_depth=3, seed=11, learn_rate=0.2, score_tree_interval=100)
    full = GBM(ntrees=10, **kw).train(y="y", training_frame=pf)
    _, res = _resumed(GBM, kw, 4, 10, pf)
    assert res.output["ntrees_actual"] == 10
    np.testing.assert_allclose(res.training_metrics.logloss,
                               full.training_metrics.logloss, atol=1e-6)
    np.testing.assert_allclose(_p(res, pf), _p(full, pf), atol=1e-5)
    _, jres = _resumed(JGBM, kw, 4, 10, jf)
    d = divergences(SimpleNamespace(model=res), SimpleNamespace(model=jres))
    assert d is not None
    np.testing.assert_allclose(res.training_metrics.logloss,
                               jres.training_metrics.logloss, atol=1e-5)
    np.testing.assert_allclose(_p(res, pf), _p(jres, jf), atol=1e-5)


def test_gbm_resume_with_sampling_and_multinomial(frames):
    """JAX's ``test_gbm_checkpoint_with_sampling_resumes_exactly`` in the
    port (the keyed row and column draws go on at the prior's iteration),
    and a multinomial GBM resumed, each against its uninterrupted run."""
    _, _, pf = frames
    kw = dict(max_depth=3, seed=17, sample_rate=0.7, col_sample_rate=0.8,
              score_tree_interval=100)
    full = GBM(ntrees=8, **kw).train(y="y", training_frame=pf)
    _, res = _resumed(GBM, kw, 3, 8, pf)
    np.testing.assert_allclose(res.training_metrics.logloss,
                               full.training_metrics.logloss, atol=1e-6)
    kw = dict(max_depth=3, seed=5, score_tree_interval=2)
    full = GBM(ntrees=6, **kw).train(y="m", training_frame=pf)
    _, res = _resumed(GBM, kw, 2, 6, pf, y="m")
    assert len(res.output["trees"]) == 6 and len(res.output["trees"][0]) == 3
    np.testing.assert_allclose(res.training_metrics.logloss,
                               full.training_metrics.logloss, atol=1e-6)
    np.testing.assert_allclose(_p(res, pf, "u"), _p(full, pf, "u"), atol=1e-5)


def test_drf_resume_adds_trees(frames):
    """JAX's ``test_drf_checkpoint_adds_trees`` in the port (every split of
    the resumed forest equal to the uninterrupted one's), and with no
    draws against JAX's resumed forest."""
    _, jf, pf = frames
    kw = dict(max_depth=6, seed=9, score_tree_interval=100)
    _, res = _resumed(DRF, kw, 3, 7, pf)
    full = DRF(ntrees=7, **kw).train(y="y", training_frame=pf)
    assert res.output["ntrees_actual"] == 7
    np.testing.assert_allclose(res.training_metrics.auc,
                               full.training_metrics.auc, atol=1e-6)
    for ga, gb in zip(res.output["trees"], full.output["trees"]):
        for la, lb in zip(ga[0].levels, gb[0].levels):
            np.testing.assert_array_equal(la.split_col, lb.split_col)
            np.testing.assert_array_equal(la.split_bin, lb.split_bin)
    kw = dict(max_depth=4, seed=9, sample_rate=1.0, mtries=-2,
              score_tree_interval=100)
    _, res = _resumed(DRF, kw, 2, 4, pf)
    _, jres = _resumed(JDRF, kw, 2, 4, jf)
    divergences(SimpleNamespace(model=res), SimpleNamespace(model=jres),
                boosted=False)
    np.testing.assert_allclose(res.training_metrics.auc,
                               jres.training_metrics.auc, atol=1e-5)


def test_checkpoint_validation_rejects_changed_params(frames):
    """JAX's ``test_checkpoint_validation_rejects_changed_params``: the
    port raises JAX's messages."""
    _, jf, pf = frames
    msgs = []
    for cls, fr in ((GBM, pf), (JGBM, jf)):
        part = cls(ntrees=3, max_depth=3, seed=1).train(y="y",
                                                        training_frame=fr)
        got = []
        for kw in (dict(ntrees=6, max_depth=5), dict(ntrees=2, max_depth=3)):
            # JAX's job wraps the builder's ValueError; its last line
            with pytest.raises(Exception) as e:
                cls(seed=1, checkpoint=part.key, **kw).train(
                    y="y", training_frame=fr)
            got.append(str(e.value).strip().splitlines()[-1]
                       .removeprefix("ValueError: "))
        msgs.append(got)
    assert "max_depth" in msgs[0][0] and "ntrees" in msgs[0][1]
    assert msgs[0] == msgs[1]


def _np_tree(params) -> dict:
    if hasattr(params, "items"):
        return {k: _np_tree(v) for k, v in params.items()}
    return np.asarray(params)


def test_deeplearning_checkpoint_continues_epochs(frames, monkeypatch):
    """JAX's ``test_deeplearning_checkpoint_continues_epochs``: 2 epochs,
    then resumed to 5; the port from JAX's initial weights, its resumed
    weights against JAX's resumed ones and against its own uninterrupted
    5 epochs; the autoencoder resumes likewise."""
    monkeypatch.setenv("H2O3_TPU_DL_GRAD_SHARD", "0")
    _, jf, pf = frames
    seen = []
    orig = jdl._run_sync_sgd

    def spy(job, p, mlp, kind, tx, params, *a, **k):
        seen.append(_np_tree(params))
        return orig(job, p, mlp, kind, tx, params, *a, **k)

    monkeypatch.setattr(jdl, "_run_sync_sgd", spy)
    kw = dict(hidden=[8], seed=4, mini_batch_size=64)
    jpart = jdl.DeepLearning(epochs=2, **kw).train(y="y", training_frame=jf)
    jres = jdl.DeepLearning(epochs=5, checkpoint=jpart.key, **kw).train(
        y="y", training_frame=jf)
    monkeypatch.setattr(pdl.DeepLearning, "_initial_net",
                        lambda self, d_in, d_pad, n_out, dev:
                        pdl.mlp_from_numpy(seen[0], self.params.activation,
                                           dev))
    part = pdl.DeepLearning(epochs=2, **kw).train(y="y", training_frame=pf)
    res = pdl.DeepLearning(epochs=5, checkpoint=part.key, **kw).train(
        y="y", training_frame=pf)
    full = pdl.DeepLearning(epochs=5, **kw).train(y="y", training_frame=pf)
    assert res.output["epochs_trained"] == 5
    assert len(res.scoring_history) == 3  # only the 3 new epochs ran
    assert [h["epoch"] for h in res.scoring_history] == \
        [h["epoch"] for h in jres.scoring_history]
    assert res.training_metrics.logloss <= part.training_metrics.logloss + 0.05
    tree = _np_tree(jres.output["params"])["params"]
    for i, d in enumerate(res.output["net"].dense()):
        for a, b in ((d.weight.numpy().T, tree[f"Dense_{i}"]["kernel"]),
                     (d.bias.numpy(), tree[f"Dense_{i}"]["bias"])):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=1e-5 * np.abs(b).max())
    for a, b in zip(res.output["net"].tensors(), full.output["net"].tensors()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="epochs > 5"):
        pdl.DeepLearning(epochs=5, checkpoint=res.key, **kw).train(
            y="y", training_frame=pf)
    monkeypatch.undo()
    ae = dict(hidden=[2], seed=4, autoencoder=True)
    part = pdl.DeepLearning(epochs=1, **ae).train(x=["a", "b", "c"],
                                                  training_frame=pf)
    res = pdl.DeepLearning(epochs=3, checkpoint=part.key, **ae).train(
        x=["a", "b", "c"], training_frame=pf)
    full = pdl.DeepLearning(epochs=3, **ae).train(x=["a", "b", "c"],
                                                  training_frame=pf)
    for a, b in zip(res.output["net"].tensors(), full.output["net"].tensors()):
        assert torch.equal(a, b)


def test_grid_checkpoint_dir_resume(frames, tmp_path):
    """JAX's ``test_grid_checkpoint_dir_resume`` in the port: the models
    dropped from the registry, the same grid recovers every model from
    its directory, and ``load_grid`` rebuilds the grid cold."""
    _, _, pf = frames
    ckdir = str(tmp_path / "grid_ck")

    def grid():
        return GridSearch(GBM, {"max_depth": [2, 3]}, grid_id="g_ck", seed=2,
                          ntrees=3, export_checkpoints_dir=ckdir)

    g1 = grid().train(y="y", training_frame=pf)
    assert len(g1.models) == 2
    built = [m.key for m in g1.models]
    for k in built:
        h2o3_tpu_torch.remove(k)
    g2 = grid().train(y="y", training_frame=pf)
    assert sorted(m.key for m in g2.models) == sorted(built)
    for a, b in zip(g1.models, g2.models):
        assert a is not b
        np.testing.assert_array_equal(_p(a, pf), _p(b, pf))
    for k in built:
        h2o3_tpu_torch.remove(k)
    g3 = load_grid(ckdir, "g_ck", device="cpu")
    assert len(g3.models) == 2 and g3.best_model() is not None
    assert g3.hyper_values == [{"max_depth": 2}, {"max_depth": 3}]


def _snapshots(monkeypatch, module) -> list:
    """The bytes of every interval snapshot ``module``'s persist writes
    (the directory keeps only the latest)."""
    got = []
    orig = module.write_model_bytes

    def keep(data, backend, p, key, *a):
        if "_ckpt" in key:
            got.append(data)
        return orig(data, backend, p, key, *a)

    monkeypatch.setattr(module, "write_model_bytes", keep)
    return got


@pytest.mark.parametrize("family,y,kw", [
    ("binomial", "y", dict(lambda_search=True, nlambdas=3)),
    ("binomial", "y", dict(lambda_=1e-3, alpha=0.5)),
    ("multinomial", "m", dict()),
], ids=["lambda_search", "admm", "multinomial"])
def test_glm_resume_from_snapshot(frames, tmp_path, monkeypatch, family, y,
                                  kw):
    """An IRLSM fit with ``export_checkpoints_dir`` snapshots each
    iteration; resumed from a middle snapshot, the port ends where its
    uninterrupted fit ends and where JAX's fit resumed from JAX's snapshot
    of the same position ends."""
    _, jf, pf = frames
    x = ["a", "b", "c"]
    kw = dict(family=family, **kw)
    out = {}
    for name, cls, fr, mod in (("port", GLM, pf, persist),
                               ("jax", JGLM, jf, jpersist)):
        full = cls(**kw).train(x=x, y=y, training_frame=fr)
        with monkeypatch.context() as mp:
            snaps = _snapshots(mp, mod)
            cls(export_checkpoints_dir=str(tmp_path / name), **kw).train(
                x=x, y=y, training_frame=fr)
        assert len(snaps) >= 3
        path = str(tmp_path / f"{name}_snap")
        with open(path, "wb") as f:
            f.write(snaps[len(snaps) // 2])
        res = cls(checkpoint=path, **kw).train(x=x, y=y, training_frame=fr)
        out[name] = (full, res, len(snaps))
    (pfull, pres, pn), (_, jres, jn) = out["port"], out["jax"]
    assert pn == jn
    coef = "beta_multinomial_std" if family == "multinomial" else "beta_std"
    np.testing.assert_array_equal(pres.output[coef], pfull.output[coef])
    np.testing.assert_allclose(pres.output[coef], jres.output[coef],
                               atol=1e-4)
    if family != "multinomial":
        assert [e["iters"] for e in pres.regularization_path] == \
            [e["iters"] for e in jres.output["regularization_path"]]
        np.testing.assert_allclose(pres.residual_deviance,
                                   jres.output["residual_deviance"],
                                   rtol=1e-5)


def test_snapshots_and_recovery_pointer(frames, tmp_path):
    """A GBM with ``export_checkpoints_dir``: one interval snapshot file
    (overwritten each interval) beside the finished model, the builder's
    recovery pointer at it, and a resume from that file path equal to the
    uninterrupted run; fold models save nothing."""
    _, _, pf = frames
    kw = dict(max_depth=3, seed=1, score_tree_interval=2)
    b = GBM(ntrees=6, export_checkpoints_dir=str(tmp_path), **kw)
    m = b.train(y="y", training_frame=pf)
    rec = b.recovery
    assert sorted(os.listdir(tmp_path)) == sorted([m.key,
                                                   rec["checkpoint_key"]])
    assert get_model(rec["checkpoint_key"]) is None
    snap = persist.load_model(rec["checkpoint_path"], device="cpu")
    assert snap.output["ntrees_actual"] == 6
    res = GBM(ntrees=10, checkpoint=rec["checkpoint_path"], **kw).train(
        y="y", training_frame=pf)
    full = GBM(ntrees=10, **kw).train(y="y", training_frame=pf)
    np.testing.assert_allclose(res.training_metrics.logloss,
                               full.training_metrics.logloss, atol=1e-6)
    cvdir = tmp_path / "cv"
    cvm = GBM(ntrees=2, nfolds=2, export_checkpoints_dir=str(cvdir),
              **kw).train(y="y", training_frame=pf)
    assert [f for f in os.listdir(cvdir) if "model" in f] == [cvm.key]


def _aml(ckdir, **kw):
    kw = {"nfolds": 2, **kw}
    return pam.AutoML(max_models=3, seed=7,
                      include_algos=["GBM", "GLM", "StackedEnsemble"],
                      export_checkpoints_dir=ckdir, **kw)


@pytest.fixture(scope="module")
def small(frames):
    """The first 600 rows: AutoML runs several plans per test."""
    df, _, _ = frames
    return h2o3_tpu_torch.upload_file(df.iloc[:600].reset_index(drop=True),
                                      device="cpu",
                                      destination_frame="ck_small")


_PLAN = pam._default_plan


def _small_plan():
    """The default plan with its tree presets cut to 5 trees of depth 3."""
    steps = _PLAN()
    for st in steps:
        if st.kind == "model" and st.algo in ("gbm", "xgboost", "drf", "xrt"):
            st.params.update(ntrees=5, max_depth=min(
                st.params.get("max_depth", 3), 3))
    return steps


def test_automl_recovers_from_manifest(small, tmp_path, monkeypatch):
    """A re-run with the same spec, frame and directory, the models dropped
    from the registry, reloads every finished step and builds no model:
    the same leaderboard (the base models by key; the ensemble built again
    from them with the same metric); a changed spec ignores the
    manifest."""
    monkeypatch.setattr(pam, "_default_plan", _small_plan)
    pf = small
    ckdir = str(tmp_path / "aml")
    a1 = _aml(ckdir)
    a1.train(y="y", training_frame=pf)
    t1 = a1.leaderboard.as_table()
    for m in a1.leaderboard.models:
        h2o3_tpu_torch.remove(m.key)
    built = []
    monkeypatch.setattr(GBM, "_build", lambda self, *a: built.append(1))
    a2 = _aml(ckdir)
    a2.train(y="y", training_frame=pf)
    t2 = a2.leaderboard.as_table()
    assert not built
    assert [r["algo"] for r in t2] == [r["algo"] for r in t1]
    assert [r["model_id"] for r in t2 if r["algo"] != "stackedensemble"] == \
        [r["model_id"] for r in t1 if r["algo"] != "stackedensemble"]
    np.testing.assert_allclose([r["auc"] for r in t2],
                               [r["auc"] for r in t1], atol=1e-12)
    assert [e["stage"] for e in a2.event_log].count("recover") == 3
    _aml(ckdir, stopping_rounds=4).train(y="y", training_frame=pf)
    assert built  # another spec: the manifest is ignored, models built


def test_automl_poison_step_guard(small, tmp_path, monkeypatch):
    """A step whose build crashes leaves its attempt in the manifest; after
    ``H2O3_TPU_AUTOML_STEP_RETRIES`` recorded attempts the step is skipped
    and the plan goes on."""
    monkeypatch.setattr(pam, "_default_plan", _small_plan)
    monkeypatch.setenv("H2O3_TPU_AUTOML_STEP_RETRIES", "2")
    pf = small
    ckdir = str(tmp_path / "poison")

    class Crash(BaseException):
        """A crash the plan's step handler does not catch."""

    real = GBM._build

    def crash_first(self, *a):
        if self.params.max_depth == 3 and self.params.ntrees == 5 \
                and self.params.sample_rate == 0.9:
            raise Crash()
        return real(self, *a)

    monkeypatch.setattr(GBM, "_build", crash_first)
    kw = dict(max_runtime_secs=0, nfolds=0)
    for _ in range(2):
        with pytest.raises(Crash):
            _aml(ckdir, **kw).train(y="y", training_frame=pf)
    steps, attempts = pam._read_automl_manifest(
        ckdir, "automl", pam._automl_fingerprint(
            _aml(ckdir, **kw).spec, None, "y", pf))
    assert list(steps) == ["def_gbm_1"] and attempts == {"def_gbm_2": 2}
    a = _aml(ckdir, **kw)
    a.train(y="y", training_frame=pf)
    assert ("skip", "def_gbm_2") in [(e["stage"], e["message"].split()[0])
                                    for e in a.event_log]
    assert [r["step"] for r in a.step_log][:2] == ["def_gbm_1", "def_gbm_3"]
