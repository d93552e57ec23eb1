"""The port's streamed (out-of-core) training lanes against the JAX
package's, on the CPU at small sizes with a forced small window
(``H2O3_TPU_HBM_WINDOW_BYTES``): GBM, XGBoost with ``reg_lambda``,
monotone GBM, GLM and DeepLearning, each held against JAX's streamed lane
at the same window and, where the port has one, against its own resident
lane; a frame that fits the window and ``H2O3_TPU_FRAME_COMPRESS=0`` take
the resident path; an oversized frame cycles the window; a streamed GBM
resumed from its interval snapshot equals the uninterrupted run.

JAX's side runs under a one-device mesh (under the tests' 8-device mesh
its block quantum is 64 rows and its blocks differ from the port's) and
with ``H2O3_TPU_OVERLOAD=0`` (the static window routes, as in the port).
The port's CPU runs take one intra-op thread (small tensors, and test
workers share the cores).

Tolerances, with their reasons:
- trees: every split decision equal (features on a 0.1 grid, so no float
  near-tie can part the packages, as in ``tests/test_torch_cv.py``); the
  streamed and resident lanes differ only by float32 block-summation
  order, and so do the two packages;
- GBM and XGBoost predictions and training logloss: 1e-6 (JAX's own
  streamed-against-resident bound, ``tests/test_oocore.py``);
- GLM coefficients: 1e-4 absolute (``tests/test_torch_glm.py``'s bound
  for whole trainings against JAX), metrics 1e-5; the port's streamed
  lane against its resident host lane (``H2O3_TPU_GLM_FUSE=0``, the same
  float64 solve): 1e-5;
- DeepLearning from JAX's initial weights: weights, the epoch losses and
  the training logloss 1e-5 relative (``tests/test_torch_deeplearning.py``:
  the same float32 steps, summed in another order);
- a fitting frame, and ``H2O3_TPU_FRAME_COMPRESS=0``: predictions
  byte-equal to the resident run's;
- resume from an interval snapshot: logloss and predictions 1e-6 of the
  uninterrupted streamed run (``tests/test_oocore.py``'s bound).
"""

import contextlib
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from h2o3_tpu.frame import chunkstore as jcs  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import deeplearning as jdl  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402
from h2o3_tpu.models.tree.xgboost import XGBoost as JXGBoost  # noqa: E402
from h2o3_tpu.parallel import mesh as pm  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch import persist  # noqa: E402
from h2o3_tpu_torch.frame import chunkstore as cs  # noqa: E402
from h2o3_tpu_torch.models import deeplearning as pdl  # noqa: E402
from h2o3_tpu_torch.models.glm import GLM  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM  # noqa: E402
from h2o3_tpu_torch.models.tree.xgboost import XGBoost  # noqa: E402

WINDOW = 48 * 1024  # tests/test_oocore.py's GBM window


@contextlib.contextmanager
def one_device():
    old = pm._mesh
    pm.set_mesh(Mesh(np.array(jax.devices("cpu")[:1]), (pm.ROWS_AXIS,)))
    try:
        yield
    finally:
        pm.set_mesh(old)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("H2O3_TPU_OVERLOAD", "0")
    monkeypatch.setenv("H2O3_TPU_DL_GRAD_SHARD", "0")
    monkeypatch.delenv("H2O3_TPU_HBM_WINDOW_BYTES", raising=False)
    monkeypatch.delenv("H2O3_TPU_FRAME_COMPRESS", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def oo_df(n=3000, c=6, seed=7, regression=False) -> pd.DataFrame:
    """``tests/test_oocore.py``'s frame with its normals on a 0.1 grid."""
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, c)), 1).astype(np.float32)
    eta = X[:, 0] - 0.5 * X[:, 1] + 0.25 * X[:, 2]
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(c)])
    if regression:
        df["label"] = (eta + 0.3 * rng.normal(size=n)).astype(np.float32)
    else:
        df["label"] = np.where(rng.random(n) < 1 / (1 + np.exp(-eta)),
                               "s", "b")
    return df


def _window(monkeypatch, nbytes):
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(nbytes))


def _jax_fit(cls, df, y="label", **kw):
    """JAX's training on a one-device mesh; its store's stats."""
    with one_device():
        jcs.LAST_STORE_STATS.clear()
        m = cls(**kw).train(y=y, training_frame=JFrame.from_pandas(df))
        return m, dict(jcs.LAST_STORE_STATS)


def _port_fit(cls, df, y="label", **kw):
    cs.LAST_STORE_STATS.clear()
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    m = cls(**kw).train(y=y, training_frame=fr)
    return m, dict(cs.LAST_STORE_STATS), fr


def _p1(model, frame, col="s"):
    return model.predict(frame).vec(col).to_numpy()


def _splits_equal(a, b):
    """Every tree's split decisions equal, level by level."""
    ta, tb = a.output["trees"], b.output["trees"]
    assert len(ta) == len(tb)
    for ga, gb in zip(ta, tb):
        la, lb = ga[0].to_host().levels, gb[0].to_host().levels
        assert len(la) == len(lb)
        for x, z in zip(la, lb):
            n = len(x.leaf_now)
            np.testing.assert_array_equal(x.leaf_now, z.leaf_now[:n])
            live = ~x.leaf_now
            np.testing.assert_array_equal(x.split_col[live],
                                          z.split_col[:n][live])
            np.testing.assert_array_equal(x.split_bin[live],
                                          z.split_bin[:n][live])


TREE_CASES = {
    # builder pair, y, kwargs
    "gbm": (GBM, JGBM, dict(ntrees=4, max_depth=4, seed=11,
                            score_tree_interval=2)),
    "xgboost": (XGBoost, JXGBoost, dict(ntrees=3, max_depth=4, seed=11,
                                        reg_lambda=1.0, min_rows=5.0,
                                        score_tree_interval=3)),
    "monotone": (GBM, JGBM, dict(ntrees=3, max_depth=3, seed=11,
                                 monotone_constraints={"x0": 1, "x1": -1},
                                 score_tree_interval=3)),
}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_streamed_trees_match_jax_and_resident(case, monkeypatch):
    """The port's streamed lane against JAX's streamed lane at the same
    window (the same blocks), and against the port's resident lane."""
    cls, jcls, kw = TREE_CASES[case]
    df = oo_df()
    res, st0, fr = _port_fit(cls, df, **kw)
    assert not st0  # resident: no store
    _window(monkeypatch, WINDOW)
    jm, jst = _jax_fit(jcls, df, **kw)
    pm_, st, _ = _port_fit(cls, df, **kw)
    assert st["n_blocks"] > 1 and st["n_blocks"] == jst["n_blocks"]
    assert st["block_rows"] == jst["block_rows"]
    assert st["peak_hbm"] <= st["window"]
    _splits_equal(pm_, jm)
    _splits_equal(pm_, res)
    with one_device():
        jp = _p1(jm, JFrame.from_pandas(df))
    np.testing.assert_allclose(_p1(pm_, fr), jp, atol=1e-6)
    np.testing.assert_allclose(_p1(pm_, fr), _p1(res, fr), atol=1e-6)
    for other in (jm, res):
        np.testing.assert_allclose(pm_.training_metrics.logloss,
                                   other.training_metrics.logloss, atol=1e-6)
    if case == "gbm":
        assert [h["ntrees"] for h in pm_.scoring_history] == [2, 4]


def test_streamed_sampled_gbm_draws_the_resident_rows(monkeypatch):
    """The keyed row draw takes the global row index, so the streamed and
    resident sampled builds draw the same rows and columns (JAX's streamed
    bootstrap folds the block index: its draws are another stream)."""
    df = oo_df(seed=8)
    kw = dict(ntrees=3, max_depth=3, seed=5, sample_rate=0.7,
              col_sample_rate=0.7, col_sample_rate_per_tree=0.8)
    res, _, fr = _port_fit(GBM, df, **kw)
    _window(monkeypatch, WINDOW)
    pm_, st, _ = _port_fit(GBM, df, **kw)
    assert st["n_blocks"] > 1
    _splits_equal(pm_, res)
    np.testing.assert_allclose(_p1(pm_, fr), _p1(res, fr), atol=1e-6)


GLM_CASES = {
    "binomial": (False, dict(family="binomial", lambda_=1e-4,
                             max_iterations=15, seed=1)),
    "gaussian_elastic_net": (True, dict(family="gaussian", alpha=0.5,
                                        lambda_=1e-3, max_iterations=12,
                                        seed=1)),
}


@pytest.mark.parametrize("case", list(GLM_CASES))
def test_streamed_glm_matches_jax_and_host_lane(case, monkeypatch):
    regression, kw = GLM_CASES[case]
    df = oo_df(4000, 8, seed=13, regression=regression)
    monkeypatch.setenv("H2O3_TPU_GLM_FUSE", "0")
    host, _, fr = _port_fit(GLM, df, **kw)
    monkeypatch.delenv("H2O3_TPU_GLM_FUSE")
    _window(monkeypatch, 96 * 1024)
    jm, jst = _jax_fit(JGLM, df, **kw)
    pm_, st, _ = _port_fit(GLM, df, **kw)
    assert st["n_blocks"] > 1 and st["n_blocks"] == jst["n_blocks"]
    assert pm_.output["irls_stats"]["streamed_blocks"] == st["n_blocks"]
    assert pm_.output["irls_stats"]["chunks"] == 0  # host solve per pass
    for k in jm.coef:
        assert abs(pm_.coef[k] - jm.coef[k]) < 1e-4, k
        assert abs(pm_.coef[k] - host.coef[k]) < 1e-5, k
    metric = "rmse" if regression else "logloss"
    for other in (jm, host):
        np.testing.assert_allclose(getattr(pm_.training_metrics, metric),
                                   getattr(other.training_metrics, metric),
                                   rtol=1e-5)


def _np_tree(params) -> dict:
    if hasattr(params, "items"):
        return {k: _np_tree(v) for k, v in params.items()}
    return np.asarray(params)


def _close(a, b, rtol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1e-30, np.abs(b).max()))


def test_streamed_deeplearning_matches_jax(monkeypatch):
    """JAX's streamed epochs (a shuffle within each block, one plan per
    block size) against the port's, from JAX's initial weights."""
    df = oo_df(4000, 8, seed=21)
    seen = []
    orig = jdl._run_sync_sgd

    def spy(job, p, mlp, kind, tx, params, *a, **k):
        seen.append(_np_tree(params))
        return orig(job, p, mlp, kind, tx, params, *a, **k)

    monkeypatch.setattr(jdl, "_run_sync_sgd", spy)
    kw = dict(hidden=[16, 16], epochs=2, mini_batch_size=64, seed=3)
    _window(monkeypatch, 96 * 1024)
    jm, jst = _jax_fit(jdl.DeepLearning, df, **kw)
    monkeypatch.setattr(pdl.DeepLearning, "_initial_net",
                        lambda self, d_in, d_pad, n_out, dev:
                        pdl.mlp_from_numpy(seen[0], self.params.activation,
                                           dev))
    pm_, st, fr = _port_fit(pdl.DeepLearning, df, **kw)
    assert st["n_blocks"] > 1 and st["n_blocks"] == jst["n_blocks"]
    stats = pm_.output["sgd_stats"]
    assert stats["streamed_blocks"] == st["n_blocks"]
    assert stats["plans"] <= 2 and stats["host_reads"] == 2
    tree = _np_tree(jm.output["params"])["params"]
    for i, d in enumerate(pm_.output["net"].dense()):
        _close(d.weight.numpy().T, tree[f"Dense_{i}"]["kernel"])
        _close(d.bias.numpy(), tree[f"Dense_{i}"]["bias"])
    _close([h["loss"] for h in pm_.scoring_history],
           [h["loss"] for h in jm.scoring_history])
    _close(pm_.training_metrics.logloss, jm.training_metrics.logloss)


def test_fitting_frame_and_compress_off_stay_resident(monkeypatch):
    """A window the frame fits, and any window under
    ``H2O3_TPU_FRAME_COMPRESS=0``: no store, predictions byte-equal to the
    resident run's, no feature column released."""
    df = oo_df(2000, 6, seed=5)
    kw = dict(ntrees=3, max_depth=3, seed=2)
    base, _, fr = _port_fit(GBM, df, **kw)
    want = _p1(base, fr).tobytes()
    for env in ({"H2O3_TPU_HBM_WINDOW_BYTES": str(1 << 30)},
                {"H2O3_TPU_HBM_WINDOW_BYTES": "32768",
                 "H2O3_TPU_FRAME_COMPRESS": "0"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert cs.ChunkStore.plan(cs.pad_rows(2000), 6 + 28) is None
        m, st, fr2 = _port_fit(GBM, df, **kw)
        assert not st
        assert all(fr2.vec(f"x{i}")._data is not None for i in range(6))
        assert _p1(m, fr2).tobytes() == want


def test_oversized_frame_cycles_the_window(monkeypatch):
    """A tiny window (rows x lanes ~8x it): at least 4 blocks and 4
    evictions, the peak within the window, the features released, and the
    model still right."""
    _window(monkeypatch, 24 * 1024)
    df = oo_df(6000, 6, seed=23)
    m, st, fr = _port_fit(GBM, df, ntrees=4, max_depth=4, seed=5)
    assert st["n_blocks"] >= 4 and st["evictions"] >= 4
    assert st["peak_hbm"] <= st["window"]
    assert st["h2d_bytes"] > 4 * st["window"]
    assert all(fr.vec(f"x{i}")._data is None for i in range(6))
    assert float(m.training_metrics.auc) > 0.7
    # a released column is uploaded again on its next use, bit-equal
    np.testing.assert_array_equal(fr.vec("x0").data.numpy(),
                                  df["x0"].to_numpy())


def test_streamed_gbm_resumes_from_its_snapshot(tmp_path, monkeypatch):
    """A streamed GBM killed right after its interval snapshot at 4 of 6
    trees, resumed from that file to 6 (the prior forest replayed block by
    block into the score lane), equals the uninterrupted streamed run
    (JAX's kill-and-resume case, ``tests/test_oocore.py``)."""
    _window(monkeypatch, WINDOW)
    df = oo_df(3000, 6, seed=29)
    kw = dict(max_depth=3, seed=6, score_tree_interval=2)
    full, st, fr = _port_fit(GBM, df, ntrees=6, **kw)
    assert st["n_blocks"] > 1
    written = []
    orig = GBM._export_interval_checkpoint

    def killed(self, make_model):
        written.append(orig(self, make_model))
        if len(written) == 2:
            raise RuntimeError("killed after the 4-tree snapshot")
        return written[-1]

    monkeypatch.setattr(GBM, "_export_interval_checkpoint", killed)
    with pytest.raises(RuntimeError, match="killed"):
        GBM(ntrees=6, export_checkpoints_dir=str(tmp_path), **kw).train(
            y="label", training_frame=fr)
    monkeypatch.setattr(GBM, "_export_interval_checkpoint", orig)
    prior = persist.load_model(written[-1], device="cpu")
    assert prior.output["ntrees_actual"] == 4
    res = GBM(ntrees=6, checkpoint=written[-1], **kw).train(
        y="label", training_frame=fr)
    assert cs.LAST_STORE_STATS["n_blocks"] > 1
    assert res.output["ntrees_actual"] == 6
    np.testing.assert_allclose(res.training_metrics.logloss,
                               full.training_metrics.logloss, atol=1e-6)
    np.testing.assert_allclose(_p1(res, fr), _p1(full, fr), atol=1e-6)
