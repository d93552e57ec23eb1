"""DeepLearning in the port (``h2o3_tpu_torch.models.deeplearning``)
against the JAX package's replicated lane, on the CPU at small sizes
(2,400 rows, 11 columns of which one categorical: 13 design columns, a
shape-bucketed width padded to 16; ``hidden`` (16, 16), batch 32, 2
epochs). JAX runs with ``H2O3_TPU_DL_GRAD_SHARD=0`` (on the tests' 8-device
mesh ``auto`` would take the sharded-gradient lane, which the port does
not have); the port starts from JAX's initial weights, read where JAX's
builder hands them to its epoch driver, through ``mlp_from_numpy``.

Tolerances, with their reasons:
- final weights: 1e-5 relative to each layer's largest weight — the same
  float32 steps, summed in another order (the rows' gradients of a
  minibatch, and JAX's batch rows spread over 8 devices);
- scoring history (each epoch's loss) and predictions: 1e-5 relative;
- ``model_summary``: equal;
- cross-validation metrics: 1e-5 relative.
Port-only: dropout masks equal between two trainings and between the
eager and block paths (bit-equal weights), the mask's keep rate within
3 sigma of ``1 - rate``, and the refusals.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import deeplearning as jdl  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OAutoEncoderEstimator,
    H2ODeepLearningEstimator,
)
from h2o3_tpu_torch.models import deeplearning as pdl  # noqa: E402
from h2o3_tpu_torch.models.tree import sampling  # noqa: E402

N = 2400
NUMS = [f"x{i}" for i in range(10)]
X_COLS = NUMS + ["c1"]
BASE = dict(hidden=(16, 16), epochs=2, mini_batch_size=32, seed=7)


def dl_df(n=N, seed=0) -> pd.DataFrame:
    """Ten float32 normals (NAs in x3), a 3-level categorical ``c1``, a
    40-level categorical ``hc`` (for hashing), a binary label, a 3-class
    response and a regression response, and user weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10)).astype(np.float32)
    df = pd.DataFrame(X, columns=NUMS)
    df.loc[rng.random(n) < 0.05, "x3"] = np.nan
    c1 = rng.integers(0, 3, n)
    df["c1"] = np.array(["a", "b", "c"])[c1]
    df["hc"] = np.array([f"h{i}" for i in range(40)])[rng.integers(0, 40, n)]
    lin = X[:, 0] - 0.8 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.4 * (c1 - 1)
    df["label"] = np.where(rng.random(n) < 1 / (1 + np.exp(-2 * lin)), "s",
                           "b")
    df["ymn"] = np.array(["u", "v", "w"])[np.digitize(
        lin + 0.3 * rng.normal(size=n), [-0.6, 0.6])]
    df["yreg"] = (1.0 + lin + 0.2 * rng.normal(size=n)).astype(np.float32)
    df["w"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return df


@pytest.fixture(scope="module")
def data():
    df = dl_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(
        df, device="cpu")


@pytest.fixture(autouse=True)
def _replicated(monkeypatch):
    monkeypatch.setenv("H2O3_TPU_DL_GRAD_SHARD", "0")


def _np_tree(params) -> dict:
    """A flax parameter tree as nested dicts of numpy arrays."""
    if hasattr(params, "items"):
        return {k: _np_tree(v) for k, v in params.items()}
    return np.asarray(params)


def _record_jax_init(monkeypatch) -> list:
    """Each JAX training's initial parameters (numpy), read where its
    builder hands them to the epoch driver."""
    seen = []
    orig = jdl._run_sync_sgd

    def spy(job, p, mlp, kind, tx, params, *a, **k):
        seen.append(_np_tree(params))
        return orig(job, p, mlp, kind, tx, params, *a, **k)

    monkeypatch.setattr(jdl, "_run_sync_sgd", spy)
    return seen


def _start_from(monkeypatch, tree):
    """The port's builders start from ``tree`` (a flax tree)."""
    def initial(self, d_in, d_pad, n_out, device):
        return pdl.mlp_from_numpy(tree, self.params.activation, device)

    monkeypatch.setattr(pdl.DeepLearning, "_initial_net", initial)


def _train_both(data, monkeypatch, y, x=X_COLS, **kw):
    """The JAX model, then the port's from JAX's initial weights."""
    _, jf, pf = data
    seen = _record_jax_init(monkeypatch)
    kw = {**BASE, **kw}
    jm = jdl.DeepLearning(**kw).train(x=x, y=y, training_frame=jf)
    _start_from(monkeypatch, seen[0])
    if kw.get("autoencoder"):
        est = H2OAutoEncoderEstimator(**{k: v for k, v in kw.items()
                                         if k != "autoencoder"})
        est.train(x=x, training_frame=pf)
    else:
        est = H2ODeepLearningEstimator(**kw)
        est.train(x=x, y=y, training_frame=pf)
    return jm, est.model, seen


def _close(a, b, rtol=1e-5):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(1e-30, np.abs(b).max()))


def _check_weights(jm, pm):
    tree = _np_tree(jm.output["params"])["params"]
    for i, d in enumerate(pm.output["net"].dense()):
        _close(d.weight.numpy().T, tree[f"Dense_{i}"]["kernel"])
        _close(d.bias.numpy(), tree[f"Dense_{i}"]["bias"])


def _check_history(jm, pm):
    assert [h["epoch"] for h in pm.scoring_history] == \
        [h["epoch"] for h in jm.scoring_history]
    _close([h["loss"] for h in pm.scoring_history],
           [h["loss"] for h in jm.scoring_history])


CASES = {
    # y, estimator kwargs
    "ce_adadelta": ("ymn", dict(l1=1e-4, l2=1e-3)),
    "ce_binomial_tanh_sgd": ("label", dict(
        activation="Tanh", adaptive_rate=False, rate=0.02, rate_decay=0.5)),
    "mse_momentum_sgd": ("yreg", dict(
        adaptive_rate=False, rate=0.01, rate_decay=0.7, momentum_start=0.5,
        l1=1e-4, l2=1e-3)),
    "mse_weights": ("yreg", dict(weights_column="w")),
    "hash_buckets": ("label", dict(hash_buckets=8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax(data, case, monkeypatch):
    y, kw = CASES[case]
    x = X_COLS + (["hc"] if case == "hash_buckets" else [])
    jm, pm, _ = _train_both(data, monkeypatch, y, x=x, **kw)
    _, jf, pf = data
    assert pm.output["input_pad"] == jm.output["input_pad"]
    assert pm.output["datainfo"].ncols_expanded == \
        jm.output["datainfo"].ncols_expanded
    _check_weights(jm, pm)
    _check_history(jm, pm)
    assert pm.model_summary() == jm.model_summary()
    jraw = np.asarray(jm._predict_raw(jf))[:N]
    _close(pm._predict_raw(pf).numpy(), jraw)
    names = ("logloss", "rmse") if y != "yreg" else ("rmse", "mae")
    for name in names:
        assert pm.training_metrics.value(name) == pytest.approx(
            jm.training_metrics.value(name), rel=1e-5), name


def test_bucketed_width_pads_the_first_kernel(data, monkeypatch):
    """13 design columns: the input bucket is 16 in both packages, the
    padded columns of the first weight stay zero, and the exact-width
    build (H2O3_TPU_SHAPE_BUCKETS=0) from the same weights without the
    padding ends at the same weights."""
    jm, pm, seen = _train_both(data, monkeypatch, "label")
    assert pm.output["input_pad"] == 3
    w0 = pm.output["net"].Dense_0.weight
    assert w0.shape[1] == 16 and bool((w0[:, 13:] == 0).all())
    _check_weights(jm, pm)
    cut = _np_tree(seen[0])
    k0 = cut["params"]["Dense_0"]
    k0["kernel"] = k0["kernel"][:13]
    _start_from(monkeypatch, cut)
    monkeypatch.setenv("H2O3_TPU_SHAPE_BUCKETS", "0")
    est = H2ODeepLearningEstimator(**BASE)
    est.train(x=X_COLS, y="label", training_frame=data[2])
    assert est.model.output["input_pad"] == 0
    exact = est.model.output["net"].tensors()
    for i, (a, b) in enumerate(zip(exact, pm.output["net"].tensors())):
        _close(a.numpy(), (b[:, :13] if i == 0 else b).numpy(), rtol=1e-6)


def test_autoencoder_matches_jax(data, monkeypatch):
    jm, pm, _ = _train_both(data, monkeypatch, None, x=NUMS,
                            autoencoder=True, hidden=(6,))
    _, jf, pf = data
    _check_weights(jm, pm)
    _check_history(jm, pm)
    assert pm.model_summary() == jm.model_summary()
    assert pm.training_metrics.mse == pytest.approx(
        jm.training_metrics.mse, rel=1e-5)
    ja = np.asarray(jm.anomaly(jf).vec(0).to_numpy())[:N]
    _close(pm.anomaly(pf).vec(0).data.numpy(), ja)
    jp, pp = jm.predict(jf), pm.predict(pf)
    assert pp.names == jp.names
    for nm in pp.names[:3]:
        _close(pp.vec(nm).data.numpy(), np.asarray(jp.vec(nm).to_numpy())[:N])


def test_tiny_frame_smaller_than_a_batch(monkeypatch):
    """20 rows at batch 32 (JAX's test_autoencoder_checkpoint_and_tiny_
    frame): one step an epoch over the 20 rows, padded slots weighted 0;
    the same weights and history as JAX's, autoencoder and supervised."""
    rng = np.random.default_rng(2)
    df = pd.DataFrame(rng.normal(size=(20, 3)), columns=list("abc"))
    df["y"] = np.where(df.a > 0, "x", "z")
    data = (df, JFrame.from_pandas(df),
            h2o3_tpu_torch.upload_file(df, device="cpu"))
    for kw, y in ((dict(autoencoder=True), None), (dict(), "y")):
        jm, pm, _ = _train_both(data, monkeypatch, y, x=list("abc"),
                                hidden=(4,), epochs=3, seed=6, **kw)
        st = pm.output["sgd_stats"]
        assert st["nbatch"] == 1 and st["steps"] == 3
        _check_weights(jm, pm)
        _check_history(jm, pm)


def test_cv_matches_jax(data, monkeypatch):
    """nfolds=3: every fold model from the same initial weights as JAX's
    (each fold starts from the seed's initialization), CV metrics and the
    kept holdout predictions within 1e-5."""
    jm, pm, seen = _train_both(data, monkeypatch, "label", nfolds=3,
                               keep_cross_validation_predictions=True)
    assert len(seen) == 4 and len(pm.cv_models) == 3
    for jfm, pfm in zip(jm.cv_models, pm.cv_models):
        _check_weights(jfm, pfm)
    for name in ("logloss", "auc", "rmse"):
        assert pm.cross_validation_metrics.value(name) == pytest.approx(
            jm.cross_validation_metrics.value(name), rel=1e-5), name
    _close(pm.cv_predictions.numpy(), np.asarray(jm.cv_predictions)[:N])


def test_early_stopping_on_the_epoch_loss(data, monkeypatch):
    """stopping_rounds=1 with a loose tolerance stops both packages at the
    same epoch of a 6-epoch budget."""
    jm, pm, _ = _train_both(data, monkeypatch, "label", epochs=6,
                            stopping_rounds=1, stopping_tolerance=0.2)
    assert len(pm.scoring_history) == len(jm.scoring_history) < 6
    _check_weights(jm, pm)


def test_optimizer_state_from_numpy_continues_like_jax():
    """One ADADELTA and one momentum-SGD update from a state carried
    across from optax's (``opt_state_from_numpy``): the port's update
    equals optax's within 1e-6 relative."""
    import jax
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(3)
    tree = {"params": {f"Dense_{i}": {
        "kernel": rng.normal(size=s).astype(np.float32),
        "bias": rng.normal(size=s[1]).astype(np.float32)}
        for i, s in enumerate([(5, 4), (4, 2)])}}
    grads = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), tree)
    for adaptive in (True, False):
        p = pdl.DeepLearningParams(hidden=(4,), adaptive_rate=adaptive,
                                   rate=0.05, rate_decay=0.5,
                                   momentum_start=0.9)
        tx = jdl._make_optimizer(p)
        st = tx.init(jax.tree.map(jnp.asarray, tree))
        # advance optax's state, carry it across, and take one more step
        st = tx.update(grads, st, tree)[1]
        upd, _ = tx.update(grads, st, tree)
        want = optax.apply_updates(jax.tree.map(jnp.asarray, tree), upd)
        if adaptive:
            opt = {"e_g": _np_tree(st[1].e_g), "e_x": _np_tree(st[1].e_x)}
        else:
            opt = {"trace": _np_tree(st[0].trace), "count": int(st[1].count)}
        net = pdl.mlp_from_numpy(tree, device="cpu")
        plan = pdl._Plan(widths=(5, 4, 2), act="relu", dropout=(0.0, 0.0),
                         kind="ce", nrow=1, batch=1, nbatch=1,
                         adaptive=adaptive, rho=p.rho, eps=p.epsilon,
                         rate=p.rate, rate_decay=p.rate_decay,
                         momentum=p.momentum_start)
        s = pdl._SgdState(plan, "cpu")
        s.load(net, pdl.opt_state_from_numpy(opt, net),
               torch.zeros(1, 5), torch.zeros(1), torch.zeros(1), 0.0, 0.0,
               1)
        g = pdl.opt_state_from_numpy({"g": _np_tree(grads)}, net)["g"]
        for t, x in zip(s.grads, g):
            t.copy_(x)
        s._update()
        s.unload(net)
        wt = _np_tree(want)["params"]
        for i, d in enumerate(net.dense()):
            _close(d.weight.numpy().T, wt[f"Dense_{i}"]["kernel"], 1e-6)
            _close(d.bias.numpy(), wt[f"Dense_{i}"]["bias"], 1e-6)


# -- port only ----------------------------------------------------------------

DROP = dict(BASE, input_dropout_ratio=0.1, hidden_dropout_ratios=(0.3, 0.2),
            activation="RectifierWithDropout")


def _fit(pf, y="label", **kw):
    est = H2ODeepLearningEstimator(**kw)
    est.train(x=X_COLS, y=y, training_frame=pf)
    return est.model


def test_dropout_masks_equal_across_runs_and_paths(data, monkeypatch):
    """Keyed masks: two trainings, and the eager and block step paths,
    end bit-equal; a different seed does not."""
    _, _, pf = data
    a = _fit(pf, **DROP)
    b = _fit(pf, **DROP)
    monkeypatch.setattr(pdl, "STEP_MODE", "block")
    c = _fit(pf, **DROP)
    assert c.output["sgd_stats"]["mode"] == "block"
    assert a.output["sgd_stats"]["mode"] == "eager"
    for x, y_, z in zip(a.output["net"].tensors(), b.output["net"].tensors(),
                        c.output["net"].tensors()):
        assert torch.equal(x, y_) and torch.equal(x, z)
    d = _fit(pf, **{**DROP, "seed": 8})
    assert not torch.equal(a.output["net"].Dense_0.weight,
                           d.output["net"].Dense_0.weight)


def test_dropout_keep_rate_within_three_sigma():
    """The keep mask of a 256 x 784 layer at rate 0.3: its keep share
    within 3 sigma of 0.7, and another step's mask differs."""
    plan = pdl._Plan(widths=(784, 8, 2), act="relu", dropout=(0.3, 0.0),
                     kind="ce", nrow=256, batch=256, nbatch=1, adaptive=True,
                     rho=0.99, eps=1e-8, rate=0.005, rate_decay=1.0,
                     momentum=0.0)
    s = pdl._SgdState(plan, "cpu")
    s.seed.fill_(sampling.seed_key(3))
    key = sampling.fold(s.seed, pdl.DROPOUT, s.epoch_t, s.step)
    keep = s._keep(key, 0, 256, 784)
    n = keep.numel()
    sigma = np.sqrt(0.7 * 0.3 / n)
    assert abs(float(keep.float().mean()) - 0.7) < 3 * sigma
    s.step.fill_(1)
    key2 = sampling.fold(s.seed, pdl.DROPOUT, s.epoch_t, s.step)
    assert not torch.equal(keep, s._keep(key2, 0, 256, 784))


@pytest.mark.parametrize("what", ["checkpoint", "export_checkpoints_dir",
                                  "window", "grad_shard", "ctl"])
def test_unported_options_raise(data, what, monkeypatch, tmp_path):
    """The lanes still to port raise ``NotImplementedError`` naming their
    ROADMAP item; the checkpoint options (ported) raise their own errors:
    an unknown checkpoint JAX's ValueError, a checkpoint directory under a
    regular file the OS's; a design past ``H2O3_TPU_HBM_WINDOW_BYTES``
    (ported) trains on the streamed lane (``tests/test_torch_oocore.py``
    holds it against JAX's)."""
    _, _, pf = data
    kw = dict(BASE)
    if what == "window":
        from h2o3_tpu_torch.frame import chunkstore as cs

        monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", "16384")
        cs.LAST_STORE_STATS.clear()
        m = _fit(pf, **kw)
        st = cs.LAST_STORE_STATS
        assert st["n_blocks"] > 1 and st["peak_hbm"] <= st["window"]
        assert m.output["sgd_stats"]["streamed_blocks"] == st["n_blocks"]
        assert [h["epoch"] for h in m.scoring_history] == [1, 2]
        assert all(np.isfinite(h["loss"]) for h in m.scoring_history)
        assert np.isfinite(m.training_metrics.logloss)
        return
    if what == "checkpoint":
        with pytest.raises(ValueError, match="not a model"):
            _fit(pf, checkpoint="some_model", **kw)
        return
    if what == "export_checkpoints_dir":
        (tmp_path / "f").write_text("")
        with pytest.raises(OSError):
            _fit(pf, export_checkpoints_dir=str(tmp_path / "f" / "d"), **kw)
        return
    monkeypatch.setenv("H2O3_TPU_DL_GRAD_SHARD",
                       "1" if what == "grad_shard" else "ctl")
    with pytest.raises(NotImplementedError, match="Queue A"):
        _fit(pf, **kw)


def test_autoencoder_refuses_cross_validation(data):
    _, _, pf = data
    est = H2OAutoEncoderEstimator(hidden=(4,), nfolds=3)
    with pytest.raises(ValueError, match="cross-validation"):
        est.train(x=NUMS, training_frame=pf)


def test_initialization_is_lecun_normal_and_seeded():
    """flax's lecun_normal in distribution (truncated at 2 sigma of the
    unit normal, std sqrt(1/fan_in)), zero biases, zero bucket columns,
    the same bits for the same seed, and no draw from the global
    generator."""
    p = pdl.DeepLearningParams(hidden=(64,), seed=5)
    state = torch.random.get_rng_state()
    a = pdl.init_mlp(p, 500, 504, 3, "cpu")
    assert torch.equal(state, torch.random.get_rng_state())
    b = pdl.init_mlp(p, 500, 504, 3, "cpu")
    for x, y in zip(a.tensors(), b.tensors()):
        assert torch.equal(x, y)
    w = a.Dense_0.weight
    assert bool((w[:, 500:] == 0).all()) and bool((a.Dense_0.bias == 0).all())
    z = w[:, :500] / np.sqrt(1 / 500) * 0.87962566103423978
    assert float(z.abs().max()) <= 2.0 + 1e-5
    assert float(w[:, :500].std()) == pytest.approx(np.sqrt(1 / 500), rel=0.05)
