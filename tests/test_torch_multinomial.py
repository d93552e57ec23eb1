"""Multinomial GBM in the port (``h2o3_tpu_torch``) against the JAX package,
on the CPU at small sizes: the K-class targets and hessians, the
multinomial metrics (host and device-stats functions), whole GBMs, the
whole-tree build of K class trees per iteration against the eager control,
validation and early stopping, and a JAX model carried across. Inputs are
made with numpy from seeds and handed to both packages.

Tolerances, with their reasons:
- targets and hessians: 1e-6 (XLA's and PyTorch's softmax differ in the
  last ulp);
- metrics: logloss, errors and hit ratios within 1e-6 relative, the
  confusion matrix equal (integer weights make every float32 cell, error
  and rank sum exact in any order); on the device-stats path the float32
  logloss and mse sums within 1e-5 relative (20,000 logs added in another
  order, as ``test_torch_metrics_device.py`` holds the binomial sums);
- whole GBMs: probabilities and logloss within 1e-5 (the JAX build sums
  histograms across an 8-device mesh, the port on one device, so float32
  sums round differently); scoring-history and stop tree counts exact;
- whole-tree build against the eager control on integer-valued targets:
  every record field bit-equal, F and varimp equal (every histogram sum is
  exact and the float32 leaf arithmetic runs the same ops in the same
  order);
- weights converted from a JAX model: probabilities within 1e-6 (the same
  trees replayed with the same float32 adds, in another order).
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import metrics as JM  # noqa: E402
from h2o3_tpu.models.tree import GBM as JGBM  # noqa: E402
from h2o3_tpu.models.tree import distributions as jdist  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator  # noqa: E402
from h2o3_tpu_torch.models import metrics as PM  # noqa: E402
from h2o3_tpu_torch.models.tree import distributions as pdist  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import gbm_from_numpy  # noqa: E402

_GBM_KW = dict(ntrees=3, max_depth=3, learn_rate=0.1, min_rows=10.0, seed=42)
_CLASSES = ("u", "v", "w")


def multiclass_df(n=2000, seed=0) -> pd.DataFrame:
    """4 numeric columns (NAs in one, ties in one) + one enum column with
    NAs, and a 3-class label drawn from a softmax of both kinds."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(4)])
    df.loc[rng.random(n) < 0.1, "x1"] = np.nan
    df["x3"] = np.round(df["x3"] * 2)
    levels = np.array(["a", "b", "c", "d"])
    cat = rng.integers(0, 4, n)
    df["cat"] = np.where(rng.random(n) < 0.07, None, levels[cat])
    eta = np.stack([1.5 * X[:, 0], X[:, 1] - 0.7 * cat,
                    0.5 * X[:, 2] + 1.2 * (cat == 2)], 1)
    eta = np.nan_to_num(eta)
    P = np.exp(eta) / np.exp(eta).sum(1, keepdims=True)
    yk = (rng.random(n)[:, None] > np.cumsum(P, 1)).sum(1)
    df["label"] = np.array(_CLASSES)[np.minimum(yk, 2)]
    return df


def _probs(frame_pred, nrow) -> np.ndarray:
    return np.stack([np.asarray(frame_pred.vec(c).to_numpy())[:nrow]
                     for c in _CLASSES], axis=1).astype(np.float64)


@pytest.fixture(scope="module")
def data():
    df = multiclass_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


@pytest.fixture(scope="module")
def jax_gbm(data):
    """One JAX reference multinomial GBM for the module."""
    _, jf, _ = data
    m = JGBM(**_GBM_KW).train(y="label", training_frame=jf)
    return m, _probs(m.predict(jf), jf.nrow)


def test_multinomial_grad_hess_matches_jax():
    rng = np.random.default_rng(1)
    n, K = 3000, 4
    F = rng.normal(size=(n, K)).astype(np.float32) * 3
    y = rng.integers(0, K, n)
    Y1h = (y[:, None] == np.arange(K)).astype(np.float32)
    w = rng.random(n).astype(np.float32)
    w[:10] = 0
    tj, hj = jdist.multinomial_grad_hess(jnp.asarray(F), jnp.asarray(Y1h),
                                         jnp.asarray(w), K)
    tp, hp = pdist.multinomial_grad_hess(
        *(torch.from_numpy(a) for a in (F, Y1h, w)), K)
    assert tp.dtype == hp.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), rtol=1e-6, atol=1e-6)


def _multinomial_inputs(n=20_000, K=4, seed=0):
    """Class ids with unlabelled rows (-1), probabilities with NaN rows and
    exact ties, integer weights with zeros."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, K, n).astype(np.float32)
    z = rng.normal(size=(n, K)) + 1.5 * (y[:, None] == np.arange(K))
    P = (np.exp(z) / np.exp(z).sum(1, keepdims=True)).astype(np.float32)
    P[:50] = 1.0 / K  # every class tied
    w = rng.integers(0, 3, n).astype(np.float32)
    y[rng.random(n) < 0.02] = -1
    P[rng.random(n) < 0.01] = np.nan
    return y, P, w


@pytest.mark.parametrize("path", ["host", "device-stats"])
def test_multinomial_metrics_match_jax(path):
    """The port's host function against JAX's host function, and the
    port's device-stats function on CPU tensors against JAX's device
    function on CPU arrays."""
    y, P, w = _multinomial_inputs()
    dom = ("a", "b", "c", "d")
    if path == "host":
        ref = JM.multinomial_metrics(y.astype(np.int64), P, w, dom)._v
        got = PM.multinomial_metrics(y, P, w, dom)._v
    else:
        ref = JM._multinomial_metrics_device(
            jnp.asarray(y), jnp.asarray(P), jnp.asarray(w), dom)._v
        got = PM._multinomial_metrics_device(
            *(torch.from_numpy(a) for a in (y, P, w)), dom)._v
    assert got.keys() == ref.keys()
    assert got["nobs"] == ref["nobs"] == int(
        ((y >= 0) & (w > 0) & ~np.isnan(P).any(1)).sum())
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  ref["confusion_matrix"])
    for k in ("logloss", "classification_error", "mean_per_class_error",
              "mse", "rmse", "hit_ratios", "per_class_error"):
        rel = 1e-5 if path != "host" and k in ("logloss", "mse", "rmse") \
            else 1e-6
        np.testing.assert_allclose(got[k], ref[k], rtol=rel, atol=0,
                                   err_msg=k)


def test_multinomial_device_stats_one_transfer_layout():
    """The packed statistics: 5 head values, the K×K matrix, 1024 rank
    buckets; the rank buckets past K stay empty."""
    y, P, w = _multinomial_inputs(n=3000, K=3, seed=2)
    packed = PM._multinomial_device_stats(
        *(torch.from_numpy(a) for a in (y, P, w)))
    assert packed.shape == (5 + 9 + 1024,) and packed.dtype == torch.float32
    assert not packed[5 + 9 + 3:].any()


@pytest.mark.parametrize("path", ["whole", "eager"])
def test_multinomial_gbm_matches_jax(data, jax_gbm, monkeypatch, path):
    """upload_file → H2OGradientBoostingEstimator.train → predict on the
    CPU, by the whole-tree build and by the eager control, against JAX's
    GBM: probabilities and training logloss within 1e-5, the labels by
    argmax, the model's shape (3 iterations of 3 class trees, K init
    scores)."""
    monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", "1" if path == "whole" else "0")
    _, jf, pf = data
    jm, jprobs = jax_gbm
    est = H2OGradientBoostingEstimator(**_GBM_KW)
    est.train(y="label", training_frame=pf)
    m = est.model
    assert m.output["distribution"] == "multinomial"
    assert m.output["n_tree_classes"] == 3 and m.nclasses == 3
    assert [len(g) for g in m.output["trees"]] == [3, 3, 3]
    np.testing.assert_array_equal(m.output["init_f"], jm.output["init_f"])
    pred = est.predict(pf)
    assert pred.names == ["predict", *_CLASSES]
    probs = _probs(pred, pf.nrow)
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    labels = np.asarray(pred.vec("predict").to_numpy())
    np.testing.assert_array_equal(labels, probs.argmax(1))
    tm, jtm = m.training_metrics, jm.training_metrics
    assert tm.kind == "multinomial"
    assert abs(tm.logloss - jtm.logloss) < 1e-5
    assert abs(tm.classification_error - jtm.classification_error) < 1e-3
    np.testing.assert_allclose(m.output["varimp"], jm.output["varimp"],
                               rtol=1e-4)
    perf = est.model_performance(pf)
    assert abs(perf.logloss - tm.logloss) < 1e-5


def _tie_suite(name):
    """(bins, class ids, max_depth, node_cap): integer bins with the NA bin
    occupied; ``sat`` caps the frontier at 8 nodes so depths 3.. form a
    saturated run, whose carry holds the class tree's scores."""
    rng = np.random.default_rng(3)
    bins = rng.integers(0, 16, (960, 7)).astype(np.uint8)
    y = ((bins[:, 0] > 7).astype(int) + (bins[:, 1] > 11)
         + rng.integers(0, 2, 960)) % 3
    return bins, y.astype(np.float32), (3, 2048) if name == "plain" else (6, 8)


def _int_grad(F, y, w):
    """Integer-valued (n, 3) targets that depend on F, unit hessians: every
    histogram sum is exact, and a class tree that read a column moved
    earlier in its iteration would see other targets."""
    Y1h = (y[:, None] == torch.arange(3)).to(torch.float32)
    return 4 * Y1h - torch.floor(2 * F), torch.ones_like(F) * w[:, None]


@pytest.mark.parametrize("suite", ["plain", "sat"])
def test_whole_tree_classes_bit_equal_to_eager_control(suite):
    """Three iterations of three class trees by the whole-tree build
    (iteration head, then one body per class tree at the device class
    slot) against the eager control (targets of every class from F as the
    iteration found it, then ``build_tree`` per class on its column): every
    record field of every class tree bit-equal up to the level the eager
    loop stopped at, the later whole-tree levels all-leaf and zero-valued;
    F and varimp equal."""
    bins, y, (depth, cap) = _tie_suite(suite)
    n, C = bins.shape
    lrs = np.array([0.5, 0.25, 0.125], np.float32)
    kw = dict(n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=depth,
              min_rows=1.0, min_split_improvement=0.0, node_cap=cap)
    b, yt, w = torch.from_numpy(bins), torch.from_numpy(y), torch.ones(n)
    wF, wvi, stk = pst.build_trees_scanned(
        b, w, yt, torch.zeros(n, 3), torch.zeros(C), len(lrs),
        grad_fn=_int_grad, grad_key=("int3",), learn_rates=lrs,
        n_classes=3, **kw)
    assert stk[0]["leaf_now"].shape[0] == 9
    whole = pst.trees_from_stacked(stk, 9)
    F, vi = torch.zeros(n, 3), torch.zeros(C)
    for it, lr in enumerate(lrs):
        T, H = _int_grad(F, yt, w)
        cols = []
        for k in range(3):
            tree, fk, vi = pst.build_tree(b, w, T[:, k], H[:, k],
                                          learn_rate=float(lr),
                                          preds=F[:, k], varimp=vi, **kw)
            cols.append(fk)
            eager, wt = tree.to_host().levels, whole[3 * it + k].levels
            for li, lv in enumerate(eager):
                for f in pst._REC_FIELDS:
                    assert getattr(lv, f).tobytes() == \
                        getattr(wt[li], f).tobytes(), (it, k, li, f)
            for lv in wt[len(eager):]:
                assert lv.leaf_now.all() and not lv.leaf_val.any()
        F = torch.stack(cols, dim=1)
    assert torch.equal(F, wF) and torch.equal(vi, wvi)
    # a chunk replayed onto (n, K) scores gives the build's F
    assert torch.equal(pst.replay_batch(b, stk, torch.zeros(n, 3)), wF)


def test_validation_and_early_stopping_on_mean_per_class_error(data):
    """A validation frame and stopping_rounds on mean_per_class_error: the
    same scoring history tree counts and stop tree count as JAX, before
    ntrees, and the validation metrics within 1e-5 (logloss)."""
    _, jf, pf = data
    dv = multiclass_df(n=800, seed=1)
    kw = dict(_GBM_KW, ntrees=20, learn_rate=0.5, score_tree_interval=2,
              stopping_rounds=2, stopping_metric="mean_per_class_error",
              stopping_tolerance=0.01)
    jm = JGBM(**kw).train(y="label", training_frame=jf,
                          validation_frame=JFrame.from_pandas(dv))
    est = H2OGradientBoostingEstimator(**kw)
    est.train(y="label", training_frame=pf, validation_frame=
              h2o3_tpu_torch.upload_file(dv, device="cpu"))
    m = est.model
    assert m.output["ntrees_actual"] == jm.output["ntrees_actual"] < 20
    hist, jh = m.scoring_history, jm.scoring_history
    assert [h["ntrees"] for h in hist] == [h["ntrees"] for h in jh]
    for a, b in zip(hist, jh):
        assert a.keys() == b.keys() == {"ntrees",
                                        "training_mean_per_class_error",
                                        "validation_mean_per_class_error"}
        for k in a:
            assert abs(a[k] - b[k]) < 1e-5, (a, b)
    vm, jvm = m.validation_metrics, jm.validation_metrics
    assert abs(vm.logloss - jvm.logloss) < 1e-5
    assert vm.nobs == jvm.nobs == 800


def test_gbm_from_numpy_multinomial_predicts_like_jax(data, jax_gbm):
    """A JAX multinomial model's weights, handed over as numpy (groups of
    three class trees, three init scores), predict in the port what they
    predict in JAX."""
    _, _, pf = data
    jm, jprobs = jax_gbm
    spec = jm.output["bin_spec"]
    out = {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards", "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f)) for f in pst.REPLAY_FIELDS}
                    for lv in t.levels] for t in group]
                  for group in jm.output["trees"]],
        "init_f": np.asarray(jm.output["init_f"]),
        "n_tree_classes": jm.output["n_tree_classes"],
        "distribution": jm.output["distribution"],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
    }
    m = gbm_from_numpy(out, device="cpu")
    np.testing.assert_allclose(_probs(m.predict(pf), pf.nrow), jprobs,
                               atol=1e-6)
    bad = dict(out, trees=[g[:2] for g in out["trees"]])
    with pytest.raises(ValueError, match="n_tree_classes"):
        gbm_from_numpy(bad, device="cpu")
