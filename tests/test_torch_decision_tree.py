"""The single decision tree in the port (``h2o3_tpu_torch.models.tree.
decision_tree``) against the JAX package's (``h2o3_tpu.models.
decision_tree``) on the CPU, at small sizes, inputs made with numpy from
seeds. The features sit on an integer grid and the regression target on a
grid of quarters, so both packages' bins and histogram sums (direct or by
sibling subtraction) are exact: a split decision or a leaf mean cannot
turn on a float sum's order.

Tolerances, with their reasons:
- every level's split column, bin, NA side and leaf flag equal;
- the predictions within 1e-6 (the leaf means are float32 quotients of
  float32 sums whose order differs);
- a JAX tree carried across (``convert_more.dt_from_numpy``) predicts
  within 1e-6 of JAX, and a save/load round trip is exact.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.decision_tree import DT as JDT  # noqa: E402
from h2o3_tpu_torch.estimators import H2ODecisionTreeEstimator  # noqa: E402
from h2o3_tpu_torch.models.convert_more import dt_from_numpy  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402

SPLIT_FIELDS = ("split_col", "split_bin", "na_left", "leaf_now")


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """No entries written to JAX's shared persistent compilation cache
    (it writes in place without a lock; see test_torch_frame_ops.py)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(2)
    n = 2000
    X = rng.integers(0, 20, (n, 5)).astype(np.float64)
    X[rng.random((n, 5)) < 0.03] = np.nan
    logit = np.nan_to_num(X[:, 0]) * 0.3 - np.nan_to_num(X[:, 1]) * 0.2 \
        + rng.normal(size=n)
    df = pd.DataFrame(X, columns=[f"f{i}" for i in range(5)])
    df["g"] = pd.Categorical(rng.choice(["a", "b", "c", "d"], n))
    df["y"] = pd.Categorical.from_codes((logit > 1).astype(int), ["n", "p"])
    df["r"] = np.round(logit * 4) / 4  # quarter steps: exact float32 sums
    df["k"] = pd.Categorical.from_codes(rng.integers(0, 3, n),
                                        ["u", "v", "w"])
    return df


def _pair(df, y, **kw):
    d = df[[c for c in df.columns if c not in {"y", "r", "k"} - {y}]]
    jf = JFrame.from_pandas(d)
    pf = h2o3_tpu_torch.upload_file(d, device="cpu")
    jm = JDT(**kw).train(y=y, training_frame=jf)
    est = H2ODecisionTreeEstimator(**kw)
    est.train(y=y, training_frame=pf)
    return jm, est, jf, pf


@pytest.fixture(scope="module")
def pairs(data):
    """Both packages' trees at JAX's defaults (depth 10, min_rows 10),
    binary and regression, trained once for the module."""
    return {y: _pair(data, y) for y in ("y", "r")}


def _levels(m):
    return m.output["trees"][0][0].to_host().levels


@pytest.mark.parametrize("y", ["y", "r"])
def test_tree_equals_jax(data, pairs, y):
    """Binary classification and regression at JAX's defaults: the same
    splits at every level, predictions within 1e-6."""
    jm, est, jf, pf = pairs[y]
    ja, pa = _levels(jm), _levels(est.model)
    assert len(ja) == len(pa)
    for a, b in zip(ja, pa):
        for f in SPLIT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))
    n = len(data)
    want = np.asarray(jm._predict_raw(jf))[:n]
    got = est.model._predict_raw(pf).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if y == "y":
        assert abs(est.auc() - jm.training_metrics.value("auc")) < 1e-9
        assert list(est.predict(pf).names) == ["predict", "n", "p"]


def test_more_than_two_classes_refused(data):
    pf = h2o3_tpu_torch.upload_file(data.drop(columns=["y", "r"]),
                                    device="cpu")
    with pytest.raises(ValueError, match="binary classification only"):
        H2ODecisionTreeEstimator().train(y="k", training_frame=pf)


def test_jax_tree_carried_across_and_round_trip(data, pairs, tmp_path):
    jm, est, jf, pf = pairs["y"]
    spec = jm.output["bin_spec"]
    out = {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards",
                      "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f))
                     for f in pst.REPLAY_FIELDS} for lv in _levels(jm)]]],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
    }
    pm = dt_from_numpy(out, device="cpu")
    want = np.asarray(jm._predict_raw(jf))[: len(data)]
    np.testing.assert_allclose(pm._predict_raw(pf).numpy(), want, rtol=0,
                               atol=1e-6)
    path = h2o3_tpu_torch.save_model(est.model, str(tmp_path) + "/")
    back = h2o3_tpu_torch.load_model(path, device="cpu")
    assert back.algo == "dt"
    np.testing.assert_array_equal(back._predict_raw(pf).numpy(),
                                  est.model._predict_raw(pf).numpy())


def test_flat_bytes_of_a_one_element_slice():
    """A decision tree's root record holds one-element column slices of a
    (1, 3) tensor (stride 3); the save's packed pull takes each tensor as
    one flat run of bytes, which a byte view of such a slice refuses
    unless the flat view has stride 1."""
    from h2o3_tpu_torch.persist import _flat_bytes

    t = torch.arange(12.0).reshape(4, 3)
    for x in (t[:1, 0], t[:, 1], t[:0, 0], t.T):
        b = _flat_bytes(x)
        assert torch.equal(b.view(torch.float32), x.contiguous().reshape(-1))
