"""The GBM slice of the port (``h2o3_tpu_torch``) against the JAX package,
module by module and as a whole, on the CPU at small sizes. Inputs are made
with numpy from seeds and handed to both packages.

Tolerances, with their reasons:
- binning: edges and u8 codes byte-equal (same float32 arithmetic);
- distributions: 1e-6 (XLA's and PyTorch's sigmoid differ in the last ulp);
- partition update and leaf decision: exact (selection and one division);
- per-level tree build on tie suites: decisions bit-equal (integer sums);
- whole GBM: AUC within 1e-3 and probabilities within 1e-5 (the JAX build
  sums histograms across an 8-device mesh, the port on one device, so
  float32 sums round differently);
- weights converted from a JAX model: probabilities within 1e-6 (the same
  trees replayed with the same float32 adds).
"""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models.tree import GBM as JGBM  # noqa: E402
from h2o3_tpu.models.tree import binning as jbin  # noqa: E402
from h2o3_tpu.models.tree import distributions as jdist  # noqa: E402
from h2o3_tpu.models.tree import shared_tree as jst  # noqa: E402
from h2o3_tpu.parallel import mesh as pm  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator  # noqa: E402
from h2o3_tpu_torch.models.tree import binning as pbin  # noqa: E402
from h2o3_tpu_torch.models.tree import distributions as pdist  # noqa: E402
from h2o3_tpu_torch.models.tree import shared_tree as pst  # noqa: E402
from h2o3_tpu_torch.models.tree.convert import gbm_from_numpy  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GBM_KW = dict(ntrees=4, max_depth=3, learn_rate=0.1, min_rows=10.0, seed=42)


def _frame_df(n=5000, seed=0) -> pd.DataFrame:
    """5 numeric columns (NAs in two, ties in one) + one enum column with
    NAs, and a binary label that depends on both kinds."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    df = pd.DataFrame(X, columns=[f"x{i}" for i in range(5)])
    df.loc[rng.random(n) < 0.1, "x1"] = np.nan
    df.loc[rng.random(n) < 0.05, "x4"] = np.nan
    df["x3"] = np.round(df["x3"] * 2)
    levels = np.array(["lo", "mid", "hi", "top"])
    cat = rng.integers(0, 4, n)
    df["cat"] = np.where(rng.random(n) < 0.07, None, levels[cat])
    eta = (1.2 * X[:, 0] - X[:, 2] + 0.7 * (cat - 1.5)
           + 0.5 * np.nan_to_num(df["x1"].to_numpy()))
    y = rng.random(n) < 1 / (1 + np.exp(-eta))
    df["label"] = np.where(y, "s", "b")
    return df


@pytest.fixture(scope="module")
def data():
    df = _frame_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


@pytest.fixture(scope="module")
def jax_gbm(data):
    """One JAX reference GBM for the module (the resident default path)."""
    _, jf, _ = data
    m = JGBM(**_GBM_KW).train(y="label", training_frame=jf)
    probs = m.predict(jf).vec("s").to_numpy()[: jf.nrow]
    return m, np.asarray(probs, np.float64)


@pytest.mark.parametrize("col", ["x1", "x3", "cat", "label"])
def test_frame_columns_and_stats_match_jax(data, col):
    """upload_file against Frame.from_pandas: kind, domain, codes/values
    and the rollup stats (mean/sigma within 1e-6, counts exact)."""
    _, jf, pf = data
    jv, pv = jf.vec(col), pf.vec(col)
    assert pv.kind == jv.kind and pv.domain == jv.domain
    np.testing.assert_array_equal(pv.to_numpy(), np.asarray(jv.to_numpy())[: jf.nrow])
    js, ps = jv.stats(), pv.stats()
    assert ps.keys() == js.keys() and ps["naCnt"] == js["naCnt"]
    for k in ("mean", "sigma", "min", "max"):
        if k in js:
            assert abs(ps[k] - js[k]) <= 1e-6 * max(1.0, abs(js[k])), k
    if "levelCounts" in js:
        np.testing.assert_array_equal(ps["levelCounts"], js["levelCounts"])


@pytest.mark.parametrize("sample", [200_000, 2000], ids=["all-rows", "sampled"])
def test_binning_edges_and_codes_byte_equal(data, sample):
    """fit_bins/bin_frame on the CPU: the numpy quantile path, including the
    seeded ``rng.choice`` sample past ``sample`` rows."""
    _, jf, pf = data
    cols = [c for c in jf.names if c != "label"]
    js = jbin.fit_bins(jf, cols, sample=sample, seed=7)
    ps = pbin.fit_bins(pf, cols, sample=sample, seed=7)
    for f in ("is_cat", "nbins", "edges", "cards"):
        a, b = getattr(ps, f), getattr(js, f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert [None if d is None else tuple(d) for d in ps.domains] == \
        [None if d is None else tuple(d) for d in js.domains]
    jcodes = np.asarray(jbin.bin_frame(js, jf))[: jf.nrow]
    pcodes = pbin.bin_frame(ps, pf).numpy()
    assert pcodes.dtype == np.uint8 and pcodes.tobytes() == jcodes.tobytes()


def test_device_quantile_program_matches(data):
    """The GPU binning program (``_device_quantile_edges``), run on CPU
    tensors, gives the JAX device program's float32 edges and counts —
    equal values; an interpolation between two zeros may carry either sign,
    which no bin code can tell apart."""
    _, jf, pf = data
    names = ["x0", "x1", "x3"]
    ns = 3000
    for nb in (255, 20):
        e, m = jbin._device_quantile_edges(jf, names, nb, ns)
        idx = torch.from_numpy(
            np.round(np.linspace(0, jf.nrow - 1, ns)).astype(np.int64))
        X = torch.stack([pf.vec(c).data[idx] for c in names], dim=1)
        ep, mp = pbin._device_quantile_edges(X, nb)
        assert ep.dtype == torch.float32
        np.testing.assert_array_equal(ep.numpy(), np.asarray(e))
        np.testing.assert_array_equal(mp.numpy(), np.asarray(m))


@pytest.mark.parametrize("dist", ["bernoulli", "gaussian"])
def test_distributions_within_1e6(dist):
    rng = np.random.default_rng(1)
    f = rng.normal(size=1000).astype(np.float32)
    y = (rng.random(1000) < 0.4).astype(np.float32)
    w = rng.random(1000).astype(np.float32)
    tj, hj = jdist.grad_hess(dist, jnp.asarray(f), jnp.asarray(y), jnp.asarray(w))
    tp, hp = pdist.grad_hess(dist, *(torch.from_numpy(a) for a in (f, y, w)))
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(hp.numpy(), np.asarray(hj), rtol=1e-6, atol=1e-6)
    assert abs(pdist.init_score(dist, y, w) - jdist.init_score(dist, y, w)) < 1e-6
    np.testing.assert_allclose(
        pdist.response_transform(dist, torch.from_numpy(f)).numpy(),
        np.asarray(jdist.response_transform(dist, jnp.asarray(f))),
        rtol=1e-6, atol=1e-6)


def test_partition_update_and_leaf_decide_exact():
    rng = np.random.default_rng(2)
    n, C, N, B = 3000, 5, 8, 16
    bins = rng.integers(0, B, (n, C)).astype(np.uint8)
    nid = rng.integers(-1, N, n).astype(np.int32)
    preds = rng.normal(size=n).astype(np.float32)
    ok = rng.random(N) < 0.6
    node = {
        "gain": rng.random(N).astype(np.float32),
        "node_w": rng.random(N).astype(np.float32) * 50,
        "node_wy": rng.normal(size=N).astype(np.float32),
        "node_wh": rng.random(N).astype(np.float32) * 10,
        "split_col": rng.integers(0, C, N).astype(np.int32),
        "split_bin": rng.integers(1, B, N).astype(np.int32),
        "is_cat": rng.random(N) < 0.3,
        "cat_mask": rng.random((N, B)) < 0.5,
        "na_left": rng.random(N) < 0.5,
    }
    node["node_wh"][0] = 0.0  # the wh > 0 guard
    order = ("node_w", "node_wy", "node_wh", "split_col", "split_bin",
             "is_cat", "cat_mask", "na_left")
    jout = jst._leaf_decide(jnp.asarray(ok), jnp.asarray(node["gain"]),
                            *(jnp.asarray(node[k]) for k in order),
                            0.1, 5.0, N)
    pout = pst._leaf_decide(torch.from_numpy(ok), torch.from_numpy(node["gain"]),
                            *(torch.from_numpy(node[k]) for k in order),
                            0.1, 5.0, N)
    for k in ("leaf_now", "leaf_val", "child_base"):
        assert pout[5][k].numpy().tobytes() == np.asarray(jout[5][k]).tobytes(), k
    assert int(pout[4]) == int(jout[4])
    rec = jout[5]
    args = ("split_col", "split_bin", "is_cat", "cat_mask", "na_left",
            "leaf_now", "leaf_val", "child_base")
    jn, jp = jst._partition_update(jnp.asarray(bins), jnp.asarray(nid),
                                   jnp.asarray(preds), *(rec[k] for k in args))
    pn, pp = pst._partition_update(
        torch.from_numpy(bins), torch.from_numpy(nid), torch.from_numpy(preds),
        *(torch.from_numpy(np.array(rec[k])) for k in args))
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    assert pp.numpy().tobytes() == np.asarray(jp).tobytes()


def _tie_suite(name):
    n = 960
    rng = np.random.default_rng(3)
    if name == "duplicated-columns":
        base = rng.integers(1, 16, n).astype(np.uint8)
        bins = np.tile(base[:, None], (1, 16))
        t = (rng.integers(0, 2, n) * 2 - 1).astype(np.float32)
    else:  # integer targets, NA bins occupied, 7 columns (padded to 8)
        bins = rng.integers(0, 16, (n, 7)).astype(np.uint8)
        t = rng.integers(-3, 4, n).astype(np.float32)
    return bins, t


@pytest.mark.parametrize("suite", ["duplicated-columns", "integer-targets-na"])
def test_per_level_build_tree_decisions_equal(suite, monkeypatch):
    """JAX's per-level builder (H2O3_TPU_WHOLE_TREE=0) and the port's eager
    level loop (with sibling subtraction) record the same split columns,
    bins, NA directions, leaves and leaf values on integer-exact data."""
    monkeypatch.setenv("H2O3_TPU_WHOLE_TREE", "0")
    bins, t = _tie_suite(suite)
    n, C = bins.shape
    kw = dict(n_bins=16, is_cat_cols=np.zeros(C, bool), max_depth=4,
              min_rows=1.0, min_split_improvement=0.0, learn_rate=0.1)
    jt, jp, jv = jst.build_tree(
        pm.shard_rows(jnp.asarray(bins)), pm.shard_rows(jnp.ones(n)),
        pm.shard_rows(jnp.asarray(t)), pm.shard_rows(jnp.ones(n)),
        preds=pm.shard_rows(jnp.zeros(n)), key=jax.random.PRNGKey(5),
        varimp=jnp.zeros(C, jnp.float32), **kw)
    ones = torch.ones(n)
    pt, pp, pv = pst.build_tree(
        torch.from_numpy(bins), ones, torch.from_numpy(t), ones,
        preds=torch.zeros(n), varimp=torch.zeros(C), **kw)
    jh, ph = jt.to_host(), pt.to_host()
    assert len(ph.levels) == len(jh.levels)
    for li, (a, b) in enumerate(zip(ph.levels, jh.levels)):
        for f in ("split_col", "split_bin", "na_left", "leaf_now", "leaf_val",
                  "is_cat", "child_base"):
            assert getattr(a, f).tobytes() == np.asarray(getattr(b, f)).tobytes(), (li, f)
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-6)


def test_gbm_matches_jax(data, jax_gbm):
    """upload_file → H2OGradientBoostingEstimator.train → predict → auc on
    the CPU, against the JAX package's GBM on the same frame."""
    _, jf, pf = data
    jm, jprobs = jax_gbm
    est = H2OGradientBoostingEstimator(**_GBM_KW)
    est.train(y="label", training_frame=pf)
    assert abs(est.auc() - jm.training_metrics.auc) < 1e-3
    pred = est.predict(pf)
    assert pred.names == ["predict", "b", "s"]
    np.testing.assert_allclose(pred.vec("s").to_numpy(), jprobs, atol=1e-5)
    jtree = jm.output["trees"][0][0]
    ptree = est.model.output["trees"][0][0].to_host()
    np.testing.assert_array_equal(ptree.levels[0].split_col,
                                  np.asarray(jtree.levels[0].split_col))
    assert est.model.output["names"] == jm.output["names"]


def test_gaussian_gbm_and_model_performance(data):
    """A regression GBM (gaussian) against JAX, and model_performance on a
    frame, which re-scores through predict and _response_and_weights."""
    df, jf, pf = data
    kw = dict(ntrees=3, max_depth=3, min_rows=10.0, seed=42)
    jm = JGBM(**kw).train(y="x0", training_frame=jf)
    est = H2OGradientBoostingEstimator(**kw)
    est.train(y="x0", training_frame=pf)
    assert est.model.output["distribution"] == "gaussian"
    jp = np.asarray(jm.predict(jf).vec("predict").to_numpy())[: jf.nrow]
    np.testing.assert_allclose(est.predict(pf).vec("predict").to_numpy(), jp,
                               atol=1e-5)
    assert abs(est.rmse() - jm.training_metrics.rmse) < 1e-5
    perf = est.model_performance(pf)
    assert abs(perf.value("rmse") - est.rmse()) < 1e-6


def test_nbins_top_level_is_accepted_with_a_warning(data):
    """``nbins_top_level`` is taken, as JAX takes it, and has no effect:
    the static quantile bins are fit once; a value other than the default
    warns so."""
    _, _, pf = data
    kw = dict(_GBM_KW, ntrees=1)
    plain = H2OGradientBoostingEstimator(**kw).train(y="label",
                                                     training_frame=pf)
    with pytest.warns(UserWarning, match="nbins_top_level has no effect"):
        est = H2OGradientBoostingEstimator(nbins_top_level=64, **kw)
        est.train(y="label", training_frame=pf)
    assert est.model.params.nbins_top_level == 64
    np.testing.assert_array_equal(est.predict(pf).vec("s").to_numpy(),
                                  plain.predict(pf).vec("s").to_numpy())


def test_gbm_from_numpy_predicts_like_jax(data, jax_gbm):
    """A JAX model's weights, handed over as numpy, predict in the port
    what they predict in JAX."""
    _, _, pf = data
    jm, jprobs = jax_gbm
    spec = jm.output["bin_spec"]
    out = {
        "bin_spec": {f: getattr(spec, f) for f in
                     ("names", "is_cat", "nbins", "edges", "cards", "domains")},
        "trees": [[[{f: np.asarray(getattr(lv, f)) for f in pst.REPLAY_FIELDS}
                    for lv in t.levels] for t in group]
                  for group in jm.output["trees"]],
        "init_f": jm.output["init_f"],
        "distribution": jm.output["distribution"],
        "names": jm.output["names"],
        "response_domain": jm.output["response_domain"],
    }
    pm_ = gbm_from_numpy(out, device="cpu")
    np.testing.assert_allclose(pm_.predict(pf).vec("s").to_numpy(), jprobs,
                               atol=1e-6)


def test_import_guard_no_jax():
    """Importing the port pulls in neither JAX (nor flax or optax) nor any
    h2o3_tpu module."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import h2o3_tpu_torch, h2o3_tpu_torch.estimators\n"
        "import h2o3_tpu_torch.models.tree.convert\n"
        "import h2o3_tpu_torch.genmodel, h2o3_tpu_torch.models.export\n"
        "import h2o3_tpu_torch.models.tree.distributions\n"
        "import h2o3_tpu_torch.models.tree.gbm\n"
        "import h2o3_tpu_torch.models.tree.drf\n"
        "import h2o3_tpu_torch.models.tree.sampling\n"
        "import h2o3_tpu_torch.models.tree.shared_tree\n"
        "import h2o3_tpu_torch.models.metrics, h2o3_tpu_torch.models.model_base\n"
        "import h2o3_tpu_torch.ops.histogram, h2o3_tpu_torch.ops.split_cuda\n"
        "import h2o3_tpu_torch.ops.cuda_graph, h2o3_tpu_torch.ops.hist_tiles\n"
        "import h2o3_tpu_torch.datasets, h2o3_tpu_torch.tools.profile_gbm\n"
        "import h2o3_tpu_torch.tools.repeat_multinomial\n"
        "import h2o3_tpu_torch.models.glm, h2o3_tpu_torch.models.glm_families\n"
        "import h2o3_tpu_torch.models.datainfo, h2o3_tpu_torch.ops.gram\n"
        "import h2o3_tpu_torch.models.bfgs, h2o3_tpu_torch.frame.parse\n"
        "import h2o3_tpu_torch.models.tree.xgboost\n"
        "import h2o3_tpu_torch.tools.profile_glm, h2o3_tpu_torch.tools.bench_gram\n"
        "import h2o3_tpu_torch.models.deeplearning\n"
        "import h2o3_tpu_torch.tools.profile_dl, h2o3_tpu_torch.tools.dl_parity\n"
        "import h2o3_tpu_torch.tools.tree_parity\n"
        "import h2o3_tpu_torch.models.grid, h2o3_tpu_torch.models.ensemble\n"
        "import h2o3_tpu_torch.automl, h2o3_tpu_torch.automl.automl\n"
        "import h2o3_tpu_torch.tools.profile_automl\n"
        "import chip_smoke\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'h2o3_tpu', 'flax', 'optax'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_need_a_card_without_device(monkeypatch):
    """Without ``device=`` an entry point resolves to ``cuda``; with no GPU
    it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = _frame_df(n=50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        h2o3_tpu_torch.upload_file(df)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gbm_from_numpy({"bin_spec": {}, "trees": [], "init_f": 0.0,
                        "distribution": "bernoulli", "names": []})
    assert h2o3_tpu_torch.upload_file(df, device="cpu").device.type == "cpu"
