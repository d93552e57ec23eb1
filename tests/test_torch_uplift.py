"""UpliftDRF in the port (``h2o3_tpu_torch.models.uplift``) against the JAX
package (``h2o3_tpu.models.uplift``) on the CPU, at small sizes, inputs
made with numpy from seeds; and the Criteo-shaped generator
(``datasets.criteo_uplift_like``).

Tolerances, with their reasons:
- the split scan on an integer-count histogram: decisions (column, bin,
  NA side, categorical mask, validity) equal, gains and uplifts within
  1e-6 (the same float32 divergence formulas; a log may round apart by an
  ulp);
- the forest at ``sample_rate`` 1 and all columns (nothing drawn): every
  real split and leaf equal, leaf values and ``uplift_predict`` within
  1e-6; AUUC, qini and ATE within 1e-9 (float64 host sums over the same
  predictions);
- the generator's rates within a few standard errors of the published
  ones.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import uplift as ju  # noqa: E402
from h2o3_tpu_torch.datasets import criteo_uplift_like  # noqa: E402
from h2o3_tpu_torch.estimators import (  # noqa: E402
    H2OUpliftRandomForestEstimator,
)
from h2o3_tpu_torch.models import uplift as pu  # noqa: E402

_TYPES = {"treatment": "enum", "visit": "enum", "conversion": "enum",
          "seg": "enum"}


def test_criteo_uplift_like_has_the_published_shape():
    """12 float features, treatment at 85%, visit at 4.70%, conversion at
    0.29% (Diemert et al., AdKDD 2018), and the generated effect's mean."""
    df = criteo_uplift_like(200_000, seed=0)
    assert list(df.columns) == [f"f{i}" for i in range(12)] + [
        "treatment", "visit", "conversion"]
    assert all(df[f"f{i}"].dtype == np.float32 for i in range(12))
    rate = {c: float((df[c] == "1").mean())
            for c in ("treatment", "visit", "conversion")}
    assert abs(rate["treatment"] - 0.85) < 0.005
    assert abs(rate["visit"] - 0.047) < 0.002
    assert abs(rate["conversion"] - 0.0029) < 0.0006
    t = df["treatment"] == "1"
    v = df["visit"] == "1"
    ate = v[t].mean() - v[~t].mean()
    assert 0.0 < df.attrs["ate_visit"] < 0.02
    assert abs(ate - df.attrs["ate_visit"]) < 0.004
    assert criteo_uplift_like(1000, seed=3).equals(
        criteo_uplift_like(1000, seed=3))


def _random_hist(seed=0, N=4, C=3, B=16):
    """Integer counts: w_t and w_c per cell, their positives below them."""
    rng = np.random.default_rng(seed)
    wt = rng.integers(0, 30, (N, C, B)).astype(np.float32)
    wc = rng.integers(0, 30, (N, C, B)).astype(np.float32)
    wt[:, :, 3] = 0  # an empty treatment cell
    yt = np.floor(wt * rng.random((N, C, B))).astype(np.float32)
    yc = np.floor(wc * rng.random((N, C, B))).astype(np.float32)
    return np.stack([wt, yt, wc, yc], axis=-1)


@pytest.mark.parametrize("metric", ["kl", "chisquared", "euclidean"])
def test_uplift_split_scan_equals_jax(metric):
    """JAX's ``_uplift_split_scan`` and the port's on one histogram with a
    categorical column and a column masked off."""
    h = _random_hist()
    is_cat = np.array([False, True, False])
    col_mask = np.ones((4, 3), np.float32)
    col_mask[2, 0] = 0.0
    j = jax.jit(ju._uplift_split_scan, static_argnums=5)(
        jnp.asarray(h), jnp.asarray(is_cat), jnp.asarray(col_mask), 10.0,
        1e-5, metric)
    p = pu._uplift_split_scan(torch.from_numpy(h), torch.from_numpy(is_cat),
                              torch.from_numpy(col_mask), 10.0, 1e-5, metric)
    assert j.keys() == p.keys()
    for k in ("ok", "col", "is_cat", "split_bin", "na_left", "cat_mask"):
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]), k)
    for k in ("gain", "node_w", "uplift"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert p["ok"].any()


def _uplift_df(n=3000, seed=5):
    """The Criteo shape's first 6 features, plus a 4-level factor that
    moves the effect (the categorical scan), at visit rates a small frame
    can split on."""
    rng = np.random.default_rng(seed)
    df = criteo_uplift_like(n, seed=seed)[[f"f{i}" for i in range(6)]
                                          + ["treatment"]]
    seg = rng.integers(0, 4, n)
    t = df["treatment"] == "1"
    p = 0.2 + 0.25 * t * (seg >= 2) + 0.1 * (df["f1"] > 0)
    df["seg"] = np.array(["a", "b", "c", "d"])[seg]
    df["visit"] = np.where(rng.random(n) < p, "1", "0")
    return df


_KW = dict(ntrees=3, max_depth=4, sample_rate=1.0, seed=11,
           treatment_column="treatment", min_rows=10.0)


@pytest.fixture(scope="module")
def forests():
    df = _uplift_df()
    jf = JFrame.from_pandas(df, column_types=_TYPES)
    jm = ju.UpliftDRF(**_KW).train(y="visit", training_frame=jf)
    pf = h2o3_tpu_torch.upload_file(df, col_types=_TYPES, device="cpu")
    pm_ = H2OUpliftRandomForestEstimator(**_KW).train(
        y="visit", training_frame=pf).model
    return df, jf, pf, jm, pm_


def _real_nodes(tree):
    """(level, node, split or leaf value) of every real node."""
    out, n_real = [], 1
    for li, lv in enumerate(tree.levels):
        leaf = np.asarray(lv.leaf_now)
        real = np.arange(len(leaf)) < n_real
        for node in np.nonzero(real)[0]:
            if leaf[node]:
                out.append((li, int(node), float(np.asarray(lv.leaf_val)[node])))
            else:
                cat = bool(np.asarray(lv.is_cat)[node])
                out.append((li, int(node), int(np.asarray(lv.split_col)[node]),
                            int(np.asarray(lv.split_bin)[node]), cat,
                            bool(np.asarray(lv.na_left)[node]),
                            tuple(np.asarray(lv.cat_mask)[node]) if cat
                            else ()))
        n_real = 2 * int(np.sum(~leaf & real))
    return out


def test_upliftdrf_matches_jax(forests):
    """At ``sample_rate`` 1 with all columns the forest is JAX's: every
    real split (categorical masks included) and leaf equal, leaf values,
    ``uplift_predict`` and varimp within 1e-6, AUUC, qini and ATE within
    1e-9."""
    df, jf, pf, jm, pm_ = forests
    jt, pt = jm.output["trees"], pm_.output["trees"]
    assert len(jt) == len(pt) == _KW["ntrees"]
    n_split = 0
    for a, b in zip(jt, pt):
        ra, rb = _real_nodes(a), _real_nodes(b)
        assert [r[:2] + (len(r),) for r in ra] == [r[:2] + (len(r),)
                                                   for r in rb]
        for x, y in zip(ra, rb):
            if len(x) == 3:
                assert y[2] == pytest.approx(x[2], abs=1e-6)
            else:
                assert x == y
                n_split += 1
    assert n_split >= 4 and any(r[4] for t in pt for r in _real_nodes(t)
                                if len(r) > 3)
    ju_pred = np.asarray(jm._predict_raw(jf))[: len(df)]
    p = pm_.predict(pf)
    assert p.names == ["uplift_predict"]
    np.testing.assert_allclose(p.vec("uplift_predict").to_numpy(), ju_pred,
                               atol=1e-6)
    np.testing.assert_allclose(pm_.output["varimp"], jm.output["varimp"],
                               rtol=1e-6, atol=1e-6)
    for k in ("auuc", "qini", "ate"):
        assert pm_.training_metrics.value(k) == pytest.approx(
            jm.training_metrics.value(k), abs=1e-9), k


def test_auuc_metrics_equal_jax_on_the_same_predictions(forests):
    """The metric function alone, in float64 on the host, on one set of
    predictions with ties."""
    df = forests[0]
    u = np.round(np.random.default_rng(0).normal(size=len(df)), 1)
    y = (df["visit"] == "1").to_numpy().astype(np.float64)
    t = (df["treatment"] == "1").to_numpy().astype(np.float64)
    j, p = ju._auuc_metrics(u, y, t), pu._auuc_metrics(u, y, t)
    for k in ("auuc", "qini", "ate", "nobs"):
        assert p.value(k) == pytest.approx(j._v[k], abs=1e-12)


def test_upliftdrf_draws_are_keyed_by_the_seed(forests):
    """With a bootstrap and an mtries draw the forest changes and is the
    same again for the same seed."""
    pf = forests[2]
    kw = {**_KW, "sample_rate": 0.632, "mtries": 3}
    a, b = (H2OUpliftRandomForestEstimator(**kw).train(
        y="visit", training_frame=pf).model for _ in range(2))
    base = [_real_nodes(t) for t in forests[4].output["trees"]]
    got = [_real_nodes(t) for t in a.output["trees"]]
    assert got == [_real_nodes(t) for t in b.output["trees"]]
    assert got != base


@pytest.mark.parametrize("kw,y,match", [
    (dict(treatment_column="f0"), "visit", "2-level factor"),
    (dict(uplift_metric="bogus"), "visit", "uplift_metric"),
    (dict(), "f1", "binary categorical response"),
    (dict(ntrees=0), "visit", "ntrees and max_depth"),
])
def test_upliftdrf_refusals_as_jax(forests, kw, y, match):
    """JAX's builder checks, with its messages."""
    pf = forests[2]
    with pytest.raises(ValueError, match=match):
        H2OUpliftRandomForestEstimator(**{**_KW, **kw}).train(
            y=y, training_frame=pf)
