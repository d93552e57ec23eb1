"""Interaction columns and feature hashing in the port's ``DataInfo``
(``h2o3_tpu_torch.models.datainfo``) against the JAX package's, on the CPU
at 2,500 rows with ``device="cpu"``, and GLMs trained on such designs.

Tolerances, with their reasons:
- specs, coefficient names and bucket tables: equal;
- a num×num product's mean and sigma: 1e-6 relative (JAX sums the
  product in float32, the port in float64);
- ``transform`` with JAX's fitted statistics: exact — the same float32
  products, subtractions and divisions by the same float32-rounded
  constants, and 0/1 indicators;
- a training on an interaction and hashed design against JAX:
  coefficients within 1e-4, iteration counts equal (the single-response
  trainings' bound, ``test_torch_glm.py``);
- a JAX model carried across (``glm_from_numpy``): predictions within
  1e-6 (the same float32 design and beta).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu.frame.frame import Frame as JFrame  # noqa: E402
from h2o3_tpu.models import datainfo as jdi  # noqa: E402
from h2o3_tpu.models.glm import GLM as JGLM  # noqa: E402
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator  # noqa: E402
from h2o3_tpu_torch.models import datainfo as pdi  # noqa: E402
from h2o3_tpu_torch.models.glm import glm_from_numpy  # noqa: E402
from test_torch_glm import glm_df, jax_glm_numpy  # noqa: E402

PAIRS = [("c1", "c2"), ("x0", "x1"), ("c1", "x2"), ("x3", "c2")]
BASE = ["x0", "x1", "x2", "x3", "c1", "c2", "h"]


def ia_df(n=2500, seed=0):
    """``glm_df`` plus ``h``, a 40-level categorical with NAs (hashed at
    ``hash_buckets`` below 40)."""
    df = glm_df(n, seed)
    rng = np.random.default_rng(seed + 7)
    levels = np.array([f"L{i:02d}" for i in range(40)])
    df["h"] = np.where(rng.random(n) < 0.04, None, levels[rng.integers(0, 40, n)])
    return df


@pytest.fixture(scope="module")
def frames():
    df = ia_df()
    return df, JFrame.from_pandas(df), h2o3_tpu_torch.upload_file(df, device="cpu")


def _fit_both(jf, pf, handling, standardize=True, buckets=16):
    kw = dict(standardize=standardize, use_all_factor_levels=False,
              missing_handling=handling, add_intercept=True,
              interaction_pairs=PAIRS, hash_buckets=buckets)
    return jdi.DataInfo.fit(jf, BASE, **kw), pdi.DataInfo.fit(pf, BASE, **kw)


@pytest.mark.parametrize("handling,standardize",
                         [("mean_imputation", True), ("skip", True),
                          ("mean_imputation", False)],
                         ids=["mean", "skip", "raw"])
def test_transform_exact(frames, handling, standardize):
    """cat×cat, num×num (NAs in x1) and cat×num (NAs in c1) pairs and a
    hashed column, fitted on the training frame and applied to it and to a
    scoring frame with an unseen level ('e' in c1, 'L99' in h), a missing
    level of c2 and its own level order: specs and names equal; with
    JAX's product statistics the matrices and masks are equal."""
    df, jf, pf = frames
    jd, pd_ = _fit_both(jf, pf, handling, standardize)
    assert pd_.coef_names() == jd.coef_names()
    assert pd_.ncols_expanded == jd.ncols_expanded
    assert pd_.hash_buckets == jd.hash_buckets
    for a, b in zip(pd_.columns, jd.columns):
        assert (a.name, a.kind, a.offset, a.width, a.domain, a.pair,
                a.pair_domains) == (b.name, b.kind, b.offset, b.width,
                                    b.domain, b.pair, b.pair_domains)
        for u, v in zip((a.mean, a.sigma) + tuple(a.pair_means or ()),
                        (b.mean, b.sigma) + tuple(b.pair_means or ())):
            assert abs(u - v) <= 1e-6 * max(1.0, abs(v))
        a.mean, a.sigma, a.pair_means = b.mean, b.sigma, b.pair_means
    sdf = ia_df(n=300, seed=5)
    sdf.loc[:20, "c1"] = "e"
    sdf.loc[21:30, "h"] = "L99"
    sdf["c2"] = sdf["c2"].replace("q", "p")
    for j_frame, p_frame in ((jf, pf),
                             (JFrame.from_pandas(sdf),
                              h2o3_tpu_torch.upload_file(sdf, device="cpu"))):
        JX, jv = jd.transform(j_frame)
        PX, pv = pd_.transform(p_frame)
        n = p_frame.nrow
        np.testing.assert_array_equal(PX.numpy(), np.asarray(JX)[:n])
        np.testing.assert_array_equal(pv.numpy(), np.asarray(jv)[:n])


def test_hash_table_and_cache(frames):
    """The bucket table is JAX's, level for level; it is built once per
    domain and column, and rebuilt for a frame with another domain."""
    _, jf, pf = frames
    v = pf.vec("h")
    lut = pdi._hash_lut(v.domain, "h", 16)
    np.testing.assert_array_equal(lut, np.asarray(jdi._hash_lut(
        jf.vec("h").domain, "h", 16)))
    _, di = _fit_both(jf, pf, "mean_imputation")
    c = next(c for c in di.columns if c.kind == "hash")
    assert c.width == 15
    a = di._hashed_codes(v, c)
    first = di._hash_luts["h"][1]
    di._hashed_codes(v, c)
    assert di._hash_luts["h"][1] is first
    other = h2o3_tpu_torch.upload_file(ia_df(50, seed=3)[["h"]], device="cpu")
    di._hashed_codes(other.vec("h"), c)
    assert di._hash_luts["h"][0] is other.vec("h").domain
    assert int(a.min()) == -1 and int(a.max()) < 16


@pytest.mark.parametrize("kw", [
    dict(family="gaussian", lambda_=1e-4, interaction_pairs=PAIRS[1:],
         hash_buckets=16),
    dict(family="binomial", lambda_=1e-4, interactions=["x0", "x2", "c2"]),
], ids=["pairs_hash", "interactions"])
def test_training_on_interactions_matches_jax(frames, kw):
    df, jf, pf = frames
    y = "ygauss" if kw["family"] == "gaussian" else "ybin"
    x = BASE if "hash_buckets" in kw else ["x0", "x1", "x2", "x3", "c2"]
    jm = JGLM(**kw).train(x=x, y=y, training_frame=jf)
    est = H2OGeneralizedLinearEstimator(**kw)
    est.train(x=x, y=y, training_frame=pf)
    pm = est.model
    assert list(pm.coef) == list(jm.coef)
    np.testing.assert_allclose(np.array(list(pm.coef.values())),
                               np.array(list(jm.coef.values())), atol=1e-4)
    assert [e["iters"] for e in pm.regularization_path] == \
        [e["iters"] for e in jm.output["regularization_path"]]
    assert pm.output["irls_stats"]["fallbacks"] == 0
    out = jax_glm_numpy(jm)
    for spec, c in zip(out["datainfo"]["columns"], jm.output["datainfo"].columns):
        spec.update(pair=c.pair, pair_means=c.pair_means,
                    pair_domains=c.pair_domains)
    out["datainfo"]["hash_buckets"] = jm.output["datainfo"].hash_buckets
    cm = glm_from_numpy(out, params=dict(response_column=y), device="cpu")
    col = "predict" if y == "ygauss" else "yes"
    np.testing.assert_allclose(
        cm.predict(pf).vec(col).to_numpy(),
        np.asarray(jm.predict(jf).vec(col).to_numpy())[: pf.nrow],
        rtol=1e-6, atol=1e-6)
