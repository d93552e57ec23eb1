"""Word2Vec and the generic model (``import_mojo``) in the port
(``h2o3_tpu_torch.models``) against the JAX package's on the CPU, at small
sizes, inputs made with numpy from seeds.

Tolerances, with their reasons:
- Word2Vec: the vocabulary, the training pairs and the random stream
  after them equal (the port draws the subsampling and the windows as
  arrays from the same generator and builds the pairs with array
  arithmetic; here they are held against JAX's one-call-at-a-time loops,
  copied below); the embeddings within 1e-5 of the largest |E| (the same
  float32 steps, with sums and the sigmoid rounded by another library);
  ``find_synonyms`` the same words, similarities within 1e-5, and
  ``transform`` (``NONE`` and ``AVERAGE``) within 1e-5;
- the generic model: the bounds of JAX's own
  ``test_generic_model_reimport_scores_live``: probabilities within 1e-5
  of the trained model's and labels equal on more than 99.9% of the rows,
  for a binomial, a multinomial and a regression GBM artifact.

JAX's own re-import test fails its label bound (agreement 0.99733). The
cause: the max-F1 threshold is one of the training predictions, so every
row of the leaf combination that set it sits exactly on it; the live
model sums its float32 leaves in float32, the offline scorer in float64,
so the re-imported p1 of those rows can fall one float32 ulp under the
threshold and the label flips (4 rows of 1,500 there, each within 3e-8).
The port's scorer shares the cause; its generic model scores the rows
near the threshold again in the trained model's float32 arithmetic
(:func:`test_labels_at_the_threshold_are_the_trained_models`).
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
from h2o3_tpu.models.word2vec import Word2Vec as JWord2Vec  # noqa: E402
from h2o3_tpu_torch import estimators as E  # noqa: E402
from h2o3_tpu_torch.models import convert_more as cm  # noqa: E402
from h2o3_tpu_torch.models import word2vec as pw2v  # noqa: E402
from test_export_persist import _df  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """No entries written to JAX's shared persistent compilation cache
    (it writes in place without a lock; see test_torch_frame_ops.py)."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


def _round_trip(model, tmp_path):
    path = h2o3_tpu_torch.save_model(model, str(tmp_path) + "/")
    back = h2o3_tpu_torch.load_model(path, device="cpu")
    assert type(back) is type(model) and back.key == model.key
    return back


# --------------------------------------------------------------------------
# Word2Vec


def _corpus(n_tokens=3000, vocab=60, seed=3):
    """Zipf-like words in sentences of 5-15 tokens, NA between sentences,
    and a few rare words under the frequency floor."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, vocab + 1)
    p /= p.sum()
    toks = []
    while len(toks) < n_tokens:
        k = int(rng.integers(5, 16))
        toks += [f"w{i}" for i in rng.choice(vocab, k, p=p)]
        if rng.random() < 0.1:
            toks.append(f"rare{int(rng.integers(0, 50))}")
        toks.append(None)
    return pd.DataFrame({"word": toks})


def _jax_pairs(words_raw, vocab, keep_p, window, rng):
    """JAX's pair loops (``h2o3_tpu/models/word2vec.py``), one draw per
    call."""
    sents = [[]]
    for w in words_raw:
        if w is None:
            if sents[-1]:
                sents.append([])
            continue
        wi = vocab.get(w)
        if wi is not None and rng.random() < keep_p[wi]:
            sents[-1].append(wi)
    centers, contexts = [], []
    for s in sents:
        for i, c in enumerate(s):
            win = rng.integers(1, window + 1)
            for j in range(max(0, i - win), min(len(s), i + win + 1)):
                if j != i:
                    centers.append(c)
                    contexts.append(s[j])
    return np.asarray(centers, np.int32), np.asarray(contexts, np.int32)


@pytest.fixture(scope="module")
def w2v_pair():
    df = _corpus()
    jf = JFrame.from_pandas(df, column_types={"word": "string"})
    pf = h2o3_tpu_torch.upload_file(df, col_types={"word": "string"},
                                    device="cpu")
    kw = dict(vec_size=16, window_size=3, min_word_freq=3, epochs=3, seed=5)
    jm = JWord2Vec(**kw).train(training_frame=jf)
    est = E.H2OWord2vecEstimator(**kw)
    est.train(training_frame=pf)
    return df, jf, pf, jm, est.model


def test_word2vec_pairs_are_jax_draws(w2v_pair):
    """The vectorized pairs equal JAX's loops, draw for draw, and leave
    the generator where JAX's leave it."""
    df, _, pf, jm, pm = w2v_pair
    words_raw = pf.vec(0).to_numpy()
    assert words_raw[df["word"].isna().to_numpy()].tolist() == [None] * int(
        df["word"].isna().sum())
    words, vocab, counts = pw2v.vocabulary(
        [w for w in words_raw if w is not None], 3)
    assert words == jm.output["words"] == pm.output["words"]
    assert vocab == jm.output["vocab"]
    keep_p = np.minimum(1.0, np.sqrt(1e-3 * counts.sum()
                                     / np.maximum(counts, 1)))
    assert (keep_p < 1).any()  # the subsampling draws decide
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    jc, jx = _jax_pairs(words_raw, vocab, keep_p, 3, r1)
    pc, px = pw2v.training_pairs(words_raw, vocab, keep_p, 3, r2)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(px, jx)
    assert r1.integers(0, 2 ** 62) == r2.integers(0, 2 ** 62)
    assert (jm.training_metrics._v["train_pairs"]
            == pm.training_metrics._v["train_pairs"] == len(jc))


def test_word2vec_equals_jax(w2v_pair, tmp_path):
    """Embeddings, synonyms and both transforms as JAX's; carried across
    and round tripped."""
    df, jf, pf, jm, pm = w2v_pair
    JE, PE = np.asarray(jm.output["embeddings"]), pm.output["embeddings"]
    np.testing.assert_allclose(PE, JE, atol=1e-5 * np.abs(JE).max())
    for word in ("w0", "w3", "w17"):
        js, ps = jm.find_synonyms(word, 5), pm.find_synonyms(word, 5)
        assert list(js) == list(ps)
        np.testing.assert_allclose(list(ps.values()), list(js.values()),
                                   atol=1e-5)
    assert pm.find_synonyms("rare1") == {}
    for how in ("NONE", "AVERAGE"):
        jt = jm.transform(jf, aggregate_method=how).to_pandas().to_numpy()
        pt = pm.transform(pf, aggregate_method=how).to_pandas().to_numpy()
        assert jt.shape == pt.shape
        np.testing.assert_allclose(pt, jt[: len(pt)], atol=1e-5)
    carried = cm.word2vec_from_numpy(dict(jm.output,
                                          embeddings=JE))
    assert carried.find_synonyms("w3", 5) == jm.find_synonyms("w3", 5)
    back = _round_trip(pm, tmp_path)
    np.testing.assert_array_equal(back.output["embeddings"], PE)
    assert back.find_synonyms("w3", 5) == pm.find_synonyms("w3", 5)


# --------------------------------------------------------------------------
# the generic model


def _gbm_and_generic(df, y, tmp_path, **kw):
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    est = E.H2OGradientBoostingEstimator(**kw)
    est.train(y=y, training_frame=fr)
    path = est.download_mojo(str(tmp_path))
    key = f"generic_{y}_{kw.get('seed', 0)}"
    g = h2o3_tpu_torch.import_mojo(path, model_id=key)
    assert h2o3_tpu_torch.get_model(key) is g
    assert g.output["source_algo"] == "gbm"
    return fr, est.model, g


def _multiclass(n=1500, seed=8):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    cls = np.argmax(X + rng.normal(scale=0.7, size=(n, 3)), axis=1)
    df = pd.DataFrame(X, columns=["a", "b", "c"])
    df["k"] = rng.choice(["p", "q", "r", "s"], n)
    df["y"] = np.array(["u", "v", "w"])[cls]
    return df


@pytest.mark.parametrize("case", ["binomial", "multinomial", "regression"])
def test_generic_model_scores_as_the_trained_model(case, tmp_path):
    """A binomial, a multinomial and a regression GBM artifact re-imported
    with ``import_mojo``: probabilities within 1e-5 of the trained model's
    and labels equal on more than 99.9% of the rows (JAX's bounds)."""
    if case == "multinomial":
        df, cols = _multiclass(), ["u", "v", "w"]
    else:
        df = _df(seed=21, classification=case == "binomial")
        cols = ["pos", "neg"] if case == "binomial" else ["predict"]
    fr, m, g = _gbm_and_generic(df, "y", tmp_path, ntrees=10, max_depth=4,
                                seed=3)
    pa, pb = m.predict(fr), g.predict(fr)
    assert pb.names == pa.names
    for c in cols:
        np.testing.assert_allclose(pb.vec(c).to_numpy(), pa.vec(c).to_numpy(),
                                   atol=1e-5)
    if case != "regression":
        la, lb = pa.vec("predict").to_numpy(), pb.vec("predict").to_numpy()
        assert (la == lb).mean() > 0.999
    # the model saves its artifact's contents, as JAX's does: the file
    # can go
    (zip_path,) = tmp_path.glob("*.zip")
    zip_path.unlink()
    back = _round_trip(g, tmp_path / "saved")
    np.testing.assert_array_equal(back.predict(fr).vec(cols[0]).to_numpy(),
                                  pb.vec(cols[0]).to_numpy())
    assert back.output["source_algo"] == "gbm"


def test_labels_at_the_threshold_are_the_trained_models(tmp_path):
    """JAX's re-import case (5 trees of depth 3 on its frame) in the port.
    The max-F1 threshold is one of the training predictions, so rows sit
    exactly on it, and the offline scorer's float64 sums give those rows
    another P(class 1) than the trained model's float32 sums (checked
    here: the cause of JAX's failing labels). The generic model scores the
    rows near the threshold again in the trained model's arithmetic:
    every label and every such row's probability is the trained
    model's."""
    df = _df(seed=14)
    fr, m, g = _gbm_and_generic(df, "y", tmp_path, ntrees=5, max_depth=3,
                                seed=3)
    thr = m.training_metrics._v["default_threshold"]
    pa, pb = m.predict(fr), g.predict(fr)
    a, b = pa.vec("pos").to_numpy(), pb.vec("pos").to_numpy()
    at_thr = a == np.float32(thr)
    assert at_thr.sum() >= 2  # the leaf combination that set it
    scored = g._mojo.score_raw(g._mojo._rows_to_table(fr.to_pandas()))[:, 1]
    assert (scored[at_thr] != a[at_thr]).all()
    np.testing.assert_array_equal(b[at_thr], a[at_thr])
    np.testing.assert_allclose(b, a, atol=1e-7)
    np.testing.assert_array_equal(pb.vec("predict").to_numpy(),
                                  pa.vec("predict").to_numpy())
