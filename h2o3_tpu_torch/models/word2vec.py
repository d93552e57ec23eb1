"""Word2Vec — the port of ``h2o3_tpu/models/word2vec.py`` (the successor of
``hex.word2vec.Word2Vec``): skip-gram with negative sampling.

The words stay on the host (the port's ``Frame`` keeps string columns
there, an NA token as ``None``), as in JAX. The vocabulary (the words with
at least ``min_word_freq`` occurrences, sorted), the unigram^0.75 table of
negative draws and the training pairs come from the host, and every draw
comes from one ``np.random.default_rng`` in JAX's order: one ``random()``
per in-vocabulary token for the frequent-word subsampling, one
``integers(1, window + 1)`` per kept token for its window, ``random((V,
dim))`` for the input embeddings, and per epoch a ``permutation`` of the
pairs and the negatives by ``choice(..., p=neg_p)``. JAX draws the first
two one call at a time in a Python loop; the port draws each as one array,
which numpy's generator fills from the same stream (its bounded integers
take their 32-bit words from the bit generator, whose buffer carries
between calls), and builds the pairs from the windows with array
arithmetic in JAX's order: sentence, centre, then context position
(:func:`training_pairs`).

Each epoch runs on the device in float32, one step per batch of ``B =
clip(2V, 16, 1024)`` pairs: the step gathers the centre, context and
negative rows from the step's starting tables, then scatter-adds the
updates into the input table at the centres, then the output table at the
contexts, then at the negatives, duplicates summed (``index_add_``). On
the card the steps replay as CUDA graphs of 32 steps each. The learning
rate decays linearly per epoch to a floor of 1% of the start.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec
from h2o3_tpu_torch.models.metrics import ModelMetrics
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.ops.gram import full_fp32


@dataclass
class Word2VecParams(CommonParams):
    vec_size: int = 100
    window_size: int = 5
    min_word_freq: int = 5
    epochs: int = 5
    learning_rate: float = 0.025
    negative_samples: int = 5
    sent_sample_rate: float = 1e-3  # frequent-word subsampling (H2O's)


class Word2VecModel(Model):
    algo = "word2vec"

    def find_synonyms(self, word: str, count: int = 10) -> dict[str, float]:
        """The ``count`` words of highest cosine similarity to ``word``
        (JAX's host numpy, on the float32 embeddings)."""
        vocab = self.output["vocab"]
        if word not in vocab:
            return {}
        E = self.output["embeddings"]
        v = E[vocab[word]]
        sims = E @ v / (np.linalg.norm(E, axis=1) * np.linalg.norm(v) + 1e-12)
        order = np.argsort(-sims)
        words = self.output["words"]
        out = {}
        for i in order:
            if words[i] == word:
                continue
            out[words[i]] = float(sims[i])
            if len(out) >= count:
                break
        return out

    def transform(self, frame: Frame, aggregate_method: str = "NONE") -> Frame:
        """Words to vectors on the frame's device (NaN for NA and unknown
        words); ``AVERAGE`` gives one row per sentence, the NA rows
        separating sentences, as H2O does."""
        vocab = self.output["vocab"]
        E = self.output["embeddings"]
        words = frame.vec(0).to_numpy()
        dim = E.shape[1]
        rows = np.full((len(words), dim), np.nan)
        for i, w in enumerate(words):
            if w is not None and w in vocab:
                rows[i] = E[vocab[w]]
        if aggregate_method.upper() == "AVERAGE":
            sents, cur = [], []
            for i, w in enumerate(words):
                if w is None:
                    sents.append(np.nanmean(rows[cur], axis=0) if cur
                                 else np.full(dim, np.nan))
                    cur = []
                else:
                    cur.append(i)
            if cur:
                sents.append(np.nanmean(rows[cur], axis=0))
            rows = np.stack(sents) if sents else rows[:0]
        dev = frame.device
        return Frame([Vec.from_numpy(rows[:, j], NUM, device=dev)
                      for j in range(dim)], [f"C{j + 1}" for j in range(dim)])


def vocabulary(tokens: list, min_word_freq: int):
    """``(words, vocab, counts)``: the words of at least ``min_word_freq``
    occurrences, sorted, their index and their counts (float64)."""
    freq = Counter(tokens)
    words = sorted(w for w, c in freq.items() if c >= min_word_freq)
    vocab = {w: i for i, w in enumerate(words)}
    counts = np.array([freq[w] for w in words], np.float64)
    return words, vocab, counts


def training_pairs(words_raw, vocab: dict, keep_p: np.ndarray,
                   window: int, rng: np.random.Generator):
    """The (centre, context) pairs of JAX's loops, in their order, from
    the same draws: the kept tokens (an in-vocabulary token is kept when
    its ``random()`` falls under its keep probability), sentences split at
    NA tokens, and per kept token a window of ``integers(1, window + 1)``
    whose neighbours in the sentence, in position order, are its
    contexts."""
    ids = np.array([-2 if w is None else vocab.get(w, -1) for w in words_raw],
                   np.int64)
    inv = np.flatnonzero(ids >= 0)
    draws = rng.random(inv.size)
    kept = inv[draws < keep_p[ids[inv]]]
    # a sentence is the kept tokens between two NA tokens
    sent = np.cumsum(ids == -2)[kept]
    tok = ids[kept]
    n = tok.size
    win = rng.integers(1, window + 1, size=n)
    pos = np.arange(n)
    first = np.searchsorted(sent, sent, side="left")
    last = np.searchsorted(sent, sent, side="right")  # one past the end
    lo = np.maximum(first, pos - win)
    hi = np.minimum(last, pos + win + 1)
    cnt = hi - lo - 1  # every neighbour but the centre itself
    total = int(cnt.sum())
    centre = np.repeat(pos, cnt)
    start = np.repeat(np.cumsum(cnt) - cnt, cnt)
    ctx = np.repeat(lo, cnt) + (np.arange(total) - start)
    ctx = ctx + (ctx >= centre)  # skip the centre
    return tok[centre].astype(np.int32), tok[ctx].astype(np.int32)


# steps one replay of the epoch's CUDA graph runs
GRAPH_STEPS = 32


def epoch(Ein, Eout, cen, ctx, negs, lr: float, B: int) -> None:
    """One pass of skip-gram steps over the batches, in place, float32 on
    the tables' device (JAX's scanned ``step``). On the card the steps run
    :data:`GRAPH_STEPS` at a time as one CUDA-graph replay (a step is ~25
    small kernels, launch-bound when eager); the rest, and every step on
    the CPU, run eagerly."""
    nbatch = cen.shape[0] // B
    cen = cen.view(nbatch, B)
    ctx = ctx.view(nbatch, B)
    negs = negs.view(nbatch, B, -1)
    lr_t = torch.tensor(lr, dtype=torch.float32, device=Ein.device)
    done = 0
    with full_fp32():
        if Ein.is_cuda and nbatch >= GRAPH_STEPS:
            done = _graphed_steps(Ein, Eout, cen, ctx, negs, lr_t)
        for i in range(done, nbatch):
            _step(Ein, Eout, cen[i], ctx[i], negs[i], lr_t)


def _graphed_steps(Ein, Eout, cen, ctx, negs, lr_t) -> int:
    """The whole chunks of :data:`GRAPH_STEPS` steps, each one replay of a
    graph captured here that reads the chunk's indices from static buffers;
    returns the steps run."""
    from h2o3_tpu_torch.ops.cuda_graph import LaunchGraph, warm_up

    S = GRAPH_STEPS
    sc, so, sn = cen[:S].clone(), ctx[:S].clone(), negs[:S].clone()

    def run(E_in, E_out):
        for j in range(S):
            _step(E_in, E_out, sc[j], so[j], sn[j], lr_t)

    # the warm-up runs on copies: it must not move the tables
    warm_up(lambda: run(Ein.clone(), Eout.clone()), Ein.device)
    graph = LaunchGraph(lambda: run(Ein, Eout))
    n = cen.shape[0] // S * S
    for k in range(0, n, S):
        sc.copy_(cen[k: k + S])
        so.copy_(ctx[k: k + S])
        sn.copy_(negs[k: k + S])
        graph.replay()
    return n


def _step(Ein, Eout, c, o, ng, lr) -> None:
    """One batch: the gathers from the step's starting tables, then the
    scatter-adds, duplicates summed."""
    vc = Ein[c]  # (B, dim)
    uo = Eout[o]
    un = Eout[ng]  # (B, neg, dim)
    pos = torch.sigmoid(torch.sum(vc * uo, dim=1))
    gpos = (pos - 1.0)[:, None]  # d/d(vc·uo)
    sneg = torch.sigmoid(torch.einsum("bd,bnd->bn", vc, un))
    dvc = gpos * uo + torch.einsum("bn,bnd->bd", sneg, un)
    duo = gpos * vc
    dun = sneg[:, :, None] * vc[:, None, :]
    Ein.index_add_(0, c, -lr * dvc)
    Eout.index_add_(0, o, -lr * duo)
    Eout.index_add_(0, ng.reshape(-1), (-lr * dun).reshape(-1, vc.shape[1]))


class Word2Vec(ModelBuilder):
    algo = "word2vec"
    PARAMS_CLS = Word2VecParams

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None):
        """Unsupervised: the words are the frame's first column, and a
        ``y`` is ignored."""
        return super().train(x=x, y=None, training_frame=training_frame,
                             validation_frame=validation_frame)

    def _validate(self, train, valid):
        pass

    def _features(self, train: Frame, response):
        return [train.names[0]]

    def _build(self, train: Frame, valid: Frame | None):
        import time

        p: Word2VecParams = self.params
        t0 = time.perf_counter()
        words_raw = train.vec(0).to_numpy()
        words, vocab, counts = vocabulary(
            [w for w in words_raw if w is not None], p.min_word_freq)
        V = len(vocab)
        if V < 2:
            raise ValueError("word2vec needs at least 2 vocabulary words")
        neg_p = counts ** 0.75
        neg_p /= neg_p.sum()
        rng = np.random.default_rng(abs(p.seed) if p.seed and p.seed > 0
                                    else 13)
        if p.sent_sample_rate > 0:
            keep_p = np.minimum(1.0, np.sqrt(p.sent_sample_rate * counts.sum()
                                             / np.maximum(counts, 1)))
        else:
            keep_p = np.ones(V)
        centers, contexts = training_pairs(words_raw, vocab, keep_p,
                                           p.window_size, rng)
        npairs = len(centers)
        if not npairs:
            raise ValueError("no training pairs (corpus too small for the "
                             "vocab/window)")
        pair_seconds = time.perf_counter() - t0

        dev = train.device
        dim = p.vec_size
        Ein = torch.from_numpy(((rng.random((V, dim)) - 0.5) / dim)
                               .astype(np.float32)).to(dev)
        Eout = torch.zeros((V, dim), dtype=torch.float32, device=dev)
        # the batch scales with the vocabulary: the scatter-adds SUM the
        # pairs' gradients, so a word repeated many times in one batch
        # would take one huge step; keep its expected repeats O(1)
        B = min(int(np.clip(2 * V, 16, 1024)), npairs)
        nbatch = max(1, npairs // B)
        cen_d = torch.from_numpy(centers).to(dev).long()
        ctx_d = torch.from_numpy(contexts).to(dev).long()
        for e in range(p.epochs):
            perm = rng.permutation(npairs)[: nbatch * B]
            negs = rng.choice(V, size=(nbatch * B, p.negative_samples),
                              p=neg_p).astype(np.int64)
            lr = p.learning_rate * (1.0 - e / max(p.epochs, 1))
            lr = float(np.float32(max(lr, p.learning_rate * 1e-2)))
            perm_d = torch.from_numpy(perm).to(dev)
            epoch(Ein, Eout, cen_d[perm_d], ctx_d[perm_d],
                  torch.from_numpy(negs).to(dev), lr, B)

        out = {
            "vocab": vocab,
            "words": words,
            "embeddings": Ein.cpu().numpy(),
            "pair_seconds": pair_seconds,
            "response_domain": None,
            "names": [train.names[0]],
        }
        model = Word2VecModel(None, p, out)
        model.training_metrics = ModelMetrics(
            "word2vec", {"vocab_size": V, "train_pairs": int(npairs),
                         "vec_size": dim})
        return model
