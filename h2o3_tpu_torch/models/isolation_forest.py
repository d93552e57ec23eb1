"""Isolation forest — the port of ``h2o3_tpu/models/isolation_forest.py``
(the successor of ``hex.tree.isofor.IsolationForest``).

The trees grow on the host from small row samples (256 rows by default)
with uniform random (feature, threshold) splits, JAX's code on JAX's numpy
generator; only the sampled rows are gathered from the device. Scoring, the
data-sized work, walks every row through every tree at once on the frame's
device (:func:`stacked_path_lengths`: each level one batched gather over
all trees, the rows in chunks). Score = 2^(-E[h(x)] / c(n)) with the
standard c(n); ``predict`` gives ``predict`` (the score) and
``mean_length``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    gather_rows,
)

# rows per scoring chunk: bounds the (rows, trees) walk state on the device
SCORE_CHUNK_ROWS = 1 << 17


@dataclass
class IsolationForestParams(CommonParams):
    ntrees: int = 50
    sample_size: int = 256
    max_depth: int = 8
    mtries: int = -1


def _c(n: float) -> float:
    if n <= 1:
        return 0.0
    return 2.0 * (np.log(n - 1) + 0.5772156649) - 2.0 * (n - 1) / n


def feature_matrix(frame: Frame, names, domains=None) -> torch.Tensor:
    """The feature columns as (n, C) float32 on the frame's device:
    numerics as they are, categoricals as their codes remapped to the
    training ``domains`` (unseen levels and NAs -1), JAX's
    ``_feature_matrix``."""
    cols = []
    for ci, n in enumerate(names):
        v = frame.vec(n)
        if not v.is_categorical():
            cols.append(v.data)
            continue
        dom = domains[ci] if domains is not None else None
        vdom = tuple(v.domain or ())
        if dom is None or tuple(dom) == vdom:
            cols.append(v.data.to(torch.float32))
            continue
        lut = {lv: i for i, lv in enumerate(dom)}
        remap = torch.as_tensor(
            np.array([lut.get(lv, -1) for lv in vdom] or [-1], np.int64),
            device=v.device)
        codes = v.data.long()
        mapped = torch.where(codes < 0, -1,
                             remap[codes.clamp(0, len(vdom) - 1)])
        cols.append(mapped.to(torch.float32))
    return torch.stack(cols, 1)


def stacked_path_lengths(X, step, n_levels: int, ntrees: int,
                         chunk: int = SCORE_CHUNK_ROWS) -> torch.Tensor:
    """Every row's path length summed over all trees, on ``X``'s device:
    per chunk of ``chunk`` rows, one (rows, trees) walk state, and at each
    level ``step(Xc, nid, d)`` -> ``(is_leaf, leaf_len, go_left)`` gathers
    the level's arrays for all trees at once. The float32 lengths add in
    float64 (JAX adds them tree by tree in float32)."""
    total = torch.zeros(X.shape[0], dtype=torch.float64, device=X.device)
    for lo in range(0, X.shape[0], chunk):
        Xc = X[lo: lo + chunk]
        n = Xc.shape[0]
        nid = torch.zeros((n, ntrees), dtype=torch.long, device=X.device)
        done = torch.zeros((n, ntrees), dtype=torch.bool, device=X.device)
        length = torch.zeros((n, ntrees), dtype=torch.float32,
                             device=X.device)
        for d in range(n_levels):
            is_leaf, ll, go_left = step(Xc, nid, d)
            length = torch.where(is_leaf & ~done, ll, length)
            done = done | is_leaf
            nid = torch.where(done, nid, 2 * nid + (~go_left).long())
        total[lo: lo + n] = length.sum(1, dtype=torch.float64)
    return total


def _tree_gather(arr: torch.Tensor, d: int, nid: torch.Tensor):
    """``arr[t, d, nid[:, t]]`` for every row and tree: (n, T)."""
    T, _, M = arr.shape
    base = torch.arange(T, device=nid.device) * (arr.shape[1] * M) + d * M
    return arr.reshape(-1)[base[None, :] + nid]


class IsolationForestModel(Model):
    algo = "isolationforest"

    def _stacked(self, dev) -> tuple:
        """The trees' level arrays stacked (T, L, M) on ``dev``, cached in
        ``output["_stacked"]`` (dropped on save)."""
        cache = self.output.get("_stacked")
        if cache is None or cache[0] != str(dev):
            feat, thr, ll = (np.stack([t[i] for t in self.output["trees"]])
                             for i in range(3))
            cache = (str(dev), torch.as_tensor(feat, device=dev).long(),
                     torch.as_tensor(thr, device=dev),
                     torch.as_tensor(ll, device=dev))
            self.output["_stacked"] = cache
        return cache[1:]

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """(n, 2): the anomaly score and the mean path length."""
        X = feature_matrix(frame, self.output["names"],
                           self.output.get("feature_domains"))
        feat, thr, leaf_len = self._stacked(X.device)
        T, L, _ = feat.shape
        C = X.shape[1]

        def step(Xc, nid, d):
            f = _tree_gather(feat, d, nid)
            rows = torch.arange(Xc.shape[0], device=Xc.device)[:, None]
            x = Xc.reshape(-1)[rows * C + f.clamp(min=0)]
            go_left = torch.where(torch.isnan(x), True,
                                  x < _tree_gather(thr, d, nid))
            return f < 0, _tree_gather(leaf_len, d, nid), go_left

        total = stacked_path_lengths(X, step, L, T)
        mean_len = total / T
        cn = _c(self.params.sample_size)
        score = torch.pow(2.0, -mean_len / max(cn, 1e-9))
        return torch.stack([score, mean_len], 1).to(torch.float32)

    def predict(self, frame: Frame) -> Frame:
        s = self._predict_raw(frame)
        return Frame([Vec(s[:, 0].contiguous(), NUM),
                      Vec(s[:, 1].contiguous(), NUM)],
                     ["predict", "mean_length"])


class IsolationForest(ModelBuilder):
    algo = "isolationforest"
    PARAMS_CLS = IsolationForestParams

    def _validate(self, train, valid):
        pass  # unsupervised

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: IsolationForestParams = self.params
        rng = np.random.default_rng(abs(p.seed) if p.seed and p.seed > 0 else 1)
        names = self._x
        X = feature_matrix(train, names)
        n, C = X.shape
        sample = min(p.sample_size, n)
        depth = min(p.max_depth, max(1, int(np.ceil(np.log2(max(sample, 2))))))
        mtries = C if p.mtries in (-1, 0) else min(p.mtries, C)
        trees = []
        for _ in range(p.ntrees):
            S = gather_rows(X, rng.choice(n, sample, replace=False))
            trees.append(self._grow(S, depth, rng, mtries))
        out = {
            "trees": trees, "names": list(names), "response_domain": None,
            "feature_kinds": ["cat" if train.vec(c).is_categorical()
                              else "num" for c in names],
            # categorical features keep the training domains: a scoring
            # frame's codes are remapped into them (feature_matrix)
            "feature_domains": [tuple(train.vec(c).domain or ())
                                if train.vec(c).is_categorical() else None
                                for c in names],
        }
        model = IsolationForestModel(None, p, out)
        raw = model._predict_raw(train).double().mean(0).cpu().numpy()
        model.training_metrics = MM.ModelMetrics(
            "anomaly", {"mean_score": float(raw[0]),
                        "mean_length": float(raw[1])})
        return model

    @staticmethod
    def _grow(S: np.ndarray, depth: int, rng, mtries: int):
        """One random tree on the sample ``S``, as stacked level arrays in
        full binary indexing (JAX's ``_grow``)."""
        n_levels = depth + 1
        max_nodes = 1 << depth
        feat = np.full((n_levels, max_nodes), -1, np.int32)
        thr = np.zeros((n_levels, max_nodes), np.float32)
        leaf_len = np.zeros((n_levels, max_nodes), np.float32)
        C = S.shape[1]
        node_rows: dict[tuple[int, int], np.ndarray] = {
            (0, 0): np.arange(len(S))}
        for d in range(n_levels):
            next_rows = {}
            for (dd, i), rows in list(node_rows.items()):
                if dd != d:
                    continue
                sub = S[rows]
                split = False
                if d < depth and len(rows) > 1:
                    cand = rng.choice(C, size=min(mtries, C), replace=False)
                    for f in cand:
                        col = sub[:, f]
                        col = col[~np.isnan(col)]
                        if len(col) and col.min() < col.max():
                            t = rng.uniform(col.min(), col.max())
                            feat[d, i] = f
                            thr[d, i] = t
                            go = np.where(np.isnan(sub[:, f]), True,
                                          sub[:, f] < t)
                            next_rows[(d + 1, 2 * i)] = rows[go]
                            next_rows[(d + 1, 2 * i + 1)] = rows[~go]
                            split = True
                            break
                if not split:
                    feat[d, i] = -1
                    leaf_len[d, i] = d + _c(float(len(rows)))
            node_rows.update(next_rows)
        return feat, thr, leaf_len
