"""Extended isolation forest — the port of
``h2o3_tpu/models/extended_isolation_forest.py`` (the successor of
``hex.isoforextended``; Hariri et al.'s random oblique cuts: a node splits
on x·n < d, n a random normal with ``extension_level`` + 1 nonzero
components, d drawn inside the node's projected range).

The trees grow on the host from 256-row samples with JAX's numpy generator
and code (float64); only the sampled rows are gathered from the device,
their NAs imputed with the training column means, which come from one
float64 reduction on the device (JAX imputes NAs with the mean, where
upstream refuses NA rows). Scoring walks every row through every tree's
stacked levels at once on the frame's device (``isolation_forest.
stacked_path_lengths``: per level one gather of each row's node normals
over all trees, the float32 projections, the comparison).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.isolation_forest import _c, stacked_path_lengths
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    gather_rows,
)

# the gathered normals of one row chunk, (rows, trees, C) float32, stay
# under this many elements
SCORE_CHUNK_ELEMENTS = 1 << 26


@dataclass
class ExtendedIsolationForestParams(CommonParams):
    ntrees: int = 100
    sample_size: int = 256
    extension_level: int = -1  # -1: fully extended (C - 1)


def _grow(X: np.ndarray, depth: int, max_depth: int, ext: int, rng) -> dict:
    n, C = X.shape
    if depth >= max_depth or n <= 1:
        return {"leaf": True, "len": depth + _c(n)}
    normal = rng.normal(size=C)
    if ext < C - 1:  # zero all but ext + 1 components
        off = rng.choice(C, C - (ext + 1), replace=False)
        normal[off] = 0.0
    proj = X @ normal
    lo, hi = proj.min(), proj.max()
    if hi <= lo:
        return {"leaf": True, "len": depth + _c(n)}
    d = rng.uniform(lo, hi)
    left = proj < d
    return {
        "leaf": False,
        "normal": normal,
        "d": d,
        "l": _grow(X[left], depth + 1, max_depth, ext, rng),
        "r": _grow(X[~left], depth + 1, max_depth, ext, rng),
    }


def _stack_tree(root: dict, C: int, max_depth: int):
    """Per level ``(normals (w, C), intercepts, is_leaf, lens)`` of one
    tree, w = 2^level (JAX's ``_stack_tree``)."""
    levels = []
    frontier = [root]
    for d in range(max_depth + 1):
        width = 1 << d
        normals = np.zeros((width, C), np.float32)
        ds = np.zeros(width, np.float32)
        is_leaf = np.ones(width, bool)
        lens = np.zeros(width, np.float32)
        nxt = [None] * (2 * width)
        for i, node in enumerate(frontier):
            if node is None:
                continue
            if node["leaf"]:
                lens[i] = node["len"]
            else:
                is_leaf[i] = False
                normals[i] = node["normal"]
                ds[i] = node["d"]
                nxt[2 * i] = node["l"]
                nxt[2 * i + 1] = node["r"]
        levels.append((normals, ds, is_leaf, lens))
        frontier = nxt
        if all(x is None for x in frontier):
            break
    return levels


def _stack_forest(stacked: list, C: int):
    """Every tree's levels padded to (T, L, W[, C]) numpy arrays: padding
    levels and nodes are leaves of length 0, which no row reaches."""
    T = len(stacked)
    L = max(len(levels) for levels in stacked)
    W = 1 << (L - 1)
    normals = np.zeros((T, L, W, C), np.float32)
    ds = np.zeros((T, L, W), np.float32)
    is_leaf = np.ones((T, L, W), bool)
    lens = np.zeros((T, L, W), np.float32)
    for t, levels in enumerate(stacked):
        for d, (nrm, dd, lf, ln) in enumerate(levels):
            w = len(dd)
            normals[t, d, :w] = nrm
            ds[t, d, :w] = dd
            is_leaf[t, d, :w] = lf
            lens[t, d, :w] = ln
    return normals, ds, is_leaf, lens


class ExtendedIsolationForestModel(Model):
    algo = "extendedisolationforest"

    def _stacked(self, dev) -> tuple:
        """The padded forest on ``dev``, cached in ``output["_stacked"]``
        (dropped on save)."""
        cache = self.output.get("_stacked")
        if cache is None or cache[0] != str(dev):
            arrs = _stack_forest(self.output["stacked_trees"],
                                 len(self.output["names"]))
            cache = (str(dev), *(torch.as_tensor(a, device=dev)
                                 for a in arrs))
            self.output["_stacked"] = cache
        return cache[1:]

    def design(self, frame: Frame) -> torch.Tensor:
        """The scored columns as (n, C) float32, NAs imputed with the
        training means (rounded to float32, as JAX's host copy is)."""
        x = torch.stack([frame.vec(c).data for c in self.output["names"]], 1)
        means = torch.as_tensor(np.asarray(self.output["col_means"],
                                           np.float32), device=x.device)
        return torch.where(torch.isnan(x), means, x)

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """(n, 2): the anomaly score and the mean path length."""
        X = self.design(frame)
        normals, ds, is_leaf, lens = self._stacked(X.device)
        T, L, W, C = normals.shape
        flat_n = normals.reshape(-1, C)
        tree_base = torch.arange(T, device=X.device) * (L * W)

        def step(Xc, nid, d):
            node = tree_base[None, :] + d * W + nid  # (rows, T)
            nrm = flat_n.index_select(0, node.reshape(-1)).reshape(
                *node.shape, C)
            proj = (Xc[:, None, :] * nrm).sum(-1)
            return (is_leaf.reshape(-1)[node], lens.reshape(-1)[node],
                    proj < ds.reshape(-1)[node])

        chunk = max(1024, SCORE_CHUNK_ELEMENTS // max(T * C, 1))
        total = stacked_path_lengths(X, step, L, T, chunk)
        mean_len = total / max(T, 1)
        score = torch.pow(2.0, -mean_len / max(
            _c(self.output["sample_size"]), 1e-9))
        return torch.stack([score, mean_len], 1).to(torch.float32)

    def predict(self, frame: Frame) -> Frame:
        raw = self._predict_raw(frame)
        return Frame([Vec(raw[:, 0].contiguous(), NUM),
                      Vec(raw[:, 1].contiguous(), NUM)],
                     ["anomaly_score", "mean_length"])


class ExtendedIsolationForest(ModelBuilder):
    algo = "extendedisolationforest"
    PARAMS_CLS = ExtendedIsolationForestParams

    def _features(self, train: Frame, response):
        return [n for n in train.names if train.vec(n).is_numeric()]

    def _validate(self, train, valid):
        pass  # unsupervised

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: ExtendedIsolationForestParams = self.params
        cols = self._x
        if not cols:
            raise ValueError("EIF needs at least one numeric column")
        C = len(cols)
        ext = C - 1 if p.extension_level == -1 else min(p.extension_level,
                                                       C - 1)
        x = torch.stack([train.vec(c).data for c in cols], 1)
        xd = x.double()
        ok = ~torch.isnan(xd)
        means = (torch.where(ok, xd, 0.0).sum(0) / ok.sum(0)).cpu().numpy()
        rng = np.random.default_rng(abs(p.seed) if p.seed and p.seed > 0 else 77)
        psi = min(p.sample_size, train.nrow)
        max_depth = int(np.ceil(np.log2(max(psi, 2))))
        stacked = []
        for _ in range(p.ntrees):
            S = gather_rows(x, rng.choice(train.nrow, psi, replace=False))
            S = S.astype(np.float64)
            S = np.where(np.isnan(S), means[None, :], S)
            stacked.append(_stack_tree(_grow(S, 0, max_depth, ext, rng), C,
                                       max_depth))
        out = {
            "names": list(cols),
            "col_means": means,
            "stacked_trees": stacked,
            "sample_size": psi,
            "response_domain": None,
        }
        model = ExtendedIsolationForestModel(None, p, out)
        raw = model._predict_raw(train).double().mean(0).cpu().numpy()
        model.training_metrics = MM.ModelMetrics(
            "anomaly", {"mean_score": float(raw[0]),
                        "mean_length": float(raw[1]), "nobs": train.nrow})
        return model
