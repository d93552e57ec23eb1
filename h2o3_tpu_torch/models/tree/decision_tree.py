"""A single decision tree — the port of ``h2o3_tpu/models/decision_tree.py``
(the successor of ``hex.tree.dt.DT``).

One CART-style tree on the per-level tree builder (``shared_tree.
build_tree``, the eager loop: one tree gains nothing from a captured
graph), with the hessian equal to the weight and a learning rate of 1, so
a leaf is the weighted mean of the node's response: the 0/1 response of a
binary classifier (H2O's DT is binary only, and more than two classes
raise as in JAX) or a numeric target (a regression, JAX's superset). On a
CUDA frame every level runs kernel B1 with its row compaction and kernel
B2.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree.binning import MAX_BINS, bin_frame
from h2o3_tpu_torch.models.tree.gbm import (
    SharedTreeModel,
    fit_bins_for,
    response_and_weights,
)
from h2o3_tpu_torch.models.tree.shared_tree import build_tree


@dataclass
class DTParams(CommonParams):
    max_depth: int = 10
    min_rows: float = 10.0
    nbins: int = MAX_BINS
    nbins_cats: int = 1024
    # accepted for surface parity and without effect (GBM's warning)
    nbins_top_level: int = 1024
    min_split_improvement: float = 1e-5


class DTModel(SharedTreeModel):
    algo = "dt"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """The leaf means: (n,) for a regression, the (n, 2) probabilities
        (the mean clipped to [0, 1]) for a classifier."""
        raw = self._replay_all(frame)
        if not self.is_classifier:
            return raw
        p1 = torch.clamp(raw, 0.0, 1.0)
        return torch.stack([1 - p1, p1], dim=1)


class DT(ModelBuilder):
    algo = "dt"
    PARAMS_CLS = DTParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: DTParams = self.params
        if p.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        yv = train.vec(p.response_column)
        classification = yv.is_categorical()
        if classification and yv.cardinality > 2:
            raise ValueError(
                "DT supports binary classification only (H2O parity)")
        spec = fit_bins_for(p, train, self._x)
        bins = bin_frame(spec, train)
        dev = train.device
        y_np, w_np = response_and_weights(p, train, yv, classification)
        w = torch.from_numpy(w_np).to(dev)
        y = torch.from_numpy(y_np).to(dev)
        tree, _, varimp = build_tree(
            bins, w, y, w,  # hessian = weight: a leaf is the node's mean
            n_bins=spec.max_bins, is_cat_cols=spec.is_cat,
            max_depth=p.max_depth, min_rows=p.min_rows,
            min_split_improvement=p.min_split_improvement, learn_rate=1.0,
            preds=torch.zeros(train.nrow, dtype=torch.float32, device=dev),
            varimp=torch.zeros(len(self._x), dtype=torch.float32,
                               device=dev))
        out = {
            "bin_spec": spec,
            "trees": [[tree]],
            "n_tree_classes": 1,
            "names": list(self._x),
            "varimp": varimp.cpu().numpy().astype(np.float64),
            "response_domain": tuple(yv.domain) if classification else None,
            "ntrees_actual": 1,
        }
        model = DTModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
