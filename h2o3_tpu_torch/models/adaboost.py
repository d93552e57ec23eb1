"""AdaBoost — the port of ``h2o3_tpu/models/adaboost.py`` (the successor
of ``hex.adaboost.AdaBoost``): discrete AdaBoost (binary) with shallow
histogram trees (stumps by default) as the weak learners.

Each learner is one tree of the per-level builder (``shared_tree.
build_tree``, the eager loop) on the ±1 response with the weights as
hessian and a learning rate of 1, so a leaf is the node's weighted mean;
on a CUDA frame every level runs kernel B1 with its row compaction and
kernel B2. The weak hypothesis is ``sign(leaf)``; its weighted error is
the one host read a learner (the stop rule ``err >= 0.5`` needs it), and
``alpha = learn_rate · ½·log((1 − err)/err)``. The weights are
reweighted and renormalized to mean 1 on the device, and the recorded
leaves become ``alpha · sign(leaf)``, so the strong score F = Σ alpha·h
replays through the forest walk and the model predicts
``1/(1 + exp(−2F))``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree.binning import MAX_BINS, bin_frame
from h2o3_tpu_torch.models.tree.gbm import SharedTreeModel, fit_bins_for
from h2o3_tpu_torch.models.tree.shared_tree import build_tree


@dataclass
class AdaBoostParams(CommonParams):
    # JAX's shared tree parameters (those AdaBoost reads: the bins,
    # max_depth, min_rows, min_split_improvement; the rest accepted as in
    # JAX and without effect)
    ntrees: int = 50
    max_depth: int = 1  # stumps by default
    min_rows: float = 10.0
    nbins: int = MAX_BINS
    nbins_cats: int = 1024
    nbins_top_level: int = 1024
    min_split_improvement: float = 1e-5
    sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    score_tree_interval: int = 5
    grow_policy: str = "depthwise"
    max_leaves: int = 0
    calibrate_model: bool = False
    calibration_frame: Any = None
    calibration_method: str = "AUTO"
    nlearners: int = 50
    weak_learner: str = "DT"  # upstream offers DRF/GBM/GLM weak learners too
    learn_rate: float = 0.5  # shrinkage on alpha (h2o's learn_rate)


class AdaBoostModel(SharedTreeModel):
    algo = "adaboost"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        F = self._replay_all(frame)  # Σ alpha·h
        p1 = 1.0 / (1.0 + torch.exp(-2.0 * F))  # logistic link on the margin
        return torch.stack([1 - p1, p1], dim=1)


class AdaBoost(ModelBuilder):
    algo = "adaboost"
    PARAMS_CLS = AdaBoostParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: AdaBoostParams = self.params
        yv = train.vec(p.response_column)
        if not yv.is_categorical() or yv.cardinality != 2:
            raise ValueError("AdaBoost is a binary classifier")
        spec = fit_bins_for(p, train, self._x)
        bins = bin_frame(spec, train)
        dev = bins.device

        y = yv.data
        w = (y >= 0).to(torch.float32)
        ypm = torch.where(y == 1, 1.0, -1.0).to(torch.float32)
        if p.weights_column:
            w = w * torch.nan_to_num(
                train.vec(p.weights_column).data).to(torch.float32)
        # normalize to MEAN 1 (sum = n): split finding compares weighted
        # node counts against min_rows, so weights must stay O(1) per row
        n_eff = torch.clamp((w > 0).sum().to(torch.float32), min=1.0)
        w = w * n_eff / torch.clamp(w.sum(), min=1e-30)

        trees = []
        alphas = []
        errs = []
        varimp = torch.zeros(len(self._x), dtype=torch.float32, device=dev)
        eps = 1e-10
        for _ in range(p.nlearners):
            if self.stop_requested():
                break
            tree, fk, varimp = build_tree(
                bins, w, ypm, w,  # leaf = weighted mean of ±1 in [-1, 1]
                n_bins=spec.max_bins, is_cat_cols=spec.is_cat,
                max_depth=p.max_depth, min_rows=p.min_rows,
                min_split_improvement=p.min_split_improvement,
                learn_rate=1.0,
                preds=torch.zeros(train.nrow, dtype=torch.float32,
                                  device=dev),
                varimp=varimp)
            h = torch.sign(fk)  # weak hypothesis in {-1, 0, +1}
            err = float((w * (h != ypm)).sum()
                        / torch.clamp(w.sum(), min=1e-30))
            err = min(max(err, eps), 1 - eps)
            alpha = float(p.learn_rate * 0.5 * np.log((1 - err) / err))
            if err >= 0.5:  # no better than chance: stop (standard AdaBoost)
                break
            # reweight and renormalize (to sum = n, keeping weights O(1))
            w = w * torch.exp(-alpha * ypm * h)
            w = w * n_eff / torch.clamp(w.sum(), min=1e-30)
            # bake alpha·sign into the recorded leaves (on the device): the
            # standard replay
            for lv in tree.levels:
                lv.leaf_val = alpha * torch.sign(lv.leaf_val)
            trees.append([tree])
            alphas.append(float(alpha))
            errs.append(err)

        out = {
            "bin_spec": spec,
            "trees": trees,
            "n_tree_classes": 1,
            "alphas": alphas,
            "errors": errs,
            "names": list(self._x),
            "varimp": varimp.cpu().numpy().astype(np.float64),
            "response_domain": tuple(yv.domain),
            "ntrees_actual": len(trees),
        }
        model = AdaBoostModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
