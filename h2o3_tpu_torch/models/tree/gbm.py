"""GBM — the port of ``h2o3_tpu/models/tree/gbm.py`` for the resident,
single-class path (bernoulli and gaussian): per tree the distribution's
pseudo-residuals, then the level-wise builder (histogram kernel B1 → split
kernel B2 → leaf decision → partition, ``shared_tree.build_tree``). Leaf
values are Newton steps from the same histogram stats, shrunk by
``learn_rate``. Training runs on the training frame's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree.binning import MAX_BINS, BinSpec, bin_frame, fit_bins
from h2o3_tpu_torch.models.tree.distributions import (
    grad_hess,
    init_score,
    resolve_distribution,
    response_transform,
)
from h2o3_tpu_torch.models.tree.shared_tree import Tree, build_tree


@dataclass
class GBMParams(CommonParams):
    ntrees: int = 50
    max_depth: int = 5
    min_rows: float = 10.0
    nbins: int = MAX_BINS
    nbins_cats: int = 1024
    min_split_improvement: float = 1e-5
    sample_rate: float = 1.0
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    score_tree_interval: int = 5  # accepted; scoring history is not ported
    learn_rate: float = 0.1
    learn_rate_annealing: float = 1.0
    distribution: str = "AUTO"
    max_abs_leafnode_pred: float = float("inf")


def _check_ported(p: GBMParams) -> None:
    """Refuse the options whose code paths are not ported yet."""
    unported = {
        "sample_rate": p.sample_rate != 1.0,
        "col_sample_rate": p.col_sample_rate != 1.0,
        "col_sample_rate_per_tree": p.col_sample_rate_per_tree != 1.0,
        "offset_column": bool(p.offset_column),
        "nfolds": bool(p.nfolds and p.nfolds > 1),
        "stopping_rounds": p.stopping_rounds > 0,
        "checkpoint": p.checkpoint is not None,
        "validation_frame": p.validation_frame is not None,
    }
    bad = sorted(k for k, v in unported.items() if v)
    if bad:
        raise NotImplementedError(f"GBM options not ported yet: {bad}")
    if p.ntrees < 1 or p.max_depth < 1:
        raise ValueError("ntrees and max_depth must be >= 1")


class GBMModel(Model):
    algo = "gbm"

    def _replay_all(self, frame: Frame) -> torch.Tensor:
        """Sum of tree contributions per row, on the frame's device."""
        spec: BinSpec = self.output["bin_spec"]
        bins = bin_frame(spec, frame)
        preds = torch.zeros(bins.shape[0], dtype=torch.float32,
                            device=bins.device)
        for group in self.output["trees"]:
            nid = torch.zeros(bins.shape[0], dtype=torch.int32,
                              device=bins.device)
            _, preds = group[0].replay(bins, nid, preds)
        return preds

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Bernoulli: (n, 2) class probabilities; gaussian: (n,)."""
        dist = self.output["distribution"]
        mu = response_transform(dist, self._replay_all(frame)
                                + self.output["init_f"])
        if dist == "bernoulli":
            return torch.stack([1 - mu, mu], dim=1)
        return mu


class GBM(ModelBuilder):
    algo = "gbm"
    PARAMS_CLS = GBMParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: GBMParams = self.params
        _check_ported(p)
        yv = train.vec(p.response_column)
        dist = resolve_distribution(p.distribution, yv)
        classification = dist == "bernoulli"
        if classification and not yv.is_categorical():
            raise ValueError("bernoulli needs a categorical response")
        dev = train.device
        nrow = train.nrow

        spec = fit_bins(train, self._x, nbins=p.nbins,
                        seed=abs(p.seed) or 7, nbins_cats=p.nbins_cats)
        bins = bin_frame(spec, train)

        # response / weights on the device
        y_np = yv.to_numpy().astype(np.float64)
        w_np = np.ones(nrow, np.float32)
        if p.weights_column:
            w_np *= np.nan_to_num(
                train.vec(p.weights_column).to_numpy()).astype(np.float32)
        w_np *= (y_np >= 0) if classification else ~np.isnan(y_np)
        y_np = np.nan_to_num(y_np, nan=0.0).astype(np.float32)
        w = torch.from_numpy(w_np).to(dev)
        y = torch.from_numpy(y_np).to(dev)

        f0 = init_score(dist, y_np, w_np)
        F = torch.full((nrow,), f0, dtype=torch.float32, device=dev)
        varimp = torch.zeros(len(self._x), dtype=torch.float32, device=dev)
        trees: list[list[Tree]] = []
        lr = p.learn_rate
        for _ in range(p.ntrees):
            t, h = grad_hess(dist, F, y, w)
            tree, F, varimp = build_tree(
                bins, w, t, h, n_bins=spec.max_bins, is_cat_cols=spec.is_cat,
                max_depth=p.max_depth, min_rows=p.min_rows,
                min_split_improvement=p.min_split_improvement,
                learn_rate=lr, preds=F, varimp=varimp,
                max_abs_leaf=p.max_abs_leafnode_pred)
            trees.append([tree])
            lr *= p.learn_rate_annealing

        domain = tuple(yv.domain) if classification else None
        out = {
            "bin_spec": spec,
            "trees": trees,
            "n_tree_classes": 1,
            "distribution": dist,
            "init_f": f0,
            "names": list(self._x),
            "varimp": varimp.cpu().numpy().astype(np.float64),
            "response_domain": domain,
            "ntrees_actual": len(trees),
        }
        model = GBMModel(None, p, out)
        model.training_metrics = _metrics_from_F(dist, F, y_np, w_np, domain)
        return model


def _metrics_from_F(dist, F, y, w, domain) -> MM.ModelMetrics:
    """Training metrics from the running scores (no tree replay)."""
    mu = response_transform(dist, F)
    if dist == "bernoulli":
        return MM.binomial_metrics(y, mu, w, domain=domain)
    return MM.regression_metrics(y, mu, w)
