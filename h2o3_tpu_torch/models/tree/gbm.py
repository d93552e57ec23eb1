"""GBM — the port of ``h2o3_tpu/models/tree/gbm.py`` for the resident,
single-class path (every distribution of ``distributions.py``): per tree
the distribution's pseudo-residuals, then the level-wise builder (histogram
kernel B1 → split kernel B2 → leaf decision → partition,
``shared_tree.build_tree``). Leaf values are Newton steps from the same
histogram stats, shrunk by ``learn_rate``. ``monotone_constraints``
({column: +1 | -1}) run every split scan on kernel B3 and clip leaves to
the bounds the constrained splits propagate. Training runs on the training
frame's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

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
    quantile_alpha: float = 0.5
    tweedie_power: float = 1.5
    huber_alpha: float = 0.9
    # {col: +1|-1} monotone direction constraints (numeric features only;
    # enforced via split rejection + child-bound propagation, like upstream)
    monotone_constraints: Any = None


def _monotone_vector(p: GBMParams, dist: str, names: list[str],
                     is_cat) -> np.ndarray | None:
    """The (C,) int32 direction vector of ``monotone_constraints``, or None
    when no column is constrained — the validation of the JAX builder, with
    its messages."""
    if not p.monotone_constraints:
        return None
    if dist not in ("gaussian", "bernoulli", "tweedie", "quantile"):
        raise ValueError(
            "monotone_constraints supports gaussian/bernoulli/"
            "tweedie/quantile distributions"
        )
    mono_vec = np.zeros(len(names), np.int32)
    for cname, d in dict(p.monotone_constraints).items():
        if int(d) == 0:  # upstream accepts 0 = unconstrained
            continue
        if cname not in names:
            raise ValueError(f"monotone constraint on unknown column {cname!r}")
        ci = names.index(cname)
        if is_cat[ci]:
            raise ValueError(
                f"monotone constraint on categorical column {cname!r}"
            )
        if int(d) not in (-1, 1):
            raise ValueError("monotone directions must be -1, 0 or 1")
        mono_vec[ci] = int(d)
    return mono_vec if mono_vec.any() else None


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

    def _distribution_for_metrics(self) -> str:
        return _metric_distribution(self.output["distribution"])

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Bernoulli: (n, 2) class probabilities; otherwise (n,) predictions
        on the response scale (through the distribution's link)."""
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
        dist, aux = resolve_distribution(p.distribution, yv, p.quantile_alpha,
                                         p.tweedie_power, p.huber_alpha)
        classification = dist == "bernoulli"
        if classification and not yv.is_categorical():
            raise ValueError("bernoulli needs a categorical response")
        dev = train.device
        nrow = train.nrow

        spec = fit_bins(train, self._x, nbins=p.nbins,
                        seed=abs(p.seed) or 7, nbins_cats=p.nbins_cats)
        bins = bin_frame(spec, train)
        mono_vec = _monotone_vector(p, dist, self._x, spec.is_cat)

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

        f0 = init_score(dist, y_np, w_np, aux)
        F = torch.full((nrow,), f0, dtype=torch.float32, device=dev)
        varimp = torch.zeros(len(self._x), dtype=torch.float32, device=dev)
        trees: list[list[Tree]] = []
        lr = p.learn_rate
        for _ in range(p.ntrees):
            t, h = grad_hess(dist, F, y, w, aux)
            tree, F, varimp = build_tree(
                bins, w, t, h, n_bins=spec.max_bins, is_cat_cols=spec.is_cat,
                max_depth=p.max_depth, min_rows=p.min_rows,
                min_split_improvement=p.min_split_improvement,
                learn_rate=lr, preds=F, varimp=varimp,
                max_abs_leaf=p.max_abs_leafnode_pred, monotone=mono_vec)
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


def _metric_distribution(dist: str) -> str:
    """The deviance regression metrics report: poisson, gamma and laplace
    have their own, every other distribution squared error."""
    return dist if dist in ("poisson", "gamma", "laplace") else "gaussian"


def _metrics_from_F(dist, F, y, w, domain) -> MM.ModelMetrics:
    """Training metrics from the running scores (no tree replay)."""
    mu = response_transform(dist, F)
    if dist == "bernoulli":
        return MM.binomial_metrics(y, mu, w, domain=domain)
    return MM.regression_metrics(y, mu, w, _metric_distribution(dist))
