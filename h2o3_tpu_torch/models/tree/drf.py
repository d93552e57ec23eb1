"""DRF and XRT — the port of ``h2o3_tpu/models/tree/drf.py`` on the shared
tree builder and GBM's interval loop (``gbm.grow_forest``).

What differs from GBM, as in H2O and the JAX package: each iteration draws
a row bootstrap (``sample_rate``, Bernoulli per row), each split draws its
candidate columns (``mtries``: √C for classification, C/3 for regression,
-2 for all), trees are deep (default depth 20, whose levels past the 2048-
node frontier run as the saturated-level graphs), a leaf is its node's
weighted mean of the target (learn rate 1), and predictions average the
trees. A classifier of K > 2 classes grows one tree per class per
iteration on the one-hot indicator; the K class trees of an iteration
share its bootstrap and draw their own columns. ``col_sample_rate_per_tree``
and ``binomial_double_trees`` are accepted and unread, as in JAX.

``XRT`` builds exactly as DRF under its own algo name: the JAX builder's
``_extra_random`` flag is read nowhere, so neither package draws random
split thresholds.

``checkpoint=`` continues a forest as GBM does (``gbm.resolve_prior``,
JAX's frozen parameters ``max_depth``, ``nbins``, ``min_rows``,
``mtries``, ``sample_rate``): the prior's bins, trees and variable
importances carry over, the running leaf sums are its trees replayed onto
the frame, and the keyed bootstraps and column draws go on from its
iteration count. ``export_checkpoints_dir`` snapshots each scoring
interval.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    ScoreKeeper,
    stopping_metric_direction,
)
from h2o3_tpu_torch.models.tree.binning import MAX_BINS
from h2o3_tpu_torch.models.tree.gbm import (
    SharedTreeModel,
    _validation_state,
    check_ported,
    fit_bins_for,
    grow_forest,
    prior_scores,
    resolve_prior,
    response_and_weights,
)
from h2o3_tpu_torch.models.tree.sampling import Sampling


@dataclass
class DRFParams(CommonParams):
    ntrees: int = 50
    max_depth: int = 20
    min_rows: float = 1.0
    nbins: int = MAX_BINS
    nbins_cats: int = 1024
    # accepted for surface parity and without effect (GBM's warning)
    nbins_top_level: int = 1024
    min_split_improvement: float = 1e-5
    sample_rate: float = 0.632
    col_sample_rate_per_tree: float = 1.0
    score_tree_interval: int = 5
    calibrate_model: bool = False
    mtries: int = -1
    binomial_double_trees: bool = False


def _averaged(F: torch.Tensor, ntrees: int, classification: bool):
    """Predictions from the per-class leaf sums of ``ntrees`` iterations:
    the mean (regression), P(class 1) clipped to [0, 1] (binomial, F of
    shape (n,)), or the means clipped at 1e-9 and normalised (K classes)."""
    avg = F / max(ntrees, 1)
    if not classification:
        return avg
    if avg.dim() == 1:
        return torch.clamp(avg, 0.0, 1.0)
    P = torch.clamp(avg, min=1e-9)
    return P / P.sum(dim=1, keepdim=True)


def _metrics_from_F(F, y, w, ntrees: int, classification: bool,
                    domain=None) -> MM.ModelMetrics:
    """Metrics of the averaged trees from the running sums (no replay): on
    the device when ``F`` is on the card, on the host otherwise."""
    P = _averaged(F, ntrees, classification)
    if not classification:
        return MM.regression_metrics(y, P, w)
    if P.dim() == 2:
        return MM.multinomial_metrics(y, P, w, domain=domain or ())
    return MM.binomial_metrics(y, P, w, domain=domain or ("0", "1"))


class DRFModel(SharedTreeModel):
    algo = "drf"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Regression: (n,) means; binomial (n, 2) and K classes (n, K)
        probabilities."""
        P = _averaged(self._replay_all(frame), self.output["ntrees_actual"],
                      self.is_classifier)
        if self.is_classifier and P.dim() == 1:
            return torch.stack([1 - P, P], dim=1)
        return P


class DRF(ModelBuilder):
    algo = "drf"
    PARAMS_CLS = DRFParams
    MODEL_CLS = DRFModel

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: DRFParams = self.params
        check_ported(self.algo, p, calibrate_model=bool(p.calibrate_model))
        yv = train.vec(p.response_column)
        classification = yv.is_categorical()
        K = yv.cardinality if classification and yv.cardinality > 2 else 1
        C = len(self._x)
        mtries = p.mtries
        if mtries in (-1, 0):
            mtries = (max(1, int(np.sqrt(C))) if classification
                      else max(1, C // 3))
        elif mtries == -2:
            mtries = C
        col_rate = min(1.0, mtries / C)
        dev = train.device
        prior = resolve_prior(self, train, ("max_depth", "nbins", "min_rows",
                                            "mtries", "sample_rate"))

        with record_function(f"{self.algo}.setup"):
            spec = (prior.output["bin_spec"] if prior is not None
                    else fit_bins_for(p, train, self._x))
            y_np, w_np = response_and_weights(p, train, yv, classification)
            w = torch.from_numpy(w_np).to(dev)
            y = torch.from_numpy(y_np).to(dev)
            domain = tuple(yv.domain) if classification else None
            f0 = np.zeros(K, np.float32) if K > 1 else 0.0  # no init score
            F = torch.zeros((train.nrow, K) if K > 1 else train.nrow,
                            device=dev)
            varimp = torch.zeros(C, dtype=torch.float32, device=dev)
            start, prior_trees = 0, []
            if prior is not None:
                F = prior_scores(prior, train, f0, dev)
                varimp = torch.as_tensor(
                    np.asarray(prior.output["varimp"], np.float32),
                    device=dev)
                start = prior.output["ntrees_actual"]
                prior_trees = [list(g) for g in prior.output["trees"]]
            vs = _validation_state(p, spec, valid, yv, classification, f0,
                                   dev)
            if vs is not None and prior is not None:
                vs["F"] = prior_scores(prior, valid, f0, dev)
        history: list[dict] = []
        metric_name, larger = stopping_metric_direction(
            p.stopping_metric, classification, len(domain or ()))
        keeper = ScoreKeeper(p.stopping_rounds, p.stopping_tolerance, larger)

        def metric(F_, y_, w_, m_done) -> float:
            v = _metrics_from_F(F_, y_, w_, m_done, classification)._v
            return float(v.get(metric_name, v.get(
                "logloss" if classification else "rmse")))

        def score(m_done: int, F_, Fv) -> bool:
            """One scoring event; True when training should stop."""
            mval = metric(F_, y, w, m_done)
            entry = {"ntrees": m_done, f"training_{metric_name}": mval}
            stop_val = mval
            if vs is not None:
                stop_val = metric(Fv, vs["y"], vs["w"], m_done)
                entry[f"validation_{metric_name}"] = stop_val
            history.append(entry)
            keeper.record(stop_val)
            return keeper.should_stop()

        def snapshot(trees, F_, varimp_):
            self._export_interval_checkpoint(
                lambda key: self._partial_model(
                    key, spec, trees, K, varimp_, domain, history, F_, y, w,
                    classification))

        if K > 1:
            def grad_fn(F_, y_, w_):  # leaf = the node's mean indicator
                Y1h = (y_[:, None] == torch.arange(K, device=y_.device)
                       ).to(torch.float32)
                return Y1h, w_[:, None].expand(-1, K)
        else:
            def grad_fn(F_, y_, w_):  # leaf = the node's mean target
                return y_, w_

        sample = Sampling(p.seed if p.seed and p.seed > 0 else 5678,
                          sample_rate=p.sample_rate, col_sample_rate=col_rate)
        trees, F, varimp, Fv = grow_forest(
            p, spec, train, y, w, F, varimp, algo=self.algo, grad_fn=grad_fn,
            grad_key=("drf", K), n_classes=K, sample=sample, learn_rate=1.0,
            annealing=1.0, max_abs_leaf=float("inf"), monotone=None,
            valid_bins=None if vs is None else vs["bins"],
            Fv=None if vs is None else vs["F"], score=score,
            stop_requested=self.stop_requested, start=start,
            trees=prior_trees,
            snapshot=snapshot if p.export_checkpoints_dir else None)

        model = self._partial_model(None, spec, trees, K, varimp, domain,
                                    history)
        with record_function(f"{self.algo}.final_metrics"):
            nt = len(trees)
            model.training_metrics = _metrics_from_F(
                F, y, w, nt, classification, domain)
            if vs is not None:
                model.validation_metrics = _metrics_from_F(
                    Fv, vs["y"], vs["w"], nt, classification, domain)
        return model

    def _partial_model(self, key, spec, trees, K, varimp, domain, history,
                       F=None, y=None, w=None, classification=False) -> Model:
        """The forest so far as a model (JAX's ``_partial_model``); with
        ``F`` it carries the training metrics of those leaf sums."""
        out = {
            "bin_spec": spec,
            "trees": [list(g) for g in trees],
            "n_tree_classes": K,
            "names": list(self._x),
            "varimp": varimp.cpu().numpy().astype(np.float64),
            "response_domain": domain,
            "ntrees_actual": len(trees),
        }
        m = self.MODEL_CLS(key, self.params, out)
        m.scoring_history = list(history)
        if F is not None:
            m.training_metrics = _metrics_from_F(
                F, y, w, max(len(trees), 1), classification, domain)
        return m


class XRTModel(DRFModel):
    algo = "xrt"


class XRT(DRF):
    """Extremely randomized trees: H2O's DRF with random split points. The
    JAX package builds them as DRF (its ``_extra_random`` is read nowhere),
    and so does the port, under the algo name ``xrt``."""

    algo = "xrt"
    MODEL_CLS = XRTModel
