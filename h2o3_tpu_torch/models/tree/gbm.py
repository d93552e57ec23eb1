"""GBM — the port of ``h2o3_tpu/models/tree/gbm.py`` for the resident path
(every distribution of ``distributions.py``; multinomial grows K class
trees per iteration on one (n, K) score matrix). Leaf values are Newton
steps from the histogram stats, shrunk by ``learn_rate``.
``monotone_constraints`` ({column: +1 | -1}) run every split scan on kernel
B3 and clip leaves to the bounds the constrained splits propagate. Training
runs on the training frame's device.

Trees grow in scoring intervals, as in JAX. By default each interval of
``score_tree_interval`` trees (at most ``scan_chunk_cap``) is one chunk of
the whole-tree build (``shared_tree.WholeTreeBuilder``: on the card one
CUDA-graph replay per tree, kernels B1 and B2 or B3 inside, and for
multinomial one iteration-head replay per iteration), its records
pulled to the host in one transfer; ``H2O3_TPU_WHOLE_TREE=0`` builds each
tree with the eager per-level loop (``shared_tree.build_tree``) instead.
After each interval the training metric (and, with a ``validation_frame``,
the validation metric of the trees replayed onto its bins) goes into
``scoring_history``, and ``stopping_rounds`` / ``stopping_metric`` /
``stopping_tolerance`` stop training through a ``ScoreKeeper``. On the card
the metrics reduce on the device (``metrics.py``). ``sample_rate``,
``col_sample_rate`` and ``col_sample_rate_per_tree`` draw rows per
iteration and columns per tree and per split by keys of the seed
(``sampling.py``), inside the replayed graphs. :func:`grow_forest` is the
interval loop, which DRF and XGBoost share; it ends early, with the
partial model, once ``max_runtime_secs`` has passed (checked between
intervals, after the first). XGBoost (``xgboost.py``) adds the
regularized leaf (``reg_lambda``/``reg_alpha``) and ``scale_pos_weight``
on this builder.

``checkpoint=`` (a prior model, its key, or a saved model or snapshot
file) continues a training as the uninterrupted run would, as in JAX: the
prior's frozen parameters must be unchanged and ``ntrees`` above its
trees; its bins, init score, trees and variable importances carry over,
``F`` is the init score plus the prior's trees replayed onto the frame,
the learning rate resumes at ``learn_rate * annealing**trees`` and the
keyed draws at the prior's iteration count (on the card, a resumed
training of a cached shape captures no graph). With
``export_checkpoints_dir`` each scoring event writes an interval snapshot
of the partial model (``model_base``), and the finished model is saved.

``offset_column`` shifts the running scores, never the init score, as in
JAX: ``F`` starts at ``f0 + offset`` (a resumed ``F`` at ``f0 + offset +``
the prior's trees; the validation scores at ``f0`` plus the validation
frame's offset, 0 where it has none), and ``predict`` adds the scored
frame's offset to the margin, except for multinomial, whose prediction
JAX returns before the offset. ``calibrate_model`` with a
``calibration_frame`` fits Platt scaling or isotonic regression
(``calibration_method``) on that frame's predictions at the end of either
lane (``calibration.py``); ``predict`` then appends ``cal_p0``/``cal_p1``.
The tree models' analysis calls (``varimp``, ``predict_contributions``,
``predict_leaf_node_assignment``, ``tree_view``, ``model_summary``) are on
:class:`SharedTreeModel`, the first three through ``shap.py``.

``grow_policy="lossguide"`` with ``max_leaves`` rations each level's
splits against a leaf budget on the whole-tree build (refused on the eager
loop and out of core, as in JAX). Under ``H2O3_TPU_TREE_EFB`` a GBM or
XGBoost training on the whole-tree build bundles its exclusive columns
(:func:`efb_for`); GOSS and bin coarsening act inside the tree builder
(``shared_tree.py``).

Out of core (``frame/chunkstore.py``): a GBM or XGBoost training whose
per-row lanes pass ``H2O3_TPU_HBM_WINDOW_BYTES`` streams them as row
blocks through ``shared_tree.build_trees_streamed`` (JAX's
``_build_streamed``): the bins made slice by slice into the store's host
tier and the feature columns' device copies released, the validation
frame resident, the training metrics from the score lane, a checkpoint's
forest replayed block by block. Multinomial stays resident,
monotone builds stream, as in JAX; DRF has no streamed lane.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch.profiler import record_function

from h2o3_tpu_torch import config
from h2o3_tpu_torch.frame import chunkstore as cs
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.calibration import maybe_fit_calibration
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    ScoreKeeper,
    _remap_response,
    check_checkpoint_compat,
    resolve_checkpoint,
    stopping_metric_direction,
)
from h2o3_tpu_torch.models.tree.binning import (
    MAX_BINS,
    BinSpec,
    bin_frame,
    bucket_nbins,
    bundle_bins,
    fit_bins,
    fit_efb,
)
from h2o3_tpu_torch.models.tree.distributions import (
    grad_hess,
    init_score,
    multinomial_grad_hess,
    multinomial_init,
    resolve_distribution,
    response_transform,
)
from h2o3_tpu_torch.models.tree.sampling import Sampling
from h2o3_tpu_torch.models.tree.shared_tree import (
    Tree,
    WholeTreeBuilder,
    build_tree,
    build_trees_streamed,
    free_graphs,
    _bin_shifts,
    leaf_reg,
    replay_batch,
    scan_chunk_cap,
    trees_from_stacked,
    use_fused_trees,
)


@dataclass
class GBMParams(CommonParams):
    ntrees: int = 50
    max_depth: int = 5
    min_rows: float = 10.0
    nbins: int = MAX_BINS
    nbins_cats: int = 1024
    # accepted for surface parity, as in JAX: upstream starts each tree at
    # nbins_top_level bins and halves per level down to nbins; the static
    # quantile bins are fit once, so it has no effect (a warning says so)
    nbins_top_level: int = 1024
    min_split_improvement: float = 1e-5
    sample_rate: float = 1.0
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    score_tree_interval: int = 5
    # leaf-wise growth, as JAX's: "depthwise" (H2O's level order) or
    # "lossguide" (each level's splits rationed by gain rank against a
    # max_leaves budget, on the whole-tree build); max_leaves is read only
    # under lossguide
    grow_policy: str = "depthwise"
    max_leaves: int = 0
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
    # probability calibration (upstream calibrate_model/calibration_frame on
    # tree models): Platt scaling or isotonic regression fit on a holdout
    # frame's predictions; predict() then appends cal_p0/cal_p1 columns
    calibrate_model: bool = False
    calibration_frame: Any = None
    calibration_method: str = "AUTO"  # AUTO -> PlattScaling | IsotonicRegression


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


# the parameters a GBM or XGBoost checkpoint must keep (JAX's list; the
# xgboost fields are absent on GBMParams and compare as None)
GBM_FROZEN = ("max_depth", "nbins", "min_rows", "distribution", "learn_rate",
              "sample_rate", "col_sample_rate", "col_sample_rate_per_tree",
              "reg_lambda", "reg_alpha", "scale_pos_weight")


def check_ported(p) -> None:
    """Refuse trees of no depth or count."""
    if p.ntrees < 1 or p.max_depth < 1:
        raise ValueError("ntrees and max_depth must be >= 1")


def resolve_prior(builder, train: Frame, frozen) -> Model | None:
    """The checkpoint's prior model, checked as JAX checks it: its frozen
    parameters, and ``ntrees`` above the prior's trees."""
    p = builder.params
    prior = resolve_checkpoint(p.checkpoint, train.device)
    if prior is not None:
        check_checkpoint_compat(prior, builder, frozen)
        if p.ntrees <= prior.output["ntrees_actual"]:
            raise ValueError(
                "checkpoint continuation needs ntrees > "
                f"{prior.output['ntrees_actual']}")
    return prior


def prior_scores(prior: Model, frame: Frame, f0, dev,
                 offset=None) -> torch.Tensor:
    """The running scores where the prior stopped: the init score, plus
    the ``offset`` column's values when given, plus the prior's trees
    replayed onto ``frame`` (JAX's order of the additions)."""
    F = _add_offset(_init_scores(f0, frame.nrow, dev), offset)
    return F + prior._replay_all(frame)


def offset_of(p, frame: Frame | None):
    """The ``offset_column``'s values on ``frame``'s device, NA as 0, or
    None without an offset column (or with one the frame lacks)."""
    if frame is None or not p.offset_column or p.offset_column not in frame:
        return None
    return torch.nan_to_num(frame.vec(p.offset_column).data.to(torch.float32))


def _add_offset(F: torch.Tensor, offset) -> torch.Tensor:
    """The scores ``F`` ((n,) or (n, K): every class) shifted by the
    offset."""
    if offset is None:
        return F
    return F + (offset[:, None] if F.dim() == 2 else offset)


def lossguide_leaves(p) -> int:
    """``max_leaves`` under ``grow_policy="lossguide"``, else 0, with JAX's
    checks: a known policy, at least 2 leaves, and the whole-tree build
    (``H2O3_TPU_WHOLE_TREE=0`` refuses it, as JAX refuses it off its fused
    lane). The port's whole-tree build carries the monotone bounds with
    kernel B3 on the card, JAX's fused monotone lane, so a constrained
    lossguide build runs there."""
    if p.grow_policy not in ("depthwise", "lossguide"):
        raise ValueError("grow_policy must be 'depthwise' or 'lossguide', "
                         f"got {p.grow_policy!r}")
    if p.grow_policy != "lossguide":
        return 0
    if p.max_leaves < 2:
        raise ValueError("grow_policy=lossguide requires max_leaves >= 2")
    if not use_fused_trees():
        raise ValueError(
            "grow_policy=lossguide runs on the whole-tree build "
            "(H2O3_TPU_WHOLE_TREE=1)")
    return int(p.max_leaves)


def efb_for(spec: BinSpec, bins, nrow: int, max_depth: int) -> tuple:
    """``(EFBPlan, bundled codes)`` under ``H2O3_TPU_TREE_EFB``, or
    ``(None, None)``: JAX's gate — the whole-tree build, no bin-coarsening
    shift, and a plan that removes a column."""
    if not (config.get_bool("H2O3_TPU_TREE_EFB") and use_fused_trees()):
        return None, None
    cats = tuple(int(i) for i in np.nonzero(np.asarray(spec.is_cat))[0])
    if any(_bin_shifts(max_depth, bucket_nbins(spec.max_bins), cats)):
        return None, None
    efb = fit_efb(spec, bins, nrow=nrow)
    return (None, None) if efb is None else (efb, bundle_bins(efb, bins))


def fit_bins_for(p, train: Frame, x: list[str]) -> BinSpec:
    """The training's bins from a tree builder's parameters (JAX's
    ``fit_bins_for``), warning that ``nbins_top_level`` has no effect."""
    if p.nbins_top_level != 1024:
        warnings.warn(
            "nbins_top_level has no effect: bins are static quantiles "
            "fit once (upstream re-bins per level); tune nbins / "
            "nbins_cats", stacklevel=4)
    return fit_bins(train, x, nbins=p.nbins, seed=abs(p.seed) or 7,
                    nbins_cats=p.nbins_cats)


class SharedTreeModel(Model):
    """What GBM and DRF models share: the forest replayed onto a frame."""

    def _replay_all(self, frame: Frame) -> torch.Tensor:
        """Sum of tree contributions per row on the frame's device: (n,),
        or (n, K) with K class trees per iteration."""
        bins = bin_frame(self.output["bin_spec"], frame)
        K = self.output.get("n_tree_classes", 1)
        F = _init_scores(np.zeros(K) if K > 1 else 0.0, bins.shape[0],
                         bins.device)
        for group in self.output["trees"]:
            F = _replay_group(bins, group, F)
        return F

    def _varimp_table(self):
        vi = self.output.get("varimp")
        if vi is None:
            return None
        names = self.output["names"]
        order = np.argsort(-vi)
        rel = vi / max(vi.max(), 1e-30)
        pct = vi / max(vi.sum(), 1e-30)
        return [
            {
                "variable": names[i],
                "relative_importance": float(vi[i]),
                "scaled_importance": float(rel[i]),
                "percentage": float(pct[i]),
            }
            for i in order
        ]

    def varimp(self):
        return self._varimp_table()

    def predict_contributions(self, frame: Frame) -> Frame:
        """Per-feature SHAP contributions + BiasTerm (``shap.py``); a row
        sums to the raw margin."""
        from h2o3_tpu_torch.models.tree.shap import predict_contributions

        return predict_contributions(self, frame)

    def tree_view(self, tree_number: int = 0, tree_class: int = 0) -> dict:
        """Node table of one tree (H2O's TreeHandler)."""
        from h2o3_tpu_torch.models.tree.shap import tree_view

        return tree_view(self, tree_number, tree_class)

    def predict_leaf_node_assignment(self, frame: Frame,
                                     type: str = "Path") -> Frame:
        """Terminal leaf per (row, tree, class): decision-path strings or
        node ids (upstream ``Model.LeafNodeAssignment``)."""
        from h2o3_tpu_torch.models.tree.shap import (
            predict_leaf_node_assignment,
        )

        return predict_leaf_node_assignment(self, frame, type)

    def model_summary(self) -> dict:
        """The upstream model_summary table of a tree model: tree counts
        and the depth and leaf distribution over the forest, computed once
        and cached (trees do not change after the build)."""
        cached = self.output.get("_model_summary_cache")
        if cached is not None:
            return cached
        trees = self.output.get("trees") or []
        flat = [t for group in trees for t in group]
        depths = [t.depth for t in flat]
        leaves = [t.n_leaves for t in flat]
        out = {
            "number_of_trees": len(trees),
            "number_of_internal_trees": len(flat),
            "model_size_in_bytes": None,
            "min_depth": int(min(depths)) if depths else 0,
            "max_depth": int(max(depths)) if depths else 0,
            "mean_depth": float(np.mean(depths)) if depths else 0.0,
            "min_leaves": int(min(leaves)) if leaves else 0,
            "max_leaves": int(max(leaves)) if leaves else 0,
            "mean_leaves": float(np.mean(leaves)) if leaves else 0.0,
            "n_classes_per_iteration": self.output.get("n_tree_classes", 1),
        }
        self.output["_model_summary_cache"] = out
        return out


class GBMModel(SharedTreeModel):
    algo = "gbm"

    def _distribution_for_metrics(self) -> str:
        return _metric_distribution(self.output["distribution"])

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Bernoulli: (n, 2) and multinomial (n, K) class probabilities;
        otherwise (n,) predictions on the response scale (through the
        distribution's link)."""
        dist = self.output["distribution"]
        raw = self._replay_all(frame)
        if dist == "multinomial":
            # JAX returns before adding an offset (its training F has it)
            f0 = torch.as_tensor(np.asarray(self.output["init_f"]),
                                 dtype=torch.float32, device=raw.device)
            return torch.softmax(raw + f0[None, :], dim=1)
        f = _add_offset(raw + self.output["init_f"],
                        offset_of(self.params, frame))
        mu = response_transform(dist, f)
        if dist == "bernoulli":
            return torch.stack([1 - mu, mu], dim=1)
        return mu


class GBM(ModelBuilder):
    algo = "gbm"
    PARAMS_CLS = GBMParams
    MODEL_CLS = GBMModel

    @staticmethod
    def free_graphs() -> None:
        """Release the CUDA graphs the whole-tree build keeps between
        trainings (one set per tree shape, ``shared_tree.graph_stats``)."""
        free_graphs()

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: GBMParams = self.params
        check_ported(p)
        if p.offset_column and p.offset_column not in train:
            raise ValueError(f"offset_column {p.offset_column!r} not in frame")
        yv = train.vec(p.response_column)
        dist, aux = resolve_distribution(p.distribution, yv, p.quantile_alpha,
                                         p.tweedie_power, p.huber_alpha)
        classification = dist in ("bernoulli", "multinomial")
        if classification and not yv.is_categorical():
            raise ValueError(f"{dist} needs a categorical response")
        K = yv.cardinality if dist == "multinomial" else 1
        dev = train.device
        nrow = train.nrow

        prior = resolve_prior(self, train, GBM_FROZEN)
        # host spans for torch.profiler (tools/profile_gbm.py): gbm.*
        with record_function("gbm.setup"):
            # the prior's bins: its trees replay on the same codes
            spec = (prior.output["bin_spec"] if prior is not None
                    else fit_bins_for(p, train, self._x))
            mono_vec = _monotone_vector(p, dist, self._x, spec.is_cat)
            max_leaves = lossguide_leaves(p)
        # out of core (frame/chunkstore.py): lanes past the window train as
        # loops over row blocks; multinomial (K class trees share the row
        # state) stays resident, monotone builds stream, as in JAX
        if dist != "multinomial":
            store = self._plan_streamed(train)
            if store is not None:
                if max_leaves:
                    store.close()
                    raise ValueError(
                        "grow_policy=lossguide is resident-only: raise the "
                        "window (H2O3_TPU_HBM_WINDOW_BYTES) or train a "
                        "frame below it")
                return self._build_streamed(
                    train, valid, p, spec, dist, aux, yv, prior, store,
                    classification, mono_vec)
        with record_function("gbm.setup"):
            y_np, w_np = response_and_weights(p, train, yv, classification)
            w = torch.from_numpy(w_np).to(dev)
            y = torch.from_numpy(y_np).to(dev)
            domain = tuple(yv.domain) if classification else None
            # XGBoost's scale_pos_weight weighs the positive class in the
            # training weights only: the init score and the metrics keep w
            spw = float(getattr(p, "scale_pos_weight", 1.0))
            w_train = w
            if spw != 1.0:
                if dist != "bernoulli":
                    raise ValueError(
                        "scale_pos_weight requires a binary response")
                w_train = torch.from_numpy(w_np * np.where(
                    y_np == 1.0, spw, 1.0).astype(np.float32)).to(dev)

            if dist == "multinomial":
                f0 = multinomial_init(y_np, w_np, K)
            else:
                f0 = init_score(dist, y_np, w_np, aux)
            # the offset shifts F, never the init score (JAX's rule)
            offset = offset_of(p, train)
            F = _add_offset(_init_scores(f0, nrow, dev), offset)
            varimp = torch.zeros(len(self._x), dtype=torch.float32,
                                 device=dev)
            start, prior_trees = 0, []
            if prior is not None:
                # continue where the prior stopped: its init score, its
                # trees replayed into F, its variable importances
                f0 = prior.output["init_f"]
                F = prior_scores(prior, train, f0, dev, offset)
                varimp = torch.as_tensor(
                    np.asarray(prior.output["varimp"], np.float32),
                    device=dev)
                start = prior.output["ntrees_actual"]
                prior_trees = [list(g) for g in prior.output["trees"]]
            vs = _validation_state(p, spec, valid, yv, classification, f0,
                                   dev, offset=True)
            if vs is not None and prior is not None:
                vs["F"] = prior_scores(prior, valid, f0, dev, vs["offset"])
        history: list[dict] = []
        metric_name, larger = stopping_metric_direction(
            p.stopping_metric, classification, len(domain or ()))
        keeper = ScoreKeeper(p.stopping_rounds, p.stopping_tolerance, larger)

        def score(m_done: int, F, Fv) -> bool:
            """One scoring event; True when training should stop."""
            mval = _train_metric(dist, F, y, w, metric_name)
            entry = {"ntrees": m_done, f"training_{metric_name}": mval}
            stop_val = mval
            if vs is not None:
                stop_val = _train_metric(dist, Fv, vs["y"], vs["w"],
                                         metric_name)
                entry[f"validation_{metric_name}"] = stop_val
            history.append(entry)
            keeper.record(stop_val)
            return keeper.should_stop()

        def snapshot(trees, F_, varimp_):
            self._export_interval_checkpoint(
                lambda key: self._partial_model(
                    key, spec, trees, K, dist, f0, varimp_, domain, F_, y, w,
                    history))

        if dist == "multinomial":
            def grad_fn(F_, y_, w_):
                Y1h = (y_[:, None] == torch.arange(K, device=y_.device)
                       ).to(torch.float32)
                return multinomial_grad_hess(F_, Y1h, w_, K)
        else:
            def grad_fn(F_, y_, w_):
                return grad_hess(dist, F_, y_, w_, aux)

        sample = Sampling(p.seed if p.seed and p.seed > 0 else 1234,
                          p.sample_rate, p.col_sample_rate,
                          p.col_sample_rate_per_tree)
        trees, F, varimp, Fv = grow_forest(
            p, spec, train, y, w_train, F, varimp, algo=self.algo,
            grad_fn=grad_fn, grad_key=("gbm", dist, aux, K), n_classes=K,
            sample=sample,
            learn_rate=p.learn_rate * p.learn_rate_annealing ** start,
            annealing=p.learn_rate_annealing,
            max_abs_leaf=p.max_abs_leafnode_pred, monotone=mono_vec,
            valid_bins=None if vs is None else vs["bins"],
            Fv=None if vs is None else vs["F"], score=score,
            stop_requested=self.stop_requested,
            reg=leaf_reg(getattr(p, "reg_lambda", 0.0),
                         getattr(p, "reg_alpha", 0.0)),
            start=start, trees=prior_trees,
            snapshot=snapshot if p.export_checkpoints_dir else None,
            max_leaves=max_leaves, efb=True)

        model = self._partial_model(None, spec, trees, K, dist, f0, varimp,
                                    domain, None, y, w, history)
        with record_function("gbm.final_metrics"):
            model.training_metrics = _metrics_from_F(dist, F, y, w, domain)
            if vs is not None:
                model.validation_metrics = _metrics_from_F(
                    dist, Fv, vs["y"], vs["w"], domain)
        maybe_fit_calibration(self, model)
        return model

    def _plan_streamed(self, train: Frame):
        """The store of this training's lanes, or None for the resident
        path: bins (1 B a row and column), six float32 lanes and the int32
        node ids (JAX's ``len(x) + 28`` bytes a row)."""
        return cs.ChunkStore.plan(cs.pad_rows(train.nrow), len(self._x) + 28,
                                  device=train.device)

    def _build_streamed(self, train, valid, p, spec, dist, aux, yv, prior,
                        store, classification, mono_vec) -> Model:
        """Out-of-core GBM (JAX's ``_build_streamed``): the binning, slice by
        slice, into the store's host tier, the feature columns' device
        copies released, and the interval loop over
        :func:`build_trees_streamed`. The training metrics come from the
        running score lane (:func:`_lane_metrics`: on the card block by
        block, JAX reduces them on the host), the validation frame stays
        resident; a checkpoint's prior forest is replayed block by block
        into the score lane."""
        npad, nrow, dev = store.npad, train.nrow, train.device
        C = len(self._x)
        with record_function("gbm.setup"):
            y_np, w_np = response_and_weights(p, train, yv, classification)
            spw = float(getattr(p, "scale_pos_weight", 1.0))
            w_train = w_np
            if spw != 1.0:
                if dist != "bernoulli":
                    raise ValueError(
                        "scale_pos_weight requires a binary response")
                w_train = w_np * np.where(y_np == 1.0, spw, 1.0).astype(
                    np.float32)
            pad = (0, npad - nrow)
            store.add("y", np.pad(y_np, pad))
            store.add("w", np.pad(w_train, pad))
            # the metrics weigh by the unscaled weights
            w_metric = "w"
            if spw != 1.0:
                w_metric = "w_metric"
                store.add(w_metric, np.pad(w_np, pad))
            for name in ("F", "wt", "wy", "wh"):
                store.add_empty(name, (npad,), np.float32)
            store.add_empty("nid", (npad,), np.int32)
            # the binning is per row, so each slice's codes are the rows of
            # the whole frame's
            bins_lane = store.add_empty("bins", (npad, C), np.uint8)
            for lo, hi in cs.setup_slices(nrow):
                bf = cs.host_block_frame(train, spec.names, lo, hi)
                bins_lane[lo:hi] = bin_frame(spec, bf).cpu().numpy()
            cs.release_frame_features(train, spec.names)
            # the offset's host lane: it shifts F's start, block by block
            offset_np = np.zeros(npad, np.float32)
            if p.offset_column:
                offset_np[:nrow] = np.nan_to_num(train.vec(
                    p.offset_column).host_values().astype(np.float32))
            domain = tuple(yv.domain) if classification else None
            varimp = torch.zeros(C, dtype=torch.float32, device=dev)
            start, trees = 0, []
            if prior is not None:
                f0 = prior.output["init_f"]
                trees = [list(g) for g in prior.output["trees"]]
                varimp = torch.as_tensor(
                    np.asarray(prior.output["varimp"], np.float32),
                    device=dev)
                start = prior.output["ntrees_actual"]
                # the prior's forest replayed block by block into F
                for bi, blk in store.stream(("bins",)):
                    lo, hi = store.span(bi)
                    Fb = torch.from_numpy(
                        np.float32(f0) + offset_np[lo:hi]).to(dev)
                    for (t,) in trees:
                        _, Fb = t.replay(blk["bins"], torch.zeros_like(
                            Fb, dtype=torch.int32), Fb)
                    store.update(bi, F=Fb)
            else:
                f0 = init_score(dist, y_np, w_np, aux)
                store.lane("F")[:] = np.float32(f0) + offset_np
            vs = _validation_state(p, spec, valid, yv, classification, f0,
                                   dev, offset=True)
            if vs is not None and prior is not None:
                vs["F"] = prior_scores(prior, valid, f0, dev, vs["offset"])

        metric_name, larger = stopping_metric_direction(
            p.stopping_metric, classification, len(domain or ()))
        keeper = ScoreKeeper(p.stopping_rounds, p.stopping_tolerance, larger)
        history: list[dict] = []
        sample = Sampling(p.seed if p.seed and p.seed > 0 else 1234,
                          p.sample_rate, p.col_sample_rate,
                          p.col_sample_rate_per_tree)
        reg = leaf_reg(getattr(p, "reg_lambda", 0.0),
                       getattr(p, "reg_alpha", 0.0))
        annealing = p.learn_rate_annealing
        lr = p.learn_rate * annealing ** start
        interval = max(1, p.score_tree_interval)
        m_done = start
        while m_done < p.ntrees and (m_done == start
                                     or not self.stop_requested()):
            chunk = min(interval, p.ntrees - m_done)
            with record_function("gbm.build_trees"):
                new_trees, varimp = build_trees_streamed(
                    store, chunk,
                    grad_fn=lambda F_, y_, w_: grad_hess(dist, F_, y_, w_,
                                                         aux),
                    n_bins=spec.max_bins, is_cat_cols=spec.is_cat,
                    max_depth=p.max_depth, min_rows=p.min_rows,
                    min_split_improvement=p.min_split_improvement,
                    learn_rates=lr * annealing ** np.arange(chunk),
                    max_abs_leaf=p.max_abs_leafnode_pred, varimp=varimp,
                    sample=sample, tree_offset=m_done, reg=reg,
                    monotone=mono_vec)
            lr *= annealing ** chunk
            trees.extend([t] for t in new_trees)
            if vs is not None:
                vs["F"] = _replay_seq(vs["bins"], new_trees, vs["F"])
            m_done += chunk
            with record_function("gbm.score"):
                mm = _lane_metrics(dist, store, nrow, w_metric, domain)
                mval = _metric_value(mm, dist, metric_name)
                entry = {"ntrees": m_done, f"training_{metric_name}": mval}
                stop_val = mval
                if vs is not None:
                    stop_val = _train_metric(dist, vs["F"], vs["y"],
                                             vs["w"], metric_name)
                    entry[f"validation_{metric_name}"] = stop_val
                history.append(entry)
                keeper.record(stop_val)
            if p.export_checkpoints_dir:
                self._export_interval_checkpoint(
                    lambda key: _with_metrics(self._partial_model(
                        key, spec, trees, 1, dist, f0, varimp, domain,
                        None, None, None, history), mm))
            if keeper.should_stop():
                break
        model = self._partial_model(None, spec, trees, 1, dist, f0, varimp,
                                    domain, None, None, None, history)
        # the last scoring event's metrics are the final scores'
        model.training_metrics = mm
        with record_function("gbm.final_metrics"):
            if vs is not None:
                model.validation_metrics = _metrics_from_F(
                    dist, vs["F"], vs["y"], vs["w"], domain)
        store.close()
        maybe_fit_calibration(self, model)
        return model

    def _partial_model(self, key, spec, trees, K, dist, f0, varimp, domain,
                       F, y, w, history) -> Model:
        """The model of the forest so far, shaped as the final model (JAX's
        ``_partial_model``), so a snapshot predicts and resumes as a short
        uninterrupted run; with ``F`` it carries the training metrics of
        those scores."""
        out = {
            "bin_spec": spec,
            "trees": [list(g) for g in trees],
            "n_tree_classes": K,
            "distribution": dist,
            "init_f": f0,
            "names": list(self._x),
            "varimp": varimp.cpu().numpy().astype(np.float64),
            "response_domain": domain,
            "ntrees_actual": len(trees),
        }
        m = self.MODEL_CLS(key, self.params, out)
        m.scoring_history = list(history)
        if F is not None:
            m.training_metrics = _metrics_from_F(dist, F, y, w, domain)
        return m


def grow_forest(p, spec: BinSpec, train: Frame, y, w, F, varimp, *,
                algo: str, grad_fn, grad_key, n_classes: int,
                sample: Sampling, learn_rate: float, annealing: float,
                max_abs_leaf: float, monotone, valid_bins, Fv,
                score, stop_requested=lambda: False, reg=None,
                start: int = 0, trees: list | None = None,
                snapshot=None, max_leaves: int = 0,
                efb: bool = False) -> tuple:
    """The interval loop GBM, XGBoost and DRF share: ``p.ntrees``
    iterations of ``n_classes`` class trees on the running scores ``F``
    ((n,) or (n, K)) of ``train`` binned by ``spec``, in chunks of
    ``p.score_tree_interval`` whole trees (one record pull each), or tree
    by tree on the eager loop (``H2O3_TPU_WHOLE_TREE=0``). After each
    interval the validation scores ``Fv`` take the new trees (replayed onto
    ``valid_bins``) and ``score(m_done, F, Fv)`` records a scoring event;
    it returns True to stop. ``stop_requested()`` (the builder's soft
    deadline) is asked before every interval but the first, and on the
    eager loop before every iteration but the first: True ends the training
    with the trees built so far. ``reg`` (``(reg_lambda, reg_alpha)``, or
    None) regularizes the leaf values. The training bins are released once
    the whole-tree builder holds its padded copy. Host spans ``{algo}.*``
    mark the phases for ``torch.profiler``. A resumed training passes the
    prior's ``trees`` and their count ``start``: iterations run from
    ``start`` (the draws' key) at ``learn_rate``, the rate of iteration
    ``start``, with ``F``, ``varimp`` and ``Fv`` where the prior left
    them. ``snapshot(trees, F, varimp)``, when given, runs after each
    scoring event (the interval checkpoint). ``max_leaves`` > 0 grows
    lossguide trees; ``efb`` (GBM and XGBoost: DRF does not read the knob,
    as in JAX) bundles columns under ``H2O3_TPU_TREE_EFB`` (:func:`efb_for`).
    Returns ``(trees, F, varimp, Fv)``, ``trees[iteration][class]``."""
    K = n_classes
    interval = max(1, p.score_tree_interval)
    lr = learn_rate
    trees: list[list[Tree]] = list(trees or [])
    n_bins = spec.max_bins
    with record_function(f"{algo}.bin_frame"):
        bins = bin_frame(spec, train)
    tree_kw = dict(n_bins=n_bins, is_cat_cols=spec.is_cat,
                   max_depth=p.max_depth, min_rows=p.min_rows,
                   min_split_improvement=p.min_split_improvement,
                   max_abs_leaf=max_abs_leaf, monotone=monotone, reg=reg)
    if use_fused_trees():
        cap = scan_chunk_cap(p.max_depth, n_bins, n_classes=K)
        plan, bins_b = None, None
        if efb:
            with record_function(f"{algo}.efb"):
                plan, bins_b = efb_for(spec, bins, train.nrow, p.max_depth)
        with record_function(f"{algo}.whole_tree_setup"):  # capture on a miss
            builder = WholeTreeBuilder(
                bins, w, y, F, varimp, grad_fn=grad_fn, grad_key=grad_key,
                chunk_cap=min(interval, cap, p.ntrees), n_classes=K,
                sample=sample, max_leaves=max_leaves, efb=plan,
                bins_b=bins_b, **tree_kw)
        del bins, bins_b  # the builder holds its own padded copy
        m_done = start
        while m_done < p.ntrees and (m_done == start
                                     or not stop_requested()):
            chunk = min(interval, cap, p.ntrees - m_done)
            with record_function(f"{algo}.build_trees"):
                stacked = builder.build(
                    lr * annealing ** np.arange(chunk), m_done)
            lr *= annealing ** chunk
            with record_function(f"{algo}.pull_records"):
                flat = trees_from_stacked(stacked, chunk * K)
                trees.extend(flat[i: i + K] for i in range(0, len(flat), K))
            if Fv is not None:
                Fv = replay_batch(valid_bins, stacked, Fv)
            m_done += chunk
            with record_function(f"{algo}.score"):
                stop = score(m_done, builder.F, Fv)
            if snapshot is not None:
                snapshot(trees, builder.F, builder.varimp)
            if stop:
                break
        # the builder's buffers serve the next training of this shape
        return trees, builder.F.clone(), builder.varimp.clone(), Fv
    if max_leaves:
        raise ValueError("grow_policy=lossguide needs the whole-tree build")
    for m in range(start, p.ntrees):
        if m > start and stop_requested():
            break
        # the iteration's bootstrap, and every class's targets from F as
        # the iteration found it
        w_tree = sample.rows(m, w)
        T, H = grad_fn(F, y, w_tree)
        if K == 1:
            T, H, F = T[:, None], H[:, None], F[:, None]
        group, cols = [], []
        for k in range(K):
            tree, fk, varimp = build_tree(
                bins, w_tree, T[:, k], H[:, k], learn_rate=lr,
                preds=F[:, k], varimp=varimp, sample=sample, iteration=m,
                cls=k, **tree_kw)
            group.append(tree)
            cols.append(fk)
        F = cols[0] if K == 1 else torch.stack(cols, dim=1)
        trees.append(group)
        lr *= annealing
        if Fv is not None:
            Fv = _replay_group(valid_bins, group, Fv)
        if (m + 1) % interval == 0 or m == p.ntrees - 1:
            stop = score(m + 1, F, Fv)
            if snapshot is not None:
                snapshot(trees, F, varimp)
            if stop:
                break
    return trees, F, varimp, Fv


def response_and_weights(p, train: Frame, yv, classification: bool) -> tuple:
    """The training response and weights as float32 numpy: rows with no
    response (a class id below 0, or NaN) weigh 0, and so do rows of
    weight NaN; their response reads 0."""
    y_np = yv.to_numpy().astype(np.float64)
    w_np = np.ones(train.nrow, np.float32)
    if p.weights_column:
        w_np *= np.nan_to_num(
            train.vec(p.weights_column).to_numpy()).astype(np.float32)
    w_np *= (y_np >= 0) if classification else ~np.isnan(y_np)
    return np.nan_to_num(y_np, nan=0.0).astype(np.float32), w_np


def _init_scores(f0, n: int, dev) -> torch.Tensor:
    """The running scores at the init score: (n,) for one class, f0 (K,)
    tiled to (n, K) for multinomial."""
    if np.ndim(f0):
        return torch.as_tensor(np.asarray(f0, np.float32),
                               device=dev).repeat(n, 1)
    return torch.full((n,), f0, dtype=torch.float32, device=dev)


def _replay_group(bins, group: list[Tree], F) -> torch.Tensor:
    """One iteration's trees added to the scores of ``bins`` (tree k to
    column k of an (n, K) ``F``)."""
    cols = [F] if F.dim() == 1 else list(F.unbind(1))
    for k, tree in enumerate(group):
        _, cols[k] = tree.replay(bins, torch.zeros(
            bins.shape[0], dtype=torch.int32, device=bins.device), cols[k])
    return cols[0] if F.dim() == 1 else torch.stack(cols, dim=1)


def _with_metrics(model: Model, metrics: MM.ModelMetrics) -> Model:
    model.training_metrics = metrics
    return model


def _replay_seq(bins, trees: list[Tree], F) -> torch.Tensor:
    """Single-class trees added to the (n,) scores of ``bins``, in order."""
    for tree in trees:
        F = _replay_group(bins, [tree], F)
    return F


def _validation_state(p: GBMParams, spec: BinSpec, valid: Frame | None, yv,
                      classification: bool, f0, dev,
                      offset: bool = False) -> dict | None:
    """The validation frame binned with the training ``BinSpec``, its
    response (remapped to the training domain) and weights on the training
    device, and its running scores at the init score. With ``offset``
    (GBM) the scores start shifted by the frame's offset column (0 where
    the frame lacks it), which ``"offset"`` holds, so the validation
    metrics are those of a replay-scored prediction."""
    if valid is None:
        return None
    if valid.device != dev:
        raise ValueError(f"validation_frame is on {valid.device}, the "
                         f"training frame on {dev}")
    vv = valid.vec(p.response_column)
    yv_np = (_remap_response(vv, yv.domain) if classification
             else vv.to_numpy())
    wv_np = np.ones(valid.nrow, np.float32)
    if p.weights_column and p.weights_column in valid:
        wv_np *= np.nan_to_num(
            valid.vec(p.weights_column).to_numpy()).astype(np.float32)
    off = None
    if offset and p.offset_column:
        off = offset_of(p, valid)
        if off is None:
            off = torch.zeros(valid.nrow, dtype=torch.float32, device=dev)
    return {"bins": bin_frame(spec, valid),
            "y": torch.as_tensor(np.asarray(yv_np, np.float32), device=dev),
            "w": torch.from_numpy(wv_np).to(dev),
            "F": _add_offset(_init_scores(f0, valid.nrow, dev), off),
            "offset": off}


def _metric_distribution(dist: str) -> str:
    """The deviance regression metrics report: poisson, gamma and laplace
    have their own, every other distribution squared error."""
    return dist if dist in ("poisson", "gamma", "laplace") else "gaussian"


def _metrics_from_F(dist, F, y, w, domain=None) -> MM.ModelMetrics:
    """Metrics from the running scores (no tree replay): on the device
    when ``F`` is on the card, on the host otherwise (``metrics.py``)."""
    if dist == "multinomial":
        return MM.multinomial_metrics(y, torch.softmax(F, dim=1), w,
                                      domain=domain or ())
    mu = response_transform(dist, F)
    if dist == "bernoulli":
        return MM.binomial_metrics(y, mu, w, domain=domain or ("0", "1"))
    return MM.regression_metrics(y, mu, w, _metric_distribution(dist))


def _lane_metrics(dist, store, nrow: int, w_lane: str,
                  domain=None) -> MM.ModelMetrics:
    """Metrics of a store's score lane ``F`` against its ``y`` and the
    ``w_lane`` weights: on the card reduced block by block
    (``metrics.metrics_of_blocks``: the rows never on the device at once),
    on the CPU from the host lanes, exact, as JAX's are."""
    if store.device.type == "cuda":
        blocks = ((b["y"], response_transform(dist, b["F"]), b[w_lane])
                  for _bi, b in store.stream(("F", "y", w_lane)))
        if dist == "bernoulli":
            return MM.metrics_of_blocks("binomial", blocks,
                                        domain=domain or ("0", "1"))
        return MM.metrics_of_blocks(
            "regression", blocks, distribution=_metric_distribution(dist))
    F, y, w = (torch.from_numpy(store.lane(k)[:nrow].copy())
               for k in ("F", "y", w_lane))
    return _metrics_from_F(dist, F, y, w, domain)


def _metric_value(m: MM.ModelMetrics, dist, metric_name: str) -> float:
    """A scoring event's metric; logloss (for classification) or rmse when
    the metric has no value for this kind."""
    v = m._v.get(metric_name)
    if v is None:
        v = m._v.get("logloss" if dist in ("bernoulli", "multinomial")
                     else "rmse")
    return float(v)


def _train_metric(dist, F, y, w, metric_name: str) -> float:
    """One scoring event's metric from the running scores."""
    return _metric_value(_metrics_from_F(dist, F, y, w), dist, metric_name)
