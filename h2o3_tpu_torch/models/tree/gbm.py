"""GBM — the port of ``h2o3_tpu/models/tree/gbm.py`` for the resident,
single-class path (every distribution of ``distributions.py``). Leaf values
are Newton steps from the histogram stats, shrunk by ``learn_rate``.
``monotone_constraints`` ({column: +1 | -1}) run every split scan on kernel
B3 and clip leaves to the bounds the constrained splits propagate. Training
runs on the training frame's device.

Trees grow in scoring intervals, as in JAX. By default each interval of
``score_tree_interval`` trees (at most ``scan_chunk_cap``) is one chunk of
the whole-tree build (``shared_tree.WholeTreeBuilder``: on the card one
CUDA-graph replay per tree, kernels B1 and B2 or B3 inside), its records
pulled to the host in one transfer; ``H2O3_TPU_WHOLE_TREE=0`` builds each
tree with the eager per-level loop (``shared_tree.build_tree``) instead.
After each interval the training metric (and, with a ``validation_frame``,
the validation metric of the trees replayed onto its bins) goes into
``scoring_history``, and ``stopping_rounds`` / ``stopping_metric`` /
``stopping_tolerance`` stop training through a ``ScoreKeeper``. On the card
the metrics reduce on the device (``metrics.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

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
    _remap_response,
    stopping_metric_direction,
)
from h2o3_tpu_torch.models.tree.binning import MAX_BINS, BinSpec, bin_frame, fit_bins
from h2o3_tpu_torch.models.tree.distributions import (
    grad_hess,
    init_score,
    resolve_distribution,
    response_transform,
)
from h2o3_tpu_torch.models.tree.shared_tree import (
    Tree,
    WholeTreeBuilder,
    build_tree,
    free_graphs,
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
    min_split_improvement: float = 1e-5
    sample_rate: float = 1.0
    col_sample_rate: float = 1.0
    col_sample_rate_per_tree: float = 1.0
    score_tree_interval: int = 5
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
        "checkpoint": p.checkpoint is not None,
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

    @staticmethod
    def free_graphs() -> None:
        """Release the CUDA graphs the whole-tree build keeps between
        trainings (one set per tree shape, ``shared_tree.graph_stats``)."""
        free_graphs()

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

        # host spans for torch.profiler (tools/profile_gbm.py): gbm.*
        with record_function("gbm.setup"):
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
            domain = tuple(yv.domain) if classification else None

            f0 = init_score(dist, y_np, w_np, aux)
            F = torch.full((nrow,), f0, dtype=torch.float32, device=dev)
            varimp = torch.zeros(len(self._x), dtype=torch.float32,
                                 device=dev)
            vs = _validation_state(p, spec, valid, yv, classification, f0,
                                   dev)
        trees: list[list[Tree]] = []
        history: list[dict] = []
        metric_name, larger = stopping_metric_direction(
            p.stopping_metric, classification, 2)
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

        def grad_fn(F_, y_, w_):
            return grad_hess(dist, F_, y_, w_, aux)

        interval = max(1, p.score_tree_interval)
        Fv = None if vs is None else vs["F"]
        lr = p.learn_rate
        if use_fused_trees():
            cap = scan_chunk_cap(p.max_depth, spec.max_bins)
            with record_function("gbm.whole_tree_setup"):  # capture on a miss
                builder = WholeTreeBuilder(
                    bins, w, y, F, varimp, grad_fn=grad_fn,
                    grad_key=("gbm", dist, aux), n_bins=spec.max_bins,
                    is_cat_cols=spec.is_cat, max_depth=p.max_depth,
                    min_rows=p.min_rows,
                    min_split_improvement=p.min_split_improvement,
                    max_abs_leaf=p.max_abs_leafnode_pred,
                    chunk_cap=min(interval, cap, p.ntrees),
                    monotone=mono_vec)
            del bins  # the builder holds its own padded copy
            m_done = 0
            while m_done < p.ntrees:
                chunk = min(interval, cap, p.ntrees - m_done)
                with record_function("gbm.build_trees"):
                    stacked = builder.build(
                        lr * p.learn_rate_annealing ** np.arange(chunk))
                lr *= p.learn_rate_annealing ** chunk
                with record_function("gbm.pull_records"):
                    trees.extend([t] for t in trees_from_stacked(stacked,
                                                                  chunk))
                if Fv is not None:
                    Fv = replay_batch(vs["bins"], stacked, Fv)
                m_done += chunk
                with record_function("gbm.score"):
                    stop = score(m_done, builder.F, Fv)
                if stop:
                    break
            # the builder's buffers serve the next training of this shape
            F, varimp = builder.F.clone(), builder.varimp.clone()
        else:
            for m in range(p.ntrees):
                t, h = grad_fn(F, y, w)
                tree, F, varimp = build_tree(
                    bins, w, t, h, n_bins=spec.max_bins,
                    is_cat_cols=spec.is_cat, max_depth=p.max_depth,
                    min_rows=p.min_rows,
                    min_split_improvement=p.min_split_improvement,
                    learn_rate=lr, preds=F, varimp=varimp,
                    max_abs_leaf=p.max_abs_leafnode_pred, monotone=mono_vec)
                trees.append([tree])
                lr *= p.learn_rate_annealing
                if Fv is not None:
                    _, Fv = tree.replay(vs["bins"], torch.zeros(
                        len(Fv), dtype=torch.int32, device=dev), Fv)
                if ((m + 1) % interval == 0 or m == p.ntrees - 1) and score(
                        m + 1, F, Fv):
                    break

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
        model.scoring_history = history
        with record_function("gbm.final_metrics"):
            model.training_metrics = _metrics_from_F(dist, F, y, w, domain)
            if vs is not None:
                model.validation_metrics = _metrics_from_F(
                    dist, Fv, vs["y"], vs["w"], domain)
        return model


def _validation_state(p: GBMParams, spec: BinSpec, valid: Frame | None, yv,
                      classification: bool, f0: float, dev) -> dict | None:
    """The validation frame binned with the training ``BinSpec``, its
    response (remapped to the training domain) and weights on the training
    device, and its running scores at the init score."""
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
    return {"bins": bin_frame(spec, valid),
            "y": torch.as_tensor(np.asarray(yv_np, np.float32), device=dev),
            "w": torch.from_numpy(wv_np).to(dev),
            "F": torch.full((valid.nrow,), f0, dtype=torch.float32,
                            device=dev)}


def _metric_distribution(dist: str) -> str:
    """The deviance regression metrics report: poisson, gamma and laplace
    have their own, every other distribution squared error."""
    return dist if dist in ("poisson", "gamma", "laplace") else "gaussian"


def _metrics_from_F(dist, F, y, w, domain=None) -> MM.ModelMetrics:
    """Metrics from the running scores (no tree replay): on the device
    when ``F`` is on the card, on the host otherwise (``metrics.py``)."""
    mu = response_transform(dist, F)
    if dist == "bernoulli":
        return MM.binomial_metrics(y, mu, w, domain=domain or ("0", "1"))
    return MM.regression_metrics(y, mu, w, _metric_distribution(dist))


def _train_metric(dist, F, y, w, metric_name: str) -> float:
    """One scoring event's metric from the running scores."""
    m = _metrics_from_F(dist, F, y, w)
    v = m._v.get(metric_name)
    if v is None:
        v = m._v.get("logloss" if dist == "bernoulli" else "rmse")
    return float(v)
