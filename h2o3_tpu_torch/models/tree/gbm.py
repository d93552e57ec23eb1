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
"""

from __future__ import annotations

import warnings
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
    free_graphs,
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


def check_ported(algo: str, p, **unported) -> None:
    """Refuse the options whose code paths are not ported yet (keyword:
    set or not), and trees of no depth or count."""
    unported.update(checkpoint=p.checkpoint is not None)
    bad = sorted(k for k, v in unported.items() if v)
    if bad:
        raise NotImplementedError(
            f"{algo.upper()} options not ported yet: {bad}")
    if p.ntrees < 1 or p.max_depth < 1:
        raise ValueError("ntrees and max_depth must be >= 1")


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
            f0 = torch.as_tensor(np.asarray(self.output["init_f"]),
                                 dtype=torch.float32, device=raw.device)
            return torch.softmax(raw + f0[None, :], dim=1)
        mu = response_transform(dist, raw + self.output["init_f"])
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
        check_ported(self.algo, p, offset_column=bool(p.offset_column))
        yv = train.vec(p.response_column)
        dist, aux = resolve_distribution(p.distribution, yv, p.quantile_alpha,
                                         p.tweedie_power, p.huber_alpha)
        classification = dist in ("bernoulli", "multinomial")
        if classification and not yv.is_categorical():
            raise ValueError(f"{dist} needs a categorical response")
        K = yv.cardinality if dist == "multinomial" else 1
        dev = train.device
        nrow = train.nrow

        # host spans for torch.profiler (tools/profile_gbm.py): gbm.*
        with record_function("gbm.setup"):
            spec = fit_bins_for(p, train, self._x)
            mono_vec = _monotone_vector(p, dist, self._x, spec.is_cat)

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
            F = _init_scores(f0, nrow, dev)
            varimp = torch.zeros(len(self._x), dtype=torch.float32,
                                 device=dev)
            vs = _validation_state(p, spec, valid, yv, classification, f0,
                                   dev)
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
            sample=sample, learn_rate=p.learn_rate,
            annealing=p.learn_rate_annealing,
            max_abs_leaf=p.max_abs_leafnode_pred, monotone=mono_vec,
            valid_bins=None if vs is None else vs["bins"],
            Fv=None if vs is None else vs["F"], score=score,
            stop_requested=self.stop_requested,
            reg=leaf_reg(getattr(p, "reg_lambda", 0.0),
                         getattr(p, "reg_alpha", 0.0)))

        out = {
            "bin_spec": spec,
            "trees": trees,
            "n_tree_classes": K,
            "distribution": dist,
            "init_f": f0,
            "names": list(self._x),
            "varimp": varimp.cpu().numpy().astype(np.float64),
            "response_domain": domain,
            "ntrees_actual": len(trees),
        }
        model = self.MODEL_CLS(None, p, out)
        model.scoring_history = history
        with record_function("gbm.final_metrics"):
            model.training_metrics = _metrics_from_F(dist, F, y, w, domain)
            if vs is not None:
                model.validation_metrics = _metrics_from_F(
                    dist, Fv, vs["y"], vs["w"], domain)
        return model


def grow_forest(p, spec: BinSpec, train: Frame, y, w, F, varimp, *,
                algo: str, grad_fn, grad_key, n_classes: int,
                sample: Sampling, learn_rate: float, annealing: float,
                max_abs_leaf: float, monotone, valid_bins, Fv,
                score, stop_requested=lambda: False, reg=None) -> tuple:
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
    mark the phases for ``torch.profiler``. Returns
    ``(trees, F, varimp, Fv)``, ``trees[iteration][class]``."""
    K = n_classes
    interval = max(1, p.score_tree_interval)
    lr = learn_rate
    trees: list[list[Tree]] = []
    n_bins = spec.max_bins
    with record_function(f"{algo}.bin_frame"):
        bins = bin_frame(spec, train)
    tree_kw = dict(n_bins=n_bins, is_cat_cols=spec.is_cat,
                   max_depth=p.max_depth, min_rows=p.min_rows,
                   min_split_improvement=p.min_split_improvement,
                   max_abs_leaf=max_abs_leaf, monotone=monotone, reg=reg)
    if use_fused_trees():
        cap = scan_chunk_cap(p.max_depth, n_bins, n_classes=K)
        with record_function(f"{algo}.whole_tree_setup"):  # capture on a miss
            builder = WholeTreeBuilder(
                bins, w, y, F, varimp, grad_fn=grad_fn, grad_key=grad_key,
                chunk_cap=min(interval, cap, p.ntrees), n_classes=K,
                sample=sample, **tree_kw)
        del bins  # the builder holds its own padded copy
        m_done = 0
        while m_done < p.ntrees and (m_done == 0 or not stop_requested()):
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
            if stop:
                break
        # the builder's buffers serve the next training of this shape
        return trees, builder.F.clone(), builder.varimp.clone(), Fv
    for m in range(p.ntrees):
        if m > 0 and stop_requested():
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
        if ((m + 1) % interval == 0 or m == p.ntrees - 1) and score(
                m + 1, F, Fv):
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


def _validation_state(p: GBMParams, spec: BinSpec, valid: Frame | None, yv,
                      classification: bool, f0, dev) -> dict | None:
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
            "F": _init_scores(f0, valid.nrow, dev)}


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


def _train_metric(dist, F, y, w, metric_name: str) -> float:
    """One scoring event's metric from the running scores; logloss (for
    classification) or rmse when the metric has no value for this kind."""
    m = _metrics_from_F(dist, F, y, w)
    v = m._v.get(metric_name)
    if v is None:
        v = m._v.get("logloss" if dist in ("bernoulli", "multinomial")
                     else "rmse")
    return float(v)
