"""Hyperparameter grid search — the port of ``h2o3_tpu/models/grid.py``.

A grid walks a hyperparameter space over any builder, with a Cartesian
walker or a seeded RandomDiscrete walker bounded by ``max_models`` and
``max_runtime_secs``, builds one model per combination on the training
frame's device, keeps a failing combination in ``grid.failures`` without
ending the grid, and can stop early when the grid's metric stops
improving (the builders' ``ScoreKeeper``). The RandomDiscrete walker is
JAX's, draw for draw: numpy's ``default_rng(seed)`` with rejection of
combinations already seen, so one seed gives JAX's sequence.

Models are built one after another: on one card and one stream a second
build in another thread would only queue behind the first. Refused with
``NotImplementedError``: ``parallelism > 1`` (JAX's threaded walker) and
``export_checkpoints_dir`` with its manifest and ``load_grid``, which need
model persistence (ROADMAP Queue A 5). Each build runs inside a
``grid.model`` span of ``torch.profiler``.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Sequence, Type

import numpy as np
from torch.profiler import record_function

from h2o3_tpu_torch.models.model_base import (
    Model,
    ModelBuilder,
    ScoreKeeper,
    get_model,
    stopping_metric_direction,
)

_LOG = logging.getLogger(__name__)
_GRID_KEYS = itertools.count(1)


class SearchCriteria:
    """``hyper_space_search_criteria``: the strategy and its budgets."""

    def __init__(
        self,
        strategy: str = "Cartesian",
        max_models: int = 0,
        max_runtime_secs: float = 0.0,
        seed: int = -1,
        stopping_rounds: int = 0,
        stopping_metric: str = "AUTO",
        stopping_tolerance: float = 1e-3,
    ):
        s = strategy.lower()
        if s not in ("cartesian", "randomdiscrete"):
            raise ValueError(f"unknown grid strategy {strategy!r}")
        self.strategy = "Cartesian" if s == "cartesian" else "RandomDiscrete"
        self.max_models = int(max_models)
        self.max_runtime_secs = float(max_runtime_secs)
        self.seed = seed
        self.stopping_rounds = stopping_rounds
        self.stopping_metric = stopping_metric
        self.stopping_tolerance = stopping_tolerance


def _grid_metrics(m: Model):
    """The metrics a grid ranks a model by: cross-validation, else
    validation, else training."""
    return m.cross_validation_metrics or m.validation_metrics or m.training_metrics


class Grid:
    """A trained grid: the models and their hyperparameter assignments."""

    def __init__(self, key: str, builder_cls: Type[ModelBuilder],
                 hyper_names: list[str]):
        self.key = key
        self.builder_cls = builder_cls
        self.hyper_names = hyper_names
        self.models: list[Model] = []
        self.hyper_values: list[dict] = []
        self.failures: list[tuple[dict, str]] = []

    @property
    def model_ids(self) -> list[str]:
        return [m.key for m in self.models]

    def sorted_metric_table(self, metric: str | None = None,
                            decreasing: bool | None = None) -> list[dict]:
        """Rows of (hyperparameter values, model key, metric), best first —
        the ``get_grid`` view."""
        if not self.models:
            return []
        m0 = self.models[0]
        name, larger = stopping_metric_direction(
            metric or "AUTO", m0.is_classifier, m0.nclasses)
        if decreasing is None:
            decreasing = larger
        rows = []
        for m, hv in zip(self.models, self.hyper_values):
            mm = _grid_metrics(m)
            val = mm.value(name) if mm is not None else float("nan")
            rows.append({**hv, "model_id": m.key, name: val})
        rows.sort(key=lambda r: (np.isnan(r[name]),
                                 -r[name] if decreasing else r[name]))
        return rows

    def best_model(self, metric: str | None = None) -> Model | None:
        tab = self.sorted_metric_table(metric)
        return get_model(tab[0]["model_id"]) if tab else None


def _space_size(hyper_params: dict[str, Sequence]) -> int:
    total = 1
    for v in hyper_params.values():
        total *= len(v)
    return total


def _walk(hyper_params: dict[str, Sequence], criteria: SearchCriteria):
    """The combinations in JAX's order: the Cartesian product, or uniform
    draws without replacement (lazy rejection sampling, memory bounded by
    the combinations consumed; a seed <= 0 seeds from the clock, as
    H2O's -1)."""
    names = list(hyper_params)
    combos = [list(hyper_params[n]) for n in names]
    if criteria.strategy == "Cartesian":
        for values in itertools.product(*combos):
            yield dict(zip(names, values))
        return
    sizes = [len(c) for c in combos]
    total = _space_size(hyper_params)
    rng = np.random.default_rng(
        criteria.seed if criteria.seed and criteria.seed > 0 else None)
    seen: set[tuple] = set()
    while len(seen) < total:
        idx = tuple(int(rng.integers(sz)) for sz in sizes)
        if idx in seen:
            continue
        seen.add(idx)
        yield {n: cand[i] for n, cand, i in zip(names, combos, idx)}


class GridSearch:
    """``H2OGridSearch``.

    >>> gs = GridSearch(GBM, {"max_depth": [3, 5], "learn_rate": [0.1, 0.3]})
    >>> grid = gs.train(x=feats, y="label", training_frame=fr)
    """

    def __init__(
        self,
        builder_cls: Type[ModelBuilder],
        hyper_params: dict[str, Sequence],
        search_criteria: dict | SearchCriteria | None = None,
        grid_id: str | None = None,
        parallelism: int = 1,
        **base_params,
    ):
        if isinstance(search_criteria, dict):
            search_criteria = SearchCriteria(**search_criteria)
        self.criteria = search_criteria or SearchCriteria()
        self.builder_cls = builder_cls
        self.hyper_params = dict(hyper_params)
        self.base_params = base_params
        self.parallelism = max(1, int(parallelism))
        self.grid = Grid(grid_id or f"grid_{next(_GRID_KEYS)}", builder_cls,
                         list(hyper_params))

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None) -> Grid:
        if self.parallelism > 1:
            raise NotImplementedError(
                "grid parallelism > 1 is not ported (ROADMAP Queue A 4: "
                "builds on one card and one stream run one after another)")
        if self.base_params.get("export_checkpoints_dir"):
            raise NotImplementedError(
                "grid export_checkpoints_dir is not ported (ROADMAP Queue "
                "A 5: model persistence)")
        return self._drive(x, y, training_frame, validation_frame)

    def _drive(self, x, y, training_frame, validation_frame) -> Grid:
        c = self.criteria
        t0 = time.time()
        keeper: ScoreKeeper | None = None
        metric_name: str | None = None
        for i, hv in enumerate(_walk(self.hyper_params, c)):
            # max_models bounds the models built: failures take no budget
            if c.max_models and len(self.grid.models) >= c.max_models:
                break
            if c.max_runtime_secs and time.time() - t0 > c.max_runtime_secs:
                _LOG.info("grid %s: max_runtime_secs reached after %d "
                          "models", self.grid.key, i)
                break
            try:
                with record_function("grid.model"):
                    builder = self.builder_cls(**{**self.base_params, **hv})
                    m = builder.train(x=x, y=y, training_frame=training_frame,
                                      validation_frame=validation_frame)
            except Exception as e:  # a failing combination is kept, as H2O
                self.grid.failures.append((dict(hv), repr(e)))
                _LOG.warning("grid %s: combo %s failed: %r", self.grid.key,
                             hv, e)
                continue
            self.grid.models.append(m)
            self.grid.hyper_values.append(dict(hv))
            if c.stopping_rounds:
                if keeper is None:
                    metric_name, larger = stopping_metric_direction(
                        c.stopping_metric, m.is_classifier, m.nclasses)
                    keeper = ScoreKeeper(c.stopping_rounds,
                                         c.stopping_tolerance, larger)
                keeper.record(_grid_metrics(m).value(metric_name))
                if keeper.should_stop():
                    _LOG.info("grid %s: early stop after %d models",
                              self.grid.key, i + 1)
                    break
        return self.grid
