"""AutoML — the port of ``h2o3_tpu/automl/automl.py``.

AutoML runs a budgeted plan of modeling steps: preset XGBoosts, preset
GBMs, a GLM, DRF and XRT, a GBM grid, a DeepLearning grid, then two
stacked ensembles ("best of family" and "all"). Every model is
cross-validated so that the ensembles can stack the holdout predictions,
and ranked on a leaderboard by AUC (binomial) or the stopping metric's
AUTO, with an event log of what ran when. The plan, its presets and its
budgets are JAX's, value for value; the builders are the port's, on the
training frame's device.

A step that fails is logged and the plan goes on. Refused with
``NotImplementedError``: ``preprocessing=["target_encoding"]``
(``TargetEncoder`` is not ported, ROADMAP Queue A 10) and
``export_checkpoints_dir`` with its manifest and recovery (model
persistence, ROADMAP Queue A 5).

Each executed step runs inside an ``automl.step.<name>`` span of
``torch.profiler`` and leaves a row in ``step_log``: its seconds, the
models it built, and what the port's counters moved meanwhile — graph
captures (whole-tree plans, ADMM blocks, DeepLearning plans) and kernel
launches. Reading the counters reads no device.
"""

from __future__ import annotations

import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
from torch.profiler import record_function

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import Model, stopping_metric_direction

_LOG = logging.getLogger(__name__)
_AUTOML_KEYS = itertools.count(1)


@dataclass
class AutoMLSpec:
    max_models: int = 0                # 0 = unbounded (use max_runtime_secs)
    max_runtime_secs: float = 3600.0
    max_runtime_secs_per_model: float = 0.0
    nfolds: int = 5
    seed: int = -1
    stopping_metric: str = "AUTO"
    stopping_rounds: int = 3
    stopping_tolerance: float = 1e-3
    sort_metric: str = "AUTO"
    include_algos: Sequence[str] | None = None
    exclude_algos: Sequence[str] | None = None
    balance_classes: bool = False
    keep_cross_validation_predictions: bool = True
    project_name: str = ""
    # ["target_encoding"]: not ported (refused)
    preprocessing: Sequence[str] | None = None
    # > 0 enables the exploitation step: the best GBM refined with half its
    # learn rate and more trees, within ratio * max_runtime_secs
    exploitation_ratio: float = 0.0
    # not ported (refused): needs model persistence
    export_checkpoints_dir: str | None = None


class Leaderboard:
    """The ranked model table. With a ``leaderboard_frame`` models rank on
    their metrics there; otherwise on cross-validation, else validation,
    else training metrics. The sort is stable: ties keep the order in
    which the models were built."""

    def __init__(self, sort_metric: str, larger_is_better: bool,
                 leaderboard_frame=None):
        self.sort_metric = sort_metric
        self.larger = larger_is_better
        self.leaderboard_frame = leaderboard_frame
        self.models: list[Model] = []
        self._lb_metrics: dict[str, Any] = {}  # model key -> metrics there

    def add(self, *models: Model) -> None:
        for m in models:
            if m is not None:
                self.models.append(m)
        self.models.sort(key=self._key)

    def _key(self, m: Model):
        v = self._metric_of(m)
        return (np.isnan(v), -v if self.larger else v)

    def _metrics_for(self, m: Model):
        if self.leaderboard_frame is not None:
            if m.key not in self._lb_metrics:
                self._lb_metrics[m.key] = m._score_metrics(
                    self.leaderboard_frame)
            return self._lb_metrics[m.key]
        return (m.cross_validation_metrics or m.validation_metrics
                or m.training_metrics)

    def _metric_of(self, m: Model) -> float:
        mm = self._metrics_for(m)
        return mm.value(self.sort_metric) if mm else float("nan")

    @property
    def leader(self) -> Model | None:
        return self.models[0] if self.models else None

    def as_table(self, extra_columns=()) -> list[dict]:
        """The leaderboard's rows; ``extra_columns`` takes
        ``get_leaderboard``'s names ("training_time_ms", "ALL")."""
        if extra_columns == "ALL" or "ALL" in tuple(extra_columns or ()):
            extra_columns = ("training_time_ms",)
        rows = []
        for m in self.models:
            mm = self._metrics_for(m)
            row = {"model_id": m.key, "algo": m.algo,
                   self.sort_metric: self._metric_of(m)}
            if mm is not None:
                for extra in ("auc", "logloss", "rmse", "mse",
                              "mean_per_class_error",
                              "mean_residual_deviance"):
                    if extra != self.sort_metric and not np.isnan(
                            mm.value(extra)):
                        row[extra] = mm.value(extra)
            if "training_time_ms" in (extra_columns or ()):
                row["training_time_ms"] = int(getattr(m, "run_time_ms", 0)
                                              or 0)
            rows.append(row)
        return rows

    def __repr__(self):
        lines = [f"Leaderboard (sorted by {self.sort_metric}):"]
        for r in self.as_table():
            lines.append("  " + "  ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items()))
        return "\n".join(lines)


@dataclass
class _Step:
    name: str
    kind: str          # "model" | "grid" | "exploit" | "ensemble"
    algo: str
    params: dict = field(default_factory=dict)
    hyper: dict = field(default_factory=dict)
    weight: int = 10   # relative budget share (H2O's step weights)


def _default_plan() -> list[_Step]:
    """JAX's default plan, in H2O's step order: preset XGBoosts, preset
    GBMs, GLM, DRF, XRT, a GBM grid, a DeepLearning grid, exploitation,
    then the ensembles."""
    return [
        _Step("def_xgb_1", "model", "xgboost", dict(ntrees=50, max_depth=10, min_child_weight=5, sample_rate=0.6, col_sample_rate_per_tree=0.8, reg_lambda=0.8, reg_alpha=0.0)),
        _Step("def_xgb_2", "model", "xgboost", dict(ntrees=50, max_depth=20, min_child_weight=10, sample_rate=0.6, col_sample_rate_per_tree=0.8, reg_lambda=0.8, reg_alpha=0.0)),
        _Step("def_xgb_3", "model", "xgboost", dict(ntrees=50, max_depth=5, min_child_weight=3, sample_rate=0.8, col_sample_rate_per_tree=0.8, reg_lambda=1.0, reg_alpha=0.0)),
        _Step("def_gbm_1", "model", "gbm", dict(ntrees=50, max_depth=6, learn_rate=0.1, sample_rate=0.8, col_sample_rate=0.8)),
        _Step("def_gbm_2", "model", "gbm", dict(ntrees=50, max_depth=3, learn_rate=0.1, sample_rate=0.9, col_sample_rate=1.0)),
        _Step("def_gbm_3", "model", "gbm", dict(ntrees=50, max_depth=9, learn_rate=0.1, sample_rate=0.7, col_sample_rate=0.6)),
        _Step("def_glm", "model", "glm", dict()),
        _Step("def_drf", "model", "drf", dict(ntrees=50)),
        _Step("def_xrt", "model", "xrt", dict(ntrees=50)),
        _Step(
            "grid_gbm", "grid", "gbm",
            dict(ntrees=50),
            hyper={
                "max_depth": [3, 5, 7],
                "learn_rate": [0.05, 0.1, 0.3],
                "sample_rate": [0.6, 0.8, 1.0],
            },
            weight=60,
        ),
        _Step(
            "grid_dl", "grid", "deeplearning",
            dict(epochs=20),
            hyper={
                "hidden": [[32, 32], [64], [128, 64]],
                "input_dropout_ratio": [0.0, 0.1],
            },
            weight=30,
        ),
        _Step("exploit_gbm_lr_annealing", "exploit", "gbm", weight=10),
        _Step("se_best_of_family", "ensemble", "stackedensemble", dict(flavor="best_of_family")),
        _Step("se_all", "ensemble", "stackedensemble", dict(flavor="all")),
    ]


def step_counters() -> dict:
    """The port's counters now: graph captures (whole-tree plans, ADMM
    blocks, DeepLearning plans) and launches by kernel wrapper. Python
    ints: reading them reads no device."""
    from h2o3_tpu_torch.models.deeplearning import SGD_EVENTS
    from h2o3_tpu_torch.models.tree.shared_tree import GRAPH_EVENTS
    from h2o3_tpu_torch.ops import cuda_graph
    from h2o3_tpu_torch.ops.gram import ADMM_EVENTS

    return {"tree_graphs": GRAPH_EVENTS["captures"],
            "admm_blocks": ADMM_EVENTS["captures"],
            "dl_plans": SGD_EVENTS["captures"], **cuda_graph.snapshot()}


class AutoML:
    """``H2OAutoML``.

    >>> aml = AutoML(max_models=8, seed=1)
    >>> aml.train(y="label", training_frame=fr)
    >>> aml.leaderboard.leader
    """

    def __init__(self, **kwargs):
        self.spec = AutoMLSpec(**kwargs)
        self.key = f"automl_{next(_AUTOML_KEYS)}"
        self.leaderboard: Leaderboard | None = None
        self.event_log: list[dict] = []
        # one row per executed step: seconds, models built, counter moves
        self.step_log: list[dict] = []
        self._t0 = 0.0

    # -- public ----------------------------------------------------------
    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, leaderboard_frame=None) -> Model | None:
        s = self.spec
        if s.preprocessing and "target_encoding" in [
                str(q).lower() for q in s.preprocessing]:
            raise NotImplementedError(
                "AutoML preprocessing=['target_encoding'] is not ported "
                "(ROADMAP Queue A 10: TargetEncoder)")
        if s.export_checkpoints_dir:
            raise NotImplementedError(
                "AutoML export_checkpoints_dir is not ported (ROADMAP Queue "
                "A 5: model persistence)")
        self._drive(x, y, training_frame, validation_frame, leaderboard_frame)
        return self.leader

    @property
    def leader(self) -> Model | None:
        return self.leaderboard.leader if self.leaderboard else None

    # -- internals -------------------------------------------------------
    def _log(self, stage: str, message: str) -> None:
        self.event_log.append({"ts": time.time(), "stage": stage,
                               "message": message})
        _LOG.info("AutoML[%s] %s: %s", self.key, stage, message)

    def _remaining(self) -> float:
        if not self.spec.max_runtime_secs:
            return float("inf")
        return self.spec.max_runtime_secs - (time.time() - self._t0)

    def _algo_allowed(self, algo: str) -> bool:
        inc, exc = self.spec.include_algos, self.spec.exclude_algos
        canon = {"gbm": "GBM", "xgboost": "XGBoost", "glm": "GLM",
                 "drf": "DRF", "xrt": "XRT", "deeplearning": "DeepLearning",
                 "stackedensemble": "StackedEnsemble"}[algo]
        if inc is not None:
            return canon in inc
        if exc is not None:
            return canon not in exc
        return True

    def _builder_cls(self, algo: str):
        from h2o3_tpu_torch.models.deeplearning import DeepLearning
        from h2o3_tpu_torch.models.glm import GLM
        from h2o3_tpu_torch.models.tree.drf import DRF, XRT
        from h2o3_tpu_torch.models.tree.gbm import GBM
        from h2o3_tpu_torch.models.tree.xgboost import XGBoost

        return {"gbm": GBM, "xgboost": XGBoost, "glm": GLM, "drf": DRF,
                "xrt": XRT, "deeplearning": DeepLearning}[algo]

    def _builder(self, algo: str, params: dict):
        return self._builder_cls(algo)(**params)

    def _exploit_gbm(self, family_best, x, y, train, validation_frame):
        """Exploitation: the best GBM again with half its learn rate and
        twice its trees (H2O's lr_annealing refinement)."""
        best = family_best.get("gbm")
        if best is None:
            return None
        s = self.spec
        p = best.params
        kw = {
            **self._common(),
            "ntrees": max(p.ntrees * 2, p.ntrees + 50),
            "max_depth": p.max_depth,
            "learn_rate": max(p.learn_rate * 0.5, 1e-3),
            "sample_rate": p.sample_rate,
            "col_sample_rate": p.col_sample_rate,
        }
        # the ratio's share of the whole budget, within what remains; with
        # no whole budget the per-model cap of _common() stays
        if s.max_runtime_secs:
            kw["max_runtime_secs"] = min(
                s.max_runtime_secs * s.exploitation_ratio,
                max(self._remaining(), 1.0))
        return self._builder("gbm", kw).train(
            x=x, y=y, training_frame=train, validation_frame=validation_frame)

    def _common(self) -> dict:
        # the seed passes through: <= 0 keeps each builder's unseeded
        # contract, > 0 makes the whole run reproducible
        s = self.spec
        out = dict(nfolds=s.nfolds, keep_cross_validation_predictions=True,
                   seed=s.seed)
        if s.max_runtime_secs_per_model:
            out["max_runtime_secs"] = s.max_runtime_secs_per_model
        if s.max_runtime_secs:
            # one model never takes more than what remains of the whole
            # budget (the builders' soft deadline keeps the partial model)
            rem = max(self._remaining(), 1.0)
            out["max_runtime_secs"] = min(out.get("max_runtime_secs") or rem,
                                          rem)
        return out

    def _drive(self, x, y, training_frame, validation_frame,
               leaderboard_frame) -> Leaderboard:
        s = self.spec
        self._t0 = time.time()
        train = training_frame
        if not isinstance(train, Frame):
            raise ValueError("training_frame must be a Frame")
        yv = train.vec(y)
        classification = yv.is_categorical()
        nclasses = len(yv.domain) if classification else 1
        sort_metric, larger = stopping_metric_direction(
            s.sort_metric if s.sort_metric.lower() != "auto"
            else ("auc" if (classification and nclasses == 2) else "AUTO"),
            classification, nclasses)
        self.leaderboard = Leaderboard(sort_metric, larger,
                                       leaderboard_frame=leaderboard_frame)
        self._log("init", "AutoML build started: "
                  f"{'classification' if classification else 'regression'}"
                  f", sort_metric={sort_metric}")

        plan = [st for st in _default_plan() if self._algo_allowed(st.algo)]
        n_models_built = 0
        family_best: dict[str, Model] = {}
        total_w = sum(st.weight for st in plan) or 1
        done_w = 0
        for st in plan:
            if self._remaining() <= 0:
                self._log("budget", "max_runtime_secs exhausted; stopping plan")
                break
            # ensembles and exploitation never count against max_models
            if (s.max_models and n_models_built >= s.max_models
                    and st.kind not in ("ensemble", "exploit")):
                done_w += st.weight
                continue
            n_before = n_models_built
            before = step_counters()
            t0 = time.perf_counter()
            try:
                with record_function(f"automl.step.{st.name}"):
                    n_models_built += self._run_step(
                        st, x, y, train, validation_frame, family_best,
                        n_models_built, total_w - done_w, sort_metric)
            except Exception as e:  # a failing step is logged; the plan goes on
                self._log("error", f"{st.name} failed: {e!r}")
            t1 = time.perf_counter()
            after = step_counters()
            self.step_log.append({
                "step": st.name, "kind": st.kind, "algo": st.algo,
                "seconds": t1 - t0, "t0": t0, "t1": t1,
                "models": n_models_built - n_before,
                "counters": {k: v - before.get(k, 0)
                             for k, v in after.items()}})
            done_w += st.weight

        self._log("done", "AutoML ended: "
                  f"{len(self.leaderboard.models)} models on leaderboard")
        return self.leaderboard

    def _run_step(self, st: _Step, x, y, train, validation_frame,
                  family_best: dict, n_models_built: int, w_left: int,
                  sort_metric: str) -> int:
        """Run one step; returns the models it built that count against
        ``max_models``."""
        s = self.spec
        lb = self.leaderboard
        if st.kind == "model":
            m = self._builder(st.algo, {**st.params, **self._common()}).train(
                x=x, y=y, training_frame=train,
                validation_frame=validation_frame)
            lb.add(m)
            self._update_family_best(family_best, m)
            self._log("model", f"{st.name} -> {m.key} "
                      f"{sort_metric}={lb._metric_of(m):.5g}")
            return 1
        if st.kind == "grid":
            from h2o3_tpu_torch.models.grid import GridSearch, SearchCriteria

            budget = self._remaining()
            n_left = (s.max_models - n_models_built) if s.max_models else 0
            crit = SearchCriteria(
                strategy="RandomDiscrete",
                max_models=max(1, n_left) if s.max_models else 0,
                max_runtime_secs=(budget * st.weight / max(1, w_left)
                                  if np.isfinite(budget) else 0.0),
                seed=s.seed,
                stopping_rounds=s.stopping_rounds,
                stopping_metric=s.stopping_metric,
                stopping_tolerance=s.stopping_tolerance)
            gs = GridSearch(self._builder_cls(st.algo), st.hyper,
                            search_criteria=crit,
                            **{**st.params, **self._common()})
            grid = gs.train(x=x, y=y, training_frame=train,
                            validation_frame=validation_frame)
            lb.add(*grid.models)
            for m in grid.models:
                self._update_family_best(family_best, m)
            self._log("grid", f"{st.name} built {len(grid.models)} models")
            return len(grid.models)
        if st.kind == "exploit":
            if s.exploitation_ratio <= 0:
                return 0  # off by default, as H2O
            m = self._exploit_gbm(family_best, x, y, train, validation_frame)
            if m is None:
                return 0
            lb.add(m)
            self._update_family_best(family_best, m)
            self._log("exploit", f"{st.name} -> {m.key} "
                      f"{sort_metric}={lb._metric_of(m):.5g}")
            return 1
        m = self._build_ensemble(st, family_best, y, train, validation_frame)
        if m is not None:
            lb.add(m)
            self._log("ensemble", f"{st.name} -> {m.key} "
                      f"{sort_metric}={lb._metric_of(m):.5g}")
        return 0

    def _update_family_best(self, family_best: dict[str, Model],
                            m: Model) -> None:
        cur = family_best.get(m.algo)
        if cur is None or self.leaderboard._key(m) < self.leaderboard._key(cur):
            family_best[m.algo] = m

    def _build_ensemble(self, st: _Step, family_best: dict[str, Model], y,
                        train, valid):
        from h2o3_tpu_torch.models.ensemble import StackedEnsemble

        if st.params.get("flavor") == "best_of_family":
            base = list(family_best.values())
        else:
            base = [m for m in self.leaderboard.models
                    if m.algo != "stackedensemble"]
        base = [m for m in base if m.cv_predictions is not None]
        if len(base) < 2:
            self._log("ensemble",
                      f"{st.name} skipped (<2 stackable base models)")
            return None
        return StackedEnsemble(base_models=base, seed=self.spec.seed).train(
            y=y, training_frame=train, validation_frame=valid)
