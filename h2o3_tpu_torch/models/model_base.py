"""Model/ModelBuilder — the subset of ``h2o3_tpu/models/model_base.py`` the
GBM, DRF and GLM slices need: parameter validation (with parameter
aliases), feature selection, ``train``, ``predict``, ``_score_metrics``
(JAX's, on the frame's device), the scoring history, early
stopping (``ScoreKeeper``, ``stopping_metric_direction``) and
``download_mojo``. Jobs, the object
registry, REST, cross-validation and checkpoints are not ported.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import CAT, NUM, STR, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM

_KEYS = itertools.count(1)


@dataclass
class CommonParams:
    training_frame: Any = None
    validation_frame: Any = None
    response_column: str | None = None
    ignored_columns: Sequence[str] = field(default_factory=tuple)
    weights_column: str | None = None
    offset_column: str | None = None
    nfolds: int = 0
    seed: int = -1
    stopping_rounds: int = 0
    stopping_metric: str = "AUTO"
    stopping_tolerance: float = 1e-3
    checkpoint: Any = None


class ScoreKeeper:
    """Early stopping — JAX's ``ScoreKeeper`` (``hex.ScoreKeeper``): stop
    when the mean of the last ``rounds`` scores does not beat the best of
    the earlier ones by more than the relative tolerance."""

    def __init__(self, rounds: int, tolerance: float, larger_is_better: bool):
        self.rounds = rounds
        self.tol = tolerance
        self.larger = larger_is_better
        self.history: list[float] = []

    def record(self, value: float) -> None:
        self.history.append(float(value))

    def should_stop(self) -> bool:
        k = self.rounds
        if k <= 0 or len(self.history) < 2 * k:
            return False
        h = np.array(self.history, dtype=np.float64)
        recent = h[-k:].mean()
        ref = h[:-k]
        best_ref = ref.max() if self.larger else ref.min()
        if self.larger:
            return bool(recent <= best_ref * (1 + self.tol) - (
                0 if best_ref >= 0 else 2 * best_ref * self.tol))
        return bool(recent >= best_ref * (1 - self.tol) + (
            0 if best_ref >= 0 else -2 * best_ref * self.tol))


def stopping_metric_direction(metric: str, classification: bool,
                              nclasses: int) -> tuple[str, bool]:
    """Resolve AUTO and return ``(metric_name, larger_is_better)``."""
    m = metric.lower()
    if m == "auto":
        # logloss for classification, rmse for regression (rmse orders like
        # gaussian deviance and is always present)
        m = "logloss" if classification else "rmse"
    elif m == "deviance":
        m = "logloss" if classification else "mean_residual_deviance"
    larger = m in ("auc", "pr_auc", "accuracy", "f1", "r2", "lift_top_group")
    return m, larger


class Model:
    """A trained model. Subclasses implement ``_predict_raw``."""

    algo = "base"

    def __init__(self, key: str | None, params, output: dict):
        self.key = key or f"{self.algo}_model_{next(_KEYS)}"
        self.params = params
        self.output = output
        self.training_metrics: MM.ModelMetrics | None = None
        self.validation_metrics: MM.ModelMetrics | None = None
        # one entry per scoring event: {ntrees, training_<metric>[,
        # validation_<metric>]}
        self.scoring_history: list[dict] = []
        self.run_time_ms: int = 0

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Regression: (n,) predictions. Classification: (n, K) probs."""
        raise NotImplementedError

    def _distribution_for_metrics(self) -> str:
        """The deviance a regression model's metrics report."""
        return "gaussian"

    @property
    def is_classifier(self) -> bool:
        return self.output.get("response_domain") is not None

    @property
    def nclasses(self) -> int:
        d = self.output.get("response_domain")
        return len(d) if d else 1

    def predict(self, frame: Frame) -> Frame:
        """A Frame with ``predict`` (+ one probability column per class for
        classifiers), on the frame's device — the H2O layout."""
        raw = self._predict_raw(frame)
        if not self.is_classifier:
            return Frame([Vec(raw.to(torch.float32), NUM)], ["predict"])
        domain = self.output["response_domain"]
        if self.nclasses == 2:
            # H2O labels binary predictions by the max-F1 threshold
            thr = 0.5
            if self.training_metrics is not None:
                thr = self.training_metrics._v.get("default_threshold", 0.5)
            labels = raw[:, 1] >= thr
        else:
            labels = torch.argmax(raw, dim=1)
        dt, _ = Vec.device_dtype(CAT, domain)
        vecs = [Vec(labels.to(getattr(torch, dt.name)), CAT, domain=domain)]
        vecs += [Vec(raw[:, k].contiguous(), NUM) for k in range(len(domain))]
        return Frame(vecs, ["predict"] + [str(d) for d in domain])

    def download_mojo(self, path: str) -> str:
        """Write the tmojo artifact to ``path`` (``models/export.py``)."""
        from h2o3_tpu_torch.models.export import export_mojo

        return export_mojo(self, path)

    save_mojo = download_mojo

    def model_performance(self, test_data: Frame | None = None):
        if test_data is None:
            return self.training_metrics
        return self._score_metrics(test_data)

    def _score_metrics(self, frame: Frame) -> MM.ModelMetrics:
        """Metrics of the model's predictions on ``frame``, with the
        response and weights as tensors on the frame's device: on the card
        the metrics reduce there (``metrics.py``)."""
        from h2o3_tpu_torch.models.tree.binning import _adapt_codes

        yv = frame.vec(self.params.response_column)
        y = yv.data
        if self.is_classifier and yv.is_categorical():
            y = _adapt_codes(yv, self.output["response_domain"])
        w = None
        if self.params.weights_column:
            w = frame.vec(self.params.weights_column).data
        return _make_metrics(self, self._predict_raw(frame),
                             y.to(torch.float32), w)


def _remap_response(yv: Vec, domain) -> np.ndarray:
    if yv.domain == tuple(domain):
        return yv.to_numpy()
    lut = {d: i for i, d in enumerate(domain)}
    remap = np.full(len(yv.domain or ()) + 1, -1, dtype=np.int32)
    for j, d in enumerate(yv.domain or ()):
        remap[j] = lut.get(d, -1)
    codes = yv.to_numpy()
    return np.where(codes >= 0, remap[np.clip(codes, 0, None)], -1)


def _make_metrics(model: Model, raw, y, w) -> MM.ModelMetrics:
    if not model.is_classifier:
        return MM.regression_metrics(y, raw, w,
                                     model._distribution_for_metrics())
    domain = model.output["response_domain"]
    if raw.dim() == 2 and raw.shape[1] > 2:
        return MM.multinomial_metrics(y, raw, w, domain=domain)
    if raw.dim() == 2:
        raw = raw[:, 1]
    return MM.binomial_metrics(y, raw, w, domain=domain)


class ModelBuilder:
    """Base builder: subclasses set ``algo``/``PARAMS_CLS`` and implement
    ``_build(train, valid) -> Model``."""

    algo = "base"
    PARAMS_CLS = CommonParams

    # builder-declared parameter aliases (GLM's upstream "lambda")
    PARAM_ALIASES: dict = {}

    def __init__(self, **kwargs):
        for alias, canon in self.PARAM_ALIASES.items():
            if alias in kwargs:
                if canon in kwargs:
                    raise ValueError(
                        f"{alias!r} and {canon!r} are aliases — pass one")
                kwargs[canon] = kwargs.pop(alias)
        valid = {f.name for f in dataclasses.fields(self.PARAMS_CLS)}
        unknown = set(kwargs) - valid
        if unknown:
            raise ValueError(f"{self.algo}: unknown parameter(s) {sorted(unknown)}")
        self.params = self.PARAMS_CLS(**kwargs)
        self.model: Model | None = None
        self._x: list[str] = []

    def _features(self, frame: Frame, y: str | None) -> list[str]:
        drop = set(self.params.ignored_columns or ())
        for extra in (y, self.params.weights_column, self.params.offset_column):
            if extra:
                drop.add(extra)
        return [n for n in frame.names
                if n not in drop and frame.vec(n).kind != STR]

    def train(self, x=None, y: str | None = None,
              training_frame: Frame | None = None,
              validation_frame: Frame | None = None) -> Model:
        p = self.params
        if training_frame is not None:
            p.training_frame = training_frame
        if validation_frame is not None:
            p.validation_frame = validation_frame
        if y is not None:
            p.response_column = y
        train, valid = p.training_frame, p.validation_frame
        if not isinstance(train, Frame):
            raise ValueError("training_frame must be a Frame")
        if p.response_column not in train:
            raise ValueError(f"response {p.response_column!r} not in frame")
        if x is not None:
            self._x = [train.names[c] if isinstance(c, int) else str(c) for c in x]
        else:
            self._x = self._features(train, p.response_column)
        t0 = time.perf_counter()
        model = self._build(train, valid)
        model.run_time_ms = int(1000 * (time.perf_counter() - t0))
        self.model = model
        return model

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        raise NotImplementedError
