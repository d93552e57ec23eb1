"""Model/ModelBuilder — the subset of ``h2o3_tpu/models/model_base.py`` the
GBM slice needs: parameter validation, feature selection, ``train``,
``predict`` and ``_response_and_weights``. Jobs, the object registry, REST,
cross-validation and checkpoints are not ported.
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
    checkpoint: Any = None


class Model:
    """A trained model. Subclasses implement ``_predict_raw``."""

    algo = "base"

    def __init__(self, key: str | None, params, output: dict):
        self.key = key or f"{self.algo}_model_{next(_KEYS)}"
        self.params = params
        self.output = output
        self.training_metrics: MM.ModelMetrics | None = None
        self.validation_metrics: MM.ModelMetrics | None = None
        self.run_time_ms: int = 0

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """Regression: (n,) predictions. Classification: (n, K) probs."""
        raise NotImplementedError

    @property
    def is_classifier(self) -> bool:
        return self.output.get("response_domain") is not None

    def predict(self, frame: Frame) -> Frame:
        """A Frame with ``predict`` (+ one probability column per class for
        binomial classifiers), on the frame's device — the H2O layout."""
        raw = self._predict_raw(frame)
        if not self.is_classifier:
            return Frame([Vec(raw.to(torch.float32), NUM)], ["predict"])
        domain = self.output["response_domain"]
        # H2O labels by the max-F1 threshold, not argmax
        thr = 0.5
        if self.training_metrics is not None:
            thr = self.training_metrics._v.get("default_threshold", 0.5)
        labels = raw[:, 1] >= thr
        dt, _ = Vec.device_dtype(CAT, domain)
        vecs = [Vec(labels.to(getattr(torch, dt.name)), CAT, domain=domain)]
        vecs += [Vec(raw[:, k].contiguous(), NUM) for k in range(len(domain))]
        return Frame(vecs, ["predict"] + [str(d) for d in domain])

    def model_performance(self, test_data: Frame | None = None):
        if test_data is None:
            return self.training_metrics
        y, w = self._response_and_weights(test_data)
        return _make_metrics(self, self._predict_raw(test_data), y, w)

    def _response_and_weights(self, frame: Frame):
        yv = frame.vec(self.params.response_column)
        y = yv.to_numpy()
        if self.is_classifier and yv.is_categorical():
            y = _remap_response(yv, self.output["response_domain"])
        w = None
        if self.params.weights_column:
            w = frame.vec(self.params.weights_column).to_numpy()
        return y, w


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
        return MM.regression_metrics(y, raw, w)
    domain = model.output["response_domain"]
    if raw.dim() == 2 and raw.shape[1] == 2:
        raw = raw[:, 1]
    if raw.dim() != 1:
        raise NotImplementedError("multinomial metrics are not ported yet")
    return MM.binomial_metrics(y, raw, w, domain=domain)


class ModelBuilder:
    """Base builder: subclasses set ``algo``/``PARAMS_CLS`` and implement
    ``_build(train, valid) -> Model``."""

    algo = "base"
    PARAMS_CLS = CommonParams

    def __init__(self, **kwargs):
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
