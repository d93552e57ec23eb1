"""h2o-py-style estimators — the port of ``h2o3_tpu/estimators.py`` for the
ported builders. ``train()`` fits and turns the estimator into a model
proxy, so a script like

    fr = h2o3_tpu_torch.upload_file(df)          # on the GPU by default
    m = H2OGradientBoostingEstimator(ntrees=20, max_depth=6)
    m.train(y="label", training_frame=fr)
    m.auc(); m.predict(fr)

runs on the training frame's device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from h2o3_tpu_torch.models.tree.gbm import GBM


class _EstimatorBase:
    """Builder + trained-model proxy, the h2o-py estimator contract."""

    _BUILDER: type = type(None)

    def __init__(self, model_id: str | None = None, **kwargs):
        valid = {f.name for f in dataclasses.fields(self._BUILDER.PARAMS_CLS)}
        unknown = set(kwargs) - valid
        if unknown:
            raise TypeError(
                f"{type(self).__name__}: unknown parameters {sorted(unknown)}")
        self._kwargs = kwargs
        self._model_id = model_id
        self.model = None

    def train(self, x=None, y=None, training_frame=None, validation_frame=None):
        builder = self._BUILDER(**self._kwargs)
        self.model = builder.train(x=x, y=y, training_frame=training_frame,
                                   validation_frame=validation_frame)
        return self

    @property
    def model_id(self) -> str | None:
        return self.model.key if self.model is not None else self._model_id

    def _m(self):
        if self.model is None:
            raise ValueError("estimator is not trained yet — call train()")
        return self.model

    def predict(self, test_data):
        return self._m().predict(test_data)

    def model_performance(self, test_data=None):
        return self._m().model_performance(test_data)

    def _metric(self, name: str, valid: bool = False) -> float:
        m = self._m()
        mm = m.validation_metrics if valid else m.training_metrics
        return mm.value(name) if mm is not None else float("nan")

    def auc(self, valid=False):
        return self._metric("auc", valid)

    def logloss(self, valid=False):
        return self._metric("logloss", valid)

    def rmse(self, valid=False):
        return self._metric("rmse", valid)

    def __getattr__(self, item) -> Any:
        model = self.__dict__.get("model")
        if model is not None and hasattr(model, item):
            return getattr(model, item)
        raise AttributeError(item)


class H2OGradientBoostingEstimator(_EstimatorBase):
    """h2o-py style estimator for the GBM builder."""

    _BUILDER = GBM
