"""h2o-py-style estimators — the port of ``h2o3_tpu/estimators.py`` for the
ported builders. ``train()`` fits and turns the estimator into a model
proxy, so a script like

    fr = h2o3_tpu_torch.upload_file(df)          # on the GPU by default
    m = H2OGradientBoostingEstimator(ntrees=20, max_depth=6)
    m.train(y="label", training_frame=fr)
    m.auc(); m.predict(fr); m.download_mojo("/tmp")

runs on the training frame's device. ``H2ORandomForestEstimator`` and
``H2OXRTEstimator`` train DRF and XRT the same way,
``H2OXGBoostEstimator`` XGBoost (the xgboost parameter names accepted),
and ``H2OGeneralizedLinearEstimator`` trains a GLM (``m.coef``,
``m.coef_norm()``, ``m.null_deviance``, ``m.residual_deviance`` and
``m.regularization_path`` through the model proxy). With ``nfolds=k``
each estimator also trains k fold models: ``m.auc(xval=True)`` and the
other metric accessors read the cross-validation metrics, and
``m.cv_models``, ``m.cross_validation_metrics`` and ``m.cv_predictions``
(with ``keep_cross_validation_predictions=True``) come through the proxy.
``H2ODeepLearningEstimator`` trains the sync-SGD MLP (``m.model_summary()``,
``m.scoring_history``), and ``H2OAutoEncoderEstimator`` the autoencoder:
``train(training_frame=fr)`` with no response, then ``m.anomaly(fr)`` and
``m.predict(fr)`` (the ``reconstr_*`` columns).
``H2OStackedEnsembleEstimator(base_models=[...])`` stacks cross-validated
models (given as models or keys) with a metalearner.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from h2o3_tpu_torch.models.deeplearning import DeepLearning
from h2o3_tpu_torch.models.ensemble import StackedEnsemble
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.tree.drf import DRF, XRT
from h2o3_tpu_torch.models.tree.gbm import GBM
from h2o3_tpu_torch.models.tree.xgboost import XGBoost


class _EstimatorBase:
    """Builder + trained-model proxy, the h2o-py estimator contract."""

    _BUILDER: type = type(None)

    def __init__(self, model_id: str | None = None, **kwargs):
        valid = {f.name for f in dataclasses.fields(self._BUILDER.PARAMS_CLS)}
        valid |= set(self._BUILDER.PARAM_ALIASES)  # GLM's "lambda"
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

    def _metric(self, name: str, valid: bool = False,
                xval: bool = False) -> float:
        m = self._m()
        mm = (m.cross_validation_metrics if xval
              else m.validation_metrics if valid else m.training_metrics)
        return mm.value(name) if mm is not None else float("nan")

    def auc(self, valid=False, xval=False):
        return self._metric("auc", valid, xval)

    def logloss(self, valid=False, xval=False):
        return self._metric("logloss", valid, xval)

    def rmse(self, valid=False, xval=False):
        return self._metric("rmse", valid, xval)

    def mse(self, valid=False, xval=False):
        return self._metric("mse", valid, xval)

    def mae(self, valid=False, xval=False):
        return self._metric("mae", valid, xval)

    def r2(self, valid=False, xval=False):
        return self._metric("r2", valid, xval)

    def download_mojo(self, path: str = ".") -> str:
        """Write the tmojo; a directory gets ``<model key>.zip`` inside."""
        import os

        p = path
        if os.path.isdir(p):
            p = os.path.join(p, f"{self._m().key}.zip")
        return self._m().download_mojo(p)

    def save_mojo(self, path: str = ".") -> str:
        return self.download_mojo(path)

    def __getattr__(self, item) -> Any:
        model = self.__dict__.get("model")
        if model is not None and hasattr(model, item):
            return getattr(model, item)
        raise AttributeError(item)


class H2OGradientBoostingEstimator(_EstimatorBase):
    """h2o-py style estimator for the GBM builder."""

    _BUILDER = GBM


class H2ORandomForestEstimator(_EstimatorBase):
    """h2o-py style estimator for the DRF builder."""

    _BUILDER = DRF


class H2OXRTEstimator(_EstimatorBase):
    """h2o-py style estimator for the XRT builder."""

    _BUILDER = XRT


class H2OXGBoostEstimator(_EstimatorBase):
    """h2o-py style estimator for the XGBoost builder."""

    _BUILDER = XGBoost


class H2OGeneralizedLinearEstimator(_EstimatorBase):
    """h2o-py style estimator for the GLM builder."""

    _BUILDER = GLM


class H2ODeepLearningEstimator(_EstimatorBase):
    """h2o-py style estimator for the DeepLearning builder."""

    _BUILDER = DeepLearning


class H2OStackedEnsembleEstimator(_EstimatorBase):
    """h2o-py style estimator for the StackedEnsemble builder."""

    _BUILDER = StackedEnsemble


class H2OAutoEncoderEstimator(_EstimatorBase):
    """DeepLearning with ``autoencoder=True`` forced: ``train()`` needs no
    response; ``anomaly(frame)`` gives the per-row reconstruction MSE."""

    _BUILDER = DeepLearning

    def __init__(self, model_id: str | None = None, **kwargs):
        kwargs["autoencoder"] = True
        super().__init__(model_id=model_id, **kwargs)

    def anomaly(self, test_data):
        return self._m().anomaly(test_data)
