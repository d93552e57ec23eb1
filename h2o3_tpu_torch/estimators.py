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
``H2OUpliftRandomForestEstimator(treatment_column=...)`` trains UpliftDRF:
``m.predict(fr)`` gives ``uplift_predict``, and the training metrics carry
``auuc``, ``qini`` and ``ate``. ``H2ODecisionTreeEstimator`` trains one
tree (binary classification or regression) and
``H2ONaiveBayesEstimator`` naive Bayes; the unsupervised estimators train
with ``train(training_frame=fr)``: ``H2OKMeansEstimator`` (``m.centers``,
``m.predict(fr)`` the cluster ids, ``download_mojo``),
``H2OPrincipalComponentAnalysisEstimator`` and
``H2OSingularValueDecompositionEstimator`` (``predict`` the projections),
``H2OGeneralizedLowRankEstimator`` (``m.transform_frame(fr)``,
``m.reconstruct(fr)``), ``H2OIsolationForestEstimator`` and
``H2OExtendedIsolationForestEstimator`` (``predict`` the anomaly score and
the mean path length).
``H2OAggregatorEstimator`` reduces a frame to exemplars
(``m.aggregated_frame``, ``m.mapping``), ``H2OGeneralizedAdditiveEstimator``
fits a GAM on ``gam_columns``, ``H2OModelSelectionEstimator`` searches
best subsets (``m.get_best_r2_values()``,
``m.get_best_model_predictors()``), ``H2ORuleFitEstimator`` fits RuleFit
(``m.rule_importance()``), ``H2OCoxProportionalHazardsEstimator`` a Cox
model (``stop_column`` the time, the response the event indicator;
``m.concordance()``) and ``H2OAdaBoostEstimator`` boosts stumps.
``H2OANOVAGLMEstimator`` decomposes a GLM into its terms
(``m.anova_table()``), ``H2OHGLMEstimator(random_columns=[...])`` fits
random intercepts (``m.coef``, ``m.coefs_random(col)``),
``H2OInfogramEstimator`` draws the information diagram
(``m.get_admissible_features()``, ``m.get_admissible_score_frame()``),
``H2OSupportVectorMachineEstimator`` fits the RBF-kernel SVM, and
``H2OWord2vecEstimator`` trains embeddings on a string column with
``train(training_frame=fr)`` (``m.find_synonyms(word)``,
``m.transform(fr, aggregate_method="AVERAGE")``).

Every estimator proxies the trained model's analysis calls: the tree
models' ``predict_contributions`` and ``predict_leaf_node_assignment``,
``varimp(use_pandas=...)``, ``gains_lift`` and ``kolmogorov_smirnov``, and
the matplotlib ``varimp_plot`` and ``learning_curve_plot``
(``explain.py``). ``H2OIsotonicRegressionEstimator`` fits isotonic
regression on one feature; ``H2OTargetEncoderEstimator`` fits a
``TargetEncoder`` (``m.transform(fr, as_training=...)`` through the
proxy).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from h2o3_tpu_torch.models.adaboost import AdaBoost
from h2o3_tpu_torch.models.aggregator import Aggregator
from h2o3_tpu_torch.models.anovaglm import ANOVAGLM
from h2o3_tpu_torch.models.coxph import CoxPH
from h2o3_tpu_torch.models.deeplearning import DeepLearning
from h2o3_tpu_torch.models.ensemble import StackedEnsemble
from h2o3_tpu_torch.models.extended_isolation_forest import (
    ExtendedIsolationForest,
)
from h2o3_tpu_torch.models.gam import GAM
from h2o3_tpu_torch.models.glm import GLM
from h2o3_tpu_torch.models.glrm import GLRM
from h2o3_tpu_torch.models.hglm import HGLM
from h2o3_tpu_torch.models.infogram import Infogram
from h2o3_tpu_torch.models.isolation_forest import IsolationForest
from h2o3_tpu_torch.models.isotonic import IsotonicRegression
from h2o3_tpu_torch.models.kmeans import KMeans
from h2o3_tpu_torch.models.model_selection import ModelSelection
from h2o3_tpu_torch.models.naive_bayes import NaiveBayes
from h2o3_tpu_torch.models.pca import PCA, SVD
from h2o3_tpu_torch.models.psvm import PSVM
from h2o3_tpu_torch.models.rulefit import RuleFit
from h2o3_tpu_torch.models.target_encoding import TargetEncoder
from h2o3_tpu_torch.models.tree.decision_tree import DT
from h2o3_tpu_torch.models.tree.drf import DRF, XRT
from h2o3_tpu_torch.models.tree.gbm import GBM
from h2o3_tpu_torch.models.tree.xgboost import XGBoost
from h2o3_tpu_torch.models.uplift import UpliftDRF
from h2o3_tpu_torch.models.word2vec import Word2Vec


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

    def predict_contributions(self, test_data):
        """Per-feature SHAP contributions + BiasTerm (tree models)."""
        m = self._m()
        if not hasattr(m, "predict_contributions"):
            raise ValueError(
                f"{m.algo} does not support predict_contributions")
        return m.predict_contributions(test_data)

    def predict_leaf_node_assignment(self, test_data, type="Path"):
        """Terminal leaf per (row, tree, class): 'Path' strings or
        'Node_ID'."""
        m = self._m()
        if not hasattr(m, "predict_leaf_node_assignment"):
            raise ValueError(
                f"{m.algo} does not support predict_leaf_node_assignment")
        return m.predict_leaf_node_assignment(test_data, type=type)

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

    def _mm(self, valid=False, xval=False):
        m = self._m()
        return (m.cross_validation_metrics if xval
                else m.validation_metrics if valid else m.training_metrics)

    def gains_lift(self, valid=False, xval=False):
        mm = self._mm(valid, xval)
        return mm.gains_lift() if mm is not None else None

    def kolmogorov_smirnov(self, valid=False, xval=False):
        return self._metric("ks", valid, xval)

    def varimp_plot(self, num_of_features=10, save=None):
        from h2o3_tpu_torch import explain

        return explain.varimp_plot(self._m(), num_of_features, save)

    def learning_curve_plot(self, save=None):
        from h2o3_tpu_torch import explain

        return explain.learning_curve_plot(self._m(), save)

    def varimp(self, use_pandas: bool = False):
        vi = self._m().varimp() if hasattr(self._m(), "varimp") else None
        if use_pandas and vi is not None:
            import pandas as pd

            return pd.DataFrame(vi)
        return vi

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


class H2OIsotonicRegressionEstimator(_EstimatorBase):
    """h2o-py style estimator for the IsotonicRegression builder."""

    _BUILDER = IsotonicRegression


class H2OTargetEncoderEstimator(_EstimatorBase):
    """h2o-py style estimator for the TargetEncoder."""

    _BUILDER = TargetEncoder


class H2OUpliftRandomForestEstimator(_EstimatorBase):
    """h2o-py style estimator for the UpliftDRF builder."""

    _BUILDER = UpliftDRF


class H2OKMeansEstimator(_EstimatorBase):
    """h2o-py style estimator for the KMeans builder."""

    _BUILDER = KMeans


class H2OPrincipalComponentAnalysisEstimator(_EstimatorBase):
    """h2o-py style estimator for the PCA builder."""

    _BUILDER = PCA


class H2OSingularValueDecompositionEstimator(_EstimatorBase):
    """h2o-py style estimator for the SVD builder."""

    _BUILDER = SVD


class H2ONaiveBayesEstimator(_EstimatorBase):
    """h2o-py style estimator for the NaiveBayes builder."""

    _BUILDER = NaiveBayes


class H2OIsolationForestEstimator(_EstimatorBase):
    """h2o-py style estimator for the IsolationForest builder."""

    _BUILDER = IsolationForest


class H2OExtendedIsolationForestEstimator(_EstimatorBase):
    """h2o-py style estimator for the ExtendedIsolationForest builder."""

    _BUILDER = ExtendedIsolationForest


class H2OGeneralizedLowRankEstimator(_EstimatorBase):
    """h2o-py style estimator for the GLRM builder."""

    _BUILDER = GLRM


class H2ODecisionTreeEstimator(_EstimatorBase):
    """h2o-py style estimator for the DT builder."""

    _BUILDER = DT


class H2OAggregatorEstimator(_EstimatorBase):
    """h2o-py style estimator for the Aggregator builder."""

    _BUILDER = Aggregator


class H2OGeneralizedAdditiveEstimator(_EstimatorBase):
    """h2o-py style estimator for the GAM builder."""

    _BUILDER = GAM


class H2OModelSelectionEstimator(_EstimatorBase):
    """h2o-py style estimator for the ModelSelection builder."""

    _BUILDER = ModelSelection


class H2ORuleFitEstimator(_EstimatorBase):
    """h2o-py style estimator for the RuleFit builder."""

    _BUILDER = RuleFit


class H2OCoxProportionalHazardsEstimator(_EstimatorBase):
    """h2o-py style estimator for the CoxPH builder."""

    _BUILDER = CoxPH


class H2OAdaBoostEstimator(_EstimatorBase):
    """h2o-py style estimator for the AdaBoost builder."""

    _BUILDER = AdaBoost


class H2OANOVAGLMEstimator(_EstimatorBase):
    """h2o-py style estimator for the ANOVAGLM builder."""

    _BUILDER = ANOVAGLM


class H2OHGLMEstimator(_EstimatorBase):
    """h2o-py style estimator for the HGLM builder."""

    _BUILDER = HGLM


class H2OInfogramEstimator(_EstimatorBase):
    """h2o-py style estimator for the Infogram builder."""

    _BUILDER = Infogram


class H2OSupportVectorMachineEstimator(_EstimatorBase):
    """h2o-py style estimator for the PSVM builder."""

    _BUILDER = PSVM


class H2OWord2vecEstimator(_EstimatorBase):
    """h2o-py style estimator for the Word2Vec builder: ``train(
    training_frame=fr)`` on a frame whose first column holds the words."""

    _BUILDER = Word2Vec


class H2OAutoEncoderEstimator(_EstimatorBase):
    """DeepLearning with ``autoencoder=True`` forced: ``train()`` needs no
    response; ``anomaly(frame)`` gives the per-row reconstruction MSE."""

    _BUILDER = DeepLearning

    def __init__(self, model_id: str | None = None, **kwargs):
        kwargs["autoencoder"] = True
        super().__init__(model_id=model_id, **kwargs)

    def anomaly(self, test_data):
        return self._m().anomaly(test_data)
