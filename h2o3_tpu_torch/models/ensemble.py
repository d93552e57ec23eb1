"""Stacked ensembles — the port of ``h2o3_tpu/models/ensemble.py``.

A stacked ensemble trains a metalearner (by default a GLM with
non-negative coefficients) on the cross-validation holdout predictions of
its base models, which must have been cross-validated on the same frame
with the same fold plan and ``keep_cross_validation_predictions=True``.
Scoring runs every base model, joins their prediction columns into the
level-one frame and scores the metalearner on it.

The level-one matrix is a ``torch.cat`` of the base models' tensors on the
training frame's device (their kept ``cv_predictions`` for training, their
``_predict_raw`` for scoring): on the card nothing goes through the host.
The metalearner is cross-validated itself (``metalearner_nfolds``, 5 by
default as in JAX, where H2O has 0), and its holdout predictions give the
ensemble's cross-validation metrics, which rank it on a leaderboard.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

from h2o3_tpu_torch.frame.frame import CAT, NUM, Frame, Vec
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    _make_metrics,
    get_model,
)


@dataclass
class StackedEnsembleParams(CommonParams):
    base_models: Sequence[Any] = field(default_factory=tuple)  # Model | key
    metalearner_algorithm: str = "AUTO"  # AUTO->glm | glm | gbm | drf | deeplearning
    metalearner_params: dict = field(default_factory=dict)
    # JAX cross-validates the metalearner by default (H2O: 0): its holdout
    # predictions are the ensemble's honest estimate on a leaderboard
    metalearner_nfolds: int = 5


def _shape_prediction_columns(raw: torch.Tensor,
                              is_classifier: bool) -> torch.Tensor:
    """One base model's level-one columns, float32: P(class 1) of a
    binomial model, the K probabilities of a multinomial one, the
    prediction of a regression."""
    raw = raw.to(torch.float32)
    if raw.dim() == 1:
        return raw[:, None]
    if raw.shape[1] == 2 and is_classifier:
        return raw[:, 1:2]
    return raw


def _level_one_matrix(models: list[Model], frame: Frame) -> torch.Tensor:
    return torch.cat([_shape_prediction_columns(m._predict_raw(frame),
                                                m.is_classifier)
                      for m in models], dim=1)


def _level_one_cv_matrix(models: list[Model]) -> torch.Tensor:
    cols = []
    for m in models:
        if m.cv_predictions is None:
            raise ValueError(
                f"base model {m.key} lacks CV holdout predictions; train "
                "with nfolds>1 and keep_cross_validation_predictions=True")
        cols.append(_shape_prediction_columns(m.cv_predictions,
                                              m.is_classifier))
    return torch.cat(cols, dim=1)


def _matrix_frame(L: torch.Tensor, y: torch.Tensor | None = None,
                  domain=None, weights: torch.Tensor | None = None) -> Frame:
    """The level-one frame on ``L``'s device: float32 columns ``bm_j``,
    the response ``y`` (categorical over ``domain`` when given) and the
    weights ``__se_weights``."""
    vecs = [Vec(L[:, j].contiguous(), NUM) for j in range(L.shape[1])]
    names = [f"bm_{j}" for j in range(L.shape[1])]
    if y is not None:
        if domain is not None:
            dt, _ = Vec.device_dtype(CAT, domain)
            vecs.append(Vec(y.to(getattr(torch, dt.name)), CAT,
                            domain=domain))
        else:
            vecs.append(Vec(y.to(torch.float32), NUM))
        names.append("y")
    if weights is not None:
        vecs.append(Vec(weights.to(torch.float32), NUM))
        names.append("__se_weights")
    return Frame(vecs, names)


class StackedEnsembleModel(Model):
    algo = "stackedensemble"

    def __init__(self, key, params, output, base_models, metalearner):
        super().__init__(key, params, output)
        self.base_models = base_models
        self.metalearner = metalearner

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        L = _level_one_matrix(self.base_models, frame)
        return self.metalearner._predict_raw(_matrix_frame(L))


class StackedEnsemble(ModelBuilder):
    algo = "stackedensemble"
    PARAMS_CLS = StackedEnsembleParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: StackedEnsembleParams = self.params
        models = self._resolved_base  # resolved and checked in _validate
        ref = models[0]
        if p.response_column is None:
            p.response_column = ref.params.response_column
        classification = ref.is_classifier
        domain = ref.output.get("response_domain")

        L = _level_one_cv_matrix(models)
        y, w = ref._response_and_weights(train)
        self._meta_weights = w is not None
        lframe = _matrix_frame(L, y, domain if classification else None,
                               weights=w)
        meta = self._make_metalearner(classification,
                                      len(domain) if domain else 1)
        meta_model = meta.train(y="y", training_frame=lframe)

        model = StackedEnsembleModel(
            None, p,
            {"response_domain": tuple(domain) if domain else None,
             "base_model_keys": [m.key for m in models],
             "metalearner_key": meta_model.key},
            models, meta_model)
        model.training_metrics = _make_metrics(
            model, model._predict_raw(train), y, w)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        # the metalearner's own holdout predictions on the level-one frame:
        # its training view would be resubstitution error and over-rank the
        # ensemble on a leaderboard
        if meta_model.cv_predictions is not None:
            model.cross_validation_metrics = _make_metrics(
                model, meta_model.cv_predictions, y, w)
        return model

    def _make_metalearner(self, classification: bool,
                          nclasses: int) -> ModelBuilder:
        p: StackedEnsembleParams = self.params
        algo = p.metalearner_algorithm.lower()
        extra = dict(p.metalearner_params)
        extra.setdefault("seed", p.seed)
        if p.metalearner_nfolds:
            extra["nfolds"] = p.metalearner_nfolds
            extra["keep_cross_validation_predictions"] = True
        if self._meta_weights:
            extra["weights_column"] = "__se_weights"
        if algo in ("auto", "glm"):
            from h2o3_tpu_torch.models.glm import GLM

            family = ("binomial" if classification and nclasses == 2
                      else "multinomial" if classification else "gaussian")
            # H2O's AUTO metalearner: a non-negative GLM
            extra.setdefault("non_negative", algo == "auto")
            extra.setdefault("family", family)
            return GLM(**extra)
        if algo == "gbm":
            from h2o3_tpu_torch.models.tree.gbm import GBM

            return GBM(**extra)
        if algo == "drf":
            from h2o3_tpu_torch.models.tree.drf import DRF

            return DRF(**extra)
        if algo == "deeplearning":
            from h2o3_tpu_torch.models.deeplearning import DeepLearning

            return DeepLearning(**extra)
        raise ValueError(
            f"unknown metalearner_algorithm {p.metalearner_algorithm!r}")

    def _validate(self, train: Frame, valid: Frame | None) -> None:
        """The alignment the stacking depends on: every base model was
        cross-validated on this training frame (the same rows, response and
        fold plan), so its holdout predictions line up row for row."""
        p: StackedEnsembleParams = self.params
        models = [bm if isinstance(bm, Model) else get_model(str(bm))
                  for bm in p.base_models]
        if not models or not all(isinstance(m, Model) for m in models):
            raise ValueError(
                "stackedensemble requires base_models trained in this session")
        self._resolved_base = models
        ref = models[0]
        if p.response_column and p.response_column != ref.params.response_column:
            raise ValueError(
                f"response_column {p.response_column!r} differs from base "
                f"models' {ref.params.response_column!r}")
        ref_fold = (ref.params.nfolds, ref.params.fold_assignment,
                    getattr(ref.params, "fold_column", None))
        for m in models:
            cv = m.cv_predictions
            if cv is None:
                raise ValueError(
                    f"base model {m.key}: train with nfolds>1 and "
                    "keep_cross_validation_predictions=True")
            if len(cv) != train.nrow:
                raise ValueError(
                    f"base model {m.key}: CV predictions cover {len(cv)} rows "
                    f"but training_frame has {train.nrow} — base models "
                    "must be cross-validated on the same frame")
            if m.params.response_column != ref.params.response_column:
                raise ValueError("base models disagree on response_column")
            fold = (m.params.nfolds, m.params.fold_assignment,
                    getattr(m.params, "fold_column", None))
            if fold != ref_fold:
                raise ValueError(
                    f"base model {m.key}: fold plan {fold} differs from "
                    f"{ref_fold}; all base models need identical "
                    "nfolds/fold_assignment/fold_column")
            if (m.params.fold_assignment == "random"
                    and m.params.seed != ref.params.seed):
                raise ValueError(
                    "random fold_assignment requires identical seeds "
                    "across base models")
