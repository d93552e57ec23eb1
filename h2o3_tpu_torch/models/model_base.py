"""Model/ModelBuilder — the subset of ``h2o3_tpu/models/model_base.py`` the
GBM, DRF, XGBoost and GLM slices need: parameter validation (with
parameter aliases), feature selection, ``train`` (JAX's ``_drive``: the
main model, then cross-validation), ``predict``, ``_score_metrics`` (JAX's,
on the frame's device), the scoring history, early stopping
(``ScoreKeeper``, ``stopping_metric_direction``), the soft
``max_runtime_secs`` deadline, the cross-validation driver
(``_cross_validate``), ``download_mojo`` and checkpoints: ``checkpoint=``
resolves a prior model (:func:`resolve_checkpoint`: a model, a key or a
model file) and :func:`check_checkpoint_compat` holds its frozen
parameters; with ``export_checkpoints_dir`` a builder writes an interval
snapshot at each scoring boundary (:meth:`ModelBuilder.
_export_interval_checkpoint`) and ``train`` saves the finished model there
(``persist.py``). A model's ``preprocessors`` (AutoML's target encoder)
transform every frame it predicts or scores, and a calibrated binomial
model's ``predict`` appends ``cal_p0``/``cal_p1`` (``calibration.py``,
whose set-up ``_validate`` checks before the build). In place of JAX's
``DKV`` registry, models are found by
key through :func:`get_model` (a weak map filled as models are made and
loaded: what grid search, stacked ensembles and ``checkpoint=`` look up;
:func:`remove_model` drops a key). Jobs and REST are not ported: the
builder itself carries the deadline and the recovery pointer a JAX
``Job`` would.
"""

from __future__ import annotations

import dataclasses
import time
import uuid
import weakref
from dataclasses import dataclass, field
from typing import Any, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from h2o3_tpu_torch.frame.frame import CAT, NUM, STR, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM

# every live model by key: the port's stand-in for JAX's DKV lookups
_MODELS: "weakref.WeakValueDictionary[str, Model]" = (
    weakref.WeakValueDictionary())


def make_key(prefix: str) -> str:
    """A fresh model key, unique across processes (JAX's
    ``DKV.make_key``): files named after keys in a checkpoint directory
    never collide with a later process's models."""
    return f"{prefix}_{uuid.uuid4().hex[:12]}"


def get_model(key: str) -> "Model | None":
    """The live model made or loaded under ``key``, or None (JAX's
    ``DKV.get`` of a model key)."""
    return _MODELS.get(str(key))


def register_model(model: "Model") -> None:
    """Make ``model`` findable by its key (a loaded model)."""
    _MODELS[model.key] = model


def remove_model(key: str) -> None:
    """Drop ``key`` from the registry (JAX's ``h2o3_tpu.remove``); the
    model object itself lives on while referenced."""
    _MODELS.pop(str(key), None)


@dataclass
class CommonParams:
    training_frame: Any = None
    validation_frame: Any = None
    response_column: str | None = None
    ignored_columns: Sequence[str] = field(default_factory=tuple)
    weights_column: str | None = None
    offset_column: str | None = None
    nfolds: int = 0
    fold_assignment: str = "modulo"  # modulo | random
    keep_cross_validation_predictions: bool = False
    seed: int = -1
    max_runtime_secs: float = 0.0
    stopping_rounds: int = 0
    stopping_metric: str = "AUTO"
    stopping_tolerance: float = 1e-3
    # a prior model (or its key, or a saved model or snapshot file) to
    # continue: more trees, more epochs, the rest of an IRLS path
    checkpoint: Any = None
    # every finished model saves here, and builders snapshot the partial
    # model at each scoring interval
    export_checkpoints_dir: str | None = None


def gather_rows(X: torch.Tensor, idx) -> np.ndarray:
    """Rows ``idx`` (host integers, a scalar or an array) of a device
    matrix, pulled as numpy of shape ``idx``'s shape + (columns,): only
    those rows cross to the host."""
    ix = torch.as_tensor(np.asarray(idx, np.int64), device=X.device)
    return X.index_select(0, ix.reshape(-1)).cpu().numpy().reshape(
        *np.shape(idx), X.shape[1])


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
        self.key = key or make_key(f"{self.algo}_model")
        self.params = params
        self.output = output
        self.training_metrics: MM.ModelMetrics | None = None
        self.validation_metrics: MM.ModelMetrics | None = None
        self.cross_validation_metrics: MM.ModelMetrics | None = None
        # the holdout predictions of the fold models, on the training
        # frame's device (with keep_cross_validation_predictions)
        self.cv_predictions: torch.Tensor | None = None
        self.cv_models: list["Model"] = []
        # one entry per scoring event: {ntrees, training_<metric>[,
        # validation_<metric>]}
        self.scoring_history: list[dict] = []
        self.run_time_ms: int = 0
        # fitted feature transformers (AutoML's target encoder) applied to
        # incoming frames before scoring; each transform is idempotent
        self.preprocessors: list = []
        _MODELS[self.key] = self

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

    def _apply_preprocessors(self, frame: Frame) -> Frame:
        for pre in getattr(self, "preprocessors", ()):
            frame = pre.transform(frame)
        return frame

    def predict(self, frame: Frame) -> Frame:
        """A Frame with ``predict`` (+ one probability column per class for
        classifiers, and ``cal_p0``/``cal_p1`` for a calibrated binomial
        model), on the frame's device — the H2O layout. The model's
        preprocessors transform ``frame`` first."""
        frame = self._apply_preprocessors(frame)
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
        names = ["predict"] + [str(d) for d in domain]
        cal = self.output.get("calibration")
        if cal is not None and raw.shape[1] == 2:
            from h2o3_tpu_torch.models.calibration import apply_calibration

            cp1 = apply_calibration(cal, raw[:, 1])
            vecs += [Vec((1.0 - cp1).to(torch.float32), NUM),
                     Vec(cp1.to(torch.float32), NUM)]
            names += ["cal_p0", "cal_p1"]
        return Frame(vecs, names)

    def download_mojo(self, path: str) -> str:
        """Write the tmojo artifact to ``path`` (``models/export.py``)."""
        from h2o3_tpu_torch.models.export import export_mojo

        return export_mojo(self, path)

    save_mojo = download_mojo

    def model_performance(self, test_data: Frame | None = None):
        if test_data is None:
            return self.training_metrics
        return self._score_metrics(test_data)

    def _response_and_weights(self, frame: Frame) -> tuple:
        """The response (class codes remapped to the model's domain) as
        float32 and the weights (or None), as tensors on the frame's
        device."""
        from h2o3_tpu_torch.models.tree.binning import _adapt_codes

        yv = frame.vec(self.params.response_column)
        y = yv.data
        if self.is_classifier and yv.is_categorical():
            y = _adapt_codes(yv, self.output["response_domain"])
        w = None
        if self.params.weights_column:
            w = frame.vec(self.params.weights_column).data
        return y.to(torch.float32), w

    def _score_metrics(self, frame: Frame) -> MM.ModelMetrics:
        """Metrics of the model's predictions on ``frame``, with the
        response and weights as tensors on the frame's device: on the card
        the metrics reduce there (``metrics.py``)."""
        frame = self._apply_preprocessors(frame)
        y, w = self._response_and_weights(frame)
        return _make_metrics(self, self._predict_raw(frame), y, w)

    def summary(self) -> dict:
        return {
            "algo": self.algo,
            "key": self.key,
            "classification": self.is_classifier,
            "nclasses": self.nclasses,
            "training_metrics": self.training_metrics.to_dict()
            if self.training_metrics else None,
            "validation_metrics": self.validation_metrics.to_dict()
            if self.validation_metrics else None,
            "run_time_ms": self.run_time_ms,
        }


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
        # the soft deadline (epoch seconds) of this build, and the one of
        # the build it runs inside (a fold model's parent), which stops it
        # too — JAX reads deadlines through the parent job chain
        self._deadline: float | None = None
        self._parent_deadline: float | None = None
        # this build's interval snapshot key (minted on the first export;
        # every interval overwrites the same file) and the pointer a resume
        # reads: {checkpoint_key, checkpoint_path, hint}
        self._ckpt_key: str | None = None
        self.recovery: dict | None = None

    def stop_requested(self) -> bool:
        """True once the build's soft deadline (``max_runtime_secs``, or
        the parent build's) has passed: iterative builders then end with
        the partial model they have."""
        return self._deadline is not None and time.time() > self._deadline

    def _features(self, frame: Frame, y: str | None) -> list[str]:
        drop = set(self.params.ignored_columns or ())
        for extra in (y, self.params.weights_column, self.params.offset_column,
                      getattr(self.params, "fold_column", None)):
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
        self._validate(train, valid)
        if x is not None:
            self._x = [train.names[c] if isinstance(c, int) else str(c) for c in x]
        else:
            self._x = self._features(train, p.response_column)
        t0 = time.perf_counter()
        deadlines = [d for d in (
            time.time() + float(p.max_runtime_secs)
            if p.max_runtime_secs else None, self._parent_deadline)
            if d is not None]
        self._deadline = min(deadlines) if deadlines else None
        cv = bool(p.nfolds and p.nfolds > 1)
        if p.checkpoint is not None and cv:
            raise ValueError(
                "checkpoint cannot be combined with cross-validation")
        model = self._build(train, valid)
        model.run_time_ms = int(1000 * (time.perf_counter() - t0))
        self.model = model
        if cv:  # after the main model, in modern H2O's order
            with record_function(f"{self.algo}.cv"):
                self._cross_validate(train)
        if p.export_checkpoints_dir:
            # H2O's contract: every finished model saves into the directory
            from h2o3_tpu_torch import persist

            backend, path = persist.model_path_in_dir(
                p.export_checkpoints_dir, model.key)
            persist.write_model_bytes(persist.serialize_model(model),
                                      backend, path, model.key)
        return model

    def _export_interval_checkpoint(self, make_model) -> str | None:
        """Snapshot the partial model into ``export_checkpoints_dir`` at a
        scoring-interval boundary; a no-op without the directory.
        ``make_model(key)`` builds a model of the current partial state; it
        is saved through ``persist`` and dropped from the registry again.
        A crash after this call loses at most one interval: ``load_model``
        the snapshot (or pass its path) as ``checkpoint=`` to continue as
        the uninterrupted run would. ``self.recovery`` points at it."""
        ckdir = self.params.export_checkpoints_dir
        if not ckdir:
            return None
        from h2o3_tpu_torch import persist

        if self._ckpt_key is None:
            self._ckpt_key = make_key(f"{self.algo}_ckpt")
        key = self._ckpt_key
        model = make_model(key)
        try:
            backend, path = persist.model_path_in_dir(ckdir, key)
            persist.write_model_bytes(persist.serialize_model(model),
                                      backend, path, key)
        finally:
            remove_model(key)  # snapshots never linger in the registry
        self.recovery = {
            "checkpoint_key": key,
            "checkpoint_path": path,
            "hint": "load_model(checkpoint_path), then rebuild with "
                    "checkpoint=checkpoint_key to resume",
        }
        return path

    def _validate(self, train: Frame, valid: Frame | None) -> None:
        """Checks before a build (a supervised builder: the response is in
        the frame; a calibration set-up that cannot work raises before the
        training, not after it)."""
        p = self.params
        if p.response_column not in train:
            raise ValueError(f"response {p.response_column!r} not in frame")
        if getattr(p, "calibrate_model", False):
            from h2o3_tpu_torch.models.calibration import (
                validate_calibration_params,
            )

            validate_calibration_params(p, train.vec(p.response_column))

    def _cross_validate(self, train: Frame) -> None:
        """JAX's CV driver: one fold model per fold, each trained on the
        whole frame with the fold's rows weighted 0 — the fold weight
        ``(~holdout) * user weights``, uploaded once per fold as an extra
        column, so every fold model has the training's shapes (on the card
        the captured graphs replay) — and predicting the whole frame; its
        fold's rows go into the holdout predictions on the frame's device.
        ``cross_validation_metrics`` are the main model's metrics of the
        holdout with the user's weights. Fold ids: :func:`fold_ids`."""
        p = self.params
        fold, folds = fold_ids(p, train)
        dev = train.device
        fold_dev = torch.from_numpy(fold).to(dev)
        user_w = None
        if p.weights_column:
            user_w = np.nan_to_num(
                train.vec(p.weights_column).to_numpy()).astype(np.float32)
        main = self.model
        holdout = None
        for f in folds:
            w_np = (fold != f).astype(np.float32)
            if user_w is not None:
                w_np = w_np * user_w
            sub = type(self)(**_fold_params(p))
            sub.params.response_column = p.response_column
            sub.params.weights_column = _CV_WEIGHTS
            sub._parent_deadline = self._deadline
            m = sub.train(x=self._x, y=p.response_column,
                          training_frame=_with_cv_weights(train, w_np, dev))
            raw = m._predict_raw(train)  # the whole frame: fold-invariant
            if holdout is None:
                holdout = torch.zeros_like(raw)
            te = (fold_dev == f).view(-1, *[1] * (raw.dim() - 1))
            holdout = torch.where(te, raw, holdout)
            main.cv_models.append(m)
        y, w = main._response_and_weights(train)
        main.cross_validation_metrics = _make_metrics(main, holdout, y, w)
        if p.keep_cross_validation_predictions:
            main.cv_predictions = holdout

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        raise NotImplementedError


def resolve_checkpoint(cp, device=None) -> "Model | None":
    """The ``checkpoint`` parameter as the prior model: a model as given, a
    key in the registry, or a readable model or snapshot file loaded
    through ``persist.load_model`` onto ``device`` (the training frame's;
    the crash-restart-resume runbook)."""
    if cp is None:
        return None
    cp = getattr(cp, "model", None) or cp  # an estimator: its model
    if isinstance(cp, Model):
        return cp
    got = get_model(str(cp))
    if got is not None:
        return got
    from h2o3_tpu_torch import persist

    try:
        backend, path = persist._backend_for(str(cp))
        found = backend.exists(path) and not backend.is_dir(path)
    except (ValueError, NotImplementedError):
        found = False
    if found:
        return persist.load_model(str(cp), device=device)
    raise ValueError(
        f"checkpoint {cp!r} is not a model in the DKV (nor a readable "
        "model/snapshot file)")


def check_checkpoint_compat(prior: "Model", builder: "ModelBuilder",
                            frozen: Sequence[str]) -> None:
    """H2O's checkpoint restrictions, with JAX's messages: the same algo,
    the same feature set, and the structural parameters unchanged (only
    the budget may grow)."""
    if prior.algo != builder.algo:
        raise ValueError(
            f"checkpoint algo {prior.algo!r} does not match builder "
            f"{builder.algo!r}")
    if list(prior.output.get("names", [])) != list(builder._x):
        raise ValueError("checkpoint was trained on a different feature set")
    for f in frozen:
        a, b = getattr(prior.params, f, None), getattr(builder.params, f, None)
        if a != b:
            raise ValueError(
                f"checkpoint requires {f} unchanged (was {a!r}, now {b!r})")


_CV_WEIGHTS = "__cv_weights__"


def fold_ids(p, train: Frame) -> tuple[np.ndarray, list]:
    """``(fold id per row, the folds)`` of a cross-validation — JAX's, bit
    for bit: ``fold_column``'s values as int64 (set on the builder's
    params; its sorted distinct values are the folds), else ``modulo``
    (row index mod ``nfolds``) or ``random`` (numpy's generator seeded by
    ``seed``, 12345 when unset)."""
    n, nfolds = train.nrow, int(p.nfolds)
    fold_col = getattr(p, "fold_column", None)
    if fold_col:
        fold = train.vec(fold_col).to_numpy().astype(np.int64)
        return fold, sorted(set(fold.tolist()))
    if p.fold_assignment == "random":
        seed = p.seed if p.seed and p.seed > 0 else 12345
        fold = np.random.default_rng(seed).integers(0, nfolds, size=n)
    else:  # modulo
        fold = np.arange(n) % nfolds
    return fold, list(range(nfolds))


def _with_cv_weights(train: Frame, w_np: np.ndarray, dev) -> Frame:
    """A frame sharing every column of ``train`` plus the fold-weight
    column: one upload, no other data movement."""
    wv = Vec.from_numpy(w_np, NUM, _CV_WEIGHTS, device=dev)
    names = [n for n in train.names if n != _CV_WEIGHTS]
    return Frame([train.vec(n) for n in names] + [wv], names + [_CV_WEIGHTS])


def _fold_params(p) -> dict:
    """A fold model's builder parameters as keyword arguments — JAX's
    ``_params_dict(p, drop_cv=True)``: the main model's, without the
    frames, folds, kept predictions, checkpoint, checkpoint exports or
    calibration."""
    d = {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}
    d.pop("training_frame")
    d.pop("validation_frame")
    d.update(nfolds=0, keep_cross_validation_predictions=False,
             checkpoint=None, export_checkpoints_dir=None)
    if "calibrate_model" in d:
        d["calibrate_model"] = False
    return d
