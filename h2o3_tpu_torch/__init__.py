"""h2o3_tpu_torch — the PyTorch/CUDA port of ``h2o3_tpu`` for one NVIDIA
H100. Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path
is a CUDA C++ kernel written for Hopper (``csrc/``), built by ``nvcc`` on
first use and bound with ``ctypes``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise. The package imports neither JAX nor ``h2o3_tpu``.

    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    fr = h2o3_tpu_torch.upload_file(df)
    m = H2OGradientBoostingEstimator(ntrees=20, max_depth=6)
    m.train(y="label", training_frame=fr)
    m.auc(); m.predict(fr)

``H2ORandomForestEstimator`` and ``H2OXRTEstimator`` (same module) train
DRF and XRT; GBM takes ``sample_rate``, ``col_sample_rate`` and
``col_sample_rate_per_tree``.

``import_mojo(path)`` re-imports a tmojo artifact as a live model.
Models persist: ``save_model(model, dir)`` writes the binary model file
(named after the model key inside a directory), ``load_model(path,
device=None)`` gives it back on the card (or where ``device`` says),
registered under its key (``get_model``); ``checkpoint=<key, model or
file>`` continues a GBM, XGBoost, DRF, GLM (IRLSM) or DeepLearning
training, and ``export_checkpoints_dir`` snapshots each scoring interval
and the finished model (``persist.py``).

Trained tree models answer H2O's analysis calls: ``varimp()``,
``predict_contributions(fr)`` (TreeSHAP on the frame's device),
``predict_leaf_node_assignment(fr, type="Path" | "Node_ID")``,
``tree_view(i)`` and ``model_summary()``; GBM takes ``offset_column``;
GBM, XGBoost, DRF and XRT take ``calibrate_model=True`` with a
``calibration_frame`` (``predict`` then adds ``cal_p0``/``cal_p1``).
``TargetEncoder`` and ``IsotonicRegression`` (exported here) fit like the
builders, AutoML takes ``preprocessing=["target_encoding"]``, and
``h2o3_tpu_torch.explain`` holds partial dependence, ICE, the SHAP summary
and ``explain(model, fr)``.

Frames take H2O's munging operations (``frame/ops.py``):
``fr.vec("x") * 2``, ``fr.vec("c") == "level"``,
``fr.split_frame([0.8], seed=1)``, ``fr.rbind``,
``fr.group_by(["k"]).agg({"x": ["mean", "sd"]})``,
``merge(a, b, all_x=True)``, ``fr.sort(["k", "x"], ascending=[True,
False])``, ``quantile``, ``table``, ``cut``, ``impute`` and the rest of
the Rapids roster, on the frame's device.
"""

__version__ = "0.1.0"

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame import ops  # noqa: F401  (attaches the operators)
from h2o3_tpu_torch.frame.ops import (
    cor,
    cut,
    group_by,
    ifelse,
    impute,
    interaction,
    merge,
    quantile,
    table,
    unique,
)
from h2o3_tpu_torch.frame.parse import import_file, upload_file
from h2o3_tpu_torch.models.isotonic import IsotonicRegression
from h2o3_tpu_torch.models.model_base import get_model, remove_model as remove
from h2o3_tpu_torch.models.target_encoding import TargetEncoder


def export_file(frame, path: str, force: bool = False,
                format: str | None = None) -> str:
    """Frame to CSV or Parquet (``h2o.export_file``)."""
    from h2o3_tpu_torch.persist import export_file as _ef

    return _ef(frame, path, force=force, format=format)


def save_model(model, path: str, force: bool = True) -> str:
    """Binary model save (``h2o.save_model``); returns the path written."""
    from h2o3_tpu_torch.persist import save_model as _sm

    return _sm(getattr(model, "model", None) or model, path, force=force)


def load_model(path: str, device=None):
    """Binary model load (``h2o.load_model``) onto ``device`` (``cuda``
    unless given)."""
    from h2o3_tpu_torch.persist import load_model as _lm

    return _lm(path, device=device)


def import_mojo(path: str, model_id: str | None = None):
    """Re-import a tmojo artifact as a live model (``h2o.import_mojo``, the
    ``hex.generic`` successor), registered under ``model_id`` (a fresh key
    unless given). For offline scoring use ``genmodel.MojoModel``."""
    from h2o3_tpu_torch.models.generic import import_mojo_model

    return import_mojo_model(path, model_id)


__all__ = ["Frame", "IsotonicRegression", "TargetEncoder", "cor", "cut",
           "export_file", "get_model", "group_by", "ifelse", "impute",
           "import_file", "import_mojo", "interaction", "load_model",
           "merge", "quantile", "remove", "save_model", "table", "unique",
           "upload_file"]
