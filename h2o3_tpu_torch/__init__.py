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

Models persist: ``save_model(model, dir)`` writes the binary model file
(named after the model key inside a directory), ``load_model(path,
device=None)`` gives it back on the card (or where ``device`` says),
registered under its key (``get_model``); ``checkpoint=<key, model or
file>`` continues a GBM, XGBoost, DRF, GLM (IRLSM) or DeepLearning
training, and ``export_checkpoints_dir`` snapshots each scoring interval
and the finished model (``persist.py``).
"""

__version__ = "0.1.0"

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.parse import import_file, upload_file
from h2o3_tpu_torch.models.model_base import get_model, remove_model as remove


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


__all__ = ["Frame", "export_file", "get_model", "import_file", "load_model",
           "remove", "save_model", "upload_file"]
