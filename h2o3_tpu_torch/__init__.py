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
"""

__version__ = "0.1.0"

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.parse import import_file, upload_file

__all__ = ["Frame", "import_file", "upload_file"]
