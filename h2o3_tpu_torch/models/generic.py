"""Generic model — the port of ``h2o3_tpu/models/generic.py`` (the
successor of ``hex.generic.GenericModel``): a tmojo zip re-imported as a
live model.

It scores through the port's own offline scorer (``genmodel.MojoModel``,
with the native C++ tree walk where ``genmodel`` would use it), and
``predict`` gives H2O's prediction layout: a binary model labels its rows
at the artifact's ``default_threshold`` (the trained model's max-F1
threshold), and a binary tree model's rows within 1e-6 of it are scored
again in the trained model's float32 arithmetic, so that they take the
trained model's labels (JAX's re-imported model flips them). The model is
registered under its key (``get_model``), and saves and loads as any
model does: with its artifact's contents, as JAX pickles its scorer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.genmodel import MojoModel
from h2o3_tpu_torch.models.metrics import ModelMetrics
from h2o3_tpu_torch.models.model_base import Model, make_key


TREE_ALGOS = ("gbm", "xgboost", "drf", "xrt")
# rows whose scored P(class 1) lies this close to the threshold are scored
# again in the trained model's float32 arithmetic (the two part by ~1e-7)
NEAR_THRESHOLD = 1e-6


@dataclass
class GenericModelParams:
    response_column: str | None = None
    weights_column: str | None = None
    offset_column: str | None = None


class GenericModel(Model):
    algo = "generic"

    def __init__(self, key: str | None, mojo: MojoModel):
        self._mojo = mojo
        out = {
            "names": mojo.meta.get("names", []),
            "response_domain": tuple(mojo.domain) if mojo.domain else None,
            "source_algo": mojo.algo,
        }
        params = GenericModelParams(
            response_column=mojo.meta.get("response_column"))
        super().__init__(key or make_key("generic"), params, out)
        thr = mojo.meta.get("default_threshold")
        if thr is not None:
            # the original max-F1 threshold, so that predict labels match
            self.output["default_threshold"] = float(thr)
            self.training_metrics = ModelMetrics(
                "generic", {"default_threshold": float(thr)})

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """The offline scorer's raw scores on the frame's rows (the enum
        codes decoded to labels, which the scorer maps through its own
        domains), on the frame's device; a binary tree model's rows near
        its threshold re-scored as the trained model scores them
        (:meth:`_trained_p1`)."""
        table = self._mojo._rows_to_table(frame.to_pandas())
        raw = np.array(self._mojo.score_raw(table), np.float64)
        thr = self.output.get("default_threshold")
        if (thr is not None and raw.ndim == 2 and raw.shape[1] == 2
                and self._mojo.algo in TREE_ALGOS):
            near = np.flatnonzero(np.abs(raw[:, 1] - thr) <= NEAR_THRESHOLD)
            if near.size:
                p1 = self._trained_p1({k: v[near] for k, v in table.items()},
                                      frame.device)
                raw[near, 1] = p1
                raw[near, 0] = 1.0 - p1
        return torch.from_numpy(raw).to(frame.device)

    def _trained_p1(self, table: dict, dev) -> np.ndarray:
        """P(class 1) of ``table``'s rows in the trained model's arithmetic:
        its float32 leaves added in float32, tree by tree in export order,
        then its link, on ``dev``. The max-F1 threshold is one of the
        training predictions, so rows sit exactly on it; the scorer's
        float64 sums part from the trained model's float32 ones in the last
        bit, which would flip such a row's label (JAX's re-imported model
        does: 0.27% of its test's rows)."""
        m = self._mojo
        bins = m._bin_features(table)
        F = torch.zeros(bins.shape[0], dtype=torch.float32, device=dev)
        for ti, levels in enumerate(m.meta["tree_levels"]):
            leaf = m._walk_tree(bins, ti, 0, levels[0]).astype(np.float32)
            F = F + torch.from_numpy(leaf).to(dev)
        if m.algo in ("drf", "xrt"):
            p1 = torch.clamp(F / max(m.meta["ntrees_actual"], 1), 0.0, 1.0)
        else:
            p1 = torch.sigmoid(F + float(m.meta["init_f"]))
        return p1.double().cpu().numpy()


def import_mojo_model(path: str, model_id: str | None = None) -> GenericModel:
    """``h2o.import_mojo``: the artifact at ``path`` as a live model."""
    return GenericModel(model_id, MojoModel.load(path))
