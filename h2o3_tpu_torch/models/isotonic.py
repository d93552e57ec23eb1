"""Isotonic regression — the port of ``h2o3_tpu/models/isotonic.py``.

Weighted pool-adjacent-violators on the single feature. The rows are
filtered, sorted and pooled by tied ``x`` on the frame's device; PAV itself
is sequential over the sorted distinct values and runs on the host in
float64, as in JAX. Prediction is linear interpolation between the fitted
thresholds (:func:`interp`, ``np.interp``'s answers on the frame's device)
with H2O's ``clip`` out-of-bounds policy, or NaN outside the thresholds
with ``out_of_bounds="na"``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder


@dataclass
class IsotonicRegressionParams(CommonParams):
    out_of_bounds: str = "clip"  # clip | na


def _pav(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted pool-adjacent-violators: isotonic fit of y (sorted by x)."""
    n = len(y)
    fitted = y.astype(np.float64).copy()
    weight = w.astype(np.float64).copy()
    # block-merge stack: (start, value, weight)
    starts = np.zeros(n, np.int64)
    vals = np.zeros(n, np.float64)
    wts = np.zeros(n, np.float64)
    top = -1
    for i in range(n):
        top += 1
        starts[top], vals[top], wts[top] = i, fitted[i], weight[i]
        while top > 0 and vals[top - 1] > vals[top]:
            wsum = wts[top - 1] + wts[top]
            vals[top - 1] = (vals[top - 1] * wts[top - 1]
                             + vals[top] * wts[top]) / wsum
            wts[top - 1] = wsum
            top -= 1
    out = np.empty(n, np.float64)
    for b in range(top + 1):
        end = starts[b + 1] if b < top else n
        out[starts[b]: end] = vals[b]
    return out


def pav_block_knots(fitted: np.ndarray) -> np.ndarray:
    """Mask keeping only PAV block-boundary knots (first/last of each
    constant run): interpolation over the kept knots is identical, and the
    stored threshold arrays stay O(blocks) instead of O(n)."""
    keep = np.ones(len(fitted), bool)
    if len(fitted) > 2:
        keep[1:-1] = ((fitted[1:-1] != fitted[:-2])
                      | (fitted[1:-1] != fitted[2:]))
    return keep


def interp(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """``np.interp(x, xp, fp)`` in float64 on ``x``'s device: ``fp[0]``
    left of ``xp[0]``, ``fp[-1]`` from ``xp[-1]`` on, ``fp[j]`` at a knot
    (the last of a run of repeated knots), the line between the knots
    around ``x`` elsewhere, and NaN at NaN but with a single knot (whose
    value numpy gives everywhere) — numpy's rule, index for index."""
    xp = np.asarray(xp, np.float64)
    fp = np.asarray(fp, np.float64)
    if len(xp) == 0:
        raise ValueError("array of sample points is empty")
    x = x.to(torch.float64).contiguous()
    xp_t = torch.as_tensor(xp, device=x.device)
    fp_t = torch.as_tensor(fp, device=x.device)
    n = len(xp)
    if n == 1:
        return torch.full_like(x, float(fp[0]))
    # the last knot at or left of x: numpy's binary search with ties
    j = torch.searchsorted(xp_t, x, right=True) - 1
    jc = j.clamp(0, n - 2)
    x0, x1, y0, y1 = xp_t[jc], xp_t[jc + 1], fp_t[jc], fp_t[jc + 1]
    slope = (y1 - y0) / (x1 - x0)
    out = slope * (x - x0) + y0
    out = torch.where(x == x0, y0, out)
    out = torch.where(j < 0, fp_t[0], out)
    out = torch.where(j >= n - 1, fp_t[n - 1], out)
    return torch.where(torch.isnan(x), x, out)


class IsotonicRegressionModel(Model):
    algo = "isotonicregression"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """(n,) float64 predictions on the frame's device."""
        x = frame.vec(self.output["feature"]).data.to(torch.float64)
        tx = self.output["thresholds_x"]
        out = interp(x, tx, self.output["thresholds_y"])
        if self.params.out_of_bounds == "na":
            out = torch.where((x < float(tx[0])) | (x > float(tx[-1])),
                              torch.nan, out)
        return out


class IsotonicRegression(ModelBuilder):
    algo = "isotonicregression"
    PARAMS_CLS = IsotonicRegressionParams

    def _validate(self, train: Frame, valid: Frame | None) -> None:
        super()._validate(train, valid)
        if train.vec(self.params.response_column).is_categorical():
            raise ValueError(f"{self.algo} does not support classification")

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p = self.params
        if len(self._x) != 1:
            raise AssertionError(
                "isotonic regression takes exactly one feature")
        feat = self._x[0]
        x = train.vec(feat).data.to(torch.float64)
        y = train.vec(p.response_column).data.to(torch.float64)
        w = torch.ones_like(y)
        if p.weights_column:
            w = torch.nan_to_num(
                train.vec(p.weights_column).data.to(torch.float64))
        ok = ~torch.isnan(x) & ~torch.isnan(y) & (w > 0)
        x, y, w = x[ok], y[ok], w[ok]
        order = torch.argsort(x, stable=True)
        x, y, w = x[order], y[order], w[order]
        # pool ties in x first (H2O's secondary aggregation)
        ux, inv = torch.unique_consecutive(x, return_inverse=True)
        wsum = torch.zeros_like(ux).index_add_(0, inv, w)
        ysum = torch.zeros_like(ux).index_add_(0, inv, w * y)
        ymean = ysum / torch.clamp(wsum, min=1e-300)
        host = torch.stack([ux, wsum, ymean]).cpu().numpy()
        fitted = _pav(host[2], host[1])
        # keep only breakpoints (H2O stores thresholds)
        keep = pav_block_knots(fitted)
        out = {
            "feature": feat,
            "thresholds_x": host[0][keep],
            "thresholds_y": fitted[keep],
            "names": [feat],
            "response_domain": None,
        }
        model = IsotonicRegressionModel(None, p, out)
        yy, ww = model._response_and_weights(train)
        model.training_metrics = MM.regression_metrics(
            yy, model._predict_raw(train), ww)
        return model
