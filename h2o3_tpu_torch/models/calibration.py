"""Probability calibration for binary classifiers — the port of
``h2o3_tpu/models/calibration.py`` (``calibrate_model`` /
``calibration_frame`` / ``calibration_method`` on the tree models: Platt
scaling and isotonic regression).

The fit runs once on the calibration frame's predictions, on the host in
float64 as in JAX (the data is one column; the predictions are read back
once). Scoring applies the small calibrator to the predicted p1 on the
tensor's device (:func:`apply_calibration`), and ``predict`` appends the
``cal_p0``/``cal_p1`` columns, the upstream predict-frame layout.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from h2o3_tpu_torch.models.isotonic import _pav, interp, pav_block_knots

_LOG = logging.getLogger(__name__)


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p, 1e-12, 1 - 1e-12)
    return np.log(p / (1 - p))


def fit_platt(p1: np.ndarray, y: np.ndarray, w: np.ndarray) -> dict:
    """Platt scaling: logistic regression of y on logit(p1) (a, b).

    Robustified the way Platt (1999) prescribes: smoothed targets
    t+ = (N+ + 1)/(N+ + 2), t- = 1/(N- + 2) (prevents the separable-score
    blowup an overconfident model produces), standardized feature, a tiny
    ridge, and damped Newton steps.
    """
    f_raw = _logit(np.asarray(p1, np.float64))
    y = np.asarray(y, np.float64)
    n_pos = float(np.sum(w * (y > 0.5)))
    n_neg = float(np.sum(w * (y <= 0.5)))
    t = np.where(y > 0.5, (n_pos + 1.0) / (n_pos + 2.0), 1.0 / (n_neg + 2.0))
    mu_f = float(np.average(f_raw, weights=np.maximum(w, 1e-12)))
    sd_f = float(np.sqrt(np.average((f_raw - mu_f) ** 2,
                                    weights=np.maximum(w, 1e-12)))) or 1.0
    f = (f_raw - mu_f) / sd_f
    a, b = 1.0, 0.0
    ridge = 1e-6
    for _ in range(100):
        eta = np.clip(a * f + b, -30.0, 30.0)
        mu = np.clip(1.0 / (1.0 + np.exp(-eta)), 1e-10, 1 - 1e-10)
        W = w * mu * (1 - mu) + 1e-12
        z = eta + (t - mu) / (mu * (1 - mu) + 1e-12)
        s_ff = float(np.sum(W * f * f)) + ridge
        s_f = float(np.sum(W * f))
        s_1 = float(np.sum(W)) + ridge
        r_f = float(np.sum(W * f * z)) + ridge * a
        r_1 = float(np.sum(W * z)) + ridge * b
        det = s_ff * s_1 - s_f * s_f
        if abs(det) < 1e-30:
            break
        a_new = (r_f * s_1 - r_1 * s_f) / det
        b_new = (s_ff * r_1 - s_f * r_f) / det
        da, db = a_new - a, b_new - b
        step = min(1.0, 4.0 / max(abs(da), abs(db), 1e-12))  # damp big jumps
        a += step * da
        b += step * db
        if abs(da) + abs(db) < 1e-10:
            break
    # unstandardize: eta = a*(f_raw - mu_f)/sd_f + b
    return {"method": "PlattScaling",
            "a": float(a / sd_f), "b": float(b - a * mu_f / sd_f)}


def fit_isotonic(p1: np.ndarray, y: np.ndarray, w: np.ndarray) -> dict:
    """Isotonic calibration: PAV of y against p1, kept at the PAV block
    boundaries (the interior points of a constant run change no
    interpolation, and would make the model and its tmojo O(n))."""
    order = np.argsort(p1, kind="stable")
    ys = np.asarray(y, np.float64)[order]
    ws = np.asarray(w, np.float64)[order]
    fitted = _pav(ys, ws)
    xs = np.asarray(p1, np.float64)[order]
    keep = pav_block_knots(fitted)
    return {
        "method": "IsotonicRegression",
        "thresholds_x": xs[keep],
        "thresholds_y": fitted[keep],
    }


def apply_calibration(cal: dict, p1) -> torch.Tensor:
    """The calibrated P(class 1) of ``p1`` (a tensor, or anything numpy
    takes) in float64, on ``p1``'s device."""
    p1 = torch.as_tensor(p1).to(torch.float64)
    if cal["method"] == "PlattScaling":
        p = torch.clamp(p1, 1e-12, 1 - 1e-12)
        eta = torch.clamp(cal["a"] * torch.log(p / (1 - p)) + cal["b"],
                          -30.0, 30.0)
        return 1.0 / (1.0 + torch.exp(-eta))
    return torch.clamp(interp(p1, cal["thresholds_x"], cal["thresholds_y"]),
                       0.0, 1.0)


def _resolve_frame(fr):
    """A frame parameter as a Frame (or None). The port keeps no frame
    registry, so a key cannot be looked up: pass the Frame itself."""
    from h2o3_tpu_torch.frame.frame import Frame

    if fr is None or isinstance(fr, Frame):
        return fr
    raise ValueError(f"no frame under key {fr!r}: the port keeps no frame "
                     "registry; pass the Frame")


def validate_calibration_params(p, yv) -> None:
    """The early check (``ModelBuilder._validate``, before the build): a
    misconfiguration must not cost a training."""
    if not getattr(p, "calibrate_model", False):
        return
    if _resolve_frame(p.calibration_frame) is None:
        raise ValueError("calibrate_model requires calibration_frame")
    if not (yv.is_categorical() and yv.cardinality == 2):
        raise ValueError("calibrate_model supports binary classification only")


def maybe_fit_calibration(builder, model) -> None:
    """The tree builders' shared tail: with ``calibrate_model``, fit the
    calibrator on the calibration frame's predictions into
    ``model.output["calibration"]``."""
    p = builder.params
    if not getattr(p, "calibrate_model", False):
        return
    from h2o3_tpu_torch.models.model_base import _remap_response

    if not model.is_classifier or model.nclasses != 2:
        raise ValueError("calibrate_model supports binary classification only")
    frame = _resolve_frame(p.calibration_frame)
    if frame is None:
        raise ValueError("calibrate_model requires calibration_frame")
    frame = model._apply_preprocessors(frame)  # e.g. TE, like predict()
    raw = model._predict_raw(frame)
    p1 = raw[:, 1].cpu().numpy().astype(np.float64)
    yv = frame.vec(p.response_column)
    if yv.is_categorical():
        y = _remap_response(yv, model.output["response_domain"]).astype(
            np.float64)
    else:
        y = yv.to_numpy().astype(np.float64)  # numeric 0/1 column
    ok = ~np.isnan(y) & (y >= 0)
    w = np.ones(frame.nrow)
    if p.weights_column and p.weights_column in frame:
        w = np.nan_to_num(frame.vec(p.weights_column).to_numpy())
    method = (p.calibration_method or "AUTO").lower().replace("_", "")
    if method in ("auto", "plattscaling", "platt"):
        cal = fit_platt(p1[ok], y[ok], w[ok])
    elif method in ("isotonicregression", "isotonic"):
        cal = fit_isotonic(p1[ok], y[ok], w[ok])
    else:
        raise ValueError(f"unknown calibration_method {p.calibration_method!r}")
    model.output["calibration"] = cal
    _LOG.info("%s: fitted %s calibration on %d holdout rows", model.algo,
              cal["method"], int(ok.sum()))
