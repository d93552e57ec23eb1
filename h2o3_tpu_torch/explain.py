"""Model explainability — the port of ``h2o3_tpu/explain.py`` (h2o-py's
``h2o.explain``).

Data first: every function returns plain numpy and dict artifacts; the
plot functions render them with matplotlib, imported only when one is
called (the Agg backend unless pyplot is already set up), so a headless
process needs no display stack.

The surface: variable importance (and a cross-model heatmap), partial
dependence, ICE, the SHAP summary (tree models, through
``predict_contributions`` on the frame's device), model correlation,
residual analysis, learning curves, and the one-call :func:`explain`
that runs what applies. The models predict on the frame's device; the
frames that partial dependence and ICE rebuild with a column clamped to a
grid value go on that device too, and only the predictions come back.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import Model

# ---------------------------------------------------------------------------
# variable importance


def varimp(model: Model, normalize: bool = True) -> dict[str, float]:
    vi = model.output.get("varimp")
    names = model.output.get("names", [])
    if vi is None:
        # GLM-family: |standardized coefficient| as importance (h2o does this)
        coefs = model.output.get("beta_std_report")
        cn = model.output.get("coef_names", [])
        if coefs is None:
            return {}
        pairs = {
            n: abs(float(c)) for n, c in zip(cn, coefs) if n != "Intercept"
        }
    else:
        pairs = {n: float(v) for n, v in zip(names, np.asarray(vi))}
    if normalize and pairs:
        mx = max(pairs.values()) or 1.0
        pairs = {k: v / mx for k, v in pairs.items()}
    return dict(sorted(pairs.items(), key=lambda kv: -kv[1]))


def varimp_heatmap(models: Sequence[Model]) -> dict:
    """Per-model normalized importances aligned on the feature union."""
    per = [varimp(m) for m in models]
    feats = sorted({f for p in per for f in p})
    mat = np.array([[p.get(f, 0.0) for f in feats] for p in per])
    return {
        "features": feats,
        "models": [m.key for m in models],
        "matrix": mat,  # (n_models, n_features)
    }


# ---------------------------------------------------------------------------
# partial dependence + ICE


def _col_grid(frame: Frame, column: str, nbins: int) -> np.ndarray:
    v = frame.vec(column)
    if v.is_categorical():
        return np.arange(v.cardinality)
    x = v.to_numpy()
    lo, hi = np.nanpercentile(x, [1, 99])
    return np.linspace(lo, hi, nbins)


def _predict_pos(model: Model, frame: Frame) -> np.ndarray:
    """Scalar prediction per row: positive-class prob or regression value."""
    raw = model._predict_raw(model._apply_preprocessors(frame))
    raw = raw.cpu().numpy()
    if raw.ndim == 2:
        return raw[:, -1] if raw.shape[1] == 2 else raw.max(axis=1)
    return raw


def _rows(frame: Frame, idx: np.ndarray):
    """The rows ``idx`` of ``frame`` as pandas (gathered on the device
    first, so only the sample comes to the host)."""
    return frame.subset_rows(idx).to_pandas()


def _clamped(base, frame: Frame, column: str, value) -> Frame:
    """``base`` with ``column`` set to ``value``, as a frame of
    ``frame``'s kinds on ``frame``'s device."""
    mod = base.copy()
    mod[column] = value
    return Frame.from_pandas(mod, column_types=frame.types,
                             device=frame.device)


def partial_dependence(
    model: Model, frame: Frame, column: str, nbins: int = 20,
    sample_rows: int = 2000, seed: int = 7,
) -> dict:
    """PDP: mean prediction with ``column`` clamped to each grid value."""
    rng = np.random.default_rng(seed)
    n = frame.nrow
    idx = rng.permutation(n)[: min(n, sample_rows)]
    base = _rows(frame, np.sort(idx))
    grid = _col_grid(frame, column, nbins)
    v = frame.vec(column)
    dom = v.domain if v.is_categorical() else None
    means, stds = [], []
    for g in grid:
        p = _predict_pos(model, _clamped(
            base, frame, column, dom[int(g)] if dom else float(g)))
        means.append(float(np.mean(p)))
        stds.append(float(np.std(p)))
    values = [dom[int(g)] for g in grid] if dom else [float(g) for g in grid]
    return {"column": column, "values": values,
            "mean_response": means, "stddev_response": stds}


def ice(
    model: Model, frame: Frame, column: str, nbins: int = 20,
    sample_rows: int = 50, seed: int = 11,
) -> dict:
    """Individual conditional expectation curves for a row sample."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.permutation(frame.nrow)[: min(frame.nrow, sample_rows)])
    base = _rows(frame, idx)
    grid = _col_grid(frame, column, nbins)
    v = frame.vec(column)
    dom = v.domain if v.is_categorical() else None
    curves = np.zeros((len(base), len(grid)))
    for gi, g in enumerate(grid):
        curves[:, gi] = _predict_pos(model, _clamped(
            base, frame, column, dom[int(g)] if dom else float(g)))
    values = [dom[int(g)] for g in grid] if dom else [float(g) for g in grid]
    return {"column": column, "values": values, "rows": idx.tolist(),
            "curves": curves}


# ---------------------------------------------------------------------------
# SHAP summary


def shap_summary(model: Model, frame: Frame, top_n: int = 20) -> dict:
    """Mean |contribution| per feature + the raw contribution matrix."""
    if not hasattr(model, "predict_contributions"):
        raise ValueError(f"{model.algo} does not support predict_contributions")
    contrib = model.predict_contributions(frame)
    cols = [c for c in contrib.names if c != "BiasTerm"]
    mat = np.stack([contrib.vec(c).to_numpy() for c in cols], axis=1)
    mean_abs = np.abs(mat).mean(axis=0)
    order = np.argsort(-mean_abs)[:top_n]
    return {
        "features": [cols[i] for i in order],
        "mean_abs_contribution": mean_abs[order],
        "contributions": mat[:, order],
    }


# ---------------------------------------------------------------------------
# model correlation + residuals + learning curve


def model_correlation(models: Sequence[Model], frame: Frame) -> dict:
    preds = np.stack([_predict_pos(m, frame) for m in models], axis=1)
    return {"models": [m.key for m in models],
            "correlation": np.corrcoef(preds, rowvar=False)}


def residual_analysis(model: Model, frame: Frame) -> dict:
    y = frame.vec(model.params.response_column).to_numpy().astype(np.float64)
    fitted = _predict_pos(model, frame)
    resid = y - fitted
    return {"fitted": fitted, "residuals": resid,
            "rmse": float(np.sqrt(np.nanmean(resid**2)))}


def learning_curve(model: Model) -> dict:
    hist = getattr(model, "scoring_history", None) or []
    if not hist:
        return {"steps": [], "series": {}}
    keys = [k for k in hist[0] if k not in ("ntrees", "iteration", "epoch")]
    step_key = next(
        (k for k in ("ntrees", "iteration", "epoch") if k in hist[0]), None
    )
    steps = [h.get(step_key, i) for i, h in enumerate(hist)]
    return {
        "steps": steps,
        "series": {k: [h.get(k) for h in hist] for k in keys},
    }


# ---------------------------------------------------------------------------
# matplotlib renderings of the artifacts above — the h2o-py plot surface
# (model.varimp_plot() etc.). Every function returns the Figure and
# optionally saves it.


def _fig():
    import sys

    import matplotlib

    # headless default, but never take over an interactive session's
    # backend: Agg only if pyplot is not imported yet
    if "matplotlib.pyplot" not in sys.modules:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, save: str | None):
    fig.tight_layout()
    if save:
        fig.savefig(save, dpi=120)
        # a saved figure is an artifact, not an open window: close it so a
        # long-lived process does not collect pyplot registry entries
        import matplotlib.pyplot as plt

        plt.close(fig)
    return fig


def varimp_plot(model: Model, num_of_features: int = 10,
                save: str | None = None):
    """Horizontal scaled-importance bars (upstream varimp_plot)."""
    plt = _fig()
    vi = varimp(model)
    items = sorted(vi.items(), key=lambda kv: kv[1])[-num_of_features:]
    fig, ax = plt.subplots(figsize=(7, 0.4 * len(items) + 1.2))
    ax.barh([k for k, _ in items], [v for _, v in items])
    ax.set_xlabel("scaled importance")
    ax.set_title(f"Variable importance: {model.key}")
    return _finish(fig, save)


def pd_plot(model: Model, frame: Frame, column: str, nbins: int = 20,
            save: str | None = None):
    """Partial-dependence curve with the ±1 SD band (upstream pd_plot)."""
    plt = _fig()
    t = partial_dependence(model, frame, column, nbins=nbins)
    fig, ax = plt.subplots(figsize=(7, 4))
    m = np.asarray(t["mean_response"])
    s = np.asarray(t["stddev_response"])
    if all(isinstance(v, (int, float)) for v in t["values"]):
        xs = t["values"]
        ax.fill_between(xs, m - s, m + s, alpha=0.2)
        ax.plot(xs, m, marker="o")
    else:  # categorical grid: bar chart
        ax.bar([str(v) for v in t["values"]], m, yerr=s, capsize=3)
        ax.tick_params(axis="x", rotation=45)
    ax.set_xlabel(column)
    ax.set_ylabel("mean response")
    ax.set_title(f"Partial dependence of {column}")
    return _finish(fig, save)


def roc_plot(model: Model, save: str | None = None, valid: bool = False):
    """ROC curve from the stored threshold table (binomial models)."""
    plt = _fig()
    mm = model.validation_metrics if valid else model.training_metrics
    if mm is None:
        raise ValueError(
            "no validation metrics on this model — train with a "
            "validation_frame or call roc_plot(valid=False)")
    auc = mm.value("auc")
    # the curve from the gains-style cumulatives when present; else only
    # the diagonal
    fig, ax = plt.subplots(figsize=(5.5, 5))
    gl = mm.gains_lift() or []
    if gl:
        pf = _pos_frac(mm)
        xs = [0.0]
        ys = [0.0]
        for r in gl:
            ys.append(r["cumulative_capture_rate"])
            # FPR from the data fraction and the capture: df*N = TP+FP,
            # approximated with the cumulative negatives fraction
            xs.append(
                (r["cumulative_data_fraction"]
                 - r["cumulative_capture_rate"] * pf) / max(1 - pf, 1e-9)
            )
        ax.plot(xs, ys, marker=".")
    ax.plot([0, 1], [0, 1], linestyle="--", linewidth=1)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title(f"ROC (AUC={auc:.4f})")
    return _finish(fig, save)


def _pos_frac(mm) -> float:
    cm = mm._v.get("confusion_matrix")
    if not cm:
        return 0.5
    tn, fp = cm[0]
    fn, tp = cm[1]
    tot = tn + fp + fn + tp
    return (tp + fn) / tot if tot else 0.5


def learning_curve_plot(model: Model, save: str | None = None):
    """Training-history curves (upstream learning_curve_plot)."""
    plt = _fig()
    lc = learning_curve(model)
    fig, ax = plt.subplots(figsize=(7, 4))
    for name, ys in lc["series"].items():
        vals = [v for v in ys if isinstance(v, (int, float))]
        if len(vals) == len(ys) and vals:
            ax.plot(lc["steps"], ys, label=name)
    ax.set_xlabel("step")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(f"Learning curve: {model.key}")
    return _finish(fig, save)


def shap_summary_plot(model: Model, frame: Frame, top_n: int = 15,
                      save: str | None = None):
    """Mean-|SHAP| bars (the beeswarm's bar-summary form)."""
    plt = _fig()
    t = shap_summary(model, frame, top_n=top_n)
    fig, ax = plt.subplots(figsize=(7, 0.4 * len(t["features"]) + 1.2))
    ax.barh(t["features"][::-1], list(t["mean_abs_contribution"])[::-1])
    ax.set_xlabel("mean |SHAP contribution|")
    ax.set_title("SHAP summary")
    return _finish(fig, save)


# ---------------------------------------------------------------------------
# the one-call driver


def explain(models, frame: Frame, columns: Sequence[str] | None = None) -> dict:
    """``h2o.explain``: run every applicable artifact.

    ``models`` may be one Model, a list, or an AutoML object (its
    leaderboard's models, as upstream).
    """
    if hasattr(models, "leaderboard"):  # AutoML duck-type
        models = [m for m in getattr(models, "models", [])] or [models.leader]
    if isinstance(models, Model):
        models = [models]
    models = list(models)
    out: dict = {}
    m0 = models[0]
    out["varimp"] = {m.key: varimp(m) for m in models if varimp(m)}
    if len(models) > 1:
        out["varimp_heatmap"] = varimp_heatmap(
            [m for m in models if varimp(m)]
        )
        out["model_correlation"] = model_correlation(models, frame)
    feats = columns
    if feats is None:
        vi = varimp(m0)
        feats = list(vi)[:2] if vi else list(m0.output.get("names", []))[:2]
    out["pdp"] = {c: partial_dependence(m0, frame, c) for c in feats}
    if hasattr(m0, "predict_contributions"):
        try:
            out["shap_summary"] = shap_summary(m0, frame)
        except ValueError:  # optional: a multinomial model has none
            pass
    if m0.params.response_column and not m0.is_classifier:
        out["residual_analysis"] = residual_analysis(m0, frame)
    lc = learning_curve(m0)
    if lc["steps"]:
        out["learning_curve"] = lc
    return out
