"""ModelSelection — the port of ``h2o3_tpu/models/model_selection.py``
(the successor of ``hex.modelselection.ModelSelection``): best-subset GLM
search in the modes ``allsubsets``, ``maxr``, ``maxrsweep``, ``forward``
and ``backward``.

For the gaussian family the search never refits: the ``DataInfo`` design
is built on the frame's device and ONE ``weighted_gram`` pass gives
XᵀWX and XᵀWy (its float32 chunk products added in float64, kept in
float64 here), with yᵀWy and Σwy in float64; every candidate subset is
then scored on the host in float64 by its sub-Gram solve
(:func:`subset_r2`, JAX's ``_subset_r2``). Selection is per predictor: a
categorical counts as its whole one-hot block. The binomial family fits
one port GLM per candidate, and ``backward`` drops the predictor of the
worst p-value of a GLM with ``compute_p_values`` at each step, as JAX
does.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.datainfo import MEAN_IMPUTATION, DataInfo
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.ops.gram import weighted_gram


@dataclass
class ModelSelectionParams(CommonParams):
    mode: str = "maxr"  # allsubsets | maxr | maxrsweep | forward | backward
    family: str = "AUTO"
    max_predictor_number: int = 1
    min_predictor_number: int = 1
    intercept: bool = True
    standardize: bool = True
    p_values_threshold: float = 0.0
    missing_values_handling: str = MEAN_IMPUTATION


class ModelSelectionModel(Model):
    algo = "modelselection"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """The largest selected subset's model: the binomial GLM's class
        probabilities, or the gaussian fit's float64 predictions on the
        frame's device."""
        if self.output["family"] == "binomial":
            return self.output["final_glm"]._predict_raw(frame)
        X, _ = self.output["datainfo"].transform(frame)
        beta = torch.as_tensor(self.output["beta_std_final"],
                               dtype=torch.float64, device=X.device)
        return X.double() @ beta

    def _distribution_for_metrics(self) -> str:
        return "gaussian"

    def get_best_r2_values(self) -> list[float]:
        return list(self.output["best_r2_values"])

    def get_best_model_predictors(self) -> list[list[str]]:
        return [list(s) for s in self.output["best_predictor_subsets"]]

    def coef(self, size: int | None = None) -> dict:
        per = self.output["coef_per_size"]
        if size is None:
            return dict(per[-1])
        sizes = [len(s) for s in self.output["best_predictor_subsets"]]
        try:
            return dict(per[sizes.index(size)])
        except ValueError:
            raise ValueError(
                f"no model of size {size}; available sizes: {sizes}"
            ) from None


def subset_r2(G, b, yty, sw, ysum, cols, icpt_idx):
    """R² of the gaussian submodel on the expanded columns ``cols`` (plus
    the intercept), its coefficients and their columns (float64)."""
    idx = list(cols)
    if icpt_idx is not None:
        idx = idx + [icpt_idx]
    Gs = G[np.ix_(idx, idx)]
    bs = b[idx]
    try:
        beta = np.linalg.solve(Gs + 1e-10 * np.eye(len(idx)), bs)
    except np.linalg.LinAlgError:
        beta = np.linalg.lstsq(Gs, bs, rcond=None)[0]
    rss = max(yty - beta @ bs, 0.0)
    tss = max(yty - (ysum * ysum) / max(sw, 1e-30), 1e-30)
    return 1.0 - rss / tss, beta, idx


def _glm(p, family: str, x, train: Frame, **extra):
    from h2o3_tpu_torch.models.glm import GLM

    return GLM(family=family, lambda_=0.0, standardize=p.standardize,
               intercept=p.intercept, weights_column=p.weights_column,
               **extra).train(y=p.response_column, x=list(x),
                              training_frame=train)


class ModelSelection(ModelBuilder):
    algo = "modelselection"
    PARAMS_CLS = ModelSelectionParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: ModelSelectionParams = self.params
        yv = train.vec(p.response_column)
        family = p.family.lower()
        if family == "auto":
            family = "binomial" if yv.is_categorical() else "gaussian"
        if family not in ("gaussian", "binomial"):
            raise ValueError("modelselection supports gaussian and binomial")

        di = DataInfo.fit(train, self._x, standardize=p.standardize,
                          use_all_factor_levels=False,
                          missing_handling=p.missing_values_handling,
                          add_intercept=p.intercept)
        # predictor -> expanded columns (a categorical owns its block)
        groups: dict[str, list[int]] = {}
        for c in di.columns:
            groups.setdefault(c.name, []).extend(
                range(c.offset, c.offset + c.width))
        pred_names = [n for n in self._x if n in groups]
        icpt_idx = di.ncols_expanded - 1 if p.intercept else None

        kmax = min(max(p.max_predictor_number, 1), len(pred_names))
        # backward walks DOWN from the full set; max_predictor_number (which
        # defaults to 1 for the growing modes) must not clamp its floor
        if p.mode.lower() == "backward":
            kmin = min(max(p.min_predictor_number, 1), len(pred_names))
        else:
            kmin = min(max(p.min_predictor_number, 1), kmax)

        gram_stats = None
        if family == "gaussian":
            X, w = di.transform(train)
            if p.weights_column:
                w = w * torch.nan_to_num(train.vec(p.weights_column).data)
            y = yv.data.to(torch.float32)
            w = w * (~torch.isnan(y))
            y = torch.nan_to_num(y, nan=0.0)
            G_d, b_d, _ = weighted_gram(X, w, y, keep_f64=True)
            w64, y64 = w.double(), y.double()
            tail = torch.stack([w64.sum(), (w64 * y64 * y64).sum(),
                                (w64 * y64).sum()])
            packed = torch.cat([G_d.reshape(-1), b_d, tail]).cpu().numpy()
            P = X.shape[1]
            del X
            G = packed[: P * P].reshape(P, P)
            b = packed[P * P: P * P + P]
            sw, yty, ysum = (float(v) for v in packed[-3:])
            gram_stats = {"design_cols": P, "host_reads": 1}

            def score(subset: tuple[str, ...]):
                cols = [c for n in subset for c in groups[n]]
                r2, beta, idx = subset_r2(G, b, yty, sw, ysum, cols,
                                          icpt_idx)
                return r2, (beta, idx)
        else:

            def score(subset: tuple[str, ...]):
                m = _glm(p, family, subset, train)
                r2 = 1.0 - m.output["residual_deviance"] / max(
                    m.output["null_deviance"], 1e-30)
                return r2, m

        mode = p.mode.lower()
        best_subsets: list[tuple[str, ...]] = []
        best_r2: list[float] = []
        best_fit: list = []
        steps: list[dict] = []
        candidates = 0

        def scored(subset):
            nonlocal candidates
            candidates += 1
            return score(subset)

        if mode in ("allsubsets", "maxr", "maxrsweep"):
            for k in range(1, kmax + 1):
                if mode == "allsubsets":
                    (r2, fit), sub = max(
                        ((scored(s), s) for s in
                         itertools.combinations(pred_names, k)),
                        key=lambda t: t[0][0])
                else:
                    # maxr: grow the best (k-1)-subset by the best addition,
                    # then sequential-replacement sweeps until no swap helps
                    base = list(best_subsets[-1]) if best_subsets else []
                    avail = [n for n in pred_names if n not in base]
                    (r2, fit), add = max(
                        ((scored(tuple(base + [a])), a) for a in avail),
                        key=lambda t: t[0][0])
                    sub = base + [add]
                    improved = True
                    while improved:
                        improved = False
                        for i in range(len(sub)):
                            for r in [n for n in pred_names if n not in sub]:
                                trial = sub[:i] + [r] + sub[i + 1:]
                                tr2, tfit = scored(tuple(trial))
                                if tr2 > r2 + 1e-12:
                                    r2, fit, sub = tr2, tfit, trial
                                    improved = True
                best_subsets.append(tuple(sub))
                best_r2.append(float(r2))
                best_fit.append(fit)
        elif mode == "forward":
            cur: list[str] = []
            for k in range(1, kmax + 1):
                avail = [n for n in pred_names if n not in cur]
                (r2, fit), add = max(
                    ((scored(tuple(cur + [a])), a) for a in avail),
                    key=lambda t: t[0][0])
                cur.append(add)
                best_subsets.append(tuple(cur))
                best_r2.append(float(r2))
                best_fit.append(fit)
        elif mode == "backward":
            cur = list(pred_names)
            while len(cur) > kmin:
                # drop the predictor with the worst (highest) p-value
                m = _glm(p, family, cur, train, compute_p_values=True)
                names = m.output["coef_names"]
                pv = np.asarray(m.output["p_values"])
                zv = np.abs(np.asarray(m.output["z_values"]))
                per_pred = {}
                for n in cur:
                    idxs = [i for i, cn in enumerate(names)
                            if cn == n or cn.startswith(n + ".")]
                    # highest p wins; |z| breaks ties once p underflows
                    per_pred[n] = (
                        min((pv[i] for i in idxs), default=1.0),
                        -max((zv[i] for i in idxs), default=0.0))
                worst = max(per_pred, key=per_pred.get)
                worst_p = per_pred[worst][0]
                thr = p.p_values_threshold
                if thr > 0 and worst_p <= thr:
                    break
                steps.append({"removed": worst, "p_value": float(worst_p),
                              "size": len(cur)})
                cur.remove(worst)
                r2, fit = scored(tuple(cur))
                best_subsets.append(tuple(cur))
                best_r2.append(float(r2))
                best_fit.append(fit)
            best_subsets.reverse()
            best_r2.reverse()
            best_fit.reverse()
        else:
            raise ValueError(f"unknown mode {p.mode!r}")

        # per-size coefficient dicts (original scale)
        coef_names = di.coef_names()
        coef_per_size: list[dict] = []
        beta_std_final = np.zeros(di.ncols_expanded, np.float64)
        final_glm = None
        for fit in best_fit:
            if family == "gaussian":
                beta_std, idx = fit
                beta_full = np.zeros(di.ncols_expanded, np.float64)
                beta_full[idx] = beta_std
                beta_std_final = beta_full
                beta_orig = beta_full.copy()
                if p.standardize:
                    shift = 0.0
                    for c in di.columns:
                        if c.kind == "num":
                            beta_orig[c.offset] = beta_full[c.offset] / c.sigma
                            shift += beta_full[c.offset] * c.mean / c.sigma
                    if p.intercept:
                        beta_orig[-1] = beta_full[-1] - shift
                coef_per_size.append(
                    {coef_names[i]: float(beta_orig[i])
                     for i in range(len(coef_names)) if beta_orig[i] != 0.0
                     or (p.intercept and i == len(coef_names) - 1)})
            else:
                coef_per_size.append(dict(fit.coef))
                final_glm = fit

        out = {
            "beta_std_final": beta_std_final,
            "final_glm": final_glm,
            "datainfo": di,
            "family": family,
            "best_predictor_subsets": best_subsets,
            "best_r2_values": best_r2,
            "coef_per_size": coef_per_size,
            "backward_steps": steps,
            "candidates_scored": candidates,
            "gram": gram_stats,
            "mode": mode,
            "names": list(self._x),
            "response_domain": tuple(yv.domain) if yv.is_categorical()
            else None,
        }
        model = ModelSelectionModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
