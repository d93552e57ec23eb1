"""ANOVA GLM — the port of ``h2o3_tpu/models/anovaglm.py`` (the successor
of ``hex.anovaglm.ANOVAGLM``): a type-III ANOVA decomposition of a GLM.

For predictors {A, B, ...} the terms are every combination up to
``highest_interaction_term``: main effects and interactions, categoricals
sum-to-zero coded and numerics standardized by their NaN mean and
deviation, an interaction the row-wise outer product of its members'
blocks, the intercept last (:func:`design`). The full model is fitted,
then each term is dropped and the model refitted.

The design is built in float64 on the frame's device from its codes, by
gathers and compares (JAX builds it on the host with a loop over rows).
- gaussian: the design cast to float32 and ONE ``weighted_gram`` pass, as
  in JAX; the full model and every reduced one are sub-Gram solves on the
  host in float64 (``solve_cholesky``), then the F table.
- binomial: JAX runs up to 25 IRLS iterations per fit in host float64
  numpy. The port runs the same iterations on the device, in float64
  because JAX's host arithmetic is float64: ``XᵀWX`` and ``XᵀWz`` as
  plain products over the full design (a dropped term's columns are left
  out of the solve, not copied out of the design), the same clip, the same
  1e-8 stop and ``ridge = lambda_ + 1e-10``. Each iteration reads its
  Gram to the host once for the ``solve_cholesky`` step. Then the
  chi-square table.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree.binning import _adapt_codes
from h2o3_tpu_torch.ops.gram import solve_cholesky, weighted_gram

IRLS_MAX = 25  # JAX's iterations per binomial fit
IRLS_TOL = 1e-8  # JAX's stop on the largest coefficient change


@dataclass
class ANOVAGLMParams(CommonParams):
    family: str = "AUTO"
    highest_interaction_term: int = 0  # 0 -> number of predictors
    lambda_: float = 0.0
    standardize: bool = True


def _effect_code(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Sum-to-zero coding, float64: k levels -> k-1 columns, the last level
    a row of -1, NA rows (code -1) all zero (JAX's ``_effect_code``)."""
    n = codes.shape[0]
    if k <= 1:
        return torch.zeros((n, 1), dtype=torch.float64, device=codes.device)
    codes = codes.long()
    levels = torch.arange(k - 1, device=codes.device)
    out = (codes[:, None] == levels[None, :]).to(torch.float64)
    return torch.where((codes == k - 1)[:, None], -1.0, out)


def design(frame: Frame, plan: dict) -> torch.Tensor:
    """The effect-coded design (float64, on the frame's device) of a fitted
    plan: the term blocks in order, the intercept last."""
    base: dict[str, torch.Tensor] = {}
    for name, info in plan["bases"].items():
        v = frame.vec(name)
        if info["kind"] == "cat":
            codes = _adapt_codes(v, info["domain"])
            base[name] = _effect_code(codes, len(info["domain"]))
        else:
            x = v.data.double()
            x = torch.where(torch.isnan(x), info["mean"], x)
            base[name] = ((x - info["mean"]) / info["sigma"])[:, None]
    n = frame.nrow
    cols = []
    for term in plan["terms"]:
        M = base[term[0]]
        for name in term[1:]:
            m2 = base[name]
            M = (M[:, :, None] * m2[:, None, :]).reshape(n, -1)
        cols.append(M)
    cols.append(torch.ones((n, 1), dtype=torch.float64, device=frame.device))
    return torch.cat(cols, dim=1)


class ANOVAGLMModel(Model):
    algo = "anovaglm"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        X = design(frame, self.output["term_plan"])
        beta = torch.as_tensor(self.output["beta_full"], dtype=torch.float64,
                               device=X.device)
        eta = X @ beta
        if self.output["family"] == "binomial":
            mu = 1.0 / (1.0 + torch.exp(-eta))
            return torch.stack([1 - mu, mu], dim=1)
        return eta

    def anova_table(self) -> list[dict]:
        return self.output["anova_table"]

    def _distribution_for_metrics(self) -> str:
        return "gaussian"


def _plan(train: Frame, preds: list[str], order: int,
          standardize: bool) -> dict:
    """The terms and each predictor's coding: a categorical's domain, a
    numeric's NaN mean and deviation (float64, on the device)."""
    terms: list[tuple[str, ...]] = []
    for r in range(1, order + 1):
        terms.extend(itertools.combinations(preds, r))
    bases: dict[str, dict] = {}
    nums = [n for n in preds if not train.vec(n).is_categorical()]
    stats = []
    for n in nums:
        x = train.vec(n).data.double()
        mean = torch.nanmean(x)
        stats += [mean, torch.sqrt(torch.nanmean((x - mean) ** 2))]
    stats = torch.stack(stats).cpu().tolist() if stats else []  # one read
    for n in preds:
        v = train.vec(n)
        if v.is_categorical():
            bases[n] = {"kind": "cat", "domain": list(v.domain or ())}
            continue
        i = 2 * nums.index(n)
        mean, sigma = stats[i], stats[i + 1] or 1.0
        if not standardize:
            mean, sigma = 0.0, 1.0
        bases[n] = {"kind": "num", "mean": mean, "sigma": sigma}
    return {"bases": bases, "terms": terms}


def _blocks(plan: dict) -> list[tuple[tuple[str, ...], list[int]]]:
    """Each term's columns in the design."""
    blocks = []
    off = 0
    for term in plan["terms"]:
        w_ = 1
        for n in term:
            info = plan["bases"][n]
            w_ *= (len(info["domain"]) - 1) if info["kind"] == "cat" else 1
            w_ = max(w_, 1)
        blocks.append((term, list(range(off, off + w_))))
        off += w_
    return blocks


class ANOVAGLM(ModelBuilder):
    algo = "anovaglm"
    PARAMS_CLS = ANOVAGLMParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        from scipy import stats as sps

        p: ANOVAGLMParams = self.params
        yv = train.vec(p.response_column)
        family = p.family.lower()
        if family == "auto":
            family = "binomial" if yv.is_categorical() else "gaussian"
        if family not in ("gaussian", "binomial"):
            raise ValueError("anovaglm supports gaussian and binomial")

        preds = list(self._x)
        order = min(p.highest_interaction_term or len(preds), len(preds))
        plan = _plan(train, preds, order, p.standardize)
        X = design(train, plan)  # (n, P) float64 on the device
        P = X.shape[1]
        blocks = _blocks(plan)

        y = yv.data.double()
        if yv.is_categorical():
            y = torch.where(y < 0, torch.nan, y)
        w = torch.ones_like(y)
        if p.weights_column:
            w = w * torch.nan_to_num(train.vec(p.weights_column).data.double())
        w = w * (~torch.isnan(y))
        y = torch.nan_to_num(y, nan=0.0)
        full_cols = list(range(P))
        reads = 1  # the plan's means and deviations

        if family == "gaussian":
            G_d, b_d, sw_d = weighted_gram(X.float(), w.float(), y.float())
            yty_d = torch.sum(w * y * y)
            packed = torch.cat([G_d.double().reshape(-1), b_d.double(),
                                torch.stack([sw_d.double(), yty_d])])
            packed = packed.cpu().numpy()
            reads += 1
            G = packed[: P * P].reshape(P, P)
            b = packed[P * P: P * P + P]
            sw, yty = float(packed[-2]), float(packed[-1])

            def rss_of(cols: list[int]) -> tuple[float, np.ndarray]:
                bs = b[cols]
                beta = solve_cholesky(G[np.ix_(cols, cols)], bs,
                                      ridge=p.lambda_)
                return max(yty - beta @ bs, 0.0), beta

            rss_full, beta_full = rss_of(full_cols)
            df_resid = max(sw - P, 1.0)
            mse = rss_full / df_resid
            table = []
            for term, cols in blocks:
                keep = [c for c in full_cols if c not in cols]
                rss_red, _ = rss_of(keep)
                ss = max(rss_red - rss_full, 0.0)
                df = len(cols)
                F = (ss / df) / max(mse, 1e-300)
                pv = float(sps.f.sf(F, df, df_resid))
                table.append({"term": ":".join(term), "df": df, "ss": ss,
                              "ms": ss / df, "f": F, "p_value": pv})
            table.append({"term": "Residual", "df": int(df_resid),
                          "ss": rss_full, "ms": mse, "f": float("nan"),
                          "p_value": float("nan")})
            iterations, deviances = [], []
        else:
            iterations = []

            def fit_cols(cols: list[int]):
                nonlocal reads
                sel = torch.as_tensor(cols, device=X.device)
                beta = np.zeros(len(cols), np.float64)
                bd = torch.zeros(P, dtype=torch.float64, device=X.device)
                it = 0
                for it in range(1, IRLS_MAX + 1):
                    eta = X @ bd
                    mu = torch.clamp(1.0 / (1.0 + torch.exp(-eta)),
                                     1e-10, 1 - 1e-10)
                    W = w * mu * (1 - mu)
                    z = eta + (y - mu) / (mu * (1 - mu))
                    XW = X * W[:, None]
                    Gb = torch.cat([XW.T @ X, (XW.T @ z)[:, None]], dim=1)
                    Gb = Gb.index_select(0, sel).cpu().numpy()
                    reads += 1
                    new = solve_cholesky(Gb[:, cols], Gb[:, -1],
                                         ridge=p.lambda_ + 1e-10)
                    done = np.max(np.abs(new - beta)) < IRLS_TOL
                    beta = new
                    bd = torch.zeros(P, dtype=torch.float64, device=X.device)
                    bd[sel] = torch.from_numpy(beta).to(X.device)
                    if done:
                        break
                iterations.append(it)
                eta = X @ bd
                mu = torch.clamp(1.0 / (1.0 + torch.exp(-eta)),
                                 1e-12, 1 - 1e-12)
                dev = -2.0 * torch.sum(w * (y * torch.log(mu)
                                            + (1 - y) * torch.log(1 - mu)))
                reads += 1
                return float(dev), beta

            dev_full, beta_full = fit_cols(full_cols)
            deviances = [dev_full]
            table = []
            for term, cols in blocks:
                keep = [c for c in full_cols if c not in cols]
                dev_red, _ = fit_cols(keep)
                deviances.append(dev_red)
                delta = max(dev_red - dev_full, 0.0)
                df = len(cols)
                pv = float(sps.chi2.sf(delta, df))
                table.append({"term": ":".join(term), "df": df, "ss": delta,
                              "ms": delta / df, "f": delta, "p_value": pv})

        out = {
            "term_plan": plan,
            "anova_table": table,
            "beta_full": np.asarray(beta_full, np.float64),
            "family": family,
            "names": preds,
            # binomial: the IRLS iterations and deviance of each fit, the
            # full model's first
            "irls_iterations": iterations,
            "deviances": deviances,
            "host_reads": reads,
            "response_domain": (tuple(yv.domain) if yv.is_categorical()
                                else None),
        }
        model = ANOVAGLMModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
