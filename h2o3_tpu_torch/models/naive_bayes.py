"""Naive Bayes — the port of ``h2o3_tpu/models/naive_bayes.py`` (the
successor of ``hex.naivebayes.NaiveBayes``).

The sufficient statistics are one pass on the frame's device: the class
priors, every numeric column's per-class count, sum and sum of squares
(one product of the stacked columns with the class indicators, in float64)
and every categorical column's per-class level counts; the host reads them
in one transfer. The statistics are float64 with JAX's rules: the variance
times ``W/(W-1)``, the ``min_sdev`` floor plus ``eps_sdev``, Laplace
smoothing of the level counts. Prediction runs on the frame's device in
float64: the Gaussian log-likelihood of each numeric value and the log of
each level's conditional probability (an NA adds nothing), normalised per
row.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder
from h2o3_tpu_torch.models.tree.binning import _adapt_codes


@dataclass
class NaiveBayesParams(CommonParams):
    laplace: float = 0.0
    min_sdev: float = 0.001
    eps_sdev: float = 0.0


class NaiveBayesModel(Model):
    algo = "naivebayes"

    def _predict_raw(self, frame: Frame) -> torch.Tensor:
        """(n, K) class probabilities on the frame's device."""
        out = self.output
        dev = frame.device
        f64 = torch.float64
        logp = torch.log(torch.as_tensor(out["priors"], dtype=f64,
                                         device=dev))[None, :].repeat(
            frame.nrow, 1)
        num = out["num_stats"]
        if num:
            x = torch.stack([frame.vec(c).data for c in num], 1).to(f64)
            mu = torch.as_tensor(np.stack([s["mean"] for s in num.values()]),
                                 device=dev)[None]  # (1, Cn, K)
            sd = torch.as_tensor(np.stack([s["sdev"] for s in num.values()]),
                                 device=dev)[None]
            ll = (-0.5 * ((x[:, :, None] - mu) / sd) ** 2
                  - torch.log(sd * np.sqrt(2 * np.pi)))
            logp = logp + torch.where(torch.isnan(x)[:, :, None], 0.0,
                                      ll).sum(1)
        for name, tab in out["cat_stats"].items():
            codes = _adapt_codes(frame.vec(name), tab["domain"]).long()
            probs = torch.as_tensor(tab["cond"], dtype=f64, device=dev)
            ll = torch.log(torch.clamp(probs[codes.clamp(min=0)], min=1e-30))
            logp = logp + torch.where((codes >= 0)[:, None], ll, 0.0)
        logp = logp - logp.max(dim=1, keepdim=True).values
        P = torch.exp(logp)
        return (P / P.sum(dim=1, keepdim=True)).to(torch.float32)


class NaiveBayes(ModelBuilder):
    algo = "naivebayes"
    PARAMS_CLS = NaiveBayesParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: NaiveBayesParams = self.params
        yv = train.vec(p.response_column)
        if not yv.is_categorical():
            raise ValueError("naivebayes requires an enum response")
        K = yv.cardinality
        dev = train.device
        f64 = torch.float64
        y = yv.data.long()
        Y1h = (y[:, None] == torch.arange(K, device=dev)[None, :]).to(f64)
        num_cols = [c for c in self._x if not train.vec(c).is_categorical()]
        cat_cols = [c for c in self._x if train.vec(c).is_categorical()]
        parts = [Y1h.sum(0)]  # the class weights
        if num_cols:
            x = torch.stack([train.vec(c).data for c in num_cols], 1).to(f64)
            ok = ~torch.isnan(x)
            x = torch.where(ok, x, 0.0)
            lanes = torch.cat([ok.to(f64), x, x * x], 1)  # (n, 3 Cn)
            parts.append((lanes.T @ Y1h).reshape(-1))
        for c in cat_cols:
            v = train.vec(c)
            codes = v.data.long()
            counts = torch.zeros((v.cardinality + 1, K), dtype=f64,
                                 device=dev)
            # NA codes land in the extra last row, dropped below
            counts.index_add_(0, torch.where(codes >= 0, codes,
                                             v.cardinality), Y1h)
            parts.append(counts[:-1].reshape(-1))
        host = torch.cat(parts).cpu().numpy()  # the one read

        class_w = host[:K]
        priors = class_w / class_w.sum()
        off = K
        num_stats, cat_stats = {}, {}
        if num_cols:
            Cn = len(num_cols)
            lanes = host[off: off + 3 * Cn * K].reshape(3, Cn, K)
            off += 3 * Cn * K
            for i, c in enumerate(num_cols):
                Wk, Sk, S2k = lanes[:, i]
                mu = Sk / np.maximum(Wk, 1e-30)
                var = S2k / np.maximum(Wk, 1e-30) - mu**2
                sd = np.sqrt(np.maximum(var * Wk / np.maximum(Wk - 1, 1.0),
                                        0.0))
                num_stats[c] = {"mean": mu,
                                "sdev": np.maximum(sd, p.min_sdev) + p.eps_sdev}
        for c in cat_cols:
            v = train.vec(c)
            L = v.cardinality
            counts = host[off: off + L * K].reshape(L, K)
            off += L * K
            cond = (counts + p.laplace) / (class_w[None, :] + p.laplace * L)
            cat_stats[c] = {"domain": v.domain, "counts": counts,
                            "cond": cond}
        # JAX's order: the statistics by the training's column order
        out = {
            "priors": priors,
            "num_stats": {c: num_stats[c] for c in self._x if c in num_stats},
            "cat_stats": {c: cat_stats[c] for c in self._x if c in cat_stats},
            "names": list(self._x),
            "response_domain": tuple(yv.domain),
        }
        model = NaiveBayesModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        if valid is not None:
            model.validation_metrics = model._score_metrics(valid)
        return model
