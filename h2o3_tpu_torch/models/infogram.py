"""InfoGram — the port of ``h2o3_tpu/models/infogram.py`` (the successor of
``hex.Infogram.Infogram``): the information diagram of admissible machine
learning (Lee et al.).

Core infogram (no protected columns): per feature, x = total information
(the predictive strength of the feature alone) and y = net information
(the strength lost when the feature is dropped), each normalized by its
largest value. Fair infogram (``protected_columns`` set): x = relevance
(the strength the feature adds to the protected columns) and y = safety
(one minus how well the feature predicts the protected columns, JAX's
stand-in for upstream's conditional mutual information). Admissible
features clear both thresholds of their mode.

Every strength is one port GBM (:func:`strength`): 1 − its training
logloss (or MSE) over the null model's, with JAX's seeds. The core mode
trains 1 + 2·F of them, so its path runs the GBM's kernels (B1, its
compaction and B2) on the card throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.metrics import ModelMetrics
from h2o3_tpu_torch.models.model_base import CommonParams, Model, ModelBuilder


@dataclass
class InfogramParams(CommonParams):
    protected_columns: list = field(default_factory=list)
    safety_index_threshold: float = 0.1
    relevance_index_threshold: float = 0.1
    total_information_threshold: float = 0.1
    net_information_threshold: float = 0.1
    ntrees: int = 20
    max_depth: int = 5
    top_n_features: int = 50


def null_loss(frame: Frame, y: str, classification: bool) -> float:
    """The null model's loss on ``y`` (JAX's, on the host): the logloss of
    the class base rates, or the response's NaN variance."""
    yv = frame.vec(y)
    yn = yv.to_numpy()
    if classification:
        yn = yn[yn >= 0] if yv.is_categorical() else yn
        _, cnt = np.unique(yn.astype(np.int64), return_counts=True)
        pr = cnt / cnt.sum()
        return -float(np.sum(pr * np.log(np.clip(pr, 1e-15, 1))))
    return float(np.nanvar(yn))


def strength(frame: Frame, y: str, xcols: list[str], classification: bool,
             ntrees: int, max_depth: int, seed: int, null: float) -> float:
    """Predictive strength of ``xcols`` for ``y`` in [0, 1]: one port GBM's
    1 − training loss / ``null`` (the null model's loss)."""
    from h2o3_tpu_torch.models.tree.gbm import GBM

    if not xcols:
        return 0.0
    m = GBM(ntrees=ntrees, max_depth=max_depth, seed=seed).train(
        y=y, x=xcols, training_frame=frame)
    loss = m.training_metrics.value("logloss" if classification else "mse")
    return float(np.clip(1.0 - loss / max(null, 1e-12), 0.0, 1.0))


class InfogramModel(Model):
    algo = "infogram"

    def _predict_raw(self, frame: Frame):
        raise NotImplementedError("infogram is a diagnostic model")

    def get_admissible_features(self) -> list[str]:
        return list(self.output["admissible_features"])

    def get_admissible_score_frame(self) -> list[dict]:
        return self.output["score_table"]

    def _score_metrics(self, frame: Frame) -> ModelMetrics:
        return ModelMetrics(
            "infogram",
            {"n_admissible": float(len(self.output["admissible_features"]))})


class Infogram(ModelBuilder):
    algo = "infogram"
    PARAMS_CLS = InfogramParams

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: InfogramParams = self.params
        yv = train.vec(p.response_column)
        classification = yv.is_categorical()
        seed = abs(p.seed) or 13
        protected = list(p.protected_columns or [])
        feats = [n for n in self._x if n not in protected]
        if len(feats) > p.top_n_features:
            feats = feats[: p.top_n_features]
        nulls: dict[str, float] = {}

        def s(y, xcols, sd, cls=classification):
            if y not in nulls:  # read once per response
                nulls[y] = null_loss(train, y, cls)
            return strength(train, y, xcols, cls, p.ntrees, p.max_depth, sd,
                            null=nulls[y])

        yc = p.response_column
        table: list[dict] = []
        if not protected:
            full = s(yc, feats, seed)
            solo, drop = {}, {}
            for fi, f in enumerate(feats):
                solo[f] = s(yc, [f], seed + 1 + fi)
                rest = [g for g in feats if g != f]
                drop[f] = max(full - s(yc, rest, seed + 101 + fi), 0.0)
            smax = max(solo.values()) or 1.0
            dmax = max(drop.values()) or 1.0
            for f in feats:
                ti, ni = solo[f] / smax, drop[f] / dmax
                adm = (ti >= p.total_information_threshold
                       and ni >= p.net_information_threshold)
                table.append({"column": f, "total_information": ti,
                              "net_information": ni, "admissible": adm})
            xkey, ykey = "total_information", "net_information"
        else:
            base = s(yc, protected, seed)
            rel, unsafe = {}, {}
            for fi, f in enumerate(feats):
                rel[f] = max(s(yc, protected + [f], seed + 1 + fi) - base, 0.0)
                u = 0.0
                for pj, pc in enumerate(protected):
                    u = max(u, s(pc, [f], seed + 201 + fi * 7 + pj,
                                 cls=train.vec(pc).is_categorical()))
                unsafe[f] = u
            rmax = max(rel.values()) or 1.0
            umax = max(unsafe.values()) or 1.0
            for f in feats:
                rv, sf = rel[f] / rmax, 1.0 - unsafe[f] / umax
                adm = (rv >= p.relevance_index_threshold
                       and sf >= p.safety_index_threshold)
                table.append({"column": f, "relevance_index": rv,
                              "safety_index": sf, "admissible": adm})
            xkey, ykey = "relevance_index", "safety_index"

        table.sort(key=lambda r: -(r[xkey] + r[ykey]))
        out = {
            "score_table": table,
            "admissible_features": [r["column"] for r in table
                                    if r["admissible"]],
            "x_axis": xkey,
            "y_axis": ykey,
            "names": feats,
            "response_domain": None,
        }
        model = InfogramModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        return model
