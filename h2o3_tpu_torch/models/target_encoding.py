"""Target encoding — the port of ``h2o3_tpu/models/target_encoding.py``
(H2O's ``ai.h2o.targetencoding.TargetEncoder``).

Supervised categorical encoding with H2O's three holdout strategies:
``none`` (each level's mean), ``loo`` (leave one out: a row's own target
left out of its level's mean) and ``kfold`` (each fold's rows get the
means of the other folds), the blending ``lambda = 1/(1+exp(-(n-k)/f))``
that pulls a level's mean toward the prior, and uniform noise.

The per-level counts and target sums are ``index_add_`` passes over the
codes on the frame's device in float64 (the rows stay there); the small
per-level tables come back to the host once per fit, where the encoder
keeps them (as JAX's does), and go up again per transform. The noise is
drawn on the host with JAX's generator and seed, one draw of ``n`` per
encoded column in the fit's column order, and uploaded, so a seeded
encoding equals JAX's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import NUM, Frame, Vec


@dataclass
class TargetEncoderParams:
    holdout_type: str = "none"  # none | loo | kfold
    blending: bool = False
    inflection_point: float = 10.0  # k in lambda = 1/(1+exp(-(n-k)/f))
    smoothing: float = 20.0  # f
    noise: float = 0.0
    fold_column: str | None = None
    nfolds: int = 5
    seed: int = -1
    columns: Sequence[str] = field(default_factory=tuple)


def _target(yv) -> torch.Tensor:
    """The target as float64 on its device: a binary enum as 1 for its
    second level and 0 otherwise (its NAs too, as in JAX)."""
    t = yv.data.to(torch.float64)
    if yv.is_categorical():
        t = (t == 1).to(torch.float64)
    return t


def _level_sums(codes: torch.Tensor, use: torch.Tensor, t: torch.Tensor,
                card: int) -> tuple:
    """Per level, the count and the target sum of the rows in ``use``."""
    cs = codes.clamp(min=0)
    zeros = torch.zeros(card, dtype=torch.float64, device=codes.device)
    cnt = zeros.index_add(0, cs, use.to(torch.float64))
    ssum = zeros.index_add(0, cs, torch.where(use, t, 0.0))
    return cnt, ssum


class TargetEncoder:
    """The fit/transform pair of the h2o-py ``TargetEncoder``."""

    algo = "targetencoder"
    PARAMS_CLS = TargetEncoderParams
    PARAM_ALIASES: dict = {}

    def __init__(self, **kw):
        self.params = TargetEncoderParams(**kw)
        # column -> (level counts, level target sums, fit-time domain)
        self._stats: dict[str, tuple[np.ndarray, np.ndarray, tuple]] = {}
        self._prior: float = 0.0
        self._y: str | None = None

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, **kw):
        """The builder-shaped entry (H2O exposes the encoder as a builder):
        fit on ``training_frame``, register under a fresh key."""
        from h2o3_tpu_torch.models.calibration import _resolve_frame
        from h2o3_tpu_torch.models.model_base import make_key, register_model

        fr = _resolve_frame(training_frame)
        self.fit(fr, y=y, columns=list(x) if x else None)
        self.key = make_key("targetencoder")
        register_model(self)
        return self

    def fit(self, frame: Frame, y: str, columns: Sequence[str] | None = None):
        p = self.params
        cols = list(columns or p.columns) or [
            n for n in frame.names if frame.vec(n).is_categorical() and n != y
        ]
        yv = frame.vec(y)
        if yv.is_categorical() and yv.cardinality != 2:
            raise ValueError("target encoding supports numeric or binary targets")
        t = _target(yv)
        ok = ~torch.isnan(t) & (t >= 0)
        t = torch.where(ok, t, 0.0)
        cols = [c for c in cols if frame.vec(c).is_categorical()]
        parts = [torch.stack([ok.sum().to(torch.float64), t.sum()])]
        for c in cols:
            v = frame.vec(c)
            codes = v.data.long()
            parts += list(_level_sums(codes, ok & (codes >= 0), t,
                                      v.cardinality))
        host = torch.cat(parts).cpu().numpy()  # one read for every table
        n_ok, t_sum = host[0], host[1]
        self._prior = float(t_sum / n_ok) if n_ok > 0 else 0.0
        self._y = y
        self._stats = {}
        off = 2
        for c in cols:
            v = frame.vec(c)
            card = v.cardinality
            self._stats[c] = (host[off: off + card].copy(),
                              host[off + card: off + 2 * card].copy(),
                              tuple(v.domain or ()))
            off += 2 * card
        return self

    def transform(self, frame: Frame, as_training: bool = False) -> Frame:
        """Append ``<col>_te`` columns (float32, on the frame's device).
        ``as_training=True`` applies the holdout strategy (loo and kfold
        read the frame's own target and folds); a test-time transform uses
        the full fitted means. A column already encoded is left as it is,
        so applying the transform again adds nothing."""
        p = self.params
        rng = np.random.default_rng(abs(p.seed) if p.seed and p.seed > 0
                                    else None)
        n, dev = frame.nrow, frame.device
        prior = self._prior

        t = fold = None
        if as_training and p.holdout_type in ("loo", "kfold"):
            t = _target(frame.vec(self._y))
            if p.holdout_type == "kfold":
                if p.fold_column:
                    fold = frame.vec(p.fold_column).data.long()
                else:
                    fold = torch.arange(n, device=dev) % p.nfolds

        new_vecs, new_names = list(frame._vecs), list(frame.names)
        for c, (cnt_np, ssum_np, dom) in self._stats.items():
            if c not in frame or f"{c}_te" in frame:  # idempotent re-apply
                continue
            v = frame.vec(c)
            codes = v.data.long()
            # remap to the fit-time domain when the frame's domain differs
            if tuple(v.domain or ()) != dom:
                lut = {d: i for i, d in enumerate(dom)}
                remap = torch.as_tensor(np.array(
                    [lut.get(d, -1) for d in (v.domain or ())] or [-1],
                    np.int64), device=dev)
                codes = torch.where(codes >= 0, remap[codes.clamp(min=0)],
                                    -1)
            cnt = torch.as_tensor(cnt_np, device=dev)
            ssum = torch.as_tensor(ssum_np, device=dev)
            seen = codes >= 0
            cs = codes.clamp(min=0)
            if as_training and p.holdout_type == "loo" and t is not None:
                own = torch.where(~torch.isnan(t), t, 0.0)
                cnt_i = cnt[cs] - 1.0
                sum_i = ssum[cs] - own
                mean = torch.where(
                    cnt_i > 0, sum_i / torch.clamp(cnt_i, min=1e-300), prior)
                nlev = cnt_i
            elif as_training and p.holdout_type == "kfold" and t is not None:
                # out-of-fold level stats = full stats − this fold's stats
                mean = torch.full((n,), prior, dtype=torch.float64,
                                  device=dev)
                nlev = torch.zeros(n, dtype=torch.float64, device=dev)
                for f in torch.unique(fold).tolist():
                    infold = fold == f
                    use = infold & seen & ~torch.isnan(t)
                    cf, sf = _level_sums(codes, use, t, len(cnt_np))
                    oof_cnt = cnt - cf
                    oof_sum = ssum - sf
                    m = torch.where(
                        oof_cnt > 0,
                        oof_sum / torch.clamp(oof_cnt, min=1e-300), prior)
                    mean = torch.where(infold, m[cs], mean)
                    nlev = torch.where(infold, oof_cnt[cs], nlev)
            else:
                c_ = cnt[cs]
                mean = torch.where(
                    c_ > 0, ssum[cs] / torch.clamp(c_, min=1e-300), prior)
                nlev = c_
            if p.blending:
                lam = 1.0 / (1.0 + torch.exp(-(nlev - p.inflection_point)
                                             / max(p.smoothing, 1e-9)))
                mean = lam * mean + (1 - lam) * prior
            enc = torch.where(seen, mean, prior)
            if as_training and p.noise > 0:
                enc = enc + torch.as_tensor(
                    rng.uniform(-p.noise, p.noise, n), device=dev)
            new_vecs.append(Vec(enc.to(torch.float32), NUM, name=f"{c}_te"))
            new_names.append(f"{c}_te")
        return Frame(new_vecs, new_names)
