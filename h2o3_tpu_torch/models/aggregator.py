"""Aggregator — the port of ``h2o3_tpu/models/aggregator.py`` (the
successor of ``hex.aggregator.Aggregator``): reduce a frame to about
``target_num_exemplars`` representative rows with member counts.

The design space (transformed numerics and one-hot categoricals, JAX's
construction in float64 cast to float32) is built once on the frame's
device and stays there. Rows stream in chunks of 8,192; each pass of a
chunk computes the squared distances of its unassigned rows to the current
exemplars as one float32 expression on the device (JAX's
``|x|² − 2x·e + |e|²`` in its order, so argmin ties break as JAX's do)
and reads back only their ``(dmin, amin)``. The exemplars live on the
device and on the host: new ones are gathered from the device matrix by
row index.

What JAX does on the host stays on the host, on the same numbers: the
greedy spawn over at most 128 candidates (their rows read back), the
radius doubling, the re-aggregation of the exemplars against themselves
and the final budget loop, all drawing from JAX's
``np.random.default_rng(abs(seed) or 19)``, so both packages pick the same
exemplars. JAX pads the distance program to powers of two to bound its
compiles; the padded rows and exemplars never win, so the port computes
on the real shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import INT, STR, Frame, Vec
from h2o3_tpu_torch.models import metrics as MM
from h2o3_tpu_torch.models.model_base import (
    CommonParams,
    Model,
    ModelBuilder,
    gather_rows,
)
from h2o3_tpu_torch.ops.gram import full_fp32

CHUNK_ROWS = 8192  # JAX's chunk
SPAWN_CANDIDATES = 128  # JAX's greedy spawn sample


@dataclass
class AggregatorParams(CommonParams):
    target_num_exemplars: int = 5000
    rel_tol_num_exemplars: float = 0.5
    transform: str = "NORMALIZE"  # NONE | STANDARDIZE | NORMALIZE
    categorical_encoding: str = "AUTO"  # one-hot on the distance space


def chunk_dists(Xc: torch.Tensor, E: torch.Tensor):
    """Min squared distance and argmin exemplar per row of ``Xc`` against
    ``E``, in float32 on their device (JAX's ``_dists_prog``)."""
    with full_fp32():
        d = ((Xc * Xc).sum(1)[:, None] - 2.0 * (Xc @ E.T)
             + (E * E).sum(1)[None, :])
    dmin, amin = torch.min(d, dim=1)
    return dmin, amin


def design_space(train: Frame, feats: list[str], transform: str
                 ) -> torch.Tensor:
    """JAX's distance space on the frame's device: each numeric column
    mean-imputed and transformed in float64 (NONE, STANDARDIZE with the
    population deviation, NORMALIZE to [0, 1]) then cast to float32, each
    categorical one-hot (an NA row all zero)."""
    t = transform.upper()
    cols = []
    for n in feats:
        v = train.vec(n)
        if v.is_categorical():
            codes = v.data.long()
            k = v.cardinality
            oh = torch.zeros((len(codes), k), dtype=torch.float32,
                             device=codes.device)
            ok = codes >= 0
            oh[ok.nonzero().flatten(), codes[ok]] = 1.0
            cols.append(oh)
            continue
        x = v.data.double()
        nan = torch.isnan(x)
        cnt = max(int((~nan).sum()), 1)
        x = torch.where(nan, torch.where(nan, 0.0, x).sum() / cnt, x)
        if t == "STANDARDIZE":
            mean = x.sum() / len(x)
            s = float(torch.sqrt(((x - mean) ** 2).sum() / len(x))) or 1.0
            x = (x - mean) / s
        elif t == "NORMALIZE":
            lo, hi = x.min(), x.max()
            x = (x - lo) / (float(hi - lo) or 1.0)
        cols.append(x.float()[:, None])
    return torch.cat(cols, dim=1).contiguous()


class AggregatorModel(Model):
    algo = "aggregator"

    def _predict_raw(self, frame: Frame):
        raise NotImplementedError("aggregator is a data-prep model")

    @property
    def aggregated_frame(self) -> Frame:
        """The exemplars (each one's first member row, in the original
        columns) and their ``counts``, on the training frame's device."""
        o = self.output["aggregated"]
        return Frame([Vec(t, kind, name=n, domain=dom)
                      for n, kind, dom, t in o], [c[0] for c in o])

    @property
    def mapping(self) -> np.ndarray:
        return self.output["mapping"]

    def _score_metrics(self, frame: Frame) -> MM.ModelMetrics:
        return MM.ModelMetrics(
            "aggregator",
            {"num_exemplars": float(self.output["num_exemplars"]),
             "nobs": float(self.output["nobs"])})


class Aggregator(ModelBuilder):
    algo = "aggregator"
    PARAMS_CLS = AggregatorParams

    def _validate(self, train, valid):
        pass  # unsupervised

    def _build(self, train: Frame, valid: Frame | None) -> Model:
        p: AggregatorParams = self.params
        feats = self._x
        X = design_space(train, feats, p.transform)
        n, d = X.shape
        dev = X.device
        stats = {"passes": 0, "reaggregations": 0, "host_reads": 0,
                 "spawned": 0}

        target = max(1, p.target_num_exemplars)
        hi_cap = target * (1.0 + p.rel_tol_num_exemplars)
        radius = 1e-3 * d  # squared-distance radius, scaled by dimension

        exemplars = gather_rows(X, [0])  # host copy, float32
        E = X[:1].clone()  # the device copy
        stats["host_reads"] += 1
        counts = np.ones(1, np.int64)
        members = np.zeros(n, np.int64)
        rng = np.random.default_rng(abs(p.seed) or 19)
        i = 1
        while i < n:
            hi = min(i + CHUNK_ROWS, n)
            idx_c = np.arange(i, hi)
            todo = np.arange(hi - i)
            while len(todo):
                rows = torch.from_numpy(i + todo).to(dev)
                dmin, amin = chunk_dists(X.index_select(0, rows), E)
                pair = torch.stack([dmin.double(), amin.double()]).cpu()
                stats["passes"] += 1
                stats["host_reads"] += 1
                dmin_h = pair[0].numpy().astype(np.float32)
                amin_h = pair[1].numpy().astype(np.int64)
                within = dmin_h <= radius
                hit = todo[within]
                members[idx_c[hit]] = amin_h[within]
                np.add.at(counts, amin_h[within], 1)
                todo = todo[~within]
                if not len(todo):
                    break
                budget = int(hi_cap) - len(counts)
                if budget <= 0:
                    # over budget: widen the radius and re-merge exemplars
                    radius *= 2.0
                    exemplars, counts, members, kept = _reaggregate(
                        exemplars, counts, members, radius)
                    E = E.index_select(0, torch.from_numpy(kept).to(dev))
                    stats["reaggregations"] += 1
                    continue
                # batched spawn: greedy maximin over a sample of the
                # uncovered rows, on their values read back
                cand = todo[rng.permutation(len(todo))[
                    : min(SPAWN_CANDIDATES, budget, len(todo))]]
                Xcand = gather_rows(X, i + cand)
                stats["host_reads"] += 1
                picked: list[int] = []
                picked_pos: list[int] = []
                for ci, j in enumerate(cand):
                    x = Xcand[ci]
                    if picked:
                        dd = np.sum((Xcand[picked_pos] - x) ** 2, axis=1)
                        if dd.min() <= radius:
                            continue
                    picked.append(int(j))
                    picked_pos.append(ci)
                base = len(counts)
                exemplars = np.vstack([exemplars, Xcand[picked_pos]])
                E = torch.cat([E, X.index_select(0, torch.from_numpy(
                    i + np.asarray(picked, np.int64)).to(dev))])
                counts = np.concatenate([counts,
                                         np.ones(len(picked), np.int64)])
                members[idx_c[picked]] = base + np.arange(len(picked))
                stats["spawned"] += len(picked)
                todo = np.setdiff1d(todo, np.asarray(picked, np.int64))
            i += CHUNK_ROWS

        # final budget enforcement
        while len(counts) > hi_cap:
            radius *= 2.0
            exemplars, counts, members, _ = _reaggregate(
                exemplars, counts, members, radius)
            stats["reaggregations"] += 1

        # each exemplar's first member row, in the original columns
        uniq, first_idx = np.unique(members, return_index=True)
        first_member = np.zeros(len(counts), np.int64)
        first_member[uniq] = first_idx
        sub = train.subset_rows(first_member)
        agg = []
        for nm in sub.names:
            v = sub.vec(nm)
            agg.append((nm, v.kind, v.domain,
                        v.to_numpy() if v.kind == STR else v.data))
        agg.append(("counts", INT, None, torch.from_numpy(
            counts.astype(np.float32)).to(dev)))
        out = {
            "aggregated": agg,
            "num_exemplars": len(counts),
            "nobs": n,
            "mapping": members,
            "exemplars": exemplars,  # their design-space rows, float32
            "radius": radius,
            "names": list(feats),
            "response_domain": None,
            "aggregator_stats": stats,
        }
        model = AggregatorModel(None, p, out)
        model.training_metrics = model._score_metrics(train)
        return model


def _reaggregate(exemplars, counts, members, radius):
    """Merge exemplars closer than ``radius`` (greedy, count-weighted:
    JAX's host loop, its float32 distances computed on the same values),
    returning also the kept exemplars' old indices. The kept rows grow in
    place in one buffer, where JAX gathers them anew for each exemplar."""
    E = len(exemplars)
    order = np.argsort(-counts)  # biggest exemplars absorb first
    new_idx = np.full(E, -1, np.int64)
    K = np.empty_like(exemplars)
    kept: list[int] = []
    for ei in order:
        x = exemplars[ei]
        nk = len(kept)
        if nk:
            dd = np.sum((K[:nk] - x) ** 2, axis=1)
            h = np.argmin(dd)
            if dd[h] <= radius:
                new_idx[ei] = h
                continue
        new_idx[ei] = nk
        K[nk] = x
        kept.append(ei)
    new_counts = np.zeros(len(kept), np.int64)
    np.add.at(new_counts, new_idx, counts)
    return K[: len(kept)].copy(), new_counts, new_idx[members], np.asarray(
        kept, np.int64)
