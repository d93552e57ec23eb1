"""Design-matrix view — the port of ``h2o3_tpu/models/datainfo.py``.

``DataInfo`` gives GLM a numeric view of a Frame: categoricals expanded to
indicator blocks, numerics standardized with the column's rollup stats,
missing values imputed with the mean or their rows skipped, an intercept
column last. The view is one ``(nrow, p)`` float32 matrix built on the
frame's device, written block by block into one buffer (no numpy round
trip, no concatenation copy). Train-time statistics (means, sigmas,
domains) are kept, so the same transform applies to validation and test
frames: unseen levels become NA, an all-zero indicator row.

Not ported yet (ROADMAP Queue A 6): feature hashing (``hash_buckets``) and
interaction columns (``interaction_pairs``); both raise
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.models.tree.binning import _adapt_codes

MEAN_IMPUTATION = "mean_imputation"
SKIP = "skip"


@dataclass
class ColumnSpec:
    name: str
    kind: str  # "num" | "cat"
    mean: float = 0.0
    sigma: float = 1.0
    domain: tuple[str, ...] = ()
    offset: int = 0  # first column index in the expanded matrix
    width: int = 1


@dataclass
class DataInfo:
    """Fitted design-matrix spec. Build with :meth:`fit`, apply with
    :meth:`transform`."""

    columns: list[ColumnSpec] = field(default_factory=list)
    standardize: bool = True
    use_all_factor_levels: bool = True
    missing_handling: str = MEAN_IMPUTATION
    add_intercept: bool = False
    ncols_expanded: int = 0
    hash_buckets: int | None = None  # always None: hashing is not ported

    @staticmethod
    def fit(
        frame: Frame,
        x: list[str],
        standardize: bool = True,
        use_all_factor_levels: bool = True,
        missing_handling: str = MEAN_IMPUTATION,
        add_intercept: bool = False,
        interaction_pairs=None,
        hash_buckets=None,
    ) -> "DataInfo":
        if interaction_pairs:
            raise NotImplementedError(
                "DataInfo interaction columns are not ported yet "
                "(ROADMAP Queue A 6)")
        if hash_buckets and int(hash_buckets) > 0:
            raise NotImplementedError(
                "DataInfo feature hashing (hash_buckets) is not ported yet "
                "(ROADMAP Queue A 6)")
        di = DataInfo(
            standardize=standardize,
            use_all_factor_levels=use_all_factor_levels,
            missing_handling=missing_handling,
            add_intercept=add_intercept,
        )
        off = 0
        for name in x:
            v = frame.vec(name)
            if v.is_categorical():
                k = v.cardinality
                width = k if use_all_factor_levels else max(1, k - 1)
                di.columns.append(ColumnSpec(
                    name, "cat", domain=v.domain or (), offset=off,
                    width=width))
                off += width
            else:
                s = v.stats()
                sigma = s["sigma"] if standardize else 1.0
                if not np.isfinite(sigma) or sigma == 0.0:
                    sigma = 1.0
                di.columns.append(ColumnSpec(
                    name, "num",
                    mean=s["mean"] if np.isfinite(s["mean"]) else 0.0,
                    sigma=sigma, offset=off))
                off += 1
        di.ncols_expanded = off + (1 if add_intercept else 0)
        return di

    def coef_names(self) -> list[str]:
        """Expanded-column names (the coefficient table's rows)."""
        names = []
        lo = 0 if self.use_all_factor_levels else 1
        for c in self.columns:
            if c.kind == "cat":
                names += [f"{c.name}.{d}" for d in c.domain[lo: lo + c.width]]
            else:
                names.append(c.name)
        if self.add_intercept:
            names.append("Intercept")
        return names

    def transform(self, frame: Frame, pad_to: int | None = None):
        """The ``(nrow, p)`` float32 design matrix on the frame's device,
        and the row validity mask (0 where ``SKIP`` drops a row with an NA;
        those rows of the matrix are zero). ``pad_to`` adds all-zero
        columns up to that width (the GLM solve's shape bucket) in the
        same buffer."""
        n, dev = frame.nrow, frame.device
        P = self.ncols_expanded
        X = torch.zeros((n, max(P, pad_to or 0)), dtype=torch.float32,
                        device=dev)
        valid = torch.ones(n, dtype=torch.float32, device=dev)
        skip = self.missing_handling == SKIP
        base = 0 if self.use_all_factor_levels else 1
        rows = torch.arange(n, device=dev)
        for c in self.columns:
            v = frame.vec(c.name)
            if c.kind == "cat":
                codes = _adapt_codes(v, c.domain).long()
                if skip:
                    valid = valid * (codes >= 0).to(torch.float32)
                # the dense indicator block: NA (-1) and the dropped
                # reference level leave the row all-zero
                j = codes - base
                hit = (j >= 0) & (j < c.width)
                X[rows, c.offset + j.clamp(0, c.width - 1)] = \
                    hit.to(torch.float32)
            else:
                data = v.data
                isna = torch.isnan(data)
                if skip:
                    valid = valid * (~isna).to(torch.float32)
                # the constants rounded to float32 as JAX's weakly-typed
                # scalars are, so both packages compute the same floats
                m32 = float(np.float32(c.mean))
                xcol = torch.where(isna, m32, data)
                if self.standardize:
                    xcol = (xcol - m32) / float(np.float32(c.sigma))
                elif skip:
                    xcol = torch.where(isna, 0.0, xcol)
                X[:, c.offset] = xcol
        if self.add_intercept:
            X[:, P - 1] = 1.0
        if skip:  # zero out invalid rows: they add nothing to reductions
            X.mul_(valid[:, None])
        return X, valid
