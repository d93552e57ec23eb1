"""Design-matrix view — the port of ``h2o3_tpu/models/datainfo.py``.

``DataInfo`` gives GLM a numeric view of a Frame: categoricals expanded to
indicator blocks, numerics standardized with the column's rollup stats,
missing values imputed with the mean or their rows skipped, an intercept
column last. The view is one ``(nrow, p)`` float32 matrix built on the
frame's device, written block by block into one buffer (no numpy round
trip, no concatenation copy). Train-time statistics (means, sigmas,
domains) are kept, so the same transform applies to validation and test
frames: unseen levels become NA, an all-zero indicator row.

Interaction columns (``interaction_pairs``) follow the base columns:
cat×cat is one combined factor (level ``a_b`` for each pair of training
levels), num×num the product (NAs imputed with the training means, then
standardized), cat×num the indicator block times the numeric. Feature
hashing (``hash_buckets``): a categorical wider than ``hash_buckets``
levels becomes a block of that many buckets, the bucket of a level
``crc32(name \\0 level) % hash_buckets``, so any frame hashes its own
levels with no domain remap.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame, Vec
from h2o3_tpu_torch.models.tree.binning import _adapt_codes

MEAN_IMPUTATION = "mean_imputation"
SKIP = "skip"


@dataclass
class ColumnSpec:
    name: str
    kind: str  # "num" | "cat" | "hash"
    mean: float = 0.0
    sigma: float = 1.0
    domain: tuple[str, ...] = ()
    offset: int = 0  # first column index in the expanded matrix
    width: int = 1
    # an interaction's source pair; kind "num" is the numeric product,
    # kind "cat" the indicator block of the categorical times the numeric,
    # or (with ``pair_domains``) the cat×cat combined factor.
    # ``pair_means``: the training means of the numeric sources (NA
    # imputation never depends on the scoring frame); ``pair_domains``:
    # the two training domains, remapped before the code a·|db| + b
    pair: tuple[str, str] | None = None
    pair_means: tuple[float, float] | None = None
    pair_domains: tuple[tuple[str, ...], tuple[str, ...]] | None = None


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
    # categoricals wider than this many levels are hashed (None: none);
    # without all factor levels bucket 0 is the dropped reference level
    hash_buckets: int | None = None
    # per column, the latest domain's bucket table on its device: one
    # crc32 per level, paid once per domain, not per scoring call
    _hash_luts: dict = field(default_factory=dict, repr=False, compare=False)

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
        hash_buckets = (int(hash_buckets) if hash_buckets
                        and int(hash_buckets) > 0 else None)
        di = DataInfo(
            standardize=standardize,
            use_all_factor_levels=use_all_factor_levels,
            missing_handling=missing_handling,
            add_intercept=add_intercept,
            hash_buckets=hash_buckets,
        )

        def width_of(k: int) -> int:
            return k if use_all_factor_levels else max(1, k - 1)

        off = 0
        for name in x:
            v = frame.vec(name)
            if v.is_categorical():
                k = v.cardinality
                if hash_buckets is not None and k > hash_buckets:
                    hw = width_of(hash_buckets)
                    di.columns.append(ColumnSpec(name, "hash", offset=off,
                                                 width=hw))
                    off += hw
                    continue
                di.columns.append(ColumnSpec(
                    name, "cat", domain=v.domain or (), offset=off,
                    width=width_of(k)))
                off += width_of(k)
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
        for a, b in interaction_pairs or ():
            va, vb = frame.vec(a), frame.vec(b)
            if va.is_categorical() and vb.is_categorical():
                da, db = tuple(va.domain or ()), tuple(vb.domain or ())
                dom = tuple(f"{p}_{q}" for p in da for q in db)
                di.columns.append(ColumnSpec(
                    f"{a}:{b}", "cat", domain=dom, offset=off,
                    width=width_of(len(dom)), pair=(a, b),
                    pair_domains=(da, db)))
                off += width_of(len(dom))
            elif va.is_categorical() or vb.is_categorical():
                cv, nv = (va, vb) if va.is_categorical() else (vb, va)
                cn, nn = (a, b) if va.is_categorical() else (b, a)
                di.columns.append(ColumnSpec(
                    f"{cn}:{nn}", "cat", domain=cv.domain or (), offset=off,
                    width=width_of(cv.cardinality), pair=(cn, nn),
                    pair_means=(0.0, float(nv.stats()["mean"]))))
                off += width_of(cv.cardinality)
            else:
                ma, mb = float(va.stats()["mean"]), float(vb.stats()["mean"])
                prod = _pair_product(va, vb, ma, mb).double()
                mean = float(prod.mean()) if len(prod) else 0.0
                sigma = (float(torch.sqrt(torch.mean((prod - mean) ** 2)))
                         if standardize and len(prod) else 1.0)
                if not np.isfinite(sigma) or sigma == 0.0:
                    sigma = 1.0
                di.columns.append(ColumnSpec(
                    f"{a}:{b}", "num", mean=mean if standardize else 0.0,
                    sigma=sigma, offset=off, pair=(a, b),
                    pair_means=(ma, mb)))
                off += 1
        di.ncols_expanded = off + (1 if add_intercept else 0)
        return di

    @staticmethod
    def from_meta(d: dict) -> "DataInfo":
        """A DataInfo from its spec as plain Python values (the tmojo's
        ``datainfo`` meta, or a JAX model's carried across): the flags,
        ``ncols_expanded``, ``hash_buckets`` and ``columns`` (each: name,
        kind, offset, width, mean, sigma, domain, and an interaction's
        pair, pair_means and pair_domains)."""

        def pair_of(c, key):
            v = c.get(key)
            return tuple(tuple(x) if isinstance(x, (list, tuple)) else x
                         for x in v) if v else None

        return DataInfo(
            columns=[ColumnSpec(c["name"], c["kind"], mean=float(c["mean"]),
                                sigma=float(c["sigma"]),
                                domain=tuple(c.get("domain") or ()),
                                offset=int(c["offset"]),
                                width=int(c["width"]),
                                pair=pair_of(c, "pair"),
                                pair_means=pair_of(c, "pair_means"),
                                pair_domains=pair_of(c, "pair_domains"))
                     for c in d["columns"]],
            standardize=bool(d["standardize"]),
            use_all_factor_levels=bool(d["use_all_factor_levels"]),
            missing_handling=d["missing_handling"],
            add_intercept=bool(d["add_intercept"]),
            ncols_expanded=int(d["ncols_expanded"]),
            hash_buckets=(int(d["hash_buckets"])
                          if d.get("hash_buckets") else None),
        )

    def coef_names(self) -> list[str]:
        """Expanded-column names (the coefficient table's rows)."""
        names = []
        lo = 0 if self.use_all_factor_levels else 1
        for c in self.columns:
            if c.kind == "hash":
                names += [f"{c.name}.hash{i}" for i in range(c.width)]
            elif c.kind == "cat":
                levels = c.domain[lo: lo + c.width]
                if c.pair is not None and c.pair_domains is None:
                    names += [f"{c.pair[0]}.{d}:{c.pair[1]}" for d in levels]
                else:
                    names += [f"{c.name}.{d}" for d in levels]
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
        rows = torch.arange(n, device=dev)

        def keep(ok):
            nonlocal valid
            if skip:
                valid = valid * ok.to(torch.float32)

        def indicators(codes, c: ColumnSpec, value=None):
            # the dense indicator block: NA (-1) and the dropped reference
            # level leave the row all-zero; ``value`` scales the one
            j = codes.long() - (0 if self.use_all_factor_levels else 1)
            hit = ((j >= 0) & (j < c.width)).to(torch.float32)
            X[rows, c.offset + j.clamp(0, c.width - 1)] = (
                hit if value is None else hit * value)

        for c in self.columns:
            if c.pair is not None:
                self._transform_interaction(frame, c, X, keep, indicators)
                continue
            v = frame.vec(c.name)
            if c.kind == "hash":
                buckets = self._hashed_codes(v, c)
                keep(buckets >= 0)
                indicators(buckets, c)
            elif c.kind == "cat":
                codes = _adapt_codes(v, c.domain)
                keep(codes >= 0)
                indicators(codes, c)
            else:
                data = v.data
                isna = torch.isnan(data)
                keep(~isna)
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

    def _hashed_codes(self, v: Vec, c: ColumnSpec) -> torch.Tensor:
        """Bucket codes of a hashed column (-1 for NA), the table cached
        per column for its latest domain."""
        hit = self._hash_luts.get(c.name)
        if hit is not None and hit[0] is v.domain and \
                hit[1].device == v.device:
            lut = hit[1]
        else:
            lut = torch.from_numpy(_hash_lut(v.domain or (), c.name,
                                             self.hash_buckets)).to(v.device)
            self._hash_luts[c.name] = (v.domain, lut)
        codes = v.data.long()
        return torch.where(codes >= 0, lut[codes.clamp(min=0)], -1)

    def _transform_interaction(self, frame: Frame, c: ColumnSpec, X, keep,
                               indicators) -> None:
        """One interaction block into ``X``; NAs imputed with the training
        means, and under ``SKIP`` a missing source drops the row."""
        va, vb = frame.vec(c.pair[0]), frame.vec(c.pair[1])
        if c.pair_domains is not None:  # cat × cat: one combined factor
            da, db = c.pair_domains
            # int32 before the product: narrow code storage would overflow
            ca = _adapt_codes(va, da).to(torch.int32)
            cb = _adapt_codes(vb, db).to(torch.int32)
            codes = torch.where((ca >= 0) & (cb >= 0), ca * len(db) + cb, -1)
            keep(codes >= 0)
            indicators(codes, c)
        elif c.kind == "num":  # num × num: the product, standardized
            ma, mb = c.pair_means or (0.0, 0.0)
            keep(~(torch.isnan(va.data) | torch.isnan(vb.data)))
            x = _pair_product(va, vb, ma, mb)
            if self.standardize:
                x = (x - float(np.float32(c.mean))) / float(
                    np.float32(c.sigma))
            X[:, c.offset] = x
        else:  # cat × num: the indicator block times the numeric
            codes = _adapt_codes(va, c.domain)
            keep(codes >= 0)
            keep(~torch.isnan(vb.data))
            mb = (c.pair_means or (0.0, 0.0))[1]
            indicators(codes, c, torch.nan_to_num(
                vb.data, nan=float(np.float32(mb))))


def _pair_product(va: Vec, vb: Vec, ma: float, mb: float) -> torch.Tensor:
    """The float32 product of two numeric columns, each NA imputed with
    its (training) mean rounded to float32."""
    return (torch.nan_to_num(va.data, nan=float(np.float32(ma)))
            * torch.nan_to_num(vb.data, nan=float(np.float32(mb))))


def _hash_lut(domain, col_name: str, n_buckets: int) -> np.ndarray:
    """Level code -> bucket: ``crc32(col_name \\0 level) % n_buckets``, a
    stable string hash seeded by the column's name, with a trailing -1 so
    the gather stays in bounds for an empty domain."""
    prefix = col_name.encode() + b"\x00"
    lut = np.fromiter(
        (zlib.crc32(prefix + d.encode()) % n_buckets for d in domain),
        dtype=np.int64, count=len(domain))
    return np.append(lut, -1)
