"""Columnar Frame on single-device torch tensors — the port of
``h2o3_tpu/frame/frame.py`` (``Vec``, ``Frame``, ``from_pandas``) and of the
type inference in ``h2o3_tpu/frame/parse.py``.

Storage follows the JAX package: numeric columns are ``float32`` with NaN
as NA, categorical columns the narrowest signed integer that holds the
domain with ``-1`` as NA, string columns stay on the host as numpy object
arrays. Rows are not padded: one device holds the whole column.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np
import pandas as pd
import torch

from h2o3_tpu_torch.device import resolve

NUM, CAT, STR, TIME = "real", "enum", "string", "time"
INT = "int"  # integral-valued numeric; stored like NUM but reported as int

_MAX_CAT_FRACTION = 0.95
_MAX_CAT_LEVELS = 10_000_000


class Vec:
    """One column: a device tensor for num/cat, a host array for str."""

    def __init__(self, data, kind: str, name: str = "", domain=None,
                 nrow: int | None = None):
        self.kind = kind
        self.name = name
        self.domain = tuple(domain) if domain is not None else None
        if kind == STR:
            self._host = np.asarray(data, dtype=object)
            self.data = None
            self.nrow = len(self._host)
        else:
            self._host = None
            self.data = data  # (nrow,) tensor
            self.nrow = int(data.shape[0]) if nrow is None else nrow
        self._stats: dict | None = None

    @staticmethod
    def device_dtype(kind: str, domain=None):
        """(numpy dtype, NA fill) of a column's device storage — the same
        ladder as ``h2o3_tpu.frame.frame.Vec.device_dtype``."""
        if kind == CAT:
            card = len(domain or ())
            dt = np.int8 if card <= 127 else np.int16 if card <= 32767 else np.int32
            return np.dtype(dt), -1
        return np.dtype(np.float32), np.nan

    @staticmethod
    def from_numpy(arr, kind: str, name: str = "", domain=None,
                   device=None) -> "Vec":
        if kind == STR:
            return Vec(arr, STR, name=name)
        dt, _ = Vec.device_dtype(kind, domain)
        host = np.ascontiguousarray(np.asarray(arr, dtype=dt))
        t = torch.from_numpy(host).to(resolve(device))
        return Vec(t, kind, name=name, domain=domain, nrow=len(host))

    @property
    def device(self) -> torch.device:
        return self.data.device

    def is_categorical(self) -> bool:
        return self.kind == CAT

    def to_numpy(self) -> np.ndarray:
        """Host copy; categorical columns come back as codes (-1 = NA)."""
        if self.kind == STR:
            return self._host
        return self.data.cpu().numpy()

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain else -1

    def stats(self) -> dict:
        """Rollup stats (naCnt, mean, sigma, min, max; levelCounts for cat)."""
        if self._stats is not None:
            return self._stats
        if self.kind == STR:
            self._stats = {"naCnt": int(sum(1 for v in self._host if v is None))}
            return self._stats
        if self.kind == CAT:
            counts = _cat_counts(self.data, max(1, self.cardinality)).cpu().numpy()
            self._stats = {"naCnt": self.nrow - int(counts.sum()),
                           "levelCounts": counts}
            return self._stats
        s = _num_stats(self.data)
        cnt = int(s["cnt"])
        mean0 = float(s["sum"]) / cnt if cnt else float("nan")
        c = _centered_stats(self.data, mean0)
        mean = mean0 + (float(c["dsum"]) / cnt if cnt else 0.0)
        var = ((float(c["dssq"]) - float(c["dsum"]) ** 2 / cnt) / cnt
               if cnt else float("nan"))
        self._stats = {
            "naCnt": self.nrow - cnt,
            "mean": mean,
            "sigma": math.sqrt(max(0.0, var) * (cnt / max(1.0, cnt - 1))),
            "min": float(s["min"]),
            "max": float(s["max"]),
        }
        return self._stats


def _num_stats(col: torch.Tensor) -> dict:
    ok = ~torch.isnan(col)
    inf = torch.tensor(float("inf"), dtype=col.dtype, device=col.device)
    return {
        "cnt": ok.sum(),
        "sum": torch.where(ok, col, 0.0).sum(dtype=torch.float32),
        "min": torch.where(ok, col, inf).min(),
        "max": torch.where(ok, col, -inf).max(),
    }


def _centered_stats(col: torch.Tensor, mean0: float) -> dict:
    ok = ~torch.isnan(col)
    d = torch.where(ok, col - mean0, 0.0)
    return {"dsum": d.sum(dtype=torch.float32),
            "dssq": (d * d).sum(dtype=torch.float32)}


def _cat_counts(codes: torch.Tensor, card: int) -> torch.Tensor:
    ok = codes >= 0
    return torch.zeros(card, dtype=torch.int64, device=codes.device).index_add_(
        0, torch.where(ok, codes, 0).long(), ok.long())


def infer_kind(s: pd.Series) -> str:
    """Column type inference — ``h2o3_tpu.frame.parse.infer_kind``."""
    if pd.api.types.is_bool_dtype(s):
        return CAT
    if pd.api.types.is_datetime64_any_dtype(s):
        return TIME
    if isinstance(s.dtype, pd.CategoricalDtype):
        return CAT
    if pd.api.types.is_integer_dtype(s):
        return INT
    if pd.api.types.is_float_dtype(s):
        return NUM
    nz = s.dropna()
    if len(nz) == 0:
        return NUM
    if pd.to_numeric(nz, errors="coerce").notna().all():
        return NUM
    nuniq = nz.nunique()
    if nuniq > _MAX_CAT_LEVELS or (len(nz) > 100 and nuniq > _MAX_CAT_FRACTION * len(nz)):
        return STR
    return CAT


def _series_to_vec(s: pd.Series, kind: str, name: str, device) -> Vec:
    if kind == TIME:
        raise NotImplementedError(
            f"column {name!r}: time columns are not ported yet")
    if kind == STR:
        return Vec(s.astype(object).where(s.notna(), None).to_numpy(), STR, name=name)
    if kind == CAT:
        if isinstance(s.dtype, pd.CategoricalDtype):
            domain = [str(c) for c in s.cat.categories]
            codes = s.cat.codes.to_numpy().astype(np.int32)
        else:
            ok = s.notna().to_numpy()
            sv = s[ok].astype(str)
            # levels interned in sorted order, as the JAX parser does
            domain = sorted(set(sv.unique()))
            codes = np.full(len(s), -1, dtype=np.int32)
            codes[ok] = pd.Categorical(sv, categories=domain).codes
        return Vec.from_numpy(codes, CAT, name=name, domain=domain, device=device)
    vals = pd.to_numeric(s, errors="coerce").to_numpy(dtype=np.float64)
    return Vec.from_numpy(vals, INT if kind == INT else NUM, name=name, device=device)


class Frame:
    """Named list of aligned Vecs on one device."""

    def __init__(self, vecs: Sequence[Vec], names: Sequence[str] | None = None):
        vecs = list(vecs)
        if names is None:
            names = [v.name or f"C{i + 1}" for i, v in enumerate(vecs)]
        if len(names) != len(vecs):
            raise ValueError("one name per column")
        if len({v.nrow for v in vecs}) > 1:
            raise ValueError("misaligned columns")
        self._vecs = vecs
        self._names = [str(n) for n in names]
        for v, n in zip(self._vecs, self._names):
            v.name = n

    @staticmethod
    def from_pandas(df: pd.DataFrame, column_types: Mapping[str, str] | None = None,
                    device=None) -> "Frame":
        dev = resolve(device)
        column_types = column_types or {}
        vecs = []
        for name in df.columns:
            kind = column_types.get(str(name)) or infer_kind(df[name])
            if kind in ("numeric", "float", "double"):
                kind = NUM
            if kind in ("factor", "categorical"):
                kind = CAT
            vecs.append(_series_to_vec(df[name], kind, str(name), dev))
        return Frame(vecs, [str(c) for c in df.columns])

    @property
    def nrow(self) -> int:
        return self._vecs[0].nrow if self._vecs else 0

    @property
    def ncol(self) -> int:
        return len(self._vecs)

    @property
    def names(self) -> list[str]:
        return list(self._names)

    @property
    def device(self) -> torch.device:
        for v in self._vecs:
            if v.kind != STR:
                return v.device
        raise ValueError("frame has no device-resident column")

    def vec(self, col: int | str) -> Vec:
        return self._vecs[self._names.index(col) if isinstance(col, str) else int(col)]

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __repr__(self) -> str:
        return f"<Frame {self.nrow}x{self.ncol} {self._names[:8]}>"


def upload_file(data, col_types: Mapping[str, str] | None = None,
                device=None) -> Frame:
    """``h2o.upload_file``: a path, a DataFrame or a dict of columns onto
    the device (``cuda`` unless ``device`` says otherwise)."""
    if isinstance(data, str):
        return import_file(data, col_types=col_types, device=device)
    df = data if isinstance(data, pd.DataFrame) else pd.DataFrame(data)
    return Frame.from_pandas(df, col_types, device=device)


def import_file(path: str, col_types: Mapping[str, str] | None = None,
                sep: str | None = None, device=None) -> Frame:
    """``h2o.import_file``: the file is read through pandas (CSV-like text,
    or parquet by extension) and uploaded like :func:`upload_file`."""
    dev = resolve(device)
    if path.lower().endswith((".parquet", ".pq")):
        df = pd.read_parquet(path)
    else:
        df = pd.read_csv(path, sep=sep or ",")
    return Frame.from_pandas(df, col_types, device=dev)
