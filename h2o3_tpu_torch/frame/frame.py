"""Columnar Frame on single-device torch tensors — the port of
``h2o3_tpu/frame/frame.py`` (``Vec``, ``Frame``, ``from_pandas``). Type
inference and file reading are in ``parse.py`` (JAX's ``frame/parse.py``).

Storage follows the JAX package: numeric columns are ``float32`` with NaN
as NA, categorical columns the narrowest signed integer that holds the
domain with ``-1`` as NA, string columns stay on the host as numpy object
arrays. A time column is float32 epoch milliseconds on the device, with an
exact float64 copy on the host that ``to_numpy`` returns. Rows are not
padded: one device holds the whole column.
"""

from __future__ import annotations

import math
import uuid
from typing import Mapping, Sequence

import numpy as np
import pandas as pd
import torch

from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.frame.parse import (  # noqa: F401  (kinds re-exported)
    CAT,
    INT,
    NUM,
    STR,
    TIME,
    infer_kind,
    series_to_host,
)


class Vec:
    """One column: a device tensor for num/cat/time, a host array for str;
    a time column also keeps its exact float64 values on the host.

    The host tier of the out-of-core plane (JAX's ``Vec.host_values`` /
    ``release_device``): :meth:`host_values` keeps a host copy of the
    device values, :meth:`release_device` drops the device tensor, and the
    ``data`` property uploads the host copy again on its next use,
    bit-identical."""

    def __init__(self, data, kind: str, name: str = "", domain=None,
                 nrow: int | None = None, host_exact=None):
        self.kind = kind
        self.name = name
        self.domain = tuple(domain) if domain is not None else None
        self._hostbuf = None  # host copy in the device dtype, once asked for
        self._device = None
        if kind == STR:
            self._host = np.asarray(data, dtype=object)
            self._data = None
            self.nrow = len(self._host)
        else:
            self._host = host_exact
            self._data = data  # (nrow,) tensor
            self._device = data.device
            self.nrow = int(data.shape[0]) if nrow is None else nrow
        self._stats: dict | None = None

    @property
    def data(self):
        """The device tensor; uploaded again from the host copy after
        :meth:`release_device`."""
        if self._data is None and self._hostbuf is not None:
            self._data = torch.from_numpy(self._hostbuf).to(self._device)
        return self._data

    @data.setter
    def data(self, v) -> None:
        self._data = v
        if v is not None:
            self._device = v.device

    def host_values(self) -> np.ndarray:
        """The host copy in the device dtype (cached; the same bits as the
        device tensor) — what the out-of-core block slicer reads."""
        if self.kind == STR:
            return self._host
        if self._hostbuf is None:
            self._hostbuf = self.data.cpu().numpy()
        return self._hostbuf

    def release_device(self) -> int:
        """Drop the device tensor after making sure the host copy exists;
        returns the device bytes released (0 when nothing was on the
        device)."""
        if self.kind == STR or self._data is None:
            return 0
        self.host_values()
        freed = self._data.numel() * self._data.element_size()
        self._data = None
        return freed

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
        exact = np.asarray(arr, dtype=np.float64) if kind == TIME else None
        host = np.ascontiguousarray(np.asarray(arr, dtype=dt))
        t = torch.from_numpy(host).to(resolve(device))
        return Vec(t, kind, name=name, domain=domain, nrow=len(host),
                   host_exact=exact)

    @property
    def device(self) -> torch.device:
        return self._device

    def is_categorical(self) -> bool:
        return self.kind == CAT

    def to_numpy(self) -> np.ndarray:
        """Host copy; categorical columns come back as codes (-1 = NA), time
        columns as their exact float64 epoch milliseconds."""
        if self.kind == STR or (self.kind == TIME and self._host is not None):
            return self._host
        if self._data is None and self._hostbuf is not None:
            return self._hostbuf.copy()  # released: no upload to read it
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


def _series_to_vec(s: pd.Series, kind: str, name: str, device) -> Vec:
    kind, vals, domain = series_to_host(s, kind)
    if kind == STR:
        return Vec(vals, STR, name=name)
    return Vec.from_numpy(vals, kind, name=name, domain=domain, device=device)


class Frame:
    """Named list of aligned Vecs on one device. ``key`` names the frame
    (JAX's frame key: ``destination_frame``, else a fresh unique key);
    the port keeps no frame registry, so only a caller-given key is stable
    across processes."""

    def __init__(self, vecs: Sequence[Vec], names: Sequence[str] | None = None,
                 key: str | None = None):
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
        self.key = key or f"frame_{uuid.uuid4().hex[:12]}"

    @staticmethod
    def from_pandas(df: pd.DataFrame, column_types: Mapping[str, str] | None = None,
                    device=None, destination_frame: str | None = None
                    ) -> "Frame":
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
        return Frame(vecs, [str(c) for c in df.columns], key=destination_frame)

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

    def to_pandas(self) -> pd.DataFrame:
        """The frame on the host (JAX's ``to_pandas``): numbers as float64,
        categoricals as their labels (None for NA), time columns as
        datetimes, strings as objects."""
        out = {}
        for n, v in zip(self._names, self._vecs):
            if v.kind == STR:
                out[n] = v._host
            elif v.kind == TIME:
                out[n] = pd.to_datetime(pd.Series(v.to_numpy()), unit="ms")
            elif v.kind == CAT:
                codes = v.to_numpy()
                dom = np.asarray(v.domain, dtype=object)
                col = np.full(len(codes), None, dtype=object)
                ok = codes >= 0
                col[ok] = dom[codes[ok]]
                out[n] = col
            else:
                out[n] = v.to_numpy().astype(np.float64)
        return pd.DataFrame(out)

    def vec(self, col: int | str) -> Vec:
        return self._vecs[self._names.index(col) if isinstance(col, str) else int(col)]

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __repr__(self) -> str:
        return f"<Frame {self.nrow}x{self.ncol} {self._names[:8]}>"
