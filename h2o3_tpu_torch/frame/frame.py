"""Columnar Frame on single-device torch tensors — the port of
``h2o3_tpu/frame/frame.py`` (``Vec``, ``Frame``, ``from_pandas``). Type
inference and file reading are in ``parse.py`` (JAX's ``frame/parse.py``).

Storage follows the JAX package: numeric columns are ``float32`` with NaN
as NA, categorical columns the narrowest signed integer that holds the
domain with ``-1`` as NA, string columns stay on the host as numpy object
arrays. A time column is float32 epoch milliseconds on the device, with an
exact float64 copy on the host that ``to_numpy`` returns. Rows are not
padded: one device holds the whole column, so JAX's ``npad``, ``row_mask``
and ``_iota_mask`` (its row padding and sharding) have no counterpart.

The core frame methods (selection, ``cbind``/``rbind``, ``head``/``tail``/
``describe``, ``subset_rows``/``gather_rows`` and ``split_frame``) are here;
the Rapids-successor operators and functions are in ``frame/ops.py``, which
attaches them to :class:`Vec` and :class:`Frame` on import.
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
                 nrow: int | None = None, host_exact=None, device=None):
        self.kind = kind
        self.name = name
        self.domain = tuple(domain) if domain is not None else None
        self._hostbuf = None  # host copy in the device dtype, once asked for
        self._device = None
        if kind == STR:
            self._host = np.asarray(data, dtype=object)
            self._data = None
            # the device of the frame the strings belong to: where a
            # numeric result of a string function goes
            self._device = None if device is None else torch.device(device)
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

    def seed_host(self, buf: np.ndarray) -> None:
        """Adopt ``buf`` (the column's values in its device dtype) as the
        host copy, unless one exists (JAX's ``_seed_host_mirror``): a parse
        that already holds the values makes :meth:`host_values` free, and a
        column with no device tensor (a streamed expression's result) lives
        on the host until ``data`` is read."""
        if self.kind != STR and self._hostbuf is None:
            self._hostbuf = np.ascontiguousarray(buf)

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
            return Vec(arr, STR, name=name, device=device)
        dt, _ = Vec.device_dtype(kind, domain)
        exact = np.asarray(arr, dtype=np.float64) if kind == TIME else None
        host = np.ascontiguousarray(np.asarray(arr, dtype=dt))
        t = torch.from_numpy(host).to(resolve(device))
        return Vec(t, kind, name=name, domain=domain, nrow=len(host),
                   host_exact=exact)

    @property
    def device(self) -> torch.device:
        return self._device

    def is_numeric(self) -> bool:
        return self.kind in (NUM, INT, TIME)

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

    def mean(self) -> float:
        return self.stats()["mean"]

    def sigma(self) -> float:
        return self.stats()["sigma"]


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


_TORCH_INT = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
              np.dtype(np.int32): torch.int32}


def _series_to_vec(s: pd.Series, kind: str, name: str, device) -> Vec:
    kind, vals, domain = series_to_host(s, kind)
    if kind == STR:
        return Vec(vals, STR, name=name, device=device)
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
        for v in self._vecs:  # strings only: the device they were put with
            if v.device is not None:
                return v.device
        raise ValueError("frame has no device-resident column")

    def resident_bytes(self) -> dict:
        """Bytes of the columns' values now held on the device (``hbm``)
        and as host copies (``host``) — JAX's ``Frame.resident_bytes``; a
        lazy column not yet loaded holds none."""
        out = {"hbm": 0, "host": 0}
        for v in self._vecs:
            if v.kind == STR:
                continue
            if v._data is not None:
                out["hbm"] += v._data.numel() * v._data.element_size()
            if v._hostbuf is not None:
                out["host"] += v._hostbuf.nbytes
        return out

    @property
    def types(self) -> dict[str, str]:
        return {n: v.kind for n, v in zip(self._names, self._vecs)}

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
        return self._vecs[self._index(col)]

    def _index(self, col: int | str) -> int:
        if isinstance(col, str):
            return self._names.index(col)
        return int(col)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __repr__(self) -> str:
        return f"<Frame {self.nrow}x{self.ncol} {self._names[:8]}>"

    # -- selection (JAX's frame.py:470-515) ----------------------------------
    def __getitem__(self, sel) -> "Frame":
        """Columns by name or position: one, or a list of them. The new
        frame shares the columns (no copy)."""
        if isinstance(sel, (str, int)):
            sel = [sel]
        if isinstance(sel, (list, tuple)) and all(
                isinstance(c, (str, int)) for c in sel):
            idx = [self._index(c) for c in sel]
            return Frame([self._vecs[i] for i in idx],
                         [self._names[i] for i in idx])
        raise TypeError(f"unsupported selection {sel!r}")

    def drop(self, cols: str | Sequence[str]) -> "Frame":
        drop = {cols} if isinstance(cols, str) else set(cols)
        return self[[n for n in self._names if n not in drop]]

    def cbind(self, other: "Frame") -> "Frame":
        if other.nrow != self.nrow:
            raise ValueError("cbind: row counts differ")
        return Frame(self._vecs + other._vecs, self._names + other._names)

    def rbind(self, other: "Frame") -> "Frame":
        """Rows of ``other`` appended, on the device. Categorical columns
        take the union of the two domains (this frame's levels first, then
        ``other``'s new ones), ``other``'s codes remapped into it and every
        code stored at the width the union needs (``Vec.device_dtype``);
        time columns carry their exact float64 copies along."""
        if self._names != other._names:
            raise ValueError("rbind: column names differ")
        vecs = []
        for va, vb in zip(self._vecs, other._vecs):
            if va.kind != vb.kind:
                raise ValueError(f"rbind: kind mismatch on {va.name}")
            if va.kind == STR:
                vecs.append(Vec(np.concatenate([va._host, vb._host]), STR,
                                name=va.name, device=va.device))
                continue
            if va.kind == CAT:
                dom = list(va.domain or ())
                lut = {d: i for i, d in enumerate(dom)}
                remap = []
                for d in vb.domain or ():
                    if d not in lut:
                        lut[d] = len(dom)
                        dom.append(d)
                    remap.append(lut[d])
                dt, _ = Vec.device_dtype(CAT, dom)
                tdt = _TORCH_INT[dt]
                a = va.data.to(tdt)
                b = vb.data.long()
                if remap:
                    table = torch.tensor(remap, dtype=tdt, device=a.device)
                    b = torch.where(b >= 0, table[b.clamp(min=0)],
                                    torch.full_like(b, -1, dtype=tdt))
                vecs.append(Vec(torch.cat([a, b.to(tdt)]), CAT, name=va.name,
                                domain=dom))
                continue
            exact = None
            if va._host is not None and vb._host is not None:
                exact = np.concatenate([va._host, vb._host])
            vecs.append(Vec(torch.cat([va.data, vb.data]), va.kind,
                            name=va.name, host_exact=exact))
        return Frame(vecs, self._names)

    # -- a look at the data (JAX's frame.py:563-585) -------------------------
    def head(self, n: int = 10) -> pd.DataFrame:
        return self.to_pandas().head(n)

    def tail(self, n: int = 10) -> pd.DataFrame:
        return self.to_pandas().tail(n)

    def describe(self) -> pd.DataFrame:
        rows = []
        for n, v in zip(self._names, self._vecs):
            s = v.stats()
            rows.append({"column": n, "type": v.kind,
                         "missing": s.get("naCnt", 0), "mean": s.get("mean"),
                         "sigma": s.get("sigma"), "min": s.get("min"),
                         "max": s.get("max"),
                         "cardinality": v.cardinality if v.kind == CAT
                         else None})
        return pd.DataFrame(rows)

    # -- row selection (JAX's frame.py:588-666) ------------------------------
    def subset_rows(self, rows, key: str | None = None) -> "Frame":
        """New frame of the rows a boolean mask or an index array picks
        (negative indices count from the end, as in numpy); kinds, domains
        and the time columns' exact copies are kept. A mask or index tensor
        on the frame's device stays there (a mask costs one read, for its
        count of rows)."""
        if isinstance(rows, torch.Tensor):
            rows = rows.to(self.device)
            if rows.dtype == torch.bool:
                rows = torch.nonzero(rows).flatten()
            rows = rows.long()
            return self.gather_rows(torch.where(rows < 0, rows + self.nrow,
                                                rows), key=key)
        rows = np.asarray(rows)
        if rows.dtype == bool:
            rows = np.flatnonzero(rows)
        rows = np.where(rows < 0, rows + self.nrow, rows)
        return self.gather_rows(rows, key=key)

    def gather_rows(self, rows, valid=None, key: str | None = None
                    ) -> "Frame":
        """Output row i is input row ``rows[i]``; where ``valid`` is False
        (by default: where ``rows < 0``) it is NA: -1 in categorical
        columns, NaN in the others, None in strings. ``rows`` is a host
        array or an ``int64`` tensor on the frame's device (sort and merge
        hand theirs over without a read). The non-string columns are
        gathered on the device by one index, a batch of the columns of
        each storage dtype at a time; only string and time columns (whose
        values live on the host) read the index back."""
        dev = self.device
        if isinstance(rows, torch.Tensor):
            idx = rows.to(dev, torch.int64)
            ok = (idx >= 0) if valid is None else torch.as_tensor(
                valid, device=dev).bool()
        else:
            rows = np.asarray(rows, dtype=np.int64)
            ok_np = (rows >= 0) if valid is None else np.asarray(valid, bool)
            if ok_np.all():  # every row valid: one upload, no NA fill
                ok_np = None
                rows_np = rows
            else:
                rows_np = np.where(ok_np, rows, 0)
            idx = torch.from_numpy(np.ascontiguousarray(rows_np)).to(dev)
            ok = None if ok_np is None else torch.from_numpy(
                np.ascontiguousarray(ok_np)).to(dev)
        m = int(idx.shape[0])
        safe = idx if ok is None else torch.where(ok, idx, 0)
        out: dict[int, torch.Tensor] = {}
        by_dtype: dict[torch.dtype, list[int]] = {}
        for i, v in enumerate(self._vecs):
            if v.kind != STR:
                by_dtype.setdefault(v.data.dtype, []).append(i)
        for dt, ids in by_dtype.items():
            block = torch.stack([self._vecs[i].data for i in ids])
            g = block.index_select(1, safe)
            if ok is not None:
                fill = -1 if self._vecs[ids[0]].kind == CAT else float("nan")
                g = torch.where(ok, g, torch.full((), fill, dtype=dt,
                                                  device=dev))
            for j, i in enumerate(ids):
                out[i] = g[j]
        host_idx = host_ok = None
        if any(v.kind == STR or v._host is not None for v in self._vecs):
            host_idx = safe.cpu().numpy()
            host_ok = (np.ones(m, bool) if ok is None
                       else ok.cpu().numpy())
        vecs = []
        for i, v in enumerate(self._vecs):
            if v.kind == STR:
                col = np.full(m, None, dtype=object)
                col[host_ok] = v._host[host_idx[host_ok]]
                vecs.append(Vec(col, STR, name=v.name, device=dev))
                continue
            exact = None
            if v._host is not None:  # a time column's exact copy
                exact = np.full(m, np.nan, np.float64)
                exact[host_ok] = v._host[host_idx[host_ok]]
            vecs.append(Vec(out[i], v.kind, name=v.name, domain=v.domain,
                            nrow=m, host_exact=exact))
        return Frame(vecs, self._names, key=key)

    def split_frame(self, ratios: Sequence[float], seed: int = 1234
                    ) -> list["Frame"]:
        """Random row split (``h2o.split_frame``): JAX's uniform draw on the
        host, ``np.random.default_rng(seed).random(nrow)``, so both packages
        put the same rows, in the same order, into each part; the parts
        are gathered on the device."""
        u = np.random.default_rng(seed).random(self.nrow)
        edges = np.cumsum(list(ratios))
        if edges[-1] > 1.0 + 1e-9:
            raise ValueError("split_frame: ratios sum past 1")
        out = []
        lo = 0.0
        for e in list(edges) + ([1.0] if edges[-1] < 1.0 - 1e-9 else []):
            out.append(self.subset_rows((u >= lo) & (u < e)))
            lo = e
        return out
