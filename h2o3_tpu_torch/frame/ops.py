"""Frame operations — the port of ``h2o3_tpu/frame/ops.py``, the successor
of H2O's Rapids roster: arithmetic, comparisons, boolean and unary math,
``ifelse``, group-by aggregation, ``merge``, ``sort``, ``quantile``,
``table``, ``cut``, ``unique``, the string and time functions, ``scale``,
the cumulative ops, ``cor``/``var`` and the type conversions.

JAX computes all of this outside any Pallas kernel, so the port is plain
PyTorch on the column's device:

- elementwise operators are PyTorch ops on the float32 columns, with JAX's
  NA rules (a comparison or boolean op on NaN gives NaN; enum codes enter
  as floats with NA as NaN); under ``H2O3_TPU_MUNGE_FUSE`` (on by default)
  they and ``ifelse`` return a deferred ``frame/lazy.LazyExprVec`` that
  evaluates the whole chain on first use with these same calls;
- group-by finds its groups on the device (each key's rank in its sort
  order, the rows lexsorted by those ranks and numbered by tuple, the
  routine that also gives ``merge`` and ``rank_within_group_by`` their
  tuple ids) and computes
  count, sum, sum of squares, NA count, min and max of every value column
  of one ``agg`` call in one pass (``index_add_`` and ``scatter_reduce_``),
  as JAX's default lane does (``munge.groupby_stats``), the pass streamed
  through the out-of-core window when one is set and the columns pass it
  (``munge.groupby_stats_streamed``);
- ``merge`` and ``sort`` on numeric and enum keys stay on the device from
  the key codes to the gathered payload: stable sorts, ``searchsorted``
  and ``repeat_interleave``, the output size the one value read back;
- ``quantile`` sorts on the device and reads only the elements its
  probabilities index.

Steps that JAX runs on the host stay on the host here too, each marked
with the JAX lines it follows: string and time functions, the host
aggregations (median, mode, first, last), string and time join and sort
keys, ``table``, ``unique``, ``cut``, ``cor``/``var`` in float64 and the
cumulative ops. JAX's multi-device lanes (the radix ``all_to_all`` join,
``_exchange_gids``) are ROADMAP Queue A 8.

Importing this module attaches the operators and methods to
:class:`Vec` and :class:`Frame` (``h2o3_tpu_torch/__init__`` does).
"""

from __future__ import annotations

import re
import warnings
from typing import Mapping, Sequence

import numpy as np
import pandas as pd
import torch

from h2o3_tpu_torch.device import resolve
from h2o3_tpu_torch.frame.frame import CAT, INT, NUM, STR, TIME, Frame, Vec

_F32 = torch.float32


def _device_of(v: Vec) -> torch.device:
    """Where a result of ``v`` goes: its device (a string column keeps the
    device of the frame it came from), else the entry points' default."""
    return v.device if v.device is not None else resolve(None)


def _host_vec(arr, kind: str, like: Vec, name: str = "", domain=None) -> Vec:
    """A host array as a Vec on ``like``'s device."""
    return Vec.from_numpy(arr, kind, name=name, domain=domain,
                          device=_device_of(like))


def _frame(df: pd.DataFrame, like, column_types=None) -> Frame:
    """A host table as a Frame on the device of ``like`` (a Vec or Frame)."""
    dev = like.device if isinstance(like, Frame) else _device_of(like)
    return Frame.from_pandas(df, column_types, device=dev)


def _scalar(x, dev) -> torch.Tensor:
    return torch.full((), float(x), dtype=_F32, device=dev)


# ---------------------------------------------------------------------------
# elementwise operators (JAX's ops.py:37-228)
# ---------------------------------------------------------------------------


def _flag(t: torch.Tensor) -> torch.Tensor:
    return t.to(_F32)


_BINOPS = {
    "+": torch.add,
    "-": torch.sub,
    "*": torch.mul,
    "/": torch.div,
    "//": lambda a, b: torch.floor(a / b),
    "%": torch.remainder,  # the sign of the divisor, as jnp.mod
    "**": torch.pow,
    "==": lambda a, b: _flag(a == b),
    "!=": lambda a, b: _flag(a != b),
    "<": lambda a, b: _flag(a < b),
    "<=": lambda a, b: _flag(a <= b),
    ">": lambda a, b: _flag(a > b),
    ">=": lambda a, b: _flag(a >= b),
    "&": lambda a, b: _flag((a != 0) & (b != 0)),
    "|": lambda a, b: _flag((a != 0) | (b != 0)),
    "min": torch.minimum,
    "max": torch.maximum,
}


def _digamma(x: torch.Tensor) -> torch.Tensor:
    # JAX's digamma is NaN at 0 and the negative integers (PyTorch: -inf
    # at 0)
    pole = (x <= 0) & (x == torch.floor(x))
    return torch.where(pole, float("nan"), torch.digamma(x))


_UNOPS = {
    "abs": torch.abs,
    "sign": lambda x: torch.where(torch.isnan(x), x, torch.sign(x)),
    "sqrt": torch.sqrt,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log1p": torch.log1p,
    "log2": torch.log2,
    "log10": torch.log10,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,  # half to even, as jnp.round
    "trunc": torch.trunc,
    "cos": torch.cos,
    "sin": torch.sin,
    "tan": torch.tan,
    "acos": torch.acos,
    "asin": torch.asin,
    "atan": torch.atan,
    "cosh": torch.cosh,
    "sinh": torch.sinh,
    "tanh": torch.tanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "lgamma": torch.lgamma,
    "digamma": _digamma,
    "not": lambda x: _flag(x == 0),
    "isna": lambda x: _flag(torch.isnan(x)),
}

# NA semantics (JAX's ops.py:87-105): comparisons and boolean ops on a NaN
# input give NaN (H2O's NA), and so does ``not``
_PRESERVE_NAN = {"==", "!=", "<", "<=", ">", ">=", "&", "|"}


def _binop_kernel(a, b, op: str) -> torch.Tensor:
    out = _BINOPS[op](a, b)
    if op in _PRESERVE_NAN:
        out = torch.where(torch.isnan(a) | torch.isnan(b), float("nan"), out)
    return out.to(_F32)


def _unop_kernel(a, op: str) -> torch.Tensor:
    out = _UNOPS[op](a)
    if op == "not":
        out = torch.where(torch.isnan(a), float("nan"), out)
    return out.to(_F32)


def _codes_as_float(codes: torch.Tensor) -> torch.Tensor:
    """Enum codes as float32 with the NA code (-1) as NaN (ops.py:109)."""
    return torch.where(codes < 0, float("nan"), codes.to(_F32))


def _as_device(x, like: Vec) -> torch.Tensor:
    """An operand as a float32 tensor on ``like``'s device: a column, a
    one-column frame, or a scalar (a 0-d tensor that broadcasts)."""
    if isinstance(x, Vec):
        if x.kind == STR:
            raise TypeError("arithmetic on string columns is not supported")
        if x.nrow != like.nrow:
            raise ValueError("operand row counts differ")
        return _codes_as_float(x.data) if x.kind == CAT else x.data
    if isinstance(x, Frame):
        if x.ncol != 1:
            raise ValueError("frame operand must have exactly one column")
        return _as_device(x.vec(0), like)
    return _scalar(x, _device_of(like))


def fuse_on() -> bool:
    """``H2O3_TPU_MUNGE_FUSE``, read at each call: elementwise operators
    defer into expression graphs (``frame/lazy.py``) and group-by streams
    through the out-of-core window."""
    from h2o3_tpu_torch import config

    return config.get_bool("H2O3_TPU_MUNGE_FUSE")


def _binop(a: Vec, b, op: str, reflected: bool = False) -> Vec:
    if isinstance(b, str):
        return _binop_str(a, b, op)
    cross_enum = (isinstance(b, Vec) and a.kind == CAT and b.kind == CAT
                  and a.domain != b.domain)
    if not cross_enum and fuse_on():
        from h2o3_tpu_torch.frame import lazy

        bb = b.vec(0) if isinstance(b, Frame) and b.ncol == 1 else b
        if lazy.fusible_operand(a) and lazy.fusible_operand(bb):
            return lazy.defer_binop(a, bb, op, reflected)
    if cross_enum:
        # enums of different domains compare by label (ops.py:147-160):
        # b's codes move into a's code space, b's labels that a lacks to
        # codes past a's domain that match nothing
        if op not in ("==", "!="):
            raise TypeError(
                "ordering comparisons between enums with different domains")
        adom = list(a.domain or ())
        lut = {d: i for i, d in enumerate(adom)}
        remap = [lut.get(d, len(adom) + j) for j, d in enumerate(b.domain or ())]
        db = _level_values(b, remap)
        return Vec(_binop_kernel(_codes_as_float(a.data), db, op), NUM,
                   nrow=a.nrow)
    da = _as_device(a, a)
    db = _as_device(b, a)
    out = _binop_kernel(db, da, op) if reflected else _binop_kernel(da, db, op)
    return Vec(out, NUM, nrow=a.nrow)


def _binop_str(a: Vec, s: str, op: str) -> Vec:
    """``frame['col'] == 'level'`` (ops.py:167): an enum compares its codes
    with the level's (no such level: 0 everywhere, NA stays NaN); a string
    column compares on the host, where its values are."""
    if op not in ("==", "!="):
        raise TypeError(
            f"operator {op!r} not supported between a column and a string")
    if a.kind == CAT:
        dom = a.domain or ()
        code = dom.index(s) if s in dom else -2
        out = _binop_kernel(_codes_as_float(a.data),
                            _scalar(code, a.device), op)
        return Vec(out, NUM, nrow=a.nrow)
    if a.kind == STR:
        eq = np.array([np.nan if v is None else float(v == s)
                       for v in a.to_numpy()], dtype=np.float64)
        if op == "!=":
            eq = 1.0 - eq
        return _host_vec(eq, NUM, a, name=a.name)
    raise TypeError(f"cannot compare a {a.kind} column to a string")


def _unop(a: Vec, op: str) -> Vec:
    if fuse_on():
        from h2o3_tpu_torch.frame import lazy

        if lazy.fusible_operand(a):
            return lazy.defer_unop(a, op)
    return Vec(_unop_kernel(_as_device(a, a), op), NUM, nrow=a.nrow)


def _select(t, y, n) -> torch.Tensor:
    out = torch.where(t != 0, y, n)
    return torch.where(torch.isnan(t), float("nan"), out).to(_F32)


def ifelse(test: Vec, yes, no) -> Vec:
    """``ASTIfElse``: ``yes`` where ``test`` is non-zero, else ``no``; NA
    where ``test`` is NA (ops.py:207)."""
    if isinstance(test, Frame):
        test = test.vec(0)
    if fuse_on():
        from h2o3_tpu_torch.frame import lazy

        yy = yes.vec(0) if isinstance(yes, Frame) and yes.ncol == 1 else yes
        nn = no.vec(0) if isinstance(no, Frame) and no.ncol == 1 else no
        if all(lazy.fusible_operand(x) for x in (test, yy, nn)):
            return lazy.defer_ifelse(test, yy, nn)
    out = _select(_as_device(test, test), _as_device(yes, test),
                  _as_device(no, test))
    return Vec(out, NUM, nrow=test.nrow)


# ---------------------------------------------------------------------------
# cumulative ops, diff, fillna — host prefix passes in float64, as JAX's
# (ops.py:240-282)
# ---------------------------------------------------------------------------

_CUMOPS = ("cumsum", "cumprod", "cummin", "cummax")


def _cumulative(v: Vec, op: str) -> Vec:
    vals = v.to_numpy().astype(np.float64)
    out = {"cumsum": np.cumsum, "cumprod": np.cumprod,
           "cummin": np.minimum.accumulate,
           "cummax": np.maximum.accumulate}[op](vals)
    return _host_vec(out, NUM, v)


def diff_lag1(v: Vec) -> Vec:
    """``ASTDiffLag1``: x[i] - x[i-1], NA in row 0."""
    vals = v.to_numpy().astype(np.float64)
    return _host_vec(np.diff(vals, prepend=np.nan), NUM, v)


def fillna(v: Vec, method: str = "forward", maxlen: int = 0) -> Vec:
    """``h2o.fillna`` (axis 0): the last (or next) observed value carried
    into NA runs, at most ``maxlen`` rows when it is positive."""
    if method not in ("forward", "backward"):
        raise ValueError(
            f"fillna method must be forward/backward, got {method!r}")
    if not v.is_numeric():
        raise ValueError(f"fillna supports numeric/time columns, not {v.kind}")
    vals = v.to_numpy().astype(np.float64)
    if method == "backward":
        vals = vals[::-1]
    idx = np.arange(len(vals))
    last = np.maximum.accumulate(np.where(~np.isnan(vals), idx, -1))
    ok = last >= 0
    if maxlen and maxlen > 0:
        ok &= (idx - last) <= maxlen
    out = np.where(ok, vals[np.maximum(last, 0)], np.nan)
    if method == "backward":
        out = out[::-1]
    return _host_vec(out, v.kind, v, name=v.name)  # a time column stays time


# ---------------------------------------------------------------------------
# group-by — ``ASTGroup`` (JAX's ops.py:290-440, munge.py:154-240)
# ---------------------------------------------------------------------------


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in the order of the float32 values, -0 equal to +0 and
    every NaN equal and after +inf (IEEE bits with the negative half
    flipped), so stable integer sorts and ``unique`` order floats the way
    JAX's and pandas' sorts do, on any device."""
    x = x.to(_F32)
    x = torch.where(x == 0, 0.0, x)
    x = torch.where(torch.isnan(x), float("nan"), x)
    b = x.view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).long()


def _first_rows(gid: torch.Tensor, ngroups: int) -> torch.Tensor:
    """The first row of each group, by a scatter of row indices."""
    n = gid.shape[0]
    rows = torch.arange(n, device=gid.device)
    return torch.full((ngroups,), n, dtype=torch.int64,
                      device=gid.device).scatter_reduce_(
        0, gid, rows, "amin", include_self=True)


def _lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """Stable multi-key order, ``keys[0]`` the primary: stable sorts
    chained from the last key to the first (PyTorch has no lexsort)."""
    order = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _dense_ids(keys: list[torch.Tensor], n_id: int | None = None):
    """The rows in the stable order of integer keys (``keys[0]`` the
    primary) and dense ids of the tuples of the first ``n_id`` keys (all
    by default), numbered in that order: equal tuples, equal ids. Returns
    ``(ids, order, new)``, ``new`` marking the sorted positions where a
    tuple starts. Group-by's factorization, the join's tuple ids
    (ops.py:496) and the groups of ``rank_within_group_by`` all come from
    here."""
    order = _lexsort(keys)
    n = order.shape[0]
    new = torch.zeros(n, dtype=torch.bool, device=order.device)
    if n:
        new[0] = True
    id_keys = keys if n_id is None else keys[:n_id]
    if id_keys and n > 1:
        s = torch.stack(id_keys, dim=1)[order]
        new[1:] = (s[1:] != s[:-1]).any(dim=1)
    ids = torch.empty_like(order).scatter_(0, order, torch.cumsum(new, 0) - 1)
    return ids, order, new


def _key_labels(v: Vec, codes: np.ndarray) -> np.ndarray:
    """Host key values as JAX's factorization sees them (ops.py:323-332):
    an enum's labels with None for NA, numbers in float32."""
    if v.kind == CAT:
        dom = np.asarray(list(v.domain or ()) + [None], dtype=object)
        return dom[codes]
    return codes


class GroupBy:
    """``frame.group_by(cols).agg(...)`` — ``ASTGroup``.

    Groups come in the order of pandas' ``factorize(sort=True)`` over the
    key tuples, as in JAX: a single key drops its NA rows; with several
    keys an NA is a value that sorts after every other of its key.
    Numeric and enum keys are factorized on the device: each key's rank
    in its sort order (an enum's by label), the rows lexsorted by those
    ranks and numbered by tuple (:func:`_dense_ids`); the keys of each
    group are read back from the group's first row. String and time keys
    take JAX's pandas factorization on the host (their values live
    there)."""

    _DEV_AGGS = ("count", "nrow", "sum", "mean", "min", "max", "var", "sd",
                 "sumsq")

    def __init__(self, frame: Frame, by: Sequence[str] | str):
        self.frame = frame
        self.by = [by] if isinstance(by, str) else list(by)
        vs = [frame.vec(b) for b in self.by]
        if any(v.kind in (STR, TIME) for v in vs):
            self._factorize_host(vs)
        else:
            self._factorize_device(vs)

    def _factorize_host(self, vs) -> None:
        # JAX's ops.py:323-337
        cols = [v.to_numpy() if v.kind != CAT else _key_labels(v, v.to_numpy())
                for v in vs]
        keys = (pd.MultiIndex.from_arrays(cols) if len(cols) > 1
                else pd.Index(cols[0]))
        codes, uniques = pd.factorize(keys, sort=True)
        self._uniques = uniques
        self._ngroups = len(uniques)
        self.gid = torch.from_numpy(codes.astype(np.int64)).to(
            self.frame.device)

    def _factorize_device(self, vs) -> None:
        dev = self.frame.device
        ranks = []
        for v in vs:
            if v.kind == CAT:
                dom = list(v.domain or ())
                order = sorted(range(len(dom)), key=dom.__getitem__)
                rank = np.empty(len(dom) + 1, np.int64)
                rank[order] = np.arange(len(dom))
                rank[-1] = len(dom)  # NA sorts after every label
                table = torch.from_numpy(rank).to(dev)
                codes = v.data.long()
                ranks.append(table[torch.where(codes >= 0, codes, len(dom))])
            else:
                ranks.append(_order_key(v.data))  # NaN after every number
        gid, _, new = _dense_ids(ranks)
        ngroups = int(new.sum())
        first = _first_rows(gid, ngroups)
        keys = [_key_labels(v, v.data[first].cpu().numpy()) if v.kind == CAT
                else v.data[first].cpu().numpy() for v in vs]
        if len(vs) == 1 and ngroups:
            last = keys[0][-1]
            if last is None or (vs[0].kind != CAT and np.isnan(last)):
                # a single key drops its NA group
                ngroups -= 1
                keys[0] = keys[0][:-1]
                gid = torch.where(gid == ngroups, -1, gid)
        if len(vs) == 1:
            self._uniques = pd.Index(keys[0])
        else:
            self._uniques = pd.MultiIndex.from_arrays(keys)
        self._ngroups = ngroups
        self.gid = gid

    def _stats(self, cols: list[str]) -> list[dict]:
        """Count, sum, sum of squares, NA count, min and max of every
        column in ``cols`` per group, in one pass over the rows and one
        read of the result (JAX's ``munge._segment_stats_local``); under
        ``H2O3_TPU_MUNGE_FUSE`` with the out-of-core window set and the
        columns over it, the pass runs block by block through a
        ``ChunkStore`` (JAX's ``munge.groupby_stats_streamed``)."""
        vs = [self.frame.vec(c) for c in cols]
        acc = _GroupStats(self._ngroups, len(vs), self.frame.device)
        if not (fuse_on() and _group_stats_streamed(acc, self.gid, vs)):
            acc.add(self.gid, torch.stack(
                [_codes_as_float(v.data) if v.kind == CAT else v.data
                 for v in vs], dim=1))
        return acc.read()

    def agg(self, spec: Mapping[str, Sequence[str] | str]) -> Frame:
        G = self._ngroups
        items = [(c, [a] if isinstance(a, str) else list(a))
                 for c, a in spec.items()]
        dev_cols = [c for c, aggs in items
                    if any(a in self._DEV_AGGS for a in aggs)]
        stats = {}
        if dev_cols:
            if G:
                stats = dict(zip(dev_cols, self._stats(dev_cols)))
            else:
                empty = np.zeros(0, np.float32)
                stats = {c: dict.fromkeys(("nrow", "sum", "sumsq", "nacnt",
                                           "min", "max"), empty)
                         for c in dev_cols}
        out_cols: dict[str, np.ndarray] = {}
        if len(self.by) == 1:
            out_cols[self.by[0]] = np.asarray(self._uniques)
        else:
            for i, b in enumerate(self.by):
                out_cols[b] = np.asarray(self._uniques.get_level_values(i))
        host_groups = None
        for col, aggs in items:
            v = self.frame.vec(col)
            st = stats.get(col)
            for a in aggs:
                name = f"{a}_{col}"
                if a in ("count", "nrow"):
                    out_cols[name] = st["nrow"] + st["nacnt"]
                elif a in ("sum", "sumsq", "min", "max"):
                    out_cols[name] = st[a]
                elif a == "mean":
                    out_cols[name] = st["sum"] / np.maximum(st["nrow"], 1)
                elif a in ("var", "sd"):
                    n = st["nrow"]
                    m = st["sum"] / np.maximum(n, 1)
                    var = (st["sumsq"] - n * m * m) / np.maximum(n - 1, 1)
                    var = np.maximum(var, 0.0)
                    out_cols[name] = np.sqrt(var) if a == "sd" else var
                elif a in ("median", "mode", "first", "last"):
                    if host_groups is None:
                        host_groups = self._host_groups()
                    out_cols[name] = _host_agg(v, a, host_groups)
                else:
                    raise ValueError(f"unknown aggregation {a!r}")
        return _frame(pd.DataFrame(out_cols), self.frame)

    def _host_groups(self) -> list[np.ndarray]:
        """Each group's rows in frame order, on the host: what JAX's
        ``vals[self._gid == g]`` selects."""
        gid = self.gid.cpu().numpy()
        order = np.argsort(gid, kind="stable")
        bounds = np.searchsorted(gid[order], np.arange(self._ngroups + 1))
        return [order[bounds[g]: bounds[g + 1]]
                for g in range(self._ngroups)]


class _GroupStats:
    """Per-group sums (count, sum, sum of squares and NA count of each
    column), minima and maxima, accumulated over row blocks in row order,
    so that blocks give the bits of one pass where the adds are ordered
    (the CPU)."""

    def __init__(self, G: int, C: int, dev):
        self.G, self.C = G, C
        inf = float("inf")
        self.sums = torch.zeros((G, 4 * C), dtype=_F32, device=dev)
        self.mn = torch.full((G, C), inf, dtype=_F32, device=dev)
        self.mx = torch.full((G, C), -inf, dtype=_F32, device=dev)

    def add(self, gid: torch.Tensor, X: torch.Tensor) -> None:
        """Rows with group ids ``gid`` (-1: no group) and values ``X``
        (rows, C) float32."""
        n, C = X.shape
        keyed = (gid >= 0)[:, None]
        g = torch.where(gid >= 0, gid, 0).long()
        nan = torch.isnan(X)
        ok = keyed & ~nan
        xz = torch.where(ok, X, 0.0)
        self.sums.index_add_(0, g, torch.cat(
            [ok.to(_F32), xz, xz * xz, (nan & keyed).to(_F32)], dim=1))
        gi = g[:, None].expand(n, C)
        inf = float("inf")
        self.mn.scatter_reduce_(0, gi, torch.where(ok, X, inf), "amin")
        self.mx.scatter_reduce_(0, gi, torch.where(ok, X, -inf), "amax")

    def read(self) -> list[dict]:
        """The stats of each column as host arrays, in one read."""
        G, C = self.G, self.C
        host = torch.cat([self.sums.T.reshape(-1), self.mn.T.reshape(-1),
                          self.mx.T.reshape(-1)]).cpu().numpy()
        s = host[: 4 * C * G].reshape(4, C, G)
        mn = host[4 * C * G: 5 * C * G].reshape(C, G)
        mx = host[5 * C * G:].reshape(C, G)
        return [{"nrow": s[0, i], "sum": s[1, i], "sumsq": s[2, i],
                 "nacnt": s[3, i], "min": mn[i], "max": mx[i]}
                for i in range(C)]


# group-by passes streamed through the out-of-core window (JAX counts them
# as munge_dispatches_total{op=groupby_stream})
GROUPBY_EVENTS = {"streamed": 0}


def _group_stats_streamed(acc: _GroupStats, gid: torch.Tensor, vs) -> bool:
    """Add the rows into ``acc`` block by block through a ``ChunkStore``:
    the group ids and each column's host copy (enum codes as float32 with
    NA as NaN, as JAX's ``GroupBy.agg``) are its lanes, padded to the
    block quantum with rows of no group. False, with nothing added, when
    no window is set or the lanes fit it."""
    from h2o3_tpu_torch.frame import chunkstore as cs

    n, C = int(gid.shape[0]), len(vs)
    npad = cs.pad_rows(n)
    store = cs.ChunkStore.plan(npad, 4.0 * (C + 1), device=gid.device)
    if store is None:
        return False
    try:
        g = np.full(npad, -1, np.int32)
        g[:n] = gid.cpu().numpy()
        store.add("gid", g)
        names = ["gid"]
        for i, v in enumerate(vs):
            hv = v.host_values()
            x = np.full(npad, np.nan, np.float32)
            x[:n] = (np.where(hv < 0, np.nan, hv.astype(np.float32))
                     if v.kind == CAT else hv)
            names.append(f"x{i}")
            store.add(names[-1], x)
        for _, blk in store.stream(names):
            acc.add(blk["gid"], torch.stack([blk[k] for k in names[1:]],
                                            dim=1))
    finally:
        store.close()
    GROUPBY_EVENTS["streamed"] += 1
    return True


def _host_agg(v: Vec, a: str, groups: list[np.ndarray]) -> np.ndarray:
    """median, mode, first and last of each group on the host, as JAX
    computes them (ops.py:416-433)."""
    vals = v.to_numpy()
    if v.kind == CAT:  # the NA code -1 as NaN
        vals = np.where(vals < 0, np.nan, vals.astype(np.float64))
    out = np.full(len(groups), np.nan)
    for g, rows in enumerate(groups):
        gv = vals[rows]
        if a in ("median", "mode"):
            gv = gv[~pd.isna(gv)]
            if len(gv):
                out[g] = (np.median(gv) if a == "median"
                          else pd.Series(gv).mode().iloc[0])
        elif len(gv):
            out[g] = gv[0] if a == "first" else gv[-1]
    return out


def group_by(frame: Frame, by) -> GroupBy:
    return GroupBy(frame, by)


# ---------------------------------------------------------------------------
# merge / sort — ``ASTMerge`` and ``ASTSort`` (JAX's ops.py:458-757)
# ---------------------------------------------------------------------------


def _domain_union(dom_a, dom_b) -> list:
    """Union of two enum domains, a's order first (ops.py:458)."""
    union = list(dom_a or ())
    seen = set(union)
    return union + [d for d in (dom_b or ()) if d not in seen]


def _level_values(v: Vec, per_level, fill=float("nan"), dtype=_F32
                  ) -> torch.Tensor:
    """One value per level of enum ``v``, looked up by its codes on the
    device; ``fill`` where the code is NA."""
    codes = v.data.long()
    if not len(per_level):
        return torch.full(codes.shape, fill, dtype=dtype, device=codes.device)
    table = torch.tensor(list(per_level), dtype=dtype).to(codes.device)
    return torch.where(codes >= 0, table[codes.clamp(min=0)],
                       torch.full((), fill, dtype=dtype, device=codes.device))


def _key_codes(v: Vec, union_pos: dict | None = None):
    """(nrow,) int32 codes of one numeric or enum key on the device
    (ops.py:467-493): equal values, equal codes; NA its own code (-1 for an
    enum, the canonical NaN's bits for a number), so NA matches NA. An enum
    takes its position in ``union_pos`` (a join matches labels); a number
    its float32 bits once -0 is +0 and every NaN the same NaN. None for
    string and time keys (the host path)."""
    if v.kind in (STR, TIME):
        return None
    if v.kind == CAT:
        if union_pos is None:
            return v.data.to(torch.int32)
        return _level_values(v, [union_pos[d] for d in v.domain or ()],
                             fill=-1, dtype=torch.int32)
    x = v.data.to(_F32)
    x = torch.where(x == 0, 0.0, x)
    x = torch.where(torch.isnan(x), float("nan"), x)
    return x.view(torch.int32)


def _tuple_gids(cols_l, cols_r):
    """Dense ids for key tuples across both sides (ops.py:496): equal
    tuples, equal ids. One key's codes are ids already."""
    if len(cols_l) == 1:
        return cols_l[0], cols_r[0]
    n_l = cols_l[0].shape[0]
    gid = _dense_ids([torch.cat([a, b]) for a, b in zip(cols_l, cols_r)])[0]
    return gid[:n_l], gid[n_l:]


def _merge_keys_device(left: Frame, right: Frame, bx, bby):
    """The two sides' tuple ids on the device, or None when a key needs
    the host path (ops.py:534: string, time, or enum against number)."""
    cols_l, cols_r = [], []
    for cl, cr in zip(bx, bby):
        vl, vr = left.vec(cl), right.vec(cr)
        if vl.kind == CAT or vr.kind == CAT:
            if not (vl.kind == CAT and vr.kind == CAT):
                return None
            pos = {d: i for i, d in enumerate(
                _domain_union(vl.domain, vr.domain))}
            kl, kr = _key_codes(vl, pos), _key_codes(vr, pos)
        else:
            kl, kr = _key_codes(vl), _key_codes(vr)
        if kl is None or kr is None:
            return None
        cols_l.append(kl)
        cols_r.append(kr)
    return _tuple_gids(cols_l, cols_r)


def _join_rows(gl, gr, all_x: bool, all_y: bool):
    """(li, ri) int64 row vectors of the join on the device, and the count
    of unmatched right rows appended (ops.py:513-531 and
    ``munge.join_expand``): the sort-merge statistics by a stable sort of
    the right ids and ``searchsorted``, expanded by ``repeat_interleave``.
    Rows come in JAX's order: left-major match groups, right-frame order
    inside a group, then (right and outer joins) the unmatched right rows
    in right-frame order. The output size is the one value read."""
    dev = gl.device
    n_l, n_r = gl.shape[0], gr.shape[0]
    rorder = torch.argsort(gr, stable=True)
    rs = gr[rorder].contiguous()
    lo = torch.searchsorted(rs, gl)
    m = torch.searchsorted(rs, gl, right=True) - lo
    m_out = m.clamp(min=1) if all_x else m
    unmatched = None
    counts = [m_out.sum()]
    if all_y:
        ls = torch.sort(gl).values
        pos = torch.searchsorted(ls, gr)
        hit = ls[pos.clamp(max=max(n_l - 1, 0))] == gr if n_l else \
            torch.zeros_like(gr, dtype=torch.bool)
        unmatched = ~((pos < n_l) & hit)
        counts.append(unmatched.sum())
    sizes = torch.stack(counts).tolist()
    total = int(sizes[0])
    n_extra = int(sizes[1]) if all_y else 0
    li = torch.repeat_interleave(torch.arange(n_l, device=dev), m_out,
                                 output_size=total)
    start = torch.cumsum(m_out, 0) - m_out
    within = torch.arange(total, device=dev) - start[li]
    if n_r:
        rpos = (lo[li] + within).clamp(max=n_r - 1)
        ri = torch.where(m[li] > 0, rorder[rpos], -1)
    else:
        ri = torch.full((total,), -1, dtype=torch.int64, device=dev)
    if n_extra:
        extra = torch.argsort(unmatched.logical_not().to(torch.uint8),
                              stable=True)[:n_extra]
        li = torch.cat([li, torch.full((n_extra,), -1, dtype=torch.int64,
                                       device=dev)])
        ri = torch.cat([ri, extra])
    return li, ri, n_extra


def _join_rows_host(left, right, bx, bby, all_x, all_y):
    """JAX's pandas join (ops.py:648-670) for string, time and mixed keys:
    their values live on the host, or their codes do not compare."""
    how = ("outer" if (all_x and all_y) else "left" if all_x
           else "right" if all_y else "inner")

    def key_col(v):
        x = v.to_numpy()
        if v.kind == CAT:  # join on labels: codes are frame-local
            dom = np.asarray(list(v.domain or ()) + [None], dtype=object)
            return dom[np.where(x >= 0, x, len(dom) - 1).astype(np.int64)]
        return x

    lk = pd.DataFrame({c: key_col(left.vec(c)) for c in bx})
    rk = pd.DataFrame({c: key_col(right.vec(c)) for c in bby})
    lk["__li__"] = np.arange(left.nrow, dtype=np.int64)
    rk["__ri__"] = np.arange(right.nrow, dtype=np.int64)
    j = lk.merge(rk, left_on=bx, right_on=bby, how=how, suffixes=("", "__rk"))
    li, ri = j["__li__"].to_numpy(), j["__ri__"].to_numpy()
    lvalid, rvalid = ~pd.isna(li), ~pd.isna(ri)
    li = np.where(lvalid, li, -1).astype(np.int64)
    ri = np.where(rvalid, ri, -1).astype(np.int64)
    dev = left.device
    return (torch.from_numpy(li).to(dev), torch.from_numpy(ri).to(dev),
            int((~lvalid).sum()))


def merge(left: Frame, right: Frame, by: Sequence[str] | None = None,
          by_x: Sequence[str] | None = None, by_y: Sequence[str] | None = None,
          all_x: bool = False, all_y: bool = False) -> Frame:
    """``h2o.merge``: inner, left (``all_x``), right (``all_y``) or outer
    join on the named keys (the shared column names by default). Numeric
    and enum keys join on the device and the payload is gathered there;
    the output keeps the left key columns, filled from the right keys on
    right-only rows, then the right frame's other columns (``_y`` on a
    clash of names)."""
    bx = list(by_x or by or [n for n in left.names if n in set(right.names)])
    bby = list(by_y or by or bx)
    dev = _merge_keys_device(left, right, bx, bby)
    if dev is not None:
        li, ri, n_extra = _join_rows(dev[0], dev[1], all_x, all_y)
    else:
        li, ri, n_extra = _join_rows_host(left, right, bx, bby, all_x, all_y)
    lvalid = li >= 0
    lg = left.gather_rows(li)
    rcols = [n for n in right.names if n not in set(bby)]
    rg = right[rcols].gather_rows(ri) if rcols else None
    out_vecs, out_names = [], []
    for n in lg.names:
        v = lg.vec(n)
        if n in bx and n_extra:  # ops.py:672-684
            patched = right[[bby[bx.index(n)]]].gather_rows(ri).vec(0)
            v = _coalesce_vec(v, patched, lvalid)
        out_vecs.append(v)
        out_names.append(n)
    if rg is not None:
        taken = set(out_names)
        for n in rg.names:
            out_vecs.append(rg.vec(n))
            out_names.append(n + "_y" if n in taken else n)
    return Frame(out_vecs, out_names)


def _coalesce_vec(a: Vec, b: Vec, use_a: torch.Tensor) -> Vec:
    """``a`` where ``use_a``, else ``b`` — a join key's right-only rows
    (ops.py:696). Enums of different domains move to the union."""
    if a.kind == STR:
        keep = use_a.cpu().numpy()
        out = a._host.copy()
        out[~keep] = b._host[~keep]
        return Vec(out, STR, name=a.name, device=a.device)
    if a.kind == CAT and tuple(a.domain or ()) != tuple(b.domain or ()):
        dom = _domain_union(a.domain, b.domain)
        pos = {d: i for i, d in enumerate(dom)}
        dt, _ = Vec.device_dtype(CAT, dom)
        tdt = getattr(torch, dt.name)
        bcodes = _level_values(b, [pos[d] for d in b.domain or ()], fill=-1,
                               dtype=tdt)
        return Vec(torch.where(use_a, a.data.to(tdt), bcodes), CAT,
                   name=a.name, domain=tuple(dom))
    exact = None
    if a._host is not None and b._host is not None:
        exact = np.where(use_a.cpu().numpy(), a._host, b._host)
    return Vec(torch.where(use_a, a.data, b.data), a.kind, name=a.name,
               domain=a.domain, nrow=a.nrow, host_exact=exact)


def sort(frame: Frame, by: Sequence[str] | str,
         ascending: bool | Sequence[bool] = True) -> Frame:
    """Rows ordered by the keys (``ASTSort``, ops.py:727), stable. Numeric
    and enum keys sort on the device with no read: NaN last in either
    direction, an enum by its code with NA first ascending and, as JAX
    negates a descending key, last descending. String and time keys sort
    on the host with pandas, as in JAX."""
    by = [by] if isinstance(by, str) else list(by)
    asc = ([ascending] * len(by) if isinstance(ascending, bool)
           else list(ascending))
    vs = [frame.vec(b) for b in by]
    if all(v.kind not in (STR, TIME) for v in vs):
        keys = []
        for v, a in zip(vs, asc):
            k = v.data.to(_F32)
            keys.append(_order_key(k if a else -k))
        return frame.gather_rows(_lexsort(keys))
    df = pd.DataFrame({b: frame.vec(b).to_numpy() for b in by})
    order = df.sort_values(by=by, ascending=asc, kind="stable").index
    return frame.gather_rows(order.to_numpy())


# ---------------------------------------------------------------------------
# quantile / table / unique / match / which / na_omit (ops.py:770-924)
# ---------------------------------------------------------------------------

_PROBS = (0.001, 0.01, 0.1, 0.25, 0.333, 0.5, 0.667, 0.75, 0.9, 0.99, 0.999)


def quantile(frame_or_vec, prob: Sequence[float] = _PROBS,
             weights: Vec | None = None) -> Frame:
    """``h2o.quantile`` (interpolation type 7). Unweighted: each column is
    sorted on the device (NaN last) and only the elements the
    probabilities index are read back; the interpolation is JAX's, in
    float64 on the host. ``weights`` takes JAX's weighted branch on the
    host in float64: observation-count weights (integer weights give the
    quantiles of the replicated rows), so a rescaling of the weights
    changes the result."""
    if isinstance(frame_or_vec, Vec):
        vecs = [frame_or_vec]
        like = frame_or_vec
    else:
        vecs = [frame_or_vec.vec(n) for n in frame_or_vec.names
                if frame_or_vec.vec(n).is_numeric()]
        like = frame_or_vec
    probs = np.asarray(prob, dtype=np.float64)
    out = {"Probs": probs}
    if weights is None:
        if vecs:
            srt = [torch.sort(v.data).values for v in vecs]
            cnts = torch.stack([(~torch.isnan(v.data)).sum()
                                for v in vecs]).tolist()
            picks, spans = [], []
            for s, c in zip(srt, cnts):
                idx = (c - 1) * probs
                lo = np.floor(idx).astype(np.int64)
                hi = np.minimum(np.ceil(idx).astype(np.int64), c - 1)
                spans.append((idx, lo))
                if c:
                    picks.append(s[torch.from_numpy(
                        np.concatenate([lo, hi])).to(s.device)])
            got = (torch.cat(picks).cpu().numpy() if picks
                   else np.zeros(0, np.float32))
            at = 0
            for v, c, (idx, lo) in zip(vecs, cnts, spans):
                if not c:
                    out[v.name] = np.full(len(probs), np.nan)
                    continue
                k = len(probs)
                slo, shi = got[at: at + k], got[at + k: at + 2 * k]
                at += 2 * k
                out[v.name] = slo * (1 - (idx - lo)) + shi * (idx - lo)
        return _frame(pd.DataFrame(out), like)
    # JAX's weighted branch (ops.py:795-831), on the host in float64
    wall = np.asarray(weights.to_numpy(), np.float64)
    warned = False
    for v in vecs:
        x = v.to_numpy().astype(np.float64)
        ok = ~np.isnan(x) & ~np.isnan(wall) & (wall > 0)
        order = np.argsort(x[ok], kind="mergesort")
        s, sw = x[ok][order], wall[ok][order]
        if len(s) == 0:
            out[v.name] = np.full(len(probs), np.nan)
            continue
        cw = np.cumsum(sw)
        if cw[-1] < 2.0 and not warned:
            warned = True
            warnings.warn(
                "weighted quantile: effective total weight < 2 for column "
                f"{v.name!r} — weights are observation counts (replication "
                "semantics), not normalized fractions; results degenerate "
                "toward the minimum", stacklevel=2)
        t = probs * max(cw[-1] - 1.0, 0.0)
        k = np.floor(t)
        frac = t - k
        j1 = np.clip(np.searchsorted(cw, k, side="right"), 0, len(s) - 1)
        j2 = np.clip(np.searchsorted(cw, k + 1.0, side="right"), 0, len(s) - 1)
        out[v.name] = s[j1] * (1 - frac) + s[j2] * frac
    return _frame(pd.DataFrame(out), like)


def _labels(v: Vec) -> np.ndarray:
    """Host values with an enum's labels (None for NA)."""
    if v.kind == CAT:
        return _key_labels(v, v.to_numpy())
    return v.to_numpy()


def table(v1: Vec, v2: Vec | None = None, dense: bool = True) -> Frame:
    """``h2o.table``: level counts of one column, or of the pairs of two
    (ops.py:835, pandas on the host as in JAX)."""
    if v2 is None:
        s = pd.Series(_labels(v1)).value_counts(sort=False).sort_index()
        return _frame(pd.DataFrame({v1.name or "C1": s.index.to_numpy(),
                                    "Count": s.to_numpy()}), v1)
    ct = pd.crosstab(pd.Series(_labels(v1)), pd.Series(_labels(v2)))
    rows = ct.stack().reset_index()
    rows.columns = [v1.name or "C1", v2.name or "C2", "Counts"]
    if dense:
        rows = rows[rows["Counts"] > 0]
    return _frame(rows, v1)


def unique(v: Vec) -> Frame:
    """Distinct values (ops.py:856): an enum's present levels in domain
    order, other columns in order of appearance, NA left out."""
    if v.kind == CAT:
        dom = np.asarray(list(v.domain or ()), dtype=object)
        present = np.unique(v.to_numpy())
        vals = dom[present[present >= 0]]
    else:
        vals = pd.unique(v.to_numpy())
        vals = vals[~pd.isna(vals)]
    return _frame(pd.DataFrame({v.name or "C1": vals}), v)


def match(v: Vec, table: Sequence, nomatch: float = float("nan"),
          start_index: int = 1) -> Vec:
    """``ASTMatch`` (R ``match``): the position of each value in ``table``
    (from ``start_index``), ``nomatch`` where absent; an enum matches its
    labels. Numeric columns match on the device (ops.py:884-890)."""
    if v.kind in (CAT, STR):
        pos = {str(t): i for i, t in enumerate(table)}
        if v.kind == CAT:
            hit = _level_values(v, [pos.get(str(d), -1) for d in v.domain or ()],
                                fill=-1, dtype=torch.int64)
        else:
            hit = torch.from_numpy(np.array(
                [pos.get(str(s), -1) if s is not None else -1
                 for s in v._host], dtype=np.int64)).to(_device_of(v))
    else:
        # non-numeric table entries never match a number (NaN), as in R
        tbl = pd.to_numeric(pd.Series(list(table), dtype=object),
                            errors="coerce").to_numpy(np.float32)
        x = v.data
        if len(tbl):
            eq = x[:, None] == torch.from_numpy(tbl).to(x.device)[None, :]
            hit = torch.where(eq.any(dim=1), eq.to(torch.int8).argmax(dim=1),
                              -1)
        else:
            hit = torch.full(x.shape, -1, dtype=torch.int64, device=x.device)
    out = torch.where(hit >= 0, (hit + start_index).to(torch.float64),
                      float(nomatch)).to(_F32)
    return Vec(out, NUM, name=v.name, nrow=v.nrow)


def is_in(v: Vec, table: Sequence) -> Vec:
    """R ``%in%``: 1 where the value occurs in ``table``, else 0."""
    m = match(v, table, nomatch=0.0, start_index=1)
    return Vec((m.data > 0).to(_F32), NUM, name=v.name, nrow=v.nrow)


def which(v: Vec) -> Frame:
    """``ASTWhich``: 0-based rows where the column is true (non-zero, not
    NA), as a one-column frame."""
    x = v.to_numpy()
    idx = np.flatnonzero(np.nan_to_num(x, nan=0.0) != 0)
    return _frame(pd.DataFrame({v.name or "which": idx.astype(np.float64)}), v)


def na_omit(frame: Frame) -> Frame:
    """``ASTNaOmit``: the rows with no NA in any column; the mask is made
    on the device (a string column's on the host, where its values are)
    and the rows gathered there."""
    dev = frame.device
    ok = torch.ones(frame.nrow, dtype=torch.bool, device=dev)
    for n in frame.names:
        v = frame.vec(n)
        if v.kind == STR:
            ok &= torch.from_numpy(np.array([s is not None for s in v._host],
                                            dtype=bool)).to(dev)
        elif v.kind == CAT:
            ok &= v.data >= 0
        else:
            ok &= ~torch.isnan(v.data)
    return frame.subset_rows(ok)


def rank_within_group_by(frame: Frame, group_by_cols: Sequence[str],
                         sort_cols: Sequence[str],
                         ascending: Sequence[bool] | bool = True,
                         new_col_name: str = "New_Rank_column",
                         sort_cols_sorted: bool = False) -> Frame:
    """``ASTRankWithinGroupBy``: the 1-based rank of each row inside its
    group, by ``sort_cols`` (ops.py:927), on the device. The group keys
    sort by their int32 key codes and the sort keys as floats (an enum by
    its code), a descending key negated, as JAX's lexsort orders them; a
    row with an NA sort key gets rank NA. ``sort_cols_sorted`` returns
    the rows in that order, else in the frame's."""
    scols = list(sort_cols)
    asc = ([ascending] * len(scols) if isinstance(ascending, bool)
           else list(ascending))
    keys = []
    for n in group_by_cols:
        k = _key_codes(frame.vec(n))
        if k is None:
            raise ValueError(
                f"rank_within_group_by: unsupported key column {n!r}")
        keys.append(k.long())
    n_gkeys = len(keys)
    dev = frame.device
    na = torch.zeros(frame.nrow, dtype=torch.bool, device=dev)
    for n, a in zip(scols, asc):
        k = frame.vec(n).data.to(_F32)
        na |= (k < 0) if frame.vec(n).kind == CAT else torch.isnan(k)
        keys.append(_order_key(k if a else -k))
    _, order, new_grp = _dense_ids(keys, n_gkeys)
    pos = torch.arange(frame.nrow, device=dev)
    start = torch.cummax(torch.where(new_grp, pos, 0), dim=0).values
    ranks = torch.empty(frame.nrow, dtype=_F32, device=dev).scatter_(
        0, order, (pos - start + 1).to(_F32))
    ranks = torch.where(na, float("nan"), ranks)
    out = Frame([frame.vec(n) for n in frame.names]
                + [Vec(ranks, NUM, name=new_col_name)],
                list(frame.names) + [new_col_name])
    return out.gather_rows(order) if sort_cols_sorted else out


def pivot(frame: Frame, index: str, column: str, value: str) -> Frame:
    """``ASTPivot``: long to wide, one row per ``index`` value and one
    column per level of ``column``, each cell the mean of ``value`` over
    the pair (a group-by, then pandas' pivot on the host as in JAX)."""
    if frame.vec(column).kind != CAT:
        raise ValueError("pivot: 'column' must be categorical")
    adf = group_by(frame, [index, column]).agg({value: "mean"}).to_pandas()
    wide = adf.pivot(index=index, columns=column,
                     values=f"mean_{value}").reset_index()
    wide.columns = [str(c) for c in wide.columns]
    return _frame(wide, frame)


def stratified_split(y: Vec, test_frac: float = 0.2, seed: int = -1) -> Vec:
    """``ASTStratifiedSplit``: an enum of 'train'/'test' with about
    ``test_frac`` of each class in 'test' (NA rows in 'train'); JAX's draw
    on the host (ops.py:1010)."""
    if y.kind != CAT:
        raise ValueError("stratified_split needs a categorical response")
    codes = y.to_numpy()
    rng = np.random.default_rng(seed if seed and seed > 0 else None)
    out = np.zeros(len(codes), np.int32)
    for k in np.unique(codes):
        idx = np.flatnonzero(codes == k)
        take = rng.permutation(len(idx))[: int(round(len(idx) * test_frac))]
        out[idx[take]] = 1
    out[codes < 0] = 0
    return _host_vec(out, CAT, y, name="test_train_split",
                     domain=("train", "test"))


def _recode(v: Vec, remap: Sequence[int], new_dom: Sequence[str]) -> Vec:
    """Enum ``v`` with each code ``c`` moved to ``remap[c]`` over
    ``new_dom``, on the device, at the width the new domain needs."""
    dt, _ = Vec.device_dtype(CAT, new_dom)
    codes = _level_values(v, remap, fill=-1, dtype=getattr(torch, dt.name))
    return Vec(codes, CAT, name=v.name, domain=tuple(new_dom))


def relevel(v: Vec, y: str) -> Vec:
    """``ASTRelevel``: level ``y`` moved to the front of the domain (the
    reference level of a GLM's one-hot columns)."""
    if v.kind != CAT:
        raise ValueError("relevel needs a categorical column")
    dom = list(v.domain or ())
    if y not in dom:
        raise ValueError(f"level {y!r} not in domain")
    new_dom = [y] + [d for d in dom if d != y]
    return _recode(v, [new_dom.index(d) for d in dom], new_dom)


def signif(v: Vec, digits: int = 6) -> Vec:
    """R ``signif`` (``ASTSignif``): rounded to ``digits`` significant
    digits, in float64 on the host as in JAX."""
    x = v.to_numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        mag = np.where(x != 0, np.floor(np.log10(np.abs(x))), 0.0)
        factor = np.power(10.0, digits - 1 - mag)
        out = np.where(np.isfinite(x), np.round(x * factor) / factor, x)
    return _host_vec(out, NUM, v, name=v.name)


def cut(v: Vec, breaks: Sequence[float], labels: Sequence[str] | None = None,
        include_lowest: bool = False, right: bool = True) -> Vec:
    """``ASTCut``: a number to the enum of its interval (pandas' ``cut`` on
    the host, as in JAX)."""
    got = pd.cut(v.to_numpy(), bins=list(breaks), labels=labels,
                 include_lowest=include_lowest, right=right)
    return _host_vec(got.codes.astype(np.int32), CAT, v, name=v.name,
                     domain=[str(c) for c in got.categories])


def impute(frame: Frame, column: str, method: str = "mean",
           by: Sequence[str] | None = None) -> float | list:
    """``h2o.impute``: fills the column's NAs in place with its mean,
    median or mode (an enum: its mode), per group of ``by`` when given;
    returns the fill value(s). JAX's host fill (ops.py:1061), the group
    means from the device group-by."""
    v = frame.vec(column)
    if by:
        gb = GroupBy(frame, by)
        agg = "mean" if method == "mean" else "median" if method == "median" \
            else "mode"
        if v.kind == CAT:
            agg = "mode"
        fill = gb.agg({column: agg}).vec(f"{agg}_{column}").to_numpy()
        gid = gb.gid.cpu().numpy()
        if v.kind == CAT:
            codes = v.to_numpy().astype(np.int64)
            na = ((codes < 0) & (gid >= 0)
                  & ~np.isnan(fill[np.clip(gid, 0, None)]))
            codes[na] = fill[gid[na]].astype(np.int64)
            _replace_vec(frame, column, _host_vec(codes, CAT, v, name=column,
                                                  domain=v.domain))
        else:
            vals = v.to_numpy().astype(np.float64)
            na = np.isnan(vals) & (gid >= 0)
            vals[na] = fill[gid[na]]
            _replace_vec(frame, column, _host_vec(vals, v.kind, v,
                                                  name=column))
        return fill.tolist()
    if v.kind == CAT:
        codes = v.to_numpy()
        valid = codes[codes >= 0]
        fill = int(pd.Series(valid).mode().iloc[0]) if len(valid) else -1
        _replace_vec(frame, column, _host_vec(
            np.where(codes < 0, fill, codes), CAT, v, name=column,
            domain=v.domain))
        return float(fill)
    vals = v.to_numpy().astype(np.float64)
    if method == "median":
        fill = float(np.nanmedian(vals))
    elif method == "mode":
        fill = float(pd.Series(vals).mode().iloc[0])
    else:
        fill = float(np.nanmean(vals))
    _replace_vec(frame, column, _host_vec(np.where(np.isnan(vals), fill, vals),
                                          v.kind, v, name=column))
    return fill


def _replace_vec(frame: Frame, column: str, new: Vec) -> None:
    i = frame._index(column)
    frame._vecs[i] = new
    new.name = frame._names[i]


# ---------------------------------------------------------------------------
# scale / cor / var (ops.py:1114-1149)
# ---------------------------------------------------------------------------


def scale(frame: Frame, center: bool = True, scale_: bool = True) -> Frame:
    """Numeric columns centred on their mean and divided by their standard
    deviation (each as asked), on the device in float32."""
    vecs = []
    for n in frame.names:
        v = frame.vec(n)
        if not v.is_numeric():
            vecs.append(v)
            continue
        mu = v.mean() if center else 0.0
        sd = v.sigma() if scale_ else 1.0
        sd = sd if sd and np.isfinite(sd) and sd > 0 else 1.0
        out = (v.data - _scalar(mu, v.device)) / _scalar(sd, v.device)
        vecs.append(Vec(out, NUM, nrow=v.nrow))
    return Frame(vecs, frame.names)


def _numeric_matrix(frame: Frame) -> tuple[list[str], np.ndarray]:
    names = [n for n in frame.names if frame.vec(n).is_numeric()]
    X = np.stack([frame.vec(n).to_numpy().astype(np.float64) for n in names],
                 axis=1)
    return names, X


def cor(frame: Frame, use: str = "complete.obs") -> Frame:
    """Pearson correlations of the numeric columns, float64 on the host
    (as in JAX); ``complete.obs`` drops the rows with an NA."""
    names, X = _numeric_matrix(frame)
    if use == "complete.obs":
        X = X[~np.isnan(X).any(axis=1)]
    c = np.corrcoef(X, rowvar=False)
    return _frame(pd.DataFrame(np.atleast_2d(c), columns=names), frame)


def var(frame: Frame) -> Frame:
    """Covariances of the numeric columns over the complete rows, float64
    on the host (as in JAX)."""
    names, X = _numeric_matrix(frame)
    c = np.cov(X[~np.isnan(X).any(axis=1)], rowvar=False)
    return _frame(pd.DataFrame(np.atleast_2d(c), columns=names), frame)


# ---------------------------------------------------------------------------
# string functions (ops.py:1157-1286): on the host, where strings live; an
# enum's function rewrites its domain and moves the codes on the device
# ---------------------------------------------------------------------------


def _str_apply(v: Vec, fn) -> Vec:
    if v.kind == CAT:
        new_dom: list[str] = []
        lut: dict[str, int] = {}
        remap = []
        for d in (fn(d) for d in v.domain or ()):
            if d not in lut:  # levels made equal collapse into one
                lut[d] = len(new_dom)
                new_dom.append(d)
            remap.append(lut[d])
        return _recode(v, remap, new_dom)
    if v.kind != STR:
        raise TypeError(f"string op on {v.kind} column")
    vals = np.array([fn(s) if s is not None else None for s in v.to_numpy()],
                    dtype=object)
    return Vec(vals, STR, name=v.name, device=v.device)


def _per_string(v: Vec, fn) -> Vec:
    """A number per string (NA for NA): per level on the device for an
    enum, per row on the host for a string column."""
    if v.kind == CAT:
        return Vec(_level_values(v, [fn(d) for d in v.domain or ()]), NUM,
                   name=v.name, nrow=v.nrow)
    vals = np.array([np.nan if s is None else fn(s) for s in v.to_numpy()],
                    dtype=np.float64)
    return _host_vec(vals, NUM, v, name=v.name)


def toupper(v: Vec) -> Vec:
    return _str_apply(v, str.upper)


def tolower(v: Vec) -> Vec:
    return _str_apply(v, str.lower)


def trim(v: Vec) -> Vec:
    return _str_apply(v, str.strip)


def sub(v: Vec, pattern: str, replacement: str) -> Vec:
    rx = re.compile(pattern)
    return _str_apply(v, lambda s: rx.sub(replacement, s, count=1))


def gsub(v: Vec, pattern: str, replacement: str) -> Vec:
    rx = re.compile(pattern)
    return _str_apply(v, lambda s: rx.sub(replacement, s))


def nchar(v: Vec) -> Vec:
    return _per_string(v, lambda s: float(len(s)))


def substring(v: Vec, start: int, end: int | None = None) -> Vec:
    return _str_apply(v, lambda s: s[start:end])


def strsplit(v: Vec, pattern: str) -> Frame:
    rx = re.compile(pattern)
    vals = _labels(v) if v.kind == CAT else v.to_numpy()
    parts = [rx.split(s) if s is not None else [] for s in vals]
    width = max((len(p) for p in parts), default=0)
    cols = {f"C{j + 1}": np.array([p[j] if j < len(p) else None
                                   for p in parts], dtype=object)
            for j in range(width)}
    return _frame(pd.DataFrame(cols), v, column_types={c: STR for c in cols})


def lstrip(v: Vec, chars: str | None = None) -> Vec:
    return _str_apply(v, lambda s: s.lstrip(chars))


def rstrip(v: Vec, chars: str | None = None) -> Vec:
    return _str_apply(v, lambda s: s.rstrip(chars))


def countmatches(v: Vec, patterns) -> Vec:
    """``ASTCountMatches``: occurrences of any of the substrings per row."""
    pats = [patterns] if isinstance(patterns, str) else list(patterns)
    return _per_string(v, lambda s: float(sum(s.count(p) for p in pats)))


def _entropy(s: str) -> float:
    if not s:
        return 0.0
    _, counts = np.unique(list(s), return_counts=True)
    p = counts / counts.sum()
    return float(-(p * np.log2(p)).sum())


def entropy(v: Vec) -> Vec:
    """``ASTEntropy``: the Shannon entropy of each string's characters."""
    return _per_string(v, _entropy)


def grep(v: Vec, pattern: str) -> Vec:
    """1 where the pattern matches, else 0 (an indicator, where H2O's grep
    returns row numbers; it composes with masks)."""
    rx = re.compile(pattern)
    return _per_string(v, lambda s: 1.0 if rx.search(s) else 0.0)


# ---------------------------------------------------------------------------
# time components, from the exact float64 epoch milliseconds on the host
# (ops.py:1294-1336)
# ---------------------------------------------------------------------------


def _time_component(v: Vec, comp: str) -> Vec:
    ms = v.to_numpy().astype(np.float64)
    dt = pd.to_datetime(pd.Series(ms), unit="ms")
    if comp == "dayOfWeek":
        vals = dt.dt.dayofweek.to_numpy().astype(np.float64)  # Monday = 0
    elif comp == "week":
        vals = dt.dt.isocalendar().week.to_numpy().astype(np.float64)
    else:
        vals = getattr(dt.dt, comp).to_numpy().astype(np.float64)
    return _host_vec(np.where(np.isnan(ms), np.nan, vals), INT, v,
                     name=v.name)


def year(v):
    return _time_component(v, "year")


def month(v):
    return _time_component(v, "month")


def day(v):
    return _time_component(v, "day")


def hour(v):
    return _time_component(v, "hour")


def minute(v):
    return _time_component(v, "minute")


def second(v):
    return _time_component(v, "second")


def day_of_week(v):
    return _time_component(v, "dayOfWeek")


def week(v):
    return _time_component(v, "week")


# ---------------------------------------------------------------------------
# interaction and type conversions (ops.py:1344-1480)
# ---------------------------------------------------------------------------


def interaction(frame: Frame, factors: list[str], pairwise: bool = False,
                max_factors: int = 100, min_occurrence: int = 1,
                destination_frame: str | None = None) -> Frame:
    """``h2o.interaction``: one enum column per combination of the factor
    columns (all of them, or every pair), whose levels are the observed
    ``a_b`` combinations; the ``max_factors`` most frequent are kept (ties
    in level order) and the rest, with those seen fewer than
    ``min_occurrence`` times, go to ``other.values``. On the host, as in
    JAX."""
    if len(factors) < 2:
        raise ValueError("interaction needs at least two factor columns")
    for f in factors:
        if not frame.vec(f).is_categorical():
            raise ValueError(f"interaction column {f!r} is not categorical")
    combos = ([(a, b) for i, a in enumerate(factors) for b in factors[i + 1:]]
              if pairwise else [tuple(factors)])
    col_codes = {f: frame.vec(f).to_numpy().astype(np.int64) for f in factors}
    vecs, names = [], []
    for combo in combos:
        cards = [len(frame.vec(f).domain) for f in combo]
        prod = 1
        for card in cards:
            prod *= max(card, 1)
            if prod > (1 << 62):
                raise ValueError(
                    "interaction cardinality product overflows the combined "
                    f"code space ({'x'.join(map(str, cards))})")
        codes = None
        for f, card in zip(combo, cards):
            c = col_codes[f]
            codes = c.copy() if codes is None else codes * card + c
            codes = np.where((c < 0) | (codes < 0), -1, codes)
        valid = codes >= 0
        uniq, counts = np.unique(codes[valid], return_counts=True)
        floor = max(min_occurrence, 1)
        keep, kcounts = uniq[counts >= floor], counts[counts >= floor]
        if len(keep) > max(max_factors, 1):
            order = np.argsort(-kcounts, kind="stable")[: max(max_factors, 1)]
            keep = keep[np.sort(order)]
        doms = [frame.vec(f).domain for f in combo]

        def label(code: int) -> str:
            parts = []
            for card, dom in zip(reversed(cards), reversed(doms)):
                parts.append(dom[code % card])
                code //= card
            return "_".join(reversed(parts))

        levels = [label(int(u)) for u in keep]
        if len(keep):
            pos = np.minimum(np.searchsorted(keep, codes), len(keep) - 1)
            hit = valid & (keep[pos] == codes)
        else:
            pos = np.zeros_like(codes)
            hit = np.zeros_like(valid)
        mapped = np.where(hit, pos, np.where(valid, len(levels), -1))
        if (valid & ~hit).any():
            levels = levels + ["other.values"]
        name = "_".join(combo)
        names.append(name)
        vecs.append(Vec.from_numpy(mapped.astype(np.int32), CAT, name=name,
                                   domain=tuple(levels), device=frame.device))
    return Frame(vecs, names, key=destination_frame)


def asfactor(v: Vec) -> Vec:
    """To an enum: strings by their sorted distinct values, numbers by
    theirs (an integral value's label has no decimal point)."""
    if v.kind == CAT:
        return v
    if v.kind == STR:
        vals = v.to_numpy()
        levels = sorted({str(s) for s in vals if s is not None})
        lut = {s: i for i, s in enumerate(levels)}
        codes = np.array([lut[str(s)] if s is not None else -1 for s in vals],
                         dtype=np.int32)
        return _host_vec(codes, CAT, v, name=v.name, domain=levels)
    vals = v.to_numpy()
    ok = ~np.isnan(vals)
    uniq = np.unique(vals[ok])
    labels = [str(int(u)) if float(u).is_integer() else str(u) for u in uniq]
    codes = np.full(len(vals), -1, np.int32)
    codes[ok] = np.searchsorted(uniq, vals[ok])
    return _host_vec(codes, CAT, v, name=v.name, domain=labels)


def asnumeric(v: Vec) -> Vec:
    """To numbers: an enum of numeric labels by value, any other enum by
    code; strings parsed (NA where they do not parse)."""
    if v.is_numeric():
        return v
    if v.kind == CAT:
        dom = list(v.domain or ())
        try:
            by_val = [float(d) for d in dom]
        except ValueError:
            by_val = [float(i) for i in range(len(dom))]
        return Vec(_level_values(v, by_val), NUM, name=v.name, nrow=v.nrow)
    vals = pd.to_numeric(pd.Series(v.to_numpy()), errors="coerce").to_numpy()
    return _host_vec(vals, NUM, v, name=v.name)


def ascharacter(v: Vec) -> Vec:
    """To strings (host): an enum's labels, numbers' ``str``."""
    if v.kind == STR:
        return v
    if v.kind == CAT:
        return Vec(_labels(v), STR, name=v.name, device=v.device)
    vals = np.array([None if np.isnan(x) else str(x) for x in v.to_numpy()],
                    dtype=object)
    return Vec(vals, STR, name=v.name, device=v.device)


def hist(v: Vec, breaks: int | Sequence[float] = 20) -> Frame:
    """``ASTHist``: counts of a numeric column's values per bin."""
    vals = v.to_numpy()
    counts, edges = np.histogram(vals[~np.isnan(vals)], bins=breaks)
    mids = (edges[:-1] + edges[1:]) / 2
    return _frame(pd.DataFrame({"breaks": edges[1:], "mids": mids,
                                "counts": counts}), v)


# ---------------------------------------------------------------------------
# operators and methods on Vec and Frame (ops.py:1488-1569)
# ---------------------------------------------------------------------------


def _frame_set(self: Frame, name, value) -> None:
    """``frame["col"] = value``: add or replace a column (a Vec, a
    one-column frame, a scalar or a host array)."""
    if isinstance(value, Frame):
        value = value.vec(0)
    if isinstance(value, (int, float)):
        value = Vec.from_numpy(np.full(self.nrow, float(value)), NUM,
                               device=self.device)
    if isinstance(value, np.ndarray):
        value = (Vec(value, STR, device=self.device) if value.dtype == object
                 else Vec.from_numpy(value, NUM, device=self.device))
    if not isinstance(value, Vec):
        raise TypeError(f"cannot set a column from {type(value).__name__}")
    if value.nrow != self.nrow and self.ncol:
        raise ValueError("column length differs from the frame's rows")
    value.name = str(name)
    if name in self._names:
        self._vecs[self._index(name)] = value
    else:
        self._names.append(str(name))
        self._vecs.append(value)


def _attach() -> None:
    def make_bin(op, reflected=False):
        def fn(self, other):
            v = self.vec(0) if isinstance(self, Frame) else self
            other = other.vec(0) if isinstance(other, Frame) else other
            return _binop(v, other, op, reflected=reflected)

        return fn

    for name, op in [
        ("__add__", "+"), ("__sub__", "-"), ("__mul__", "*"),
        ("__truediv__", "/"), ("__floordiv__", "//"), ("__mod__", "%"),
        ("__pow__", "**"), ("__eq__", "=="), ("__ne__", "!="),
        ("__lt__", "<"), ("__le__", "<="), ("__gt__", ">"), ("__ge__", ">="),
        ("__and__", "&"), ("__or__", "|"),
    ]:
        setattr(Vec, name, make_bin(op))
    for name, op in [
        ("__radd__", "+"), ("__rsub__", "-"), ("__rmul__", "*"),
        ("__rtruediv__", "/"), ("__rpow__", "**"), ("__rmod__", "%"),
    ]:
        setattr(Vec, name, make_bin(op, reflected=True))
    Vec.__hash__ = lambda self: id(self)
    Frame.__hash__ = lambda self: hash(self.key)

    for op in _UNOPS:
        setattr(Vec, {"not": "logical_not"}.get(op, op),
                (lambda o: lambda self: _unop(self, o))(op))
    for op in _CUMOPS:
        setattr(Vec, op, (lambda o: lambda self: _cumulative(self, o))(op))
    for fn in (asfactor, asnumeric, ascharacter, toupper, tolower, trim,
               nchar, gsub, substring, strsplit, grep, year, month, day,
               hour, minute, second, day_of_week, week, table, unique, cut,
               quantile):
        setattr(Vec, fn.__name__, fn)
    Vec.sub_ = sub

    for fn in (group_by, merge, sort, quantile, impute, scale, cor, var):
        setattr(Frame, fn.__name__, fn)
    Frame.__setitem__ = _frame_set


_attach()
