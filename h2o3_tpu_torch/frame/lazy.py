"""Deferred columns — the port of ``h2o3_tpu/frame/lazy.py``, the successor
of H2O's ``FileVec`` (a column read from its file on first use) and
``CategoricalWrappedVec`` (an enum seen through a domain remap):

- :class:`LazyVec`: a column whose load is deferred to the first read of
  its values; ``import_file(path, lazy=True)`` (:func:`import_file_lazy`)
  makes one per column of a CSV or Parquet file after one row-count pass,
  so a model that uses a few columns of a wide file loads only those;
- :class:`WrappedCatVec`: an enum column remapped onto another domain
  (:func:`wrap_domain`), the remap one gather on first use;
- :class:`LazyExprVec`: a column defined by an elementwise expression
  graph. Under ``H2O3_TPU_MUNGE_FUSE`` (on by default) the operators and
  ``ifelse`` of ``frame/ops.py`` return one, splicing their operands'
  graphs, and the whole chain is evaluated on its first use. JAX compiles
  the chain into one XLA program; the port evaluates each node with the
  same PyTorch calls as the eager operators (``ops._binop_kernel``,
  ``ops._unop_kernel``, ``ifelse``'s select), so the values are those of
  ``H2O3_TPU_MUNGE_FUSE=0`` bit for bit. With the out-of-core window set,
  the leaves' host copies stream through a ``ChunkStore`` block by block
  and the result stays in host memory until its ``data`` is read.

Every column reads its values through ``Vec.data``, ``to_numpy`` or
``host_values``, which load or evaluate a deferred column first.
:data:`LAZY_EVENTS` counts the loads and evaluations (JAX publishes them
as metrics, which the port does not have).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import pandas as pd
import torch

from h2o3_tpu_torch.frame.frame import CAT, NUM, STR, TIME, Frame, Vec

# loads of lazy columns, expressions deferred, and expressions evaluated
# resident and streamed
LAZY_EVENTS = {"loads": 0, "deferred": 0, "resident": 0, "streamed": 0}


def _intern(arr) -> tuple[np.ndarray, tuple]:
    """Labels as int32 codes into their sorted domain (-1 for None and
    NaN): each value's ``str``, as JAX's ``LazyVec._materialize``."""
    s = pd.Series(np.asarray(arr, dtype=object), dtype=object)
    ok = s.notna().to_numpy()
    labels = s[ok].map(str)
    levels = sorted(set(labels))
    codes = np.full(len(s), -1, np.int32)
    codes[ok] = pd.Categorical(labels, categories=levels).codes
    return codes, tuple(levels)


class LazyVec(Vec):
    """A column loaded by ``loader`` (host values: numbers, labels or
    strings) on its first read; an enum's domain, when not given, is
    interned then (sorted, as the eager parse)."""

    def __init__(self, loader: Callable[[], np.ndarray], kind: str,
                 name: str, nrow: int, domain=None, device=None):
        from h2o3_tpu_torch.device import resolve

        # Vec.__init__ is not called: there are no values yet
        self.kind = kind
        self.name = name
        self._domain = tuple(domain) if domain is not None else None
        self.nrow = int(nrow)
        self._device = resolve(device)
        self._loader = loader
        self._data = None
        self._hostbuf = None
        self._exact = None  # strings, or a time column's float64 copy
        self._stats = None

    def _materialize(self) -> None:
        if self._loader is None:
            return
        arr = self._loader()
        if len(arr) != self.nrow:
            raise ValueError(f"lazy column {self.name!r}: the loader gave "
                             f"{len(arr)} rows, expected {self.nrow}")
        if self.kind == CAT and self._domain is None:
            arr, self._domain = _intern(arr)
        if self.kind == STR:
            self._exact = np.asarray(arr, dtype=object)
        else:
            v = Vec.from_numpy(np.asarray(arr), self.kind,
                               domain=self._domain, device=self._device)
            self._data, self._exact = v._data, v._host
        self._loader = None  # the closure may hold the file's data
        self._stats = None
        LAZY_EVENTS["loads"] += 1

    @property
    def is_materialized(self) -> bool:
        return self._loader is None

    @property
    def data(self):
        self._materialize()
        return Vec.data.fget(self)

    @data.setter
    def data(self, v) -> None:
        self._materialize()
        Vec.data.fset(self, v)

    @property
    def _host(self):
        self._materialize()
        return self._exact

    @_host.setter
    def _host(self, v) -> None:
        self._exact = v

    @property
    def domain(self):
        if self.kind == CAT and self._domain is None:
            self._materialize()
        return self._domain

    @domain.setter
    def domain(self, d) -> None:
        self._domain = tuple(d) if d is not None else None

    def to_numpy(self) -> np.ndarray:
        self._materialize()
        return super().to_numpy()


class WrappedCatVec(Vec):
    """An enum column seen through another domain: ``base``'s codes mapped
    by ``old_to_new`` (-1 where a level is not in the new domain), gathered
    on the first read (JAX's ``WrappedCatVec``)."""

    def __init__(self, base: Vec, new_domain, old_to_new):
        if not base.is_categorical():
            raise TypeError("wrap_domain needs an enum column")
        self.kind = CAT
        self.name = base.name
        self.domain = tuple(new_domain)
        self.nrow = base.nrow
        self._device = base.device
        self._base = base
        self._lut = np.asarray(old_to_new, np.int32)
        self._data = None
        self._hostbuf = None
        self._host = None
        self._stats = None

    @property
    def data(self):
        if self._data is None and self._hostbuf is None:
            codes = self._base.data
            dt, _ = Vec.device_dtype(CAT, self.domain)
            lut = torch.from_numpy(np.append(self._lut, -1).astype(dt)).to(
                codes.device)
            self._data = lut[torch.where(codes >= 0, codes.long(),
                                         len(self._lut))]  # -1: the NA slot
        return Vec.data.fget(self)

    @data.setter
    def data(self, v) -> None:
        Vec.data.fset(self, v)


def wrap_domain(base: Vec, new_domain) -> WrappedCatVec:
    """``base`` remapped onto ``new_domain`` as a deferred view (JAX's
    ``wrap_domain``): a test frame's levels aligned with a training
    domain without rewriting the column."""
    idx = {d: i for i, d in enumerate(new_domain)}
    lut = [idx.get(d, -1) for d in base.domain or ()]
    return WrappedCatVec(base, list(new_domain), lut)


def _series_values(s: pd.Series, kind: str) -> np.ndarray:
    """A column's host values for :class:`LazyVec`: labels (None for NA)
    for enums and strings, epoch milliseconds for time (any format pandas
    reads), float64 otherwise (JAX's ``_series_values``)."""
    from h2o3_tpu_torch.frame.parse import _mixed_time_ms

    if kind in (STR, CAT):
        return s.astype(object).where(s.notna(), None).to_numpy()
    if kind == TIME:
        return _mixed_time_ms(s)
    return pd.to_numeric(s, errors="coerce").to_numpy(np.float64)


def import_file_lazy(path: str, col_types=None, sep: str | None = None,
                     device=None, destination_frame: str | None = None
                     ) -> Frame:
    """``import_file(..., lazy=True)`` (JAX's ``import_file_lazy``): the
    setup sniff, one row-count pass, then a :class:`LazyVec` per column
    whose loader reads that column alone on first use. Parquet counts its
    rows from the file's metadata and reads one column; a text file counts
    them as pandas parses them (quoted newlines, blank lines), reading
    only the first column, kept as that column's values when numeric."""
    from h2o3_tpu_torch.frame.parse import _kind_name, parse_setup

    ext = path.removesuffix(".gz").rsplit(".", 1)[-1].lower()
    setup = parse_setup(path, sep=sep)
    types = dict(setup["column_types"])
    if col_types:
        types.update(col_types)
    names = setup["column_names"]
    if ext in ("parquet", "pq"):
        import pyarrow.parquet as pq

        nrow = pq.ParquetFile(path).metadata.num_rows

        def make_loader(col: str, kind: str):
            def load():
                return _series_values(
                    pd.read_parquet(path, columns=[col])[col], kind)
            return load
    else:
        first = pd.read_csv(path, sep=setup.get("separator"),
                            usecols=[names[0]], engine="c")[names[0]]
        nrow = len(first)
        if not pd.api.types.is_numeric_dtype(first):
            first = None  # a string column may be large: not kept

        def make_loader(col: str, kind: str):
            if col == names[0] and first is not None:
                return lambda: _series_values(first, kind)

            def load():
                # the tokenizer scans the file; one column is converted
                s = pd.read_csv(path, sep=setup.get("separator"),
                                usecols=[col], engine="c")[col]
                return _series_values(s, kind)
            return load
    vecs = []
    for name in names:
        kind = _kind_name(types.get(name, NUM))
        vecs.append(LazyVec(make_loader(name, kind), kind, name, nrow,
                            device=device))
    return Frame(vecs, list(names), key=destination_frame)


# ---------------------------------------------------------------------------
# deferred expressions
# ---------------------------------------------------------------------------
#
# A graph is a tuple of nodes:
#   ("leaf", i, is_cat)  the i-th leaf column (an enum's codes enter as
#                        floats with NA as NaN, as the eager operators take
#                        them)
#   ("const", ci)        the ci-th scalar, a float32 0-d tensor
#   ("bin", op, l, r)    ops._binop_kernel(l, r, op)
#   ("un", op, a)        ops._unop_kernel(a, op)
#   ("sel", t, y, n)     ifelse: y where t != 0, else n; NaN where t is NaN

_MAX_EXPR_NODES = 256  # past this, an operand enters as an evaluated leaf


def _node_count(node) -> int:
    """The number of operation nodes (bin, un, sel) in a graph."""
    tag = node[0]
    if tag == "bin":
        return 1 + _node_count(node[2]) + _node_count(node[3])
    if tag == "un":
        return 1 + _node_count(node[2])
    if tag == "sel":
        return 1 + sum(_node_count(c) for c in node[1:])
    return 0


def _eval_node(node, leaves, consts) -> torch.Tensor:
    """A graph's values over the leaf tensors (whole columns or one row
    block of each), by the eager operators' own calls (JAX jits the graph
    into one program, ``_expr_program``; eager PyTorch needs no cache)."""
    from h2o3_tpu_torch.frame import ops

    tag = node[0]
    if tag == "leaf":
        x = leaves[node[1]]
        return ops._codes_as_float(x) if node[2] else x
    if tag == "const":
        return consts[node[1]]
    if tag == "bin":
        return ops._binop_kernel(_eval_node(node[2], leaves, consts),
                                 _eval_node(node[3], leaves, consts), node[1])
    if tag == "un":
        return ops._unop_kernel(_eval_node(node[2], leaves, consts), node[1])
    return ops._select(*(_eval_node(c, leaves, consts) for c in node[1:]))


class LazyExprVec(Vec):
    """A deferred elementwise expression (``H2O3_TPU_MUNGE_FUSE=1``): its
    graph, leaf columns and constants, evaluated on the first read of its
    values — over the whole leaf tensors, or, with the out-of-core window
    set and the leaves over it, block by block through a ``ChunkStore``
    with the result kept in host memory (``data`` then uploads it)."""

    def __init__(self, node, leaves, consts, nrow: int, device):
        # Vec.__init__ is not called: there are no values yet
        self.kind = NUM
        self.name = ""
        self.domain = None
        self.nrow = int(nrow)
        self._device = device
        self._node = node
        self._leaves = list(leaves)
        self._consts = [float(c) for c in consts]
        self._data = None
        self._hostbuf = None
        self._host = None
        self._stats = None
        LAZY_EVENTS["deferred"] += 1

    def _materialize(self) -> None:
        if self._node is None:
            return
        buf = _materialize_expr_streamed(self)
        if buf is not None:
            self.seed_host(buf)
            LAZY_EVENTS["streamed"] += 1
        else:
            self._data = _materialize_expr(self)
            LAZY_EVENTS["resident"] += 1
        self._node = self._leaves = self._consts = None  # release operands
        self._stats = None

    @property
    def is_materialized(self) -> bool:
        return self._node is None

    @property
    def data(self):
        self._materialize()
        return Vec.data.fget(self)

    @data.setter
    def data(self, v) -> None:
        self._materialize()
        Vec.data.fset(self, v)

    def to_numpy(self) -> np.ndarray:
        self._materialize()
        return super().to_numpy()

    def host_values(self) -> np.ndarray:
        self._materialize()
        return super().host_values()


def _consts_on(lv: LazyExprVec) -> list:
    from h2o3_tpu_torch.frame import ops

    return [ops._scalar(c, lv._device) for c in lv._consts]


def _materialize_expr(lv: LazyExprVec) -> torch.Tensor:
    """The expression over its whole leaf columns, on their device."""
    return _eval_node(lv._node, [v.data for v in lv._leaves], _consts_on(lv))


def _materialize_expr_streamed(lv: LazyExprVec) -> np.ndarray | None:
    """The expression over row blocks: each leaf's host copy a lane of a
    ``ChunkStore`` (padded to the block quantum: NaN, or -1 for enum
    codes), each block's result read back into a float32 host buffer.
    None when the leaves fit the window (the resident evaluation runs)."""
    from h2o3_tpu_torch.frame import chunkstore as cs

    n, C = lv.nrow, len(lv._leaves)
    npad = cs.pad_rows(n)
    store = cs.ChunkStore.plan(npad, 4.0 * (C + 1), device=lv._device)
    if store is None:
        return None
    try:
        names = []
        for i, v in enumerate(lv._leaves):
            hv = v.host_values()
            buf = np.full(npad, -1 if v.kind == CAT else np.nan, hv.dtype)
            buf[:n] = hv
            names.append(f"l{i}")
            store.add(names[-1], buf)
        consts = _consts_on(lv)
        out = np.empty(npad, np.float32)
        for bi, blk in store.stream(names):
            lo, hi = store.span(bi)
            out[lo:hi] = _eval_node(lv._node, [blk[k] for k in names],
                                    consts).cpu().numpy()
    finally:
        store.close()
    return out[:n]


# -- graph builders (frame/ops.py calls these under fuse_on()) --------------

def fusible_operand(x) -> bool:
    """Whether ``x`` can enter a graph: a non-string column or a Python or
    numpy scalar (what ``ops._as_device`` takes, strings aside)."""
    if isinstance(x, Vec):
        return x.kind != STR
    return isinstance(x, (bool, int, float, np.integer, np.floating,
                          np.bool_))


def _leaf(v: Vec, leaves: list, leaf_ids: dict) -> int:
    """``v``'s leaf slot, shared by every use of the same column."""
    if id(v) not in leaf_ids:
        leaf_ids[id(v)] = len(leaves)
        leaves.append(v)
    return leaf_ids[id(v)]


def _as_node(x, leaves, consts, leaf_ids, nrow):
    if isinstance(x, Vec):
        if x.nrow != nrow:
            raise ValueError("operand row counts differ")
        if (isinstance(x, LazyExprVec) and not x.is_materialized
                and _node_count(x._node) < _MAX_EXPR_NODES):
            return _splice(x._node, x, leaves, consts, leaf_ids)
        return ("leaf", _leaf(x, leaves, leaf_ids), x.kind == CAT)
    consts.append(float(x))
    return ("const", len(consts) - 1)


def _splice(node, src: LazyExprVec, leaves, consts, leaf_ids):
    """``src``'s graph grafted into a new one, its leaf and constant slots
    renumbered (a column shared by several operands stays one leaf)."""
    tag = node[0]
    if tag == "leaf":
        return ("leaf", _leaf(src._leaves[node[1]], leaves, leaf_ids),
                node[2])
    if tag == "const":
        consts.append(src._consts[node[1]])
        return ("const", len(consts) - 1)
    if tag == "bin":
        return ("bin", node[1],
                _splice(node[2], src, leaves, consts, leaf_ids),
                _splice(node[3], src, leaves, consts, leaf_ids))
    if tag == "un":
        return ("un", node[1],
                _splice(node[2], src, leaves, consts, leaf_ids))
    return ("sel",) + tuple(_splice(c, src, leaves, consts, leaf_ids)
                            for c in node[1:])


def defer_binop(a: Vec, b, op: str, reflected: bool = False) -> LazyExprVec:
    leaves, consts, ids = [], [], {}
    na = _as_node(a, leaves, consts, ids, a.nrow)
    nb = _as_node(b, leaves, consts, ids, a.nrow)
    if reflected:
        na, nb = nb, na
    return LazyExprVec(("bin", op, na, nb), leaves, consts, a.nrow, a.device)


def defer_unop(a: Vec, op: str) -> LazyExprVec:
    leaves, consts, ids = [], [], {}
    return LazyExprVec(("un", op, _as_node(a, leaves, consts, ids, a.nrow)),
                       leaves, consts, a.nrow, a.device)


def defer_ifelse(test: Vec, yes, no) -> LazyExprVec:
    leaves, consts, ids = [], [], {}
    node = ("sel",) + tuple(_as_node(x, leaves, consts, ids, test.nrow)
                            for x in (test, yes, no))
    return LazyExprVec(node, leaves, consts, test.nrow, test.device)
