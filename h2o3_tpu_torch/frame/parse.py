"""Ingest — the port of ``h2o3_tpu/frame/parse.py``: the reader dispatched
on the file extension, separator sniffing, column typing on the first
10,000 rows (``parse_setup``), the whole file read with those types
(``parse``), and ``import_file`` / ``upload_file`` on top.

Formats, as in JAX: CSV / TSV / text with the separator guessed among
``,`` ``\\t`` ``;`` ``|`` (and ``.gz`` of any of them), Parquet, ORC,
Feather/Arrow, SVMLight, and XLS(X) through pandas when its reader library
is installed (the library's ``ImportError`` otherwise). ISO-8601 date
strings and datetime64 columns parse as the ``time`` kind, stored as epoch
milliseconds (UTC).

Not ported (ROADMAP Queue A 6 and 7): the native C++ CSV parse
(``H2O3_TPU_NATIVE_PARSE``), the streamed parse of large files
(``H2O3_TPU_STREAM_BYTES``) and ``lazy=True``.
"""

from __future__ import annotations

import gzip
import os
from typing import Mapping

import numpy as np
import pandas as pd

NUM, CAT, STR, TIME = "real", "enum", "string", "time"
INT = "int"  # integral-valued numeric; stored like NUM but reported as int

# H2O parses low-cardinality strings as enums and high-cardinality ones as
# strings (JAX's heuristic)
_MAX_CAT_FRACTION = 0.95
_MAX_CAT_LEVELS = 10_000_000
_SETUP_ROWS = 10_000  # parse_setup types the columns on this many rows
_NOT_TEXT = (".parquet", ".pq", ".orc", ".feather", ".arrow", ".xls",
             ".xlsx", ".svm", ".svmlight")


def _ext(path: str) -> str:
    return os.path.splitext(path.removesuffix(".gz"))[1].lower()


def _read_any(path: str, sep: str | None = None, header: int | None = 0,
              nrows: int | None = None) -> pd.DataFrame:
    """The file as a DataFrame, by its extension (JAX's ``_read_any``);
    ``nrows`` limits the text and Excel readers, as in JAX."""
    ext = _ext(path)
    if ext in (".parquet", ".pq"):
        return pd.read_parquet(path)
    if ext == ".orc":
        return pd.read_orc(path)
    if ext in (".feather", ".arrow"):
        return pd.read_feather(path)
    if ext in (".xls", ".xlsx"):
        return pd.read_excel(path, nrows=nrows)
    if ext in (".svm", ".svmlight"):
        from sklearn.datasets import load_svmlight_file

        X, y = load_svmlight_file(path)
        df = pd.DataFrame(X.toarray(),
                          columns=[f"C{i + 1}" for i in range(X.shape[1])])
        df.insert(0, "target", y)
        return df
    # CSV / TSV / text (+ .gz through pandas)
    return pd.read_csv(path, sep=sep or _sniff_sep(path), header=header,
                       engine="c", nrows=nrows)


def _sniff_sep(path: str) -> str:
    """The separator among ``,`` ``\\t`` ``;`` ``|`` that every one of the
    first 5 lines holds equally often, the most of them (JAX's
    ``_sniff_sep``; ``,`` on a tie or an empty file)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", errors="replace") as f:
        head = [line for _, line in zip(range(5), f)]
    if not head:
        return ","
    best, best_score = ",", -1
    for cand in (",", "\t", ";", "|"):
        counts = [line.count(cand) for line in head]
        score = min(counts) if min(counts) == max(counts) else 0
        if score > best_score:
            best, best_score = cand, score
    return best


def infer_kind(s: pd.Series) -> str:
    """Column type inference — JAX's ``infer_kind``: bool and categorical
    dtypes are enums, datetime64 and ISO-8601 date strings time, integer
    and float dtypes numeric; other columns numeric when every value
    parses as a number, else enums unless near-unique (strings)."""
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
    sample = nz.iloc[:1000].astype(str)
    if sample.str.match(r"^\d{4}-\d{2}-\d{2}([ T].*)?$").all():
        try:
            pd.to_datetime(sample, format="ISO8601")
            return TIME
        except (ValueError, TypeError):
            pass
    nuniq = nz.nunique()
    if nuniq > _MAX_CAT_LEVELS or (len(nz) > 100
                                   and nuniq > _MAX_CAT_FRACTION * len(nz)):
        return STR
    return CAT


def _time_ms(s: pd.Series) -> np.ndarray:
    """Epoch milliseconds (UTC) as float64, NaN for NA — JAX's TIME branch
    of ``_series_to_host``: datetime64 of any resolution or timezone,
    numbers taken as epoch ms, strings parsed as ISO-8601 (values that do
    not parse become NA)."""
    if pd.api.types.is_datetime64_any_dtype(s):
        dt = pd.to_datetime(s)
    elif pd.api.types.is_numeric_dtype(s):
        dt = pd.to_datetime(s, unit="ms", errors="coerce")
    else:
        dt = pd.to_datetime(s, errors="coerce", format="ISO8601")
    if getattr(dt.dtype, "tz", None) is not None:
        dt = dt.dt.tz_convert("UTC").dt.tz_localize(None)
    vals = dt.astype("datetime64[ms]").astype("int64").to_numpy()
    return np.where(dt.isna().to_numpy(), np.nan, vals.astype(np.float64))


def series_to_host(s: pd.Series, kind: str):
    """A column as ``(kind, values, domain)`` on the host: codes with the
    sorted domain for enums (-1 = NA), an object array for strings, float64
    otherwise (epoch ms for time)."""
    if kind == STR:
        return STR, s.astype(object).where(s.notna(), None).to_numpy(), None
    if kind == CAT:
        if isinstance(s.dtype, pd.CategoricalDtype):
            domain = [str(c) for c in s.cat.categories]
            return CAT, s.cat.codes.to_numpy().astype(np.int32), domain
        ok = s.notna().to_numpy()
        sv = s[ok].astype(str)
        # levels interned in sorted order, as the JAX parser does
        domain = sorted(set(sv.unique()))
        codes = np.full(len(s), -1, dtype=np.int32)
        codes[ok] = pd.Categorical(sv, categories=domain).codes
        return CAT, codes, domain
    if kind == TIME:
        return TIME, _time_ms(s), None
    vals = pd.to_numeric(s, errors="coerce").to_numpy(dtype=np.float64)
    return (INT if kind == INT else NUM), vals, None


def parse_setup(path: str, sep: str | None = None) -> dict:
    """Sniff a file — JAX's ``parse_setup``: the separator of a text file
    and each column's kind from its first 10,000 rows."""
    if sep is None and _ext(path) not in _NOT_TEXT:
        sep = _sniff_sep(path)
    head = _read_any(path, sep=sep, nrows=_SETUP_ROWS)
    return {
        "source_frames": [path],
        "separator": sep or ",",
        "column_names": [str(c) for c in head.columns],
        "column_types": {str(c): infer_kind(head[c]) for c in head.columns},
        "rows_sniffed": len(head),
    }


def parse(setup: dict, device=None):
    """The whole of each source read and coerced to the setup's column
    types, onto ``device`` (``cuda`` unless given) — JAX's ``parse``
    without its streamed lane."""
    from h2o3_tpu_torch.frame.frame import Frame

    dfs = [_read_any(p, sep=setup.get("separator"))
           for p in setup["source_frames"]]
    df = pd.concat(dfs, ignore_index=True) if len(dfs) > 1 else dfs[0]
    return Frame.from_pandas(df, setup.get("column_types"), device=device)


def import_file(path: str, col_types: Mapping[str, str] | None = None,
                sep: str | None = None, device=None):
    """``h2o.import_file``: :func:`parse_setup`, the caller's ``col_types``
    over the sniffed ones, then :func:`parse`."""
    from h2o3_tpu_torch.device import resolve

    dev = resolve(device)
    setup = parse_setup(path, sep=sep)
    if col_types:
        setup["column_types"].update(col_types)
    return parse(setup, device=dev)


def upload_file(data, col_types: Mapping[str, str] | None = None,
                device=None):
    """``h2o.upload_file``: a path (as :func:`import_file`), a DataFrame or
    a dict of columns onto the device (``cuda`` unless ``device`` says
    otherwise)."""
    from h2o3_tpu_torch.frame.frame import Frame

    if isinstance(data, str):
        return import_file(data, col_types=col_types, device=device)
    df = data if isinstance(data, pd.DataFrame) else pd.DataFrame(data)
    return Frame.from_pandas(df, col_types, device=device)
