"""Ingest — the port of ``h2o3_tpu/frame/parse.py``: the reader dispatched
on the file extension, separator sniffing, column typing on the first
10,000 rows (``parse_setup``), the parse itself (``parse``), and
``import_file`` / ``upload_file`` on top.

Formats, as in JAX: CSV / TSV / text with the separator guessed among
``,`` ``\\t`` ``;`` ``|`` (and ``.gz`` of any of them), Parquet, ORC,
Feather/Arrow, SVMLight, and XLS(X) through pandas when its reader library
is installed (the library's ``ImportError`` otherwise). ISO-8601 date
strings and datetime64 columns parse as the ``time`` kind, stored as epoch
milliseconds (UTC).

The lanes of a text file, chosen as JAX chooses them:

- ``stream``: a CSV source above ``H2O3_TPU_STREAM_BYTES`` (256 MB by
  default), or ``setup["stream"]``, is read in 1M-row pandas chunks
  (:func:`parse_stream`), enum levels interned chunk by chunk and sorted at
  the end;
- ``native``: an eligible CSV (``H2O3_TPU_NATIVE_PARSE``, on by default)
  goes through the C++ tokenizer ``native/fastcsv.cpp``
  (:mod:`h2o3_tpu_torch.native_csv`, :func:`_try_native_csv`), its column
  types decided on a pandas sample of 2,000 rows;
- ``pandas``: any other file, and a CSV outside the native dialect
  (quotes, a stray CR, a type surprise past the sample, integers of 2^53
  and above, time columns);
- ``sharded``: :func:`parse_sharded`, called directly, splits one plain
  CSV into ``H2O3_TPU_INGEST_SHARDS`` byte ranges each parsed on its own.

:data:`PARSE_LANES` records which lane parsed each source. ``lazy=True``
(:mod:`h2o3_tpu_torch.frame.lazy`) defers each column's load to its first
use.
"""

from __future__ import annotations

import bisect
import gzip
import io
import os
import warnings
from typing import Mapping, Sequence

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
_STREAM_CHUNK_ROWS = 1_000_000
_NATIVE_SNIFF_BYTES = 4 << 20  # the native lane types columns on this prefix
_NATIVE_SNIFF_ROWS = 2000
_SCAN_BLOCK = 1 << 22  # parse_sharded's counting scan reads this many bytes

# source path -> the lane of its latest parse: "native", "pandas", "stream"
# or "sharded"
PARSE_LANES: dict[str, str] = {}


def _ext(path: str) -> str:
    return os.path.splitext(path.removesuffix(".gz"))[1].lower()


def _kind_name(k: str) -> str:
    """A column type as the caller may spell it, as a kind."""
    return {"numeric": NUM, "float": NUM, "double": NUM, "factor": CAT,
            "categorical": CAT}.get(k, k)


def _read_any(path: str, sep: str | None = None, header: int | None = 0,
              nrows: int | None = None) -> pd.DataFrame:
    """The file as a DataFrame, by its extension (JAX's ``_read_any``);
    ``nrows`` limits the text and Excel readers, as in JAX. A whole text
    file with a header goes through the native lane when it is on and the
    file is eligible. A whole read records its lane in
    :data:`PARSE_LANES`."""
    lane = "pandas"
    ext = _ext(path)
    if ext in (".parquet", ".pq"):
        df = pd.read_parquet(path)
    elif ext == ".orc":
        df = pd.read_orc(path)
    elif ext in (".feather", ".arrow"):
        df = pd.read_feather(path)
    elif ext in (".xls", ".xlsx"):
        df = pd.read_excel(path, nrows=nrows)
    elif ext in (".svm", ".svmlight"):
        from sklearn.datasets import load_svmlight_file

        X, y = load_svmlight_file(path)
        df = pd.DataFrame(X.toarray(),
                          columns=[f"C{i + 1}" for i in range(X.shape[1])])
        df.insert(0, "target", y)
    else:  # CSV / TSV / text (+ .gz through pandas)
        from h2o3_tpu_torch import config

        sep = sep or _sniff_sep(path)
        df = None
        if (header == 0 and nrows is None
                and config.get_bool("H2O3_TPU_NATIVE_PARSE")):
            df = _try_native_csv(path, sep)
            lane = "pandas" if df is None else "native"
        if df is None:
            df = pd.read_csv(path, sep=sep, header=header, engine="c",
                             nrows=nrows)
    if nrows is None:
        PARSE_LANES[path] = lane
    return df


def _try_native_csv(path: str, sep: str) -> pd.DataFrame | None:
    """The native lane (JAX's ``_try_native_csv``): None whenever the file
    is outside the fast path, and the caller then uses pandas. The column
    types come from a pandas read of the first 2,000 rows of a 4 MB prefix,
    so both lanes agree on them: float and integer columns are numeric,
    string columns that sniff as enums are enums, anything else (bool,
    time, string, duplicate names) declines.

    A column whose sampled rows are integers becomes int64 when the whole
    column is NA-free and integral; a value of 2^53 or above declines (only
    pandas' int64 parse is exact there). As in JAX, an integral value
    written as a decimal ("2.0") past the sample keeps the column integer
    where pandas would make it float: H2O types by value.
    """
    from h2o3_tpu_torch import native_csv

    if not native_csv.available():
        return None

    def opener():
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path,
                                                                        "rb")

    try:
        # types from a bounded prefix first: an ineligible large file is not
        # read whole only for pandas to read it again
        with opener() as f:
            prefix = f.read(_NATIVE_SNIFF_BYTES)
        if len(prefix) == _NATIVE_SNIFF_BYTES:
            cut = prefix.rfind(b"\n")  # drop the partial last line
            if cut < 0:
                return None
            prefix = prefix[: cut + 1]
        sample = pd.read_csv(io.BytesIO(prefix), sep=sep,
                             nrows=_NATIVE_SNIFF_ROWS, engine="c")
    except Exception:  # noqa: BLE001 — any trouble in the sniff: pandas
        return None
    names = [str(c) for c in sample.columns]
    if len(set(names)) != len(names):
        return None
    kinds: list[int] = []
    int_named = []
    for c in sample.columns:
        s = sample[c]
        if pd.api.types.is_bool_dtype(s):
            return None
        if pd.api.types.is_integer_dtype(s):
            kinds.append(0)
            int_named.append(str(c))
        elif pd.api.types.is_float_dtype(s):
            kinds.append(0)
        elif (pd.api.types.is_object_dtype(s)
              or pd.api.types.is_string_dtype(s)) and infer_kind(s) == CAT:
            kinds.append(1)
        else:  # time, string or mixed: pandas' semantics
            return None
    try:
        with opener() as f:
            data = f.read()
        df = native_csv.parse_csv_native(data, names, kinds, sep=sep)
    except Exception:  # noqa: BLE001 — any native trouble: pandas
        return None
    if df is None:
        return None
    for c in int_named:
        v = df[c].to_numpy()
        if np.any(np.abs(v) >= 2**53):
            return None  # float64 already rounded these
        if not np.isnan(v).any() and np.all(v == np.floor(v)):
            df[c] = v.astype(np.int64)
    return df


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


def _mixed_time_ms(s: pd.Series) -> np.ndarray:
    """Epoch milliseconds as float64 of strings in any format pandas reads
    (``format="mixed"``, UTC), NaN where one does not parse — the time
    lane of JAX's streamed and lazy parses."""
    dt = pd.to_datetime(s, errors="coerce", format="mixed", utc=True)
    dt = dt.dt.tz_localize(None)
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


def _is_csv_like(path: str) -> bool:
    return _ext(path) not in _NOT_TEXT


def parse_stream(paths: Sequence[str], column_types: Mapping[str, str],
                 sep: str | None = None, device=None,
                 destination_frame: str | None = None,
                 chunk_rows: int = _STREAM_CHUNK_ROWS):
    """Chunked CSV ingest (JAX's ``parse_stream``): each source read by
    pandas in chunks of ``chunk_rows`` rows, the column kinds fixed by
    ``column_types`` (else by the first chunk), enum levels interned chunk
    by chunk (``pd.factorize`` of the chunk's labels, its small domain
    mapped into the column's) and sorted at the end, which remaps the
    codes. Strings stay on the host, time columns become epoch
    milliseconds of kind ``real`` (as in JAX). A later chunk's value that
    does not parse as its column's number becomes NA, with a warning that
    counts them."""
    from h2o3_tpu_torch.device import resolve
    from h2o3_tpu_torch.frame.frame import Frame, Vec

    dev = resolve(device)
    col_order: list[str] | None = None
    kinds: dict[str, str] = {}
    num_parts: dict[str, list[np.ndarray]] = {}
    cat_parts: dict[str, list[np.ndarray]] = {}
    str_parts: dict[str, list[np.ndarray]] = {}
    domains: dict[str, dict[str, int]] = {}
    coerce_losses: dict[str, int] = {}
    for path in paths:
        reader = pd.read_csv(path, sep=sep or _sniff_sep(path), engine="c",
                             chunksize=chunk_rows)
        for chunk in reader:
            if col_order is None:
                col_order = [str(c) for c in chunk.columns]
                for c in col_order:
                    kinds[c] = _kind_name(column_types.get(c)
                                          or infer_kind(chunk[c]))
            for c in col_order:
                s, k = chunk[c], kinds[c]
                if k == CAT:
                    local_codes, local_levels = pd.factorize(
                        s.astype(str).where(s.notna(), None))
                    lut = domains.setdefault(c, {})
                    remap = np.empty(len(local_levels) + 1, np.int32)
                    for li, lv in enumerate(local_levels):
                        remap[li] = lut.setdefault(str(lv), len(lut))
                    remap[-1] = -1  # factorize's NA code
                    cat_parts.setdefault(c, []).append(
                        remap[local_codes.astype(np.int64)])
                elif k == STR:
                    str_parts.setdefault(c, []).append(
                        s.astype(object).where(s.notna(), None).to_numpy())
                elif k == TIME:
                    num_parts.setdefault(c, []).append(_mixed_time_ms(s))
                else:
                    vals = pd.to_numeric(s, errors="coerce").to_numpy(
                        np.float64)
                    lost = int((np.isnan(vals) & s.notna().to_numpy()).sum())
                    if lost:
                        coerce_losses[c] = coerce_losses.get(c, 0) + lost
                    num_parts.setdefault(c, []).append(vals)
    if col_order is None:
        raise ValueError("empty parse input")
    for c, lost in coerce_losses.items():
        warnings.warn(
            f"stream parse: column {c!r} (typed {kinds[c]} from the sniff) "
            f"had {lost} non-numeric value(s) in later chunks coerced to NA "
            "— pass column_types to override the sniffed type",
            RuntimeWarning, stacklevel=2)
    vecs = []
    for c in col_order:
        k = kinds[c]
        if k == CAT:
            codes = np.concatenate(cat_parts[c])
            levels = list(domains[c])
            order = sorted(range(len(levels)), key=levels.__getitem__)
            remap = np.empty(len(levels) + 1, np.int32)
            remap[order] = np.arange(len(levels), dtype=np.int32)
            remap[-1] = -1  # the NA slot
            vecs.append(Vec.from_numpy(remap[codes], CAT, name=c,
                                       domain=[levels[i] for i in order],
                                       device=dev))
        elif k == STR:
            vecs.append(Vec(np.concatenate(str_parts[c]), STR, name=c,
                            device=dev))
        else:
            vecs.append(Vec.from_numpy(np.concatenate(num_parts[c]),
                                       INT if k == INT else NUM, name=c,
                                       device=dev))
    for path in paths:
        PARSE_LANES[path] = "stream"
    return Frame(vecs, col_order, key=destination_frame)


def _data_line_offsets(path: str, wanted: set[int]) -> dict[int, int]:
    """Byte offsets where the requested 0-based data rows start (the header
    is file line 0): one streaming block scan in O(1) memory (JAX's
    ``_data_line_offsets``)."""
    out: dict[int, int] = {}
    remaining = set(wanted)
    line = pos = 0  # newlines seen so far, bytes before this block
    with open(path, "rb") as f:
        while remaining:
            block = f.read(1 << 22)
            if not block:
                break
            idx = 0
            while remaining:
                j = block.find(b"\n", idx)
                if j < 0:
                    break
                # data row `line` starts right after file line `line` ends
                if line in remaining:
                    out[line] = pos + j + 1
                    remaining.discard(line)
                line += 1
                idx = j + 1
            pos += len(block)
    return out


def _row_offsets(path: str, rows, newlines_before: list[int],
                 block: int) -> dict[int, int]:
    """Byte offsets where the given 0-based data rows start, from the
    newline counts a scan took in blocks of ``block`` bytes
    (``newlines_before[i]``: the newlines before block i): one block read
    a row, not a walk from the file's start. A row past the last newline
    is left out."""
    out: dict[int, int] = {}
    with open(path, "rb") as f:
        for r in rows:
            # data row r starts right after the file's newline number r
            i = bisect.bisect_right(newlines_before, r) - 1
            if i < 0:
                continue
            f.seek(i * block)
            at = np.flatnonzero(np.frombuffer(f.read(block), np.uint8)
                                == ord("\n"))
            j = r - newlines_before[i]
            if j < len(at):
                out[r] = i * block + int(at[j]) + 1
    return out


def _read_rank_rows(path, sep, col_order, kinds, lo: int, hi: int, n: int,
                    offsets: dict[int, int] | None = None):
    """Data rows ``[lo, hi)`` as a DataFrame (JAX's ``_read_rank_rows``):
    the byte range (from ``offsets``, the rows' start bytes, when the
    caller has them, else located by a newline scan) tokenized by the
    native parser when it is on and the range is in its dialect, else
    pandas re-reading the file with ``skiprows``. The caller has refused
    quoted files, so a raw newline is a record's end."""
    from h2o3_tpu_torch import config, native_csv

    if (hi > lo and config.get_bool("H2O3_TPU_NATIVE_PARSE")
            and native_csv.available()):
        try:
            offs = offsets if offsets is not None else _data_line_offsets(
                path, {lo, hi} if hi < n else {lo})
            start = offs.get(lo)
            end = offs.get(hi, os.path.getsize(path))
            if start is not None:
                with open(path, "rb") as f:
                    f.seek(start)
                    data = f.read(end - start)
                got = native_csv.parse_csv_native(
                    data, col_order, [int(kinds[c] == CAT) for c in col_order],
                    sep=sep, has_header=False)
                if got is not None and len(got) == hi - lo:
                    return got
        except Exception:  # noqa: BLE001 — any native trouble: pandas
            pass
    return pd.read_csv(path, sep=sep, skiprows=range(1, lo + 1),
                       nrows=max(hi - lo, 0), header=0, names=col_order)


def parse_sharded(setup: dict, device=None,
                  destination_frame: str | None = None):
    """Byte-range ingest of one plain CSV (JAX's ``parse_sharded`` on one
    process): the rows counted by one newline scan, which also refuses any
    double quote (a quoted field could hide a newline and break the row
    addressing) and notes the newlines before each block, so that each
    range's first byte is found with one block read; the kinds sniffed on 1,000 rows (numeric, integer and
    enum columns only); the rows read as ``H2O3_TPU_INGEST_SHARDS`` byte
    ranges (0 or 1: one range), each parsed on its own and concatenated;
    enum levels interned per range and unified sorted. With the
    out-of-core plane's window set, each column's parsed block becomes its
    host copy (``Vec.host_values`` then costs nothing). JAX's multi-process
    branch (each rank its own range, the domains allgathered) is ROADMAP
    Queue A 8."""
    import torch

    from h2o3_tpu_torch import config
    from h2o3_tpu_torch.device import resolve
    from h2o3_tpu_torch.frame import chunkstore as cs
    from h2o3_tpu_torch.frame.frame import Frame, Vec

    if (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise NotImplementedError(
            "parse_sharded across processes is not ported (ROADMAP Queue "
            "A 8): call it on one process")
    dev = resolve(device)
    paths = setup["source_frames"]
    if len(paths) != 1 or not str(paths[0]).endswith(".csv"):
        raise ValueError("sharded parse v1 handles exactly one plain .csv")
    path = str(paths[0])
    newlines = quotes = 0
    newlines_before = []  # a block's start: where the ranges' rows are found
    last = b"\n"
    with open(path, "rb") as f:
        while True:
            block = f.read(_SCAN_BLOCK)
            if not block:
                break
            newlines_before.append(newlines)
            newlines += block.count(b"\n")
            quotes += block.count(b'"')
            last = block[-1:]
    if quotes:
        raise ValueError(
            "sharded parse v1 requires unquoted CSV (a quoted field could "
            "embed a newline, breaking row addressing); re-export without "
            "quotes or use the single-host parse")
    n = max(newlines + (0 if last == b"\n" else 1) - 1, 0)  # less the header
    sep = setup.get("separator") or _sniff_sep(path)
    sample = pd.read_csv(path, sep=sep, nrows=1000)
    col_order = [str(c) for c in sample.columns]
    types = setup.get("column_types") or {}
    kinds = {}
    for c in col_order:
        k = _kind_name(types.get(c) or infer_kind(sample[c]))
        if k in (STR, TIME):
            raise ValueError(
                f"sharded parse v1 does not support {k} column {c!r} "
                "(host-resident / needs exact f64)")
        kinds[c] = k
    k_ranges = max(config.get_int("H2O3_TPU_INGEST_SHARDS"), 0)
    bounds = ([n * j // k_ranges for j in range(k_ranges + 1)]
              if k_ranges > 1 and n > 0 else [0, n])
    offsets = _row_offsets(path, sorted(set(bounds)), newlines_before,
                           _SCAN_BLOCK)
    if len(bounds) > 2:
        local = pd.concat(
            [_read_rank_rows(path, sep, col_order, kinds, a, b, n, offsets)
             for a, b in zip(bounds, bounds[1:]) if b > a],
            ignore_index=True)
    else:
        local = _read_rank_rows(path, sep, col_order, kinds, 0, n, n,
                                offsets)
    seed_host = cs.streaming_enabled()
    vecs = []
    for c in col_order:
        if kinds[c] == CAT:
            codes, levels = pd.factorize(
                local[c].astype(str).where(local[c].notna(), None))
            levels = [str(v) for v in levels]
            union = sorted(levels)  # H2O interns levels sorted
            lut = {lv: i for i, lv in enumerate(union)}
            dt, _ = Vec.device_dtype(CAT, union)
            remap = np.array([lut[lv] for lv in levels] or [0], dt)
            host = np.where(codes >= 0, remap[np.clip(codes, 0, None)],
                            -1).astype(dt)
            kind, domain = CAT, tuple(union)
        else:
            host = pd.to_numeric(local[c], errors="coerce").to_numpy(
                np.float32)
            kind, domain = (INT if kinds[c] == INT else NUM), None
        host = np.ascontiguousarray(host)
        v = Vec(torch.from_numpy(host).to(dev), kind, name=c, domain=domain,
                nrow=n)
        if seed_host:
            v.seed_host(host)
        vecs.append(v)
    PARSE_LANES[path] = "sharded"
    return Frame(vecs, col_order, key=destination_frame)


def parse(setup: dict, device=None, destination_frame: str | None = None):
    """Each source parsed with the setup's column types onto ``device``
    (``cuda`` unless given) — JAX's ``parse``: text sources above
    ``H2O3_TPU_STREAM_BYTES`` together (or ``setup["stream"]``) take the
    chunked :func:`parse_stream`; the others are read whole, an eligible
    CSV by the native parser."""
    from h2o3_tpu_torch import config
    from h2o3_tpu_torch.frame.frame import Frame

    paths = setup["source_frames"]
    csv_like = all(_is_csv_like(p) for p in paths)
    want_stream = bool(setup.get("stream"))
    if not want_stream and csv_like:
        try:
            total = sum(os.path.getsize(p) for p in paths)
            want_stream = total > config.get_int("H2O3_TPU_STREAM_BYTES")
        except OSError:
            pass
    if want_stream and csv_like:
        return parse_stream(paths, setup.get("column_types") or {},
                            sep=setup.get("separator"), device=device,
                            destination_frame=destination_frame)
    dfs = [_read_any(p, sep=setup.get("separator")) for p in paths]
    df = pd.concat(dfs, ignore_index=True) if len(dfs) > 1 else dfs[0]
    return Frame.from_pandas(df, setup.get("column_types"), device=device,
                             destination_frame=destination_frame)


def import_file(path: str, col_types: Mapping[str, str] | None = None,
                sep: str | None = None, device=None,
                destination_frame: str | None = None, lazy: bool = False):
    """``h2o.import_file``: :func:`parse_setup`, the caller's ``col_types``
    over the sniffed ones, then :func:`parse`. ``lazy=True`` defers each
    column's load to its first use (``frame/lazy.py``)."""
    from h2o3_tpu_torch.device import resolve

    dev = resolve(device)
    if lazy:
        from h2o3_tpu_torch.frame.lazy import import_file_lazy

        return import_file_lazy(path, col_types=col_types, sep=sep,
                                device=dev,
                                destination_frame=destination_frame)
    setup = parse_setup(path, sep=sep)
    if col_types:
        setup["column_types"].update(col_types)
    return parse(setup, device=dev, destination_frame=destination_frame)


def upload_file(data, col_types: Mapping[str, str] | None = None,
                device=None, destination_frame: str | None = None):
    """``h2o.upload_file``: a path (as :func:`import_file`), a DataFrame or
    a dict of columns onto the device (``cuda`` unless ``device`` says
    otherwise)."""
    from h2o3_tpu_torch.frame.frame import Frame

    if isinstance(data, str):
        return import_file(data, col_types=col_types, device=device,
                           destination_frame=destination_frame)
    df = data if isinstance(data, pd.DataFrame) else pd.DataFrame(data)
    return Frame.from_pandas(df, col_types, device=device,
                             destination_frame=destination_frame)
