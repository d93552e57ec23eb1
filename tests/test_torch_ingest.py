"""The port's ingest lanes (``h2o3_tpu_torch.native_csv`` and
``h2o3_tpu_torch.frame.parse``) against ``h2o3_tpu.native_csv`` and
``h2o3_tpu.frame.parse`` on the CPU, on the same bytes.

- The native lane: ``_try_native_csv`` of both packages on each dialect
  case of JAX's ``tests/test_native_csv.py`` (NA spellings, CRLF, a stray
  CR, blank lines, integers past 2^53, no trailing newline, gzip, quotes,
  a type surprise past the sample, a ragged row, a time column, duplicate
  headers): both decline, or both give equal DataFrames (dtypes, values
  and categories exact); ``import_file`` of each case equal to JAX's and
  recorded under the lane that parsed it; the thread split invisible.
- ``parse_stream`` at 500-row chunks on a file of numbers, integers,
  enums (levels first seen late, NAs), strings, times and one value a
  later chunk cannot parse: names, kinds, domains and values exact, and
  the warning in both.
- ``parse``'s dispatch by ``H2O3_TPU_STREAM_BYTES`` and
  ``H2O3_TPU_NATIVE_PARSE``: the same lane in both packages.
- ``parse_sharded`` under ``H2O3_TPU_INGEST_SHARDS`` 0-4: the same byte
  ranges as JAX's, equal to the one-range parse and to JAX's (its first
  ``nrow`` rows: JAX pads rows to its mesh), and the refusal of quoted
  files and of several processes; the ranges' first bytes found from the
  counting scan equal those of JAX's newline walk, and each range is
  tokenized natively.
- The port's library is built under ``h2o3_tpu_torch/_build/`` only.

The tests of the native lane skip without g++; the others do not need it.
"""

import gzip
import logging
import os

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

from h2o3_tpu import native_csv as jnative  # noqa: E402
from h2o3_tpu.frame import parse as jparse  # noqa: E402

from h2o3_tpu_torch import native_csv as pnative  # noqa: E402
from h2o3_tpu_torch.frame import parse as pparse  # noqa: E402


def _require_gxx():
    """Both packages' libraries, built on first use (skips without g++)."""
    if not (pnative.available() and jnative.available()):
        pytest.skip("no g++ toolchain to build libfastcsv")


@pytest.fixture
def needs_gxx():
    """For the tests of the native lane: the others hold without it."""
    _require_gxx()

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(body: str, name: str = "t.csv"):
    return lambda tmp_path: _write(tmp_path / name, body)


def _write(p, body: str) -> str:
    p.write_text(body)
    return str(p)


def _mixed(tmp_path) -> str:
    rng = np.random.default_rng(1)
    n = 3000
    df = pd.DataFrame({"x": rng.normal(size=n), "i": rng.integers(-1000, 1000, n),
                       "g": rng.choice(["red", "green", "blue"], n),
                       "y": rng.normal(size=n) * 1e12})
    df.loc[rng.random(n) < 0.03, "x"] = np.nan
    path = str(tmp_path / "m.csv")
    df.to_csv(path, index=False)
    return path


def _gz(tmp_path) -> str:
    p = tmp_path / "z.csv.gz"
    with gzip.open(p, "wt") as f:
        f.write("a,g\n1.25,u\n2.5,v\n")
    return str(p)


_SURPRISE = "a\n" + "\n".join(str(i) for i in range(3000)) + "\noops\n"

# JAX's dialect cases (tests/test_native_csv.py), as files
DIALECT = {
    "mixed": _mixed,
    "na_spellings_crlf": _text("a,g\r\n1.5,x\r\nNA,null\r\n,NaN\r\n+3.25,x\r\n"),
    "stray_cr_inside": _text("a,g\n1.5,x\ry\n2.5,z\n"),
    "stray_cr_ending_field": _text("a,g\n1.5,w\r,z\n"),
    "crlf_endings": _text("a,g\r\n1.5,x\r\n2.5,y\r\n"),
    "na_set": _text("g\na\nNone\nNAN\nb\n"),
    "blank_lines": _text("a\n1\n\n2\n"),
    "big_int64": _text("id\n9007199254740993\n9007199254740995\n"),
    "no_trailing_newline": _text("a,b\n1,2\n3,4"),
    "gz": _gz,
    "quoted": _text('a,g\n1,"x,y"\n2,z\n'),
    "numeric_surprise": _text(_SURPRISE),
    "ragged_row": _text("a,b\n1,2\n3,4,5\n"),
    "time_like": _text("t\n2024-01-01\n2024-01-02\n"),
    "duplicate_headers": _text("a,a\n1,2\n"),
}


def assert_same_df(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert list(a.columns) == list(b.columns)
    for c in a.columns:
        assert a[c].dtype == b[c].dtype, c
        if isinstance(a[c].dtype, pd.CategoricalDtype):
            assert list(a[c].cat.categories) == list(b[c].cat.categories), c
            np.testing.assert_array_equal(a[c].cat.codes, b[c].cat.codes, c)
        else:
            np.testing.assert_array_equal(a[c].to_numpy(), b[c].to_numpy(), c)


def assert_same_frame(pf, jf):
    """Names, kinds, domains and host values equal to JAX's (its first
    ``nrow`` rows)."""
    assert pf.names == jf.names
    assert pf.nrow == jf.nrow
    for name in jf.names:
        pv, jv = pf.vec(name), jf.vec(name)
        assert pv.kind == jv.kind, name
        assert pv.domain == jv.domain, name
        a, b = pv.to_numpy(), jv.to_numpy()
        if pv.kind == "string":
            assert list(a) == list(b), name
            continue
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b[: len(a)], err_msg=name)


@pytest.mark.usefixtures("needs_gxx")
@pytest.mark.parametrize("case", list(DIALECT))
def test_native_lane_matches_jax(tmp_path, case):
    """``_try_native_csv`` declines exactly where JAX's does and otherwise
    gives JAX's DataFrame; ``import_file`` gives JAX's frame and records
    the lane that parsed it."""
    path = DIALECT[case](tmp_path)
    got = pparse._try_native_csv(path, ",")
    assert_same_df(got, jparse._try_native_csv(path, ","))
    try:
        want = jparse.import_file(path)
    except Exception as e:  # pandas refuses the file: so must the port
        with pytest.raises(type(e)):
            pparse.import_file(path, device="cpu")
        return
    fr = pparse.import_file(path, device="cpu")
    assert pparse.PARSE_LANES[path] == ("pandas" if got is None else "native")
    assert_same_frame(fr, want)


@pytest.mark.usefixtures("needs_gxx")
def test_native_lane_outcomes():
    """The cases JAX's tests pin as declining decline in the port too, and
    the rest parse natively (so the lanes above are both exercised)."""
    declined = {"stray_cr_inside", "stray_cr_ending_field", "big_int64",
                "quoted", "numeric_surprise", "ragged_row", "time_like"}
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        for case, make in DIALECT.items():
            got = pparse._try_native_csv(make(Path(d)), ",")
            assert (got is None) == (case in declined), case


@pytest.mark.usefixtures("needs_gxx")
@pytest.mark.parametrize("threads", [1, 2, 3, 7])
def test_native_threads_match_jax(threads):
    """Rows, values and enum domains do not depend on the thread split:
    the port at each thread count equals JAX's single-thread parse."""
    rng = np.random.default_rng(3)
    n = 4000
    lines = ["x,g"] + [f"{rng.normal():.6g},{rng.choice(['u', 'v', 'w'])}"
                       for _ in range(n)]
    data = ("\n".join(lines) + "\n").encode()
    ref = jnative.parse_csv_native(data, ["x", "g"], [0, 1], n_threads=1)
    got = pnative.parse_csv_native(data, ["x", "g"], [0, 1],
                                   n_threads=threads)
    assert ref is not None
    assert_same_df(got, ref)


def _stream_df(n=3000, seed=5) -> pd.DataFrame:
    """Numbers with NAs, integers, an enum whose levels first appear past
    the first chunks (and NAs), an integer-coded enum with NAs in some
    chunks only, a near-unique string column and a date column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).round(5)
    x[rng.random(n) < 0.05] = np.nan
    e = np.array(["lo", "mid"], dtype=object)[rng.integers(0, 2, n)]
    late = np.arange(n) >= 1700
    e[late & (rng.random(n) < 0.3)] = "zz_late"
    e[late & (rng.random(n) < 0.2)] = "aa_late"
    e[rng.random(n) < 0.05] = None
    code = rng.integers(1, 4, n).astype(object)
    code[2200:2300][::7] = None  # NAs in the fifth chunk only
    days = rng.integers(0, 2000, n)
    return pd.DataFrame({
        "x": x, "i": rng.integers(-50, 50, n), "e": e, "code": code,
        "s": [f"id{i:06d}" for i in range(n)],
        "d": (pd.Timestamp("2018-01-01") + pd.to_timedelta(days, "D")
              ).strftime("%Y-%m-%d")})


def test_parse_stream_matches_jax(tmp_path, caplog):
    """``parse_stream`` at 500-row chunks: names, kinds, domains and values
    exactly JAX's (the time column as epoch ms of kind ``real``, as JAX
    streams it), and a number a later chunk cannot parse made NA with a
    warning in both. ``code``, an integer column typed as an enum, holds
    both "1" and "1.0" among its levels in both packages: a chunk with an
    NA reads the column as float64 before its labels are taken."""
    df = _stream_df()
    df["x"] = df["x"].astype(object)
    df.loc[2600, "x"] = "not_a_number"  # past the sniffed rows' chunks
    path = str(tmp_path / "s.csv")
    df.to_csv(path, index=False)
    types = {c: k for c, k in pparse.parse_setup(path)["column_types"].items()}
    # the type is fixed by the first chunk, as a 500-row sniff would
    types["x"] = "real"
    types["code"] = "enum"
    with pytest.warns(RuntimeWarning, match="1 non-numeric value"):
        pf = pparse.parse_stream([path], types, device="cpu", chunk_rows=500)
    with caplog.at_level(logging.WARNING, logger="h2o3_tpu"):
        jf = jparse.parse_stream([path], types, chunk_rows=500)
    assert any("1 non-numeric value" in r.getMessage()
               for r in caplog.records)
    assert pparse.PARSE_LANES[path] == "stream"
    assert_same_frame(pf, jf)
    assert pf.vec("d").kind == "real"
    assert pf.vec("e").domain == ("aa_late", "lo", "mid", "zz_late")
    assert {"1", "1.0"} <= set(pf.vec("code").domain)


_LANE_ENV = {  # the knobs that pick each lane, past the file's size
    "stream": {"H2O3_TPU_STREAM_BYTES": "{below}"},
    "native": {"H2O3_TPU_STREAM_BYTES": "{size}"},
    "pandas": {"H2O3_TPU_STREAM_BYTES": "{size}",
               "H2O3_TPU_NATIVE_PARSE": "0"},
}


@pytest.mark.parametrize("lane", list(_LANE_ENV))
def test_parse_dispatch_matches_jax(tmp_path, monkeypatch, lane):
    """A CSV above ``H2O3_TPU_STREAM_BYTES`` streams in both packages; one
    at or under it takes the native lane, or pandas under
    ``H2O3_TPU_NATIVE_PARSE=0``, in both (JAX's lane read by spies on its
    ``parse_stream`` and ``_try_native_csv``); the frames equal JAX's."""
    if lane == "native":
        _require_gxx()
    df = _stream_df(800).drop(columns=["s", "d", "code"])
    path = str(tmp_path / "d.csv")
    df.to_csv(path, index=False)
    size = os.path.getsize(path)
    for k, v in _LANE_ENV[lane].items():
        monkeypatch.setenv(k, v.format(below=size - 1, size=size))
    seen = []
    real_stream, real_native = jparse.parse_stream, jparse._try_native_csv

    def spy_stream(*a, **k):
        seen.append("stream")
        return real_stream(*a, **k)

    def spy_native(*a, **k):
        got = real_native(*a, **k)
        seen.append("pandas" if got is None else "native")
        return got

    monkeypatch.setattr(jparse, "parse_stream", spy_stream)
    monkeypatch.setattr(jparse, "_try_native_csv", spy_native)
    pf = pparse.import_file(path, device="cpu")
    jf = jparse.import_file(path)
    assert pparse.PARSE_LANES[path] == lane
    assert (seen or ["pandas"]) == [lane]
    assert_same_frame(pf, jf)


def _sharded_df(n=1000, seed=11) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).round(4)
    x[rng.random(n) < 0.05] = np.nan
    return pd.DataFrame({"x": x, "k": rng.integers(0, 9, n),
                         "g": rng.choice(["aa", "bb", "cc"], n)})


@pytest.mark.parametrize("shards", [0, 1, 2, 3, 4])
def test_parse_sharded_matches(tmp_path, monkeypatch, shards):
    """``parse_sharded`` with k byte ranges equals the one-range parse and
    JAX's sharded parse, and records the ``sharded`` lane."""
    path = str(tmp_path / "r.csv")
    _sharded_df().to_csv(path, index=False)
    setup = jparse.parse_setup(path)
    one = pparse.parse_sharded(dict(setup), device="cpu")
    monkeypatch.setenv("H2O3_TPU_INGEST_SHARDS", str(shards))
    ranges = {pparse: [], jparse: []}
    for mod, calls in ranges.items():
        real = mod._read_rank_rows
        monkeypatch.setattr(mod, "_read_rank_rows", lambda *a, _r=real,
                            _c=calls: _c.append(a[4:6]) or _r(*a))
    pf = pparse.parse_sharded(dict(setup), device="cpu")
    jf = jparse.parse_sharded(dict(setup))
    assert pparse.PARSE_LANES[path] == "sharded"
    assert ranges[pparse] == ranges[jparse]
    assert len(ranges[pparse]) == max(shards, 1)
    assert_same_frame(pf, one)
    assert_same_frame(pf, jf)


@pytest.mark.parametrize("block", [64, 1000, 1 << 22])
def test_row_offsets_match_line_walk(tmp_path, block):
    """The ranges' first bytes, found from the counting scan's newlines
    before each block, equal those of JAX's walk over every newline, at
    blocks that put the rows in many blocks, in a few and in one."""
    path = str(tmp_path / "r.csv")
    _sharded_df(500).to_csv(path, index=False)
    with open(path, "rb") as f:
        data = f.read()
    before = [data[:i * block].count(b"\n")
              for i in range(-(-len(data) // block))]
    rows = [0, 1, 166, 250, 333, 499, 500]
    got = pparse._row_offsets(path, rows, before, block)
    assert got == jparse._data_line_offsets(path, set(rows))
    assert got[500] == len(data)


@pytest.mark.usefixtures("needs_gxx")
def test_parse_sharded_ranges_parse_natively(tmp_path, monkeypatch):
    """Each of the k ranges is tokenized by the native parser from the
    offsets of the one counting scan, with no walk of the newlines."""
    path = str(tmp_path / "r.csv")
    _sharded_df().to_csv(path, index=False)
    monkeypatch.setenv("H2O3_TPU_INGEST_SHARDS", "3")
    parsed = []
    real = pnative.parse_csv_native

    def spy(*a, **k):
        got = real(*a, **k)
        parsed.append(None if got is None else len(got))
        return got

    monkeypatch.setattr(pnative, "parse_csv_native", spy)
    monkeypatch.setattr(pparse, "_data_line_offsets", None)  # not called
    fr = pparse.parse_sharded({"source_frames": [path]}, device="cpu")
    assert parsed == [333, 333, 334]
    assert fr.nrow == 1000


def test_parse_sharded_refusals(tmp_path, monkeypatch):
    """Quoted files are refused in both packages; a string column too; a
    multi-process parse is Queue A 8's."""
    path = str(tmp_path / "q.csv")
    with open(path, "w") as f:
        f.write('x,g\n1.0,"a,b"\n2.0,c\n')
    for mod in (pparse, jparse):
        kw = {"device": "cpu"} if mod is pparse else {}
        with pytest.raises(ValueError, match="unquoted"):
            mod.parse_sharded({"source_frames": [path]}, **kw)
    spath = str(tmp_path / "s.csv")
    pd.DataFrame({"s": [f"id{i}" for i in range(200)]}).to_csv(spath,
                                                              index=False)
    with pytest.raises(ValueError, match="string column"):
        pparse.parse_sharded({"source_frames": [spath]}, device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="Queue A 8"):
        pparse.parse_sharded({"source_frames": [spath]}, device="cpu")


def test_parse_sharded_seeds_host_copies_under_window(tmp_path, monkeypatch):
    """With the out-of-core window set, each parsed column's host copy is
    the parsed block itself (no device read), equal to the device values."""
    path = str(tmp_path / "r.csv")
    _sharded_df(300).to_csv(path, index=False)
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(1 << 20))
    fr = pparse.parse_sharded({"source_frames": [path]}, device="cpu")
    for name in fr.names:
        v = fr.vec(name)
        assert v._hostbuf is not None, name
        np.testing.assert_array_equal(v.host_values(), v.data.numpy())


@pytest.mark.usefixtures("needs_gxx")
def test_library_built_under_the_port_build_dir(tmp_path, monkeypatch):
    """The port builds ``libfastcsv`` into its own build directory (here a
    temporary one) and never writes the JAX package's ``native/`` copy; a
    failed build is recorded and the lane falls to pandas."""
    assert pnative.library_path().parent == pnative.BUILD_DIR
    assert pnative.BUILD_DIR == pnative._PKG / "_build"
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "BUILD_ERROR", None)
    outputs = []  # every file g++ is asked to write
    real_run = pnative.subprocess.run

    def spy_run(cmd, *a, **k):
        outputs.append(os.path.realpath(cmd[cmd.index("-o") + 1]))
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(pnative.subprocess, "run", spy_run)
    assert pnative.available()
    built = sorted(p.name for p in (tmp_path / "_build").iterdir())
    assert built == ["libfastcsv.lock", pnative.library_path().name]
    native_dir = os.path.realpath(os.path.join(_REPO, "native"))
    assert len(outputs) == 1
    assert os.path.dirname(outputs[0]) == os.path.realpath(tmp_path / "_build")
    assert not outputs[0].startswith(native_dir + os.sep)
    # a build that fails: recorded, and the native lane declines
    monkeypatch.setattr(pnative, "_LIB", None)
    monkeypatch.setattr(pnative, "SRC", tmp_path / "missing.cpp")
    (tmp_path / "missing.cpp").write_text("this is not C++\n")
    assert not pnative.available()
    assert "g++ failed" in pnative.BUILD_ERROR
    path = _write(tmp_path / "a.csv", "a\n1\n2\n")
    pparse.import_file(path, device="cpu")
    assert pparse.PARSE_LANES[path] == "pandas"
