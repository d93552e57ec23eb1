"""File parsing in the port (``h2o3_tpu_torch.frame.parse`` and the ``time``
kind of ``frame.py``) against ``h2o3_tpu.frame.parse.import_file`` /
``upload_file``, on the CPU: each separator, each file format this machine
can read, ISO-8601 date strings, datetime64 uploads, and the 10,000-row
typing edge. Names, kinds, domains and ``to_numpy()`` must be equal
exactly — the same pandas readers and the same float32 / int8 / float64
storage. A GBM on a frame with a date column is held against JAX's within
1e-5 (float32 histogram sums added in another order).
"""

import gzip

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

from h2o3_tpu.frame import parse as jparse  # noqa: E402
from h2o3_tpu.models.tree.gbm import GBM as JGBM  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.frame import frame as pframe  # noqa: E402
from h2o3_tpu_torch.frame import parse as pparse  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM as PGBM  # noqa: E402


def parse_df(n=300, seed=0) -> pd.DataFrame:
    """An ISO date column, a float with NAs, an int, an enum with NAs and
    a near-unique string column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    return pd.DataFrame({
        "d": pd.date_range("2020-01-01", periods=n, freq="D").strftime(
            "%Y-%m-%d"),
        "x": x,
        "y": rng.integers(0, 10, n),
        "c": np.where(rng.random(n) < 0.05, None,
                      np.array(["lo", "mid", "hi"])[rng.integers(0, 3, n)]),
        "s": [f"id{i:05d}" for i in range(n)],
    })


def assert_same_frame(pf, jf):
    """Names, kinds, domains and host values equal to JAX's exactly."""
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


@pytest.mark.parametrize("sep,ext", [(",", ".csv"), (";", ".csv"),
                                     ("\t", ".tsv"), ("|", ".txt")],
                         ids=["comma", "semicolon", "tab", "pipe"])
def test_separators_match_jax(tmp_path, sep, ext):
    """The separator is sniffed among , \\t ; | on the first 5 lines, as
    JAX's ``_sniff_sep`` does: every column keeps its name and kind."""
    path = str(tmp_path / f"f{ext}")
    parse_df().to_csv(path, sep=sep, index=False)
    assert pparse._sniff_sep(path) == jparse._sniff_sep(path) == sep
    pf = h2o3_tpu_torch.import_file(path, device="cpu")
    assert [pf.vec(c).kind for c in pf.names] == [
        "time", "real", "int", "enum", "string"]
    assert_same_frame(pf, jparse.import_file(path))


def _write(df: pd.DataFrame, path: str, fmt: str) -> None:
    if fmt == "parquet":
        df.to_parquet(path)
    elif fmt == "feather":
        df.to_feather(path)
    elif fmt == "orc":
        df.to_orc(path)
    elif fmt == "gz":
        with gzip.open(path, "wt") as f:
            df.to_csv(f, sep=";", index=False)


@pytest.mark.parametrize("fmt,ext", [
    ("parquet", ".parquet"), ("feather", ".feather"), ("orc", ".orc"),
    ("gz", ".csv.gz")])
def test_formats_by_extension_match_jax(tmp_path, fmt, ext):
    """Parquet, Feather, ORC and a gzipped ;-separated text file, each
    dispatched on its extension."""
    df = parse_df().drop(columns=["d"])
    df["d"] = pd.date_range("2021-03-01", periods=len(df), freq="h")
    path = str(tmp_path / f"f{ext}")
    _write(df, path, fmt)
    pf = h2o3_tpu_torch.import_file(path, device="cpu")
    assert pf.vec("d").kind == "time"
    assert_same_frame(pf, jparse.import_file(path))


def test_svmlight_matches_jax(tmp_path):
    from sklearn.datasets import dump_svmlight_file

    rng = np.random.default_rng(3)
    X = rng.normal(size=(200, 6)) * (rng.random((200, 6)) < 0.4)
    y = rng.integers(0, 2, 200)
    path = str(tmp_path / "f.svm")
    dump_svmlight_file(X, y, path)
    pf = h2o3_tpu_torch.import_file(path, device="cpu")
    assert pf.names[0] == "target" and pf.ncol == 7
    assert_same_frame(pf, jparse.import_file(path))


def test_excel_without_its_reader_raises_as_jax(tmp_path):
    """A reader whose library is missing raises that library's
    ImportError in both packages (no silent CSV read)."""
    import zipfile

    try:
        import openpyxl  # noqa: F401
    except ImportError:
        # a zip with a workbook entry: pandas takes it for xlsx and asks
        # for openpyxl
        path = str(tmp_path / "f.xlsx")
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("xl/workbook.xml", "<workbook/>")
        for imp in (lambda: h2o3_tpu_torch.import_file(path, device="cpu"),
                    lambda: jparse.import_file(path)):
            with pytest.raises(ImportError):
                imp()
        return
    path = str(tmp_path / "f.xlsx")
    parse_df().drop(columns=["d"]).to_excel(path, index=False)
    assert_same_frame(h2o3_tpu_torch.import_file(path, device="cpu"),
                      jparse.import_file(path))


@pytest.mark.parametrize("values", [
    ["2020-01-01", "2020-02-29", None, "2021-12-31"],
    ["2020-01-01T10:30:00", "2020-01-02T00:00:01.250", None,
     "2020-06-30T23:59:59"],
    ["2020-01-01 10:30:00+02:00", "2020-01-02 00:00:00+02:00",
     "2020-03-01 12:00:00+02:00", None],
], ids=["dates", "iso-t", "offsets"])
def test_iso_dates_are_time_as_jax(tmp_path, values):
    """ISO-8601 strings type as ``time``: epoch milliseconds in UTC, NA as
    NaN, the exact float64 copy from ``to_numpy`` and float32 on the
    device."""
    df = pd.DataFrame({"t": values * 40, "v": np.arange(160.0)})
    path = str(tmp_path / "t.csv")
    df.to_csv(path, index=False)
    pf = h2o3_tpu_torch.import_file(path, device="cpu")
    jf = jparse.import_file(path)
    assert pf.vec("t").kind == "time"
    assert_same_frame(pf, jf)
    v = pf.vec("t")
    exact = v.to_numpy()
    assert exact.dtype == np.float64
    assert np.isnan(exact).sum() == 40
    np.testing.assert_array_equal(v.data.numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(
        exact, pparse._time_ms(pd.to_datetime(df["t"], format="ISO8601",
                                              utc=True)))


def test_datetime64_upload_and_numeric_time(tmp_path):
    """datetime64 columns of any resolution and timezone upload as
    ``time``; numbers typed ``time`` by the caller are epoch ms."""
    n = 50
    base = pd.date_range("2019-05-01", periods=n, freq="37min")
    df = pd.DataFrame({
        "ns": base,
        "s": base.astype("datetime64[s]"),
        "tz": base.tz_localize("US/Eastern"),
        "ms": (base.astype("datetime64[ms]").astype("int64")).astype(float),
    })
    df.loc[3, "ns"] = pd.NaT
    types = {"ms": "time"}
    pf = h2o3_tpu_torch.upload_file(df, col_types=types, device="cpu")
    jf = jparse.upload_file(df, col_types=types)
    assert [pf.vec(c).kind for c in pf.names] == ["time"] * 4
    assert_same_frame(pf, jf)
    np.testing.assert_array_equal(pf.vec("ms").to_numpy(),
                                  df["ms"].to_numpy())
    assert np.isnan(pf.vec("ns").to_numpy()[3])


def test_types_from_the_first_10000_rows(tmp_path):
    """A column numeric in its first 10,000 rows and text after types as
    numeric, and the text becomes NA, as JAX's ``parse_setup`` then
    ``parse`` do; a column of dates with text after stays time."""
    n = 10_050
    x = np.arange(n).astype(object)
    x[10_010] = "oops"
    d = pd.date_range("2000-01-01", periods=n, freq="h").strftime(
        "%Y-%m-%d %H:%M").to_numpy(dtype=object)
    d[10_020] = "not a date"
    path = str(tmp_path / "edge.csv")
    pd.DataFrame({"x": x, "d": d, "k": np.arange(n) % 7}).to_csv(
        path, index=False)
    setup = pparse.parse_setup(path)
    assert setup == jparse.parse_setup(path)
    assert setup["rows_sniffed"] == 10_000
    assert setup["column_types"] == {"x": "int", "d": "time", "k": "int"}
    pf = h2o3_tpu_torch.import_file(path, device="cpu")
    assert_same_frame(pf, jparse.import_file(path))
    assert np.isnan(pf.vec("x").to_numpy()[10_010])
    assert np.isnan(pf.vec("d").to_numpy()[10_020])


def test_col_types_override_and_parse_setup(tmp_path):
    """The caller's ``col_types`` win over the sniffed ones; the setup
    equals JAX's."""
    path = str(tmp_path / "f.csv")
    parse_df().to_csv(path, sep="|", index=False)
    assert pparse.parse_setup(path) == jparse.parse_setup(path)
    types = {"y": "enum", "d": "string"}
    pf = h2o3_tpu_torch.import_file(path, col_types=types, device="cpu")
    assert pf.vec("y").kind == "enum" and pf.vec("d").kind == "string"
    assert_same_frame(pf, jparse.import_file(path, col_types=types))


def test_infer_kind_is_the_frame_modules():
    """``frame.py`` keeps importing ``infer_kind``; its answers equal
    JAX's on each kind of column."""
    assert pframe.infer_kind is pparse.infer_kind
    cols = {
        "b": pd.Series([True, False, True]),
        "dt": pd.Series(pd.to_datetime(["2020-01-01", None, "2020-01-03"])),
        "cat": pd.Series(["a", "b", "a"], dtype="category"),
        "i": pd.Series([1, 2, 3]),
        "f": pd.Series([1.5, np.nan, 3.0]),
        "numstr": pd.Series(["1", "2.5", None]),
        "iso": pd.Series(["2020-01-01", "2020-01-02T03:04", None]),
        "notiso": pd.Series(["2020/01/01", "2020/01/02", "x"]),
        "empty": pd.Series([None, None], dtype=object),
        "uniq": pd.Series([f"u{i}" for i in range(200)]),
    }
    for name, s in cols.items():
        assert pparse.infer_kind(s) == jparse.infer_kind(s), name


def test_gbm_on_a_date_column_predicts_like_jax():
    """A time column is a numeric feature to the trees (binned from its
    float32 device values), as in JAX: a GBM trained on a date and a float
    column predicts like JAX's within 1e-5."""
    rng = np.random.default_rng(5)
    n = 1500
    days = rng.integers(0, 700, n)
    d = (pd.Timestamp("2022-01-01") + pd.to_timedelta(days, "D")).strftime(
        "%Y-%m-%d")
    x = np.round(rng.normal(size=n), 1)
    y = np.where((days > 350) ^ (x > 0.3) ^ (rng.random(n) < 0.1), "s", "b")
    df = pd.DataFrame({"d": d, "x": x, "label": y})
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    jf = jparse.upload_file(df)
    assert pf.vec("d").kind == jf.vec("d").kind == "time"
    kw = dict(ntrees=5, max_depth=3, seed=1)
    pm = PGBM(**kw).train(y="label", training_frame=pf)
    jm = JGBM(**kw).train(y="label", training_frame=jf)
    assert pm.output["names"] == jm.output["names"] == ["d", "x"]
    np.testing.assert_allclose(pm._predict_raw(pf).numpy(),
                               np.asarray(jm._predict_raw(jf))[:n],
                               atol=1e-5)
