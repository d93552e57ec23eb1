"""The port's deferred columns (``h2o3_tpu_torch.frame.lazy``) against
``h2o3_tpu.frame.lazy`` on the CPU.

- ``LazyVec``: nothing loads until a column's values are read, and
  ``import_file(lazy=True)`` of a CSV and a Parquet file equals the eager
  frame and JAX's lazy one (names, kinds, domains, values exact); a GBM on
  a lazy frame equals one on the eager frame and loads only its columns.
- ``wrap_domain`` equals JAX's.
- ``LazyExprVec``: operator chains under ``H2O3_TPU_MUNGE_FUSE=1`` against
  JAX's with ``tests/test_torch_frame_ops.py``'s tolerances (1e-6 relative
  and 1e-6 absolute, ``_UNOP_TOL`` where two libms differ), and bit-equal
  to the port's ``H2O3_TPU_MUNGE_FUSE=0`` operators; graphs splice and
  share leaves.
- Through the out-of-core window: the streamed evaluation and the
  streamed group-by equal the resident ones, with the store's peak within
  the window. Arithmetic, comparisons, ``sqrt`` and ``ifelse`` are
  bit-equal; ``exp`` and ``log`` within one float32 ulp (2^-23 relative),
  because PyTorch's CPU kernels run a vector body and a scalar tail with
  two libms, so a transcendental's last bit depends on where a row falls
  in its block (on the card every element takes the same path).
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import h2o3_tpu  # noqa: E402
from h2o3_tpu.frame import lazy as jlazy  # noqa: E402
from h2o3_tpu.frame import ops as jops  # noqa: E402
from h2o3_tpu.frame import parse as jparse  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.frame import chunkstore as pcs  # noqa: E402
from h2o3_tpu_torch.frame import lazy as plazy  # noqa: E402
from h2o3_tpu_torch.frame import ops as pops  # noqa: E402
from h2o3_tpu_torch.frame.frame import Vec as PVec  # noqa: E402
from h2o3_tpu_torch.models.tree.gbm import GBM as PGBM  # noqa: E402

N = 2000
FLOAT_RTOL = 1e-6  # tests/test_torch_frame_ops.py's
_UNOP_TOL = {"gamma": (2e-5, 1e-6), "lgamma": (FLOAT_RTOL, 4e-6)}
ULP = 2.0 ** -23


def lazy_df(n=N, seed=0) -> pd.DataFrame:
    """Numbers with NaN, an integer column, an enum with NAs, a date
    column and a binary label."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).round(4)
    x[rng.random(n) < 0.1] = np.nan
    e = np.array(["lo", "mid", "hi"], dtype=object)[rng.integers(0, 3, n)]
    e[rng.random(n) < 0.05] = None
    days = rng.integers(0, 3000, n)
    return pd.DataFrame({
        "x": x, "y": (rng.normal(size=n) * 3).round(3),
        "k": rng.integers(0, 20, n), "e": e,
        "d": (pd.Timestamp("2016-01-01") + pd.to_timedelta(days, "D")
              ).strftime("%Y-%m-%d"),
        "f0": rng.integers(0, 16, n) / 4.0, "f1": rng.integers(0, 16, n) / 4.0,
        "label": np.where(rng.random(n) < 0.4, "yes", "no")})


@pytest.fixture(scope="module")
def df():
    return lazy_df()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_vec(pv, jv, rtol=0.0, atol=0.0, name=""):
    a, b = pv.to_numpy(), jv.to_numpy()  # a lazy enum's domain comes now
    assert pv.kind == jv.kind, name
    assert pv.domain == jv.domain, name
    assert len(a) == len(b), name
    if pv.kind == "string":
        assert list(a) == list(b), name
    elif rtol or atol:
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=rtol, atol=atol, equal_nan=True,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_frames(pf, other):
    assert pf.names == other.names
    assert pf.nrow == other.nrow
    for n in pf.names:
        assert_vec(pf.vec(n), other.vec(n), name=n)


def _file(tmp_path, df, fmt) -> str:
    path = str(tmp_path / f"f.{fmt}")
    if fmt == "csv":
        df.to_csv(path, index=False)
    else:
        df.to_parquet(path)
    return path


def test_lazyvec_defers_until_first_touch(tmp_path, df):
    """A lazy import loads nothing; reading one column's values loads that
    column alone, once."""
    path = _file(tmp_path, df, "csv")
    fr = h2o3_tpu_torch.import_file(path, device="cpu", lazy=True)
    assert all(isinstance(fr.vec(n), plazy.LazyVec) for n in fr.names)
    assert fr.resident_bytes() == {"hbm": 0, "host": 0}
    assert not any(fr.vec(n).is_materialized for n in fr.names)
    assert fr.nrow == len(df) and fr.device.type == "cpu"
    loads = plazy.LAZY_EVENTS["loads"]
    x = fr.vec("x").data
    assert x.shape == (len(df),)
    assert plazy.LAZY_EVENTS["loads"] == loads + 1
    fr.vec("x").data  # noqa: B018  (a second read loads nothing)
    assert plazy.LAZY_EVENTS["loads"] == loads + 1
    assert [n for n in fr.names if fr.vec(n).is_materialized] == ["x"]
    assert fr.resident_bytes()["hbm"] == 4 * len(df)
    # an enum's domain is interned on its first read
    assert fr.vec("e").domain == ("hi", "lo", "mid")
    assert fr.vec("e").is_materialized


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_import_file_lazy_equals_eager(tmp_path, df, fmt):
    """Every lazy column equals the eager parse's and JAX's lazy import's:
    kinds, domains, values, a time column's exact float64 copy."""
    path = _file(tmp_path, df, fmt)
    lazy = h2o3_tpu_torch.import_file(path, device="cpu", lazy=True)
    assert_frames(lazy, h2o3_tpu_torch.import_file(path, device="cpu"))
    jf = jparse.import_file(path, lazy=True)
    assert_frames(h2o3_tpu_torch.import_file(path, device="cpu", lazy=True),
                  jf)


def test_gbm_on_lazy_frame_equals_eager(tmp_path, df):
    """A GBM on three columns of a lazy frame equals one on the eager frame
    (trees and predictions) and loads those columns and the response
    only."""
    path = _file(tmp_path, df, "csv")
    kw = dict(ntrees=3, max_depth=3, seed=1, min_rows=5.0)
    x = ["f0", "f1", "k"]
    lazy = h2o3_tpu_torch.import_file(path, device="cpu", lazy=True)
    eager = h2o3_tpu_torch.import_file(path, device="cpu")
    ml = PGBM(**kw).train(x=x, y="label", training_frame=lazy)
    me = PGBM(**kw).train(x=x, y="label", training_frame=eager)
    assert sorted(n for n in lazy.names if lazy.vec(n).is_materialized) == \
        sorted(x + ["label"])
    np.testing.assert_array_equal(ml._predict_raw(eager).numpy(),
                                  me._predict_raw(eager).numpy())
    assert ml.output["names"] == me.output["names"]


def test_wrap_domain_matches_jax(df):
    """An enum remapped onto a domain that reorders, drops and adds levels:
    the codes JAX's view gives, NA where a level is gone."""
    pv = h2o3_tpu_torch.upload_file(df[["e"]], device="cpu").vec("e")
    jv = h2o3_tpu.upload_file(df[["e"]]).vec("e")
    new = ["mid", "zzz", "hi"]
    pw, jw = plazy.wrap_domain(pv, new), jlazy.wrap_domain(jv, new)
    assert pw.domain == jw.domain == tuple(new)
    assert pw.nrow == jw.nrow
    np.testing.assert_array_equal(pw.to_numpy(),
                                  np.asarray(jw.data)[: jw.nrow])


# chains of 4-11 operators over up to four columns: arithmetic,
# comparisons, a libm op, ifelse, an enum operand, constants on both sides
CHAINS = {
    "arith": lambda x, y, k, e: ((x * 2.5 + y) / (k + 1) - 0.75) * x,
    "compare_bool": lambda x, y, k, e: ((x > 0) & (y < 1)) | (k >= 10),
    "libm": lambda x, y, k, e: (x.abs() + 1).log() + (y * 0.1).exp(),
    "ifelse": lambda x, y, k, e: pops_or_jops(x).ifelse(
        x > y, x * y, (k - 3) ** 2),
    "enum_and_reflected": lambda x, y, k, e: 2 - (e + x) / 3 + 1 / (k + 1),
    "ten_ops": lambda x, y, k, e: pops_or_jops(x).ifelse(
        ((x - y) * 0.5 + k).abs().sqrt() > 2, (x + 1).exp(), y - k * e) / 4,
}


def pops_or_jops(v):
    return pops if isinstance(v, PVec) else jops


def _cols(fr):
    return [fr.vec(n) for n in ("x", "y", "k", "e")]


@pytest.fixture(scope="module")
def frames(df):
    d = df.drop(columns=["d"])
    return (h2o3_tpu_torch.upload_file(d, device="cpu"),
            h2o3_tpu.upload_file(d))


@pytest.mark.parametrize("chain", list(CHAINS))
def test_expr_chains_match_jax(frames, monkeypatch, chain):
    """A chain is one deferred graph in both packages; its values are
    JAX's within the frame-ops tolerances, and bit-equal to the port's
    eager operators."""
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")
    pf, jf = frames
    f = CHAINS[chain]
    got = f(*_cols(pf))
    assert isinstance(got, plazy.LazyExprVec) and not got.is_materialized
    want = f(*_cols(jf))
    assert isinstance(want, jlazy.LazyExprVec)
    rtol, atol = (1e-5, 1e-5) if chain in ("libm", "ten_ops") else (
        FLOAT_RTOL, 1e-6)
    assert_vec(got, want, rtol=rtol, atol=atol, name=chain)
    assert got.is_materialized
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "0")
    eager = f(*_cols(pf))
    assert type(eager) is PVec
    np.testing.assert_array_equal(got.to_numpy(), eager.to_numpy())


@pytest.mark.parametrize("op", ["exp", "log", "sqrt", "gamma", "lgamma"])
def test_unop_deferred_matches_jax(frames, monkeypatch, op):
    """One deferred unary op on an enum, an integer and a float column,
    against JAX's deferred one (``_UNOP_TOL`` where two libms differ)."""
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")
    pf, jf = frames
    rtol, atol = _UNOP_TOL.get(op, (FLOAT_RTOL, 1e-6))
    for col in ("x", "k", "e"):
        got = pops._unop(pf.vec(col), op)
        assert isinstance(got, plazy.LazyExprVec)
        assert_vec(got, jops._unop(jf.vec(col), op), rtol=rtol, atol=atol,
                   name=f"{op}({col})")


def test_graphs_splice_and_share_leaves(frames, monkeypatch):
    """Operands that are deferred graphs splice into one graph, a column
    used twice is one leaf, a used graph stays valid, and a chain past
    the node cap still evaluates (its inner part as an evaluated leaf)."""
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")
    pf, _ = frames
    x, y = pf.vec("x"), pf.vec("y")
    a = x * 2 + y
    b = (a - x) / (a + 1)
    assert [id(v) for v in b._leaves] == [id(x), id(y)]
    assert plazy._node_count(b._node) == 7  # a graph, spliced twice
    assert not a.is_materialized  # splicing does not evaluate the operand
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "0")
    want = ((x * 2 + y) - x) / ((x * 2 + y) + 1)
    np.testing.assert_array_equal(b.to_numpy(), want.to_numpy())
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")
    def long_chain():
        c = x
        for _ in range(300):
            c = c + 0.001
        return c

    c = long_chain()
    assert plazy._node_count(c._node) < 300
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "0")
    np.testing.assert_array_equal(c.to_numpy(), long_chain().to_numpy())


def test_munge_fuse_zero_keeps_eager(frames, monkeypatch):
    """``H2O3_TPU_MUNGE_FUSE=0``: every operator returns an evaluated
    column in both packages."""
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "0")
    pf, jf = frames
    x, k = pf.vec("x"), pf.vec("k")
    for v in (x + 1, x.log(), pops.ifelse(x > 0, k, 1.0), 2 * k):
        assert type(v) is PVec and v.data is not None
    assert not isinstance(jops._binop(jf.vec("x"), 1.0, "+"),
                          jlazy.LazyExprVec)  # JAX's lane is eager too


def _windowed(monkeypatch, nbytes):
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(nbytes))
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")


@pytest.mark.parametrize("chain", list(CHAINS))
def test_expr_streamed_equals_resident(frames, monkeypatch, chain):
    """Under a window smaller than the leaves, the chain evaluates block by
    block and stays in host memory; equal to the resident evaluation
    (bit-equal but for the libm ops, see the module's docstring), the
    store's peak within the window."""
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")
    pf, _ = frames
    f = CHAINS[chain]
    resident = f(*_cols(pf)).to_numpy()
    _windowed(monkeypatch, 8 * 1024)
    streamed = plazy.LAZY_EVENTS["streamed"]
    got = f(*_cols(pf))
    vals = got.to_numpy()
    assert plazy.LAZY_EVENTS["streamed"] == streamed + 1
    st = pcs.LAST_STORE_STATS
    assert st["n_blocks"] > 1 and 0 < st["peak_hbm"] <= st["window"]
    assert got._data is None and got._hostbuf is not None  # host-resident
    if chain in ("libm", "ten_ops"):
        np.testing.assert_allclose(vals, resident, rtol=ULP, atol=0,
                                   equal_nan=True)
    else:
        np.testing.assert_array_equal(vals, resident)
    assert torch.equal(got.data.isnan(), torch.from_numpy(np.isnan(vals)))


def test_groupby_streamed_equals_resident(frames, monkeypatch):
    """A two-key group-by under a window below its lanes streams them
    block by block: every statistic equal to the resident pass (the CPU
    adds in row order either way), the store's peak within the window."""
    pf, _ = frames
    spec = {"x": ["count", "sum", "mean", "sd", "min", "max"],
            "y": ["sum", "sumsq"], "e": ["mean", "max"]}
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "1")
    resident = pf.group_by(["e", "k"]).agg(spec)
    _windowed(monkeypatch, 16 * 1024)
    streamed = pops.GROUPBY_EVENTS["streamed"]
    got = pf.group_by(["e", "k"]).agg(spec)
    assert pops.GROUPBY_EVENTS["streamed"] == streamed + 1
    st = pcs.LAST_STORE_STATS
    assert st["n_blocks"] > 1 and 0 < st["peak_hbm"] <= st["window"]
    assert_frames(got, resident)
    # the eager lane ignores the window, as JAX's
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", "0")
    assert_frames(pf.group_by(["e", "k"]).agg(spec), resident)
    assert pops.GROUPBY_EVENTS["streamed"] == streamed + 1
