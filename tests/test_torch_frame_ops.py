"""The port's frame operations (``h2o3_tpu_torch.frame.ops``) against
``h2o3_tpu.frame.ops`` on the CPU. Where JAX's code branches on its munge
lane (``H2O3_TPU_MUNGE_FUSE=1``, its default compiled lane, or ``0``, the
eager one) the comparison runs in both lanes as parametrized cases: group-by
aggregation, merge, sort, ``ifelse``, the operator chains, the enum and
string comparisons, ``match``/``which``, ``rank_within_group_by``, ``pivot``
and ``impute(by=)``. An operation whose JAX code never reads the lane is
compared once. So is each single binary and unary operator: JAX's
compiled lane evaluates the same ``_BINOPS``/``_UNOPS`` formula and NaN rule
as its eager kernels (``lazy.py:303-323`` against ``ops.py:93-105``), and the
operator chains hold the port against both lanes. Every JAX program is a
compile in the test process, so lane cases that add nothing are left out.

Inputs are seeded frames of 2,000 rows: numbers with NaN, integer keys
with NaN and duplicates, enums with NA and unequal (overlapping) domains, a
near-unique string column and a time column. Exact: gathers, merge and
sort outputs row by row (every join flavour, duplicate and NaN keys,
several keys, enum keys of different domains, string and time keys on the
host path), group counts, minima and maxima, ``table``, ``unique``,
``cut``, the string and time functions and the type conversions. 1e-6
relative: float32 sums, means and variances (the two packages add in
another order) and the float32 elementwise math. 1e-12: ``cor`` and
``var`` (float64 on the host).

The no-round-trip check of JAX's ``test_frame_ops.py`` holds for the port:
``merge`` and ``sort`` on numeric or enum keys never call ``to_pandas`` and
never move a column to the host.
"""

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

import h2o3_tpu  # noqa: E402
from h2o3_tpu.frame import ops as jops  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.frame import ops as pops  # noqa: E402
from h2o3_tpu_torch.frame.frame import Frame as PFrame  # noqa: E402
from h2o3_tpu_torch.frame.frame import Vec as PVec  # noqa: E402

N = 2000
FLOAT_RTOL = 1e-6
X_MAX = 4.5  # above every |x| of ops_df's normal column


def ops_df(n=N, seed=0) -> pd.DataFrame:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    g = rng.integers(0, 6, n).astype(np.float64)
    g[rng.random(n) < 0.05] = np.nan
    e = np.array(["lo", "mid", "hi"], dtype=object)[rng.integers(0, 3, n)]
    e[rng.random(n) < 0.05] = None
    f = np.array(["b", "lo", "mid", "z"], dtype=object)[rng.integers(0, 4, n)]
    f[rng.random(n) < 0.05] = None
    t = pd.Timestamp("2019-06-01") + pd.to_timedelta(
        rng.integers(0, 10 ** 9, n), "s")
    return pd.DataFrame({
        "x": x,
        "y": rng.normal(size=n) * 3,
        "k": rng.integers(0, 50, n),
        "g": g,
        "e": e,
        "f": f,
        "s": [f" Id{i % 1990:05d}x " for i in range(n)],  # near-unique
        "t": t,
    })


@pytest.fixture(scope="module")
def df():
    d = ops_df()
    assert np.nanmax(np.abs(d["x"])) < X_MAX
    return d


@pytest.fixture(autouse=True, scope="module")
def _no_compile_cache_writes():
    """The JAX programs compiled here are not written to the persistent
    compilation cache that the test processes share: it writes an entry
    in place, with no lock and no atomic rename, so a process that reads
    an entry while another is still writing it may load a truncated
    program (JAX's tree programs are shared across nearby shapes). Reads
    stay on."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, float("inf"))
    yield
    jax.config.update(key, old)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the frames are small, and under six test
    workers PyTorch's pool would only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["1", "0"], ids=["fuse", "eager"])
def lane(request, monkeypatch):
    """JAX's compiled munge lane (its default) and its eager lane."""
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", request.param)
    return request.param


@pytest.fixture(scope="module")
def frames(df):
    """The port's frame and JAX's, JAX in its default lane."""
    return (h2o3_tpu_torch.upload_file(df, device="cpu"),
            h2o3_tpu.upload_file(df))


@pytest.fixture
def lane_frames(frames, lane):
    """The same pair, JAX in each of its munge lanes."""
    return frames


def assert_vec(pv, jv, rtol=0.0, atol=0.0, name=""):
    assert pv.kind == jv.kind, name
    assert pv.domain == jv.domain, name
    a, b = pv.to_numpy(), jv.to_numpy()
    assert len(a) == len(b), name
    if pv.kind == "string":
        assert list(a) == list(b), name
    elif rtol or atol:
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64),
                                   rtol=rtol, atol=atol, equal_nan=True,
                                   err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)


def assert_same(pf, jf, rtol=None):
    """Names, kinds, domains and values equal to JAX's; ``rtol`` maps a
    column to its relative tolerance (the rest exact)."""
    assert pf.names == jf.names
    assert pf.nrow == jf.nrow
    for name in jf.names:
        assert_vec(pf.vec(name), jf.vec(name),
                   rtol=(rtol or {}).get(name, 0.0), name=name)


# ---------------------------------------------------------------------------
# elementwise operators


_NOT_SYMMETRIC = {"-", "/", "//", "%", "**", "<", "<=", ">", ">="}


@pytest.mark.parametrize("op", list(pops._BINOPS))
def test_binops(frames, op):
    pf, jf = frames
    px, py, jx, jy = pf.vec("x"), pf.vec("y"), jf.vec("x"), jf.vec("y")
    exact = op in pops._PRESERVE_NAN
    tol = dict(rtol=0.0 if exact else FLOAT_RTOL,
               atol=0.0 if exact else 1e-6)
    assert_vec(pops._binop(px, py, op), jops._binop(jx, jy, op), **tol)
    assert_vec(pops._binop(px, 1.5, op), jops._binop(jx, 1.5, op), **tol)
    if op in _NOT_SYMMETRIC:  # a reflected scalar operand (2.0 - x)
        assert_vec(pops._binop(px, 2.0, op, reflected=True),
                   jops._binop(jx, 2.0, op, reflected=True), **tol)
    if op in ("+", "<", "=="):  # an enum operand: its codes, NA as NaN
        assert_vec(pops._binop(pf.vec("e"), px, op),
                   jops._binop(jf.vec("e"), jx, op), **tol)


# (rtol, atol) where two libms' float32 results differ by more than a few
# ulps: lgamma by ~2e-6 absolute near its roots at 1 and 2, and gamma,
# exp(lgamma(x)) in both packages, by that last bit scaled by |lgamma(x)|
# (up to ~16 here)
_UNOP_TOL = {"gamma": (2e-5, 1e-6), "lgamma": (FLOAT_RTOL, 4e-6)}


@pytest.mark.parametrize("op", list(pops._UNOPS))
def test_unops(frames, op):
    pf, jf = frames
    for col in ("x", "y", "g"):
        rtol, atol = _UNOP_TOL.get(op, (FLOAT_RTOL, 1e-6))
        assert_vec(pops._unop(pf.vec(col), op), jops._unop(jf.vec(col), op),
                   rtol=rtol, atol=atol, name=f"{op}({col})")


def test_operators_attached(lane_frames):
    pf, jf = lane_frames
    px, jx = pf.vec("x"), jf.vec("x")
    for expr in (lambda a: a + a * 2 - 1, lambda a: 1 - a, lambda a: 3 / a,
                 lambda a: (a > 0) & (a < 1), lambda a: (a <= 0) | (a >= 1),
                 lambda a: a ** 2 % 1.5, lambda a: a // 0.5,
                 lambda a: a.abs().sqrt().log1p(), lambda a: a.logical_not(),
                 lambda a: a.isna(), lambda a: 2 ** a, lambda a: 7 % a):
        assert_vec(expr(px), expr(jx), rtol=FLOAT_RTOL, atol=1e-6)
    for op in pops._CUMOPS:
        assert_vec(getattr(px, op)(), getattr(jx, op)())


def test_enum_and_string_comparisons(lane_frames):
    pf, jf = lane_frames
    assert pf.vec("s").kind == "string"
    for col, level in (("e", "lo"), ("e", "nope"), ("s", " Id00007x ")):
        for op in ("==", "!="):
            assert_vec(pops._binop(pf.vec(col), level, op),
                       jops._binop(jf.vec(col), level, op))
    # enums of different domains compare by label
    for op in ("==", "!="):
        assert_vec(pops._binop(pf.vec("e"), pf.vec("f"), op),
                   jops._binop(jf.vec("e"), jf.vec("f"), op))
    with pytest.raises(TypeError):
        pf.vec("e") < pf.vec("f")
    with pytest.raises(TypeError):
        pf.vec("e") < "lo"
    with pytest.raises(TypeError):
        pf.vec("s") + 1


def test_ifelse(lane_frames):
    pf, jf = lane_frames
    pt, jt = pf.vec("x") > 0, jf.vec("x") > 0
    assert_vec(pops.ifelse(pt, pf.vec("y"), 0.5),
               jops.ifelse(jt, jf.vec("y"), 0.5))
    assert_vec(pops.ifelse(pf.vec("g"), -1, pf.vec("x")),
               jops.ifelse(jf.vec("g"), -1, jf.vec("x")))


def test_diff_and_fillna(frames):
    pf, jf = frames
    assert_vec(pops.diff_lag1(pf.vec("x")), jops.diff_lag1(jf.vec("x")))
    for method in ("forward", "backward"):
        for maxlen in (0, 1):
            assert_vec(pops.fillna(pf.vec("x"), method, maxlen),
                       jops.fillna(jf.vec("x"), method, maxlen))
    assert_vec(pops.fillna(pf.vec("t")), jops.fillna(jf.vec("t")))
    with pytest.raises(ValueError):
        pops.fillna(pf.vec("e"))


# ---------------------------------------------------------------------------
# group-by

_AGGS = ["count", "nrow", "sum", "mean", "min", "max", "var", "sd", "sumsq",
         "median", "mode", "first", "last"]
_FLOAT_AGGS = ("sum", "mean", "var", "sd", "sumsq")


_GB_SPEC = {"x": _AGGS, "k": ["count", "sum", "mean", "var", "min", "max"],
            "e": ["min", "max", "mode", "first"]}


def _group_by_both(pf, jf, by):
    gb = pops.group_by(pf, by)
    got, want = gb.agg(_GB_SPEC), jops.group_by(jf, by).agg(_GB_SPEC)
    assert_group_by(gb, got, want, _GB_SPEC)


@pytest.mark.parametrize("by", [["e"], ["g"], ["k"], ["e", "f"],
                                ["g", "e", "k"]],
                         ids=lambda b: "+".join(b))
def test_group_by(lane_frames, by):
    """Numeric and enum keys (the port's device factorization) against
    both of JAX's aggregation lanes."""
    _group_by_both(*lane_frames, by)


@pytest.mark.parametrize("by", [["s"], ["t"]], ids=lambda b: "+".join(b))
def test_group_by_host_keys(frames, by):
    """String and time keys: pandas' factorization on the host in both
    packages; JAX's lanes differ only in the aggregation, which the cases
    above hold in both."""
    _group_by_both(*frames, by)


def assert_group_by(gb, got, want, spec):
    """Keys, counts, extrema and the host aggregations exactly; float32
    sums, means, sums of squares and variances to 1e-6 of the scale of
    what was added (a group's sum of |x|, or of x^2 for the squares and
    variances), which bounds the float32 sums' own rounding in any order
    (relative to the result itself it is unbounded where a group's values
    cancel)."""
    floats = {f"{a}_{c}" for c, aggs in spec.items() for a in aggs
              if a in _FLOAT_AGGS}
    assert got.names == want.names and got.nrow == want.nrow
    for name in want.names:
        if name not in floats:
            assert_vec(got.vec(name), want.vec(name), name=name)
    gid, G = gb.gid.numpy(), gb._ngroups
    for c, aggs in spec.items():
        v = gb.frame.vec(c)
        x = v.to_numpy().astype(np.float64)
        if v.kind == "enum":
            x[x < 0] = np.nan
        ok = (gid >= 0) & ~np.isnan(x)
        n = np.bincount(gid[ok], minlength=G)
        s1 = np.bincount(gid[ok], np.abs(x[ok]), minlength=G)
        s2 = np.bincount(gid[ok], x[ok] ** 2, minlength=G)
        scale = {"sum": s1, "mean": s1 / np.maximum(n, 1), "sumsq": s2,
                 "var": s2 / np.maximum(n - 1, 1),
                 "sd": s2 / np.maximum(n - 1, 1)}
        for a in aggs:
            if a not in _FLOAT_AGGS:
                continue
            name = f"{a}_{c}"
            pv, jv = got.vec(name), want.vec(name)
            assert pv.kind == jv.kind, name
            g = pv.to_numpy().astype(np.float64)
            w = jv.to_numpy().astype(np.float64)
            if a == "sd":  # held as the variance it is the root of
                g, w = g * g, w * w
            assert (np.isnan(g) == np.isnan(w)).all(), name
            both = ~np.isnan(w)
            err = np.abs(g - w)[both]
            assert (err <= FLOAT_RTOL * scale[a][both]).all(), (
                name, float((err / np.maximum(scale[a][both], 1e-30)).max()))


def test_group_by_empty_groups_and_attached(lane_frames):
    pf, jf = lane_frames
    na = pd.DataFrame({"k": [np.nan] * 5, "x": np.arange(5.0)})
    got = pops.group_by(h2o3_tpu_torch.upload_file(na, device="cpu"),
                        "k").agg({"x": ["sum", "median"]})
    want = jops.group_by(h2o3_tpu.upload_file(na), "k").agg(
        {"x": ["sum", "median"]})
    assert got.nrow == want.nrow == 0 and got.names == want.names
    gb = pf.group_by("e")
    assert_group_by(gb, gb.agg({"y": "mean"}),
                    jf.group_by("e").agg({"y": "mean"}), {"y": ["mean"]})
    with pytest.raises(ValueError):
        pf.group_by("e").agg({"y": "geomean"})


def test_group_by_one_pass_on_device(frames, monkeypatch):
    """Every value column's count, sums and NA counts ride one
    ``index_add_``, the extrema one ``scatter_reduce_`` each."""
    pf, _ = frames
    gb = pops.group_by(pf, ["e", "f"])
    calls = {"index_add_": 0, "scatter_reduce_": 0}
    for name in calls:
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    gb.agg({"x": ["sum", "min"], "y": ["max", "sd"], "k": "count"})
    assert calls == {"index_add_": 1, "scatter_reduce_": 2}


# ---------------------------------------------------------------------------
# merge and sort


def _join_frames(seed=5, n=N):
    rng = np.random.default_rng(seed)
    ldf = pd.DataFrame({
        "k": rng.integers(0, 200, n).astype(np.float64),
        "k2": rng.integers(0, 4, n).astype(np.float64),
        "c": np.array(["a", "b", "c", "q"], dtype=object)[
            rng.integers(0, 4, n)],
        "x": rng.normal(size=n),
        "s": [f"r{i % 300}" for i in range(n)],
        "t": pd.Timestamp("2021-01-01") + pd.to_timedelta(
            rng.integers(0, 400, n), "D"),
    })
    m = n // 2
    rdf = pd.DataFrame({
        "k": rng.integers(0, 300, m).astype(np.float64),
        "k2": rng.integers(0, 4, m).astype(np.float64),
        "c": np.array(["c", "a", "d"], dtype=object)[rng.integers(0, 3, m)],
        "y": rng.normal(size=m),
        "s": [f"r{i % 400}" for i in range(m)],
        "t": pd.Timestamp("2021-01-01") + pd.to_timedelta(
            rng.integers(0, 500, m), "D"),
    })
    ldf.loc[::37, "k"] = np.nan  # NaN keys match NaN keys
    rdf.loc[::53, "k"] = np.nan
    ldf.loc[::41, "c"] = None
    rdf.loc[::43, "c"] = None
    ldf.loc[::29, "k"] = -0.0  # -0 matches +0
    return ldf, rdf


@pytest.fixture(scope="module")
def join_dfs():
    return _join_frames()


_HOWS = {"inner": (False, False), "left": (True, False),
         "right": (False, True), "outer": (True, True)}


def _merge_both(join_dfs, how, by):
    ldf, rdf = join_dfs
    cols_l = by + [c for c in ("x", "k2", "c") if c not in by]
    cols_r = by + [c for c in ("y", "c") if c not in by]
    all_x, all_y = _HOWS[how]
    got = pops.merge(h2o3_tpu_torch.upload_file(ldf[cols_l], device="cpu"),
                     h2o3_tpu_torch.upload_file(rdf[cols_r], device="cpu"),
                     by=by, all_x=all_x, all_y=all_y)
    want = jops.merge(h2o3_tpu.upload_file(ldf[cols_l]),
                      h2o3_tpu.upload_file(rdf[cols_r]), by=by,
                      all_x=all_x, all_y=all_y)
    if "t" in by and all_y:
        # JAX's coalesced time key keeps only its float32 device values
        # (ops.py:718-724); the port carries the exact copy along
        assert got.names == want.names and got.nrow == want.nrow
        np.testing.assert_array_equal(got.vec("t").data.numpy(),
                                      np.asarray(want.vec("t").data)[
                                          : want.nrow])
        got, want = got.drop("t"), want.drop("t")
    assert_same(got, want)


@pytest.mark.parametrize("how", list(_HOWS))
@pytest.mark.parametrize("by", [["k"], ["c"], ["c", "k2"]],
                         ids=lambda b: "+".join(b))
def test_merge(join_dfs, lane, how, by):
    """Numeric and enum keys: the device join, against both JAX lanes (two
    numeric keys: ``test_merge_attached_and_default_keys``)."""
    _merge_both(join_dfs, how, by)


@pytest.mark.parametrize("how", list(_HOWS))
@pytest.mark.parametrize("by", [["s"], ["t"]], ids=lambda b: "+".join(b))
def test_merge_host_keys(join_dfs, how, by):
    """String and time keys: JAX's pandas join, the same code in both of
    its lanes (its compiled lane hands these keys to the eager one)."""
    _merge_both(join_dfs, how, by)


def test_merge_by_x_by_y_and_mixed_keys(join_dfs, lane):
    ldf, rdf = join_dfs
    l2 = ldf[["k", "x"]].rename(columns={"k": "lk"})
    r2 = rdf[["k", "y", "c"]].rename(columns={"k": "rk"})
    for all_x, all_y in _HOWS.values():
        got = pops.merge(h2o3_tpu_torch.upload_file(l2, device="cpu"),
                         h2o3_tpu_torch.upload_file(r2, device="cpu"),
                         by_x=["lk"], by_y=["rk"], all_x=all_x, all_y=all_y)
        want = jops.merge(h2o3_tpu.upload_file(l2), h2o3_tpu.upload_file(r2),
                          by_x=["lk"], by_y=["rk"], all_x=all_x, all_y=all_y)
        assert_same(got, want)
    # an enum key against a numeric key takes the host path, where pandas
    # refuses labels against numbers in both packages
    l3 = pd.DataFrame({"k": ["1", "2", "3", None], "x": [1.0, 2, 3, 4]})
    r3 = pd.DataFrame({"k": [2.0, 3, 5], "y": [10.0, 20, 30]})
    pl = h2o3_tpu_torch.upload_file(l3, col_types={"k": "enum"}, device="cpu")
    jl = h2o3_tpu.upload_file(l3, col_types={"k": "enum"})
    with pytest.raises(ValueError, match="merge on"):
        jops.merge(jl, h2o3_tpu.upload_file(r3), all_x=True)
    with pytest.raises(ValueError, match="merge on"):
        pops.merge(pl, h2o3_tpu_torch.upload_file(r3, device="cpu"),
                   all_x=True)


def test_merge_attached_and_default_keys(join_dfs):
    ldf, rdf = join_dfs
    pl = h2o3_tpu_torch.upload_file(ldf[["k", "k2", "x"]], device="cpu")
    pr = h2o3_tpu_torch.upload_file(rdf[["k", "k2", "y"]], device="cpu")
    got = pl.merge(pr)  # joins on the shared names, k and k2
    want = jops.merge(h2o3_tpu.upload_file(ldf[["k", "k2", "x"]]),
                      h2o3_tpu.upload_file(rdf[["k", "k2", "y"]]))
    assert_same(got, want)


@pytest.mark.parametrize("by,asc", [
    (["x"], [True]), (["x"], [False]), (["e", "x"], [True, False]),
    (["e"], [False]), (["g", "k", "y"], [False, True, False]),
    (["s"], [True]), (["t", "x"], [False, True])],
    ids=lambda v: "+".join(map(str, v)))
def test_sort(lane_frames, by, asc):
    pf, jf = lane_frames
    assert_same(pops.sort(pf, by, asc), jops.sort(jf, by, asc))


def test_sort_enum_na_descending():
    """A descending enum key is negated, as in JAX: its NA code -1 becomes
    +1 and sorts after every level; ascending, NA comes first."""
    d = pd.DataFrame({"c": ["b", None, "a", "c", None, "a"],
                      "x": [1.0, 2, 3, 4, 5, 6]})
    pf = h2o3_tpu_torch.upload_file(d, device="cpu")
    jf = h2o3_tpu.upload_file(d)
    for asc in (True, False):
        got = pops.sort(pf, "c", asc)
        assert_same(got, jops.sort(jf, "c", asc))
    assert pops.sort(pf, "c", False).vec("x").to_numpy().tolist() == \
        [4, 1, 3, 6, 2, 5]
    assert pf.sort("x", False).vec("x").to_numpy()[0] == 6


def test_merge_and_sort_stay_on_the_device(join_dfs, lane, monkeypatch):
    """JAX's no-round-trip check (``test_frame_ops.py:261``), tightened:
    numeric and enum keys join and sort with no ``to_pandas``, no
    ``to_numpy`` and no tensor moved to the host (``cpu()``/``numpy()``);
    the join's output size is its one scalar read."""
    ldf, rdf = join_dfs
    left = h2o3_tpu_torch.upload_file(ldf[["k", "k2", "c", "x"]],
                                      device="cpu")
    right = h2o3_tpu_torch.upload_file(rdf[["k", "k2", "c", "y"]],
                                       device="cpu")

    def boom(*a, **k):
        raise AssertionError("a host round trip during merge/sort")

    for owner, name in ((PFrame, "to_pandas"), (PVec, "to_numpy"),
                        (PVec, "host_values"), (torch.Tensor, "cpu"),
                        (torch.Tensor, "numpy"), (pd.DataFrame, "merge"),
                        (pd.DataFrame, "sort_values")):
        monkeypatch.setattr(owner, name, boom)
    outs = [pops.merge(left, right, by=by, all_x=ax, all_y=ay)
            for by in (["k"], ["k", "k2"], ["c"]) for ax, ay in _HOWS.values()]
    srt = pops.sort(left, ["c", "k", "x"], [True, False, True])
    monkeypatch.undo()
    assert all(o.nrow > 0 for o in outs) and srt.nrow == left.nrow
    assert_same(srt, jops.sort(h2o3_tpu.upload_file(ldf[["k", "k2", "c",
                                                         "x"]]),
                               ["c", "k", "x"], [True, False, True]))


# ---------------------------------------------------------------------------
# quantile, table, unique, match, which, na_omit, rank, pivot, splits


def test_quantile(frames):
    pf, jf = frames
    assert_same(pops.quantile(pf), jops.quantile(jf))
    probs = [0.0, 0.05, 0.5, 0.93, 1.0]
    assert_same(pops.quantile(pf.vec("x"), probs),
                jops.quantile(jf.vec("x"), probs))
    assert_same(pf.vec("y").quantile([0.3]), jf.vec("y").quantile([0.3]))
    w = pd.DataFrame({"w": np.random.default_rng(2).integers(0, 4, N)
                      .astype(np.float64)})
    pw = h2o3_tpu_torch.upload_file(w, device="cpu").vec("w")
    jw = h2o3_tpu.upload_file(w).vec("w")
    assert_same(pops.quantile(pf[["x", "k"]], probs, weights=pw),
                jops.quantile(jf[["x", "k"]], probs, weights=jw))
    na = pd.DataFrame({"a": [np.nan] * 4})
    assert_same(pops.quantile(h2o3_tpu_torch.upload_file(na, device="cpu")),
                jops.quantile(h2o3_tpu.upload_file(na)))


def test_quantile_reads_only_the_picked_elements(frames, monkeypatch):
    """The sorted column stays on the device: the host reads the count of
    values and the 2 x len(prob) elements the probabilities index."""
    pf, _ = frames
    reads = []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        reads.append(self.numel())
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    pops.quantile(pf.vec("x"), [0.1, 0.5, 0.9])
    assert reads == [6]


def test_table_unique(frames):
    pf, jf = frames
    for c in ("e", "g", "k"):
        assert_same(pops.table(pf.vec(c)), jops.table(jf.vec(c)))
        assert_same(pops.unique(pf.vec(c)), jops.unique(jf.vec(c)))
    assert_same(pops.unique(pf.vec("s")), jops.unique(jf.vec("s")))
    for dense in (True, False):
        assert_same(pops.table(pf.vec("e"), pf.vec("f"), dense=dense),
                    jops.table(jf.vec("e"), jf.vec("f"), dense=dense))


def test_match_is_in_which(lane_frames):
    pf, jf = lane_frames
    for col, tbl in (("k", [3, 7, "x", 7, 11.0]), ("g", [2.0]),
                     ("e", ["mid", "lo", "none"]), ("s", [" Id00003x ", "q"])):
        for kw in ({}, {"nomatch": -1.0, "start_index": 0}):
            assert_vec(pops.match(pf.vec(col), tbl, **kw),
                       jops.match(jf.vec(col), tbl, **kw))
        assert_vec(pops.is_in(pf.vec(col), tbl), jops.is_in(jf.vec(col), tbl))
    assert_same(pops.which(pf.vec("x") > 1), jops.which(jf.vec("x") > 1))
    # an empty table matches nothing (JAX's argmax refuses the empty row)
    assert (pops.match(pf.vec("k"), [], nomatch=-1.0).to_numpy() == -1).all()


def test_na_omit(frames, df):
    pf, jf = frames
    got = pops.na_omit(pf)
    assert_same(got, jops.na_omit(jf))
    assert got.nrow == len(df.dropna())


@pytest.mark.parametrize("sorted_out", [False, True])
def test_rank_within_group_by(lane_frames, sorted_out):
    pf, jf = lane_frames
    for g, s, asc in ((["e"], ["x"], True), (["e", "g"], ["y", "x"],
                                             [False, True]),
                      ([], ["k"], False), (["k"], ["f"], True)):
        assert_same(pops.rank_within_group_by(pf, g, s, asc,
                                              sort_cols_sorted=sorted_out),
                    jops.rank_within_group_by(jf, g, s, asc,
                                              sort_cols_sorted=sorted_out))


def test_pivot_stratified_relevel(lane_frames):
    pf, jf = lane_frames
    got, want = pops.pivot(pf, "k", "e", "x"), jops.pivot(jf, "k", "e", "x")
    assert got.names == want.names
    for n in want.names:  # group means: to 1e-6 of the largest |x|
        assert_vec(got.vec(n), want.vec(n), atol=FLOAT_RTOL * X_MAX, name=n)
    with pytest.raises(ValueError):
        pops.pivot(pf, "k", "x", "y")
    assert_vec(pops.stratified_split(pf.vec("e"), 0.3, seed=5),
               jops.stratified_split(jf.vec("e"), 0.3, seed=5))
    assert_vec(pops.relevel(pf.vec("e"), "mid"),
               jops.relevel(jf.vec("e"), "mid"))
    with pytest.raises(ValueError):
        pops.relevel(pf.vec("e"), "nope")


def test_signif_cut_scale(frames):
    pf, jf = frames
    for d in (1, 3):
        assert_vec(pops.signif(pf.vec("y"), d), jops.signif(jf.vec("y"), d))
    for kw in ({}, {"labels": ["a", "b", "c"], "include_lowest": True},
               {"right": False}):
        assert_vec(pops.cut(pf.vec("y"), [-5, -1, 1, 5], **kw),
                   jops.cut(jf.vec("y"), [-5, -1, 1, 5], **kw))
    # (x - mean) / sd: the float32 moments' rounding, to 1e-6 of the
    # largest scaled value
    got, want = pops.scale(pf[["x", "y", "e"]]), jops.scale(jf[["x", "y",
                                                               "e"]])
    assert got.names == want.names
    assert_vec(got.vec("e"), want.vec("e"))
    for n in ("x", "y"):
        big = np.nanmax(np.abs(want.vec(n).to_numpy()))
        assert_vec(got.vec(n), want.vec(n), atol=FLOAT_RTOL * big, name=n)
    assert_vec(pops.scale(pf[["k"]], center=False).vec("k"),
               jops.scale(jf[["k"]], center=False).vec("k"),
               rtol=FLOAT_RTOL)


@pytest.mark.parametrize("fuse,col,method,by", [
    ("1", "x", "mean", None), ("1", "x", "median", None),
    ("1", "x", "mode", None), ("1", "e", "mode", None)] + [
    (fuse, *case) for case in (("x", "mean", ["e"]),
                               ("x", "median", ["e", "g"]),
                               ("e", "mode", ["f"]))
    for fuse in ("1", "0")])
def test_impute(df, monkeypatch, fuse, col, method, by):
    """``by=`` groups through JAX's group-by, so those cases run in both
    of its lanes; the plain statistics never read the lane."""
    monkeypatch.setenv("H2O3_TPU_MUNGE_FUSE", fuse)
    pf = h2o3_tpu_torch.upload_file(df, device="cpu")
    jf = h2o3_tpu.upload_file(df)
    got = pops.impute(pf, col, method, by=by)
    want = jops.impute(jf, col, method, by=by)
    # a mean: to 1e-6 of the largest |x| (its float32 sum's rounding)
    atol = FLOAT_RTOL * X_MAX if method == "mean" else 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True)
    assert_vec(pf.vec(col), jf.vec(col), atol=atol)


def test_cor_var(frames):
    pf, jf = frames
    for use in ("complete.obs", "everything"):
        got, want = pops.cor(pf, use=use), jops.cor(jf, use=use)
        assert got.names == want.names
        for n in want.names:
            np.testing.assert_allclose(got.vec(n).to_numpy(),
                                       want.vec(n).to_numpy(), rtol=1e-12,
                                       atol=1e-12, equal_nan=True)
    assert_same(pf.var(), jf.var())


# ---------------------------------------------------------------------------
# strings, time, interaction, conversions


@pytest.mark.parametrize("col", ["e", "s"])
def test_string_functions(frames, col):
    pf, jf = frames
    pv, jv = pf.vec(col), jf.vec(col)
    for fn, args in ((pops.toupper, ()), (pops.tolower, ()), (pops.trim, ()),
                     (pops.sub, ("[io]", "0")), (pops.gsub, ("[io]", "0")),
                     (pops.nchar, ()), (pops.substring, (1, 3)),
                     (pops.lstrip, (" I",)), (pops.rstrip, ()),
                     (pops.countmatches, (["0", "i"],)), (pops.entropy, ()),
                     (pops.grep, ("0[0-3]",))):
        assert_vec(fn(pv, *args), getattr(jops, fn.__name__)(jv, *args),
                   name=fn.__name__)
    assert_same(pops.strsplit(pv, "0+"), jops.strsplit(jv, "0+"))
    assert_vec(pv.tolower().toupper(), jv.tolower().toupper())
    with pytest.raises(TypeError):
        pops.toupper(pf.vec("x"))


def test_enum_string_function_collapses_levels():
    d = pd.DataFrame({"c": ["a", "A", None, "b", "B", "a"]})
    pv = h2o3_tpu_torch.upload_file(d, device="cpu").vec("c")
    jv = h2o3_tpu.upload_file(d).vec("c")
    got = pops.tolower(pv)
    assert got.domain == ("a", "b")
    assert_vec(got, jops.tolower(jv))


def test_time_components(frames):
    pf, jf = frames
    for fn in ("year", "month", "day", "hour", "minute", "second",
               "day_of_week", "week"):
        assert_vec(getattr(pf.vec("t"), fn)(), getattr(jf.vec("t"), fn)(),
                   name=fn)


def test_interaction(frames):
    pf, jf = frames
    for kw in ({}, {"pairwise": True}, {"max_factors": 4},
               {"min_occurrence": 60}, {"min_occurrence": 10 ** 6}):
        assert_same(pops.interaction(pf, ["e", "f"], **kw),
                    jops.interaction(jf, ["e", "f"], **kw))
    assert_same(pops.interaction(pf, ["e", "f", "e"], pairwise=True),
                jops.interaction(jf, ["e", "f", "e"], pairwise=True))
    with pytest.raises(ValueError):
        pops.interaction(pf, ["e"])
    with pytest.raises(ValueError):
        pops.interaction(pf, ["e", "x"])


def test_conversions_and_hist(frames):
    pf, jf = frames
    for col in ("x", "g", "k", "e", "s"):
        for fn in ("asfactor", "asnumeric", "ascharacter"):
            assert_vec(getattr(pf.vec(col), fn)(), getattr(jf.vec(col), fn)(),
                       name=f"{fn}({col})")
    num = pd.DataFrame({"c": ["1.5", "2", None, "1.5"], "d": ["u", "v", "u",
                                                              None]})
    pn = h2o3_tpu_torch.upload_file(num, col_types={"c": "enum"},
                                    device="cpu")
    jn = h2o3_tpu.upload_file(num, col_types={"c": "enum"})
    for col in ("c", "d"):
        assert_vec(pops.asnumeric(pn.vec(col)), jops.asnumeric(jn.vec(col)))
    for breaks in (7, [-4.0, 0.0, 1.0, 9.0]):
        assert_same(pops.hist(pf.vec("y"), breaks),
                    jops.hist(jf.vec("y"), breaks))


def test_exports_and_devices(frames):
    pf, _ = frames
    for name in ("group_by", "merge", "quantile", "table", "unique", "cut",
                 "impute", "ifelse", "cor", "interaction"):
        assert getattr(h2o3_tpu_torch, name) is getattr(pops, name)
    # results stay on the frame's device, strings' results too
    assert pops.nchar(pf.vec("s")).device.type == "cpu"
    assert pops.quantile(pf).device.type == "cpu"
    assert pf.group_by("e").agg({"x": "sum"}).device.type == "cpu"
