"""The port's split scan (kernel B2's plain version and the
``fused_split_scan`` counterpart, ``h2o3_tpu_torch.ops.split_cuda``, and the
all-plain ``shared_tree._split_scan``) against the JAX package's Pallas
split kernel in the interpreter (``split_candidates(interpret=True)``), its
``fused_split_scan`` and the dense ``_split_scan``.

On the tie suites of ``tests/test_split_pallas.py`` (``_tie_data``: unit
weights, duplicated columns, constant or ±1 targets) and on integer targets
every sum is exact in float32, so decisions — and the gains and child stats
themselves — must match bit for bit. Elsewhere the port is held to the f64
accuracy bound of ``test_fused_f64_accuracy_bound``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from h2o3_tpu.models.tree.shared_tree import _split_scan as jax_split_scan  # noqa: E402
from h2o3_tpu.ops.hist_pallas import blocked_from_dense, plan_layout  # noqa: E402
from h2o3_tpu.ops.histogram import _hist_scatter_local  # noqa: E402
from h2o3_tpu.ops.split_pallas import (  # noqa: E402
    fused_split_scan as jax_fused_split_scan,
    split_candidates as jax_split_candidates,
)
from h2o3_tpu_torch.models.tree.shared_tree import _split_scan  # noqa: E402
from h2o3_tpu_torch.ops import split_cuda as sc  # noqa: E402
from h2o3_tpu_torch.ops.histogram import histogram  # noqa: E402

_N, _B = 4, 16


def _tie_data(n, C, n_bins, seed=0):
    """test_split_pallas._tie_data: every column a duplicate of one column."""
    rng = np.random.default_rng(seed)
    base = rng.integers(1, n_bins, n).astype(np.uint8)
    return np.tile(base[:, None], (1, C))


def _suite(name):
    """(bins, nid, stats, is_cat) of one integer-exact suite."""
    n = 960
    rng = np.random.default_rng(3)
    nid = rng.integers(0, _N, n).astype(np.int32)
    is_cat = None
    if name == "constant-target":
        bins = _tie_data(n, 13, _B)
        t = np.ones(n, np.float32)
    elif name == "duplicated-columns":
        bins = _tie_data(n, 16, _B, seed=3)
        t = (rng.integers(0, 2, n) * 2 - 1).astype(np.float32)
    elif name == "integer-targets-with-na":
        bins = rng.integers(0, _B, (n, 7)).astype(np.uint8)  # bin 0 = NA
        t = rng.integers(-3, 4, n).astype(np.float32)
    else:  # mixed categorical / numeric
        bins = rng.integers(0, _B, (n, 7)).astype(np.uint8)
        bins[:, 2] = rng.integers(0, 7, n)
        bins[:, 5] = rng.integers(0, 5, n)
        is_cat = np.zeros(7, bool)
        is_cat[[2, 5]] = True
        t = rng.integers(-3, 4, n).astype(np.float32)
    C = bins.shape[1]
    if is_cat is None:
        is_cat = np.zeros(C, bool)
    w = np.ones(n, np.float32)
    stats = np.stack([w, w * t, w], axis=1)
    return bins, nid, stats, is_cat


def _hists(bins, nid, stats):
    """(port (N, C, B, 3) torch, JAX (N, C, B, 3) jnp) of the same rows."""
    hp = histogram(torch.from_numpy(bins), torch.from_numpy(nid),
                   torch.from_numpy(stats), _N, _B)
    d = _hist_scatter_local(jnp.asarray(bins), jnp.asarray(nid),
                            jnp.asarray(stats), _N, _B)
    hj = jnp.transpose(d.reshape(bins.shape[1], _N, _B, 3), (1, 0, 2, 3))
    return hp, hj


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


_KEYS = ("gain", "col", "split_bin", "na_left", "is_cat", "cat_mask", "Lst",
         "Rst", "ok", "node_w", "node_wy", "node_wh")


def _assert_same_decisions(port: dict, ref: dict, what: str):
    for k in _KEYS:
        a = port[k].numpy()
        b = np.asarray(ref[k])
        if k == "col":
            b = b.astype(np.int32)
        if k == "split_bin":
            b = b.astype(np.int32)
        assert a.shape == b.shape and _bits(a) == _bits(b.astype(a.dtype)), (
            f"{what}: field {k} differs\nport {a}\nref  {b}")


@pytest.mark.parametrize("suite", [
    "constant-target", "duplicated-columns", "integer-targets-with-na",
    "mixed-categorical"])
def test_split_bit_exact_on_tie_suites(suite):
    bins, nid, stats, is_cat = _suite(suite)
    C = bins.shape[1]
    hp, hj = _hists(bins, nid, stats)
    assert _bits(hp) == _bits(hj)  # integer sums: the same histogram
    cat_cols = tuple(int(i) for i in np.nonzero(is_cat)[0])
    col_mask = np.ones((_N, C), np.float32)
    col_mask[:, -1] = 0.0  # a masked column must never win
    args_p = (torch.from_numpy(is_cat), torch.from_numpy(col_mask), 1.0, 0.0)
    args_j = (jnp.asarray(is_cat), jnp.asarray(col_mask), 1.0, 0.0)

    # the plain scan and the dispatching scan against JAX's dense scan
    ref = jax_split_scan(hj, *args_j, cat_cols)
    _assert_same_decisions(_split_scan(hp, *args_p, cat_cols), ref, "_split_scan")
    _assert_same_decisions(sc.fused_split_scan(hp, *args_p, cat_cols), ref,
                           "fused_split_scan")
    if suite == "constant-target":
        assert (np.asarray(ref["col"]) == 0).all()  # lowest index wins ties

    # B2's plain version against the Pallas kernel, per (node, column)
    lay = plan_layout(C, _N, _B, 3)
    blk = blocked_from_dense(
        jnp.transpose(hj, (1, 0, 2, 3)).reshape(C, _N * _B, 3), lay)
    tot_j = jnp.asarray(hj)[:, 0].sum(axis=1)
    g, t, nal, L, R = jax_split_candidates(blk, tot_j, 1.0, layout=lay,
                                           interpret=True)
    gp, tp, nalp, Lp, Rp = sc.split_candidates_plain(
        hp, hp[:, 0].sum(dim=1), 1.0)
    for a, b in ((gp, g), (tp, t), (nalp, nal), (Lp, L), (Rp, R)):
        b = np.asarray(b)[:, :C]
        assert _bits(a) == _bits(b.astype(a.numpy().dtype))

    # and JAX's fused assembly over the Pallas candidates, numeric suites
    if not cat_cols:
        fj = jax_fused_split_scan(blk, lay, jnp.asarray(is_cat),
                                  jnp.asarray(col_mask), 1.0, 0.0, (),
                                  interpret=True)
        _assert_same_decisions(sc.fused_split_scan(hp, *args_p), fj,
                               "vs split_pallas.fused_split_scan")


def test_split_f64_accuracy_bound():
    """test_fused_f64_accuracy_bound's shape on the port: the winner's child
    stats within 5e-5 of float64 and the winning gain within 5e-4 of the
    float64 gain at the SAME candidate."""
    rng = np.random.default_rng(9)
    n, c, N, B = 4096, 6, 16, 64
    bins = rng.integers(1, B, size=(n, c)).astype(np.uint8)
    bins[rng.random((n, c)) < 0.1] = 0
    nid = rng.integers(0, N, size=n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    t = rng.normal(size=n).astype(np.float32)
    stats = np.stack([w, w * t, w], axis=1).astype(np.float32)
    h = histogram(torch.from_numpy(bins), torch.from_numpy(nid),
                  torch.from_numpy(stats), N, B)
    sp = sc.fused_split_scan(h, torch.zeros(c, dtype=torch.bool),
                             torch.ones(N, c), 10.0, 0.0)

    ref = np.zeros((N, c, B, 3), np.float64)
    for col in range(c):
        np.add.at(ref[:, col], (nid, bins[:, col]), stats.astype(np.float64))
    na, data = ref[:, :, 0, :], ref[:, :, 1:, :]
    cum = np.cumsum(data, axis=2)
    left = cum[:, :, :-1, :]
    right = cum[:, :, -1:, :] - left
    tot = ref.sum(axis=2)[:, 0, :]

    def fit(s):
        return -np.where(s[..., 0] > 0,
                         s[..., 1] ** 2 / np.maximum(s[..., 0], 1e-300), 0.0)

    nodes = np.arange(N)
    col_i = sp["col"].numpy()
    t_i = sp["split_bin"].numpy() - 1
    nal = sp["na_left"].numpy()[:, None]
    L64 = left[nodes, col_i, t_i] + np.where(nal, na[nodes, col_i], 0.0)
    R64 = right[nodes, col_i, t_i] + np.where(~nal, na[nodes, col_i], 0.0)
    for got, want in ((sp["Lst"].numpy(), L64), (sp["Rst"].numpy(), R64)):
        assert (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max() < 5e-5
    g64 = fit(tot) - fit(L64) - fit(R64)
    gerr = np.abs(sp["gain"].numpy() - g64) / np.maximum(np.abs(g64), 1.0)
    assert gerr.max() < 5e-4, f"gain rel err vs f64 {gerr.max():.2e}"


def test_split_dispatch_routes_cpu_to_plain():
    bins, nid, stats, _ = _suite("integer-targets-with-na")
    hp, _ = _hists(bins, nid, stats)
    tot = hp[:, 0].sum(dim=1)
    before = sc.split_candidates_cuda.launches
    out = sc.split_candidates(hp, tot, 1.0)
    assert sc.split_candidates_cuda.launches == before
    for a, b in zip(out, sc.split_candidates_plain(hp, tot, 1.0)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sc.split_candidates_cuda(hp, tot, 1.0)
