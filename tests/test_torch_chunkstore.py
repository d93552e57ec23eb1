"""The port's out-of-core store (``h2o3_tpu_torch.frame.chunkstore``)
against the JAX package's (``h2o3_tpu/frame/chunkstore.py``), on the CPU,
where the port's "device" copies are CPU tensors.

JAX's side runs under a one-device mesh (under the tests' 8-device mesh
its block quantum is 64 rows, the port's 8) and with
``H2O3_TPU_OVERLOAD=0`` (the port routes by the static window alone, as
JAX does with its overload plane off).

Held equal, with no tolerance: the plan's gates and block geometry on the
same ``(npad, bytes_per_row, window, prefetch)``, including the over-window
frame of one quantum; the LRU window's evictions and peak through the same
sequence of streams and updates (each bounded by the window); the values an
updated and then evicted block uploads again; a ``Vec``'s device values
after its release and lazy rebuild (bit-equal), and nothing released under
``H2O3_TPU_FRAME_COMPRESS=0``.
"""

import contextlib

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from torch_threads import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from h2o3_tpu.frame import chunkstore as jcs  # noqa: E402
from h2o3_tpu.parallel import mesh as pm  # noqa: E402

import h2o3_tpu_torch  # noqa: E402
from h2o3_tpu_torch.frame import chunkstore as cs  # noqa: E402


@contextlib.contextmanager
def one_device():
    """JAX's store on a one-device mesh (``tests/test_oocore.py``'s
    ``_use_mesh(1)``)."""
    old = pm._mesh
    pm.set_mesh(Mesh(np.array(jax.devices("cpu")[:1]), (pm.ROWS_AXIS,)))
    try:
        yield
    finally:
        pm.set_mesh(old)


@pytest.fixture(autouse=True)
def _static_window(monkeypatch):
    monkeypatch.setenv("H2O3_TPU_OVERLOAD", "0")
    monkeypatch.delenv("H2O3_TPU_HBM_WINDOW_BYTES", raising=False)
    monkeypatch.delenv("H2O3_TPU_FRAME_COMPRESS", raising=False)


def _geometry(store):
    return None if store is None else (store.npad, store.block_rows,
                                       store.n_blocks, store.window)


PLANS = [  # (npad, bytes per row, window, compress)
    (10_000, 32, 0, "1"),  # no window: resident
    (10_000, 32, 10_000 * 32 + 1, "1"),  # fits: resident
    (10_000, 32, 4096, "0"),  # the plane off: resident
    (100_000, 32, 65_536, "1"),  # past the window: streams
    (3000, 34, 48 * 1024, "1"),  # the GBM test frames
    (4000, 44, 96 * 1024, "1"),  # the GLM test frames
    (8, 32, 64, "1"),  # one quantum over the window: one block, streamed
    (8, 32, 1024, "1"),  # the same with room: resident
    (1000, 8, 1000 * 8 - 1, "1"),  # one byte over: streams
]


@pytest.mark.parametrize("npad,bpr,window,compress", PLANS)
def test_plan_gates_and_geometry_equal_jax(npad, bpr, window, compress,
                                           monkeypatch):
    monkeypatch.setenv("H2O3_TPU_HBM_WINDOW_BYTES", str(window))
    monkeypatch.setenv("H2O3_TPU_FRAME_COMPRESS", compress)
    with one_device():
        want = _geometry(jcs.ChunkStore.plan(npad, bpr))
    got = _geometry(cs.ChunkStore.plan(npad, bpr))
    assert got == want
    if got is not None:
        assert got[2] > 1 or got[1] == cs.BLOCK_QUANTUM


@pytest.mark.parametrize("npad,bpr,window,prefetch", [
    (1024, 16, 4096, 1), (1000, 20, 3000, 0), (1000, 20, 3000, 2)])
def test_geometry_by_prefetch_depth_equals_jax(npad, bpr, window, prefetch):
    with one_device():
        j = jcs.ChunkStore(npad, bpr, window=window, prefetch=prefetch)
    p = cs.ChunkStore(npad, bpr, window=window, prefetch=prefetch)
    assert (p.block_rows, p.n_blocks) == (j.block_rows, j.n_blocks)
    assert [p.span(b) for b in range(p.n_blocks)] == \
        [j.span(b) for b in range(j.n_blocks)]


def _drive(store, to_dev, to_np):
    """The same passes through either store: two streamed passes over two
    lanes, per-block updates of a mutable lane, then a fetch of every
    block of it. Returns the updated lane as fetched, per block."""
    n = store.npad
    store.add_empty("x", (n, 4), np.float32)
    store.lane("x")[:] = np.arange(n * 4, dtype=np.float32).reshape(n, 4)
    store.add("m", np.arange(n, dtype=np.float32))
    for _ in range(2):
        for bi, blk in store.stream(("x", "m")):
            lo, hi = store.span(bi)
            assert np.array_equal(to_np(blk["x"]), store.lane("x")[lo:hi])
            store.update(bi, m=to_dev(to_np(blk["m"]) * 2 + bi))
    return [to_np(store.fetch(bi, ("m",))["m"]) for bi in range(
        store.n_blocks)]


def test_lru_window_evictions_and_peak_equal_jax():
    """Eviction before upload bounds the peak by the window, the same
    evictions happen in the same order, and an updated block that was
    evicted uploads its current values (the host tier was written back)."""
    args = dict(window=4096, prefetch=1)
    with one_device():
        j = jcs.ChunkStore(1024, 16 + 4, **args)
        jm = _drive(j, jnp.asarray, np.asarray)
        jstats = (j.evictions, j.peak_hbm)
        j.close()
    p = cs.ChunkStore(1024, 16 + 4, **args)
    pm_ = _drive(p, torch.from_numpy, lambda t: t.numpy())
    assert (p.evictions, p.peak_hbm) == jstats
    assert p.evictions >= 4 and p.peak_hbm <= p.window
    want = np.arange(1024, dtype=np.float32) * 4
    for bi, (a, b) in enumerate(zip(pm_, jm)):
        lo, hi = p.span(bi)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, want[lo:hi] + 3 * bi)
    p.close()
    assert cs.LAST_STORE_STATS["peak_hbm"] <= cs.LAST_STORE_STATS["window"]
    assert cs.LAST_STORE_STATS["evictions"] == jstats[0]


def test_fill_resets_both_tiers_and_uploads_nothing():
    """``fill`` (a tree's node ids back to 0) makes each block on the
    device: after an update, a fill and an eviction, the block reads the
    fill value, and the host lane reads it too."""
    p = cs.ChunkStore(64, 8, window=128, prefetch=0)
    p.add_empty("nid", (64,), np.int32)
    for bi, blk in p.stream(("nid",)):
        p.update(bi, nid=blk["nid"] + 5)
    p.fill("nid", 0)
    up = p.uploads
    for bi, blk in p.stream(("nid",)):
        assert int(blk["nid"].abs().sum()) == 0
    assert p.uploads == up
    assert not p.lane("nid").any()


def test_vec_release_and_rebuild_bit_equal(monkeypatch):
    """``Vec.release_device`` drops the device copy and returns its bytes;
    ``data`` uploads the host copy again, bit-equal; the frame helper
    releases nothing under ``H2O3_TPU_FRAME_COMPRESS=0``."""
    rng = np.random.default_rng(3)
    df = pd.DataFrame({"a": rng.normal(size=500).astype(np.float32),
                       "c": rng.choice(["x", "y", "z"], 500)})
    df.loc[::7, "a"] = np.nan
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    for name in ("a", "c"):
        v = fr.vec(name)
        before = v.data.clone()
        freed = v.release_device()
        assert freed == before.numel() * before.element_size()
        assert v._data is None
        np.testing.assert_array_equal(v.to_numpy(), before.numpy())
        after = v.data
        assert after.dtype == before.dtype
        assert before.numpy().tobytes() == after.numpy().tobytes()
    monkeypatch.setenv("H2O3_TPU_FRAME_COMPRESS", "0")
    assert cs.release_frame_features(fr, ["a", "c"]) == 0
    assert fr.vec("a")._data is not None
    monkeypatch.setenv("H2O3_TPU_FRAME_COMPRESS", "1")
    assert cs.release_frame_features(fr, ["a", "c"]) == 500 * 4 + 500 * 1


def test_host_block_frame_rows_equal_the_frame():
    """A block sub-frame holds exactly its rows of the frame (the last
    block stops at the frame's end)."""
    rng = np.random.default_rng(5)
    df = pd.DataFrame({"a": rng.normal(size=100).astype(np.float32),
                       "c": rng.choice(["x", "y"], 100)})
    fr = h2o3_tpu_torch.upload_file(df, device="cpu")
    for lo, hi in ((0, 48), (48, 96), (96, 104)):
        bf = cs.host_block_frame(fr, ["a", "c"], lo, hi)
        assert bf.nrow == min(hi, 100) - lo
        for name in ("a", "c"):
            np.testing.assert_array_equal(
                bf.vec(name).to_numpy(), fr.vec(name).to_numpy()[lo:hi])
        assert bf.vec("c").domain == fr.vec("c").domain
