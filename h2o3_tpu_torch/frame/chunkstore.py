"""Out-of-core data plane — the port of ``h2o3_tpu/frame/chunkstore.py``:
a training's per-row lanes kept as row blocks in host memory, an LRU
window of device copies bounded by ``H2O3_TPU_HBM_WINDOW_BYTES``, and a
block iterator that uploads ``H2O3_TPU_PREFETCH_DEPTH`` blocks ahead of the
one being computed on.

The drivers (the streamed tree build, the GLM Gram pass, the DeepLearning
epoch) are loops over the blocks around the resident path's own steps:
histograms and Grams are sums over row blocks, and DeepLearning already
walks minibatches. A frame whose lanes fit the window takes the resident
path unchanged (:meth:`ChunkStore.plan` returns None), and
``H2O3_TPU_FRAME_COMPRESS=0`` turns the plane off.

What differs from JAX, where ``device_put`` and ``device_get`` are
asynchronous by nature:

- on the card the host lanes are pinned tensors, and every upload runs
  with ``non_blocking=True`` on an upload stream of the store's own; the
  compute stream waits on a block's copy event only when the block is
  handed to it, so block k+1's copy runs behind block k's compute;
- :meth:`ChunkStore.update` writes a block's new values back into its
  pinned host slice on a write-back stream, after the compute that made
  them, without blocking the host (JAX reads them back with a blocking
  ``device_get``); a later upload of that slice waits on the write-back on
  the card, and the host waits on it only where it reads the lanes itself
  (:meth:`ChunkStore.lane`, :meth:`ChunkStore.close`);
- :meth:`ChunkStore.fill` of a whole lane (a tree's node ids reset to 0)
  leaves the host lane alone and makes the blocks on the card, so it costs
  neither a host wait nor an upload;
- JAX publishes its gauges and counters through ``utils/metrics``, which
  the port does not have: the store keeps the counts as attributes, and
  :meth:`ChunkStore.close` copies them into :data:`LAST_STORE_STATS`.
  On the card the copies' overlap with compute is measured with CUDA
  events (``copy_overlap_ms``, ``copy_wait_ms``); ``prefetch_overlap_s``
  is JAX's host-clock count (seconds from a prefetch's issue to the
  consumer asking for the block).

On the CPU the same store runs with ``cpu`` "device" copies, so the tests
can force a small window.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Iterable, Sequence

import numpy as np
import torch

from h2o3_tpu_torch import config

# the smallest row count of a block (JAX's ``block_quantum`` on one
# device: one float32 sublane tile per shard)
BLOCK_QUANTUM = 8

# stats of the most recently closed store (JAX's deprecated alias, which
# the port keeps as its only record)
LAST_STORE_STATS: dict = {}


def compress_on() -> bool:
    """``H2O3_TPU_FRAME_COMPRESS``: the plane's master switch."""
    return config.get_bool("H2O3_TPU_FRAME_COMPRESS")


def window_bytes() -> int:
    """``H2O3_TPU_HBM_WINDOW_BYTES`` (0 = no window, everything
    resident)."""
    return max(config.get_int("H2O3_TPU_HBM_WINDOW_BYTES"), 0)


def streaming_enabled() -> bool:
    """Whether any frame may stream: the plane on and a window set (JAX's
    ``streaming_enabled``)."""
    return compress_on() and window_bytes() > 0


def prefetch_depth() -> int:
    """``H2O3_TPU_PREFETCH_DEPTH`` (1 = double buffering, 0 = none)."""
    return max(config.get_int("H2O3_TPU_PREFETCH_DEPTH"), 0)


def pad_rows(nrow: int) -> int:
    """The streamed row count of a frame of ``nrow`` rows: a multiple of
    the block quantum (JAX's ``pad_to_shards`` on one device below its
    row-bucket ladder, which starts past 65,536 rows; the port buckets no
    row count)."""
    q = BLOCK_QUANTUM
    return max(q, -(-nrow // q) * q)


def stream_block_rows(npad: int, budget_rows: int) -> int:
    """Rows of one block: the largest multiple of the quantum within
    ``budget_rows``, clamped to [quantum, npad] (JAX's
    ``stream_block_rows`` on one device)."""
    q = BLOCK_QUANTUM
    b = max(q, (max(budget_rows, 0) // q) * q)
    return min(b, max(npad, q))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ChunkStore:
    """Row-blocked two-tier store of one training's lanes.

    Lanes are ``(npad, ...)`` host tensors (pinned when the store's device
    is a GPU); blocks are contiguous row slices of every lane, sized so
    that one block of the streamed lanes fits the window's share per
    buffer (window / (1 + prefetch depth)). Device copies are kept per
    (lane, block) in an LRU bounded by the window, which evicts before it
    uploads, so the window bounds the peak; mutable lanes are written back
    through :meth:`update`, so an evicted block uploads its current
    values."""

    def __init__(self, npad: int, bytes_per_row: float, *,
                 window: int | None = None, prefetch: int | None = None,
                 device=None):
        self.npad = int(npad)
        self.window = window_bytes() if window is None else int(window)
        self.depth = prefetch_depth() if prefetch is None else int(prefetch)
        self.device = torch.device("cpu" if device is None else device)
        budget_rows = int(
            self.window // max(bytes_per_row * (1 + self.depth), 1))
        self.block_rows = stream_block_rows(self.npad, budget_rows)
        self.n_blocks = -(-self.npad // self.block_rows)
        self._lanes: dict[str, torch.Tensor] = {}
        # (lane, block) -> device tensor, in LRU order (oldest first)
        self._dev: OrderedDict[tuple[str, int], torch.Tensor] = OrderedDict()
        self._pinned: set[tuple[str, int]] = set()
        self._fills: dict[tuple[str, int], object] = {}  # block = constant
        self._issued_at: dict[int, float] = {}  # block -> prefetch stamp
        self._hbm = 0
        self.peak_hbm = 0
        self.evictions = 0
        self.uploads = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.prefetch_overlap_s = 0.0
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            self._up = torch.cuda.Stream(self.device)
            self._down = torch.cuda.Stream(self.device)
        # on the card: a block's upload event until the compute stream has
        # waited on it; the pending write-back of each host slice; and per
        # block handed out (issue, copied, asked) events for the overlap
        self._ready: dict[tuple[str, int], torch.cuda.Event] = {}
        self._wb: dict[tuple[str, int], torch.cuda.Event] = {}
        self._timeline: list[tuple] = []

    # -- planning -----------------------------------------------------------
    @staticmethod
    def plan(npad: int, bytes_per_row: float,
             device=None) -> "ChunkStore | None":
        """The one gate every driver uses: None (stay resident) when the
        plane is off, no window is set or the lanes fit it; otherwise a
        store whose blocks fit the window. A frame over the window whose
        geometry rounds up to one block is re-clamped to stream (JAX's
        boundary fix). JAX also takes a window from its overload plane's
        measured headroom when none is set; the port reads only the knob
        (JAX under ``H2O3_TPU_OVERLOAD=0``)."""
        if not compress_on():
            return None
        need = npad * bytes_per_row
        static = window_bytes()
        if not (static and need > static):
            return None
        store = ChunkStore(npad, bytes_per_row, device=device)
        if store.n_blocks <= 1:
            if need <= store.window:
                return None
            store._force_stream_geometry()
        return store

    def _force_stream_geometry(self) -> None:
        """Re-clamp the geometry of an over-window frame to at least two
        blocks, down to the one-quantum floor (a one-quantum frame stays
        one block, through the store's accounted window)."""
        self.block_rows = stream_block_rows(self.npad, max(self.npad // 2, 1))
        self.n_blocks = -(-self.npad // self.block_rows)

    # -- lanes (host tier) --------------------------------------------------
    def _host_tensor(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self._cuda)

    def add(self, name: str, arr) -> np.ndarray:
        """Register a host lane (leading axis npad) from a numpy array or a
        tensor; returns its numpy view so callers can fill it in place."""
        src = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        if src.shape[0] != self.npad:
            raise ValueError(f"lane {name!r} has {src.shape[0]} rows, the "
                             f"store {self.npad}")
        self._drop_lane(name)
        if self._cuda:
            t = self._host_tensor(tuple(src.shape), src.dtype)
            t.copy_(src)
        else:
            t = src.cpu()
        self._lanes[name] = t
        return t.numpy()

    def add_empty(self, name: str, shape: tuple, dtype, fill=0) -> np.ndarray:
        self._drop_lane(name)
        t = self._host_tensor(tuple(shape),
                              torch.from_numpy(np.empty(0, dtype)).dtype)
        t.fill_(fill)
        self._lanes[name] = t
        return t.numpy()

    def _drop_lane(self, name: str) -> None:
        for bi in range(self.n_blocks):
            self._drop((name, bi))
            self._fills.pop((name, bi), None)

    def shape(self, name: str) -> tuple:
        return tuple(self._lanes[name].shape)

    def lane(self, name: str) -> np.ndarray:
        """The host lane as numpy, current: pending write-backs finished and
        blocks made by :meth:`fill` written (a host wait on the card)."""
        self._host_sync()
        t = self._lanes[name]
        for bi in range(self.n_blocks):
            v = self._fills.pop((name, bi), None)
            if v is not None:
                lo, hi = self.span(bi)
                t[lo:hi].fill_(v)
        return t.numpy()

    def fill(self, name: str, value) -> None:
        """Reset a mutable lane on both tiers: every block becomes the
        constant ``value`` (made on the device when fetched; the host lane
        is written only when :meth:`lane` reads it)."""
        for bi in range(self.n_blocks):
            self._drop((name, bi))
            self._fills[(name, bi)] = value

    def span(self, bi: int) -> tuple[int, int]:
        lo = bi * self.block_rows
        return lo, min(lo + self.block_rows, self.npad)

    def rows(self, bi: int) -> int:
        lo, hi = self.span(bi)
        return hi - lo

    # -- device window ------------------------------------------------------
    def _drop(self, key: tuple[str, int], evict: bool = False) -> None:
        t = self._dev.pop(key, None)
        if t is not None:
            self._hbm -= _nbytes(t)
            self._ready.pop(key, None)
            if evict:
                self.evictions += 1

    def _evict_to(self, budget: int) -> None:
        for key in list(self._dev):
            if self._hbm <= budget:
                break
            if key in self._pinned:
                continue
            self._drop(key, evict=True)

    def _insert(self, key: tuple[str, int], t: torch.Tensor) -> None:
        self._dev[key] = t
        self._hbm += _nbytes(t)
        self.peak_hbm = max(self.peak_hbm, self._hbm)

    def _upload(self, key: tuple[str, int],
                host: torch.Tensor) -> torch.Tensor:
        """The device copy of a host slice: on the card a non-blocking copy
        on the upload stream, after the slice's pending write-back."""
        self.uploads += 1
        self.h2d_bytes += _nbytes(host)
        if not self._cuda:
            return host.clone()
        wb = self._wb.get(key)
        with torch.cuda.stream(self._up):
            if wb is not None:
                self._up.wait_event(wb)
            t = host.to(self.device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self._up)
        self._ready[key] = ev
        return t

    def _ensure(self, bi: int, names: Sequence[str], pin: bool = False
                ) -> dict:
        """Make block ``bi``'s named lanes resident (misses upload from the
        host tier, or are made on the device for a filled lane). Returns
        ``{name: (tensor, upload event or None)}``."""
        lo, hi = self.span(bi)
        out = {}
        for name in names:
            key = (name, bi)
            t = self._dev.get(key)
            if t is not None:
                self._dev.move_to_end(key)
            else:
                host = self._lanes[name][lo:hi]
                if self.window:
                    # evict before the upload, so the window bounds the
                    # peak (it can still pass the window when the pinned
                    # in-flight blocks alone do: the one-quantum floor)
                    self._evict_to(max(self.window - _nbytes(host), 0))
                if key in self._fills:
                    t = torch.full(tuple(host.shape), self._fills[key],
                                   dtype=host.dtype, device=self.device)
                else:
                    t = self._upload(key, host)
                self._insert(key, t)
            if pin:
                self._pinned.add(key)
            out[name] = (t, self._ready.get(key))
        return out

    def _hand_out(self, bi: int, got: dict) -> dict:
        """Block ``bi``'s device tensors for the compute stream: on the card
        the stream waits here, and only here, on the blocks' uploads."""
        out = {}
        for name, (t, ev) in got.items():
            if ev is not None:
                compute = torch.cuda.current_stream(self.device)
                compute.wait_event(ev)
                t.record_stream(compute)  # freed on eviction only after use
                self._ready.pop((name, bi), None)
            out[name] = t
        return out

    def fetch(self, bi: int, names: Sequence[str]) -> dict:
        """Device tensors of block ``bi``'s named lanes, through the LRU
        window (misses upload; the window evicts least-recently-used
        unpinned blocks past the budget)."""
        return self._hand_out(bi, self._ensure(bi, names))

    def update(self, bi: int, **arrays) -> None:
        """A block's new device values: the window's copy is replaced and
        the host slice written back (on the card without blocking the
        host, on the write-back stream after the compute that made them),
        so an evicted block uploads its current values."""
        lo, hi = self.span(bi)
        for name, arr in arrays.items():
            key = (name, bi)
            host = self._lanes[name][lo:hi]
            arr = arr.to(host.dtype).reshape(host.shape)
            self._fills.pop(key, None)
            self.d2h_bytes += _nbytes(host)
            if self._cuda:
                made = torch.cuda.Event()
                made.record(torch.cuda.current_stream(self.device))
                self._down.wait_event(made)
                with torch.cuda.stream(self._down):
                    host.copy_(arr, non_blocking=True)
                arr.record_stream(self._down)
                ev = torch.cuda.Event()
                ev.record(self._down)
                self._wb[key] = ev
            else:
                host.copy_(arr)
            self._drop(key)
            if self.window:
                # the same eviction before insert as fetch: bounds the peak
                self._evict_to(max(self.window - _nbytes(arr), 0))
            self._insert(key, arr)

    def unpin(self, bi: int) -> None:
        self._pinned = {k for k in self._pinned if k[1] != bi}

    def _timed(self, bi: int, names: Sequence[str], pin: bool) -> tuple:
        """:meth:`_ensure`, between two upload-stream events on the card:
        ``(issued, copied, lanes)``."""
        if not self._cuda:
            return None, None, self._ensure(bi, names, pin)
        issued = torch.cuda.Event(enable_timing=True)
        issued.record(self._up)
        got = self._ensure(bi, names, pin)
        copied = torch.cuda.Event(enable_timing=True)
        copied.record(self._up)
        return issued, copied, got

    def stream(self, names: Sequence[str]):
        """Iterate ``(bi, {name: device tensor})`` over every block with
        ``prefetch_depth`` blocks of lookahead: block k+1's upload is issued
        (pinned against eviction) before block k is yielded, so the copy
        runs behind block k's compute."""
        ahead: dict[int, tuple] = {}
        for bi in range(self.n_blocks):
            for j in range(bi + 1, min(bi + 1 + self.depth, self.n_blocks)):
                if j not in ahead:
                    self._issued_at[j] = time.perf_counter()
                    ahead[j] = self._timed(j, names, pin=True)
            t0 = self._issued_at.pop(bi, None)
            if t0 is not None:
                self.prefetch_overlap_s += time.perf_counter() - t0
            if bi in ahead:  # the LRU order moves as on a fetch
                issued, copied, _ = ahead.pop(bi)
                got = self._ensure(bi, names)
            else:
                issued, copied, got = self._timed(bi, names, pin=False)
            if self._cuda:
                asked = torch.cuda.Event(enable_timing=True)
                asked.record(torch.cuda.current_stream(self.device))
                self._timeline.append((issued, copied, asked))
            blk = self._hand_out(bi, got)
            self.unpin(bi)
            yield bi, blk
        self._issued_at.clear()

    def _host_sync(self) -> None:
        """Wait for every copy in flight (the host reads or writes lanes)."""
        if self._cuda:
            self._up.synchronize()
            self._down.synchronize()
            self._wb.clear()

    def _copy_overlap(self) -> tuple[float, float]:
        """``(overlap, wait)`` ms over the blocks handed out so far, from
        CUDA events: how long each block's uploads ran before the compute
        stream asked for it, and how long it then waited on them."""
        if not self._timeline:
            return 0.0, 0.0
        torch.cuda.synchronize(self.device)
        overlap = wait = 0.0
        for issued, copied, asked in self._timeline:
            took = issued.elapsed_time(copied)
            ahead = issued.elapsed_time(asked)
            overlap += max(0.0, min(took, ahead))
            wait += max(0.0, took - ahead)
        return overlap, wait

    def close(self) -> None:
        """Release both tiers and record the run's stats in
        :data:`LAST_STORE_STATS`."""
        self._host_sync()
        overlap, wait = self._copy_overlap()
        LAST_STORE_STATS.clear()
        LAST_STORE_STATS.update(
            peak_hbm=self.peak_hbm, window=self.window,
            n_blocks=self.n_blocks, block_rows=self.block_rows,
            evictions=self.evictions, uploads=self.uploads,
            h2d_bytes=self.h2d_bytes, d2h_bytes=self.d2h_bytes,
            prefetch_overlap_s=self.prefetch_overlap_s,
            copy_overlap_ms=overlap, copy_wait_ms=wait)
        self._dev.clear()
        self._ready.clear()
        self._pinned.clear()
        self._fills.clear()
        self._timeline.clear()
        self._lanes.clear()
        self._hbm = 0

    def __repr__(self) -> str:
        return (f"<ChunkStore {self.npad} rows x {len(self._lanes)} lanes, "
                f"{self.n_blocks} blocks of {self.block_rows}, "
                f"window {self.window} B, device {self._hbm} B>")


# ---------------------------------------------------------------------------
# frame helpers: host block sub-frames and the release of device copies


# rows per slice of the set-up passes that fill the lanes (binning, the
# design transform): the transforms work row by row, so any slicing gives
# the same lanes, and a slice's float32 sub-frame stays small beside the
# window (JAX transforms one block at a time)
SETUP_ROWS = 1 << 18


def setup_slices(nrow: int):
    """``(lo, hi)`` row ranges of at most :data:`SETUP_ROWS` covering a
    frame of ``nrow`` rows."""
    for lo in range(0, nrow, SETUP_ROWS):
        yield lo, min(lo + SETUP_ROWS, nrow)


def host_block_frame(frame, names: Iterable[str], lo: int, hi: int):
    """A sub-frame of rows ``[lo, min(hi, nrow))`` of ``frame``, each named
    column sliced from its host copy and uploaded as one block-sized
    tensor. Binning and ``DataInfo.transform`` work row by row, so a
    block's result is exactly the rows of the whole frame's."""
    from h2o3_tpu_torch.frame.frame import STR, Frame, Vec

    top = min(hi, frame.nrow)
    vecs = []
    for name in names:
        v = frame.vec(name)
        if v.kind == STR:
            raise ValueError(f"column {name!r} is a string column: streamed "
                             "lanes are numeric or categorical")
        buf = torch.from_numpy(v.host_values()[lo:top]).to(v.device)
        vecs.append(Vec(buf, v.kind, name=name, domain=v.domain))
    return Frame(vecs, list(names))


def release_frame_features(frame, names: Iterable[str]) -> int:
    """Drop the device copies of the named feature columns (they live on as
    the store's lanes); the host copy stays and ``Vec.data`` uploads it
    again on its next use. A no-op under ``H2O3_TPU_FRAME_COMPRESS=0``.
    Returns the bytes released."""
    if not compress_on():
        return 0
    return sum(frame.vec(name).release_device() for name in names)
