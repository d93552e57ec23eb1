"""Launch-geometry autotuner of kernel B1 — the port of the tile autotuner
of ``h2o3_tpu/ops/hist_pallas.py`` (``_tiles``, ``_tile_bucket``,
``_sweep_grid``, ``_run_tile_sweep``, ``tiles_for``).

``H2O3_TPU_PALLAS_TILES``, the JAX package's knob under its name and
default, sets B1's three launch parameters ``(rows per block, columns per
group, nodes per shared-memory tile)`` (``hist_cuda.launch_geometry``):

- ``''``: the built-in geometry (``hist_cuda.builtin_tiles``);
- ``'ROWS,COLS,NODES'``: those values, as given, with no sweep;
- ``'auto'``: the first launch of a shape bucket on a card times every
  candidate of :func:`_sweep_grid` with CUDA events on synthetic data of the
  bucket's geometry, and keeps the fastest, in-process and in
  ``h2o3_tpu_torch/_build/hist_tiles.json`` (keyed by bucket, row count and
  card name), so a same-bucket launch, here or in a later process, sweeps
  no more. A candidate the card refuses to launch is skipped;
- anything else raises ``ValueError``.

The sweep runs at the caller's row count rounded up to a power of two: at
the JAX package's 4096 rows an H100 would time launch overhead.

One environment variable drives both packages, but an explicit triple means
different things in each: the JAX package reads it as its Pallas (row,
column, node) tiles. A triple set for the JAX kernel changes the port's
geometry too, and one whose shared-memory tile exceeds a block's
(``hist_cuda.SMEM_LIMIT``; JAX's ``'256,4,32'`` asks for 393 KB at 256 bins
and 3 lanes) makes every launch of B1 raise ``ValueError``.
"""

from __future__ import annotations

import functools
import json
import os

import torch

from h2o3_tpu_torch import config
from h2o3_tpu_torch.ops import cuda_build

CACHE_PATH = cuda_build.BUILD_DIR / "hist_tiles.json"
_TUNED: dict = {}  # in-process cache: key -> (rows, cols, nodes)
SWEEP_TIMES: dict = {}  # key -> {candidate: ms} of each sweep run here
_SWEEP_REPS = 10


def _tiles() -> tuple[int, int, int] | None:
    """The knob as the JAX package's ``_tiles`` parses it; None stands for
    the built-in geometry (``''`` and ``'auto'``, which :func:`tiles_for`
    resolves per shape)."""
    spec = config.get("H2O3_TPU_PALLAS_TILES").strip()
    if not spec or spec == "auto":
        return None
    parts = [int(x) for x in spec.split(",")]
    if len(parts) != 3 or any(p <= 0 for p in parts):
        raise ValueError(
            f"H2O3_TPU_PALLAS_TILES must be 'ROW,COL,NODE' positive ints "
            f"or 'auto', got {spec!r}")
    return tuple(parts)


def _tile_bucket(c: int, n_nodes: int, n_bins: int, ns: int) -> tuple:
    """Shape bucket, as the JAX package's: columns to a multiple of 8,
    nodes and bins to powers of two."""
    cb = -(-c // 8) * 8
    nb = 1 << max(int(n_nodes - 1).bit_length(), 1)
    bb = 1 << max(int(n_bins - 1).bit_length(), 3)
    return (cb, nb, bb, ns)


def _row_bucket(n: int) -> int:
    """Rows of the sweep: ``n`` rounded up to a power of two."""
    return 1 << max(int(n - 1).bit_length(), 0)


def _sweep_grid(n: int, c: int, n_nodes: int, n_bins: int, ns: int,
                wave) -> list:
    """The candidate triples: columns per group 8, 16 and as many as fit
    two blocks per SM, by 1, 2 or 4 nodes per tile, less those over one
    block's shared memory, each with the rows per block that fill one, two
    or four waves of the card (``wave(smem)`` clusters each); the built-in
    geometry is among them."""
    from h2o3_tpu_torch.ops import hist_cuda as hc

    builtin = hc.builtin_tiles(n, c, n_nodes, n_bins, ns, wave)
    wide = hc._cols_fitting(c, n_bins, ns, hc._MAX_COLS)
    cols = sorted({min(c, 8), min(c, 16), wide, builtin[1]})
    nodes = sorted({1, min(2, n_nodes), min(4, n_nodes)})
    grid = []
    for ct in cols:
        for nt in nodes:
            smem = nt * ct * n_bins * ns * 4
            if smem > hc.SMEM_LIMIT:
                continue
            for k in (1, 2, 4):
                cand = (hc.rows_per_wave(n, -(-c // ct), k * wave(smem)), ct,
                        nt)
                if cand not in grid:
                    grid.append(cand)
    return grid


def sweep_inputs(n: int, c: int, n_nodes: int, n_bins: int, ns: int,
                 device: torch.device) -> tuple:
    """The sweep's synthetic data, made on the card from seed 0: uniform
    codes, every row in one of the nodes, normal stats."""
    gen = torch.Generator(device=device).manual_seed(0)
    bins = torch.randint(0, n_bins, (n, c), dtype=torch.uint8,
                         generator=gen, device=device)
    nid = torch.randint(0, n_nodes, (n,), dtype=torch.int32, generator=gen,
                        device=device)
    stats = torch.randn(n, ns, generator=gen, device=device)
    return bins, nid, stats


def _run_tile_sweep(n, c, n_nodes, n_bins, ns, device) -> tuple:
    """Time each candidate on :func:`sweep_inputs`; returns the fastest
    triple (None if the card launched none) and every candidate's ms."""
    from h2o3_tpu_torch.ops import hist_cuda as hc

    wave = functools.partial(hc._wave_clusters, device, ns)
    bins, nid, stats = sweep_inputs(n, c, n_nodes, n_bins, ns, device)
    rows, start = hc._launch_compact(nid, n_nodes)
    times = {}
    for tiles in _sweep_grid(n, c, n_nodes, n_bins, ns, wave):
        try:
            g = hc.launch_geometry(n, c, n_nodes, n_bins, ns, wave, tiles)
            hc._launch_hist(bins, stats, rows, start, n_nodes, n_bins, g)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(_SWEEP_REPS):
                hc._launch_hist(bins, stats, rows, start, n_nodes, n_bins, g)
            t1.record()
            t1.synchronize()
        except (RuntimeError, ValueError):  # a candidate the card refuses
            continue
        times[tiles] = t0.elapsed_time(t1) / _SWEEP_REPS
    best = min(times, key=times.get) if times else None
    return best, times


def tiles_for(n: int, c: int, n_nodes: int, n_bins: int, ns: int,
              device: torch.device) -> tuple[int, int, int] | None:
    """B1's tiles for one launch: :func:`_tiles` unless the knob is
    ``'auto'``; then the bucket's winner from the in-process cache, the
    persistent store, or a new sweep (``tiles_for.sweeps`` counts sweeps).
    None stands for the built-in geometry."""
    spec = config.get("H2O3_TPU_PALLAS_TILES").strip()
    if spec != "auto":
        return _tiles()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    rows = _row_bucket(n)
    key = (_tile_bucket(c, n_nodes, n_bins, ns), rows, name)
    if key in _TUNED:
        return _TUNED[key]
    skey = repr(key)
    try:
        with open(CACHE_PATH) as f:
            stored = json.load(f)
    except (OSError, ValueError):
        stored = {}
    if skey in stored:
        hit = stored[skey]
        _TUNED[key] = tuple(int(x) for x in hit) if hit else None
        return _TUNED[key]
    tiles_for.sweeps += 1
    cb, nb, bb, _ = key[0]
    tiles, times = _run_tile_sweep(rows, cb, nb, min(bb, 256), ns, device)
    SWEEP_TIMES[key] = times
    _TUNED[key] = tiles
    try:
        CACHE_PATH.parent.mkdir(parents=True, exist_ok=True)
        stored[skey] = list(tiles) if tiles else None
        tmp = f"{CACHE_PATH}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(stored, f, indent=0, sort_keys=True)
        os.replace(tmp, CACHE_PATH)  # atomic publish
    except OSError:
        pass  # a read-only checkout: the in-process cache still holds
    return tiles


tiles_for.sweeps = 0
