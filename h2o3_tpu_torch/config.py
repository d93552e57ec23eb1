"""Runtime knobs of the PyTorch port — the subset of ``h2o3_tpu.config``
that the ported GBM path reads, under the same names and with the same
defaults (one set of environment variables drives both packages)."""

from __future__ import annotations

import os

_KNOBS: dict[str, tuple[str, str]] = {
    "H2O3_TPU_HIST_SUBTRACT": (
        "1", "tree builder: build the lighter child's histogram, derive the "
             "sibling by parent subtraction (0 = direct per-node histograms)"),
    "H2O3_TPU_SHAPE_BUCKETS": (
        "1", "shape-bucketed padding: histogram bins round up to a power of "
             "two and feature columns to a multiple of 4 (the padding is "
             "inert: empty bins and all-NA columns never win a split)"),
    "H2O3_TPU_PALLAS_TILES": (
        "", "kernel B1 launch geometry: '' = built in; 'ROWS,COLS,NODES' = "
            "rows per block, columns per group, nodes per shared-memory "
            "tile, used as given; 'auto' = a sweep per shape bucket and "
            "card, cached in h2o3_tpu_torch/_build/hist_tiles.json. The "
            "JAX package reads the same variable, where a triple means its "
            "Pallas row, column and node tiles: one setting drives both "
            "packages, and a triple set for one may not fit the other "
            "(the port raises ValueError on a tile over one block's shared "
            "memory)"),
}


def get(name: str) -> str:
    default, _ = _KNOBS[name]
    return os.environ.get(name, default)


def get_bool(name: str) -> bool:
    return get(name) not in ("0", "false", "False", "")
