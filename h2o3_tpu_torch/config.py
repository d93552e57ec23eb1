"""Runtime knobs of the PyTorch port — the subset of ``h2o3_tpu.config``
that the ported GBM and GLM paths read, under the same names and with the same
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
    "H2O3_TPU_WHOLE_TREE": (
        "1", "whole-tree build: every level of a tree runs at padded shapes "
             "with no host read, and GBM builds a scoring interval of trees "
             "per chunk; on the card each tree is one CUDA-graph replay "
             "(a tree that reaches node_cap: one for the levels before the "
             "saturated run, one per saturated level, one for the terminal "
             "level), at any depth (the JAX package bounds its unrolled "
             "program by H2O3_TPU_FUSED_MAX_DEPTH, which the port does not "
             "read); 0 = the eager per-level loop with its host reads "
             "(debug/bisect escape hatch)"),
    "H2O3_TPU_GLM_FUSE": (
        "auto", "GLM IRLSM: iterations per chunk on the device, the state "
                "frozen by torch.where once a chunk stops and read by the "
                "host once per chunk (the ADMM solve reads one flag per "
                "block of steps); 'auto' = 8, an integer N >= 1 = N, '0' = "
                "every iteration's Gram read to the host and solved there "
                "in float64 (the JAX package's per-iteration lane)"),
}


def get(name: str) -> str:
    default, _ = _KNOBS[name]
    return os.environ.get(name, default)


def get_bool(name: str) -> bool:
    return get(name) not in ("0", "false", "False", "")
