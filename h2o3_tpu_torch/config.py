"""Runtime knobs of the PyTorch port — the subset of ``h2o3_tpu.config``
that the ported GBM, GLM, DeepLearning, persistence and AutoML paths read, under the same names
and with the same defaults (one set of environment variables drives both
packages)."""

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
    "H2O3_TPU_HBM_WINDOW_BYTES": (
        "0", "device-memory window of the out-of-core lanes (0 = everything "
             "resident); the port has no streamed lane yet: a DeepLearning "
             "design larger than a set window raises NotImplementedError"),
    "H2O3_TPU_DL_GRAD_SHARD": (
        "auto", "DeepLearning gradient reduction: the port runs on one "
                "device, where the JAX package's 'auto' and '0' both take "
                "the replicated lane; '1' and 'ctl' ask for the sharded and "
                "ctl lanes, which need more than one device, and raise "
                "NotImplementedError"),
    "H2O3_TPU_PERSIST_RETRIES": (
        "4", "transient persist IO failures are retried this many times "
             "before surfacing (deterministic errors — bad path, collision, "
             "corrupt file — always fail fast)"),
    "H2O3_TPU_PERSIST_BACKOFF": (
        "0.2", "base persist retry backoff, seconds: delay = base * 2^attempt "
               "plus up to +50% deterministic jitter (keyed on op+attempt)"),
    "H2O3_TPU_AUTOML_STEP_RETRIES": (
        "2", "AutoML poison-step guard: a plan step whose build has already "
             "crashed this many recorded attempts (the step manifest under "
             "export_checkpoints_dir counts them across resumes) is skipped "
             "with a warning instead of killing every resume at the same "
             "place; 0 disables the guard"),
}


def get(name: str) -> str:
    default, _ = _KNOBS[name]
    return os.environ.get(name, default)


def get_bool(name: str) -> bool:
    return get(name) not in ("0", "false", "False", "")


def get_int(name: str) -> int:
    return int(get(name))


def get_float(name: str) -> float:
    return float(get(name))
