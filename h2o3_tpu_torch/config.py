"""Runtime knobs of the PyTorch port — the subset of ``h2o3_tpu.config``
that the ported GBM, GLM, DeepLearning, persistence, AutoML, ingest,
munging, out-of-core and tree-variant paths read, under the same names and
with the same defaults (one set of environment variables drives both
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
    "H2O3_TPU_FRAME_COMPRESS": (
        "1", "master switch of the out-of-core data plane "
             "(frame/chunkstore.py): streamed trainings keep their per-row "
             "lanes as row blocks in host memory and release the device "
             "copies of the feature columns they binned or transformed "
             "(Vec.release_device; the column is uploaded again on its next "
             "use, bit-identical). '0' turns the whole plane off (no "
             "streaming, no release), even when H2O3_TPU_HBM_WINDOW_BYTES "
             "is set"),
    "H2O3_TPU_HBM_WINDOW_BYTES": (
        "0", "device-memory window of one training's per-row lanes: a "
             "GBM/XGBoost (not multinomial), GLM (single response, IRLSM, "
             "no p-values) or DeepLearning (not autoencoder) training whose "
             "lanes exceed it streams them as row blocks through an LRU "
             "window of this many bytes (frame/chunkstore.py), the lanes "
             "parked in host memory, pinned on the card; the histogram, "
             "Gram and epoch become loops over the blocks. The lanes JAX "
             "keeps resident stay resident, and a frame that fits takes the "
             "resident path unchanged. '0' = no window, everything resident. "
             "The JAX package also routes by the overload plane's measured "
             "headroom when no window is set; the port reads only this "
             "knob (JAX's behaviour under H2O3_TPU_OVERLOAD=0)"),
    "H2O3_TPU_PREFETCH_DEPTH": (
        "1", "row blocks the streamed loop uploads ahead of the one it "
             "computes on (frame/chunkstore.py): 1 = double buffering (on "
             "the card block k+1 copies on a copy stream while block k "
             "computes), higher values deepen the pipeline at the cost of a "
             "larger share of the window per block; 0 = each block uploaded "
             "when it is asked for"),
    "H2O3_TPU_DL_GRAD_SHARD": (
        "auto", "DeepLearning gradient reduction: the port runs on one "
                "device, where the JAX package's 'auto' and '0' both take "
                "the replicated lane; '1' and 'ctl' ask for the sharded and "
                "ctl lanes, which need more than one device, and raise "
                "NotImplementedError"),
    "H2O3_TPU_TREE_GOSS": (
        "", "gradient-based one-side sampling for tree builds ('a,b': the "
            "top-a fraction of rows by |gradient| plus a sampled b fraction "
            "of the rest, amplified by (1-a)/b, applied after the row "
            "bootstrap in every tree lane: whole-tree, eager and streamed, "
            "where the streamed lane takes the top-a threshold per row "
            "block, as JAX's); '' = off"),
    "H2O3_TPU_TREE_EFB": (
        "0", "exclusive feature bundling for GBM and XGBoost on the "
             "whole-tree build: columns that are almost everywhere at one "
             "bin code and never non-default on the same row share one "
             "bundle column, kernel B1 accumulates over the bundled "
             "columns and the histogram is expanded back to the real "
             "columns right after (split records, varimp, the tmojo and "
             "scoring never see a bundle); skipped under bin coarsening, on "
             "the eager and streamed lanes and when no column bundles; DRF "
             "and XRT do not read it, as in JAX; 0 = off"),
    "H2O3_TPU_HIST_I16": (
        "0", "int16 histogram accumulation on the plain histogram (CPU "
             "tensors): each node's stat lanes rescaled to int8-range codes "
             "(exactly, scale 1, when they are small integers), summed, "
             "and rescaled back; any cell past 32,767 reruns the histogram "
             "in float32. On the card kernel B1 runs unchanged, as the JAX "
             "package leaves its Pallas kernel unchanged; 0 = off"),
    "H2O3_TPU_BIN_ADAPT": (
        "0", "per-level bin coarsening in the whole-tree build (numeric "
             "frames: from depth 3 each level halves the data bins, never "
             "below 63, the histogram and split scan running at 129 and 65 "
             "bins on 255-bin frames; splits are recorded at full "
             "resolution); the eager and streamed lanes do not coarsen, as "
             "in JAX; 0 = off"),
    "H2O3_TPU_TREE_U8CACHE": (
        "1", "bin_frame memoizes a frame's uint8 bin codes on the frame, "
             "keyed by the BinSpec's contents and the columns' identity, so "
             "repeated builds over one frame (AutoML, grids, CV, checkpoint "
             "restarts) bin it once; a column replaced by Frame.__setitem__ "
             "misses the cache; 0 = bin on every call"),
    "H2O3_TPU_NATIVE": (
        "1", "the offline scorer's C++ tree walk (native/tmojo_score.cpp, "
             "built by g++ into h2o3_tpu_torch/_build/ on first use; "
             "genmodel.py) on (1) / off (0, the numpy level replay, which "
             "gives the same bits)"),
    "H2O3_TPU_NATIVE_PARSE": (
        "1", "native chunked CSV parser (native/fastcsv.cpp, built by g++ "
             "into h2o3_tpu_torch/_build/ on first use) on (1) / off (0); "
             "files outside its strict dialect always go to pandas"),
    "H2O3_TPU_STREAM_BYTES": (
        str(256 * 1024 * 1024),
        "CSV bytes above which parse streams in chunks (frame/parse.py "
        "parse_stream: 1M-row pandas chunks, enum levels interned chunk by "
        "chunk)"),
    "H2O3_TPU_INGEST_SHARDS": (
        "0", "sharded CSV ingest (frame/parse.py parse_sharded): how many "
             "byte ranges one process splits the source into and parses "
             "independently (each range located by a streaming newline "
             "scan and tokenized by the native byte-range parser) before "
             "concatenating, equal to the one-range parse; 0 = one range. "
             "The port runs one process: a multi-process parse raises "
             "NotImplementedError (ROADMAP Queue A 8)"),
    "H2O3_TPU_MUNGE_FUSE": (
        "1", "deferred munging: elementwise operators and ifelse return a "
             "LazyExprVec (frame/lazy.py) whose whole expression chain is "
             "evaluated on first touch, block by block through the "
             "ChunkStore window when one is configured (the result then "
             "stays in host memory), and group-by streams its value "
             "columns through the window the same way; 0 = every operator "
             "evaluated when called and group-by resident (the same "
             "values, bit for bit)"),
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
