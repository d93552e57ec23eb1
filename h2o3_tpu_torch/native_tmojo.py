"""ctypes binding of the native tmojo tree walk (``native/tmojo_score.cpp``)
— the port's copy of ``h2o3_tpu/native.py``, the C++ half of the offline
scorer (``genmodel.py``).

:func:`forest_blob` flattens a loaded tree tmojo's per-level arrays into
the contiguous layout of the C interface (once per model, kept on the
``MojoModel``); :func:`score_forest` then walks every tree row by row with
an early exit per row, and :func:`bin_numeric` bins a float32 column by its
edges. Both give the same bits as the numpy level replay: float32 leaves
accumulate into float64 in export order.

The library is built on first use with JAX's flags (``g++ -O3 -shared
-fPIC``, with ``-fopenmp`` when the toolchain has it) into the git-ignored
``h2o3_tpu_torch/_build/``, named by a hash of the source and the flags,
under a file lock (several test processes may ask at once) and published by
an atomic rename. The JAX package builds its own copy next to the source;
the port never writes there. ``H2O3_TPU_NATIVE=0`` turns the walk off;
:data:`BUILD_ERROR` says why the library is missing.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from h2o3_tpu_torch import config

_PKG = Path(__file__).resolve().parent
SRC = _PKG.parent / "native" / "tmojo_score.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
# tried in order: OpenMP when the toolchain has it, then without
_EXTRA_FLAGS = (("-fopenmp",), ())

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# why the library is missing, once a build failed (None: not tried or built)
BUILD_ERROR: str | None = None

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def library_path(extra: tuple = _EXTRA_FLAGS[0]) -> Path:
    """Where the built library goes: ``_build/libtmojo_<hash>.so``."""
    h = hashlib.sha256(SRC.read_bytes()
                       + " ".join(GXX_FLAGS + tuple(extra)).encode())
    return BUILD_DIR / f"libtmojo_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    for extra in _EXTRA_FLAGS:
        if library_path(extra).exists():
            return library_path(extra)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libtmojo.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one process compiles, others wait
        errors = []
        for extra in _EXTRA_FLAGS:
            out = library_path(extra)
            if out.exists():
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                r = subprocess.run(
                    ["g++", *GXX_FLAGS, *extra, str(SRC), "-o", str(tmp)],
                    capture_output=True, text=True, timeout=300)
                if r.returncode == 0:
                    os.replace(tmp, out)
                    return out
                errors.append(r.stderr)
            finally:
                if tmp.exists():
                    tmp.unlink()
    raise RuntimeError(f"g++ failed on {SRC.name}:\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, or None (no compiler, or the build failed)."""
    global _LIB, BUILD_ERROR
    with _LOCK:
        if _LIB is not None or BUILD_ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            BUILD_ERROR = f"{type(e).__name__}: {e}"
            return None
        lib.tmojo_score_forest.restype = None
        lib.tmojo_score_forest.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int64,          # bins, n, C
            ctypes.c_int64, ctypes.c_int64,                # n_trees, K
            _I64P, _I64P, _I64P,                           # starts, counts, offs
            _I32P, _I32P, _U8P, _U8P, ctypes.c_int64,      # col, bin, iscat, mask, B
            _U8P, _U8P, _F32P, _I32P,                      # naleft, leaf, val, child
            _F64P,                                         # out
        ]
        lib.tmojo_bin_numeric.restype = None
        lib.tmojo_bin_numeric.argtypes = [
            _F32P, ctypes.c_int64, _F32P, ctypes.c_int64, _U8P,
        ]
        _LIB = lib
        return _LIB


def enabled() -> bool:
    """The native walk is on (``H2O3_TPU_NATIVE``) and the library built."""
    return config.get_bool("H2O3_TPU_NATIVE") and get_lib() is not None


def forest_blob(mojo) -> dict:
    """A tree tmojo's level arrays flattened into the C layout (kept on
    ``mojo``)."""
    blob = getattr(mojo, "_native_blob", None)
    if blob is not None:
        return blob
    a = mojo.arrays
    shapes = mojo.meta["tree_levels"]  # [tree][class] -> n_levels
    K = mojo.meta["n_tree_classes"]
    n_trees = len(shapes)
    starts = np.zeros(n_trees * K, np.int64)
    counts = np.zeros(n_trees * K, np.int64)
    offs: list[int] = []
    parts: dict[str, list] = {f: [] for f in (
        "split_col", "split_bin", "is_cat", "cat_mask", "na_left",
        "leaf_now", "leaf_val", "child_base")}
    dtypes = {"split_col": np.int32, "split_bin": np.int32,
              "is_cat": np.uint8, "cat_mask": np.uint8, "na_left": np.uint8,
              "leaf_now": np.uint8, "leaf_val": np.float32,
              "child_base": np.int32}
    node_off = lvl_i = 0
    for ti in range(n_trees):
        for ki in range(K):
            starts[ti * K + ki] = lvl_i
            counts[ti * K + ki] = shapes[ti][ki]
            for li in range(shapes[ti][ki]):
                pre = f"t{ti}_k{ki}_l{li}_"
                offs.append(node_off)
                node_off += len(a[pre + "split_col"])
                lvl_i += 1
                for f, dt in dtypes.items():
                    parts[f].append(np.asarray(a[pre + f], dt))
    B = parts["cat_mask"][0].shape[1] if parts["cat_mask"] else 1
    blob = {"n_trees": n_trees, "K": K, "B": int(B), "starts": starts,
            "counts": counts, "offs": np.asarray(offs, np.int64)}
    for f, arrs in parts.items():
        cat = (np.concatenate(arrs) if arrs
               else np.zeros((0, B) if f == "cat_mask" else 0, dtypes[f]))
        blob[f] = np.ascontiguousarray(cat).reshape(-1)
    mojo._native_blob = blob
    return blob


def score_forest(mojo, bins: np.ndarray) -> np.ndarray:
    """The whole forest walked natively: (n, K) float64 leaf sums."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native tmojo library unavailable: {BUILD_ERROR}")
    blob = forest_blob(mojo)
    bins_u8 = np.ascontiguousarray(bins.astype(np.uint8))
    n, C = bins_u8.shape
    out = np.zeros((n, blob["K"]), np.float64)
    lib.tmojo_score_forest(
        bins_u8, n, C, blob["n_trees"], blob["K"],
        blob["starts"], blob["counts"], blob["offs"],
        blob["split_col"], blob["split_bin"], blob["is_cat"],
        blob["cat_mask"], blob["B"],
        blob["na_left"], blob["leaf_now"], blob["leaf_val"],
        blob["child_base"], out)
    return out


def bin_numeric(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Float32 binning by ``edges`` (searchsorted left, plus 1; code 0 =
    NaN), natively."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native tmojo library unavailable: {BUILD_ERROR}")
    xf = np.ascontiguousarray(x, np.float32)
    ef = np.ascontiguousarray(edges, np.float32)
    out = np.empty(len(xf), np.uint8)
    lib.tmojo_bin_numeric(xf, len(xf), ef, len(ef), out)
    return out
