"""ctypes binding of the native chunked CSV parser (``native/fastcsv.cpp``)
— the port's copy of ``h2o3_tpu/native_csv.py``, the ParseDataset
tokenizer's counterpart: the file's bytes split among threads, each column
typed beforehand as numeric or enum from a pandas sample.

The library is built on first use with JAX's flags (``g++ -O3 -std=c++17
-shared -fPIC -pthread``) into the git-ignored ``h2o3_tpu_torch/_build/``,
named by a hash of the source and the flags, under a file lock (several
test processes may ask at once) and published by an atomic rename. The
JAX package builds its own copy next to the source; the port never writes
there.

The fast path's contract is the C source's (rc < 0 on a violation): a
one-character separator, no double quote anywhere, NA spellings exactly
pandas' default set, blank lines skipped as pandas skips them; a ragged
row or a non-numeric token in a numeric column makes
:func:`parse_csv_native` return None, and the caller uses pandas.
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

_PKG = Path(__file__).resolve().parent
SRC = _PKG.parent / "native" / "fastcsv.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
# why the library is missing, once a build failed (None: not tried or built)
BUILD_ERROR: str | None = None

_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def library_path() -> Path:
    """Where the built library goes: ``_build/libfastcsv_<hash>.so``."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libfastcsv_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "libfastcsv.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one process compiles, others wait
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed on {SRC.name}:\n{r.stderr}")
            os.replace(tmp, out)
        finally:
            if tmp.exists():
                tmp.unlink()
    return out


def _lib() -> ctypes.CDLL | None:
    global _LIB, BUILD_ERROR
    with _LOCK:
        if _LIB is not None or BUILD_ERROR is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
            BUILD_ERROR = f"{type(e).__name__}: {e}"
            return None
        lib.fastcsv_parse.restype = ctypes.c_void_p
        lib.fastcsv_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int,
            ctypes.c_int, _I32P, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ]
        lib.fastcsv_nrows.restype = ctypes.c_int64
        lib.fastcsv_nrows.argtypes = [ctypes.c_void_p]
        lib.fastcsv_get_numeric.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            _F64P]
        lib.fastcsv_get_codes.argtypes = [ctypes.c_void_p, ctypes.c_int, _I32P]
        lib.fastcsv_domain_size.restype = ctypes.c_int64
        lib.fastcsv_domain_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fastcsv_domain_bytes.restype = ctypes.c_int64
        lib.fastcsv_domain_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fastcsv_get_domain.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_char_p]
        lib.fastcsv_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _lib() is not None


def parse_csv_native(data: bytes, names: list[str], kinds: list[int],
                     sep: str = ",", has_header: bool = True,
                     n_threads: int | None = None):
    """Parse a CSV byte buffer with pre-typed columns (JAX's
    ``parse_csv_native``).

    ``kinds[i]``: 0 numeric (float64 out), 1 enum (codes and domain out).
    Returns a pandas DataFrame — numeric columns float64 (the caller
    narrows integers), enum columns Categorical with SORTED categories, as
    the pandas path interns them — or None when the buffer is outside the
    fast path. Level bytes that are not UTF-8 return None too, so that
    pandas raises its own decode error.
    """
    import pandas as pd

    lib = _lib()
    if lib is None or len(sep) != 1:
        return None
    kinds_arr = np.asarray(kinds, np.int32)
    rc = ctypes.c_int(0)
    if n_threads is None:
        n_threads = min(max(os.cpu_count() or 1, 1), 16)
    h = lib.fastcsv_parse(
        data, len(data), sep.encode()[0], int(has_header), len(names),
        kinds_arr, n_threads, ctypes.byref(rc),
    )
    if not h:
        return None  # rc says why; every reason means "use pandas"
    try:
        n = lib.fastcsv_nrows(h)
        cols = {}
        for i, name in enumerate(names):
            if kinds[i] == 0:
                out = np.empty(n, np.float64)
                if n:
                    lib.fastcsv_get_numeric(h, i, out)
                cols[name] = out
                continue
            codes = np.empty(n, np.int32)
            if n:
                lib.fastcsv_get_codes(h, i, codes)
            nbytes = lib.fastcsv_domain_bytes(h, i)
            buf = ctypes.create_string_buffer(int(nbytes) or 1)
            lib.fastcsv_get_domain(h, i, buf)
            try:
                domain = buf.raw[: int(nbytes)].decode("utf-8").split("\n")[:-1]
            except UnicodeDecodeError:
                return None
            # levels sorted and codes remapped, so a column's domain does
            # not depend on which parser ran
            order = np.argsort(np.asarray(domain, object), kind="stable")
            remap = np.empty(len(domain) + 1, np.int32)
            remap[order] = np.arange(len(domain), dtype=np.int32)
            remap[-1] = -1  # the NA slot
            cols[name] = pd.Categorical.from_codes(
                remap[codes], categories=pd.Index([domain[j] for j in order],
                                                  dtype=object))
        return pd.DataFrame(cols)
    finally:
        lib.fastcsv_free(h)
