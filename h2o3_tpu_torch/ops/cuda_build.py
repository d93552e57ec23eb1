"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``_build/lib<name>_<hash>.so`` on first use,
then loaded with ``ctypes``. The hash covers the source and the flags, so
an edited kernel never loads a stale library. Nothing here runs at import
time: only the CUDA path of a wrapper (or an explicit :func:`build_all`)
reaches the compiler, so the CPU tests import every module without it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: the split kernel's gains must
    # round exactly as the plain PyTorch version's separate ops do
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}  # name -> nvcc/ptxas output of its last build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required to "
                           "build the h2o3_tpu_torch kernels")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{h}.so"


def _compile(name: str) -> Path:
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{BUILD_LOG[name]}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _compile(name)
    lib = ctypes.CDLL(str(path))
    lib.h2o3_cuda_error_string.argtypes = [ctypes.c_int]
    lib.h2o3_cuda_error_string.restype = ctypes.c_char_p
    with _LOCK:
        _LIBS.setdefault(name, lib)
        return _LIBS[name]


def build_all(names=("hist", "split")) -> dict[str, ctypes.CDLL]:
    """Build every named kernel in parallel (one nvcc per source) and load
    them; raises on the first failed build."""
    errors: dict[str, BaseException] = {}

    def one(n):
        try:
            _compile(n)
        except BaseException as e:  # re-raised below, on the caller's thread
            errors[n] = e

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next(iter(errors.values()))
    return {n: load(n) for n in names}


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch function."""
    if err:
        msg = lib.h2o3_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
