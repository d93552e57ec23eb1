"""Kernels B2 and B3 on the card at the headline's shapes, alone.

    PYTHONPATH=<checkout> python h2o3_tpu_torch/tools/bench_split.py [--label L]

Times ``split_candidates_cuda`` (B2) and ``split_candidates_mono_cuda`` (B3)
of whichever ``h2o3_tpu_torch`` is importable (so one call can time two
checkouts in turns) on B1 histograms of 1M rows x 28 columns, 256 bins and
3 float stat lanes at 1, 2, 4, 8, 16 and 32 nodes, the node counts of the
headline's six split levels (10% of the rows retired, as ``chip_smoke.py``
phase 2); B3 with random column directions and every other node bounded.
Per shape and kernel one JSON line: CUDA-event ms over the wrapper (the
median of 21 windows of 50 calls), device-only ms (every kernel and memset
the call launches, under ``torch.profiler``) by kernel name, the plain
version's ms, the least time the card could take (bound), and the host
microseconds per call of ``split_cuda._outputs`` (the wrapper's output
allocation), all in this process on this card.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import time

import numpy as np
import torch

from h2o3_tpu_torch.tools.bench_hist import (
    device_ms,
    device_profile,
    hist_inputs,
    time_ms,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
NODES = (1, 2, 4, 8, 16, 32)


def split_bound(N: int, C: int, B: int, mono: bool) -> tuple[float, str]:
    """B2's (B3's with ``mono``) least time in ms and what sets it: the
    histogram, node totals (and directions and bounds) read once and the
    outputs (gain, t, na_left, Lst, Rst) written once at the card's memory
    rate, or ~24 float32 operations per candidate (B3: 43, the clipped
    child values, differences and products added) at its float32 rate."""
    nbytes = 4 * N * C * B * 3 + 4 * N * 3 + N * C * (4 + 4 + 1 + 24)
    if mono:
        nbytes += 4 * C + 8 * N
    tb = nbytes / HBM_BYTES_PER_S
    tf = (43 if mono else 24) * N * C * (B - 2) / F32_FLOPS
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def median_ms(fn, windows: int = 21, reps: int = 50) -> float:
    """Median over ``windows`` windows of the mean CUDA-event ms per call
    of ``reps`` calls: the wrapper is host-bound, and one slow window (the
    host is shared) moves a single mean by tens of percent."""
    return statistics.median(time_ms(fn, reps, warmup=2 if i == 0 else 0)
                             for i in range(windows))


def host_us(fn, windows: int = 21, reps: int = 200) -> float:
    """Median over windows of the host microseconds per call of ``fn``."""
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) / reps * 1e6)
    return statistics.median(out)


def mono_inputs(N, C, seed, integer=False):
    """Random directions in {-1, 0, 1} per column and bounds on every other
    node (±inf on the rest): quarter-integers for integer stats, else a few
    hundredths, where the child values of these histograms lie. int32 and
    float32 on the card, as the tree loop hands them to B3."""
    rng = np.random.default_rng(seed)
    mono = rng.integers(-1, 2, C).astype(np.int32)
    if integer:
        lo = -rng.integers(0, 4, N) / 4
        hi = rng.integers(0, 4, N) / 4
    else:
        lo = -rng.uniform(0.005, 0.05, N)
        hi = rng.uniform(0.005, 0.05, N)
    bounded = np.arange(N) % 2 == 0
    lo = np.where(bounded, lo, -np.inf).astype(np.float32)
    hi = np.where(bounded, hi, np.inf).astype(np.float32)
    dev = torch.device("cuda")
    return [torch.from_numpy(a).to(dev) for a in (mono, lo, hi)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_split needs a CUDA card")
    from h2o3_tpu_torch.ops import split_cuda
    from h2o3_tpu_torch.ops.hist_cuda import hist_cuda
    from h2o3_tpu_torch.ops.histogram import node_totals
    from h2o3_tpu_torch.ops.split_cuda import (
        split_candidates_cuda,
        split_candidates_mono_cuda,
        split_candidates_mono_plain,
        split_candidates_plain,
    )

    n, C, B = args.rows, 28, 256
    for N in NODES:
        hist = hist_cuda(*hist_inputs(n, C, N, B, seed=N), N, B)
        tot = node_totals(hist).contiguous()
        margs = (hist, tot, 10.0, *mono_inputs(N, C, seed=100 + N))
        for name, kernel, plain, a in (
                ("split", split_candidates_cuda, split_candidates_plain,
                 (hist, tot, 10.0)),
                ("split_mono", split_candidates_mono_cuda,
                 split_candidates_mono_plain, margs)):
            run = functools.partial(kernel, *a)
            prof = device_profile(run, reps=50)
            bound, by = split_bound(N, C, B, name == "split_mono")
            print(json.dumps({
                "label": args.label, "kernel": name, "rows": n, "nodes": N,
                "cols": C, "bins": B, "ms": median_ms(run),
                "device_ms": device_ms(run, reps=50, kernels=(
                    f"split_kernel<{str(name == 'split_mono').lower()}>",)),
                "by_kernel": prof,
                "plain_ms": time_ms(functools.partial(plain, *a), reps=5,
                                    warmup=1),
                "bound_ms": bound, "bound_by": by,
                "outputs_host_us": host_us(functools.partial(
                    split_cuda._outputs, N, C, hist.device)),
                "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
