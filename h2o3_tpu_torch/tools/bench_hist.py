"""Kernel B1 on the card at the headline's shapes, alone.

    PYTHONPATH=<checkout> python h2o3_tpu_torch/tools/bench_hist.py [--label L]

Times ``hist_cuda`` of whichever ``h2o3_tpu_torch`` is importable (so one
call can time two checkouts in turns) on 1M rows x 28 columns, 256 bins,
3 stat lanes: 1, 8 and 32 nodes with 10% of the rows retired (the inputs of
``chip_smoke.py`` phase 2), 1 node with every row active (depth 0) and 16
nodes with half of the rows dead (the depth-5 sibling launch). Per shape
one JSON line: CUDA-event ms over the wrapper, device-only ms (all device
time under ``torch.profiler``, per call) and one ``index_add_`` computing
the same histogram, all in this process on this card.
"""

from __future__ import annotations

import argparse
import json
import re

import numpy as np
import torch

SHAPES = (  # (label, nodes, share of rows dead, seed)
    ("1", 1, 0.1, 1), ("8", 8, 0.1, 8), ("32", 32, 0.1, 32),
    ("1_all", 1, 0.0, 2), ("16_sibling", 16, 0.5, 16))


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_profile(fn, reps: int = 10) -> dict:
    """Device milliseconds per call by kernel (and memset) name, under
    ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"b1_\w+|split_kernel<\w+>|Memset", e.key)
            name = m.group(0) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def device_ms(fn, reps: int = 10) -> float:
    """Device-only milliseconds per call: the self device time of every
    kernel and memset the calls put on the card."""
    return sum(device_profile(fn, reps).values())


def hist_inputs(n, C, N, B, seed, dead=0.1, integer=False):
    """(bins, nid, stats) on the card: codes uniform over B bins, nid uniform
    over N nodes with a ``dead`` share at -1, three stat lanes {w, wy, wh}
    (integer-valued with ``integer``)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, (n, C)).astype(np.uint8)
    nid = rng.integers(0, N, n).astype(np.int32)
    nid[rng.random(n) < dead] = -1
    if integer:
        w = np.ones(n, np.float32)
        stats = np.stack([w, rng.integers(-3, 4, n).astype(np.float32), w], 1)
    else:
        w = rng.random(n).astype(np.float32)
        stats = np.stack([w, w * rng.normal(size=n).astype(np.float32),
                          w * rng.random(n).astype(np.float32)], 1)
    dev = torch.device("cuda")
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (bins, nid, stats)]


def index_add_ms(bins, nid, stats, N, B) -> float:
    """One ``index_add_`` over flattened ((node·B + bin)·C + col) computing
    the same histogram; the index is built outside the timing."""
    C, S = bins.shape[1], stats.shape[1]
    keep = nid >= 0
    idx = ((nid[keep].long()[:, None] * B + bins[keep].long()) * C
           + torch.arange(C, device=bins.device)).reshape(-1)
    src = stats[keep].repeat_interleave(C, dim=0)
    out = torch.zeros(N * B * C, S, device=bins.device)
    return time_ms(lambda: out.index_add_(0, idx, src), reps=5, warmup=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_hist needs a CUDA card")
    from h2o3_tpu_torch.ops import hist_cuda as hc
    from h2o3_tpu_torch.ops.hist_cuda import hist_cuda

    n, C, B = args.rows, 28, 256
    for label, N, dead, seed in SHAPES:
        bins, nid, stats = hist_inputs(n, C, N, B, seed, dead)

        def run():
            return hist_cuda(bins, nid, stats, N, B)

        prof = device_profile(run)
        print(json.dumps({
            "label": args.label, "shape": label, "rows": n, "nodes": N,
            "active": int((nid >= 0).sum()), "ms": time_ms(run, reps=20),
            "device_ms": sum(prof.values()), "by_kernel": prof,
            "index_add_ms": index_add_ms(bins, nid, stats, N, B),
            "waves": {str(k): v for k, v in getattr(hc, "_WAVE", {}).items()},
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
