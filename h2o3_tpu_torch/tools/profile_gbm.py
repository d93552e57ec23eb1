"""Where the headline GBM's time goes on the card.

    python -m h2o3_tpu_torch.tools.profile_gbm [--rows N] [--trees T]

Uploads the Higgs-like frame, trains the headline GBM once to warm up
(depth 6, lr 0.1, min_rows 10, seed 42), then measures a second training:
host phases with ``torch.cuda.synchronize()`` around each (binning, the tree
loop, training metrics), and the whole training under ``torch.profiler``
for the device time of every kernel by name. Prints one JSON line: the
wall seconds, the device-busy seconds (kernels on one stream do not
overlap), the idle share, the phases, the kernels by device time,
kernel B1's device time summed over its four kernels, and the split
kernel B2's device time and launches.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from h2o3_tpu_torch import upload_file
from h2o3_tpu_torch.datasets import higgs_like
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree import gbm as gbm_mod
from h2o3_tpu_torch.models.tree.binning import bin_frame, fit_bins


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gbm needs a CUDA card")
    kw = dict(ntrees=args.trees, max_depth=6, learn_rate=0.1, min_rows=10.0,
              seed=42)
    df = higgs_like(args.rows)
    fr, upload_s = _timed(lambda: upload_file(df))
    feats = [c for c in fr.names if c != "label"]

    def train():
        return H2OGradientBoostingEstimator(**kw).train(
            y="label", training_frame=fr)

    train()  # warm-up: first-call costs stay out of the measurement
    est, train_s = _timed(train)
    spec, fit_s = _timed(lambda: fit_bins(fr, feats, seed=42))
    bins, bin_s = _timed(lambda: bin_frame(spec, fr))
    F = torch.zeros(args.rows, device=bins.device)
    y = np.zeros(args.rows)
    y[: args.rows // 2] = 1
    _, metrics_s = _timed(lambda: gbm_mod._metrics_from_F(
        "bernoulli", F + torch.randn_like(F), y, np.ones(args.rows), ("b", "s")))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, traced_s = _timed(train)
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            k = kernels.setdefault(evt.key[:90], [0.0, 0])
            k[0] += us / 1e3
            k[1] += evt.count
    busy_s = sum(v[0] for v in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    # kernel B1 is four kernels (b1_*) per launch; one b1_hist_tile each
    b1 = [v for k, v in kernels.items() if "b1_" in k]
    b1_calls = sum(v[1] for k, v in kernels.items() if "b1_hist_tile" in k)
    # kernel B2 (split_kernel<false>), one kernel per launch
    split = [v for k, v in kernels.items() if "split_kernel" in k]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "rows": args.rows, **kw,
        "upload_s": upload_s, "train_s": train_s,
        "trees_per_sec": args.trees / train_s,
        "phases_s": {"fit_bins": fit_s, "bin_frame": bin_s,
                     "training_metrics": metrics_s,
                     "tree_loop_and_rest": train_s - fit_s - bin_s - metrics_s},
        "traced_train_s": traced_s, "device_busy_s": busy_s,
        "device_idle_share": 1 - busy_s / traced_s,
        "kernels_ms": [{"name": k, "ms": v[0], "calls": v[1]} for k, v in top],
        "b1_ms": sum(v[0] for v in b1), "b1_launches": b1_calls,
        "split_ms": sum(v[0] for v in split),
        "split_launches": sum(v[1] for v in split),
        "auc": est.auc(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
