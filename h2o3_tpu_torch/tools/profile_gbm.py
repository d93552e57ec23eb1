"""Where the headline GBM's time goes on the card.

    python -m h2o3_tpu_torch.tools.profile_gbm [--rows N] [--trees T]

Uploads the Higgs-like frame and trains the headline GBM (depth 6, lr 0.1,
min_rows 10, seed 42, score_tree_interval 5) on the default whole-tree
path: a first training (it builds the kernels if needed and captures the
tree's CUDA graph: capture seconds, graph pool and state bytes, and whether
the graph cache kept them after the training), then a
warm one, timed. Then, apart: the host phases with
``torch.cuda.synchronize()`` around each (binning, one device-stats
training-metrics call, times the calls a training makes), a warm training
under ``torch.profiler`` for the device-busy time, the idle share and the
device time of every kernel by name and the host seconds of the GBM's
``gbm.*`` spans (setup, whole-tree setup, chunk builds, record pulls,
scoring, final metrics), and a warm training of the eager
per-level loop (``H2O3_TPU_WHOLE_TREE=0``) in the same process. Kernels
inside graph replays are read from the graph path's trace when the
profiler reports them there (``graph_kernels_visible``); otherwise the
per-kernel times come from a traced eager training (``kernels_from``).
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from h2o3_tpu_torch import upload_file
from h2o3_tpu_torch.datasets import higgs_like
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree import gbm as gbm_mod
from h2o3_tpu_torch.models.tree import shared_tree
from h2o3_tpu_torch.models.tree.binning import bin_frame, fit_bins


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profiled(fn) -> tuple[dict, dict, float]:
    """``{kernel name: [device ms, calls]}`` of one traced call, the host
    seconds of the GBM's ``gbm.*`` spans (``record_function`` in
    ``models/tree/gbm.py``; a span that waits on the card includes the
    wait), and the call's wall seconds."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = _timed(fn)
    kernels, spans = {}, {}
    for evt in prof.key_averages():
        if evt.key.startswith("gbm."):  # the host entry, not its device twin
            spans[evt.key] = max(spans.get(evt.key, 0.0),
                                 evt.cpu_time_total / 1e6)
            continue
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        if us > 0:
            k = kernels.setdefault(evt.key[:90], [0.0, 0])
            k[0] += us / 1e3
            k[1] += evt.count
    return kernels, spans, wall


def _kernel_summary(kernels: dict) -> dict:
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    # kernel B1 is four kernels (b1_*) per launch; one b1_hist_tile each
    b1 = [v for k, v in kernels.items() if "b1_" in k]
    # kernel B2 (split_kernel<false>), one kernel per launch
    split = [v for k, v in kernels.items() if "split_kernel" in k]
    return {
        "kernels_ms": [{"name": k, "ms": v[0], "calls": v[1]} for k, v in top],
        "b1_ms": sum(v[0] for v in b1),
        "b1_launches": sum(v[1] for k, v in kernels.items()
                           if "b1_hist_tile" in k),
        "split_ms": sum(v[0] for v in split),
        "split_launches": sum(v[1] for v in split),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gbm needs a CUDA card")
    kw = dict(ntrees=args.trees, max_depth=6, learn_rate=0.1, min_rows=10.0,
              seed=42, score_tree_interval=5)
    df = higgs_like(args.rows)
    fr, upload_s = _timed(lambda: upload_file(df))
    feats = [c for c in fr.names if c != "label"]

    def train():
        return H2OGradientBoostingEstimator(**kw).train(
            y="label", training_frame=fr)

    knob = os.environ.get("H2O3_TPU_WHOLE_TREE")
    os.environ["H2O3_TPU_WHOLE_TREE"] = "1"
    _, first_s = _timed(train)  # builds the kernels, captures the graph
    # the capture's sizes, and whether the cache kept the plan (it keeps
    # the latest plans within a share of the card's memory)
    graphs = dict(shared_tree.GRAPH_EVENTS["last_capture"], cached=any(
        (g["rows"], g["depth"]) == (args.rows, 6)
        for g in shared_tree.graph_stats()),
        cache_budget_bytes=shared_tree._GRAPH_CACHE_SHARE
        * torch.cuda.get_device_properties(0).total_memory)
    est, train_s = _timed(train)
    spec, fit_s = _timed(lambda: fit_bins(fr, feats, seed=42))
    bins, bin_s = _timed(lambda: bin_frame(spec, fr))
    F = torch.randn(args.rows, device=bins.device)
    y = (torch.arange(args.rows, device=bins.device) % 2).float()
    w = torch.ones(args.rows, device=bins.device)
    _, metrics_s = _timed(lambda: gbm_mod._metrics_from_F(
        "bernoulli", F, y, w, ("b", "s")))
    metric_calls = math.ceil(args.trees / kw["score_tree_interval"]) + 1

    kernels, spans, traced_s = _profiled(train)
    busy_s = sum(v[0] for v in kernels.values()) / 1e3
    visible = any("b1_hist_tile" in k for k in kernels)
    os.environ["H2O3_TPU_WHOLE_TREE"] = "0"
    train()  # the eager loop's warm-up
    _, eager_s = _timed(train)
    eager_kernels, eager_spans, eager_traced_s = _profiled(train)
    if knob is None:
        os.environ.pop("H2O3_TPU_WHOLE_TREE")
    else:
        os.environ["H2O3_TPU_WHOLE_TREE"] = knob
    eager_busy_s = sum(v[0] for v in eager_kernels.values()) / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "rows": args.rows, **kw,
        "upload_s": upload_s, "first_train_s": first_s,
        "train_s": train_s, "trees_per_sec": args.trees / train_s,
        "graph": graphs,
        "phases_s": {"fit_bins": fit_s, "bin_frame": bin_s,
                     "training_metrics_per_call": metrics_s,
                     "training_metrics_calls": metric_calls,
                     "training_metrics": metrics_s * metric_calls,
                     "tree_loop_and_rest": train_s - fit_s - bin_s
                     - metrics_s * metric_calls},
        "traced_train_s": traced_s, "host_spans_s": spans,
        "device_busy_s": busy_s,
        "device_idle_share": 1 - busy_s / traced_s,
        "graph_kernels_visible": visible,
        "kernels_from": "graph replays" if visible else "eager loop",
        **_kernel_summary(kernels if visible else eager_kernels),
        "eager": {"train_s": eager_s, "trees_per_sec": args.trees / eager_s,
                  "traced_train_s": eager_traced_s,
                  "host_spans_s": eager_spans,
                  "device_busy_s": eager_busy_s,
                  "device_idle_share": 1 - eager_busy_s / eager_traced_s},
        "auc": est.auc(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
