"""Where a tree model's training time goes on the card.

    python -m h2o3_tpu_torch.tools.profile_gbm [--algo gbm|drf] [--rows N]
        [--trees T] [--sample-rate R] [--col-sample-rate R]
        [--col-sample-rate-per-tree R]

Uploads the Higgs-like frame and trains, on the default whole-tree path,
the headline GBM (20 trees, depth 6, lr 0.1, min_rows 10, seed 42,
score_tree_interval 5) or, with ``--algo drf``, the DRF headline (H2O's
DRF defaults: 50 trees of depth 20, min_rows 1, mtries sqrt(C), sample_rate
0.632; seed 42, score_tree_interval 5), with the sampling rates given
(GBM's default to 1, DRF's bootstrap to 0.632): a first training (it
builds the kernels if needed and captures the tree's CUDA graphs: capture
seconds, graph pool and state bytes, and whether the graph cache kept
them after the training), then a warm one, timed. Then, apart: the host
phases with ``torch.cuda.synchronize()`` around each (binning, one
device-stats training-metrics call, times the calls a training makes), a
warm training under ``torch.profiler`` for the device-busy time, the idle
share, the device time of every kernel by name and the host seconds of
the model's ``gbm.*`` / ``drf.*`` spans (setup, binning, whole-tree setup,
chunk builds, record pulls, scoring, final metrics), and a warm training
of the eager per-level loop (``H2O3_TPU_WHOLE_TREE=0``) in the same
process. Kernels inside graph replays are read from the graph path's
trace when the profiler reports them there (``graph_kernels_visible``);
otherwise the per-kernel times come from a traced eager training
(``kernels_from``). Device time is also split by level width
(``by_width``: levels of up to 1024 nodes, ``tree.narrow``, and of
1025-2048, ``tree.wide``, the host spans the tree builder puts around the
launches of each width): each span's device time (``width_span_device_ms``,
the spans' device twins, graph replays included) and, by kernel, the
device events inside each twin's range on the card's clock. Prints one
JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import json
import math
import os
import time

import torch

from h2o3_tpu_torch import upload_file
from h2o3_tpu_torch.datasets import higgs_like
from h2o3_tpu_torch.estimators import (
    H2OGradientBoostingEstimator,
    H2ORandomForestEstimator,
)
from h2o3_tpu_torch.models.tree import drf as drf_mod
from h2o3_tpu_torch.models.tree import gbm as gbm_mod
from h2o3_tpu_torch.models.tree import shared_tree
from h2o3_tpu_torch.models.tree.binning import bin_frame, fit_bins

_WIDTHS = ("tree.narrow", "tree.wide")


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _by_width(events) -> dict:
    """``{width span: {kernel: [device ms, calls]}}``: each device event
    assigned to the width span whose device twin (the span's range on the
    card's clock, covering what was launched inside it, graph replays
    included) contains its start."""
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in events if e.name in _WIDTHS
                    and e.device_type == torch.autograd.DeviceType.CUDA)
    starts = [r[0] for r in ranges]
    out = {w: {} for w in _WIDTHS}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name in _WIDTHS or e.name.startswith(("gbm.", "drf."))):
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0 or e.time_range.start >= ranges[i][1]:
            continue
        v = out[ranges[i][2]].setdefault(e.name[:90], [0.0, 0])
        v[0] += (e.time_range.end - e.time_range.start) / 1e3
        v[1] += 1
    return out


def _profiled(fn, prefix: str) -> tuple[dict, dict, float, dict, dict]:
    """``{kernel name: [device ms, calls]}`` of one traced call, the host
    seconds of the model's ``{prefix}.*`` spans (``record_function`` in
    ``models/tree/gbm.py``; a span that waits on the card includes the
    wait), the call's wall seconds, the kernels in each width span
    (:func:`_by_width`), and each width span's device milliseconds."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = _timed(fn)
    kernels, spans, span_ms = {}, {}, {}
    for evt in prof.key_averages():
        if evt.key in _WIDTHS:
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                span_ms[evt.key] = evt.device_time_total / 1e3
            continue
        if evt.key.startswith(prefix + "."):  # the host entry, not its twin
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
    return kernels, spans, wall, _by_width(prof.events()), span_ms


def _kernel_summary(kernels: dict) -> dict:
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    # kernel B1 is four kernels (b1_*) per launch; one b1_hist_tile each
    b1 = [v for k, v in kernels.items() if "b1_" in k]
    # kernel B2 (split_kernel<false>), one kernel per launch
    split = [v for k, v in kernels.items() if "split_kernel" in k]
    return {
        "kernels_ms": [{"name": k, "ms": v[0], "calls": v[1]} for k, v in top],
        "device_ms": sum(v[0] for v in kernels.values()),
        "b1_ms": sum(v[0] for v in b1),
        "b1_launches": sum(v[1] for k, v in kernels.items()
                           if "b1_hist_tile" in k),
        "split_ms": sum(v[0] for v in split),
        "split_launches": sum(v[1] for v in split),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", choices=("gbm", "drf"), default="gbm")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--trees", type=int, default=None,
                    help="default: 20 (gbm), 50 (drf)")
    ap.add_argument("--sample-rate", type=float, default=None)
    ap.add_argument("--col-sample-rate", type=float, default=None,
                    help="gbm only (DRF's per-split rate comes from mtries)")
    ap.add_argument("--col-sample-rate-per-tree", type=float, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gbm needs a CUDA card")
    drf = args.algo == "drf"
    trees = args.trees or (50 if drf else 20)
    if drf:
        est_cls = H2ORandomForestEstimator
        kw = dict(ntrees=trees, max_depth=20, min_rows=1.0, mtries=-1,
                  sample_rate=0.632, seed=42, score_tree_interval=5)
    else:
        est_cls = H2OGradientBoostingEstimator
        kw = dict(ntrees=trees, max_depth=6, learn_rate=0.1, min_rows=10.0,
                  seed=42, score_tree_interval=5)
    for name in ("sample_rate", "col_sample_rate",
                 "col_sample_rate_per_tree"):
        if getattr(args, name) is not None:
            if drf and name == "col_sample_rate":
                raise SystemExit("DRF draws its per-split columns by mtries")
            kw[name] = getattr(args, name)
    df = higgs_like(args.rows)
    fr, upload_s = _timed(lambda: upload_file(df))
    feats = [c for c in fr.names if c != "label"]

    def train():
        est = est_cls(**kw)
        est.train(y="label", training_frame=fr)
        return est

    knob = os.environ.get("H2O3_TPU_WHOLE_TREE")
    os.environ["H2O3_TPU_WHOLE_TREE"] = "1"
    _, first_s = _timed(train)  # builds the kernels, captures the graphs
    # the capture's sizes, and whether the cache kept the plan (it keeps
    # the latest plans within a share of the card's memory)
    graphs = dict(shared_tree.GRAPH_EVENTS["last_capture"], cached=any(
        (g["rows"], g["depth"]) == (args.rows, kw["max_depth"])
        for g in shared_tree.graph_stats()),
        cache_budget_bytes=shared_tree._GRAPH_CACHE_SHARE
        * torch.cuda.get_device_properties(0).total_memory)
    est, train_s = _timed(train)
    spec, fit_s = _timed(lambda: fit_bins(fr, feats, seed=42))
    bins, bin_s = _timed(lambda: bin_frame(spec, fr))
    F = torch.randn(args.rows, device=bins.device)
    y = (torch.arange(args.rows, device=bins.device) % 2).float()
    w = torch.ones(args.rows, device=bins.device)
    if drf:
        metrics_fn = lambda: drf_mod._metrics_from_F(  # noqa: E731
            F.abs(), y, w, trees, True, ("b", "s"))
    else:
        metrics_fn = lambda: gbm_mod._metrics_from_F(  # noqa: E731
            "bernoulli", F, y, w, ("b", "s"))
    _, metrics_s = _timed(metrics_fn)
    metric_calls = math.ceil(trees / kw["score_tree_interval"]) + 1

    kernels, spans, traced_s, widths, span_ms = _profiled(train, args.algo)
    busy_s = sum(v[0] for v in kernels.values()) / 1e3
    visible = any("b1_hist_tile" in k for k in kernels)
    os.environ["H2O3_TPU_WHOLE_TREE"] = "0"
    train()  # the eager loop's warm-up
    _, eager_s = _timed(train)
    (eager_kernels, eager_spans, eager_traced_s, eager_widths,
     eager_span_ms) = _profiled(train, args.algo)
    if knob is None:
        os.environ.pop("H2O3_TPU_WHOLE_TREE")
    else:
        os.environ["H2O3_TPU_WHOLE_TREE"] = knob
    eager_busy_s = sum(v[0] for v in eager_kernels.values()) / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "algo": args.algo,
        "rows": args.rows, **kw,
        "upload_s": upload_s, "first_train_s": first_s,
        "train_s": train_s, "trees_per_sec": trees / train_s,
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
        "by_width": {w: _kernel_summary(widths[w]) for w in _WIDTHS},
        "width_span_device_ms": span_ms,
        "eager": {"train_s": eager_s, "trees_per_sec": trees / eager_s,
                  "traced_train_s": eager_traced_s,
                  "host_spans_s": eager_spans,
                  "device_busy_s": eager_busy_s,
                  "device_idle_share": 1 - eager_busy_s / eager_traced_s,
                  "width_span_device_ms": eager_span_ms,
                  "by_width": {w: _kernel_summary(eager_widths[w])
                               for w in _WIDTHS}},
        "auc": est.auc(),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
