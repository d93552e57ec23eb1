"""Where a GLM's training time goes on the card.

    python -m h2o3_tpu_torch.tools.profile_glm [--frame higgs|airlines]
        [--rows N] [--out PATH]

Uploads the frame (``datasets.higgs_like``, response ``label``, or
``datasets.airlines_like``, response ``IsDepDelayed``) and trains the JAX
bench's GLM headline on it (binomial, ``lambda_=1e-4``,
``max_iterations=20``, IRLSM on the fused lane): a first training (it
captures the ADMM block's CUDA graph), then a warm one, timed; then a warm
training under ``torch.profiler``: the host seconds of the ``glm.*`` spans
(set-up, ``datainfo.transform``, the lambda path, each chunk, metrics), the
device milliseconds in each leaf span (the row pass, the Gram, the solve —
Cholesky and triangular solves, the ADMM's elementwise steps — the
transform and the metrics) and by kernel name, the device-busy seconds and
the idle share. Prints one JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import time

import torch

GLM_KW = dict(family="binomial", lambda_=1e-4, max_iterations=20, seed=1)
LEAVES = ("glm.rowpass", "glm.gram", "glm.solve", "glm.transform",
          "glm.metrics")
_CUDA = torch.autograd.DeviceType.CUDA


def _solve_kind(name: str) -> str:
    """A kernel of the solve span by kind: the Cholesky factorization,
    the triangular solves, or the ADMM's elementwise and reduction work."""
    low = name.lower()
    if "potrf" in low or "chol" in low:
        return "cholesky"
    if "trsv" in low or "trsm" in low:
        return "triangular_solves"
    return "elementwise_and_reductions"


def timed(fn):
    """``(fn(), seconds)`` with the card synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def traced(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall and device-busy
    seconds (every kernel's and copy's time on the card), the idle share,
    the host seconds of the ``glm.*`` spans (the longest of each name, and
    their count), the device ms of the kernels inside each leaf span's
    device twin (the span's range on the card's clock, graph replays
    included; kernels in none go to ``other``), the solve span's device ms
    by kind (Cholesky, triangular solves, the ADMM's elementwise work) and
    the busiest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(fn)
    events = prof.events()
    twins = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == _CUDA and e.name in LEAVES)
    starts = [t[0] for t in twins]
    spans, by_leaf, by_kernel, solve_kinds = {}, {}, {}, {}
    busy_us = 0.0
    for e in events:
        if e.name.startswith("glm."):
            if e.device_type != _CUDA:
                s = spans.setdefault(e.name, [0.0, 0, 0.0])
                dt = (e.time_range.end - e.time_range.start) / 1e6
                s[0] = max(s[0], dt)
                s[1] += 1
                s[2] += dt
            continue
        if e.device_type != _CUDA:
            continue
        dur = e.time_range.end - e.time_range.start
        busy_us += dur
        k = by_kernel.setdefault(e.name[:90], [0.0, 0])
        k[0] += dur / 1e3
        k[1] += 1
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        leaf = "other"
        # the innermost twin holding the kernel's start: scan back over
        # the twins that start before it
        while i >= 0:
            if e.time_range.start < twins[i][1]:
                leaf = twins[i][2]
                break
            i -= 1
        by_leaf[leaf] = by_leaf.get(leaf, 0.0) + dur / 1e3
        if leaf == "glm.solve":
            kind = _solve_kind(e.name)
            solve_kinds[kind] = solve_kinds.get(kind, 0.0) + dur / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    return {
        "traced_wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "host_spans_s": {k: {"longest": v[0], "count": v[1], "total": v[2]}
                         for k, v in sorted(spans.items())},
        "device_ms_by_span": dict(sorted(by_leaf.items(),
                                         key=lambda kv: -kv[1])),
        "solve_device_ms_by_kind": solve_kinds,
        "top_kernels_ms": [{"name": k, "ms": v[0], "calls": v[1]}
                           for k, v in top],
    }


def main() -> int:
    from h2o3_tpu_torch import upload_file
    from h2o3_tpu_torch.datasets import airlines_like, higgs_like
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", choices=("higgs", "airlines"), default="higgs")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_glm needs a CUDA device")
    if a.frame == "higgs":
        df, y = higgs_like(a.rows, seed=0), "label"
    else:
        df, y = airlines_like(a.rows, seed=0), "IsDepDelayed"
    fr, upload_s = timed(lambda: upload_file(df))

    def train():
        est = H2OGeneralizedLinearEstimator(**GLM_KW)
        est.train(y=y, training_frame=fr)
        return est

    _, first_s = timed(train)
    est, warm_s = timed(train)
    st = est.model.output["irls_stats"]
    steps = sorted(st["admm_steps"])
    line = {
        "tool": "profile_glm", "frame": a.frame, "rows": a.rows,
        "design_cols": est.model.output["datainfo"].ncols_expanded,
        **GLM_KW, "device": torch.cuda.get_device_name(0),
        "upload_s": upload_s, "first_train_s": first_s,
        "warm_train_s": warm_s,
        "iterations": st["iterations"],
        "iterations_per_s": st["iterations"] / warm_s,
        "chunks": st["chunks"], "host_reads": st["host_reads"],
        "masked_iterations": st["masked_iterations"],
        "fallbacks": st["fallbacks"],
        "admm_steps": {"min": steps[0], "median": steps[len(steps) // 2],
                       "max": steps[-1]} if steps else None,
        "auc": est.auc(),
        "warm_traced": traced(train),
    }
    text = json.dumps(line)
    print(text, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
