"""Where a GLM's training time goes on the card.

    python -m h2o3_tpu_torch.tools.profile_glm
        [--frame higgs|airlines|covtype] [--family binomial|multinomial|ordinal]
        [--hash-buckets N] [--rows N] [--out PATH]

Uploads the frame and trains a GLM on it:
- the JAX bench's GLM headline (the default): binomial, ``lambda_=1e-4``,
  ``max_iterations=20``, IRLSM on the fused lane, on
  ``datasets.higgs_like`` (response ``label``) or ``--frame airlines``
  (``datasets.airlines_like``, response ``IsDepDelayed``); with
  ``--hash-buckets 64`` the Airlines shape's interaction headline: Origin
  and Dest hashed to 63 columns each, the pairs UniqueCarrier×Distance and
  CRSDepTime×Distance;
- ``--frame covtype --family multinomial``: ``datasets.covtype_like``
  (581,012 rows, 7 classes), ``lambda_`` unset (the Cholesky solve per
  class);
- ``--family ordinal``: ``datasets.ordinal_like`` (1M x 28, 5 ordered
  levels), standardize off, BFGS on the device.

A first training (it captures the ADMM block's CUDA graph), then a warm
one, timed; then a warm training under ``torch.profiler``: the host
seconds of the ``glm.*`` spans (set-up, ``datainfo.transform``, the lambda
path, each chunk, metrics), the device milliseconds in each leaf span (the
row pass, the Gram, the solve — Cholesky and triangular solves, the ADMM's
elementwise steps —, the ordinal BFGS, the transform and the metrics) and
by kernel name, the device-busy seconds and the idle share. Prints one
JSON line (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import bisect
import json
import time

import torch

GLM_KW = dict(family="binomial", lambda_=1e-4, max_iterations=20, seed=1)
# the slice-9 headlines: multinomial GLM at JAX's defaults (lambda_ unset
# means 0), ordinal unstandardized (its coefficients are the frame's
# truth), and the Airlines shape with hashed airports and two interactions
MULTINOMIAL_KW = dict(family="multinomial", seed=1)
ORDINAL_KW = dict(family="ordinal", standardize=False, seed=1)
INTERACTIONS_KW = dict(GLM_KW, hash_buckets=64, interaction_pairs=[
    ("UniqueCarrier", "Distance"), ("CRSDepTime", "Distance")])
LEAVES = ("glm.rowpass", "glm.gram", "glm.solve", "glm.bfgs",
          "glm.lbfgs", "glm.transform", "glm.metrics")
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


def traced(fn, prefix: str = "glm.", leaves=LEAVES) -> dict:
    """One call of ``fn`` under ``torch.profiler``: wall and device-busy
    seconds (every kernel's and copy's time on the card), the idle share,
    the host seconds of the ``prefix`` spans (``glm.*``: the longest of
    each name, and their count), the device ms of the kernels inside each
    leaf span's device twin (the span's range on the card's clock, graph
    replays included; kernels in none go to ``other``), the solve span's
    device ms by kind (Cholesky, triangular solves, the ADMM's elementwise
    work) and the busiest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(fn)
    events = prof.events()
    twins = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events
                   if e.device_type == _CUDA and e.name in leaves)
    starts = [t[0] for t in twins]
    spans, by_leaf, by_kernel, solve_kinds = {}, {}, {}, {}
    busy_us = 0.0
    for e in events:
        if e.name.startswith(prefix):
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


def headline(frame: str, family: str, hash_buckets: int, rows):
    """``(pandas frame, response, estimator kwargs)`` of a run."""
    from h2o3_tpu_torch import datasets

    if family == "ordinal":
        return (datasets.ordinal_like(rows or 1_000_000, seed=0), "rating",
                dict(ORDINAL_KW))
    if family == "multinomial":
        return (datasets.covtype_like(rows or datasets.COVTYPE_ROWS, seed=0),
                "cover_type", dict(MULTINOMIAL_KW))
    kw = dict(INTERACTIONS_KW if hash_buckets else GLM_KW)
    if hash_buckets:
        kw["hash_buckets"] = hash_buckets
    if frame == "airlines":
        return (datasets.airlines_like(rows or 1_000_000, seed=0),
                "IsDepDelayed", kw)
    return datasets.higgs_like(rows or 1_000_000, seed=0), "label", kw


def main() -> int:
    from h2o3_tpu_torch import upload_file
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", choices=("higgs", "airlines", "covtype"),
                    default="higgs")
    ap.add_argument("--family", choices=("binomial", "multinomial",
                                         "ordinal"), default="binomial")
    ap.add_argument("--hash-buckets", type=int, default=0)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_glm needs a CUDA device")
    df, y, kw = headline(a.frame, a.family, a.hash_buckets, a.rows)
    fr, upload_s = timed(lambda: upload_file(df))

    def train():
        est = H2OGeneralizedLinearEstimator(**kw)
        est.train(y=y, training_frame=fr)
        return est

    _, first_s = timed(train)
    est, warm_s = timed(train)
    out = est.model.output
    st = out["irls_stats"]
    steps = sorted(st["admm_steps"])
    classes = len(out["response_domain"] or ()) if a.family == "multinomial" \
        else 1
    line = {
        "tool": "profile_glm", "frame": a.frame, "rows": len(df),
        "design_cols": out["datainfo"].ncols_expanded,
        **{k: v for k, v in kw.items() if k != "interaction_pairs"},
        "interaction_pairs": kw.get("interaction_pairs"),
        "device": torch.cuda.get_device_name(0),
        "upload_s": upload_s, "first_train_s": first_s,
        "warm_train_s": warm_s,
        "iterations": st["iterations"],
        "iterations_per_s": st["iterations"] / warm_s,
        "class_passes_per_s": st["iterations"] * classes / warm_s
        if a.family == "multinomial" else None,
        "chunks": st["chunks"], "host_reads": st["host_reads"],
        "masked_iterations": st["masked_iterations"],
        "fallbacks": st["fallbacks"],
        "admm_steps": {"min": steps[0], "median": steps[len(steps) // 2],
                       "max": steps[-1]} if steps else None,
        "bfgs": st.get("bfgs"),
        "metric": (est.model.training_metrics.logloss
                   if out["response_domain"] else None),
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
