"""Where an AutoML run's time goes on the card.

    python -m h2o3_tpu_torch.tools.profile_automl [--frame higgs|santander]
        [--rows N] [--nfolds K] [--out PATH]

Makes the frame on the card and runs AutoML on it twice in one process:
cold (kernels loaded, graphs captured) and warm, then a third, warm run
under ``torch.profiler``. The default is the JAX bench's AutoML
(``bench.py::_bench_automl``: the first 50,000 rows of
``datasets.higgs_like(1_000_000)``, ``max_models=3``, ``nfolds=0``,
``seed=11``, GBM and GLM); ``--frame santander`` runs on
``datasets.santander_like`` (200,000 x 200 by default) with JAX's default
plan. For each run and step: host seconds, models built, graph captures
(whole-tree plans, ADMM blocks, DeepLearning plans), kernel launches and
host syncs (:class:`HostReads`); for the traced run: each step's device
milliseconds (the kernels that started on the card while its
``automl.step.<name>`` host span was open) and idle share, the
device-busy seconds, the run's idle share and the busiest kernels. Prints one JSON line (and writes it to ``--out``). A
Santander run at 5 folds makes millions of kernel events, more than the
profiler digests in minutes: profile it with fewer folds (``--nfolds 0``
leaves out the ensembles, which need holdout predictions).
"""

from __future__ import annotations

import argparse
import bisect
import json
import time
import warnings

import torch

from h2o3_tpu_torch.tools.profile_glm import timed

# the JAX bench's AutoML (bench.py::_bench_automl), and the full plan at
# 5 folds on the Santander-shaped frame
BENCH = dict(max_models=3, nfolds=0, seed=11, max_runtime_secs=900,
             include_algos=["GBM", "GLM"])
SANTANDER = dict(max_models=10, nfolds=5, seed=1, max_runtime_secs=900)
_SYNC_MESSAGE = "called a synchronizing CUDA operation"


class HostReads:
    """Counts the card's synchronizing operations (a copy to the host, an
    ``.item()``, a ``nonzero``, a blocking copy from pageable host memory:
    each waits for the card) inside the block,
    with the ``perf_counter`` time of each, by running it under
    ``torch.cuda.set_sync_debug_mode("warn")`` and catching the warnings
    that mode raises. ``in_span(t0, t1)`` counts those between two times
    (an AutoML ``step_log`` row's)."""

    def __enter__(self):
        self.times: list[float] = []
        self._mode = torch.cuda.get_sync_debug_mode()
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.filterwarnings("always", message=f".*{_SYNC_MESSAGE}.*")
        show = warnings.showwarning

        def count(message, category, filename, lineno, file=None, line=None):
            if _SYNC_MESSAGE in str(message):
                self.times.append(time.perf_counter())
            else:
                show(message, category, filename, lineno, file, line)

        warnings.showwarning = count
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self._mode)
        self._ctx.__exit__(*exc)
        return False

    def in_span(self, t0: float, t1: float) -> int:
        return sum(1 for t in self.times if t0 <= t <= t1)


_CUDA = torch.autograd.DeviceType.CUDA
# the host spans of the port's builders: their device twins are ranges,
# not work on the card
_SPANS = ("automl.", "grid.", "tree.", "gbm.", "drf.", "glm.", "dl.",
          "xgboost.", "xrt.", "stackedensemble.")


def traced_steps(fn) -> dict:
    """One call of ``fn`` (an AutoML run) under ``torch.profiler``: wall
    and device-busy seconds (every kernel's and copy's time on the card),
    the idle share, and for each ``automl.step.<name>`` host span its host
    seconds, the device ms of the kernels that started inside it and its
    idle share; the busiest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, wall = timed(fn)
    events = prof.events()
    steps = sorted((e.time_range.start, e.time_range.end,
                    e.name[len("automl.step."):]) for e in events
                   if e.device_type != _CUDA
                   and e.name.startswith("automl.step."))
    starts = [t[0] for t in steps]
    busy_us, by_step, by_kernel = 0.0, {}, {}
    for e in events:
        if (e.device_type != _CUDA or e.name.startswith(_SPANS)
                or getattr(e, "is_user_annotation", False)):
            continue
        dur = e.time_range.end - e.time_range.start
        busy_us += dur
        k = by_kernel.setdefault(e.name[:90], [0.0, 0])
        k[0] += dur / 1e3
        k[1] += 1
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        name = (steps[i][2] if i >= 0 and e.time_range.start < steps[i][1]
                else "outside")
        by_step[name] = by_step.get(name, 0.0) + dur / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    host = {name: (t1 - t0) / 1e6 for t0, t1, name in steps}
    return {
        "traced_wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "steps": {name: {"host_s": host[name],
                         "device_ms": by_step.get(name, 0.0),
                         "idle_share": 1 - by_step.get(name, 0.0) / 1e3
                         / host[name] if host[name] else None}
                  for name in host},
        "device_ms_outside_steps": by_step.get("outside", 0.0),
        "top_kernels_ms": [{"name": k, "ms": v[0], "calls": v[1]}
                           for k, v in top],
    }


def frame_for(name: str, rows: int | None):
    """``(pandas frame, response)``: the bench's Higgs-like cut (the first
    50,000 rows of the 1M-row draw: a 50,000-row draw is another sequence)
    or the Santander-shaped frame."""
    from h2o3_tpu_torch import datasets

    if name == "santander":
        df = datasets.santander_like(rows or datasets.SANTANDER_ROWS)
        return df, "target"
    return (datasets.higgs_like(1_000_000).iloc[: rows or 50_000]
            .reset_index(drop=True), "label")


def steps_table(aml, reads: HostReads | None = None) -> list[dict]:
    """One row per executed step of ``aml``: seconds, models, captures,
    launches by kernel wrapper, and host syncs when counted."""
    out = []
    for r in aml.step_log:
        c = r["counters"]
        row = {"step": r["step"], "seconds": r["seconds"],
               "models": r["models"],
               "captures": {k: c[k] for k in ("tree_graphs", "admm_blocks",
                                              "dl_plans")},
               "launches": {k: v for k, v in c.items() if k.endswith("_cuda")}}
        if reads is not None:
            row["host_syncs"] = reads.in_span(r["t0"], r["t1"])
        out.append(row)
    return out


def main() -> int:
    import h2o3_tpu_torch
    from h2o3_tpu_torch.automl import AutoML

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", choices=("higgs", "santander"),
                    default="higgs")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--nfolds", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_automl needs a CUDA device")
    kw = dict(SANTANDER if a.frame == "santander" else BENCH)
    if a.nfolds is not None:
        kw["nfolds"] = a.nfolds
    df, y = frame_for(a.frame, a.rows)
    fr, upload_s = timed(lambda: h2o3_tpu_torch.upload_file(df))
    runs = {}

    def run():
        aml = AutoML(**kw)
        aml.train(y=y, training_frame=fr)
        return aml

    for name in ("cold", "warm"):
        with HostReads() as reads:
            aml, secs = timed(run)
        runs[name] = {"seconds": secs, "steps": steps_table(aml, reads),
                      "host_syncs": len(reads.times),
                      "leaderboard": [[r["model_id"], r.get("auc"),
                                       r.get("logloss")]
                                      for r in aml.leaderboard.as_table()]}
    line = {
        "tool": "profile_automl", "frame": a.frame, "rows": fr.nrow,
        "cols": fr.ncol, "automl": {k: v for k, v in kw.items()},
        "device": torch.cuda.get_device_name(0), "upload_s": upload_s,
        **runs,
        "warm_traced": traced_steps(run),
    }
    text = json.dumps(line)
    print(text, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
