"""Repeated trainings of the multinomial headline on the card: how far
their loglosses spread, and where each run's trees first differ from the
first run's.

    python -m h2o3_tpu_torch.tools.repeat_multinomial [--runs 12]

Uploads the Covertype-shaped frame (``datasets.covtype_like``, 581,012 x
54, 7 classes) once and trains the multinomial headline GBM (20 iterations,
depth 6, lr 0.1, min_rows 10, seed 42) ``--runs`` times, alternating the
graph path and the eager control (``H2O3_TPU_WHOLE_TREE`` 1 and 0). Per
run one JSON line: the path, the training logloss, the scoring history,
and the first split (iteration, class, level, node) whose column, bin or
leaf flag differs from run 1's, with both runs' column, bin, cover and
gain there. B1 adds float32 sums in a different order each run, so two
candidates whose gains agree to within that rounding may swap.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

import h2o3_tpu_torch
from h2o3_tpu_torch.datasets import covtype_like
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

KW = dict(ntrees=20, max_depth=6, learn_rate=0.1, min_rows=10.0, seed=42)
FIELDS = ("split_col", "split_bin", "leaf_now", "node_w", "gain")


def _records(model) -> list:
    return [[[{f: getattr(lv, f) for f in FIELDS} for lv in t.to_host().levels]
             for t in group] for group in model.output["trees"]]


def _first_difference(ref, got) -> dict | None:
    for it, (rg, gg) in enumerate(zip(ref, got)):
        for k, (rt, gt) in enumerate(zip(rg, gg)):
            for li, (a, b) in enumerate(zip(rt, gt)):
                diff = ((a["split_col"] != b["split_col"])
                        | (a["split_bin"] != b["split_bin"])) & ~a["leaf_now"]
                diff |= a["leaf_now"] != b["leaf_now"]
                if diff.any():
                    node = int(np.nonzero(diff)[0][0])

                    def at(r):
                        return {f: r[f][node].item() for f in FIELDS}

                    return {"iteration": it, "class": k, "level": li,
                            "node": node, "first_run": at(a), "this_run": at(b)}
    return None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("repeat_multinomial needs a CUDA card")
    fr = h2o3_tpu_torch.upload_file(covtype_like(581_012, seed=0))
    knob = os.environ.get("H2O3_TPU_WHOLE_TREE")
    ref = None
    for i in range(args.runs):
        mode = "1" if i % 2 == 0 else "0"
        os.environ["H2O3_TPU_WHOLE_TREE"] = mode
        est = H2OGradientBoostingEstimator(**KW)
        est.train(y="cover_type", training_frame=fr)
        recs = _records(est.model)
        ref = recs if ref is None else ref
        print(json.dumps({
            "run": i, "path": "graph" if mode == "1" else "eager",
            "logloss": est.model.training_metrics.logloss,
            "history": [h["training_logloss"]
                        for h in est.model.scoring_history],
            "first_difference": _first_difference(ref, recs),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    if knob is None:
        os.environ.pop("H2O3_TPU_WHOLE_TREE")
    else:
        os.environ["H2O3_TPU_WHOLE_TREE"] = knob
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
