"""Where two tree models of one training part, and what that does to their
AUC: the card's XGBoost against the CPU's, beside the CPU's own
sensitivity.

    python -m h2o3_tpu_torch.tools.tree_parity [--rows 100000]
        [--trees 20] [--card-runs 8] [--cpu-only] [--out PATH]

On ``chip_smoke.py``'s XGBoost parity pair (``datasets.higgs_like`` with
seed 1, xgboost's defaults but for the trees): the CPU model once, the CPU
model again with every weight one float32 ulp under 1 (so every near-tie
is decided by other roundings), and the card model ``--card-runs`` times
(B1's float sums vary from run to run). For every model against the CPU
baseline: the first partings (``divergences``), the exact AUC of the
scores after each iteration and its gap, and the largest score gap
entering the first parting's iteration. The card runs are also held
against each other. Prints one JSON line per model (and writes them to
``--out``).

``divergences``, ``score_gaps`` and ``NEAR_TIE`` are the rules that
``chip_smoke.py`` holds trees by.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

# two decisions of one node differ only as a float near-tie when the gains
# the two sides recorded for their choices agree to this share (the card's
# float32 scans against the CPU's, which accumulate in float64): a gain is a
# difference of fit terms up to ~1000x its size, so float32 rounding moves
# it by up to ~1e-4 of itself, while a wrong candidate loses far more
NEAR_TIE = 1e-3

# a child's weight is at the min_rows (XGBoost's min_child_weight) edge when
# it lies within float32 rounding of the limit: the scans take one child as
# the node's total less the other, so a sum can move by a few ulps of the
# node's weight between two trainings (every weight one ulp under 1 turns a
# one-row child of weight 1 into 0.99999994, which min_rows 1 refuses)
EDGE_ULPS = 4

KW = dict(max_depth=6, learn_rate=0.3, reg_lambda=1.0, min_rows=1.0, seed=42)


def divergences(a, b, boosted=True) -> dict:
    """Where two models of one forest part (the card's and the CPU's): per
    class tree, the first level at which a real node decides otherwise,
    every level before it equal (so the nodes there saw the same rows;
    below it the subtrees differ and are not compared). The lowest such
    node must be a float near-tie: both sides split it, on other
    candidates whose gains agree within NEAR_TIE (relative), or one side
    split it and the other made it a leaf (a gain at the edge of
    min_split_improvement; its gain is reported). Later nodes of that
    level may follow from it (the 2048-node frontier cap passes to the
    next node). Raises on a parting that is no near-tie where the two trees
    were grown on the same targets: every tree of a forest (``boosted``
    false), but only the trees of the first iteration that parts of a
    boosted model. A boosted tree of a later iteration is grown on the
    scores of the earlier trees, which differ once one of them parted (a
    whole leaf's value times the learning rate), so its gains can part by
    more than float rounding without a fault: such partings are counted
    and listed, not held. A parting where both sides split on candidates
    far apart is also no fault when it is at the ``min_rows`` edge: a
    child of either side's chosen split (its weight read from the next
    level's records) lies within EDGE_ULPS float32 ulps of the node's
    weight of the limit, so the candidate one side took can be infeasible
    on the other by rounding alone. It is reported with
    ``at_min_child_weight_edge`` and both sides' child weights."""
    equal, first, held_it = 0, [], None
    fields = ("split_col", "split_bin", "na_left", "is_cat")
    for it, (ga, gb) in enumerate(zip(a.model.output["trees"],
                                      b.model.output["trees"])):
        for k, (ta, tb) in enumerate(zip(ga, gb)):
            la, lb = ta.to_host().levels, tb.to_host().levels
            for li, (x, z, real) in enumerate(zip(la, lb,
                                                  ta.real_level_masks())):
                # a leaf's split fields are its unused best candidate
                split = ~x.leaf_now & ~z.leaf_now
                d = real & ((x.leaf_now != z.leaf_now) | split & np.any(
                    [getattr(x, f) != getattr(z, f) for f in fields],
                    axis=0))
                if not d.any():
                    continue
                node = int(np.nonzero(d)[0][0])
                gx, gz = float(x.gain[node]), float(z.gain[node])
                both = not (x.leaf_now[node] or z.leaf_now[node])
                if held_it is None:
                    held_it = it
                held = not boosted or it == held_it
                first.append({"iteration": it, "class": k, "level": li,
                              "node": int(node), "nodes": int(d.sum()),
                              "both_split": bool(both), "gains": [gx, gz],
                              "held": held})
                if (held and both
                        and abs(gx - gz) > NEAR_TIE * max(abs(gx), abs(gz))):
                    limit = getattr(a.model.params, "min_rows", None)
                    kids = [_child_weights(lv, li, node) for lv in (la, lb)]
                    if not _at_edge(kids, limit, x, z, node):
                        raise AssertionError(f"trees part at a decision that "
                                             f"is no near-tie: {first[-1]}")
                    first[-1].update(at_min_child_weight_edge=True,
                                     child_weights=kids)
                break
            else:
                equal += 1
    n_held = sum(p["held"] for p in first)
    return {"class_trees_equal": equal,
            "class_trees_parting_at_a_near_tie": n_held,
            "class_trees_parting_on_other_scores": len(first) - n_held,
            "partings": first[:8]}


def _child_weights(levels, li: int, node: int) -> list | None:
    """The recorded weights of a split node's two children (the next
    level's ``node_w``), or None where the records have none."""
    if li + 1 >= len(levels):
        return None
    nw = getattr(levels[li + 1], "node_w", None)
    if nw is None:
        return None
    base = int(levels[li].child_base[node])
    return [float(nw[base]), float(nw[base + 1])]


def _at_edge(kids, limit, x, z, node: int) -> bool:
    """Whether a child of either side's split at ``node`` lies within
    EDGE_ULPS float32 ulps of the node's weight of the ``min_rows``
    limit."""
    if limit is None or any(k is None for k in kids):
        return False
    eps = float(np.finfo(np.float32).eps)
    for lv, pair in zip((x, z), kids):
        parent = float(lv.node_w[node]) if lv.node_w is not None else 0.0
        tol = EDGE_ULPS * eps * max(parent, float(limit), 1.0)
        if any(abs(w - float(limit)) <= tol for w in pair):
            return True
    return False


def score_path(m, frame) -> list[torch.Tensor]:
    """A boosted model's raw scores on ``frame``'s rows (binned with the
    model's own edges, on the frame's device) after each iteration count
    0..ntrees, without the init score."""
    from h2o3_tpu_torch.models.tree.binning import bin_frame
    from h2o3_tpu_torch.models.tree.gbm import _init_scores, _replay_group

    o = m.model.output
    bins = bin_frame(o["bin_spec"], frame)
    K = o.get("n_tree_classes", 1)
    F = _init_scores(np.zeros(K) if K > 1 else 0.0, bins.shape[0],
                     bins.device)
    out = [F]
    for group in o["trees"]:
        F = _replay_group(bins, group, F)
        out.append(F)
    return out


def score_gaps(a, b, frame, iterations) -> dict:
    """Per iteration count n, the largest |difference| on ``frame``'s rows
    between two boosted models' raw scores summed over their first n
    iterations (each model binning the frame with its own edges): what
    the trees of iteration n were grown on, apart from the init score."""
    pa, pb = score_path(a, frame), score_path(b, frame)
    return {str(n): float((pa[n].double().cpu()
                           - pb[n].double().cpu()).abs().max())
            for n in sorted(set(iterations))}


def auc_path(m, frame, y: np.ndarray) -> list[float]:
    """The exact AUC of a binomial model's scores after each of its
    iterations."""
    from h2o3_tpu_torch.models import metrics as MM

    return [MM.binomial_metrics(
        y, torch.sigmoid(F.double()).cpu().numpy())._v["auc"]
        for F in score_path(m, frame)[1:]]


def fit(fr, trees: int, **kw):
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator

    est = H2OXGBoostEstimator(ntrees=trees, **KW, **kw)
    est.train(y="label", training_frame=fr)
    return est


def against(m, base, frame, y, base_auc) -> dict:
    """``m`` against ``base``: partings, AUC paths and the score gap
    entering the first parting's iteration."""
    try:
        parts = divergences(m, base)
    except AssertionError as e:
        parts = {"raised": str(e)}
    its = [p["iteration"] for p in parts.get("partings", [])]
    auc = auc_path(m, frame, y)
    gap = [abs(x - z) for x, z in zip(auc, base_auc)]
    return {"auc": auc[-1], "auc_delta": gap[-1],
            "auc_delta_path": gap,
            "first_iteration_auc_delta_over_1e-4": next(
                (i for i, g in enumerate(gap) if g > 1e-4), None),
            "trees": parts,
            "score_gap_entering": score_gaps(m, base, frame, its[:2])}


def main() -> int:
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--cols", type=int, default=28)
    ap.add_argument("--trees", type=int, default=20)
    ap.add_argument("--card-runs", type=int, default=8)
    ap.add_argument("--cpu-only", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not a.cpu_only and not torch.cuda.is_available():
        raise SystemExit("tree_parity needs a CUDA device (or --cpu-only)")
    df = higgs_like(a.rows, a.cols, seed=1)
    y = (df["label"].to_numpy() == "s").astype(np.float64)
    cpu = h2o3_tpu_torch.upload_file(df, device="cpu")
    base = fit(cpu, a.trees)
    base_auc = auc_path(base, cpu, y)
    lines = [{"tool": "tree_parity", "model": "cpu", "rows": a.rows,
              "ntrees": a.trees, **KW, "auc": base_auc[-1]}]
    dfw = df.assign(w=np.float32(np.nextafter(np.float32(1), np.float32(0))))
    wfr = h2o3_tpu_torch.upload_file(dfw, device="cpu")
    lines.append({"model": "cpu_weights_one_ulp_under_1",
                  **against(fit(wfr, a.trees, weights_column="w"), base,
                            cpu, y, base_auc)})
    if not a.cpu_only:
        card = h2o3_tpu_torch.upload_file(df, device="cuda")
        runs = [fit(card, a.trees) for _ in range(a.card_runs)]
        for i, m in enumerate(runs):
            line = {"model": f"card_{i}", "device":
                    torch.cuda.get_device_name(0),
                    **against(m, base, cpu, y, base_auc)}
            if i:
                line["against_card_0"] = against(m, runs[0], cpu, y,
                                                 auc_path(runs[0], cpu, y))
                del line["against_card_0"]["auc_delta_path"]
            lines.append(line)
    out = [json.dumps(x) for x in lines]
    print("\n".join(out), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
