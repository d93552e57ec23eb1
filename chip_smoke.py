"""Smoke run of the PyTorch/CUDA port (``h2o3_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
final line):

1. build   — compile every kernel of the main path (csrc/*.cu, one nvcc per
             source, in parallel) into the ignored build directory;
2. kernels — each kernel against its plain PyTorch version on the card at the
             main path's shapes (1M rows x 28 columns, 256 bins, 3 stat
             lanes, 1/8/32 nodes, plus an integer-stat shape that must match
             exactly), with its time, the plain version's time, one PyTorch
             library call's time where one computes the same function, and
             the least time the card could take (bound);
3. main    — the headline GBM through the user entry points at full width:
             upload_file -> H2OGradientBoostingEstimator(20 trees, depth 6,
             lr 0.1, min_rows 10, seed 42).train -> predict -> AUC on a
             1M x 28 Higgs-like frame; launch counts are zeroed just before
             and read just after, and must match the levels built;
4. parity  — the same GBM at 100k rows on the card and on the CPU (plain
             versions): AUC within 1e-3 and tree 0's split columns equal;
5. the ``kernels`` line, the card's name and power limit, and the result.

It imports nothing of JAX or of the JAX package. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

N_ROWS, N_COLS, N_BINS, N_STATS = 1_000_000, 28, 256, 3
GBM_KW = dict(ntrees=20, max_depth=6, learn_rate=0.1, min_rows=10.0, seed=42)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def hist_inputs(n, C, N, seed, integer=False):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, N_BINS, (n, C)).astype(np.uint8)  # bin 0 = NA
    nid = rng.integers(0, N, n).astype(np.int32)
    nid[rng.random(n) < 0.1] = -1  # retired rows
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


def candidate_gains(hist, tot, min_rows):
    """Every candidate's gain (N, C, B-2), plain PyTorch — to tell a float
    near-tie from a wrong decision."""
    from h2o3_tpu_torch.ops.split_cuda import _fit, _gain_with_na

    na, data = hist[:, :, 0, :], hist[:, :, 1:, :]
    cum = torch.cumsum(data, dim=2)
    left = cum[:, :, :-1, :]
    right = cum[:, :, -1:, :] - left
    pf = _fit(tot)
    return torch.maximum(
        _gain_with_na(pf, left + na[:, :, None, :], right, min_rows),
        _gain_with_na(pf, left, right + na[:, :, None, :], min_rows))


def gain_scale(hist, tot):
    """(N, C) bound on the fit terms a gain cancels: |fit(parent)| plus the
    per-bin sum of wy²/w, at least 1."""
    w, wy = hist[..., 0], hist[..., 1]
    per_bin = torch.where(w > 0, wy * wy / w.clamp(min=1e-30), 0.0).sum(dim=2)
    pf = torch.where(tot[:, 0] > 0, tot[:, 1] ** 2 / tot[:, 0].clamp(min=1e-30),
                     0.0)
    return (per_bin + pf[:, None]).clamp(min=1.0)


def phase_build() -> dict:
    from h2o3_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all(("hist", "split"))
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "kernels": ["hist", "split"]}
    for name, log in cuda_build.BUILD_LOG.items():
        out[f"ptxas_{name}"] = [ln.strip() for ln in log.splitlines()
                                if "Used" in ln or "spill" in ln]
    return out


def phase_kernels() -> tuple[dict, dict]:
    """Kernels against their plain versions; returns (phase line, per-kernel
    measurements for the kernels line)."""
    from h2o3_tpu_torch.ops.hist_cuda import hist_cuda, hist_plain
    from h2o3_tpu_torch.ops.histogram import node_totals
    from h2o3_tpu_torch.ops.split_cuda import (
        split_candidates_cuda,
        split_candidates_plain,
    )

    n, C, B, S = N_ROWS, N_COLS, N_BINS, N_STATS
    rows = []
    meas = {}
    for N in (1, 8, 32):
        bins, nid, stats = hist_inputs(n, C, N, seed=N)
        got = hist_cuda(bins, nid, stats, N, B)
        ref = hist_plain(bins, nid, stats, N, B)
        # float32 sums in any order stay within a few ulp of the cell's
        # absolute mass: both versions are held to 1e-5 of it against an
        # exact float64 sum (the float64 plain version)
        ref64 = hist_plain(bins, nid, stats.double(), N, B)
        mass = hist_plain(bins, nid, stats.double().abs(), N, B).clamp(min=1.0)
        rel = ((got.double() - ref64).abs() / mass).max().item()
        rel_plain = ((ref.double() - ref64).abs() / mass).max().item()
        if not (rel < 1e-5 and rel_plain < 1e-5):
            raise AssertionError(f"hist N={N}: err/mass {rel:.3e} (kernel), "
                                 f"{rel_plain:.3e} (plain) vs float64")
        del ref64, mass
        ms = time_ms(lambda: hist_cuda(bins, nid, stats, N, B), reps=20)
        plain_ms = time_ms(lambda: hist_plain(bins, nid, stats, N, B), reps=3,
                           warmup=1)
        # yardstick: ONE index_add_ over flattened (node·B + bin)·C + col
        keep = nid >= 0
        idx = ((nid[keep].long()[:, None] * B + bins[keep].long()) * C
               + torch.arange(C, device=bins.device)).reshape(-1)
        src = stats[keep].repeat_interleave(C, dim=0)
        lib_out = torch.zeros(N * B * C, S, device=bins.device)
        lib_ms = time_ms(lambda: lib_out.index_add_(0, idx, src), reps=5,
                         warmup=1)
        del idx, src, lib_out
        bnd, by = bound_ms(n * C + 4 * n + 4 * n * S + 4 * N * C * B * S,
                           n * C * S)
        rows.append({"kernel": "hist", "nodes": N, "err_over_mass": rel,
                     "plain_err_over_mass": rel_plain,
                     "max_abs_err": (got - ref).abs().max().item(), "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": bnd, "bound_by": by})

        # B2 on the kernel's histogram, at the main path's node counts
        tot = node_totals(got).contiguous()
        gk = split_candidates_cuda(got, tot, 10.0)
        gp = split_candidates_plain(got, tot, 10.0)
        # the two prefix sums associate differently; a gain's rounding is
        # bounded by the fit terms it cancels, themselves bounded by the
        # per-bin sum of wy²/w (Cauchy-Schwarz): hold gains to 1e-5 of it
        scale = gain_scale(got, tot)
        feasible = gp[0] > -1e29
        gerr = torch.where(feasible, (gk[0] - gp[0]).abs() / scale, 0.0)
        gerr = gerr.max().item()
        if not (gerr < 1e-5 and torch.equal(feasible, gk[0] > -1e29)):
            raise AssertionError(f"split N={N}: gain err/scale {gerr:.3e}")
        # decisions: equal, or a float near-tie — the kernel's candidate
        # scores within the gain tolerance of the plain best
        diff = (gk[1] != gp[1]) | (gk[2] != gp[2])
        n_diff = int(diff.sum())
        if n_diff:
            allg = candidate_gains(got, tot, 10.0)
            at_k = allg.gather(2, gk[1].long()[..., None]).squeeze(2)
            slack = 1e-5 * scale
            if bool(((gp[0] - at_k > slack) & diff).any()):
                raise AssertionError(f"split N={N}: {n_diff} decisions differ")
        s_ms = time_ms(lambda: split_candidates_cuda(got, tot, 10.0), reps=50)
        s_plain = time_ms(lambda: split_candidates_plain(got, tot, 10.0),
                          reps=5, warmup=1)
        sb, sby = bound_ms(4 * N * C * B * 3 + 4 * N * 3
                           + N * C * (4 + 4 + 1 + 24), 24 * N * C * (B - 2))
        rows.append({"kernel": "split", "nodes": N, "err_over_scale": gerr,
                     "max_abs_err": (gk[0] - gp[0]).abs().max().item(),
                     "decisions_differing_as_near_ties": n_diff, "ms": s_ms,
                     "plain_ms": s_plain, "library_ms": None, "bound_ms": sb,
                     "bound_by": sby})
        if N == 8:
            meas["hist"] = rows[-2]
        if N == 32:
            meas["split"] = rows[-1]

    # integer stats: every order of summation is exact -> bit-equal
    bins, nid, stats = hist_inputs(n, C, 8, seed=99, integer=True)
    got = hist_cuda(bins, nid, stats, 8, B)
    ref = hist_plain(bins, nid, stats, 8, B)
    if not torch.equal(got, ref):
        raise AssertionError("hist: integer-stat histogram not bit-equal")
    tot = node_totals(got).contiguous()
    for a, b in zip(split_candidates_cuda(got, tot, 10.0),
                    split_candidates_plain(got, tot, 10.0)):
        if not torch.equal(a, b):
            raise AssertionError("split: integer-stat decisions not bit-equal")
    return {"phase": "kernels", "rows": rows, "integer_exact": True}, meas


def split_nodes(tree) -> list:
    """(level, node, split column) of every real split node."""
    out = []
    host = tree.to_host()
    for li, (lv, m) in enumerate(zip(host.levels, tree.real_level_masks())):
        for node in np.nonzero(~lv.leaf_now & m)[0]:
            out.append((li, int(node), int(lv.split_col[node])))
    return out


def train(df, device):
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    fr = h2o3_tpu_torch.upload_file(df, device=device)
    est = H2OGradientBoostingEstimator(**GBM_KW)
    t0 = time.perf_counter()
    est.train(y="label", training_frame=fr)
    if device == "cuda":
        torch.cuda.synchronize()
    return est, fr, time.perf_counter() - t0


def phase_main() -> dict:
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.models import metrics as MM
    from h2o3_tpu_torch.ops.hist_cuda import hist_cuda
    from h2o3_tpu_torch.ops.split_cuda import split_candidates_cuda

    df = higgs_like(N_ROWS, N_COLS, seed=0)
    hist_cuda.launches = 0
    split_candidates_cuda.launches = 0
    est, fr, seconds = train(df, "cuda")
    pred = est.predict(fr)
    p1 = pred.vec("s").data
    torch.cuda.synchronize()
    launches = {"hist": hist_cuda.launches,
                "split": split_candidates_cuda.launches}
    trees = [g[0] for g in est.model.output["trees"]]
    # per tree: a histogram and a split scan at every level but the last,
    # whose leaves come from the parents' child stats
    levels = sum(len(t.levels) - 1 for t in trees)
    if not (launches["hist"] == launches["split"] == levels > 0):
        raise AssertionError(f"launches {launches} vs {levels} split levels")
    if p1.shape != (N_ROWS,) or not bool(torch.isfinite(p1).all()):
        raise AssertionError("predictions not finite or of the wrong shape")
    y = (df["label"].to_numpy() == "s").astype(np.float64)
    auc_pred = MM.binomial_metrics(y, p1)._v["auc"]
    auc = est.auc()
    if not (abs(auc_pred - auc) < 1e-4 and auc > 0.75):
        raise AssertionError(f"auc {auc} vs replayed {auc_pred}")
    return {"phase": "main", "rows": N_ROWS, "cols": N_COLS, **GBM_KW,
            "train_seconds": seconds, "trees_per_sec": GBM_KW["ntrees"] / seconds,
            "auc": auc, "auc_from_predict": auc_pred, "levels": levels,
            "launches": launches}


def phase_parity() -> dict:
    from h2o3_tpu_torch.datasets import higgs_like

    df = higgs_like(100_000, N_COLS, seed=1)
    g, _, g_s = train(df, "cuda")
    c, _, c_s = train(df, "cpu")
    dauc = abs(g.auc() - c.auc())
    sg = split_nodes(g.model.output["trees"][0][0])
    sc = split_nodes(c.model.output["trees"][0][0])
    if not (dauc < 1e-3 and sg == sc):
        raise AssertionError(f"parity: auc delta {dauc}, tree-0 splits "
                             f"{len(sg)} vs {len(sc)}, equal={sg == sc}")
    return {"phase": "parity", "rows": 100_000, "auc_cuda": g.auc(),
            "auc_cpu": c.auc(), "auc_delta": dauc, "tree0_split_nodes": len(sg),
            "cuda_seconds": g_s, "cpu_seconds": c_s}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    import h2o3_tpu_torch  # noqa: F401  (fails outside a checkout)
    emit(phase_build())
    kline, meas = phase_kernels()
    emit(kline)
    main_line = phase_main()
    emit(main_line)
    emit(phase_parity())
    kernels = []
    for name, src, replaces, shape in (
        ("hist", "h2o3_tpu_torch/csrc/hist.cu",
         "h2o3_tpu/ops/hist_pallas.py:448",
         "1M x 28 u8, 8 nodes, 256 bins, 3 lanes"),
        ("split", "h2o3_tpu_torch/csrc/split.cu",
         "h2o3_tpu/ops/split_pallas.py:67",
         "32 nodes x 28 columns x 256 bins x 3 lanes"),
    ):
        m = meas[name]
        kernels.append({
            "name": name, "ported": True, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": main_line["launches"][name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": shape,
        })
    emit({"kernels": kernels})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
