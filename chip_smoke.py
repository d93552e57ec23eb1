"""Smoke run of the PyTorch/CUDA port (``h2o3_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero before the
final line):

1. build   — compile every kernel of the main paths (csrc/*.cu, one nvcc
             per source, in parallel) into the ignored build directory;
2. kernels — each kernel (B1 histogram with its row compaction, B2 split
             scan, B3 monotone split scan) against its plain PyTorch version
             on the card at the main path's shapes (1M rows x 28 columns,
             256 bins, 3 stat lanes; B1 at 1/8/32 nodes with 10% of the rows
             retired, 1 node with every row active and 16 nodes with half
             of the rows dead, B2/B3 at 1/8/32 nodes, plus an integer-stat
             shape that must match exactly), with its CUDA-event time over
             the wrapper, its device-only time (torch.profiler), the plain
             version's time, one PyTorch library call's time where one
             computes the same function, and the least time the card could
             take (bound);
             B1 is also held bit-equal on integer stats where fewer rows
             are active than its grid has clusters (1M rows with 50, 1 or
             no active rows; 150-row frames);
2b. autotune — B1's tile autotuner under H2O3_TPU_PALLAS_TILES=auto at the
             headline's node counts (1, 2, 4, 8, 16; 1 and 2 share a
             bucket): one sweep per new bucket, none on a repeat, each
             winner beside the built-in geometry's time; B1 at the tuned
             geometry against its plain version and, on the same inputs in
             the same phase, B1 at the built-in geometry;
3. main    — the headline GBM through the user entry points at full width:
             upload_file -> H2OGradientBoostingEstimator(20 trees, depth 6,
             lr 0.1, min_rows 10, seed 42).train -> predict -> AUC on a
             1M x 28 Higgs-like frame; launch counts are zeroed just before
             and read just after, and must match the levels built;
4. parity  — the same GBM at 100k rows on the card and on the CPU (plain
             versions): AUC within 1e-3 and tree 0's split columns equal;
5. mono    — the headline with monotone_constraints {f0: +1, f1: -1,
             f4: +1, f5: +1} (f4 and f5 go against the signal): every split
             scan on B3 and none on B2, AUC > 0.7, and predictions monotone
             in each constrained column over a sweep of 8 fixed rows; then a
             tweedie GBM on a 1M-row claims frame, {f0: +1, f1: -1};
6. mono parity — the constrained headline at 100k rows, card against CPU;
7. the ``kernels`` line (B1, its compaction, B2 and B3, with their launch
   counts from the main paths; the tile autotuner is no kernel and is off
   on the main path, so its figures stay on the autotune line), the card's
   name and power limit, and the result.

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
MONO = {"f0": 1, "f1": -1, "f4": 1, "f5": 1}
CLAIMS_MONO = {"f0": 1, "f1": -1}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def hist_bound(nid, C, N, B, S) -> tuple[float, str]:
    """B1's bound for these inputs: nid read once, codes and stats of the
    active rows only, the histogram written once; one add per active row,
    column and lane."""
    act = int((nid >= 0).sum())
    return bound_ms(4 * len(nid) + act * (C + 4 * S) + 4 * N * C * B * S,
                    act * C * S)


def check_compaction(nid, N) -> tuple[int, int]:
    """The compaction kernel against its plain version: equal offsets, and
    each node's rows equal as sets. Returns (max |offset difference|,
    compacted positions whose (node, row) differs once each node's rows are
    sorted)."""
    from h2o3_tpu_torch.ops.hist_cuda import compact_cuda, compact_plain

    rows, start = compact_cuda(nid, N)
    prow, pstart = compact_plain(nid, N)
    off_err = int((start.long() - pstart.long()).abs().max())
    if off_err:
        raise AssertionError(f"compaction N={N}: offsets differ by {off_err}")
    m = int(pstart[-1])
    node = torch.searchsorted(pstart[1:], torch.arange(m, device=nid.device),
                              right=True)
    key = node * len(nid) + rows[:m].long()  # plain: ascending already
    mismatched = int((torch.sort(key).values
                      != node * len(nid) + prow[:m].long()).sum())
    if mismatched:
        raise AssertionError(f"compaction N={N}: {mismatched} rows differ")
    return off_err, mismatched


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


def mono_inputs(N, C, seed, integer=False):
    """Random directions in {-1, 0, 1} per column and bounds on every other
    node (±inf on the rest): quarter-integers for integer stats, else a few
    hundredths, where the child values of these histograms lie."""
    rng = np.random.default_rng(seed)
    mono = rng.integers(-1, 2, C).astype(np.int32)
    if integer:
        lo = -rng.integers(0, 4, N) / 4
        hi = rng.integers(0, 4, N) / 4
    else:
        lo = -rng.uniform(0.005, 0.05, N)
        hi = rng.uniform(0.005, 0.05, N)
    bounded = np.arange(N) % 2 == 0
    lo = np.where(bounded, lo, -np.inf).astype(np.float32)
    hi = np.where(bounded, hi, np.inf).astype(np.float32)
    dev = torch.device("cuda")
    return [torch.from_numpy(a).to(dev) for a in (mono, lo, hi)]


def mono_terms64(hist, tot, min_rows, mono, lo, hi):
    """Per candidate and NA side (last axis: NA left, NA right), in float64:
    the gain (_NEG under min_rows), the monotone margin m·(v_right - v_left)
    (+inf where m == 0), and the margin's float32 rounding allowance, 1e-5
    of the column's absolute wy and wh mass over each child's wh."""
    from h2o3_tpu_torch.ops.split_cuda import _child_val, _fit, _gain_with_na

    h = hist.double()
    na, data = h[:, :, 0, :], h[:, :, 1:, :]
    cum = torch.cumsum(data, dim=2)
    left = cum[:, :, :-1, :]
    right = cum[:, :, -1:, :] - left
    nab = na[:, :, None, :]
    pf = _fit(tot.double())
    gain = torch.stack([_gain_with_na(pf, left + nab, right, min_rows),
                        _gain_with_na(pf, left, right + nab, min_rows)], -1)
    lo_, hi_ = lo.double()[:, None, None], hi.double()[:, None, None]
    mass_y = h[..., 1].abs().sum(dim=2)[:, :, None]
    mass_h = h[..., 2].abs().sum(dim=2)[:, :, None]

    def val(s):
        v = _child_val(s, lo_, hi_)
        return v, 1e-5 * (mass_y + v.abs() * mass_h) / s[..., 2].clamp(min=1e-30)

    (va, ta), (vb, tb) = val(left + nab), val(right)
    (vc, tc), (vd, td) = val(left), val(right + nab)
    m = mono.double()[None, :, None]
    margin = torch.stack([m * (vb - va), m * (vd - vc)], -1)
    margin = torch.where(m[..., None] == 0, torch.inf, margin)
    return gain, margin, torch.stack([ta + tb, tc + td], -1)


def check_mono_split(hist, tot, min_rows, mono, lo, hi, gk, gp, scale):
    """B3 against its plain version on float data. Where the two decide
    alike, gains within 1e-5 of the fit scale they cancel (as B2). Where
    they differ, it must be a near-tie in float64: the kernel's candidate
    is feasible within its margin allowance and within the gain tolerance
    of every clearly feasible candidate (or, if the kernel found none,
    there is none). Returns (gain err/scale, decisions differing)."""
    feas_k, feas_p = gk[0] > -1e29, gp[0] > -1e29
    diff = (gk[1] != gp[1]) | (gk[2] != gp[2]) | (feas_k != feas_p)
    gerr = torch.where(~diff & feas_p, (gk[0] - gp[0]).abs() / scale, 0.0)
    gerr = gerr.max().item()
    if gerr >= 1e-5:
        raise AssertionError(f"split_mono: gain err/scale {gerr:.3e}")
    n_diff = int(diff.sum())
    if n_diff:
        gain, margin, tol = mono_terms64(hist, tot, min_rows, mono, lo, hi)
        clear = (margin > tol) & (gain > -1e29)
        best = torch.where(clear, gain, -torch.inf).amax(dim=(2, 3))
        idx = gk[1].long()[:, :, None, None].expand(-1, -1, 1, 2)
        side = (~gk[2]).long()[:, :, None]  # 0: NA left, 1: NA right

        def at(a):
            return a.gather(2, idx).squeeze(2).gather(2, side).squeeze(2)

        g_k, m_k, t_k = at(gain), at(margin), at(tol)
        ok = torch.where(
            feas_k, (g_k > -1e29) & (m_k >= -t_k) & (g_k >= best - 1e-5 * scale),
            best < -1e29)
        if bool((diff & ~ok).any()):
            raise AssertionError(f"split_mono: {int((diff & ~ok).sum())} of "
                                 f"{n_diff} differing decisions are not "
                                 "near-ties")
    return gerr, n_diff


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
    from h2o3_tpu_torch.ops.hist_cuda import (
        compact_cuda,
        compact_plain,
        hist_cuda,
        hist_plain,
    )
    from h2o3_tpu_torch.ops.histogram import node_totals
    from h2o3_tpu_torch.ops.split_cuda import (
        split_candidates_cuda,
        split_candidates_mono_cuda,
        split_candidates_mono_plain,
        split_candidates_plain,
    )
    from h2o3_tpu_torch.tools.bench_hist import (
        SHAPES,
        device_ms,
        hist_inputs,
        index_add_ms,
        time_ms,
    )

    n, C, B, S = N_ROWS, N_COLS, N_BINS, N_STATS
    rows = []
    meas = {}
    for label, N, dead, seed in SHAPES:
        bins, nid, stats = hist_inputs(n, C, N, B, seed, dead)
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
            raise AssertionError(f"hist {label}: err/mass {rel:.3e} (kernel), "
                                 f"{rel_plain:.3e} (plain) vs float64")
        del ref64, mass
        off_err, mismatched = check_compaction(nid, N)

        def run():
            return hist_cuda(bins, nid, stats, N, B)

        bnd, by = hist_bound(nid, C, N, B, S)
        rows.append({"kernel": "hist", "shape": label, "nodes": N,
                     "active_rows": int((nid >= 0).sum()),
                     "err_over_mass": rel, "plain_err_over_mass": rel_plain,
                     "max_abs_err": (got - ref).abs().max().item(),
                     "ms": time_ms(run, reps=20), "device_ms": device_ms(run),
                     "plain_ms": time_ms(
                         lambda: hist_plain(bins, nid, stats, N, B), reps=3,
                         warmup=1),
                     # yardstick: ONE index_add_ computing the same histogram
                     "library_ms": index_add_ms(bins, nid, stats, N, B),
                     "bound_ms": bnd, "bound_by": by})
        if label == "8":
            meas["hist"] = rows[-1]
            cb, cby = bound_ms(4 * n + 4 * rows[-1]["active_rows"]
                               + 4 * (N + 1), 0)
            meas["hist_compact"] = {
                # offsets: |kernel - plain|; rows: positions differing
                "max_abs_err": off_err, "rows_mismatched": mismatched,
                "ms": time_ms(lambda: compact_cuda(nid, N), reps=20),
                "device_ms": device_ms(lambda: compact_cuda(nid, N)),
                "plain_ms": time_ms(lambda: compact_plain(nid, N), reps=3,
                                    warmup=1),
                # no single PyTorch call drops nid < 0 rows, groups the rest
                # by node and returns the offsets
                "library_ms": None, "bound_ms": cb, "bound_by": cby}
            rows.append({"kernel": "hist_compact", "shape": label,
                         "nodes": N, **meas["hist_compact"]})
        if label not in ("1", "8", "32"):
            continue

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
        s_dev = device_ms(lambda: split_candidates_cuda(got, tot, 10.0))
        s_plain = time_ms(lambda: split_candidates_plain(got, tot, 10.0),
                          reps=5, warmup=1)
        sb, sby = bound_ms(4 * N * C * B * 3 + 4 * N * 3
                           + N * C * (4 + 4 + 1 + 24), 24 * N * C * (B - 2))
        rows.append({"kernel": "split", "nodes": N, "err_over_scale": gerr,
                     "max_abs_err": (gk[0] - gp[0]).abs().max().item(),
                     "decisions_differing_as_near_ties": n_diff, "ms": s_ms,
                     "device_ms": s_dev, "plain_ms": s_plain, "library_ms": None, "bound_ms": sb,
                     "bound_by": sby})

        # B3 on the same histogram: random directions, half the nodes bounded
        mono, lo, hi = mono_inputs(N, C, seed=100 + N)
        margs = (got, tot, 10.0, mono, lo, hi)
        mk = split_candidates_mono_cuda(*margs)
        mp = split_candidates_mono_plain(*margs)
        merr, m_diff = check_mono_split(*margs, mk, mp, scale)
        same = (mk[1] == mp[1]) & (mk[2] == mp[2])
        m_ms = time_ms(lambda: split_candidates_mono_cuda(*margs), reps=50)
        m_dev = device_ms(lambda: split_candidates_mono_cuda(*margs))
        m_plain = time_ms(lambda: split_candidates_mono_plain(*margs), reps=5,
                          warmup=1)
        # inputs read once (+ directions and bounds), outputs written once;
        # per candidate B2's ~24 flops plus 4 clipped child values, 2
        # differences, 2 products and 3 adds, ~19 more
        mb, mby = bound_ms(4 * N * C * B * 3 + 4 * N * 3 + 4 * C + 8 * N
                           + N * C * (4 + 4 + 1 + 24), 43 * N * C * (B - 2))
        rows.append({"kernel": "split_mono", "nodes": N,
                     "err_over_scale": merr,
                     "max_abs_err": torch.where(
                         same, (mk[0] - mp[0]).abs(), 0.0).max().item(),
                     "decisions_differing_as_near_ties": m_diff,
                     # (node, column) winners the mask moved away from B2's
                     "changed_by_mask": float(((mp[1] != gp[1])
                                               | (mp[2] != gp[2])).float()
                                              .mean()),
                     "ms": m_ms, "device_ms": m_dev, "plain_ms": m_plain,
                     "library_ms": None,
                     "bound_ms": mb, "bound_by": mby})
        if N == 32:
            meas["split"] = rows[-2]
            meas["split_mono"] = rows[-1]

    # integer stats: every order of summation is exact -> bit-equal
    bins, nid, stats = hist_inputs(n, C, 8, B, seed=99, integer=True)
    got = hist_cuda(bins, nid, stats, 8, B)
    ref = hist_plain(bins, nid, stats, 8, B)
    if not torch.equal(got, ref):
        raise AssertionError("hist: integer-stat histogram not bit-equal")
    tot = node_totals(got).contiguous()
    for a, b in zip(split_candidates_cuda(got, tot, 10.0),
                    split_candidates_plain(got, tot, 10.0)):
        if not torch.equal(a, b):
            raise AssertionError("split: integer-stat decisions not bit-equal")
    margs = (got, tot, 10.0, *mono_inputs(8, C, seed=7, integer=True))
    for a, b in zip(split_candidates_mono_cuda(*margs),
                    split_candidates_mono_plain(*margs)):
        if not torch.equal(a, b):
            raise AssertionError("split_mono: integer-stat decisions not "
                                 "bit-equal")
    few = [few_active_check(*case) for case in (
        (n, C, 8, 50), (n, C, 32, 1), (n, C, 8, 0), (150, 16, 1, 60),
        (150, C, 4, 30))]
    return {"phase": "kernels", "rows": rows, "integer_exact": True,
            "few_active_bit_equal": few}, meas


def few_active_check(n, C, N, active) -> dict:
    """B1 on integer stats where fewer rows are active than its grid has
    clusters, bit-equal to the plain version. The partials' scratch comes
    from torch.empty, so the caching allocator is first handed a block of
    NaNs to give back: a cluster without rows must neither write a partial
    nor be read by the reduce."""
    import functools

    from h2o3_tpu_torch.ops.hist_cuda import (
        _wave_clusters,
        hist_cuda,
        hist_plain,
        launch_geometry,
    )

    rng = np.random.default_rng(n + N + active)
    dev = torch.device("cuda")
    nid = np.full(n, -1, np.int32)
    nid[rng.choice(n, active, replace=False)] = rng.integers(0, N, active)
    bins, nid, stats = (torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, N_BINS, (n, C)).astype(np.uint8), nid,
        rng.integers(-3, 4, (n, N_STATS)).astype(np.float32)))
    g = launch_geometry(n, C, N, N_BINS, N_STATS,
                        functools.partial(_wave_clusters, dev, N_STATS))
    if not g["clusters"] > active:
        raise AssertionError(f"few-active case {n, C, N, active}: only "
                             f"{g['clusters']} clusters")
    torch.full((16 << 20,), float("nan"), device=dev)  # freed at once
    got = hist_cuda(bins, nid, stats, N, N_BINS)
    if not torch.equal(got, hist_plain(bins, nid, stats, N, N_BINS)):
        raise AssertionError(f"hist: {active} active rows of {n} at {N} "
                             "nodes not bit-equal")
    return {"rows": n, "cols": C, "nodes": N, "active_rows": active,
            "clusters": g["clusters"]}


def phase_autotune() -> dict:
    """B1's autotuner under H2O3_TPU_PALLAS_TILES=auto at the headline node
    counts: a sweep on the first resolve of each bucket (1 and 2 nodes
    share one), none on a repeat; the winners beside the built-in
    geometry's time in the same sweep. Then B1 at the 8-node bucket's
    winner on phase 2's 8-node inputs against its plain version, timed
    beside B1 at the built-in geometry on the same inputs. Returns the
    phase line."""
    import os

    from h2o3_tpu_torch.ops import cuda_build, hist_tiles
    from h2o3_tpu_torch.ops.hist_cuda import (
        _wave_clusters,
        builtin_tiles,
        hist_cuda,
        hist_plain,
    )
    from h2o3_tpu_torch.tools.bench_hist import device_ms, hist_inputs, time_ms

    dev = torch.device("cuda")
    hist_tiles.CACHE_PATH = cuda_build.BUILD_DIR / "hist_tiles_smoke.json"
    hist_tiles.CACHE_PATH.unlink(missing_ok=True)
    hist_tiles._TUNED.clear()
    hist_tiles.tiles_for.sweeps = 0
    knob = os.environ.get("H2O3_TPU_PALLAS_TILES")
    os.environ["H2O3_TPU_PALLAS_TILES"] = "auto"
    try:
        rows, seen = [], set()
        for N in (1, 2, 4, 8, 16):
            bucket = hist_tiles._tile_bucket(N_COLS, N, N_BINS, N_STATS)
            s0 = hist_tiles.tiles_for.sweeps
            t0 = time.perf_counter()
            win = hist_tiles.tiles_for(N_ROWS, N_COLS, N, N_BINS, N_STATS, dev)
            seconds = time.perf_counter() - t0
            if hist_tiles.tiles_for.sweeps != s0 + (bucket not in seen):
                raise AssertionError(f"autotune N={N}: "
                                     f"{hist_tiles.tiles_for.sweeps - s0} "
                                     f"sweeps for bucket {bucket}")
            seen.add(bucket)
            s1 = hist_tiles.tiles_for.sweeps
            if (hist_tiles.tiles_for(N_ROWS, N_COLS, N, N_BINS, N_STATS, dev)
                    != win or hist_tiles.tiles_for.sweeps != s1):
                raise AssertionError(f"autotune N={N}: a repeat resolve swept")
            key, times = next((k, v) for k, v in hist_tiles.SWEEP_TIMES.items()
                              if k[0] == bucket)
            cb, nb, bb, _ = bucket
            builtin = builtin_tiles(
                key[1], cb, nb, min(bb, 256), N_STATS,
                lambda smem: _wave_clusters(dev, N_STATS, smem))
            if win not in times:
                raise AssertionError(f"autotune N={N}: winner {win} untimed")
            rows.append({"nodes": N, "bucket": bucket, "sweep_rows": key[1],
                         "winner": win, "winner_ms": times[win],
                         "builtin": builtin, "builtin_ms": times[builtin],
                         "candidates": len(times), "resolve_seconds": seconds})
        sweeps = hist_tiles.tiles_for.sweeps
        # B1 at the tuned geometry of the 8-node bucket
        ib, inid, ist = hist_inputs(N_ROWS, N_COLS, 8, N_BINS, seed=5,
                                    integer=True)
        if not torch.equal(hist_cuda(ib, inid, ist, 8, N_BINS),
                           hist_plain(ib, inid, ist, 8, N_BINS)):
            raise AssertionError("autotune: integer histogram at the winner "
                                 "not bit-equal")
        bins, nid, stats = hist_inputs(N_ROWS, N_COLS, 8, N_BINS, seed=8)

        def run():
            return hist_cuda(bins, nid, stats, 8, N_BINS)

        got, ref = run(), hist_plain(bins, nid, stats, 8, N_BINS)
        tuned = {"tiles": hist_tiles.tiles_for(N_ROWS, N_COLS, 8, N_BINS,
                                               N_STATS, dev),
                 "max_abs_err": (got - ref).abs().max().item(),
                 "ms": time_ms(run, reps=20), "device_ms": device_ms(run)}
        os.environ["H2O3_TPU_PALLAS_TILES"] = ""  # the built-in geometry
        tuned["builtin_ms"] = time_ms(run, reps=20)
        tuned["builtin_device_ms"] = device_ms(run)
    finally:
        if knob is None:
            del os.environ["H2O3_TPU_PALLAS_TILES"]
        else:
            os.environ["H2O3_TPU_PALLAS_TILES"] = knob
    return {"phase": "autotune", "sweeps": sweeps, "buckets": rows,
            "tuned_8_nodes": tuned}


def split_nodes(tree) -> list:
    """(level, node, split column) of every real split node."""
    out = []
    host = tree.to_host()
    for li, (lv, m) in enumerate(zip(host.levels, tree.real_level_masks())):
        for node in np.nonzero(~lv.leaf_now & m)[0]:
            out.append((li, int(node), int(lv.split_col[node])))
    return out


def train(df, device, y="label", **kw):
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    fr = h2o3_tpu_torch.upload_file(df, device=device)
    est = H2OGradientBoostingEstimator(**GBM_KW, **kw)
    t0 = time.perf_counter()
    est.train(y=y, training_frame=fr)
    if device == "cuda":
        torch.cuda.synchronize()
    return est, fr, time.perf_counter() - t0


def phase_main() -> dict:
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.models import metrics as MM
    from h2o3_tpu_torch.ops.hist_cuda import compact_cuda, hist_cuda
    from h2o3_tpu_torch.ops.split_cuda import split_candidates_cuda

    df = higgs_like(N_ROWS, N_COLS, seed=0)
    hist_cuda.launches = 0
    compact_cuda.launches = 0
    split_candidates_cuda.launches = 0
    est, fr, seconds = train(df, "cuda")
    pred = est.predict(fr)
    p1 = pred.vec("s").data
    torch.cuda.synchronize()
    launches = {"hist": hist_cuda.launches,
                "hist_compact": compact_cuda.launches,
                "split": split_candidates_cuda.launches}
    trees = [g[0] for g in est.model.output["trees"]]
    # per tree: a histogram (one compaction each) and a split scan at every
    # level but the last, whose leaves come from the parents' child stats
    levels = sum(len(t.levels) - 1 for t in trees)
    if not (launches["hist"] == launches["hist_compact"] == launches["split"]
            == levels > 0):
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


def phase_parity(name="parity", **kw) -> dict:
    from h2o3_tpu_torch.datasets import higgs_like

    df = higgs_like(100_000, N_COLS, seed=1)
    g, _, g_s = train(df, "cuda", **kw)
    c, _, c_s = train(df, "cpu", **kw)
    dauc = abs(g.auc() - c.auc())
    sg = split_nodes(g.model.output["trees"][0][0])
    sc = split_nodes(c.model.output["trees"][0][0])
    if not (dauc < 1e-3 and sg == sc):
        raise AssertionError(f"{name}: auc delta {dauc}, tree-0 splits "
                             f"{len(sg)} vs {len(sc)}, equal={sg == sc}")
    return {"phase": name, "rows": 100_000, "auc_cuda": g.auc(),
            "auc_cpu": c.auc(), "auc_delta": dauc, "tree0_split_nodes": len(sg),
            "cuda_seconds": g_s, "cpu_seconds": c_s}


def monotone_probe(est, df, constraints, pred_col, n_rows=8, n_grid=64):
    """Sweep each constrained column over a grid with the other features of
    ``n_rows`` fixed rows held; the predictions must never move against the
    column's direction by more than 1e-6. Returns the worst signed step."""
    import h2o3_tpu_torch

    base = df[[c for c in df.columns if c.startswith("f")]].iloc[:n_rows]
    grid = np.linspace(-3, 3, n_grid, dtype=np.float32)
    worst = float("inf")
    for col, sign in constraints.items():
        rows = base.loc[base.index.repeat(n_grid)].reset_index(drop=True)
        rows[col] = np.tile(grid, n_rows)
        fr = h2o3_tpu_torch.upload_file(rows, device="cuda")
        p = est.predict(fr).vec(pred_col).data.double().cpu().numpy()
        step = (sign * np.diff(p.reshape(n_rows, n_grid), axis=1)).min()
        worst = min(worst, float(step))
    if worst < -1e-6:
        raise AssertionError(f"monotone probe: a step of {worst} against a "
                             "constrained direction")
    return worst


def mono_run(df, y, constraints, pred_col, **kw) -> tuple:
    """Train a constrained GBM on the card with every count zeroed just
    before and read just after; B3 must run at every split level and B2
    never."""
    from h2o3_tpu_torch.ops.hist_cuda import hist_cuda
    from h2o3_tpu_torch.ops.split_cuda import (
        split_candidates_cuda,
        split_candidates_mono_cuda,
    )

    hist_cuda.launches = 0
    split_candidates_cuda.launches = 0
    split_candidates_mono_cuda.launches = 0
    est, fr, seconds = train(df, "cuda", y=y,
                             monotone_constraints=constraints, **kw)
    p = est.predict(fr).vec(pred_col).data
    torch.cuda.synchronize()
    launches = {"hist": hist_cuda.launches,
                "split": split_candidates_cuda.launches,
                "split_mono": split_candidates_mono_cuda.launches}
    levels = sum(len(g[0].levels) - 1 for g in est.model.output["trees"])
    if not (launches["split_mono"] == launches["hist"] == levels > 0
            and launches["split"] == 0):
        raise AssertionError(f"mono launches {launches} vs {levels} levels")
    if p.shape != (len(df),) or not bool(torch.isfinite(p).all()):
        raise AssertionError("predictions not finite or of the wrong shape")
    probe = monotone_probe(est, df, constraints, pred_col)
    return est, seconds, launches, levels, probe


def phase_mono() -> tuple[list[dict], dict]:
    from h2o3_tpu_torch.datasets import claims_like, higgs_like

    df = higgs_like(N_ROWS, N_COLS, seed=0)
    est, seconds, launches, levels, probe = mono_run(df, "label", MONO, "s")
    auc = est.auc()
    if not auc > 0.7:
        raise AssertionError(f"constrained headline auc {auc}")
    out = [{"phase": "mono", "rows": N_ROWS, "cols": N_COLS, **GBM_KW,
            "monotone_constraints": MONO, "train_seconds": seconds,
            "trees_per_sec": GBM_KW["ntrees"] / seconds, "auc": auc,
            "levels": levels, "launches": launches,
            "probe_worst_step": probe}]
    del df
    cf = claims_like(N_ROWS, N_COLS, seed=0)
    est, seconds, launches_t, levels, probe = mono_run(
        cf, "claim", CLAIMS_MONO, "predict", distribution="tweedie",
        tweedie_power=1.5)
    dev = est.model.training_metrics.value("mean_residual_deviance")
    if not np.isfinite(dev):
        raise AssertionError(f"tweedie deviance {dev}")
    out.append({"phase": "mono_tweedie", "rows": N_ROWS, "cols": N_COLS,
                **GBM_KW, "distribution": "tweedie", "tweedie_power": 1.5,
                "monotone_constraints": CLAIMS_MONO,
                "zero_share": float((cf["claim"] == 0).mean()),
                "train_seconds": seconds,
                "trees_per_sec": GBM_KW["ntrees"] / seconds,
                "mean_residual_deviance": dev, "levels": levels,
                "launches": launches_t, "probe_worst_step": probe})
    return out, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    import h2o3_tpu_torch  # noqa: F401  (fails outside a checkout)
    emit(phase_build())
    kline, meas = phase_kernels()
    emit(kline)
    emit(phase_autotune())
    main_line = phase_main()
    emit(main_line)
    emit(phase_parity())
    mono_lines, mono_launches = phase_mono()
    for line in mono_lines:
        emit(line)
    emit(phase_parity("mono_parity", monotone_constraints=MONO))
    launches = {**main_line["launches"],
                "split_mono": mono_launches["split_mono"]}
    kernels = []
    for name, src, replaces, shape in (
        ("hist", "h2o3_tpu_torch/csrc/hist.cu",
         "h2o3_tpu/ops/hist_pallas.py:448",
         "1M x 28 u8, 8 nodes, 10% retired, 256 bins, 3 lanes"),
        ("hist_compact", "h2o3_tpu_torch/csrc/hist.cu",
         "h2o3_tpu/ops/hist_pallas.py:448",
         "1M nid, 8 nodes, 10% retired"),
        ("split", "h2o3_tpu_torch/csrc/split.cu",
         "h2o3_tpu/ops/split_pallas.py:67",
         "32 nodes x 28 columns x 256 bins x 3 lanes"),
        ("split_mono", "h2o3_tpu_torch/csrc/split.cu",
         "h2o3_tpu/ops/split_pallas.py:146",
         "32 nodes x 28 columns x 256 bins x 3 lanes, 16 nodes bounded"),
    ):
        m = meas[name]
        kernels.append({
            "name": name, "ported": True, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "device_ms": m["device_ms"],
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
