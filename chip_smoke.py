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
             no active rows; 150-row frames), and B2/B3 at the edges of
             their geometry and feasibility (257, 129, 33, 4 and 3 bins,
             2048 nodes, no feasible candidate, min_rows 0), each after
             the allocator was handed a block of NaNs; B1, its compaction
             and B2 also at the multinomial headline's shape (581,012
             rows, 54 columns padded to 56 with all-NA columns, 8 nodes;
             B1 on uniform codes and on the binned Covertype-shaped
             frame's codes);
2b. autotune — B1's tile autotuner under H2O3_TPU_PALLAS_TILES=auto at the
             headline's node counts (1, 2, 4, 8, 16; 1 and 2 share a
             bucket): one sweep per new bucket, none on a repeat, each
             winner beside the built-in geometry's time; B1 at the tuned
             geometry against its plain version and, on the same inputs in
             the same phase, B1 at the built-in geometry;
3. main    — the headline GBM through the user entry points at full width:
             upload_file -> H2OGradientBoostingEstimator(20 trees, depth 6,
             lr 0.1, min_rows 10, seed 42).train -> predict -> AUC on a
             1M x 28 Higgs-like frame, by default on the whole-tree path
             (each tree one CUDA-graph replay, captured in this training
             after an eager warm-up tree); launch counts are zeroed just
             before and read just after: less the warm-up's launches, B1,
             its compaction and B2 ran 20 x 6 = 120 times inside replays;
             a second training of the shape under torch.profiler must show
             as many events of each kernel in the card's trace as the
             replay-counted launches (the graph really holds them);
             the device-stats AUC of the predictions against their exact
             host AUC (within 1e-3);
3b. whole_tree — the headline trained by the eager per-level loop
             (H2O3_TPU_WHOLE_TREE=0) and by graph replay, in turns, in one
             process: warm trees/sec of both, AUC within 1e-5, tree 0's
             splits equal, no new capture for a repeated shape, and the
             graphs' captures, replays, capture seconds and memory;
4. parity  — the same GBM at 100k rows on the card and on the CPU (plain
             versions): AUC within 1e-3 and tree 0's split columns equal;
5. mono    — the headline with monotone_constraints {f0: +1, f1: -1,
             f4: +1, f5: +1} (f4 and f5 go against the signal): every split
             scan on B3 and none on B2 (120 inside replays, held against
             the trace of a second training as in phase 3), AUC > 0.7, and
             predictions monotone in each constrained column over a sweep of
             8 fixed rows; then a tweedie GBM on a 1M-row claims frame,
             {f0: +1, f1: -1};
6. mono parity — the constrained headline at 100k rows, card against CPU;
7. multinomial — GBM on a Covertype-shaped frame (``datasets.covtype_like``,
             581,012 x 54, 7 classes), 20 iterations of 7 class trees,
             depth 6, lr 0.1, min_rows 10, seed 42, score_tree_interval 5,
             by the eager control and by graph replay in turns (eager,
             graph, eager, graph): logloss within 2e-4 (repeated
             trainings of either path differ by up to 8.45e-5: B1's float
             sums decide near-tie splits) and class tree (0, 0)'s strong
             splits equal; less the warm-up tree, B1, its
             compaction and B2 ran 140 x 6 = 840 times inside replays, as
             many as a traced third training shows; the device-stats
             multinomial metrics against the exact host metrics of the same
             probabilities (logloss within 1e-6, confusion matrix equal);
             warm seconds, class trees/sec, the graphs' capture seconds and
             memory, and the trace's device idle share;
8. multinomial parity — 5 iterations on the first 100k rows of that frame,
             card against CPU: logloss within 1e-3 relative, classification
             error within 1e-3;
9. drf     — the slice's headline: binomial DRF at H2O's defaults (50
             trees of depth 20, min_rows 1, mtries -1 = 5 of 28 columns per
             split, sample_rate 0.632, seed 42) on the 1M x 28 Higgs-like
             frame through H2ORandomForestEstimator: a capturing training
             (counted: B1, its compaction and B2 inside replays, 1,000 each
             when every tree runs all 20 levels, and B1's launches on the
             saturated-level graph at 2048 nodes), a warm one (trees/sec),
             one traced (its kernel
             events equal to the replay-counted launches; device idle
             share, width spans) and the eager control: graph and eager
             records equal in every split of every tree, AUC; capture
             seconds, pool, state and retained bytes against the cache's
             budget, and whether the plan stayed cached;
10. kernels_wide — B1 (with its compaction) and B2 against their plain
             versions at the saturated widths, 1024 and 2048 nodes at 1M x
             28 x 256 x 3, on uniform codes and on the DRF headline's
             codes with a real depth-12 nid (tree 0 replayed 12 levels),
             with events, device and CUDA-graph times, bound and one
             index_add_'s time;
11. drf_parity — the keyed masks bit-equal on the card and the CPU, then
             DRF card against CPU at 10k rows and 3 trees, binomial and
             regression (claims-like): trees equal up to a float near-tie,
             the card's trees scored on the CPU within 1e-3 of the card's
             metric, AUC within 1e-3 and RMSE within 2e-2 relative;
12. drf_multinomial — DRF on the Covertype-shaped frame, 10 iterations of
             7 class trees at depth 20, graph against eager logloss within
             2e-4;
13. gbm_sampled — the headline GBM with sample_rate, col_sample_rate and
             col_sample_rate_per_tree at 0.8, graph against eager AUC
             within 1e-5; gbm_sampled_parity: the same at 100k rows, card
             against CPU;
14. export  — the binomial, multinomial and DRF headline models through
             ``download_mojo``, scored by the port's offline scorer
             (``h2o3_tpu_torch.genmodel``) on 100k rows (DRF: 10k) within
             1e-5 of ``predict``; the headline's ``export_pojo`` file run in
             a subprocess on 1,000 rows, within 1e-5; export seconds,
             artifact bytes, and a warm ``predict`` of each GBM on 1M
             rows;
15. glm     — the JAX bench's GLM headline (``bench.py:652``): binomial,
             lambda_=1e-4, max_iterations=20, seed=1 on the 1M x 28
             Higgs-like frame (29 design columns padded to 32), IRLSM on
             the fused lane: first and warm seconds, iterations/sec, IRLS
             iterations, chunks and host reads, ADMM steps per iteration
             (min/median/max), host float64 fallbacks (must be 0), the Gram
             alone against its bound and against a float64 Gram of the
             same inputs (within 1e-5), the ADMM solve by CUDA-graph
             blocks and eagerly, the device idle share of a traced warm
             training, the training AUC against the exact AUC of
             ``predict``, coefficients, and the ``H2O3_TPU_GLM_FUSE=0``
             control (its seconds, coefficients within 1e-3);
16. glm_airlines — the same on a 1M-row Airlines-shaped frame
             (``datasets.airlines_like``: 634 design columns padded to
             636, a 2.5 GB design), with the design bytes and the Gram's
             TFLOP/s;
17. glm_families — gaussian, poisson, gamma (positive rows, log link) and
             tweedie (power 1.5, log link) on the 1M-row claims frame, and
             L_BFGS on the headline: warm seconds, iterations, deviance;
17b. glm_multinomial — multinomial GLM on the Covertype-shaped frame at
             its published size (581,012 x 54, 7 classes; 55 design
             columns padded to 56), at JAX's default (``lambda_`` unset:
             a Cholesky solve per class) and at ``lambda_=1e-4``, alpha
             0.5 (an ADMM solve per class): warm seconds, iterations and
             class passes per second, training logloss, host reads,
             masked iterations, fallbacks, ADMM steps per class solve, a
             traced warm training and the ``H2O3_TPU_GLM_FUSE=0`` control
             (seconds, max|ΔBeta|); the predictions (n, 7), finite, rows
             summing to 1. JAX's cycling IRLS diverges on this frame and
             so does the port's: the figures are reported, not gated;
17c. glm_ordinal — ordinal GLM on ``datasets.ordinal_like`` (1M x 28, 5
             ordered levels from a known proportional-odds model),
             standardize off: warm seconds, BFGS iterations, evaluations,
             host reads (at most one per iteration) and stop reason, the
             NLL, max|beta - beta_true|, a traced warm training, and the
             host L-BFGS-B control (within 0.02 of beta_true);
17d. glm_interactions — the Airlines shape with ``hash_buckets=64`` and
             the pairs UniqueCarrier×Distance and CRSDepTime×Distance
             (191 design columns padded to 192, 0.77 GB): warm seconds,
             iterations/sec, AUC against the exact AUC of ``predict``,
             fallbacks (none allowed), design bytes, a traced training;
18. glm_parity — card against CPU: the headline at 1M rows, the Airlines
             shape cut to 50,000 rows, the hashed interaction headline at
             50,000 rows: coefficients within 1e-4, deviance within 1e-5
             relative, iterations equal; multinomial on the ordinal
             frame's response at 100k rows: Beta within 1e-4, logloss
             within 1e-5 relative, iterations equal; ordinal at the
             headline's 1M rows: beta and cuts within 2e-3; reported only:
             the Covertype multinomial (diverging) and the ordinal at 100k
             rows (a long float32 BFGS run whose end turns on rounding);
19. glm_export — the GLM headlines through ``download_mojo``, 100k rows
             scored offline: the binomial ones within 1e-5 of
             ``predict``, the multinomial, ordinal and hashed interaction
             models within 1e-6 in every probability column;
20. bin_edges — ``fit_bins`` on the card (1M-row Higgs-like and
             claims-like frames) bit-equal to the device program on CPU
             tensors of the same strided sample;
21. frame   — ``import_file`` on the card of one 200,000-row frame (an
             ISO-date column, the headline's 28 float columns and its
             label) written ``,``, tab, ``;`` and ``|``-separated: names,
             kinds, the floats and the date column's exact float64 copy
             equal to what was written;
22. cv      — cross-validation: the GBM headline with nfolds=5 (modulo,
             predictions kept), cold after emptying the graph cache (the
             main model captures, folds 2..5 must not) and warm (no
             capture; 6 x 20 x 6 launches of B1, its compaction and B2
             inside replays), the GLM headline with nfolds=5 (no ADMM
             capture in the folds) and the DRF headline with nfolds=3: the
             main model's and each fold's seconds, CV AUC beside training
             AUC, the holdout bit-equal to each fold model's own
             prediction on its rows, the card's CV metrics within 1e-6 of
             a host recomputation from the kept predictions; GBM CV at
             100k rows (3 folds), card against CPU: CV AUC within 1e-3;
23. max_runtime — GBM with ntrees=1000 and max_runtime_secs=1 on the
             headline frame: a partial model after at least one interval,
             well under 1000 trees;
24. xgboost — ``H2OXGBoostEstimator`` at xgboost's defaults (50 trees,
             depth 6, eta 0.3, lambda 1, min_child_weight 1) on the
             headline frame: cold and warm trees/sec, AUC, launches (50 x
             6 inside replays) and captures; reg_alpha=0.5 and
             scale_pos_weight=3 on the same captured plan; lambda = alpha
             = 0 with GBM's parameters, whose trees equal the GBM
             headline's; card against CPU at 100k rows (20 trees); the
             tmojo scored offline within 1e-6 of ``predict``;
25. dl      — DeepLearning, the JAX bench's headline (``bench.py``'s
             ``_bench_dl``, BASELINE.json configuration 4):
             ``datasets.mnist_like`` (100,000 x 784 float columns made on
             the card, 10 classes), ``H2ODeepLearningEstimator`` with
             hidden (128, 128), 1 epoch, batch 256, seed 3, Rectifier,
             ADADELTA: cold and warm seconds, rows/sec, steps/sec, one
             capture cold and none warm, replays, one host read per epoch,
             a traced warm training (idle share, device ms by ``dl.*``
             span), training logloss and the accuracy of ``predict``, and
             the eager step loop's weights within 1e-5 of the graphs'
             (dropout off); the DL path runs no kernel of the kernels line;
26. dl_autoencoder — ``H2OAutoEncoderEstimator`` (hidden (128,), 1 epoch)
             on the same features: seconds, reconstruction MSE, ``anomaly``
             over the frame (its mean the training MSE), the 784
             ``reconstr_*`` columns of ``predict``;
27. dl_parity — card against CPU on the first 10,000 rows, 2 epochs:
             final weights, the first epoch's loss and the training
             logloss within ``DL_PARITY_TOL`` (the float32 trajectory's
             own sensitivity, reported beside them);
28. dl_export — the headline model's tmojo, its bytes and export seconds,
             and 100,000 rows scored offline within 1e-6 of ``predict``;
29. automl  — the JAX bench's AutoML (``bench.py::_bench_automl``,
             BASELINE.json configuration 5): GBM and GLM, max_models 3, no
             folds, seed 11, on the first 50,000 rows of the 1M-row
             Higgs-like frame, cold (graph caches emptied) and warm in one
             process: seconds, captures, launches and host syncs by step,
             the leaderboard; 3 models, the leaderboard sorted by AUC as a
             host re-sort of its values, 0 captures warm;
30. automl_santander — the full leaderboard at full width: JAX's default
             plan (nfolds 5, max_models 10, seed 1) on
             ``datasets.santander_like`` (200,000 x 200, ~10% positives):
             per step seconds, captures, host syncs, launches and the
             ensembles' scoring seconds; both ensembles built, every
             base model's holdout a card tensor of 200,000 rows, every
             model's CV metrics within 1e-6 of a host recomputation, the
             "all" ensemble's training AUC at least the best base CV AUC
             less 0.02, ``predict``'s probability rows summing to 1;
31. automl_parity — the "all" ensemble's metalearner fit on the CPU on its
             level-one matrix copied from the card: coefficients within
             1e-4, deviance within 1e-5 relative; a small AutoML (20,000
             rows of the headline frame, GBM and GLM, max_models 4, 3
             folds, seed 7) on both devices, its CV AUCs and leaderboard
             orders reported;
32. the ``kernels`` line (B1, its compaction, B2 and B3, with their launch
   counts from the main paths, warm-up launches included and also given
   apart; for B1, its compaction and B2 their launches on the
   multinomial and DRF paths, on the CV, XGBoost and AutoML (Santander)
   paths, their figures at the multinomial shape and
   at 1024 and 2048 nodes on the DRF headline's depth-12 nid; the tile
   autotuner is no kernel and is off on the main path, so its figures stay
   on the autotune line), the card's name and power limit, and the
   result. Each phase line carries the seconds since the previous line.

It imports nothing of JAX or of the JAX package. Without a GPU it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
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
# the multinomial headline: Covertype's shape (datasets.covtype_like)
MN_ROWS, MN_COLS, MN_CLASSES = 581_012, 54, 7
MN_KW = dict(GBM_KW, score_tree_interval=5)
# cut from 10 iterations (PR 6) to 5 to keep the run's time with the DRF
# phases added
MN_PARITY_ROWS, MN_PARITY_ITERS = 100_000, 5
# graph against eager on the multinomial headline: repeated trainings of
# either path land on a few distinct loglosses, 8.45e-5 apart at most
# (B1's float sums decide near-tie splits whose gains agree to 1e-5; see
# tools/repeat_multinomial.py), so the two paths are held to 2e-4 here;
# the card test test_multinomial_graphs_bit_equal_to_eager holds them
# bit-equal on integer-valued targets
MN_PATH_TOL = 2e-4
PREDICT_ROWS = 1_000_000
CLAIMS_MONO = {"f0": 1, "f1": -1}
HEADLINE_AUC = 0.845338  # the unsampled headline's AUC since PR 1
# the DRF headline: H2O's DRF defaults (depth 20, min_rows 1, mtries -1 =
# sqrt(28) = 5 columns per split, sample_rate 0.632) on the Higgs-like frame
DRF_KW = dict(ntrees=50, max_depth=20, min_rows=1.0, mtries=-1,
              sample_rate=0.632, seed=42, score_tree_interval=5)
# card against CPU: the CPU's plain scans take ~10 s a depth-20 tree at
# 20k rows, so the pair is cut to these rows and trees
DRF_PARITY_ROWS, DRF_PARITY_TREES = 10_000, 3
DRF_MN_ITERS = 10  # multinomial DRF: 10 iterations = 70 class trees
GBM_SAMPLED = dict(sample_rate=0.8, col_sample_rate=0.8,
                   col_sample_rate_per_tree=0.8)


_LAST_EMIT = [time.perf_counter()]


def emit(obj: dict) -> None:
    """Print one phase line, with the seconds since the previous one."""
    now = time.perf_counter()
    if "phase" in obj:
        obj = {**obj, "phase_seconds": now - _LAST_EMIT[0]}
    _LAST_EMIT[0] = now
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
                                if "entry function" in ln or "Used" in ln
                                or "spill" in ln]
    return out


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call: ``reps`` calls captured in one CUDA
    graph and replayed between two events, with no host time between the
    launches. ``torch.profiler`` loses a short kernel's events at times
    (B2's at 1024 and 2048 nodes in every reading), so each kernel row
    carries this time beside the profiler's ``device_ms``."""
    fn()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def hist_row(label, bins, nid, stats, N, compaction=False) -> tuple:
    """B1 on ``(bins, nid, stats)`` against its plain version (both held to
    1e-5 of each cell's absolute mass against a float64 sum), its times,
    bound and one ``index_add_``'s time. Returns (row, the kernel's
    histogram) and, with ``compaction``, checks and times the compaction
    too (the row's ``compact`` entry)."""
    from h2o3_tpu_torch.ops.hist_cuda import (
        compact_cuda,
        compact_plain,
        hist_cuda,
        hist_plain,
    )
    from h2o3_tpu_torch.tools.bench_hist import device_ms, index_add_ms, time_ms

    n, C = bins.shape
    B, S = N_BINS, N_STATS
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
    row = {"kernel": "hist", "shape": label, "rows": n, "cols": C, "nodes": N,
           "active_rows": int((nid >= 0).sum()),
           "err_over_mass": rel, "plain_err_over_mass": rel_plain,
           "max_abs_err": (got - ref).abs().max().item(),
           "ms": time_ms(run, reps=20), "device_ms": device_ms(run),
           "graph_ms": graph_ms(run),
           "plain_ms": time_ms(lambda: hist_plain(bins, nid, stats, N, B),
                               reps=3, warmup=1),
           # yardstick: ONE index_add_ computing the same histogram
           "library_ms": index_add_ms(bins, nid, stats, N, B),
           "bound_ms": bnd, "bound_by": by}
    if compaction:
        cb, cby = bound_ms(4 * n + 4 * row["active_rows"] + 4 * (N + 1), 0)
        row["compact"] = {
            # offsets: |kernel - plain|; rows: positions differing
            "kernel": "hist_compact", "shape": label, "nodes": N,
            "max_abs_err": off_err, "rows_mismatched": mismatched,
            "ms": time_ms(lambda: compact_cuda(nid, N), reps=20),
            "device_ms": device_ms(lambda: compact_cuda(nid, N)),
            "graph_ms": graph_ms(lambda: compact_cuda(nid, N)),
            "plain_ms": time_ms(lambda: compact_plain(nid, N), reps=3,
                                warmup=1),
            # no single PyTorch call drops nid < 0 rows, groups the rest
            # by node and returns the offsets
            "library_ms": None, "bound_ms": cb, "bound_by": cby}
    return row, got


def split_row(got, N, label=None) -> tuple:
    """B2 on the histogram ``got`` against its plain version: gains within
    1e-5 of the fit scale they cancel, decisions equal or float near-ties;
    times and bound. Returns (row, node totals, gain scale, plain
    result)."""
    from h2o3_tpu_torch.ops.histogram import node_totals
    from h2o3_tpu_torch.ops.split_cuda import (
        split_candidates_cuda,
        split_candidates_plain,
    )
    from h2o3_tpu_torch.tools.bench_hist import device_ms, time_ms
    from h2o3_tpu_torch.tools.bench_split import split_bound

    C, B = got.shape[1], got.shape[2]
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
    sb, sby = split_bound(N, C, B, mono=False)
    row = {"kernel": "split", "nodes": N, "cols": C, "err_over_scale": gerr,
           "max_abs_err": (gk[0] - gp[0]).abs().max().item(),
           "decisions_differing_as_near_ties": n_diff,
           "ms": time_ms(lambda: split_candidates_cuda(got, tot, 10.0),
                         reps=50),
           "device_ms": device_ms(lambda: split_candidates_cuda(got, tot,
                                                                10.0)),
           "graph_ms": graph_ms(lambda: split_candidates_cuda(got, tot, 10.0)),
           "plain_ms": time_ms(lambda: split_candidates_plain(got, tot, 10.0),
                               reps=5, warmup=1),
           "library_ms": None, "bound_ms": sb, "bound_by": sby}
    if label is not None:
        row["shape"] = label
    return row, tot, scale, gp


def covtype_codes() -> torch.Tensor:
    """The (581,012, 54) u8 bin codes of the multinomial headline's frame,
    binned on the card as its training bins them."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import covtype_like
    from h2o3_tpu_torch.models.tree.binning import bin_frame, fit_bins

    fr = h2o3_tpu_torch.upload_file(covtype_like(MN_ROWS, seed=0),
                                    device="cuda")
    feats = [c for c in fr.names if c != "cover_type"]
    return bin_frame(fit_bins(fr, feats, seed=MN_KW["seed"]), fr)


def phase_kernels() -> tuple[dict, dict]:
    """Kernels against their plain versions; returns (phase line, per-kernel
    measurements for the kernels line)."""
    from h2o3_tpu_torch.models.tree.binning import bucket_cols
    from h2o3_tpu_torch.ops.hist_cuda import hist_cuda, hist_plain
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
        time_ms,
    )
    from h2o3_tpu_torch.tools.bench_split import mono_inputs, split_bound

    n, C, B = N_ROWS, N_COLS, N_BINS
    rows = []
    meas = {}
    for label, N, dead, seed in SHAPES:
        bins, nid, stats = hist_inputs(n, C, N, B, seed, dead)
        row, got = hist_row(label, bins, nid, stats, N,
                            compaction=label == "8")
        rows.append(row)
        if label == "8":
            meas["hist"] = row
            meas["hist_compact"] = row.pop("compact")
            rows.append(meas["hist_compact"])
        if label not in ("1", "8", "32"):
            continue

        # B2 on the kernel's histogram, at the main path's node counts
        srow, tot, scale, gp = split_row(got, N)
        rows.append(srow)

        # B3 on the same histogram: random directions, half the nodes bounded
        mono, lo, hi = mono_inputs(N, C, seed=100 + N)
        margs = (got, tot, 10.0, mono, lo, hi)
        mk = split_candidates_mono_cuda(*margs)
        mp = split_candidates_mono_plain(*margs)
        merr, m_diff = check_mono_split(*margs, mk, mp, scale)
        same = (mk[1] == mp[1]) & (mk[2] == mp[2])
        m_ms = time_ms(lambda: split_candidates_mono_cuda(*margs), reps=50)
        m_dev = device_ms(lambda: split_candidates_mono_cuda(*margs))
        m_graph = graph_ms(lambda: split_candidates_mono_cuda(*margs))
        m_plain = time_ms(lambda: split_candidates_mono_plain(*margs), reps=5,
                          warmup=1)
        mb, mby = split_bound(N, C, B, mono=True)
        rows.append({"kernel": "split_mono", "nodes": N,
                     "err_over_scale": merr,
                     "max_abs_err": torch.where(
                         same, (mk[0] - mp[0]).abs(), 0.0).max().item(),
                     "decisions_differing_as_near_ties": m_diff,
                     # (node, column) winners the mask moved away from B2's
                     "changed_by_mask": float(((mp[1] != gp[1])
                                               | (mp[2] != gp[2])).float()
                                              .mean()),
                     "ms": m_ms, "device_ms": m_dev, "graph_ms": m_graph,
                     "plain_ms": m_plain,
                     "library_ms": None,
                     "bound_ms": mb, "bound_by": mby})
        if N == 32:
            meas["split"] = srow
            meas["split_mono"] = rows[-1]

    # the multinomial headline's shape: Covertype's rows, its 54 columns
    # padded to bucket_cols(54) with all-NA columns (code 0) as the
    # whole-tree state pads them, 8 nodes; B1 on uniform codes, then on
    # the binned codes of the multinomial headline's own frame (one-hot
    # columns put every row in one of two bins)
    Cp = bucket_cols(MN_COLS)
    bins, nid, stats = hist_inputs(MN_ROWS, Cp, 8, B, seed=54)
    bins[:, MN_COLS:] = 0
    rows.append(hist_row("multinomial_8_uniform_codes", bins, nid, stats,
                         8)[0])
    bins[:, :MN_COLS] = covtype_codes()
    row, got = hist_row("multinomial_8", bins, nid, stats, 8, compaction=True)
    meas["hist_multinomial"] = row
    meas["hist_compact_multinomial"] = row.pop("compact")
    srow, _, _, _ = split_row(got, 8, label="multinomial_8")
    meas["split_multinomial"] = srow
    rows += [row, meas["hist_compact_multinomial"], srow]
    del bins, nid, stats, got

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
    edges = [split_edge_check(*case) for case in SPLIT_EDGES]
    return {"phase": "kernels", "rows": rows, "integer_exact": True,
            "few_active_bit_equal": few, "split_edges_bit_equal": edges}, meas


SPLIT_EDGES = (  # (nodes, columns, bins, min_rows)
    (8, 13, 257, 10.0), (8, 13, 129, 10.0), (8, 13, 33, 10.0),
    (8, 13, 4, 10.0), (8, 13, 3, 10.0),
    (8, 13, 256, 1e9),      # no feasible candidate anywhere
    (8, 13, 256, 0.0),      # empty children allowed
    (2048, 13, 256, 10.0),  # the widest frontier (node_cap)
)


def split_edge_check(N, C, B, min_rows) -> dict:
    """B2 and B3 bit-equal to their plain versions on integer stats at an
    edge of their geometry or feasibility. Their outputs come from one
    torch.empty buffer, so the caching allocator is first handed a block of
    that size full of NaNs: an element the kernel left unwritten shows."""
    from h2o3_tpu_torch.ops.hist_cuda import hist_plain
    from h2o3_tpu_torch.ops.split_cuda import (
        output_layout,
        split_candidates_cuda,
        split_candidates_mono_cuda,
        split_candidates_mono_plain,
        split_candidates_plain,
    )
    from h2o3_tpu_torch.tools.bench_split import mono_inputs

    n = 200_000
    rng = np.random.default_rng(N + B)
    dev = torch.device("cuda")
    codes, nid, stats = (torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, B, (n, C)).astype(np.int32),  # codes up to 256
        rng.integers(0, N, n).astype(np.int32),
        np.stack([np.ones(n), rng.integers(-3, 4, n), rng.integers(1, 4, n)],
                 1).astype(np.float32)))
    h = hist_plain(codes, nid, stats, N, B)
    tot = h[:, 0].sum(dim=1)
    margs = (h, tot, min_rows, *mono_inputs(N, C, seed=B, integer=True))
    nan_floats = -(-output_layout(N, C)[1] // 4)
    out = {"nodes": N, "cols": C, "bins": B, "min_rows": min_rows}
    for name, kernel, plain, a in (
            ("split", split_candidates_cuda, split_candidates_plain,
             margs[:3]),
            ("split_mono", split_candidates_mono_cuda,
             split_candidates_mono_plain, margs)):
        torch.full((nan_floats,), float("nan"), device=dev)  # freed at once
        got = kernel(*a)
        if not all(torch.equal(x, y) for x, y in zip(got, plain(*a))):
            raise AssertionError(f"{name}: N={N} C={C} B={B} min_rows="
                                 f"{min_rows} not bit-equal")
        out[f"{name}_feasible_pairs"] = int((got[0] > -1e29).sum())
    return out


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


def counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before and read
    just after. Returns ``(fn's result, {kernel: launches on the card},
    {kernel: launches of the warm-up runs of graphs captured meanwhile})``
    under the names of the kernels line."""
    from h2o3_tpu_torch.models.tree import shared_tree as pst
    from h2o3_tpu_torch.ops import cuda_graph

    names = {"hist_cuda": "hist", "compact_cuda": "hist_compact",
             "split_candidates_cuda": "split",
             "split_candidates_mono_cuda": "split_mono"}
    for f in cuda_graph.counters():
        f.launches = 0
    warm0 = dict(pst.GRAPH_EVENTS["warmup_launches"])
    out = fn()
    torch.cuda.synchronize()
    counts = {names[k]: v for k, v in cuda_graph.snapshot().items()}
    warm = {names[k]: v - warm0.get(k, 0)
            for k, v in pst.GRAPH_EVENTS["warmup_launches"].items()}
    return out, counts, {k: warm.get(k, 0) for k in counts}


# the kernel whose events in a trace count one launch of each wrapper
KERNEL_EVENTS = {"hist": "b1_hist_tile", "hist_compact": "b1_compact_scatter",
                 "split": "split_kernel<false>",
                 "split_mono": "split_kernel<true>"}


def traced_launches(fn, what: str) -> tuple[dict, dict]:
    """Run ``fn``, a training whose graphs are already captured, under
    ``torch.profiler`` with the counters zeroed (:func:`counted`), and hold
    each counter against the events of its kernel in the card's trace:
    kernels inside a graph replay appear there one by one, so equal counts
    show the replays launched what the counters claim. The profiler has
    lost a short kernel's events before (PERF.md), so a trace that
    disagrees is taken once more; a graph that lacks a kernel disagrees
    both times. Returns the counts and the trace's summary: wall seconds,
    device-busy seconds (every kernel's and memset's self time), the idle
    share, the host seconds of the GBM's ``gbm.*`` spans and the device
    ms of the busiest kernels."""
    from h2o3_tpu_torch.models.tree import shared_tree as pst

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        caps = pst.GRAPH_EVENTS["captures"]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            _, counts, _ = counted(fn)
            wall = time.perf_counter() - t0
        if pst.GRAPH_EVENTS["captures"] != caps:
            raise AssertionError(f"{what}: the traced training captured")
        traced = dict.fromkeys(KERNEL_EVENTS, 0)
        busy_ms, spans, by_kernel, widths = 0.0, {}, {}, {}
        for evt in prof.key_averages():
            if evt.key.startswith("tree."):
                # the tree builder's width spans: their device twin spans
                # the kernels launched inside (graph replays included)
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    widths[evt.key] = evt.device_time_total / 1e3
                continue
            if evt.key.startswith(("gbm.", "drf.")):  # the host span
                spans[evt.key] = max(spans.get(evt.key, 0.0),
                                     evt.cpu_time_total / 1e6)
            elif evt.device_type == torch.autograd.DeviceType.CUDA:
                busy_ms += evt.self_device_time_total / 1e3
                by_kernel[evt.key[:60]] = (by_kernel.get(evt.key[:60], 0.0)
                                           + evt.self_device_time_total / 1e3)
                for k, sym in KERNEL_EVENTS.items():
                    traced[k] += evt.count if sym in evt.key else 0
        if traced == counts:
            top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
            return counts, {"traced_wall_s": wall,
                            "device_busy_s": busy_ms / 1e3,
                            "device_idle_share": 1 - busy_ms / 1e3 / wall,
                            "host_spans_s": spans,
                            "width_spans_device_ms": widths,
                            "top_kernels_ms": dict(top)}
    raise AssertionError(f"{what}: counters {counts}, trace {traced}")


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


@contextlib.contextmanager
def whole_tree(mode: str):
    """``H2O3_TPU_WHOLE_TREE`` set to ``mode`` (1: graph replay, 0: the
    eager per-level loop) for the block."""
    knob = os.environ.get("H2O3_TPU_WHOLE_TREE")
    os.environ["H2O3_TPU_WHOLE_TREE"] = mode
    try:
        yield
    finally:
        if knob is None:
            os.environ.pop("H2O3_TPU_WHOLE_TREE", None)
        else:
            os.environ["H2O3_TPU_WHOLE_TREE"] = knob


def fit(est_cls, fr, y, **kw):
    """(estimator, seconds) of one training on ``fr``, to the card's end."""
    est = est_cls(**kw)
    if fr.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.train(y=y, training_frame=fr)
    if fr.device.type == "cuda":
        torch.cuda.synchronize()
    return est, time.perf_counter() - t0


def phase_main() -> tuple[dict, tuple]:
    """The headline; returns its line and (estimator, pandas frame, card
    frame) for the export phase."""
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.models import metrics as MM

    df = higgs_like(N_ROWS, N_COLS, seed=0)

    def run():
        est, fr, seconds = train(df, "cuda")
        return est, fr, seconds, est.predict(fr).vec("s").data

    (est, fr, seconds, p1), launches, warm = counted(run)
    replayed = {k: launches[k] - warm[k] for k in launches}
    trees = [g[0] for g in est.model.output["trees"]]
    # per tree: a histogram (one compaction each) and a split scan at every
    # level but the last, whose leaves come from the parents' child stats
    levels = sum(len(t.levels) - 1 for t in trees)
    expect = GBM_KW["ntrees"] * GBM_KW["max_depth"]
    if not (levels == expect and replayed["split_mono"] == 0 and all(
            replayed[k] == expect for k in ("hist", "hist_compact", "split"))):
        raise AssertionError(f"launches {launches}, warm-up {warm} vs "
                             f"{levels} split levels")
    traced, _ = traced_launches(lambda: train(df, "cuda"), "main")
    if traced != {**replayed, "split_mono": 0}:
        raise AssertionError(f"main: traced {traced}, replayed {replayed}")
    if p1.shape != (N_ROWS,) or not bool(torch.isfinite(p1).all()):
        raise AssertionError("predictions not finite or of the wrong shape")
    y = (df["label"].to_numpy() == "s").astype(np.float64)
    auc_pred = MM.binomial_metrics(y, p1)._v["auc"]  # device statistics
    auc_exact = MM.binomial_metrics(y, p1.double().cpu().numpy())._v["auc"]
    auc = est.auc()
    if not (abs(auc_pred - auc) < 1e-4 and abs(auc - HEADLINE_AUC) <= 1e-5
            and abs(auc_pred - auc_exact) <= 1e-3):
        raise AssertionError(f"auc {auc} vs replayed {auc_pred}, exact "
                             f"{auc_exact}")
    return {"phase": "main", "rows": N_ROWS, "cols": N_COLS, **GBM_KW,
            "train_seconds": seconds, "trees_per_sec": GBM_KW["ntrees"] / seconds,
            "auc": auc, "auc_from_predict": auc_pred,
            "auc_exact_host": auc_exact,
            "auc_device_minus_exact": auc_pred - auc_exact, "levels": levels,
            "launches": launches, "warmup_launches": warm,
            "replayed_launches": replayed, "traced_launches": traced,
            "scoring_history": est.model.scoring_history}, (est, df, fr)


def phase_whole_tree() -> dict:
    """The headline by the eager per-level loop and by graph replay, in
    turns (eager, graph, eager, graph) in one process; the second of each
    is the warm figure."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.models.tree import shared_tree as pst

    fr = h2o3_tpu_torch.upload_file(higgs_like(N_ROWS, N_COLS, seed=0),
                                    device="cuda")
    runs, captures = {}, []
    for mode in ("0", "1", "0", "1"):
        with whole_tree(mode):
            runs.setdefault(mode, []).append(fit(
                H2OGradientBoostingEstimator, fr, "label", **GBM_KW))
        if mode == "1":
            captures.append(pst.GRAPH_EVENTS["captures"])
    (g, g_s), (e, e_s) = runs["1"][-1], runs["0"][-1]
    dauc = abs(g.auc() - e.auc())
    sg = split_nodes(g.model.output["trees"][0][0])
    se = split_nodes(e.model.output["trees"][0][0])
    if not (dauc <= 1e-5 and sg == se and captures[1] == captures[0]):
        raise AssertionError(f"whole_tree: auc delta {dauc}, tree-0 splits "
                             f"equal={sg == se}, captures {captures}")
    (graphs,) = [st for st in pst.graph_stats()
                 if (st["rows"], st["depth"]) == (N_ROWS, GBM_KW["max_depth"])
                 and st["replay_launches"].get("split_candidates_cuda")]
    return {"phase": "whole_tree", "rows": N_ROWS, "cols": N_COLS, **GBM_KW,
            "graph_seconds": g_s, "graph_trees_per_sec": GBM_KW["ntrees"] / g_s,
            "eager_seconds": e_s, "eager_trees_per_sec": GBM_KW["ntrees"] / e_s,
            "cold_seconds": {m: [r[1] for r in v] for m, v in runs.items()},
            "auc_graph": g.auc(), "auc_eager": e.auc(), "auc_delta": dauc,
            "tree0_split_nodes": len(sg), "tree0_splits_equal": sg == se,
            "captures_total": captures[-1], "graphs": graphs}


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
    never (less the capture's warm-up tree, ntrees x max_depth launches
    inside replays)."""

    def run():
        est, fr, seconds = train(df, "cuda", y=y,
                                 monotone_constraints=constraints, **kw)
        return est, seconds, est.predict(fr).vec(pred_col).data

    (est, seconds, p), launches, warm = counted(run)
    replayed = {k: launches[k] - warm[k] for k in launches}
    levels = sum(len(g[0].levels) - 1 for g in est.model.output["trees"])
    expect = GBM_KW["ntrees"] * GBM_KW["max_depth"]
    if not (replayed["split_mono"] == replayed["hist"] == levels == expect
            and launches["split"] == 0):
        raise AssertionError(f"mono launches {launches}, warm-up {warm} vs "
                             f"{levels} levels")
    traced, _ = traced_launches(lambda: train(
        df, "cuda", y=y, monotone_constraints=constraints, **kw), "mono")
    if traced != {**replayed, "split": 0}:
        raise AssertionError(f"mono: traced {traced}, replayed {replayed}")
    if p.shape != (len(df),) or not bool(torch.isfinite(p).all()):
        raise AssertionError("predictions not finite or of the wrong shape")
    probe = monotone_probe(est, df, constraints, pred_col)
    return est, seconds, launches, levels, probe, warm, traced


def phase_mono() -> tuple[list[dict], tuple[dict, dict]]:
    from h2o3_tpu_torch.datasets import claims_like, higgs_like

    df = higgs_like(N_ROWS, N_COLS, seed=0)
    est, seconds, launches, levels, probe, warm, traced = mono_run(
        df, "label", MONO, "s")
    auc = est.auc()
    if not auc > 0.7:
        raise AssertionError(f"constrained headline auc {auc}")
    out = [{"phase": "mono", "rows": N_ROWS, "cols": N_COLS, **GBM_KW,
            "monotone_constraints": MONO, "train_seconds": seconds,
            "trees_per_sec": GBM_KW["ntrees"] / seconds, "auc": auc,
            "levels": levels, "launches": launches, "warmup_launches": warm,
            "traced_launches": traced, "probe_worst_step": probe}]
    del df
    cf = claims_like(N_ROWS, N_COLS, seed=0)
    est, seconds, launches_t, levels, probe, warm_t, traced_t = mono_run(
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
                "launches": launches_t, "warmup_launches": warm_t,
                "traced_launches": traced_t, "probe_worst_step": probe})
    return out, (launches, warm)


def strong_splits(tree) -> list:
    """Per level, the sorted columns of the real split nodes with a gain of
    1 or more: smaller gains are rounding noise in label-pure nodes, where
    the last bits of B1's float sums decide whether a node splits."""
    host = tree.to_host()
    return [sorted(lv.split_col[~lv.leaf_now & m & (lv.gain >= 1.0)].tolist())
            for lv, m in zip(host.levels, tree.real_level_masks())]


def phase_multinomial() -> tuple[dict, tuple]:
    """The multinomial headline at full width: 581,012 x 54, 7 classes, 20
    iterations (140 class trees) at depth 6, by the eager control and by
    graph replay in turns (eager, graph, eager, graph) in one process; the
    graph training that captures is counted (840 launches of B1, its
    compaction and B2 inside replays, plus the warm-up tree's), a third
    graph training is traced and must show as many kernel events; the
    device-stats multinomial metrics against the exact host metrics of the
    same probabilities. Returns the line and (estimator, pandas frame, card
    frame) for the export phase."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import covtype_like
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.models import metrics as MM
    from h2o3_tpu_torch.models.tree import shared_tree as pst

    df = covtype_like(MN_ROWS, seed=0)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    if fr.ncol != MN_COLS + 1 or fr.vec("cover_type").cardinality != MN_CLASSES:
        raise AssertionError(f"covtype_like: {fr.ncol} columns")

    def run():
        return fit(H2OGradientBoostingEstimator, fr, "cover_type", **MN_KW)

    runs, counts = {}, None
    for mode in ("0", "1", "0", "1"):
        with whole_tree(mode):
            if mode == "1" and counts is None:  # the capturing training
                (est, s), launches, warm = counted(run)
                counts = (launches, warm, pst.GRAPH_EVENTS["captures"])
            else:
                est, s = run()
        runs.setdefault(mode, []).append((est, s))
    caps_after = pst.GRAPH_EVENTS["captures"]
    with whole_tree("1"):
        traced, trace = traced_launches(run, "multinomial")
    launches, warm, caps = counts
    replayed = {k: launches[k] - warm[k] for k in launches}
    (g, g_s), (e, e_s) = runs["1"][-1], runs["0"][-1]
    trees = g.model.output["trees"]
    class_trees = MN_KW["ntrees"] * MN_CLASSES
    expect = class_trees * MN_KW["max_depth"]
    if not (len(trees) == MN_KW["ntrees"]
            and all(len(grp) == MN_CLASSES for grp in trees)
            and replayed["split_mono"] == 0 and all(
                replayed[k] == expect
                for k in ("hist", "hist_compact", "split"))):
        raise AssertionError(f"multinomial launches {launches}, warm-up "
                             f"{warm} vs {expect}")
    if traced != {**replayed, "split_mono": 0} or caps_after != caps:
        raise AssertionError(f"multinomial: traced {traced}, replayed "
                             f"{replayed}, captures {caps} -> {caps_after}")
    dll = abs(g.logloss() - e.logloss())
    sg = strong_splits(trees[0][0])
    se = strong_splits(e.model.output["trees"][0][0])
    if not (dll <= MN_PATH_TOL and sg == se and sg[0]):
        raise AssertionError(f"multinomial: logloss delta {dll}, class tree "
                             f"(0, 0) strong splits equal={sg == se}")
    # device-stats metrics of the predictions against the exact host ones
    probs = torch.stack([g.predict(fr).vec(str(k)).data
                         for k in range(1, MN_CLASSES + 1)], dim=1)
    if probs.shape != (MN_ROWS, MN_CLASSES) or not bool(
            torch.isfinite(probs).all()):
        raise AssertionError("multinomial predictions not finite or of the "
                             "wrong shape")
    y = fr.vec("cover_type").data
    dm = MM.multinomial_metrics(y, probs)  # device statistics
    hm = MM.multinomial_metrics(y.cpu().numpy(), probs.cpu().numpy())
    if not (abs(dm.logloss - hm.logloss) <= 1e-6
            and np.array_equal(dm.confusion_matrix, hm.confusion_matrix)
            and abs(dm.logloss - g.logloss()) < 1e-3):
        raise AssertionError(f"multinomial metrics: device {dm}, host {hm}")
    (graphs,) = [st for st in pst.graph_stats()
                 if (st["rows"], st["classes"]) == (MN_ROWS, MN_CLASSES)]
    return {"phase": "multinomial", "rows": MN_ROWS, "cols": MN_COLS,
            "classes": MN_CLASSES, **MN_KW,
            "graph_seconds": g_s,
            "iterations_per_sec": MN_KW["ntrees"] / g_s,
            "class_trees_per_sec": class_trees / g_s,
            "eager_seconds": e_s,
            "eager_class_trees_per_sec": class_trees / e_s,
            "cold_seconds": {m: [r[1] for r in v] for m, v in runs.items()},
            "logloss_graph": g.logloss(), "logloss_eager": e.logloss(),
            "logloss_delta": dll, "logloss_tolerance": MN_PATH_TOL,
            # every run, in order: B1's float sums vary run to run
            "logloss_runs": {m: [r[0].logloss() for r in v]
                             for m, v in runs.items()},
            "classification_error": g.model.training_metrics.value(
                "classification_error"),
            "tree00_strong_splits": sum(map(len, sg)),
            "tree00_splits_equal": sg == se,
            "device_logloss": dm.logloss, "host_logloss": hm.logloss,
            "confusion_matrix_equal": True,
            "hit_ratios": dm.hit_ratios,
            "launches": launches, "warmup_launches": warm,
            "replayed_launches": replayed, "traced_launches": traced,
            "trace": trace, "graphs": graphs,
            "scoring_history": g.model.scoring_history}, (g, df, fr)


def phase_multinomial_parity(df) -> dict:
    """The multinomial GBM on the first 100k rows of the same frame, on the
    card and on the CPU (plain versions), 5 iterations (35 class trees):
    logloss within 1e-3 relative, classification error within 1e-3."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    sub = df.iloc[:MN_PARITY_ROWS]
    out = {}
    for dev in ("cuda", "cpu"):
        fr = h2o3_tpu_torch.upload_file(sub, device=dev)
        est = H2OGradientBoostingEstimator(**{**MN_KW,
                                              "ntrees": MN_PARITY_ITERS})
        t0 = time.perf_counter()
        est.train(y="cover_type", training_frame=fr)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = (est.model.training_metrics, time.perf_counter() - t0)
    (g, g_s), (c, c_s) = out["cuda"], out["cpu"]
    rel = abs(g.logloss - c.logloss) / c.logloss
    derr = abs(g.classification_error - c.classification_error)
    if not (rel <= 1e-3 and derr <= 1e-3):
        raise AssertionError(f"multinomial_parity: logloss {g.logloss} vs "
                             f"{c.logloss}, error {g.classification_error} "
                             f"vs {c.classification_error}")
    return {"phase": "multinomial_parity", "rows": MN_PARITY_ROWS,
            "iterations": MN_PARITY_ITERS, "logloss_cuda": g.logloss,
            "logloss_cpu": c.logloss, "logloss_rel_delta": rel,
            "error_cuda": g.classification_error,
            "error_cpu": c.classification_error, "error_delta": derr,
            "cuda_seconds": g_s, "cpu_seconds": c_s}


def warm_predict_seconds(est, fr) -> float:
    """The second of two ``predict`` calls on ``fr``, to the card's end."""
    est.predict(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.predict(fr)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_export(binomial, multinomial) -> dict:
    """The binomial and the multinomial headline models exported with
    ``download_mojo``, loaded with the port's own offline scorer
    (``h2o3_tpu_torch.genmodel``, numpy only) and scored on the first 100k
    rows of their pandas frames: probabilities within 1e-5 of the model's
    own ``predict``; the binomial model's ``export_pojo`` file run in a
    subprocess on 1,000 rows, within 1e-5 too. Also times a warm
    ``predict`` of each model on 1M rows on the card."""
    import io
    import shutil

    import pandas as pd

    import h2o3_tpu_torch
    from h2o3_tpu_torch import genmodel
    from h2o3_tpu_torch.datasets import covtype_like
    from h2o3_tpu_torch.models.export import export_pojo
    from h2o3_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "smoke_export"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    n_score = 100_000
    line = {"phase": "export", "scored_rows": n_score}
    for name, (est, df, fr), y, classes in (
            ("binomial", binomial, "label", ("b", "s")),
            ("multinomial", multinomial, "cover_type",
             tuple(str(k) for k in range(1, MN_CLASSES + 1)))):
        t0 = time.perf_counter()
        path = est.download_mojo(str(out_dir))
        export_s = time.perf_counter() - t0
        if path != os.path.join(str(out_dir), f"{est.model_id}.zip"):
            raise AssertionError(f"export {name}: wrote {path}")
        t0 = time.perf_counter()
        mojo = genmodel.MojoModel.load(path)
        scored = mojo.predict(df.drop(columns=y).iloc[:n_score])
        score_s = time.perf_counter() - t0
        pred = est.predict(fr)
        want = np.stack([pred.vec(c).data[:n_score].double().cpu().numpy()
                         for c in classes], 1)
        got = np.stack([scored[c] for c in classes], 1)
        err = float(np.abs(got - want).max())
        labels = pred.vec("predict").data[:n_score].long().cpu().numpy()
        # a label may differ only where the scorer's float64 sums and the
        # card's float32 ones straddle the decision: within 1e-5 of the
        # max-F1 threshold (binomial) or of a tie between two classes
        if len(classes) == 2:
            margin = np.abs(got[:, 1] - mojo.meta["default_threshold"])
        else:
            top2 = np.sort(got, axis=1)[:, -2:]
            margin = top2[:, 1] - top2[:, 0]
        same = scored["predict"] == np.asarray(classes, object)[labels]
        agree = float(same.mean())
        if not (err <= 1e-5 and same[margin > 1e-5].all()):
            raise AssertionError(f"export {name}: max |mojo - predict| "
                                 f"{err}, labels agreeing {agree}")
        line[name] = {"export_seconds": export_s,
                      "artifact_bytes": os.path.getsize(path),
                      "load_and_score_seconds": score_s,
                      "max_abs_err": err, "labels_agree": agree,
                      "rows_within_1e-5_of_a_decision": int(
                          (margin <= 1e-5).sum()),
                      "trees": sum(len(g) for g in
                                   est.model.output["trees"])}
    # the single-file scorer in a fresh interpreter
    est, df, fr = binomial
    t0 = time.perf_counter()
    src = export_pojo(est.model, str(out_dir / "headline_pojo.py"))
    pojo_export_s = time.perf_counter() - t0
    csv = out_dir / "rows.csv"
    df.drop(columns="label").iloc[:1000].to_csv(csv, index=False)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, src, str(csv)], capture_output=True,
                       text=True, timeout=300, cwd=str(out_dir))
    pojo_run_s = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"export_pojo run failed: {r.stderr[-2000:]}")
    got = pd.read_csv(io.StringIO(r.stdout))["s"].to_numpy()
    want = est.predict(fr).vec("s").data[:1000].double().cpu().numpy()
    perr = float(np.abs(got - want).max())
    if not perr <= 1e-5:
        raise AssertionError(f"export_pojo: max |pojo - predict| {perr}")
    line["pojo"] = {"export_seconds": pojo_export_s,
                    "file_bytes": os.path.getsize(src), "rows": 1000,
                    "run_seconds": pojo_run_s, "max_abs_err": perr}
    # a warm predict at 1M rows: the headline's own frame, and a 1M-row
    # Covertype-shaped frame for the multinomial model
    line["predict_1m_binomial_seconds"] = warm_predict_seconds(est, fr)
    big = h2o3_tpu_torch.upload_file(covtype_like(PREDICT_ROWS, seed=1),
                                     device="cuda")
    line["predict_1m_multinomial_seconds"] = warm_predict_seconds(
        multinomial[0], big)
    shutil.rmtree(out_dir, ignore_errors=True)
    return line


def forest_diff(a, b) -> int:
    """Class trees whose records differ between two models of one forest:
    every replay field of every level up to the first that split nothing,
    and every later level of either all-leaf and zero-valued (past that
    level the graph path records JAX's placeholders, and the eager loop on
    the card, which reads ``n_split`` only at depth 8, 12, ..., records the
    dead levels it ran as computed, or stops)."""
    from h2o3_tpu_torch.models.tree.shared_tree import REPLAY_FIELDS

    diff = 0
    for ga, gb in zip(a.model.output["trees"], b.model.output["trees"]):
        for ta, tb in zip(ga, gb):
            la, lb = ta.to_host().levels, tb.to_host().levels
            dead = next((i for i, lv in enumerate(la) if lv.leaf_now.all()),
                        len(la) - 1)
            same = len(lb) > dead and all(
                np.array_equal(getattr(x, f), getattr(z, f))
                for x, z in zip(la[: dead + 1], lb) for f in REPLAY_FIELDS)
            same &= all(lv.leaf_now.all() and not lv.leaf_val.any()
                        for lv in la[dead + 1:] + lb[dead + 1:])
            diff += not same
    if len(a.model.output["trees"]) != len(b.model.output["trees"]):
        diff += 1
    return diff


def plan_stats(rows, depth, classes=1):
    """The cached whole-tree plan of this shape, or None."""
    from h2o3_tpu_torch.models.tree import shared_tree as pst

    found = [s for s in pst.graph_stats() if (s["rows"], s["depth"],
                                              s["classes"]) == (rows, depth,
                                                                classes)]
    return found[-1] if found else None


def phase_drf() -> tuple[dict, tuple]:
    """The slice's headline: binomial DRF at H2O's defaults on the 1M x 28
    Higgs-like frame, 50 trees of depth 20 (levels 11-19 on the saturated-
    level graph at 2048 nodes). A first training captures (counted), a
    second is the warm figure, a third is traced (its kernel events equal
    to the first's replay-counted launches), and the eager control
    trains in the same process: graph and eager records equal in every
    split of every tree (0/1 targets and bootstrap weights make every
    histogram sum exact). Returns the line and (estimator, pandas frame,
    card frame) for the export and wide-kernel phases."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.models import metrics as MM
    from h2o3_tpu_torch.models.tree import shared_tree as pst

    df = higgs_like(N_ROWS, N_COLS, seed=0)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")

    def run():
        return fit(H2ORandomForestEstimator, fr, "label", **DRF_KW)

    with whole_tree("1"):
        (cold, cold_s), launches, warm = counted(run)
        caps = pst.GRAPH_EVENTS["captures"]
        before = plan_stats(N_ROWS, DRF_KW["max_depth"])
        g, g_s = run()
        after = plan_stats(N_ROWS, DRF_KW["max_depth"])
        traced, trace = traced_launches(run, "drf")
    with whole_tree("0"):
        e, e_s = run()
    replayed = {k: launches[k] - warm[k] for k in launches}
    if traced != {**replayed, "split_mono": 0} or replayed["hist"] == 0:
        raise AssertionError(f"drf: traced {traced}, replayed {replayed}")
    if pst.GRAPH_EVENTS["captures"] != caps or after is None:
        raise AssertionError("drf: the warm trainings captured again, or "
                             "the plan left the cache")
    n_diff = forest_diff(g, e)
    if n_diff or forest_diff(g, cold):
        raise AssertionError(f"drf: {n_diff} of {DRF_KW['ntrees']} trees "
                             "differ between graph and eager")
    # B1 launches on the saturated-level graph in the warm training
    names = after["graph_names"]
    si = names.index("saturated_level")
    sat_replays = after["replays"][si] - before["replays"][si]
    sat_b1 = after["graph_launches"][si].get("hist_cuda", 0) * sat_replays
    p1 = g.predict(fr).vec("s").data
    if p1.shape != (N_ROWS,) or not bool(torch.isfinite(p1).all()):
        raise AssertionError("drf predictions not finite or of the wrong "
                             "shape")
    y = (df["label"].to_numpy() == "s").astype(np.float64)
    auc_pred = MM.binomial_metrics(y, p1)._v["auc"]
    auc = g.auc()
    if not (auc > 0.8 and abs(auc - auc_pred) <= 1e-3
            and abs(auc - e.auc()) <= 1e-9):
        raise AssertionError(f"drf: auc {auc}, from predict {auc_pred}, "
                             f"eager {e.auc()}")
    budget = pst._GRAPH_CACHE_SHARE * torch.cuda.get_device_properties(
        0).total_memory
    nt = DRF_KW["ntrees"]
    return {"phase": "drf", "rows": N_ROWS, "cols": N_COLS, **DRF_KW,
            "mtries_resolved": int(np.sqrt(N_COLS)),
            "first_seconds": cold_s, "graph_seconds": g_s,
            "graph_trees_per_sec": nt / g_s, "eager_seconds": e_s,
            "eager_trees_per_sec": nt / e_s, "auc": auc,
            "auc_from_predict": auc_pred, "auc_eager": e.auc(),
            "trees_differing_graph_eager": n_diff,
            "levels_recorded": sum(len(t[0].levels)
                                   for t in g.model.output["trees"]),
            "launches": launches, "warmup_launches": warm,
            "replayed_launches": replayed, "traced_launches": traced,
            "saturated_replays_warm": sat_replays,
            "saturated_b1_launches_warm": sat_b1,
            "trace": trace, "graphs": after,
            "plan_cached": True, "cache_budget_bytes": budget,
            "retained_over_budget": after["retained_bytes"] / budget,
            "scoring_history": g.model.scoring_history}, (g, df, fr)


def phase_drf_parity() -> dict:
    """DRF on the card against the CPU's plain versions, binomial
    (Higgs-like) and regression (claims-like), cut to DRF_PARITY_ROWS rows
    and DRF_PARITY_TREES trees. Both sides draw the same masks: the keyed
    draws of the bootstrap and of the per-split and per-tree columns are
    held bit-equal between the card and the CPU first, at the headline's
    widths. Then per pair: the card's trees equal the CPU's up to the
    first node where they part, and that node is a float near-tie
    (:func:`divergences`); the card's trees scored on the CPU give the
    card's training metric within 1e-3 (AUC) or 1e-3 relative (RMSE); and
    the two trainings' metrics agree, AUC within 1e-3 and RMSE within 2e-2
    relative. A near-tie in a depth-20 tree of a heavy-tailed target moves
    a whole subtree, and the training RMSE of 3 trees with it: over four
    cuts (10k x 3, 5k x 8, 30k x 3, 50k x 2 trees) card and CPU trainings
    differed by 2.1e-4 to 7.9e-3 relative (8.4e-3 on a held-out frame),
    the binomial AUC by 1.2e-6 to 3.2e-4."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import claims_like, higgs_like
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.models.tree import sampling
    from h2o3_tpu_torch.tools.tree_parity import NEAR_TIE, divergences

    key = sampling.seed_key(DRF_KW["seed"])
    rows = [sampling.index_hash(N_ROWS, d) for d in ("cuda", "cpu")]
    cols = [sampling.index_hash(2048 * N_COLS, d) for d in ("cuda", "cpu")]
    for it in range(5):
        a, b = (sampling.row_mask(key, it, 0.632, h) for h in rows)
        if not torch.equal(a.cpu(), b):
            raise AssertionError("row masks differ between card and CPU")
        for k in range(7):
            tk = [sampling.split_key(torch.tensor([key], device=d),
                                     torch.tensor([it], device=d), k)
                  for d in ("cuda", "cpu")]
            for depth in (0, 11, 19):
                c, d_ = (sampling.split_cols(t, depth, 5 / 28, 2048, N_COLS,
                                             h) for t, h in zip(tk, cols))
                if not torch.equal(c.cpu(), d_):
                    raise AssertionError("split-column masks differ "
                                         "between card and CPU")
            tc = [sampling.tree_cols(key, it, k, 0.5, N_COLS, h)
                  for h in cols]
            if not torch.equal(tc[0].cpu(), tc[1]):
                raise AssertionError("tree-column masks differ")
    out = {"phase": "drf_parity", "rows": DRF_PARITY_ROWS,
           "trees": DRF_PARITY_TREES,
           "cut": f"{DRF_PARITY_ROWS} rows and {DRF_PARITY_TREES} trees "
                  f"of the headline's {N_ROWS} and {DRF_KW['ntrees']}",
           "masks_bit_equal": True, "mask_iterations_checked": 5,
           "near_tie": NEAR_TIE}
    kw = {**DRF_KW, "ntrees": DRF_PARITY_TREES}
    for name, make, y, metric, tol in (
            ("binomial", higgs_like, "label", "auc", 1e-3),
            ("regression", claims_like, "claim", "rmse", 2e-2)):
        df = make(DRF_PARITY_ROWS, N_COLS, seed=1)
        got = {}
        for dev in ("cuda", "cpu"):
            fr = h2o3_tpu_torch.upload_file(df, device=dev)
            got[dev] = (*fit(H2ORandomForestEstimator, fr, y, **kw), fr)
        (g, g_s, _), (c, c_s, cpu_fr) = got["cuda"], got["cpu"]
        parting = divergences(g, c, boosted=False)
        gm, cm = g._metric(metric), c._metric(metric)
        on_cpu = g.model.model_performance(cpu_fr).value(metric)
        rel = 1.0 if metric == "auc" else cm
        delta, delta_own = abs(gm - cm) / rel, abs(gm - on_cpu) / rel
        if not (delta <= tol and delta_own <= 1e-3):
            raise AssertionError(f"drf_parity {name}: {metric} {gm} (card), "
                                 f"{cm} (CPU), {on_cpu} (card's trees on "
                                 "the CPU)")
        out[name] = {f"{metric}_cuda": gm, f"{metric}_cpu": cm,
                     "delta" if metric == "auc" else "rel_delta": delta,
                     "tolerance": tol,
                     f"{metric}_card_trees_on_cpu": on_cpu,
                     "card_trees_on_cpu_delta": delta_own, **parting,
                     "cuda_seconds": g_s, "cpu_seconds": c_s}
    return out


def phase_drf_multinomial() -> dict:
    """Multinomial DRF on the Covertype-shaped frame (581,012 x 54, 7
    classes) at depth 20, cut to DRF_MN_ITERS iterations (70 class trees):
    a capturing and a warm training by graph replay and the eager control
    in one process, training logloss of graph against eager within
    MN_PATH_TOL."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import covtype_like
    from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
    from h2o3_tpu_torch.models.tree import shared_tree as pst

    fr = h2o3_tpu_torch.upload_file(covtype_like(MN_ROWS, seed=0),
                                    device="cuda")
    kw = {**DRF_KW, "ntrees": DRF_MN_ITERS}

    def run():
        return fit(H2ORandomForestEstimator, fr, "cover_type", **kw)

    with whole_tree("1"):
        (cold, cold_s), launches, warm = counted(run)
        g, g_s = run()
        capture = pst.GRAPH_EVENTS["last_capture"]
        cached = plan_stats(MN_ROWS, DRF_KW["max_depth"], MN_CLASSES)
    with whole_tree("0"):
        e, e_s = run()
    dll = abs(g.logloss() - e.logloss())
    class_trees = DRF_MN_ITERS * MN_CLASSES
    if not (dll <= MN_PATH_TOL and np.isfinite(g.logloss())
            and len(g.model.output["trees"]) == DRF_MN_ITERS):
        raise AssertionError(f"drf_multinomial: logloss {g.logloss()} vs "
                             f"eager {e.logloss()}")
    return {"phase": "drf_multinomial", "rows": MN_ROWS, "cols": MN_COLS,
            "classes": MN_CLASSES, **kw,
            "cut": f"{DRF_MN_ITERS} iterations ({class_trees} class trees) "
                   f"of the default {DRF_KW['ntrees']}",
            "first_seconds": cold_s, "graph_seconds": g_s,
            "class_trees_per_sec": class_trees / g_s,
            "eager_seconds": e_s,
            "eager_class_trees_per_sec": class_trees / e_s,
            "logloss_graph": g.logloss(), "logloss_eager": e.logloss(),
            "logloss_delta": dll, "logloss_tolerance": MN_PATH_TOL,
            "classification_error": g.model.training_metrics.value(
                "classification_error"),
            "class_trees_differing_graph_eager": forest_diff(g, e),
            "launches": launches, "warmup_launches": warm,
            # a plan over the cache's budget is captured anew per training
            "plan_cached": cached is not None, "last_capture": capture}


def phase_gbm_sampled() -> dict:
    """The headline GBM with sample_rate, col_sample_rate and
    col_sample_rate_per_tree at 0.8: a capturing and a warm training by
    graph replay and the eager control, AUC within 1e-5; the card against
    the CPU at 100k rows is the ``gbm_sampled_parity`` phase."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    from h2o3_tpu_torch.tools.tree_parity import divergences

    fr = h2o3_tpu_torch.upload_file(higgs_like(N_ROWS, N_COLS, seed=0),
                                    device="cuda")
    kw = {**GBM_KW, **GBM_SAMPLED}

    def run():
        return fit(H2OGradientBoostingEstimator, fr, "label", **kw)

    with whole_tree("1"):
        (cold, cold_s), launches, warm = counted(run)
        g, g_s = run()
    with whole_tree("0"):
        e, e_s = run()
    dauc = abs(g.auc() - e.auc())
    if not (dauc <= 1e-5 and g.auc() > 0.75):
        raise AssertionError(f"gbm_sampled: auc {g.auc()} vs eager "
                             f"{e.auc()}")
    # float residuals: B1's sums vary in the last bits from run to run, so
    # the two paths' leaf values differ there and a split may part at a
    # near-tie; the splits are held up to the first parting
    parting = divergences(g, e)
    nt = GBM_KW["ntrees"]
    return {"phase": "gbm_sampled", "rows": N_ROWS, "cols": N_COLS, **kw,
            "first_seconds": cold_s, "graph_seconds": g_s,
            "graph_trees_per_sec": nt / g_s, "eager_seconds": e_s,
            "eager_trees_per_sec": nt / e_s, "auc_graph": g.auc(),
            "auc_eager": e.auc(), "auc_delta": dauc,
            "graph_against_eager": parting,
            "launches": launches, "warmup_launches": warm}


def export_drf(est, df, fr, n_score=10_000) -> dict:
    """The DRF headline model through ``download_mojo``, scored offline by
    the port's numpy scorer on ``n_score`` rows: within 1e-5 of
    ``predict``."""
    import shutil

    from h2o3_tpu_torch import genmodel
    from h2o3_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "smoke_export_drf"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    path = est.download_mojo(str(out_dir))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scored = genmodel.MojoModel.load(path).predict(
        df.drop(columns="label").iloc[:n_score])
    score_s = time.perf_counter() - t0
    want = est.predict(fr).vec("s").data[:n_score].double().cpu().numpy()
    err = float(np.abs(np.asarray(scored["s"]) - want).max())
    if not err <= 1e-5:
        raise AssertionError(f"export drf: max |mojo - predict| {err}")
    line = {"export_seconds": export_s,
            "artifact_bytes": os.path.getsize(path), "scored_rows": n_score,
            "load_and_score_seconds": score_s, "max_abs_err": err,
            "trees": len(est.model.output["trees"])}
    shutil.rmtree(out_dir, ignore_errors=True)
    return line


def depth12_nid(est, fr):
    """The DRF headline's tree 0 replayed through its first 12 levels: each
    row's node at level 12 (2048 slots; -1 once retired), the frame's bin
    codes, and the stats the tree's histograms summed ({w, w·y, w} at
    iteration 0's bootstrap)."""
    from h2o3_tpu_torch.models.tree.binning import bin_frame
    from h2o3_tpu_torch.models.tree.sampling import Sampling
    from h2o3_tpu_torch.models.tree.shared_tree import _partition_update

    bins = bin_frame(est.model.output["bin_spec"], fr)
    tree = est.model.output["trees"][0][0]
    nid = torch.zeros(N_ROWS, dtype=torch.int32, device="cuda")
    preds = torch.zeros(N_ROWS, device="cuda")
    for lv in tree._replay_levels(bins.device)[:12]:
        nid, preds = _partition_update(bins, nid, preds, *lv)
    y = (fr.vec("label").data == 1).float()
    w = Sampling(DRF_KW["seed"], DRF_KW["sample_rate"]).rows(
        0, torch.ones(N_ROWS, device="cuda"))
    return bins, nid, torch.stack([w, w * y, w], 1).contiguous()


def phase_kernels_wide(drf_model) -> tuple[dict, dict]:
    """B1 (with its compaction) and B2 at the saturated DRF widths: 1024
    and 2048 nodes at 1M x 28 x 256 x 3, on uniform codes and on the DRF
    headline's codes with a real depth-12 ``nid`` (2048 nodes, and the
    1024 lighter children sibling subtraction builds), each against its
    plain version with its times, byte bound and one ``index_add_``'s
    time. Returns the line and the per-kernel figures."""
    from h2o3_tpu_torch.tools.bench_hist import hist_inputs

    rows, meas = [], {}
    for N in (1024, 2048):
        bins, nid, stats = hist_inputs(N_ROWS, N_COLS, N, N_BINS, seed=N)
        row, got = hist_row(f"{N}_uniform", bins, nid, stats, N,
                            compaction=True)
        srow = split_row(got, N, label=f"{N}_uniform")[0]
        rows += [row, row.pop("compact"), srow]
        del bins, nid, stats, got
    est, _, fr = drf_model
    bins, nid, stats = depth12_nid(est, fr)
    row, got = hist_row("drf_depth12_2048", bins, nid, stats, 2048,
                        compaction=True)
    meas["hist_2048"], meas["hist_compact_2048"] = row, row.pop("compact")
    meas["split_2048"] = split_row(got, 2048, label="drf_depth12_2048")[0]
    rows += [row, meas["hist_compact_2048"], meas["split_2048"]]
    del got
    # the lighter child of each pair, as sibling subtraction builds it
    cnt = torch.bincount(nid[nid >= 0].long(), minlength=2048)
    build_left = cnt[0::2] <= cnt[1::2]
    pair = torch.clamp(nid, min=0).long() >> 1
    left = (nid & 1) == 0
    nid_b = torch.where((nid >= 0) & (left == build_left[pair]), pair,
                        -1).to(torch.int32)
    row, got = hist_row("drf_depth12_1024_built", bins, nid_b, stats, 1024,
                        compaction=True)
    meas["hist_1024"], meas["hist_compact_1024"] = row, row.pop("compact")
    meas["split_1024"] = split_row(got, 1024,
                                   label="drf_depth12_1024_built")[0]
    rows += [row, meas["hist_compact_1024"], meas["split_1024"]]
    return {"phase": "kernels_wide", "rows": rows,
            "active_rows_depth12": int((nid >= 0).sum())}, meas


# ---------------------------------------------------------------------------
# GLM (slice 8): IRLSM with the on-card Cholesky and ADMM solves, L-BFGS,
# the single-response families, categorical design matrices, tmojo export


@contextlib.contextmanager
def glm_fuse(mode: str):
    """``H2O3_TPU_GLM_FUSE`` set to ``mode`` for the block."""
    knob = os.environ.get("H2O3_TPU_GLM_FUSE")
    os.environ["H2O3_TPU_GLM_FUSE"] = mode
    try:
        yield
    finally:
        if knob is None:
            os.environ.pop("H2O3_TPU_GLM_FUSE", None)
        else:
            os.environ["H2O3_TPU_GLM_FUSE"] = knob


def glm_fit(fr, y, **kw):
    from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator

    return fit(H2OGeneralizedLinearEstimator, fr, y, **kw)


def event_ms(fn, reps: int = 5) -> float:
    """CUDA-event milliseconds per call of ``fn``, after one warm call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def coef_diff(a, b) -> float:
    return float(max(abs(a.coef[k] - b.coef[k]) for k in a.coef))


def glm_solve_figures(model, fr) -> dict:
    """The Gram and the solve of the training's last iteration, alone at
    its shapes: the design rebuilt as the training built it, the working
    weights at the fitted beta. The Gram (CUDA events) against its bound —
    2·n·p² + 2·n·p float32 operations over 67 TFLOP/s, or the design, the
    weights and the response read once and G written once over the HBM
    rate, the larger; G against a float64 Gram of the same inputs on the
    card (relative Frobenius error); and one ADMM solve at the training's
    l1 and l2, by CUDA-graph blocks (the training's path) and eagerly
    (the design not taken), host clock to the card's end, with its
    steps."""
    from h2o3_tpu_torch.models import glm as G_
    from h2o3_tpu_torch.ops import gram

    p = model.params
    out = model.output
    di, X, y, w, off = G_.training_inputs(p, fr, out["names"], 8)
    n, pp = X.shape
    P = di.ncols_expanded
    fam = out["family_obj"]
    beta = torch.zeros(pp, dtype=torch.float32, device=X.device)
    beta[:P] = torch.as_tensor(out["beta_std"], dtype=torch.float32)
    W, z, _ = G_._irls_weights(fam, X, y, w, off, beta)
    gram_ms = event_ms(lambda: gram.weighted_gram(X, W, z))
    flops = 2.0 * n * pp * pp + 2.0 * n * pp
    bound, by = bound_ms(4.0 * (n * pp + 2 * n + pp * pp + pp), flops)
    Gm, b, _ = gram.weighted_gram(X, W, z)
    X64 = X.double()
    G64 = (X64 * W.double()[:, None]).T @ X64
    del X64
    rel = float(torch.linalg.norm(Gm.double() - G64) / torch.linalg.norm(G64))
    del G64
    nobs = float(w.sum())
    lam = float(np.atleast_1d(p.lambda_)[0])
    l1 = torch.tensor(lam * 0.5 * nobs, device=X.device)
    l2 = torch.tensor(lam * 0.5 * nobs, device=X.device)
    pad = (torch.arange(pp, device=X.device) >= P).to(torch.float32)
    solve = {}
    for mode, use_graph in (("graph", True), ("eager", False)):
        s = gram.AdmmSolver(pp, X.device, use_graph=use_graph)
        s.solve(Gm, b, l1, l2, P - 1, pad, P)  # capture / warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.solve(Gm, b, l1, l2, P - 1, pad, P)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps = int(s.i)
        solve[mode] = {"ms": ms, "steps": steps,
                       "ms_per_step": ms / max(steps, 1),
                       "host_reads": -(-steps // s.block)}
    return {"design_cols": P, "padded_cols": pp,
            "design_bytes": n * pp * 4, "gram_ms": gram_ms,
            "gram_bound_ms": bound, "gram_bound_by": by,
            "gram_tflops": flops / (gram_ms * 1e-3) / 1e12,
            "gram_vs_float64_rel_fro": rel, "solve": solve}


def glm_headline(name: str, df, y: str, pos: str) -> tuple[dict, tuple]:
    """One GLM headline frame: upload, a first and a warm training, a
    traced warm training (idle share, spans, device ms by span), the
    training's accounting (iterations, chunks, host reads, ADMM steps, host
    fallbacks: none allowed), the Gram and solve alone
    (:func:`glm_solve_figures`), the training AUC and the exact AUC of
    ``predict``, and the ``H2O3_TPU_GLM_FUSE=0`` control in the same call.
    Returns the phase line and (estimator, pandas frame, card frame)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.models import metrics as MM
    from h2o3_tpu_torch.tools.profile_glm import GLM_KW, traced

    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    _, first_s = glm_fit(fr, y, **GLM_KW)
    est, warm_s = glm_fit(fr, y, **GLM_KW)
    m = est.model
    st = m.output["irls_stats"]
    steps = sorted(st["admm_steps"])
    trace = traced(lambda: glm_fit(fr, y, **GLM_KW))
    p1 = est.predict(fr).vec(pos).data
    if p1.shape != (len(df),) or not bool(torch.isfinite(p1).all()):
        raise AssertionError(f"{name}: predictions not finite or misshapen")
    yy = (df[y].astype(str).to_numpy() == pos).astype(np.float64)
    auc_exact = MM.binomial_metrics(yy, p1.double().cpu().numpy())._v["auc"]
    figs = glm_solve_figures(m, fr)
    with glm_fuse("0"):
        ctl, ctl_s = glm_fit(fr, y, **GLM_KW)
    cst = ctl.model.output["irls_stats"]
    diff = coef_diff(m, ctl.model)
    coefs = list(m.coef)
    show = [c for c in coefs if c in ("Intercept", "f0", "f1", "f2", "f3",
                                      "f4", "f5")] or coefs[:6] + ["Intercept"]
    ok = (st["fallbacks"] == 0 and st["host_iterations"] == 0
          and abs(est.auc() - auc_exact) <= 1e-3
          and all(np.isfinite(v) for v in m.coef.values())
          and figs["gram_vs_float64_rel_fro"] <= 1e-5 and diff <= 1e-3)
    line = {"phase": name, "rows": len(df), **GLM_KW,
            "design_cols": figs["design_cols"],
            "padded_cols": figs["padded_cols"],
            "first_train_s": first_s, "warm_train_s": warm_s,
            "iterations": st["iterations"],
            "iterations_per_s": st["iterations"] / warm_s,
            "chunks": st["chunks"], "host_reads": st["host_reads"],
            "admm_blocks": st["admm_blocks"],
            "masked_iterations": st["masked_iterations"],
            "admm_steps_per_iteration": {
                "min": steps[0], "median": steps[len(steps) // 2],
                "max": steps[-1], "each": st["admm_steps"]} if steps else None,
            "host_float64_fallbacks": st["fallbacks"],
            "gram_ms_per_iteration": figs["gram_ms"],
            "gram_bound_ms": figs["gram_bound_ms"],
            "gram_bound_by": figs["gram_bound_by"],
            "gram_tflops": figs["gram_tflops"],
            "gram_vs_float64_rel_fro": figs["gram_vs_float64_rel_fro"],
            "design_bytes": figs["design_bytes"],
            "solve_ms_per_iteration": figs["solve"]["graph"]["ms"],
            "admm_graph_against_eager": figs["solve"],
            "device_idle_share": trace["device_idle_share"],
            "traced_wall_s": trace["traced_wall_s"],
            "device_busy_s": trace["device_busy_s"],
            "device_ms_by_span": trace["device_ms_by_span"],
            "host_spans_s": trace["host_spans_s"],
            "auc_train": est.auc(), "auc_exact_predict": auc_exact,
            "coef": {k: m.coef[k] for k in show},
            "residual_deviance": m.residual_deviance,
            "null_deviance": m.null_deviance,
            "control_fuse0": {"train_s": ctl_s,
                              "iterations": cst["iterations"],
                              "host_iterations": cst["host_iterations"],
                              "auc": ctl.auc(), "max_coef_diff": diff}}
    if not ok:
        raise AssertionError(f"{name}: {line}")
    return line, (est, df, fr)


def phase_glm() -> tuple[dict, tuple]:
    """The JAX bench's GLM headline (``bench.py:652``): binomial,
    lambda_=1e-4, max_iterations=20, seed=1 on the 1M x 28 Higgs-like
    frame (29 design columns padded to 32)."""
    from h2o3_tpu_torch.datasets import higgs_like

    return glm_headline("glm", higgs_like(N_ROWS, N_COLS, seed=0), "label",
                        "s")


def phase_glm_airlines() -> tuple[dict, tuple]:
    """The same GLM on the Airlines-shaped frame (``datasets.airlines_like``,
    1M rows; 7 numeric columns, UniqueCarrier, Origin and Dest one-hot:
    634 design columns padded to 636), response IsDepDelayed."""
    from h2o3_tpu_torch.datasets import airlines_like

    return glm_headline("glm_airlines", airlines_like(N_ROWS, seed=0),
                        "IsDepDelayed", "YES")


def phase_glm_families() -> dict:
    """One warm training of each other family on the 1M-row claims frame
    (gamma on its positive rows only, the family needs y > 0, with the log
    link: with its default inverse link the IRLS of both packages leaves
    the link's domain on this severity and fails in the float64 lane;
    tweedie at variance power 1.5 with the log link, link power 0),
    lambda_=1e-4 and
    max_iterations=20 as the headline, and L_BFGS on the binomial headline
    frame: seconds, iterations, deviance; every deviance finite and below
    its null deviance."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import claims_like, higgs_like
    from h2o3_tpu_torch.tools.profile_glm import GLM_KW

    claims = claims_like(N_ROWS, N_COLS, seed=0)
    runs = [("gaussian", claims, "claim", {}),
            ("poisson", claims, "claim", {}),
            ("gamma", claims[claims["claim"] > 0].reset_index(drop=True),
             "claim", dict(link="log")),
            ("tweedie", claims, "claim",
             dict(tweedie_variance_power=1.5, tweedie_link_power=0.0)),
            ("binomial_lbfgs", higgs_like(N_ROWS, N_COLS, seed=0), "label",
             dict(solver="L_BFGS"))]
    line = {"phase": "glm_families"}
    for name, df, y, extra in runs:
        fam = name.split("_")[0]
        kw = dict(GLM_KW, family=fam, **extra)
        fr = h2o3_tpu_torch.upload_file(df, device="cuda")
        glm_fit(fr, y, **kw)
        est, warm_s = glm_fit(fr, y, **kw)
        m = est.model
        st = m.output["irls_stats"]
        rd, nd = m.residual_deviance, m.null_deviance
        line[name] = {"rows": len(df), **extra, "warm_train_s": warm_s,
                      "iterations": st["iterations"],
                      "host_reads": st["host_reads"],
                      "host_float64_fallbacks": st["fallbacks"],
                      "residual_deviance": rd, "null_deviance": nd,
                      "path_iterations": [e.get("iters") for e in
                                          m.regularization_path]}
        if not (np.isfinite(rd) and rd < nd):
            raise AssertionError(f"glm_families {name}: {line[name]}")
    return line


def glm_pair(df, y, rows: int, kw=None, gate: bool = True, keep=None):
    """A GLM (the headline's parameters unless ``kw``) on the card and on
    the CPU on the same frame: coefficients within 1e-4, residual deviance
    within 1e-5 relative, iteration counts equal (a multinomial model: its
    whole Beta, and its training logloss within 1e-5 relative). With
    ``gate`` False the figures are reported and only required finite.
    ``keep`` (a list) receives the card's (estimator, frame, card frame)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.tools.profile_glm import GLM_KW

    kw = GLM_KW if kw is None else kw
    df = df.iloc[:rows].reset_index(drop=True)
    gfr = h2o3_tpu_torch.upload_file(df, device="cuda")
    g, g_s = glm_fit(gfr, y, **kw)
    c, c_s = glm_fit(h2o3_tpu_torch.upload_file(df, device="cpu"), y, **kw)
    if keep is not None:
        keep.append((g, df, gfr))
    go, co = g.model.output, c.model.output
    key = "beta_multinomial_std" if go.get("multinomial") else "beta_std"
    diff = float(np.abs(np.asarray(go[key]) - np.asarray(co[key])).max())
    rel = abs(g.residual_deviance - c.residual_deviance) / abs(
        c.residual_deviance)
    out = {"rows": rows, **{k: v for k, v in kw.items()
                            if k != "interaction_pairs"},
           "cuda_s": g_s, "cpu_s": c_s,
           "max_coef_diff": diff, "deviance_rel_diff": rel,
           "iterations_cuda": go["irls_stats"]["iterations"],
           "iterations_cpu": co["irls_stats"]["iterations"],
           "fallbacks_cuda": go["irls_stats"]["fallbacks"],
           "fallbacks_cpu": co["irls_stats"]["fallbacks"]}
    ok = np.isfinite(diff) and np.isfinite(rel)
    if go["response_domain"] and len(go["response_domain"]) > 2:
        gl, cl = g.logloss(), c.logloss()
        out.update(logloss_cuda=gl, logloss_cpu=cl,
                   logloss_rel_diff=abs(gl - cl) / abs(cl))
        ok = ok and (not gate or out["logloss_rel_diff"] <= 1e-5)
    else:
        out.update(auc_cuda=g.auc(), auc_cpu=c.auc())
    ok = ok and (not gate or (
        diff <= 1e-4 and rel <= 1e-5
        and out["iterations_cuda"] == out["iterations_cpu"]))
    out["gated"] = gate
    if not ok:
        raise AssertionError(f"glm_parity: {out}")
    return out


def ordinal_pair(df, rows: int, gate: bool = True) -> dict:
    """The ordinal headline on the card and on the CPU: beta and the cuts
    within 2e-3 (JAX's bound between its two ordinal lanes), with each
    side's BFGS stop. With ``gate`` False the figures are reported only."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.tools.profile_glm import ORDINAL_KW

    df = df.iloc[:rows].reset_index(drop=True)
    g, g_s = glm_fit(h2o3_tpu_torch.upload_file(df, device="cuda"), "rating",
                     **ORDINAL_KW)
    c, c_s = glm_fit(h2o3_tpu_torch.upload_file(df, device="cpu"), "rating",
                     **ORDINAL_KW)
    go, co = g.model.output, c.model.output
    out = {"rows": rows, "cuda_s": g_s, "cpu_s": c_s,
           "max_beta_diff": float(np.abs(go["beta_std"]
                                         - co["beta_std"]).max()),
           "max_theta_diff": float(np.abs(go["theta"] - co["theta"]).max()),
           "nll_cuda": go["residual_deviance"] / 2,
           "nll_cpu": co["residual_deviance"] / 2,
           "bfgs_cuda": go["irls_stats"].get("bfgs"),
           "bfgs_cpu": co["irls_stats"].get("bfgs"), "gated": gate}
    if gate and not (out["max_beta_diff"] <= 2e-3
                     and out["max_theta_diff"] <= 2e-3):
        raise AssertionError(f"glm_parity ordinal: {out}")
    return out


GLM_PARITY_AIRLINES_ROWS = 50_000  # the CPU's Gram at 636 columns is slow
GLM_PARITY_SLICE9_ROWS = 100_000  # multinomial and ordinal, card and CPU


def phase_glm_parity(higgs_df, airlines_df, covtype_df,
                     ordinal_df) -> tuple[dict, tuple]:
    """Card against the port's own CPU path: the headline at its full 1M
    rows, the Airlines shape cut to its first 50,000 rows (the CPU's
    Gram at 636 columns and 1M rows takes minutes a training), and the
    slice-9 models: the hashed Airlines interaction headline at 50,000
    rows, the multinomial headline (Covertype's shape, lambda unset) at
    100,000 rows, reported only (its cycling IRLS diverges, as JAX's does
    on this frame, and a diverging float32 trajectory is not reproducible
    across devices), the multinomial GLM of the ordinal frame's 5-level
    response at 100,000 rows (a convergent fit, gated), and the ordinal
    headline at its full 1M rows (gated: JAX's BFGS stops it after a few
    iterations at the same place on both devices) and at 100,000 rows
    (reported only: there BFGS runs ~45 iterations into float32 noise, and
    where its last zoom fails, JAX's algorithm still takes the full step,
    so the end point turns on rounding). Returns the line and the card's
    convergent multinomial model (for the export phase)."""
    from h2o3_tpu_torch.tools.profile_glm import (INTERACTIONS_KW,
                                                  MULTINOMIAL_KW)

    n9 = GLM_PARITY_SLICE9_ROWS
    mn = []
    line = {"phase": "glm_parity",
            "glm": glm_pair(higgs_df, "label", len(higgs_df)),
            "glm_airlines": glm_pair(airlines_df, "IsDepDelayed",
                                     GLM_PARITY_AIRLINES_ROWS),
            "glm_interactions": glm_pair(airlines_df, "IsDepDelayed",
                                         GLM_PARITY_AIRLINES_ROWS,
                                         INTERACTIONS_KW),
            "glm_multinomial_covtype": glm_pair(
                covtype_df, "cover_type", n9, MULTINOMIAL_KW, gate=False),
            "glm_multinomial": glm_pair(ordinal_df, "rating", n9,
                                        MULTINOMIAL_KW, keep=mn),
            "glm_ordinal": ordinal_pair(ordinal_df, len(ordinal_df)),
            "glm_ordinal_100k": ordinal_pair(ordinal_df, n9, gate=False),
            "cuts": {"glm_airlines_rows": GLM_PARITY_AIRLINES_ROWS,
                     "glm_interactions_rows": GLM_PARITY_AIRLINES_ROWS,
                     "glm_multinomial_rows": n9,
                     "glm_ordinal_100k_rows": n9}}
    return line, mn[0]


def phase_glm_export(models: dict) -> dict:
    """``download_mojo`` of the GLM headlines; 100k rows scored offline by
    ``h2o3_tpu_torch.genmodel``: the binomial headlines within 1e-5 of
    ``predict``, the slice-9 models (multinomial, ordinal, hashed
    interactions) within 1e-6 in every probability column."""
    import shutil

    from h2o3_tpu_torch import genmodel
    from h2o3_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "smoke_glm_export"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    n_score = 100_000
    line = {"phase": "glm_export", "scored_rows": n_score}
    for name, ((est, df, fr), y, cols, tol) in models.items():
        t0 = time.perf_counter()
        path = est.download_mojo(str(out_dir))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        scored = genmodel.MojoModel.load(path).predict(
            df.drop(columns=y).iloc[:n_score])
        score_s = time.perf_counter() - t0
        pred = est.predict(fr)
        err = max(float(np.abs(np.asarray(scored[c], np.float64)
                               - pred.vec(c).data[:n_score].double()
                               .cpu().numpy()).max()) for c in cols)
        line[name] = {"export_seconds": export_s,
                      "artifact_bytes": os.path.getsize(path),
                      "load_and_score_seconds": score_s, "max_abs_err": err,
                      "tolerance": tol, "columns": cols}
        if not err <= tol:
            raise AssertionError(f"glm_export {name}: {line[name]}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return line


def class_solve_steps(st) -> dict | None:
    steps = sorted(st["admm_steps"])
    if not steps:
        return None
    return {"min": steps[0], "median": steps[len(steps) // 2],
            "max": steps[-1], "solves": len(steps)}


def phase_glm_multinomial() -> tuple[dict, tuple]:
    """Multinomial GLM on the Covertype-shaped frame at its published
    size (581,012 x 54, 7 classes; 55 design columns padded to 56): JAX's
    default (``lambda_`` unset: a Cholesky solve per class) and the GLM
    headline's ``lambda_=1e-4``, alpha 0.5 (an ADMM solve per class), each
    a warm training (the default after a first one; the ADMM run after a
    one-iteration training on 2,000 rows that captures its block) with
    its accounting (iterations, class
    passes, host reads, masked iterations, fallbacks, ADMM steps per class
    solve), a traced warm training of the default (idle share, device ms
    by span), the ``H2O3_TPU_GLM_FUSE=0`` host float64 control (seconds,
    max|ΔBeta|), and the predictions: (n, 7), finite, rows summing to 1."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import covtype_like
    from h2o3_tpu_torch.tools.profile_glm import MULTINOMIAL_KW, traced

    df = covtype_like()
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    line = {"phase": "glm_multinomial", "rows": len(df),
            "columns": df.shape[1] - 1, "classes": 7}
    keep = None
    small = h2o3_tpu_torch.upload_file(covtype_like(2_000), device="cuda")
    for name, kw in (("default", MULTINOMIAL_KW),
                     ("lambda_1e-4", dict(MULTINOMIAL_KW, lambda_=1e-4,
                                          alpha=0.5))):
        # a first training at full size for the default; for the ADMM run
        # one iteration on 2,000 rows captures the 56-wide block's graph
        # (its full trainings take seconds each)
        _, first_s = (glm_fit(fr, "cover_type", **kw) if name == "default"
                      else glm_fit(small, "cover_type", max_iterations=1,
                                   **kw))
        est, warm_s = glm_fit(fr, "cover_type", **kw)
        m = est.model
        st = m.output["irls_stats"]
        with glm_fuse("0"):
            ctl, ctl_s = glm_fit(fr, "cover_type", **kw)
        dB = float(np.abs(m.output["beta_multinomial_std"]
                          - ctl.model.output["beta_multinomial_std"]).max())
        P = torch.stack([est.predict(fr).vec(str(k)).data
                         for k in range(1, 8)], 1)
        rec = {"first_train_s": first_s if name == "default" else None,
               "capture_train_s": None if name == "default" else first_s,
               "warm_train_s": warm_s,
               "iterations": st["iterations"],
               "iterations_per_s": st["iterations"] / warm_s,
               "class_passes_per_s": 7 * st["iterations"] / warm_s,
               "chunks": st["chunks"], "host_reads": st["host_reads"],
               "masked_iterations": st["masked_iterations"],
               "host_float64_fallbacks": st["fallbacks"],
               "admm_steps_per_class_solve": class_solve_steps(st),
               "admm_blocks": st["admm_blocks"],
               "logloss_train": est.logloss(),
               "residual_deviance": m.residual_deviance,
               "max_abs_beta": float(np.abs(
                   m.output["beta_multinomial_std"]).max()),
               "control_fuse0": {"train_s": ctl_s,
                                 "iterations": ctl.model.output[
                                     "irls_stats"]["iterations"],
                                 "logloss_train": ctl.logloss(),
                                 "max_abs_beta_diff": dB}}
        if name == "default":
            rec["traced"] = traced(lambda: glm_fit(fr, "cover_type", **kw))
            keep = est
        line[name] = rec
        ok = (P.shape == (len(df), 7) and bool(torch.isfinite(P).all())
              and float((P.sum(1) - 1).abs().max()) <= 1e-5)
        if not ok:
            raise AssertionError(f"glm_multinomial {name}: {rec}")
    line["design_cols"] = keep.model.output["datainfo"].ncols_expanded
    line["design_bytes"] = len(df) * (-(-line["design_cols"] // 4) * 4) * 4
    return line, (keep, df, fr)


def phase_glm_ordinal() -> tuple[dict, tuple]:
    """Ordinal GLM on ``datasets.ordinal_like`` (the 1M x 28 Higgs-like
    features, a 5-level response cut from a proportional-odds latent with
    known coefficients), standardize off: a first and a warm training (BFGS
    on the device), its iterations, evaluations, host reads and stop, the
    NLL, max|beta - beta_true|, a traced warm training, and the
    ``H2O3_TPU_GLM_FUSE=0`` host L-BFGS-B control on the same device
    objective."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import ORDINAL_BETA, ORDINAL_CUTS, ordinal_like
    from h2o3_tpu_torch.tools.profile_glm import ORDINAL_KW, traced

    df = ordinal_like(N_ROWS, N_COLS, seed=0)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    truth = np.zeros(N_COLS)
    truth[: len(ORDINAL_BETA)] = ORDINAL_BETA
    _, first_s = glm_fit(fr, "rating", **ORDINAL_KW)
    est, warm_s = glm_fit(fr, "rating", **ORDINAL_KW)
    trace = traced(lambda: glm_fit(fr, "rating", **ORDINAL_KW))
    with glm_fuse("0"):
        ctl, ctl_s = glm_fit(fr, "rating", **ORDINAL_KW)

    def fit_figures(e, s):
        o = e.model.output
        return {"train_s": s, "iterations": o["irls_stats"]["iterations"],
                "host_reads": o["irls_stats"]["host_reads"],
                "nll": o["residual_deviance"] / 2,
                "max_abs_beta_err": float(np.abs(o["beta_orig"]
                                                 - truth).max()),
                "max_abs_cut_err": float(np.abs(o["theta"]
                                                - ORDINAL_CUTS).max()),
                "logloss_train": e.logloss()}

    st = est.model.output["irls_stats"]
    P = torch.stack([est.predict(fr).vec(str(k)).data for k in range(1, 6)], 1)
    line = {"phase": "glm_ordinal", "rows": len(df), "columns": N_COLS,
            "levels": 5, "first_train_s": first_s, "warm_train_s": warm_s,
            **{k: v for k, v in fit_figures(est, warm_s).items()
               if k != "train_s"},
            "bfgs": st["bfgs"], "host_float64_fallbacks": st["fallbacks"],
            "traced": trace, "control_fuse0": fit_figures(ctl, ctl_s)}
    ok = (st["fallbacks"] == 0 and np.isfinite(line["nll"])
          and st["bfgs"]["reads"] <= st["iterations"]
          and P.shape == (len(df), 5) and bool(torch.isfinite(P).all())
          and line["control_fuse0"]["max_abs_beta_err"] <= 0.02)
    if not ok:
        raise AssertionError(f"glm_ordinal: {line}")
    return line, (est, df, fr)


def phase_glm_interactions() -> tuple[dict, tuple]:
    """The Airlines shape (``datasets.airlines_like``, 1M rows) with
    ``hash_buckets=64`` (Origin and Dest, 300 levels each, hashed to 63
    columns each) and the interactions UniqueCarrier×Distance and
    CRSDepTime×Distance, binomial, the headline's ``lambda_=1e-4``: first
    and warm seconds, iterations/sec, the design's exact width and bytes,
    fallbacks (none allowed), AUC against the exact AUC of ``predict``, a
    traced warm training."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import airlines_like
    from h2o3_tpu_torch.models import metrics as MM
    from h2o3_tpu_torch.tools.profile_glm import INTERACTIONS_KW, traced

    df = airlines_like(N_ROWS, seed=0)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    _, first_s = glm_fit(fr, "IsDepDelayed", **INTERACTIONS_KW)
    est, warm_s = glm_fit(fr, "IsDepDelayed", **INTERACTIONS_KW)
    trace = traced(lambda: glm_fit(fr, "IsDepDelayed", **INTERACTIONS_KW))
    m = est.model
    st = m.output["irls_stats"]
    di = m.output["datainfo"]
    p1 = est.predict(fr).vec("YES").data
    yy = (df["IsDepDelayed"].astype(str).to_numpy() == "YES").astype(float)
    auc_exact = MM.binomial_metrics(yy, p1.double().cpu().numpy())._v["auc"]
    padded = -(-di.ncols_expanded // 4) * 4
    line = {"phase": "glm_interactions", "rows": len(df),
            "hash_buckets": INTERACTIONS_KW["hash_buckets"],
            "interaction_pairs": INTERACTIONS_KW["interaction_pairs"],
            "design_blocks": {c.name: [c.kind, c.width] for c in di.columns
                              if c.kind != "num" or c.pair},
            "design_cols": di.ncols_expanded, "padded_cols": padded,
            "design_bytes": len(df) * padded * 4,
            "first_train_s": first_s, "warm_train_s": warm_s,
            "iterations": st["iterations"],
            "iterations_per_s": st["iterations"] / warm_s,
            "chunks": st["chunks"], "host_reads": st["host_reads"],
            "admm_steps_per_iteration": class_solve_steps(st),
            "host_float64_fallbacks": st["fallbacks"],
            "auc_train": est.auc(), "auc_exact_predict": auc_exact,
            "traced": trace}
    if not (st["fallbacks"] == 0 and abs(est.auc() - auc_exact) <= 1e-3
            and all(np.isfinite(v) for v in m.coef.values())):
        raise AssertionError(f"glm_interactions: {line}")
    return line, (est, df, fr)


def phase_bin_edges() -> dict:
    """``fit_bins`` on the card for the 1M-row Higgs-like and claims-like
    frames: its edges equal, to the bit, those of the same device program
    (``_device_quantile_edges``) run on CPU tensors of the same strided
    sample, through ``fit_bins``'s own unique-and-finite step."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import claims_like, higgs_like
    from h2o3_tpu_torch.models.tree import binning

    line = {"phase": "bin_edges"}
    for name, df, y in (("higgs_like", higgs_like(N_ROWS, N_COLS, seed=0),
                         "label"),
                        ("claims_like", claims_like(N_ROWS, N_COLS, seed=0),
                         None)):
        cols = [c for c in df.columns if c != y]
        fr = h2o3_tpu_torch.upload_file(df[cols], device="cuda")
        spec = binning.fit_bins(fr, cols)
        ns = min(fr.nrow, 200_000)
        idx = torch.from_numpy(
            np.round(np.linspace(0, fr.nrow - 1, ns)).astype(np.int64))
        X = torch.stack([fr.vec(c).data.cpu()[idx] for c in cols], dim=1)
        e_cpu, m_cpu = binning._device_quantile_edges(X, binning.MAX_BINS)
        e_dev, m_dev = binning._device_quantile_edges(X.cuda(),
                                                      binning.MAX_BINS)
        raw_equal = (e_dev.cpu().numpy().tobytes() == e_cpu.numpy().tobytes()
                     and bool((m_dev.cpu() == m_cpu).all()))
        edges = np.full_like(spec.edges, np.inf)
        nb = np.zeros_like(spec.nbins)
        for ci in range(len(cols)):
            e = np.unique(e_cpu[ci].numpy())
            e = e[np.isfinite(e)]
            nb[ci] = len(e) + 1
            edges[ci, : len(e)] = e
        fit_equal = (edges.tobytes() == spec.edges.tobytes()
                     and np.array_equal(nb, spec.nbins))
        line[name] = {"rows": fr.nrow, "columns": len(cols), "sample": ns,
                      "raw_edges_bit_equal": raw_equal,
                      "fit_bins_edges_bit_equal": fit_equal}
        if not (raw_equal and fit_equal):
            raise AssertionError(f"bin_edges {name}: {line[name]}")
    return line



# ---------------------------------------------------------------------------
# slice 11: file parsing, cross-validation, max_runtime_secs and XGBoost


FRAME_ROWS = 200_000  # the parsed files: the headline's 28 columns + a date
CV_FOLDS, DRF_CV_FOLDS, CV_PARITY_ROWS, CV_PARITY_FOLDS = 5, 3, 100_000, 3
# xgboost's defaults (XGBoostParams) on the headline frame
XGB_KW = dict(ntrees=50, max_depth=6, learn_rate=0.3, reg_lambda=1.0,
              min_rows=1.0, seed=42)
# card against CPU: the CPU's plain scans take ~1 s a tree at 100k rows, so
# the pair is cut to these trees
XGB_PARITY_TREES = 20
# ``python -m h2o3_tpu_torch.tools.tree_parity`` on an NVIDIA H100 80GB
# HBM3 (700 W): over 16 card runs of that pair the first parting came at
# iteration 2 or 3, at gains equal within 1.2e-4 relative, with the scores
# entering it 1.1e-5 apart and their exact AUCs 1.8e-6; in 4 runs B1's sums
# decided iteration 2's near-tie the CPU's other way, and those runs ended
# 1.425e-3 of AUC from the CPU and from the other 12 (6e-9 to 9e-9; in
# the next call's 8 repeats, 4 of 8). So the final AUC is held against the
# nearest of several card runs (the chance that all 16 take the rarer way
# is 1.5e-5 even at one in two), and the part both sides grew on the same
# scores is held to:
XGB_PARITY_REPEATS = 16
XGB_SCORE_NOISE = 1e-4
XGB_PRE_PARTING_AUC = 1e-5
MAX_RUNTIME_TREES, MAX_RUNTIME_SECS = 1000, 1.0


def phase_frame() -> dict:
    """``import_file`` on the card of the same frame written four times, as
    ``,`` ``\\t`` ``;`` and ``|``-separated text: the headline's 28 float
    columns, its label and an ISO-date column. Each file must come back
    with the frame's names, the kinds (``time``, ``real`` x 28, ``enum``),
    the floats equal to the written values in float32, and the date
    column's exact float64 copy equal to the epoch milliseconds pandas
    parses from the strings (its float32 device values their rounding)."""
    import pandas as pd

    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.ops import cuda_build

    df = higgs_like(FRAME_ROWS, N_COLS, seed=3)
    days = np.random.default_rng(3).integers(0, 3650, FRAME_ROWS)
    stamp = pd.Timestamp("2015-01-01") + pd.to_timedelta(days, "D")
    df.insert(0, "date", stamp.strftime("%Y-%m-%d"))
    want_ms = stamp.to_numpy().astype("datetime64[ms]").astype(
        np.int64).astype(np.float64)
    kinds = ["time"] + ["real"] * N_COLS + ["enum"]
    out_dir = cuda_build.BUILD_DIR / "smoke_frame"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    text = df.to_csv(index=False)  # no value holds a separator
    write_s = time.perf_counter() - t0
    files = {}
    for name, sep in (("comma", ","), ("tab", "\t"), ("semicolon", ";"),
                      ("pipe", "|")):
        path = str(out_dir / f"{name}.csv")
        with open(path, "w") as f:
            f.write(text.replace(",", sep))
        t0 = time.perf_counter()
        fr = h2o3_tpu_torch.import_file(path)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        got_kinds = [fr.vec(c).kind for c in fr.names]
        d = fr.vec("date")
        exact = d.to_numpy()
        float_diff = max(float(np.abs(
            fr.vec(c).data.cpu().numpy()
            - df[c].to_numpy(np.float32)).max()) for c in df.columns[1:-1])
        ok = (fr.names == list(df.columns) and got_kinds == kinds
              and d.data.device.type == "cuda"
              and np.array_equal(exact, want_ms)
              and np.array_equal(d.data.cpu().numpy(),
                                 exact.astype(np.float32))
              and float_diff == 0.0
              and fr.vec("label").domain == ("b", "s"))
        files[name] = {"names": fr.names[:3] + ["..."] + fr.names[-2:],
                       "kinds": {k: got_kinds.count(k) for k in set(kinds)},
                       "date_exact_ms_first": exact[:2].tolist(),
                       "date_exact_equal_parsed": bool(
                           np.array_equal(exact, want_ms)),
                       "date_device_float32_max_ms_off": float(np.abs(
                           d.data.cpu().numpy().astype(np.float64)
                           - exact).max()),
                       "float_max_abs_diff": float_diff,
                       "import_s": read_s}
        if not ok:
            raise AssertionError(f"frame {name}: {files[name]}")
        os.remove(path)
    return {"phase": "frame", "rows": FRAME_ROWS, "cols": len(df.columns),
            "to_csv_s": write_s, "files": files}


@contextlib.contextmanager
def builds_recorded(*builders):
    """The graph and ADMM capture counts at the start of each ``_build``
    of the given builder classes in the block, in order (a CV: the main
    model, then fold 1, 2, ...)."""
    from h2o3_tpu_torch.models.tree import shared_tree as pst
    from h2o3_tpu_torch.ops import gram

    seen, saved = [], [(b, b.__dict__.get("_build")) for b in builders]

    def wrap(orig):
        def _build(self, train, valid):
            seen.append((pst.GRAPH_EVENTS["captures"],
                         gram.ADMM_EVENTS["captures"]))
            return orig(self, train, valid)
        return _build

    for b in builders:
        b._build = wrap(b._build)
    try:
        yield seen
    finally:
        for b, orig in saved:
            if orig is None:
                del b._build
            else:
                b._build = orig


def cv_check(name, est, fr, y_np, pos_col, folds_expected) -> dict:
    """The CV's own checks: the holdout equals each fold model's prediction
    on its fold's rows, bit for bit, on the card; the card's CV metrics
    equal a host float64 recomputation from ``cv_predictions`` within
    1e-6 (logloss, MSE, RMSE, and the AUC of the same 1024 score buckets
    the card uses, H2O's AUC2); the exact host AUC beside them."""
    from h2o3_tpu_torch.models import model_base as pmb

    m = est.model
    fold, folds = pmb.fold_ids(m.params, fr)
    hold = m.cv_predictions
    if len(folds) != folds_expected or len(m.cv_models) != len(folds):
        raise AssertionError(f"{name}: {len(m.cv_models)} fold models")
    fold_dev = torch.from_numpy(fold).to(hold.device)
    for f, fm in zip(folds, m.cv_models):
        te = fold_dev == f
        if not torch.equal(hold[te], fm._predict_raw(fr)[te]):
            raise AssertionError(f"{name}: fold {f}'s holdout is not its "
                                 "model's prediction")
    out = cv_metrics_against_host(name, m, hold, y_np)
    return {**out, "holdout_equals_fold_models": True}


def cv_metrics_against_host(name, m, hold, y_np) -> dict:
    """``m``'s cross-validation metrics on the card against a host float64
    recomputation from the holdout ``hold`` (n, 2), within 1e-6 (logloss,
    MSE, RMSE, and the AUC of the same 1024 score buckets the card uses,
    H2O's AUC2); the exact host AUC beside them."""
    from h2o3_tpu_torch.models import metrics as MM

    p = hold[:, 1].double().cpu().numpy()
    pc = np.clip(p, MM._EPS, 1 - MM._EPS)
    ypos = y_np == 1
    host = {"logloss": float(-np.where(ypos, np.log(pc),
                                       np.log1p(-pc)).mean()),
            "mse": float(((y_np - pc) ** 2).mean())}
    host["rmse"] = float(np.sqrt(host["mse"]))
    pc32 = np.clip(hold[:, 1].cpu().numpy(), np.float32(MM._EPS),
                   np.float32(1 - MM._EPS))
    b = np.clip((pc32 * np.float32(MM._NBUCKETS)).astype(np.int32), 0,
                MM._NBUCKETS - 1)
    wpos = np.bincount(b, ypos, MM._NBUCKETS)
    wneg = np.bincount(b, ~ypos, MM._NBUCKETS)
    below = np.concatenate([[0.0], np.cumsum(wneg)[:-1]])
    host["auc"] = float((wpos * (below + 0.5 * wneg)).sum()
                        / (wpos.sum() * wneg.sum()))
    card = {k: m.cross_validation_metrics.value(k) for k in host}
    diff = {k: abs(card[k] - host[k]) for k in host}
    exact_auc = MM.binomial_metrics(y_np, p)._v["auc"]
    if max(diff.values()) > 1e-6:
        raise AssertionError(f"{name}: card CV metrics {card}, host {host}")
    return {"cv_metrics_card": card, "cv_metrics_host": host,
            "cv_metrics_max_diff": max(diff.values()),
            "cv_auc_exact_host": exact_auc}


def cv_run(name, cls, fr, y_np, kw, pos, folds_expected, builders):
    """One CV training, counted (launches on the card, warm-up launches)
    and with the captures at each model's start recorded; then its checks
    (:func:`cv_check`). Returns the phase's part for it and the estimator."""
    from h2o3_tpu_torch.models.tree import shared_tree as pst
    from h2o3_tpu_torch.ops import gram

    with builds_recorded(*builders) as seen:
        (est, secs), launches, warm = counted(
            lambda: fit(cls, fr, "label", **kw))
        end = (pst.GRAPH_EVENTS["captures"], gram.ADMM_EVENTS["captures"])
    m = est.model
    part = {"seconds": secs,
            "main_seconds": m.run_time_ms / 1e3,
            "fold_seconds": [f.run_time_ms / 1e3 for f in m.cv_models],
            "graph_captures": end[0] - seen[0][0],
            "graph_captures_folds_2_to_k": end[0] - seen[2][0],
            "admm_captures": end[1] - seen[0][1],
            "admm_captures_folds_2_to_k": end[1] - seen[2][1],
            "launches": launches, "warmup_launches": warm,
            "replayed_launches": {k: launches[k] - warm[k]
                                  for k in launches},
            "train_auc": est.auc(), "cv_auc": est.auc(xval=True)}
    part.update(cv_check(name, est, fr, y_np, pos, folds_expected))
    if part["graph_captures_folds_2_to_k"] or part[
            "admm_captures_folds_2_to_k"]:
        raise AssertionError(f"{name}: folds 2..k captured: {part}")
    return part, est


def phase_cv() -> dict:
    """Cross-validation on the card: the GBM headline with nfolds=5
    (modulo, predictions kept), captured cold (the graph cache emptied
    first: the main model captures, folds 2..5 must not) and run again
    warm (no capture at all); B1, its compaction and B2 launched 6 models x
    20 trees x 6 levels inside replays; the GLM headline with nfolds=5 (no
    ADMM capture in the folds, none at all warm); the DRF headline with
    nfolds=3; each with the holdout and metric checks of
    :func:`cv_check`. Last, GBM CV at 100k rows (3 folds) on the card
    against the CPU: CV AUC within 1e-3."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.estimators import (
        H2OGeneralizedLinearEstimator,
        H2OGradientBoostingEstimator,
        H2ORandomForestEstimator,
    )
    from h2o3_tpu_torch.models.glm import GLM
    from h2o3_tpu_torch.models.tree import shared_tree as pst
    from h2o3_tpu_torch.models.tree.drf import DRF
    from h2o3_tpu_torch.models.tree.gbm import GBM
    from h2o3_tpu_torch.tools.profile_glm import GLM_KW

    df = higgs_like(N_ROWS, N_COLS, seed=0)
    y_np = (df["label"].to_numpy() == "s").astype(np.float64)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    line = {"phase": "cv", "rows": N_ROWS, "cols": N_COLS}
    cv = dict(nfolds=CV_FOLDS, fold_assignment="modulo",
              keep_cross_validation_predictions=True)
    pst.free_graphs()
    gbm_kw = {**GBM_KW, **cv}
    cold, _ = cv_run("cv gbm", H2OGradientBoostingEstimator, fr, y_np,
                     gbm_kw, "s", CV_FOLDS, (GBM,))
    warm, est = cv_run("cv gbm warm", H2OGradientBoostingEstimator, fr,
                       y_np, gbm_kw, "s", CV_FOLDS, (GBM,))
    expect = (CV_FOLDS + 1) * GBM_KW["ntrees"] * GBM_KW["max_depth"]
    if not (cold["graph_captures"] == 1 and warm["graph_captures"] == 0
            and all(warm["replayed_launches"][k] == expect
                    for k in ("hist", "hist_compact", "split"))
            and warm["launches"]["split_mono"] == 0
            and abs(est.auc() - HEADLINE_AUC) <= 1e-5):
        raise AssertionError(f"cv gbm: cold {cold}, warm {warm}")
    line["gbm"] = {**GBM_KW, **cv, "cold": cold, "warm": warm,
                   "expected_replayed_launches": expect}
    glm_kw = {**GLM_KW, **cv}
    glm_cold, _ = cv_run("cv glm", H2OGeneralizedLinearEstimator, fr, y_np,
                         glm_kw, "s", CV_FOLDS, (GLM,))
    glm_warm, glm = cv_run("cv glm warm", H2OGeneralizedLinearEstimator, fr,
                           y_np, glm_kw, "s", CV_FOLDS, (GLM,))
    if glm_warm["admm_captures"] or any(
            m.output["irls_stats"]["fallbacks"]
            for m in [glm.model] + glm.model.cv_models):
        raise AssertionError(f"cv glm: {glm_warm}")
    line["glm"] = {**GLM_KW, **cv, "cold": glm_cold, "warm": glm_warm}
    drf_kw = {**DRF_KW, **cv, "nfolds": DRF_CV_FOLDS}
    drf, _ = cv_run("cv drf", H2ORandomForestEstimator, fr, y_np, drf_kw,
                    "s", DRF_CV_FOLDS, (DRF,))
    line["drf"] = {**drf_kw, **drf}
    # card against CPU at 100k rows
    small = higgs_like(CV_PARITY_ROWS, N_COLS, seed=1)
    pkw = {**GBM_KW, **cv, "nfolds": CV_PARITY_FOLDS}
    g, g_s = fit(H2OGradientBoostingEstimator,
                 h2o3_tpu_torch.upload_file(small, device="cuda"), "label",
                 **pkw)
    c, c_s = fit(H2OGradientBoostingEstimator,
                 h2o3_tpu_torch.upload_file(small, device="cpu"), "label",
                 **pkw)
    dauc = abs(g.auc(xval=True) - c.auc(xval=True))
    if dauc > 1e-3:
        raise AssertionError(f"cv parity: CV AUC card {g.auc(xval=True)}, "
                             f"CPU {c.auc(xval=True)}")
    line["parity"] = {"rows": CV_PARITY_ROWS, "nfolds": CV_PARITY_FOLDS,
                      "cv_auc_cuda": g.auc(xval=True),
                      "cv_auc_cpu": c.auc(xval=True), "cv_auc_delta": dauc,
                      "cuda_seconds": g_s, "cpu_seconds": c_s}
    return line


def phase_max_runtime() -> dict:
    """GBM on the headline frame with ntrees=1000 and max_runtime_secs=1:
    the build stops between scoring intervals once the second has passed,
    after at least one interval, well under 1000 trees, with a partial
    model that scores (finite predictions, AUC above 0.8)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator

    fr = h2o3_tpu_torch.upload_file(higgs_like(N_ROWS, N_COLS, seed=0),
                                    device="cuda")
    kw = {**GBM_KW, "ntrees": MAX_RUNTIME_TREES,
          "max_runtime_secs": MAX_RUNTIME_SECS}
    est, secs = fit(H2OGradientBoostingEstimator, fr, "label", **kw)
    built = est.model.output["ntrees_actual"]
    p1 = est.predict(fr).vec("s").data
    line = {"phase": "max_runtime", "rows": N_ROWS, **kw,
            "trees_built": built, "seconds": secs,
            "scoring_events": len(est.model.scoring_history),
            "auc": est.auc()}
    if not (5 <= built < MAX_RUNTIME_TREES // 2
            and secs < MAX_RUNTIME_SECS + 2.0
            and bool(torch.isfinite(p1).all()) and est.auc() > 0.8):
        raise AssertionError(f"max_runtime: {line}")
    return line


def phase_xgboost(gbm_headline) -> tuple[dict, dict]:
    """``H2OXGBoostEstimator`` at xgboost's defaults (50 trees, depth 6, eta
    0.3, lambda 1, min_child_weight 1) on the headline frame: a cold
    training (counted: 50 x 6 launches of B1, its compaction and B2 inside
    replays, plus the warm-up tree's; one capture: the regularized plan is
    new) and a warm one (trees/sec, no capture); runs with reg_alpha=0.5
    and with scale_pos_weight=3 on the same plan (lambda, alpha and the
    weights are loaded state: no capture); an unregularized run (lambda =
    alpha = 0 with GBM's lr, min_rows and min_split_improvement) on GBM's
    captured plan, whose trees must equal the GBM headline's: every split
    decision (a parting is allowed only as a float near-tie of B1's
    run-to-run sums, ``divergences``), the leaf values to B1's last bits,
    and the AUC within 1e-5; card against CPU at 100k rows (20 trees:
    tree 0's splits equal; the first iteration that parts parting at
    float near-ties, the scores entering it within XGB_SCORE_NOISE and
    their exact AUCs within XGB_PRE_PARTING_AUC; the CPU's exact AUC
    within 1e-3 of the nearest of XGB_PARITY_REPEATS card runs); the tmojo
    scored by the port's ``genmodel`` on 100k rows within 1e-6 of
    ``predict``.
    Returns the line and the cold run's counts for the kernels line."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch import genmodel
    from h2o3_tpu_torch.datasets import higgs_like
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    from h2o3_tpu_torch.models import metrics as MM
    from h2o3_tpu_torch.models.tree import shared_tree as pst
    from h2o3_tpu_torch.ops import cuda_build
    from h2o3_tpu_torch.tools.tree_parity import (
        auc_path,
        divergences,
        score_gaps,
    )

    df = higgs_like(N_ROWS, N_COLS, seed=0)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    nt = XGB_KW["ntrees"]

    def run(**kw):
        return fit(H2OXGBoostEstimator, fr, "label", **{**XGB_KW, **kw})

    caps0 = pst.GRAPH_EVENTS["captures"]
    (cold, cold_s), launches, warm_l = counted(run)
    caps_cold = pst.GRAPH_EVENTS["captures"] - caps0
    est, warm_s = run()
    caps_warm = pst.GRAPH_EVENTS["captures"] - caps0 - caps_cold
    replayed = {k: launches[k] - warm_l[k] for k in launches}
    expect = nt * XGB_KW["max_depth"]
    if not (caps_cold == 1 and caps_warm == 0
            and all(replayed[k] == expect
                    for k in ("hist", "hist_compact", "split"))
            and replayed["split_mono"] == 0):
        raise AssertionError(f"xgboost: launches {launches}, warm-up "
                             f"{warm_l}, captures {caps_cold}/{caps_warm}")
    variants = {}
    for label, kw in (("reg_alpha_0.5", dict(reg_alpha=0.5)),
                      ("scale_pos_weight_3", dict(scale_pos_weight=3.0))):
        c0 = pst.GRAPH_EVENTS["captures"]
        v, v_s = run(**kw)
        variants[label] = {"seconds": v_s, "trees_per_sec": nt / v_s,
                           "auc": v.auc(),
                           "captures": pst.GRAPH_EVENTS["captures"] - c0}
        if variants[label]["captures"] or not v.auc() > 0.8:
            raise AssertionError(f"xgboost {label}: {variants[label]}")
    # lambda = alpha = 0 with GBM's parameters: GBM's plan and trees
    g_est = gbm_headline
    c0 = pst.GRAPH_EVENTS["captures"]
    u, u_s = fit(H2OXGBoostEstimator, fr, "label", reg_lambda=0.0,
                 reg_alpha=0.0, gamma=1e-5, **GBM_KW)
    u_caps = pst.GRAPH_EVENTS["captures"] - c0
    parting = divergences(u, g_est)  # raises on a parting that is no tie
    leaf_diff = max(
        float(np.abs(a.leaf_val - b.leaf_val).max())
        for ga, gb in zip(u.model.output["trees"], g_est.model.output["trees"])
        for a, b in zip(ga[0].to_host().levels, gb[0].to_host().levels))
    dauc_u = abs(u.auc() - g_est.auc())
    if u_caps or dauc_u > 1e-5 or (
            parting["class_trees_equal"] == GBM_KW["ntrees"]
            and leaf_diff > 1e-5):
        raise AssertionError(f"xgboost unregularized: captures {u_caps}, "
                             f"auc {u.auc()} vs gbm {g_est.auc()}, splits "
                             f"{parting}, leaf values {leaf_diff}")
    # card against CPU, each model's AUC exact on the host from its own
    # predictions (the card's training AUC is bucketed: at eta 0.3 and
    # min_child_weight 1 the scores crowd its 1024 buckets)
    small = higgs_like(100_000, N_COLS, seed=1)
    y_small = (small["label"].to_numpy() == "s").astype(np.float64)
    pkw = {**XGB_KW, "ntrees": XGB_PARITY_TREES}

    def exact_auc(m, sfr):
        p = m.predict(sfr).vec("s").data.double().cpu().numpy()
        return MM.binomial_metrics(y_small, p)._v["auc"]

    pair, frames = {}, {}
    for d in ("cuda", "cpu"):
        frames[d] = sfr = h2o3_tpu_torch.upload_file(small, device=d)
        m, m_s = fit(H2OXGBoostEstimator, sfr, "label", **pkw)
        pair[d] = (m, m_s, exact_auc(m, sfr))
    (gp, gp_s, g_auc), (cp, cp_s, c_auc) = pair["cuda"], pair["cpu"]
    dauc = abs(g_auc - c_auc)
    sg = split_nodes(gp.model.output["trees"][0][0])
    sc = split_nodes(cp.model.output["trees"][0][0])
    # up to the first iteration that parts, both sides grow their trees on
    # the same scores: that iteration parts at float near-ties (raises
    # otherwise), and the scores entering it and their AUCs agree to float
    # noise
    parity_partings = divergences(gp, cp)
    parts = parity_partings["partings"]
    t_first = parts[0]["iteration"] if parts else XGB_PARITY_TREES
    later = [p["iteration"] for p in parts if not p["held"]][:1]
    score_gap = score_gaps(gp, cp, frames["cpu"], [t_first] + later)
    auc_first = (abs(auc_path(gp, frames["cpu"], y_small)[t_first - 1]
                     - auc_path(cp, frames["cpu"], y_small)[t_first - 1])
                 if t_first else 0.0)
    # past it the trajectories part, and which way B1's float sums decide
    # a near-tie varies between runs of the card: the CPU's final AUC is
    # held against the nearest of the card's repeats of the training
    rep_auc = [g_auc] + [
        exact_auc(fit(H2OXGBoostEstimator, frames["cuda"], "label",
                      **pkw)[0], frames["cuda"])
        for _ in range(XGB_PARITY_REPEATS - 1)]
    nearest = min(abs(a - c_auc) for a in rep_auc)
    if not (nearest < 1e-3 and sg == sc
            and score_gap[str(t_first)] <= XGB_SCORE_NOISE
            and auc_first <= XGB_PRE_PARTING_AUC):
        raise AssertionError(f"xgboost parity: exact auc delta {dauc} "
                             f"(nearest of {XGB_PARITY_REPEATS} card runs "
                             f"{nearest}), tree-0 splits equal={sg == sc}, "
                             f"first parting at iteration {t_first}: score "
                             f"gap entering it {score_gap}, auc delta "
                             f"{auc_first}")
    # the tmojo, scored offline
    out_dir = cuda_build.BUILD_DIR / "smoke_export_xgb"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    path = est.download_mojo(str(out_dir))
    export_s = time.perf_counter() - t0
    n_score = 100_000
    mojo = genmodel.MojoModel.load(path)
    t0 = time.perf_counter()
    scored = mojo.predict(df.drop(columns="label").iloc[:n_score])
    score_s = time.perf_counter() - t0
    want = est.predict(fr).vec("s").data[:n_score].double().cpu().numpy()
    merr = float(np.abs(np.asarray(scored["s"]) - want).max())
    if mojo.algo != "xgboost" or merr > 1e-6:
        raise AssertionError(f"xgboost tmojo: algo {mojo.algo}, max |mojo "
                             f"- predict| {merr}")
    p1 = est.predict(fr).vec("s").data
    if p1.shape != (N_ROWS,) or not bool(torch.isfinite(p1).all()):
        raise AssertionError("xgboost predictions not finite or misshapen")
    line = {"phase": "xgboost", "rows": N_ROWS, "cols": N_COLS, **XGB_KW,
            "cold_seconds": cold_s, "cold_trees_per_sec": nt / cold_s,
            "warm_seconds": warm_s, "warm_trees_per_sec": nt / warm_s,
            "auc": est.auc(), "auc_cold": cold.auc(),
            "captures_cold": caps_cold, "captures_warm": caps_warm,
            "launches": launches, "warmup_launches": warm_l,
            "replayed_launches": replayed, "variants": variants,
            "unregularized": {"seconds": u_s, "captures": u_caps,
                              "auc": u.auc(), "gbm_auc": g_est.auc(),
                              "auc_delta": dauc_u, "splits": parting,
                              "max_leaf_val_diff": leaf_diff},
            "parity": {"rows": 100_000, "ntrees": XGB_PARITY_TREES,
                       "auc_exact_cuda": g_auc, "auc_exact_cpu": c_auc,
                       "auc_exact_delta": dauc,
                       "auc_train_cuda_bucketed": gp.auc(),
                       "auc_train_cpu": cp.auc(),
                       "tree0_split_nodes": len(sg),
                       "trees": parity_partings,
                       "first_parting_iteration": t_first,
                       "max_score_gap_entering_iteration": score_gap,
                       "auc_exact_delta_entering_first_parting": auc_first,
                       "auc_exact_cuda_repeats": rep_auc,
                       "auc_exact_nearest_repeat_delta": nearest,
                       "cuda_seconds": gp_s, "cpu_seconds": cp_s},
            "export": {"seconds": export_s,
                       "bytes": os.path.getsize(path),
                       "score_rows": n_score, "score_seconds": score_s,
                       "max_abs_err": merr},
            "scoring_history": est.model.scoring_history}
    return line, {"launches": launches, "warmup_launches": warm_l}


# the DeepLearning headline: BASELINE.json configuration 4 as the JAX
# bench times it (bench.py's _bench_dl): an MNIST-shaped frame made on the
# card, 2 x 128 hidden, 1 epoch at batch 256, seed 3, Rectifier, ADADELTA
DL_ROWS, DL_COLS, DL_CLASSES = 100_000, 784, 10
DL_KW = dict(hidden=(128, 128), epochs=1.0, mini_batch_size=256, seed=3)
DL_AE_KW = dict(hidden=(128,), epochs=1.0, mini_batch_size=256, seed=3)
DL_PARITY_ROWS, DL_PARITY_EPOCHS = 10_000, 2
# graph against eager: the same float32 steps, so the same weights to the
# bit but for cuBLAS's choices between a capture and an eager launch
DL_PATH_TOL = 1e-5
# card against CPU: 2 epochs of 39 float32 ADADELTA steps, summed by
# cuBLAS and by the CPU's BLAS in other orders. The trajectory is chaotic
# at float32: a ReLU pre-activation that rounds across 0 flips a unit for
# a row, and ADADELTA's normalized steps carry the difference on.
# ``python -m h2o3_tpu_torch.tools.dl_parity`` on an NVIDIA H100 80GB HBM3
# (700 W) and its host: on the CPU alone, the first layer's initial
# weights one ulp up, or every feature one ulp up, moved the final
# weights by up to 2.1e-2 of the largest and the training logloss by up
# to 6.9e-4 relative at 20,000 rows (at 10,000 rows by 3.7e-7: a flip
# happens or not), while the card and the CPU ended 1.7e-2 and 5.9e-4
# apart at 10,000 rows (the same with the card's column statistics on the
# CPU) and 1.9e-2 and 9.5e-4 at 20,000. The first epoch's loss agreed
# within 9.6e-7 relative (1.9e-6 with the card's statistics on the CPU).
# Held to:
DL_PARITY_TOL = {"weights": 5e-2, "logloss": 2e-3, "first_epoch_loss": 1e-5}


def dl_fit(fr, autoencoder=False, **kw):
    """(model, seconds) of one DeepLearning training on ``fr``, to the
    card's end."""
    from h2o3_tpu_torch.estimators import (
        H2OAutoEncoderEstimator,
        H2ODeepLearningEstimator,
    )

    x = [n for n in fr.names if n != "label"]
    est = (H2OAutoEncoderEstimator(**kw) if autoencoder
           else H2ODeepLearningEstimator(**kw))
    if fr.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if autoencoder:
        est.train(x=x, training_frame=fr)
    else:
        est.train(x=x, y="label", training_frame=fr)
    if fr.device.type == "cuda":
        torch.cuda.synchronize()
    return est.model, time.perf_counter() - t0


@contextlib.contextmanager
def dl_steps(mode: str):
    """``deeplearning.STEP_MODE`` set to ``mode`` for the block."""
    from h2o3_tpu_torch.models import deeplearning as pdl

    saved = pdl.STEP_MODE
    pdl.STEP_MODE = mode
    try:
        yield
    finally:
        pdl.STEP_MODE = saved


def phase_dl() -> tuple[dict, tuple]:
    """The DeepLearning headline through ``H2ODeepLearningEstimator``:
    ``datasets.mnist_like`` (100,000 x 784 on the card, 10 classes), a
    cold training after emptying the DL state cache (one capture: the
    step block and the tail) and a warm one (no capture): seconds,
    rows/sec (rows x epochs / s), steps/sec, replays, host reads per
    epoch; a traced warm training (device idle share, the ``dl.*`` spans
    and their device ms); training logloss and accuracy of ``predict``
    (finite (n, 10) probabilities whose rows sum to 1); the eager step
    loop's training (one epoch, dropout off): its weights within
    ``DL_PATH_TOL`` of the graphs'. Returns the line and (model, frame)."""
    from h2o3_tpu_torch.datasets import mnist_like
    from h2o3_tpu_torch.models import deeplearning as pdl
    from h2o3_tpu_torch.tools.dl_parity import gaps
    from h2o3_tpu_torch.tools.profile_dl import LEAVES
    from h2o3_tpu_torch.tools.profile_glm import traced

    t0 = time.perf_counter()
    fr = mnist_like(DL_ROWS, DL_COLS, DL_CLASSES, seed=5)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    pdl.free_graphs()
    caps0 = pdl.SGD_EVENTS["captures"]
    cold, cold_s = dl_fit(fr, **DL_KW)
    caps_cold = pdl.SGD_EVENTS["captures"] - caps0
    warm, warm_s = dl_fit(fr, **DL_KW)
    caps_warm = pdl.SGD_EVENTS["captures"] - caps0 - caps_cold
    st = warm.output["sgd_stats"]
    trace = traced(lambda: dl_fit(fr, **DL_KW), prefix="dl.", leaves=LEAVES)
    with dl_steps("eager"):
        eager, eager_s = dl_fit(fr, **DL_KW)
    path_diff = gaps(warm, eager)["weights"]
    prob = torch.stack([warm.predict(fr).vec(str(k)).data
                        for k in range(DL_CLASSES)], 1)
    label = fr.vec("label").data.long()
    acc = float((prob.argmax(1) == label).float().mean())
    rowsum = float((prob.sum(1) - 1).abs().max())
    mm = warm.training_metrics
    line = {"phase": "dl", "rows": DL_ROWS, "cols": DL_COLS,
            "classes": DL_CLASSES, **DL_KW, "make_frame_s": make_s,
            "cold_train_s": cold_s, "warm_train_s": warm_s,
            "rows_per_s": DL_ROWS * st["epochs"] / warm_s,
            "steps_per_s": st["steps"] / warm_s,
            "captures_cold": caps_cold, "captures_warm": caps_warm,
            "capture_seconds": pdl.SGD_EVENTS["capture_seconds"],
            "sgd_stats": st,
            "host_reads_per_epoch": st["host_reads"] / st["epochs"],
            "device_idle_share": trace["device_idle_share"],
            "traced_wall_s": trace["traced_wall_s"],
            "device_busy_s": trace["device_busy_s"],
            "device_ms_by_span": trace["device_ms_by_span"],
            "host_spans_s": trace["host_spans_s"],
            "top_kernels_ms": trace["top_kernels_ms"][:8],
            "train_logloss": mm.logloss,
            "train_classification_error": mm.classification_error,
            "accuracy_predict": acc, "prob_rowsum_max_err": rowsum,
            "scoring_history": warm.scoring_history,
            "graph_against_eager": {"eager_train_s": eager_s,
                                    "weights_max_rel_diff": path_diff,
                                    "tolerance": DL_PATH_TOL,
                                    "eager_mode": eager.output[
                                        "sgd_stats"]["mode"]}}
    ok = (caps_cold == 1 and caps_warm == 0 and st["mode"] == "graph"
          and st["host_reads"] == st["epochs"]
          and cold.output["sgd_stats"]["captures"] == 1
          and eager.output["sgd_stats"]["mode"] == "eager"
          and path_diff <= DL_PATH_TOL and rowsum <= 1e-5
          and tuple(prob.shape) == (DL_ROWS, DL_CLASSES)
          and bool(torch.isfinite(prob).all()) and np.isfinite(mm.logloss)
          and acc > 1.0 / DL_CLASSES)
    if not ok:
        raise AssertionError(f"dl: {line}")
    return line, (warm, fr)


def phase_dl_autoencoder(fr) -> dict:
    """``H2OAutoEncoderEstimator`` (``hidden=(128,)``, 1 epoch) on the
    headline's features: cold and warm seconds, rows/sec, the training
    reconstruction MSE, ``anomaly`` over the frame (finite, one per row,
    its mean the training MSE within 1e-5 relative) and ``predict``'s
    784 ``reconstr_*`` columns."""
    from h2o3_tpu_torch.models import deeplearning as pdl

    caps0 = pdl.SGD_EVENTS["captures"]
    _, cold_s = dl_fit(fr, autoencoder=True, **DL_AE_KW)
    m, warm_s = dl_fit(fr, autoencoder=True, **DL_AE_KW)
    caps = pdl.SGD_EVENTS["captures"] - caps0
    an = m.anomaly(fr).vec(0).data
    an_mean = float(an.double().mean())
    pred = m.predict(fr)
    mse = m.training_metrics.mse
    line = {"phase": "dl_autoencoder", "rows": DL_ROWS, "cols": DL_COLS,
            **DL_AE_KW, "cold_train_s": cold_s, "warm_train_s": warm_s,
            "rows_per_s": DL_ROWS / warm_s, "captures": caps,
            "sgd_stats": m.output["sgd_stats"],
            "train_recon_mse": mse, "anomaly_mean": an_mean,
            "anomaly_max": float(an.max()),
            "predict_cols": pred.ncol,
            "scoring_history": m.scoring_history}
    ok = (caps == 1 and an.shape == (DL_ROWS,)
          and bool(torch.isfinite(an).all()) and np.isfinite(mse)
          and abs(an_mean - mse) <= 1e-5 * mse and pred.ncol == DL_COLS
          and pred.names[0] == "reconstr_p0")
    if not ok:
        raise AssertionError(f"dl_autoencoder: {line}")
    return line


def phase_dl_parity(fr) -> dict:
    """Card against CPU: the headline's network on the first 10,000 rows
    for 2 epochs with dropout off, from the same initial weights (drawn on
    the CPU for both): final weights (over the largest), the first
    epoch's loss and the training logloss (relative) within
    ``DL_PARITY_TOL``; beside them, reported, the CPU against itself with
    the first layer's initial weights one ulp up (the float32
    trajectory's own sensitivity)."""
    from h2o3_tpu_torch.models import deeplearning as pdl
    from h2o3_tpu_torch.tools.dl_parity import (
        first_layer_one_ulp_up,
        gaps,
        head,
    )

    cpu = head(fr, DL_PARITY_ROWS, "cpu")
    card = head(fr, DL_PARITY_ROWS, "cuda")
    kw = dict(DL_KW, epochs=float(DL_PARITY_EPOCHS))
    g, g_s = dl_fit(card, **kw)
    c, c_s = dl_fit(cpu, **kw)
    init = pdl.init_mlp
    pdl.init_mlp = first_layer_one_ulp_up(init)
    try:
        u, _ = dl_fit(cpu, **kw)
    finally:
        pdl.init_mlp = init
    gap = gaps(g, c)
    line = {"phase": "dl_parity", "rows": DL_PARITY_ROWS, "cols": DL_COLS,
            **kw, "cuda_train_s": g_s, "cpu_train_s": c_s,
            "cuda_against_cpu": gap,
            "cpu_one_ulp_sensitivity": gaps(u, c),
            "epoch_losses_cuda": [h["loss"] for h in g.scoring_history],
            "epoch_losses_cpu": [h["loss"] for h in c.scoring_history],
            "logloss_cuda": g.training_metrics.logloss,
            "logloss_cpu": c.training_metrics.logloss,
            "tolerance": DL_PARITY_TOL}
    if not (all(gap[k] <= v for k, v in DL_PARITY_TOL.items())
            and len(g.scoring_history) == 2):
        raise AssertionError(f"dl_parity: {line}")
    return line


def phase_dl_export(model, fr) -> dict:
    """The headline model through ``download_mojo``: the artifact's bytes
    and export seconds, and its 100,000 rows scored offline by the port's
    ``genmodel`` within 1e-6 of ``predict`` in every probability column,
    the labels equal."""
    from h2o3_tpu_torch import genmodel
    from h2o3_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR / "smoke_export_dl"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = str(out_dir / "dl.zip")
    t0 = time.perf_counter()
    model.download_mojo(path)
    export_s = time.perf_counter() - t0
    table = {n: fr.vec(n).data.cpu().numpy() for n in fr.names
             if n != "label"}
    mojo = genmodel.MojoModel.load(path)
    t0 = time.perf_counter()
    scored = mojo.predict(table)
    score_s = time.perf_counter() - t0
    pred = model.predict(fr)
    err = max(float(np.abs(np.asarray(scored[str(k)])
                           - pred.vec(str(k)).data.double().cpu().numpy())
                    .max()) for k in range(DL_CLASSES))
    labels_equal = float(np.mean(
        np.asarray(scored["predict"]).astype(int)
        == pred.vec("predict").data.cpu().numpy()))
    line = {"phase": "dl_export", "bytes": os.path.getsize(path),
            "export_s": export_s, "score_rows": DL_ROWS,
            "score_s": score_s, "max_abs_err": err,
            "label_agreement": labels_equal}
    if mojo.algo != "deeplearning" or err > 1e-6:
        raise AssertionError(f"dl_export: {line}")
    return line


# slice 13: AutoML (the bench's configuration and the Santander-shaped full
# leaderboard: tools/profile_automl.py's BENCH, SANTANDER and frame_for)
# card against CPU: a small AutoML on the first rows of the headline frame
AML_PARITY_ROWS = 20_000
AML_PARITY_KW = dict(max_models=4, nfolds=3, seed=7,
                     include_algos=["GBM", "GLM"])
# the metalearner card against CPU: glm_parity's bounds
META_COEF_TOL, META_DEVIANCE_RTOL = 1e-4, 1e-5


@contextlib.contextmanager
def se_scoring_spans():
    """``(start, end)`` of every ``StackedEnsembleModel._predict_raw`` call
    in the block (every base model's prediction and the metalearner's),
    the card synchronised at both ends of each."""
    from h2o3_tpu_torch.models.ensemble import StackedEnsembleModel

    spans, orig = [], StackedEnsembleModel._predict_raw

    def timed(self, frame):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, frame)
        torch.cuda.synchronize()
        spans.append((t0, time.perf_counter()))
        return out

    StackedEnsembleModel._predict_raw = timed
    try:
        yield spans
    finally:
        StackedEnsembleModel._predict_raw = orig


def automl_run(fr, y, kw):
    """One AutoML run on ``fr``, counted (:func:`counted`) and with its
    host syncs and ensemble scoring recorded. Returns (the AutoML, its
    seconds, launches, warm-up launches, its per-step rows)."""
    from h2o3_tpu_torch.automl import AutoML
    from h2o3_tpu_torch.tools.profile_automl import HostReads, steps_table

    def run():
        aml = AutoML(**kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aml.train(y=y, training_frame=fr)
        torch.cuda.synchronize()
        return aml, time.perf_counter() - t0

    with HostReads() as reads, se_scoring_spans() as spans:
        (aml, secs), launches, warm = counted(run)
    steps = steps_table(aml, reads)
    for row, r in zip(steps, aml.step_log):
        if r["kind"] == "ensemble":
            row["se_scoring_s"] = sum(b - a for a, b in spans
                                      if r["t0"] <= a and b <= r["t1"])
    return aml, secs, launches, warm, steps


def leaderboard_rows(aml) -> list:
    return [[r["model_id"], r["algo"], r.get("auc"), r.get("logloss")]
            for r in aml.leaderboard.as_table()]


def check_sorted(name, aml) -> None:
    """The leaderboard sorted by AUC, descending, and equal to a host
    re-sort of the same values (stable: ties keep the build order)."""
    vals = [r["auc"] for r in aml.leaderboard.as_table()]
    order = sorted(range(len(vals)),
                   key=lambda i: (np.isnan(vals[i]), -vals[i]))
    if order != list(range(len(vals))):
        raise AssertionError(f"{name}: leaderboard not sorted by AUC: {vals}")


def phase_automl() -> dict:
    """The JAX bench's AutoML (``bench.py::_bench_automl``): GBM and GLM,
    max_models 3, no folds, seed 11, on the first 50,000 rows of the 1M
    Higgs-like frame, twice in one process after the graph caches were
    emptied: cold (every plan captured) and warm. Gates: 3 models, the
    leaderboard sorted by AUC and equal to a host re-sort, 0 captures in
    the warm pass (the kernels are built before; the cold-warm gap is
    graph capture)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.models.glm import GLM
    from h2o3_tpu_torch.models.tree import shared_tree as pst
    from h2o3_tpu_torch.tools.profile_automl import BENCH, frame_for

    df, y = frame_for("higgs", None)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    pst.free_graphs()
    GLM.free_graphs()
    line = {"phase": "automl", "rows": fr.nrow, "cols": N_COLS, **BENCH}
    for name in ("cold", "warm"):
        aml, secs, launches, warm, steps = automl_run(fr, y, BENCH)
        caps = {k: sum(s["captures"][k] for s in steps)
                for k in ("tree_graphs", "admm_blocks", "dl_plans")}
        line[name] = {"seconds": secs, "models": len(aml.leaderboard.models),
                      "captures": caps, "launches": launches,
                      "warmup_launches": warm, "steps": steps,
                      "host_syncs": sum(s["host_syncs"] for s in steps),
                      "leaderboard": leaderboard_rows(aml),
                      "leader_auc": aml.leader.training_metrics.value("auc")}
        check_sorted(f"automl {name}", aml)
        if len(aml.leaderboard.models) != 3:
            raise AssertionError(f"automl {name}: {line[name]}")
    line["cold_s"], line["warm_s"] = line["cold"]["seconds"], line["warm"][
        "seconds"]
    if any(line["warm"]["captures"].values()):
        raise AssertionError(f"automl: the warm pass captured: {line}")
    return line


def phase_automl_santander() -> tuple[dict, tuple]:
    """The full leaderboard at full width: JAX's default plan (nfolds 5,
    max_models 10, seed 1) on ``datasets.santander_like`` (200,000 x 200
    float columns, ~10% positives), counted as the kernels line's
    ``automl`` run. Per step: seconds, models, captures, host syncs,
    kernel launches, and the ensembles' scoring seconds. Gates: both
    ensembles built; every other model's ``cv_predictions`` on the card
    with a row per frame row; every model's CV metrics within 1e-6 of a
    host recomputation from its holdout (the ensembles': their
    metalearner's); the "all" ensemble's training AUC at least the best
    base model's CV AUC less 0.02; ``predict``'s probabilities in [0, 1]
    with rows summing to 1 within 1e-6. Returns its line and (launches,
    warm-up launches, the "all" ensemble, the frame)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.tools.profile_automl import SANTANDER, frame_for

    t0 = time.perf_counter()
    df, y = frame_for("santander", None)
    y_np = (df[y].to_numpy() == "1").astype(np.float64)
    fr = h2o3_tpu_torch.upload_file(df, device="cuda")
    make_s = time.perf_counter() - t0
    aml, secs, launches, warm, steps = automl_run(fr, y, SANTANDER)
    models = aml.leaderboard.models
    ses = {s: m for s, m in _steps_built(aml).items()
           if m.algo == "stackedensemble"}
    line = {"phase": "automl_santander", "rows": fr.nrow, "cols": fr.ncol,
            "features": fr.ncol - 2, **SANTANDER,
            "positive_share": float(y_np.mean()), "make_frame_s": make_s,
            "seconds": secs, "models": len(models),
            "launches": launches, "warmup_launches": warm, "steps": steps,
            "captures": {k: sum(s["captures"][k] for s in steps)
                         for k in ("tree_graphs", "admm_blocks",
                                   "dl_plans")},
            "host_syncs": sum(s["host_syncs"] for s in steps),
            "dl_grid_reached": any(s["step"] == "grid_dl" for s in steps),
            "note": "the DeepLearning grid is not reached: max_models is "
                    "spent by the nine preset models and the GBM grid's one",
            "leaderboard": leaderboard_rows(aml),
            "errors": [e["message"] for e in aml.event_log
                       if e["stage"] == "error"]}
    check_sorted("automl_santander", aml)
    if line["errors"] or set(ses) != {"se_best_of_family", "se_all"}:
        raise AssertionError(f"automl_santander: {line}")
    checks = {}
    for m in models:
        hold = (m.metalearner.cv_predictions if m.algo == "stackedensemble"
                else m.cv_predictions)
        if (hold is None or hold.device.type != "cuda"
                or hold.shape[0] != fr.nrow):
            raise AssertionError(f"automl_santander: {m.key} holdout "
                                 f"{None if hold is None else hold.shape}")
        checks[m.key] = cv_metrics_against_host(
            f"automl_santander {m.key}", m, hold, y_np)["cv_metrics_max_diff"]
    line["cv_metrics_max_diff"] = checks
    se = ses["se_all"]
    best = max(m.cross_validation_metrics.value("auc") for m in se.base_models)
    line["se_all"] = {"train_auc": se.training_metrics.value("auc"),
                      "cv_auc": se.cross_validation_metrics.value("auc"),
                      "best_base_cv_auc": best,
                      "base_models": len(se.base_models),
                      "coef": {k: float(v) for k, v in
                               se.metalearner.coef.items()}}
    if line["se_all"]["train_auc"] < best - 0.02:
        raise AssertionError(f"automl_santander: {line['se_all']}")
    for name, m in (("leader", aml.leader), ("se_all", se)):
        pred = m.predict(fr)
        P = torch.stack([pred.vec(d).data for d in ("0", "1")], dim=1)
        span = float((P.sum(dim=1) - 1).abs().max())
        if not (bool(((P >= 0) & (P <= 1)).all()) and span <= 1e-6):
            raise AssertionError(f"automl_santander: {name}'s predict: "
                                 f"rows sum to 1 within {span}")
        line[f"{name}_predict_row_sum_err"] = span
    return line, (launches, warm, se, fr)


def _steps_built(aml) -> dict:
    """step name -> the model it built (model and ensemble steps)."""
    keys = {m.key: m for m in aml.leaderboard.models}
    out = {}
    for e in aml.event_log:
        if e["stage"] in ("model", "ensemble") and " -> " in e["message"]:
            step, rest = e["message"].split(" -> ")
            out[step] = keys[rest.split()[0]]
    return out


def phase_automl_parity(se, fr) -> dict:
    """Card against CPU without the trees' near-ties: the Santander run's
    "all" ensemble's level-one CV matrix, response and weights copied to
    the CPU and its metalearner fit there with the same parameters:
    coefficients within 1e-4 and deviance within 1e-5 relative (the GLM
    bounds of ``glm_parity``). Then a small AutoML (GBM and GLM,
    max_models 4, 3 folds, seed 7) on the first 20,000 rows of the
    headline frame on both devices: each model's CV AUC pair and both
    leaderboard orders, reported, not gated (the card parts from the CPU
    at gain near-ties, PERF.md §6 PR 12)."""
    import h2o3_tpu_torch
    from h2o3_tpu_torch.models import ensemble as E

    ref = se.base_models[0]
    L = E._level_one_cv_matrix(se.base_models)
    y, w = ref._response_and_weights(fr)
    b = E.StackedEnsemble(base_models=se.base_models, seed=se.params.seed)
    b._meta_weights = w is not None
    domain = ref.output["response_domain"]
    t0 = time.perf_counter()
    cpu = b._make_metalearner(True, len(domain)).train(
        y="y", training_frame=E._matrix_frame(
            L.cpu(), y.cpu(), domain, None if w is None else w.cpu()))
    cpu_s = time.perf_counter() - t0
    card = se.metalearner
    cc = {k: float(v) for k, v in card.coef.items()}
    pc = {k: float(v) for k, v in cpu.coef.items()}
    dev_card = float(card.residual_deviance)
    dev_cpu = float(cpu.residual_deviance)
    dcoef = max(abs(cc[k] - pc[k]) for k in cc)
    ddev = abs(dev_card - dev_cpu) / abs(dev_cpu)
    line = {"phase": "automl_parity",
            "metalearner": {"level_one_cols": L.shape[1],
                            "level_one_device": str(L.device),
                            "coef_cuda": cc, "coef_cpu": pc,
                            "coef_max_diff": dcoef,
                            "deviance_cuda": dev_card,
                            "deviance_cpu": dev_cpu,
                            "deviance_rel_diff": ddev,
                            "cpu_seconds": cpu_s}}
    if dcoef > META_COEF_TOL or ddev > META_DEVIANCE_RTOL:
        raise AssertionError(f"automl_parity: metalearner {line}")
    from h2o3_tpu_torch.automl import AutoML
    from h2o3_tpu_torch.tools.profile_automl import frame_for

    df, y = frame_for("higgs", AML_PARITY_ROWS)
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        aml = AutoML(**AML_PARITY_KW)
        aml.train(y=y,
                  training_frame=h2o3_tpu_torch.upload_file(df, device=dev))
        runs[dev] = {"seconds": time.perf_counter() - t0,
                     "cv_auc": {s: m.cross_validation_metrics.value("auc")
                                for s, m in _steps_built(aml).items()},
                     "leaderboard_steps": [
                         {m.key: s for s, m in _steps_built(aml).items()}[
                             m.key] for m in aml.leaderboard.models]}
    line["small_automl"] = {
        "rows": AML_PARITY_ROWS, **AML_PARITY_KW, **runs,
        "cv_auc_max_diff": max(abs(runs["cuda"]["cv_auc"][s]
                                   - runs["cpu"]["cv_auc"][s])
                               for s in runs["cpu"]["cv_auc"]),
        "same_order": runs["cuda"]["leaderboard_steps"]
        == runs["cpu"]["leaderboard_steps"]}
    return line


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
    main_line, headline = phase_main()
    emit(main_line)
    emit(phase_whole_tree())
    emit(phase_parity())
    mono_lines, (mono_launches, mono_warm) = phase_mono()
    for line in mono_lines:
        emit(line)
    emit(phase_parity("mono_parity", monotone_constraints=MONO))
    mn_line, mn_model = phase_multinomial()
    emit(mn_line)
    emit(phase_multinomial_parity(mn_model[1]))
    drf_line, drf_model = phase_drf()
    emit(drf_line)
    wide_line, wide = phase_kernels_wide(drf_model)
    emit(wide_line)
    emit(phase_drf_parity())
    emit(phase_drf_multinomial())
    emit(phase_gbm_sampled())
    emit(phase_parity("gbm_sampled_parity", **GBM_SAMPLED))
    export_line = phase_export(headline, mn_model)
    export_line["drf"] = export_drf(*drf_model)
    emit(export_line)
    glm_line, glm_model = phase_glm()
    emit(glm_line)
    air_line, air_model = phase_glm_airlines()
    emit(air_line)
    emit(phase_glm_families())
    mn_glm_line, mn_glm = phase_glm_multinomial()
    emit(mn_glm_line)
    ord_line, ord_model = phase_glm_ordinal()
    emit(ord_line)
    ia_line, ia_model = phase_glm_interactions()
    emit(ia_line)
    parity, mn_export = phase_glm_parity(glm_model[1], air_model[1],
                                         mn_glm[1], ord_model[1])
    emit(parity)
    del mn_glm
    emit(phase_glm_export({
        "glm": (glm_model, "label", ["s"], 1e-5),
        "glm_airlines": (air_model, "IsDepDelayed", ["YES"], 1e-5),
        "glm_multinomial": (mn_export, "rating",
                            ["1", "2", "3", "4", "5"], 1e-6),
        "glm_ordinal": (ord_model, "rating", ["1", "2", "3", "4", "5"],
                        1e-6),
        "glm_interactions": (ia_model, "IsDepDelayed", ["NO", "YES"],
                             1e-6)}))
    del glm_model, air_model, ord_model, ia_model, mn_export
    emit(phase_bin_edges())
    emit(phase_frame())
    cv_line = phase_cv()
    emit(cv_line)
    emit(phase_max_runtime())
    xgb_line, xgb_counts = phase_xgboost(headline[0])
    emit(xgb_line)
    dl_line, (dl_model, dl_frame) = phase_dl()
    emit(dl_line)
    emit(phase_dl_autoencoder(dl_frame))
    emit(phase_dl_parity(dl_frame))
    emit(phase_dl_export(dl_model, dl_frame))
    del dl_model, dl_frame
    emit(phase_automl())
    sant_line, (sant_launches, sant_warm, se_all, sant_fr) = \
        phase_automl_santander()
    emit(sant_line)
    emit(phase_automl_parity(se_all, sant_fr))
    del se_all, sant_fr
    launches = {**main_line["launches"],
                "split_mono": mono_launches["split_mono"]}
    warmups = {**main_line["warmup_launches"],
               "split_mono": mono_warm["split_mono"]}
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
            # launches on the card in the main path's run: inside graph
            # replays, plus those of the capture's eager warm-up tree
            "launches": launches[name],
            "warmup_launches": warmups[name],
            "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "device_ms": m["device_ms"], "graph_ms": m["graph_ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
            "bound_by": m["bound_by"], "library_ms": m["library_ms"],
            "shape": shape,
        })
        if name != "split_mono":  # B3 does not run on the multinomial path
            mm = meas[f"{name}_multinomial"]
            kernels[-1]["multinomial"] = {
                "launches": mn_line["launches"][name],
                "warmup_launches": mn_line["warmup_launches"][name],
                **{k: mm[k] for k in ("max_abs_err", "ms", "device_ms",
                                      "graph_ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
                "shape": f"{MN_ROWS} x {MN_COLS} (padded to {mm.get('cols')}"
                         ") u8, 8 nodes, 256 bins, 3 lanes"
                if name != "hist_compact" else f"{MN_ROWS} nid, 8 nodes"}
            # the DRF headline's launches, and the kernel at its saturated
            # widths on a real depth-12 nid (2048 nodes; 1024 built)
            kernels[-1]["drf"] = {
                "launches": drf_line["launches"][name],
                "warmup_launches": drf_line["warmup_launches"][name],
                **{f"at_{N}_nodes": {k: wide[f"{name}_{N}"][k] for k in (
                    "max_abs_err", "ms", "device_ms", "graph_ms", "plain_ms",
                    "bound_ms", "bound_by", "library_ms")}
                   for N in (1024, 2048)}}
        else:
            kernels[-1]["drf"] = {
                "launches": drf_line["launches"][name],
                "warmup_launches": drf_line["warmup_launches"][name]}
        # slice 11's paths, each counted as its own run: the cold GBM
        # cross-validation (main model and 5 folds, its capture's warm-up
        # included) and XGBoost at its defaults (cold)
        cv_gbm = cv_line["gbm"]["cold"]
        kernels[-1]["cv"] = {
            "launches": cv_gbm["launches"][name],
            "warmup_launches": cv_gbm["warmup_launches"][name]}
        kernels[-1]["xgboost"] = {
            "launches": xgb_counts["launches"][name],
            "warmup_launches": xgb_counts["warmup_launches"][name]}
        # slice 13: the Santander-shaped AutoML run, counted as one run
        kernels[-1]["automl"] = {"launches": sant_launches[name],
                                 "warmup_launches": sant_warm[name]}
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
