"""Weighted Gram and the GLM solves — the port of ``h2o3_tpu/ops/gram.py``.

The Gram ``XᵀWX`` and ``XᵀWz`` is one float32 product over the design
matrix on its device. The JAX package computes it at
``precision=HIGHEST``; here every product runs inside :func:`full_fp32`,
which turns TF32 off for its duration whatever the caller set, so the card
computes it in full float32.

The solves come in two lanes, as in JAX:
- on the device, float32, with no host read inside a solve step:
  :func:`cho_solve_jitter_device` (Cholesky with a jitter ladder, the
  first rung whose factorization succeeds and whose solve is finite wins)
  and :class:`AdmmSolver` (the elastic-net ADMM loop, up to 500 steps with
  JAX's stopping rule, run in blocks of masked steps: the host reads one
  flag per block, and on the card each block is one CUDA-graph replay);
- on the host, float64: :func:`solve_cholesky` and
  :func:`admm_elastic_net` (the per-iteration lane under
  ``H2O3_TPU_GLM_FUSE=0`` and the tail a non-finite device solve hands a
  lambda to).
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.linalg
import torch


@contextlib.contextmanager
def full_fp32():
    """Float32 matrix products in full precision (no TF32) for the block's
    duration, whatever the caller set, restoring the caller's setting
    after. Uses the backend's ``fp32_precision`` where PyTorch has it (the
    legacy ``allow_tf32`` flag otherwise; the two may not be mixed)."""
    m = torch.backends.cuda.matmul
    new_api = hasattr(m, "fp32_precision")
    saved = m.fp32_precision if new_api else m.allow_tf32
    if new_api:
        m.fp32_precision = "ieee"
    else:
        m.allow_tf32 = False
    try:
        yield
    finally:
        if new_api:
            m.fp32_precision = saved
        else:
            m.allow_tf32 = saved


# rows per partial Gram: the whole chunks run as one batched float32 GEMM
# and their products add in float64, so no float32 sum runs over more than
# this many rows. On the H100, one float32 GEMM over the 1M rows of the
# Airlines-shaped design (636 columns) is ~1e-5 off a float64 Gram
# (relative Frobenius); 4,096-row chunks are ~4e-7 off at about the same
# time, and larger chunks are worse, since a batch's GEMM does not split
# its rows further (python -m h2o3_tpu_torch.tools.bench_gram; PERF.md).
# The partial Grams take n/4096·p²·4 bytes (395 MB at 1M x 636).
GRAM_CHUNK_ROWS = 1 << 12


def weighted_gram(X, w, z, keep_f64: bool = False):
    """``(G, b, sw)`` = (XᵀWX, XᵀWz, Σw) for diagonal W, float32 out (G and
    b kept in float64 with ``keep_f64``): the rows in chunks of
    :data:`GRAM_CHUNK_ROWS`, each chunk's product in full float32 (one
    batched GEMM for all whole chunks, one GEMM for the rest), the chunk
    products added in float64."""
    n, p = X.shape
    R = GRAM_CHUNK_ROWS
    k = n // R
    f64 = torch.float64
    G = torch.zeros((p, p), dtype=f64, device=X.device)
    b = torch.zeros(p, dtype=f64, device=X.device)
    with full_fp32():
        Xw = X * w[:, None]
        if k:
            A = Xw[: k * R].view(k, R, p).transpose(1, 2)
            G += torch.bmm(A, X[: k * R].view(k, R, p)).sum(0, dtype=f64)
            b += torch.bmm(A, z[: k * R].view(k, R, 1))[..., 0].sum(
                0, dtype=f64)
        if n > k * R:
            G += (Xw[k * R:].T @ X[k * R:]).double()
            b += (Xw[k * R:].T @ z[k * R:]).double()
    if keep_f64:
        return G, b, w.sum(dtype=torch.float32)
    return G.float(), b.float(), w.sum(dtype=torch.float32)


def _cho_solve(L, r):
    """Solve ``L Lᵀ x = r`` by two triangular solves (LAPACK's potrs)."""
    y = torch.linalg.solve_triangular(L, r[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


# jitter ladder mirroring solve_cholesky's host escalation: first try is
# bare, then max(1e-10, 10x) per retry — six attempts before the caller's
# float64 lane
_JITTERS = (0.0, 1e-10, 1e-9, 1e-8, 1e-7, 1e-6)


def cho_solve_jitter_device(G, b, extra_diag=None):
    """On-device SPD solve with jitter escalation, float32. Every rung of
    the ladder is factored at once (one batched ``cholesky_ex``); a rung is
    taken when its factorization reports success (``info == 0``) and its
    solve is finite — the rungs JAX's ``cho_factor`` (NaNs on failure)
    accepts. Returns ``(x, ok)`` as device tensors, with no host read;
    ``ok`` False routes the caller to the host float64 lane.
    ``extra_diag`` is a per-column additive diagonal (the ridge, and the
    unit diagonal that keeps padded columns invertible at zero)."""
    p = G.shape[0]
    if extra_diag is not None:
        G = G + torch.diag(extra_diag)
    jit = torch.tensor(_JITTERS, dtype=G.dtype, device=G.device)
    eye = torch.eye(p, dtype=G.dtype, device=G.device)
    A = G[None] + jit[:, None, None] * eye[None]
    with full_fp32():
        L, info = torch.linalg.cholesky_ex(A)
        xs = _cho_solve(L, b.expand(len(_JITTERS), p))
    okj = (info == 0) & torch.isfinite(xs).all(dim=1)
    first = torch.argmax(okj.to(torch.int32))  # lowest ok rung
    ok = okj.any()
    x = torch.where(ok, xs[first], torch.zeros_like(b))
    return x, ok


# block graphs captured by the ADMM solvers (one per solver, at its first
# block on the card): a warm training, or the folds of a cross-validation,
# add none
ADMM_EVENTS = {"captures": 0}


class AdmmSolver:
    """The device ADMM elastic net — JAX's ``admm_elastic_net_device``:
    minimize ½βᵀGβ − bᵀβ + l2/2‖β‖² + l1‖β‖₁ (the intercept unpenalized),
    with the same rho heuristic, soft-threshold step and stopping rule
    (``max|z−z_old| < tol`` and ``max|x−z| < tol``, at most ``iters``
    steps).

    JAX stops its ``while_loop`` at the first step that is done; here a step
    is masked: once ``done`` (or ``i == iters``, or the caller's ``frozen``
    flag) holds, ``torch.where`` keeps the state, so extra steps change
    nothing. The steps run in blocks of ``block``; the host reads one pair
    of flags per block (finished, frozen). On the card one block is one
    CUDA-graph replay over fixed buffers, captured once per (width,
    ``non_negative``) and device.

    One solver serves a training's solves of one width: ``reads`` counts
    its host reads, ``i`` holds the last solve's step count (a device
    scalar) and ``last_frozen`` whether its last read found ``frozen``."""

    def __init__(self, p: int, device, non_negative: bool = False,
                 iters: int = 500, tol: float = 1e-6, block: int = 25,
                 use_graph: bool | None = None):
        dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.p, self.block, self.non_negative = p, block, non_negative
        self.L = torch.zeros((p, p), **f32)
        self.b = torch.zeros(p, **f32)
        self.rho = torch.zeros((), **f32)
        self.thr = torch.zeros(p, **f32)
        self.neg_mask = torch.zeros(p, dtype=torch.bool, device=dev)
        self.x = torch.zeros(p, **f32)
        self.z = torch.zeros(p, **f32)
        self.u = torch.zeros(p, **f32)
        self.i = torch.zeros((), dtype=torch.int32, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.frozen = torch.zeros((), dtype=torch.bool, device=dev)
        self.iters = torch.tensor(iters, dtype=torch.int32, device=dev)
        self.tol = torch.tensor(tol, **f32)
        self.use_graph = (dev.type == "cuda") if use_graph is None else use_graph
        self.graph = None
        self.reads = 0
        self.blocks = 0
        self.last_frozen = False

    def _steps(self) -> None:
        """``block`` masked ADMM steps on the buffers, in place."""
        for _ in range(self.block):
            x = _cho_solve(self.L, self.b + self.rho * (self.z - self.u))
            v = x + self.u
            z_new = torch.sign(v) * torch.clamp(torch.abs(v) - self.thr,
                                                min=0.0)
            if self.non_negative:
                z_new = torch.where(self.neg_mask & (z_new < 0), 0.0, z_new)
            done_new = ((torch.max(torch.abs(z_new - self.z)) < self.tol)
                        & (torch.max(torch.abs(x - z_new)) < self.tol))
            act = ~self.done & (self.i < self.iters) & ~self.frozen
            self.u.copy_(torch.where(act, self.u + x - z_new, self.u))
            self.x.copy_(torch.where(act, x, self.x))
            self.z.copy_(torch.where(act, z_new, self.z))
            self.i.add_(act.to(torch.int32))
            self.done.logical_or_(act & done_new)

    def _run_block(self) -> None:
        if not self.use_graph:
            with full_fp32():
                self._steps()
            return
        if self.graph is None:
            from h2o3_tpu_torch.ops.cuda_graph import LaunchGraph, warm_up

            saved = [t.clone() for t in (self.x, self.z, self.u, self.i,
                                         self.done)]
            with full_fp32():
                warm_up(self._steps, self.x.device)
            for t, s in zip((self.x, self.z, self.u, self.i, self.done),
                            saved):
                t.copy_(s)
            with full_fp32():
                self.graph = LaunchGraph(self._steps)
            ADMM_EVENTS["captures"] += 1
        self.graph.replay()

    def solve(self, G, b, l1, l2, icpt: int, pad_diag, real_p: float,
              frozen=None):
        """``(z, ok)`` for one Gram; ``l1``/``l2`` float32 device scalars,
        ``icpt`` the intercept's column (-1: none), ``pad_diag`` the unit
        diagonal of the padded columns, ``real_p`` the true width (the rho
        mean). ``frozen`` (a device bool) marks a solve whose result the
        caller will discard: the steps stop at the next block."""
        p = self.p
        ar = torch.arange(p, device=G.device)
        diag = torch.diagonal(G)
        rho = torch.clamp(torch.sum(diag * (1.0 - pad_diag))
                          / max(float(real_p), 1.0), min=1e-3)
        A = (G + torch.diag(pad_diag)
             + (l2 + rho) * torch.eye(p, dtype=G.dtype, device=G.device))
        with full_fp32():
            L, info = torch.linalg.cholesky_ex(A)
        self.L.copy_(L)
        self.b.copy_(b)
        self.rho.copy_(rho)
        self.thr.copy_(torch.where(ar == icpt, 0.0, l1 / rho))
        self.neg_mask.copy_(ar != icpt)
        for t in (self.x, self.z, self.u):
            t.zero_()
        self.i.zero_()
        self.done.zero_()
        self.frozen.copy_(torch.zeros((), dtype=torch.bool, device=G.device)
                          if frozen is None else frozen)
        while True:
            self._run_block()
            self.blocks += 1
            fin = self.done | (self.i >= self.iters) | self.frozen
            fin, self.last_frozen = torch.stack([fin, self.frozen]).tolist()
            self.reads += 1
            if fin:
                break
        ok = ((info == 0) & torch.isfinite(self.z).all()
              & torch.isfinite(L).all())
        return self.z.clone(), ok


def solve_cholesky(G: np.ndarray, b: np.ndarray, ridge: float = 0.0) -> np.ndarray:
    """Host-side SPD solve with jitter escalation, float64."""
    G = np.asarray(G, np.float64)
    b = np.asarray(b, np.float64)
    p = G.shape[0]
    jitter = 0.0
    for _ in range(6):
        try:
            c, low = scipy.linalg.cho_factor(
                G + (ridge + jitter) * np.eye(p), lower=True)
            return scipy.linalg.cho_solve((c, low), b)
        except np.linalg.LinAlgError:
            jitter = max(1e-10, jitter * 10 or 1e-10)
    return np.linalg.lstsq(G + ridge * np.eye(p), b, rcond=None)[0]


def admm_elastic_net(
    G: np.ndarray,
    b: np.ndarray,
    l1: float,
    l2: float,
    intercept_idx: int | None,
    rho: float | None = None,
    iters: int = 500,
    tol: float = 1e-6,
    non_negative: bool = False,
) -> np.ndarray:
    """Host ADMM elastic net, float64: minimize ½βᵀGβ − bᵀβ + l2/2‖β‖² +
    l1‖β‖₁ (intercept unpenalized)."""
    G = np.asarray(G, np.float64)
    b = np.asarray(b, np.float64)
    p = G.shape[0]
    if rho is None:
        rho = max(1e-3, np.mean(np.diag(G)))
    A = G + (l2 + rho) * np.eye(p)
    c, low = scipy.linalg.cho_factor(A, lower=True)
    x = np.zeros(p)
    z = np.zeros(p)
    u = np.zeros(p)
    thr = np.full(p, l1 / rho)
    if intercept_idx is not None:
        thr[intercept_idx] = 0.0
    for _ in range(iters):
        x = scipy.linalg.cho_solve((c, low), b + rho * (z - u))
        z_old = z
        v = x + u
        z = np.sign(v) * np.maximum(np.abs(v) - thr, 0.0)
        if non_negative:
            neg = np.arange(p) != (intercept_idx if intercept_idx is not None else -1)
            z = np.where(neg & (z < 0), 0.0, z)
        u = u + x - z
        if np.max(np.abs(z - z_old)) < tol and np.max(np.abs(x - z)) < tol:
            break
    return z
