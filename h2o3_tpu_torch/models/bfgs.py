"""BFGS on the device — the port of ``jax.scipy.optimize.minimize(
method="BFGS")``, which the JAX package's fused ordinal GLM runs
(``_ordinal_fused_fit``).

The algorithm is JAX's (``jax/_src/scipy/optimize/bfgs.py`` and
``line_search.py``): Nocedal & Wright's Algorithm 6.1 with the inverse
Hessian ``H`` kept only where ``rho = 1/(y·s)`` is finite, and the strong-
Wolfe line search of Algorithm 3.5 (c1 = 1e-4, c2 = 0.9, at most 10
bracketing steps, the first trial from the previous decrease) whose zoom
(Algorithm 3.6) tries the cubic, then the quadratic, then the bisection
point, and fails when the bracket is 1e-5 wide or after 30 steps. It stops
on ``‖g‖_∞ < gtol``, on a failed line search or at ``maxiter``, with JAX's
status codes and its quirks kept: a failed line search still takes its
last step, and ``ok`` is only that ``x`` and ``f`` are finite.

JAX nests the zoom's loop in the line search's and that in BFGS's. Here
the three are one state machine whose every step evaluates the objective
and its gradient once: a bracketing or a zoom trial, and, where that trial
ends the line search, the BFGS update and the next search's start in the
same step. Every state tensor (``x``, ``f``, ``g``, ``H``, the search's
scalars) lives on the objective's device, and a step changes nothing once
the run has stopped (``torch.where``), so the host runs :data:`BLOCK`
steps and then reads one packed vector: whether the run stopped, its
counters and ``x``. The reads are one per block, and the steps run after
the stop are counted as masked.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_BRACKET, _ZOOM = 0, 1
# steps a host read: a line search takes 1-5 evaluations, so a read per 8
# steps stays under one per BFGS iteration, and a run wastes at most 7
# masked evaluations past its stop
BLOCK = 8
GTOL = 1e-6  # the gradient test the JAX package's ordinal fit asks for
LS_MAXITER = 10  # bracketing steps of a line search (JAX's default)


@dataclass
class BFGSResult:
    x: np.ndarray  # float64 copy of the float32 optimum
    fun: float
    ok: bool  # x and fun finite (JAX's ``ok``)
    iterations: int  # BFGS updates (JAX's ``nit``)
    evaluations: int  # objective and gradient evaluations (``nfev``)
    status: int  # 0 gtol, 1 maxiter, 2 + line-search status on failure
    reads: int  # host reads (one per block of steps)
    steps: int  # state-machine steps run
    masked_steps: int  # steps run after the stop

    @property
    def stop(self) -> str:
        """Why the run ended: ``gtol``, ``maxiter``, ``line_search`` (status
        3: a failed zoom, 5: no bracket in 10 steps) or ``undefined``."""
        return ("undefined" if self.status < 0 else "gtol" if self.status == 0
                else "maxiter" if self.status == 1 else "line_search")


def value_and_grad(fun):
    """``fg(x) -> (f, g)`` of a scalar ``fun`` by ``torch.autograd``."""

    def fg(x):
        x = x.detach().requires_grad_(True)
        f = fun(x)
        (g,) = torch.autograd.grad(f, x)
        return f.detach(), g.detach()

    return fg


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc);
    NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d0 = fb - fa - C * db
    d1 = fc - fa - C * dc
    A = (dc ** 2 * d0 - db ** 2 * d1) / denom
    B = (-(dc ** 3) * d0 + db ** 3 * d1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The minimizer of the quadratic through (a, fa, fpa) and (b, fb)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _State:
    """The run's tensors on the device: BFGS's (x, f, g, H, the previous
    f, k, nfev, converged, failed, stopped, status), the line search's
    (direction p, phi0/dphi0, first trial, bracketing index i and the
    previous trial, the star point, its failure flag, the mode) and the
    zoom's (j, the lo/hi/rec points)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def where(self, mask, new: "_State") -> None:
        for k, v in new.__dict__.items():
            self.__dict__[k] = torch.where(mask, v, self.__dict__[k])


def minimize_bfgs(fg, x0: torch.Tensor, maxiter: int) -> BFGSResult:
    """Minimize with JAX's BFGS (``gtol`` :data:`GTOL`) from ``x0``
    (float32, on the device); ``fg`` gives ``(f, g)`` on the same device
    (:func:`value_and_grad`)."""
    dev, dt = x0.device, x0.dtype
    d = x0.shape[0]
    eye = torch.eye(d, dtype=dt, device=dev)

    def t(v, dtype=dt):
        return torch.tensor(v, dtype=dtype, device=dev)

    i32 = torch.int32
    f0, g0 = fg(x0)
    zero = t(0.0)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    S = _State(
        x=x0.clone(), f=f0, g=g0, H=eye.clone(),
        old_old=f0 + torch.linalg.vector_norm(g0) / 2,
        k=t(0, i32), nfev=t(1, i32), converged=g0.abs().max() < GTOL,
        failed=false, status_ls=t(0, i32),
        # the line search
        mode=t(_BRACKET, i32), p=torch.zeros_like(x0), phi0=f0, dphi0=zero,
        start=zero, i=t(1, i32), a_i1=zero, phi_i1=f0, dphi_i1=zero,
        a_star=zero, phi_star=f0, dphi_star=zero, g_star=g0,
        ls_failed=false,
        # the zoom
        j=t(0, i32), a_lo=zero, phi_lo=zero, dphi_lo=zero, a_hi=zero,
        phi_hi=zero, dphi_hi=zero, a_rec=zero, phi_rec=zero, z_failed=false,
    )
    S.stopped = S.converged | (S.k >= maxiter)
    _start_search(S, S.stopped)

    steps = reads = 0
    while True:
        for _ in range(BLOCK):
            _step(S, fg, maxiter, eye)
            steps += 1
        packed = torch.cat([
            torch.stack([S.stopped, S.converged, S.failed]).double(),
            torch.stack([S.k, S.nfev, S.status_ls]).double(),
            S.f.double()[None], S.x.double()]).cpu().numpy()
        reads += 1
        if packed[0]:
            break
    converged, failed = bool(packed[1]), bool(packed[2])
    k, nfev, status_ls = (int(v) for v in packed[3:6])
    f, x = float(packed[6]), packed[7:]
    status = (0 if converged else 1 if k == maxiter
              else 2 + status_ls if failed else -1)
    return BFGSResult(
        x=x, fun=f, ok=bool(np.all(np.isfinite(x)) and np.isfinite(f)),
        iterations=k, evaluations=nfev, status=status, reads=reads,
        steps=steps, masked_steps=steps - (nfev - 1))


def _start_search(S: _State, skip) -> None:
    """Where ``skip`` is false: the next line search from (x, f, g, H) —
    the descent direction, the first trial from the previous decrease,
    the bracketing state and the star point at step 0."""
    p = -(S.H @ S.g)
    dphi0 = torch.dot(S.g, p)
    cand = 1.01 * 2 * (S.f - S.old_old) / dphi0
    start = torch.where(cand > 1, torch.ones_like(cand), cand)
    zero = torch.zeros_like(S.f)
    new = _State(mode=torch.zeros_like(S.mode), p=p, phi0=S.f, dphi0=dphi0,
                 start=start, i=torch.ones_like(S.i), a_i1=zero,
                 phi_i1=S.f, dphi_i1=dphi0, a_star=zero, phi_star=S.f,
                 dphi_star=dphi0, g_star=S.g,
                 ls_failed=torch.zeros_like(S.ls_failed))
    S.where(~skip, new)


def _step(S: _State, fg, maxiter: int, eye) -> None:
    """One evaluation: a bracketing or zoom trial of the line search and
    its update, then, where the search ended, the BFGS update and the
    next search's start. Nothing changes where the run has stopped."""
    active = ~S.stopped
    zoom = S.mode == _ZOOM
    c1, c2 = 1e-4, 0.9
    wide = S.x.dtype == torch.float64

    # the trial step
    a_br = torch.where(S.i == 1, S.start, S.a_i1 * 2.0)
    dalpha = S.a_hi - S.a_lo
    lo = torch.minimum(S.a_hi, S.a_lo)
    hi = torch.maximum(S.a_hi, S.a_lo)
    cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
    # JAX's narrowest bracket: 1e-5 below 64-bit floats, 1e-10 at 64
    z_failed = S.z_failed | (dalpha <= (1e-10 if wide else 1e-5))
    a_cub = _cubicmin(S.a_lo, S.phi_lo, S.dphi_lo, S.a_hi, S.phi_hi,
                      S.a_rec, S.phi_rec)
    use_cub = (S.j > 0) & (a_cub > lo + cchk) & (a_cub < hi - cchk)
    a_quad = _quadmin(S.a_lo, S.phi_lo, S.dphi_lo, S.a_hi, S.phi_hi)
    use_quad = ~use_cub & (a_quad > lo + qchk) & (a_quad < hi - qchk)
    a_z = torch.where(use_cub, a_cub, torch.where(
        use_quad, a_quad, (S.a_lo + S.a_hi) / 2.0))
    a = torch.where(zoom, a_z, a_br)

    phi, g = fg(S.x + a * S.p)
    dphi = torch.dot(g, S.p)
    w1 = phi > S.phi0 + c1 * a * S.dphi0  # the sufficient decrease fails
    w2 = torch.abs(dphi) <= -c2 * S.dphi0  # the curvature condition holds

    # bracketing (Algorithm 3.5): a trial that satisfies both conditions
    # ends the search; one that overshoots enters the zoom with the
    # previous trial as lo (z1) or as hi (z2); the 10th trial ends it failed
    z1 = w1 | ((phi >= S.phi_i1) & (S.i > 1))
    s_i = w2 & ~z1
    z2 = (dphi >= 0) & ~z1 & ~s_i
    enter = z1 | z2
    prev, trial = (S.a_i1, S.phi_i1, S.dphi_i1), (a, phi, dphi)
    lo_pt = [torch.where(z1, u, v) for u, v in zip(prev, trial)]
    hi_pt = [torch.where(z1, v, u) for u, v in zip(prev, trial)]
    i_next = S.i + 1
    exhausted = ~s_i & ~enter & (i_next > LS_MAXITER)
    one = torch.ones_like(a)
    br = _State(
        mode=torch.where(enter, S.mode.new_tensor(_ZOOM),
                         S.mode.new_tensor(_BRACKET)),
        i=i_next, a_i1=a, phi_i1=phi, dphi_i1=dphi,
        # entering the zoom sets the star to JAX's zoom start: step 1
        # with the lo point's values and the search's first gradient
        a_star=torch.where(s_i, a, torch.where(enter, one, S.a_star)),
        phi_star=torch.where(s_i, phi, torch.where(enter, lo_pt[1],
                                                   S.phi_star)),
        dphi_star=torch.where(s_i, dphi, torch.where(enter, lo_pt[2],
                                                     S.dphi_star)),
        g_star=torch.where(s_i, g, torch.where(enter, S.g, S.g_star)),
        ls_failed=exhausted,
        j=torch.zeros_like(S.j), a_lo=lo_pt[0], phi_lo=lo_pt[1],
        dphi_lo=lo_pt[2], a_hi=hi_pt[0], phi_hi=hi_pt[1], dphi_hi=hi_pt[2],
        a_rec=(lo_pt[0] + hi_pt[0]) / 2.0,
        phi_rec=(lo_pt[1] + hi_pt[1]) / 2.0,
        z_failed=torch.zeros_like(S.z_failed),
    )
    br_end = s_i | exhausted

    # zoom (Algorithm 3.6)
    hi_to_j = w1 | (phi >= S.phi_lo)
    star_j = w2 & ~hi_to_j
    hi_to_lo = (dphi * (S.a_hi - S.a_lo) >= 0) & ~hi_to_j & ~star_j
    lo_to_j = ~hi_to_j & ~star_j
    j_next = S.j + 1
    zf = z_failed | (j_next >= 30)
    to_rec_hi = hi_to_j | hi_to_lo
    zm = _State(
        j=j_next,
        a_hi=torch.where(hi_to_j, a, torch.where(hi_to_lo, S.a_lo, S.a_hi)),
        phi_hi=torch.where(hi_to_j, phi, torch.where(hi_to_lo, S.phi_lo,
                                                     S.phi_hi)),
        dphi_hi=torch.where(hi_to_j, dphi, torch.where(hi_to_lo, S.dphi_lo,
                                                       S.dphi_hi)),
        a_rec=torch.where(to_rec_hi, S.a_hi,
                          torch.where(lo_to_j, S.a_lo, S.a_rec)),
        phi_rec=torch.where(to_rec_hi, S.phi_hi,
                            torch.where(lo_to_j, S.phi_lo, S.phi_rec)),
        a_lo=torch.where(lo_to_j, a, S.a_lo),
        phi_lo=torch.where(lo_to_j, phi, S.phi_lo),
        dphi_lo=torch.where(lo_to_j, dphi, S.dphi_lo),
        a_star=torch.where(star_j, a, S.a_star),
        phi_star=torch.where(star_j, phi, S.phi_star),
        dphi_star=torch.where(star_j, dphi, S.dphi_star),
        g_star=torch.where(star_j, g, S.g_star),
        z_failed=zf, ls_failed=zf,
    )

    # the line search's update (the zoom's fields in zoom mode, the rest
    # kept), then whether it ended in this step
    ls = _State(**{k: torch.where(zoom, zm.__dict__.get(k, getattr(S, k)), v)
                   for k, v in br.__dict__.items()})
    ended = torch.where(zoom, star_j | zf, br_end)
    S.where(active, ls)
    S.nfev = S.nfev + active.to(S.nfev.dtype)

    # the BFGS update where the search ended (its step taken even when it
    # failed, as JAX's is)
    upd = active & ended
    # below 64-bit floats JAX floors the step at 1e-8
    a_k = S.a_star if wide else torch.where(
        torch.abs(S.a_star) < 1e-8, torch.sign(S.a_star) * 1e-8, S.a_star)
    s = a_k * S.p
    y = S.g_star - S.g
    rho = 1.0 / torch.dot(y, s)
    W = eye - rho * torch.outer(s, y)
    H_new = W @ S.H @ W.T + rho * torch.outer(s, s)
    H_new = torch.where(torch.isfinite(rho), H_new, S.H)
    k_new = S.k + 1
    conv = S.g_star.abs().max() < GTOL
    status_ls = torch.where(S.z_failed, S.k.new_tensor(1), torch.where(
        S.i > LS_MAXITER, S.k.new_tensor(3), S.k.new_tensor(0)))
    bf = _State(x=S.x + s, f=S.phi_star, g=S.g_star, H=H_new,
                old_old=S.f, k=k_new, converged=conv, failed=S.ls_failed,
                status_ls=status_ls,
                stopped=conv | S.ls_failed | (k_new >= maxiter))
    S.where(upd, bf)
    _start_search(S, ~upd | S.stopped)

