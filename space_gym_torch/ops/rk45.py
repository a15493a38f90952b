"""Runge-Kutta tableaux, the Dormand-Prince step, and the adaptive RK45 of
`physics="adaptive"`.

Dormand-Prince 5(4) (Dormand & Prince 1980; scipy rk.RK45.{A,B,E,P}) and
Bogacki-Shampine 3(2) (scipy rk.RK23.{A,B,P}); the Dormand-Prince step and
dense output of space_gym_tpu/ops/rk45.py on lane-first `(B, n)` states,
used by the fixed-substep tier (ops/fixed_rk.py) and by `solve_step`.  The
kernels' integrator is the physics body in ops/physics.py and
csrc/physics.cuh.

`solve_step` is the twin of the JAX `solve_step`: scipy's
`solve_ivp(method="RK45", events=...)` for one control interval (Hairer's
initial step, the step controller with its rejected-step rule, the quartic
dense output, Brent's method on every event that changed sign, the earliest
root winning).  JAX runs it under `vmap`, which turns each `lax.while_loop`
into a loop that runs while any lane's condition holds and keeps the old
carry of the lanes whose condition is false.  Here those loops are written
out: an `active` mask per loop, `torch.where(active, new, old)` on every
carried tensor, and one host read of `active.any()` per iteration, so a lane
comes back with the bits it would have alone.  Brent's method runs only on
the (lane, event) pairs whose event changed sign, all pairs in one batch.

In the parity mode of ops/exact.py (the parity engine's reset and step,
parity/device_replay.py) the branches of the JAX module's parity mode are
taken: the stage combinations, the dense output's Q = K^T P and Q @ p go
through numpy's OpenBLAS (`kt_dot`, `ktp`, `dot_mv`), the RMS norm through
its BLAS dot, the controller's pow through libm, and divisions by constants
divide, so the solver computes scipy's bits.  Outside it the sequential sums
below run, and `x ** e` and the norm may differ from scipy's by an ulp.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import exact
from .events import crossings

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
ERROR_ESTIMATOR_ORDER = 4
ERROR_EXPONENT = -1.0 / (ERROR_ESTIMATOR_ORDER + 1)

DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0)
DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
)
DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
DP_E = (-71 / 57600, 0.0, 71 / 16695, -71 / 1920, 17253 / 339200, -22 / 525, 1 / 40)
# Quartic interpolant (rows = stages 0..6, cols = powers x^1..x^4).
DP_P = (
    (1.0, -8048581381 / 2820520608, 8663915743 / 2820520608, -12715105075 / 11282082432),
    (0.0, 0.0, 0.0, 0.0),
    (0.0, 131558114200 / 32700410799, -68118460800 / 10900136933, 87487479700 / 32700410799),
    (0.0, -1754552775 / 470086768, 14199869525 / 1410260304, -10690763975 / 1880347072),
    (0.0, 127303824393 / 49829197408, -318862633887 / 49829197408, 701980252875 / 199316789632),
    (0.0, -282668133 / 205662961, 2019193451 / 616988883, -1453857185 / 822651844),
    (0.0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423),
)
N_STAGES = 6

BS3_A = (
    (),
    (1 / 2,),
    (0.0, 3 / 4),
)
BS3_B = (2 / 9, 1 / 3, 4 / 9)
# Cubic interpolant (rows = stages 0..3, cols = powers x^1..x^3).
BS3_P = (
    (1.0, -4 / 3, 5 / 9),
    (0.0, 1.0, -2 / 3),
    (0.0, 4 / 3, -8 / 9),
    (0.0, -1.0, 1.0),
)
BS3_N_STAGES = 3

TABLEAUX = {
    "dp5": (DP_A, DP_B, DP_P, N_STAGES),
    "bs3": (BS3_A, BS3_B, BS3_P, BS3_N_STAGES),
}


def _wsum(vectors, coeffs):
    """Weighted sum of vectors[j] * coeffs[j], accumulated in ascending j."""
    acc = vectors[0] * coeffs[0]
    for v, c in zip(vectors[1:], coeffs[1:]):
        acc = acc + v * c
    return acc


def _stage_dot(vectors, coeffs, which: int):
    """np.dot(K[:s].T, coeffs) as scipy computes it: numpy's gemv in the
    parity mode (exact.kt_dot), the sequential sum otherwise."""
    if exact.enabled():
        return exact.kt_dot(torch.stack(vectors, dim=-2), which)
    return _wsum(vectors, coeffs)


def rk_step(rhs, t, y, f, h):
    """One Dormand-Prince step of y (B, n); returns (y_new, f_new, K list of
    the 7 stage derivatives)."""
    K = [f]
    for s in range(1, N_STAGES):
        dy = _stage_dot(K, DP_A[s], s) * h
        K.append(rhs(t + DP_C[s] * h, y + dy))
    y_new = y + h * _stage_dot(K, DP_B, exact.WHICH_B)
    f_new = rhs(t + h, y_new)
    K.append(f_new)
    return y_new, f_new, K


def dense_q(K):
    """Dense-output coefficients Q = K^T P, shape (B, n, 4); numpy's dgemm of
    K.T by P in the parity mode."""
    if exact.enabled():
        return exact.ktp(torch.stack(K, dim=-2))
    cols = [_wsum(K, tuple(DP_P[j][m] for j in range(7))) for m in range(4)]
    return torch.stack(cols, dim=-1)


def dense_eval(t_old, h, y_old, Q, t):
    """The quartic interpolant at per-lane times t (B,) -> (B, n); t_old and
    h are 0-d or per lane (B,)."""
    x = ((t - t_old) / h)[:, None]
    p1 = x
    p2 = p1 * x
    p3 = p2 * x
    p4 = p3 * x
    hc = h[:, None] if h.dim() else h
    if exact.enabled():
        # scipy: y = h * np.dot(Q, p) + y_old (numpy's RowMajor gemv)
        y = hc * exact.dot_mv(Q, torch.cat([p1, p2, p3, p4], dim=-1))
    else:
        y = hc * (Q[..., 0] * p1 + Q[..., 1] * p2 + Q[..., 2] * p3 + Q[..., 3] * p4)
    return y + y_old


# ------------------------------------------------------ the adaptive solver --
STATUS_RUNNING = 0
STATUS_EVENT = 1
STATUS_FINISHED = 2
STATUS_FAILED = -1


def _rms_norm(x):
    """scipy common.norm of each row: ||x||_2 / sqrt(n); numpy's BLAS dot
    in the parity mode (numpy's 1-D norm is not a sequential sum of
    squares)."""
    if exact.enabled():
        return exact.divc(exact.norm_last(x), x.shape[-1] ** 0.5)
    return torch.linalg.vector_norm(x, dim=-1) / (x.shape[-1] ** 0.5)


def select_initial_step(rhs, t0, y0, f0, t_bound, rtol, atol):
    """Hairer/Norsett/Wanner empirical initial step (scipy
    common.select_initial_step) per lane, for direction +1 and
    max_step=inf; t0 (B,), y0 and f0 (B, n)."""
    interval_length = (t_bound - t0).abs()
    scale = atol + y0.abs() * rtol
    d0 = _rms_norm(y0 / scale)
    d1 = _rms_norm(f0 / scale)
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6, 0.01 * d0 / d1)
    h0 = torch.minimum(h0, interval_length)
    y1 = y0 + h0[:, None] * f0
    f1 = rhs((t0 + h0)[:, None], y1)
    d2 = _rms_norm((f1 - f0) / scale) / h0
    h1 = torch.where((d1 <= 1e-15) & (d2 <= 1e-15), torch.clamp(h0 * 1e-3, min=1e-6),
                     exact.powf(exact.rdivc(0.01, torch.maximum(d1, d2)),
                                1.0 / (ERROR_ESTIMATOR_ORDER + 1)))
    return torch.minimum(torch.minimum(100 * h0, h1), interval_length)


class _Syncs:
    """Host reads of a loop condition, counted for the caller's stats."""

    def __init__(self):
        self.n = 0

    def any(self, mask) -> bool:
        self.n += 1
        return bool(mask.any())


def brentq(f: Callable[[torch.Tensor], torch.Tensor], xa, xb, xtol, rtol, maxiter: int = 100,
           syncs: _Syncs | None = None):
    """Brent's method as scipy.optimize.brentq (zeros.c), on a batch of
    brackets [xa, xb] (n,): `f` maps (n,) points to (n,) values, one
    function per element.  Assumes a sign change on each bracket; without
    one the iteration still ends at `maxiter` and the caller discards the
    result.  Each element's iterates are those it would have alone."""
    syncs = syncs or _Syncs()
    where = torch.where
    fa, fb = f(xa), f(xb)
    zero = torch.zeros_like(xa)
    xpre, xcur, xblk, fpre, fcur, fblk, spre, scur = xa, xb, zero, fa, fb, zero, zero, zero
    # an exact zero at an end is the root; the loop's result is discarded there
    endpoint_hit = (fa == 0) | (fb == 0)
    active = ~endpoint_hit
    i = 0
    while i < maxiter and syncs.any(active):
        bracket = (fpre != 0) & (fcur != 0) & (torch.signbit(fpre) != torch.signbit(fcur))
        xblk_b = where(bracket, xpre, xblk)
        fblk_b = where(bracket, fpre, fblk)
        s_new = xcur - xpre
        spre_b = where(bracket, s_new, spre)
        scur_b = where(bracket, s_new, scur)

        swap = fblk_b.abs() < fcur.abs()
        xpre_s, xcur_s, xblk_s = where(swap, xcur, xpre), where(swap, xblk_b, xcur), where(
            swap, xcur, xblk_b)
        fpre_s, fcur_s, fblk_s = where(swap, fcur, fpre), where(swap, fblk_b, fcur), where(
            swap, fcur, fblk_b)

        delta = (xtol + rtol * xcur_s.abs()) / 2
        sbis = (xblk_s - xcur_s) / 2
        converged = (fcur_s == 0) | (sbis.abs() < delta)

        # interpolation or extrapolation: secant where xpre == xblk, else
        # inverse quadratic
        use_interp = (spre_b.abs() > delta) & (fcur_s.abs() < fpre_s.abs())
        stry_secant = -fcur_s * (xcur_s - xpre_s) / (fcur_s - fpre_s)
        dpre = (fpre_s - fcur_s) / (xpre_s - xcur_s)
        dblk = (fblk_s - fcur_s) / (xblk_s - xcur_s)
        stry_iq = -fcur_s * (fblk_s * dblk - fpre_s * dpre) / (dblk * dpre * (fblk_s - fpre_s))
        stry = where(xpre_s == xblk_s, stry_secant, stry_iq)
        good = 2 * stry.abs() < torch.minimum(spre_b.abs(), 3 * sbis.abs() - delta)
        take = use_interp & good
        spre_n = where(take, scur_b, sbis)
        scur_n = where(take, stry, sbis)

        step = where(scur_n.abs() > delta, scur_n, where(sbis > 0, delta, -delta))
        xcur_n = xcur_s + step
        fcur_n = f(xcur_n)

        # the JAX body's carry, then the old carry where this element had ended
        new = (where(converged, xpre_s, xcur_s), where(converged, xcur_s, xcur_n), xblk_s,
               where(converged, fpre_s, fcur_s), where(converged, fcur_s, fcur_n), fblk_s,
               where(converged, spre_b, spre_n), where(converged, scur_b, scur_n))
        old = (xpre, xcur, xblk, fpre, fcur, fblk, spre, scur)
        xpre, xcur, xblk, fpre, fcur, fblk, spre, scur = (
            where(active, a, b) for a, b in zip(new, old))
        active = active & ~converged
        i += 1
    return where(endpoint_hit, where(fa == 0, xa, xb), xcur)


class SolveResult(NamedTuple):
    y: torch.Tensor           # (B, n) state at t (event time if terminated, else t_bound)
    t: torch.Tensor           # (B,)
    terminated: torch.Tensor  # (B,) bool: a terminal event fired (solve_ivp status 1)
    failed: torch.Tensor      # (B,) bool: step size underflow or a non-finite step
    n_steps: torch.Tensor     # (B,) int32 accepted RK steps taken


def _attempt_steps(rhs, t, y, f, h_abs, t_bound, rtol, atol, live, syncs):
    """scipy RungeKutta._step_impl, the inner accept/reject loop, on the
    lanes `live`.  Returns (failed, t_new, h, y_new, f_new, K (7, B, n),
    h_abs for the next step)."""
    where = torch.where
    inf = torch.full((), float("inf"), dtype=t.dtype, device=t.device)
    min_step = 10 * (torch.nextafter(t, inf) - t).abs()
    h_abs = torch.maximum(h_abs, min_step)  # max_step is inf
    B = t.shape[0]
    accepted = torch.zeros(B, dtype=torch.bool, device=t.device)
    failed, rejected = accepted, accepted
    t_new, h, y_new, f_new = t, torch.zeros_like(t), y, f
    K = torch.zeros((N_STAGES + 1,) + tuple(y.shape), dtype=y.dtype, device=y.device)
    active = live
    while syncs.any(active):
        # ~(>=), not (<): a NaN step size (a non-finite right-hand side)
        # fails the lane instead of spinning the loop
        fail_now = ~(h_abs >= min_step)
        tn = torch.minimum(t + h_abs, t_bound)
        hh = tn - t
        h_abs_cur = hh.abs()
        yn, fn, Ks = rk_step(rhs, t[:, None], y, f, hh[:, None])
        scale = atol + torch.maximum(y.abs(), yn.abs()) * rtol
        error_norm = _rms_norm(_stage_dot(Ks, DP_E, exact.WHICH_E) * hh[:, None] / scale)
        ok = error_norm < 1
        pow_err = exact.powf(error_norm, ERROR_EXPONENT)  # scipy's numpy-scalar pow
        factor_ok = where(error_norm == 0, MAX_FACTOR, torch.clamp(SAFETY * pow_err, max=MAX_FACTOR))
        factor_ok = where(rejected, torch.clamp(factor_ok, max=1.0), factor_ok)
        # a non-finite error would make the step size NaN: shrink it instead,
        # so that the underflow check above ends the lane
        factor_bad = where(torch.isfinite(error_norm),
                           torch.clamp(SAFETY * pow_err, min=MIN_FACTOR), MIN_FACTOR)
        h_next = where(ok, h_abs_cur * factor_ok, h_abs_cur * factor_bad)

        a1 = active[:, None]
        accepted = where(active, ok & ~fail_now, accepted)
        failed = where(active, fail_now, failed)
        rejected = where(active, rejected | ~ok, rejected)
        h_abs = where(active, h_next, h_abs)
        t_new = where(active, tn, t_new)
        h = where(active, hh, h)
        y_new = where(a1, yn, y_new)
        f_new = where(a1, fn, f_new)
        K = where(a1[None], torch.stack(Ks), K)
        active = active & ~(accepted | failed)
    return failed, t_new, h, y_new, f_new, K, h_abs


def solve_step(
    rhs: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    event_fn: Callable[..., torch.Tensor],
    y0: torch.Tensor,
    t_bound: float,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    max_steps: int = 1000,
    event_args: tuple = (),
    stats: dict | None = None,
) -> SolveResult:
    """Integrate y' = rhs(t, y) for every lane from t=0 to t_bound, stopping
    each lane at the first root of a terminal event: the solve_ivp(...,
    events=...) call of the reference's make_step (dynamic_model.py:94-125).

    y0 (B, n) in float32 or float64, which every tensor keeps; t_bound a
    number or per lane (B,).  `rhs(t (B,
    1), y (B, n)) -> (B, n)` is called on the whole batch.
    `event_fn(y (m, n), *args) -> (m, E)` is called on the whole batch with
    `event_args`, and on the lanes of Brent's pairs with those lanes' rows
    of each per-lane tensor in `event_args`.  `stats`, where given, gains
    the host reads of loop conditions ("syncs") and the lanes that ran
    Brent's method ("brent_lanes")."""
    dtype, dev = y0.dtype, y0.device
    B = y0.shape[0]
    tb = torch.as_tensor(t_bound, dtype=dtype, device=dev)
    tol4 = 4 * torch.finfo(dtype).eps  # brentq's xtol and rtol in solve_event_equation
    syncs = _Syncs()
    where = torch.where

    t = torch.zeros(B, dtype=dtype, device=dev)
    y = y0
    f = rhs(t[:, None], y0)
    h_abs = select_initial_step(rhs, t, y0, f, tb, rtol, atol)
    g = event_fn(y0, *event_args)
    status = torch.full((B,), STATUS_RUNNING, dtype=torch.int32, device=dev)
    y_final, t_final = y0, t
    n_steps = torch.zeros(B, dtype=torch.int32, device=dev)
    brent_lanes = 0

    while True:
        running = (status == STATUS_RUNNING) & (n_steps < max_steps)
        if not syncs.any(running):
            break
        failed, t_new, h, y_new, f_new, K, h_abs_next = _attempt_steps(
            rhs, t, y, f, h_abs, tb, rtol, atol, running, syncs)
        Q = dense_q(list(K))
        g_new = event_fn(y_new, *event_args)
        active = crossings(g, g_new) & running[:, None]
        any_event = active.any(dim=1)

        t_root, y_root = t_new, y_new
        pairs = active.nonzero()
        syncs.n += 1
        if pairs.shape[0]:
            lane, ev = pairs[:, 0], pairs[:, 1:]
            brent_lanes += int(any_event.sum())
            t_l, h_l, y_l, Q_l = t[lane], h[lane], y[lane], Q[lane]
            args_l = tuple(a[lane] for a in event_args)

            def ge(tq):
                return event_fn(dense_eval(t_l, h_l, y_l, Q_l, tq), *args_l).gather(1, ev)[:, 0]

            roots = brentq(ge, t_l, t_new[lane], tol4, tol4, syncs=syncs)
            first = torch.full((B,), float("inf"), dtype=dtype, device=dev).scatter_reduce(
                0, lane, roots, "amin")
            t_root = where(any_event, first, t_new)
            y_root = where(any_event[:, None], dense_eval(t, h, y, Q, t_root), y_new)

        finished = t_new >= tb
        st = where(failed, STATUS_FAILED, where(any_event, STATUS_EVENT, where(
            finished, STATUS_FINISHED, STATUS_RUNNING))).to(torch.int32)
        r1 = running[:, None]
        t = where(running, t_new, t)
        y = where(r1, y_new, y)
        f = where(r1, f_new, f)
        h_abs = where(running, h_abs_next, h_abs)
        g = where(r1, g_new, g)
        status = where(running, st, status)
        y_final = where(r1, y_root, y_final)
        t_final = where(running, t_root, t_final)
        n_steps = n_steps + running.to(torch.int32)

    if stats is not None:
        stats["syncs"] = stats.get("syncs", 0) + syncs.n
        stats["brent_lanes"] = stats.get("brent_lanes", 0) + brent_lanes
    return SolveResult(y=y_final, t=t_final, terminated=status == STATUS_EVENT,
                       failed=status == STATUS_FAILED, n_steps=n_steps)
