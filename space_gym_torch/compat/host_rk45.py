"""Host (numpy) adaptive RK45 with terminal events — strict-parity oracle.

A from-scratch implementation of the same published algorithm the reference
runs through scipy.integrate.solve_ivp (dynamic_model.py:112-118): Dormand-
Prince 5(4), Hairer initial-step selection, scipy's step controller and quartic
dense output, and Brent's method for event roots (xtol=rtol=4*eps).  Using the
same numpy BLAS dot calls in the same order makes results bit-identical to
scipy on this workload, which pins down "bitwise trajectory parity" for the
compat adapter's host-physics mode (`physics="host"`); the batched integrator
(ops/rk45.py::solve_step) is validated against both.

A copy of space_gym_tpu/parity/host_rk45.py.
"""
from __future__ import annotations

import numpy as np

SAFETY = 0.9
MIN_FACTOR = 0.2
MAX_FACTOR = 10.0
ERROR_EXPONENT = -0.2  # -1/(4+1)
EPS = np.finfo(float).eps

C = np.array([0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1], dtype=float)
A = np.array(
    [
        [0, 0, 0, 0, 0],
        [1 / 5, 0, 0, 0, 0],
        [3 / 40, 9 / 40, 0, 0, 0],
        [44 / 45, -56 / 15, 32 / 9, 0, 0],
        [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729, 0],
        [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
    ],
    dtype=float,
)
B = np.array([35 / 384, 0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84], dtype=float)
E = np.array(
    [-71 / 57600, 0, 71 / 16695, -71 / 1920, 17253 / 339200, -22 / 525, 1 / 40],
    dtype=float,
)
P = np.array(
    [
        [1, -8048581381 / 2820520608, 8663915743 / 2820520608, -12715105075 / 11282082432],
        [0, 0, 0, 0],
        [0, 131558114200 / 32700410799, -68118460800 / 10900136933, 87487479700 / 32700410799],
        [0, -1754552775 / 470086768, 14199869525 / 1410260304, -10690763975 / 1880347072],
        [0, 127303824393 / 49829197408, -318862633887 / 49829197408, 701980252875 / 199316789632],
        [0, -282668133 / 205662961, 2019193451 / 616988883, -1453857185 / 822651844],
        [0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423],
    ],
    dtype=float,
)


def _norm(x):
    return np.linalg.norm(x) / x.size**0.5


def _select_initial_step(fun, t0, y0, f0, t_bound, rtol, atol):
    interval_length = abs(t_bound - t0)
    scale = atol + np.abs(y0) * rtol
    d0 = _norm(y0 / scale)
    d1 = _norm(f0 / scale)
    h0 = 1e-6 if (d0 < 1e-5 or d1 < 1e-5) else 0.01 * d0 / d1
    h0 = min(h0, interval_length)
    y1 = y0 + h0 * f0
    f1 = fun(t0 + h0, y1)
    d2 = _norm((f1 - f0) / scale) / h0
    if d1 <= 1e-15 and d2 <= 1e-15:
        h1 = max(1e-6, h0 * 1e-3)
    else:
        h1 = (0.01 / max(d1, d2)) ** 0.2
    return min(100 * h0, h1, interval_length)


def brentq(f, xa, xb, xtol=4 * EPS, rtol=4 * EPS, maxiter=100):
    """Brent's method, the zeros.c algorithm as used by scipy.optimize.brentq."""
    xpre, xcur = xa, xb
    fpre, fcur = f(xpre), f(xcur)
    if fpre == 0:
        return xpre
    if fcur == 0:
        return xcur
    xblk = fblk = spre = scur = 0.0
    for _ in range(maxiter):
        if fpre != 0 and fcur != 0 and np.signbit(fpre) != np.signbit(fcur):
            xblk, fblk = xpre, fpre
            spre = scur = xcur - xpre
        if abs(fblk) < abs(fcur):
            xpre, xcur, xblk = xcur, xblk, xcur
            fpre, fcur, fblk = fcur, fblk, fcur
        delta = (xtol + rtol * abs(xcur)) / 2
        sbis = (xblk - xcur) / 2
        if fcur == 0 or abs(sbis) < delta:
            return xcur
        if abs(spre) > delta and abs(fcur) < abs(fpre):
            if xpre == xblk:
                stry = -fcur * (xcur - xpre) / (fcur - fpre)
            else:
                dpre = (fpre - fcur) / (xpre - xcur)
                dblk = (fblk - fcur) / (xblk - xcur)
                stry = -fcur * (fblk * dblk - fpre * dpre) / (dblk * dpre * (fblk - fpre))
            if 2 * abs(stry) < min(abs(spre), 3 * abs(sbis) - delta):
                spre, scur = scur, stry
            else:
                spre = scur = sbis
        else:
            spre = scur = sbis
        xpre, fpre = xcur, fcur
        if abs(scur) > delta:
            xcur += scur
        else:
            xcur += delta if sbis > 0 else -delta
        fcur = f(xcur)
    return xcur


def solve_step(fun, events, y0, t_bound, rtol=1e-3, atol=1e-6):
    """Integrate from t=0 to t_bound, stopping at the first terminal-event
    root.  Returns (y_final, terminated) with solve_ivp's exact semantics for
    the reference's all-terminal, direction=0 event set."""
    t = 0.0
    y = np.array(y0, dtype=float)
    f = fun(t, y)
    h_abs = _select_initial_step(fun, t, y, f, t_bound, rtol, atol)
    g = [ev(t, y) for ev in events]
    K = np.empty((7, y.size), dtype=float)

    while True:
        min_step = 10 * abs(np.nextafter(t, np.inf) - t)
        if h_abs < min_step:
            h_abs = min_step
        step_accepted = False
        step_rejected = False
        while not step_accepted:
            if h_abs < min_step:
                raise RuntimeError("step size underflow")
            t_new = min(t + h_abs, t_bound)
            h = t_new - t
            h_abs = abs(h)
            # rk_step
            K[0] = f
            for s in range(1, 6):
                dy = np.dot(K[:s].T, A[s, :s]) * h
                K[s] = fun(t + C[s] * h, y + dy)
            y_new = y + h * np.dot(K[:-1].T, B)
            f_new = fun(t + h, y_new)
            K[6] = f_new
            scale = atol + np.maximum(np.abs(y), np.abs(y_new)) * rtol
            error_norm = _norm(np.dot(K.T, E) * h / scale)
            if error_norm < 1:
                factor = (
                    MAX_FACTOR
                    if error_norm == 0
                    else min(MAX_FACTOR, SAFETY * error_norm**ERROR_EXPONENT)
                )
                if step_rejected:
                    factor = min(1, factor)
                h_abs *= factor
                step_accepted = True
            else:
                h_abs *= max(MIN_FACTOR, SAFETY * error_norm**ERROR_EXPONENT)
                step_rejected = True

        t_old, y_old = t, y
        t, y, f = t_new, y_new, f_new

        g_new = [ev(t, y) for ev in events]
        g_arr, g_new_arr = np.asarray(g), np.asarray(g_new)
        active = ((g_arr <= 0) & (g_new_arr >= 0)) | ((g_arr >= 0) & (g_new_arr <= 0))
        if np.any(active):
            Q = K.T.dot(P)
            hseg = t - t_old

            def sol(tq):
                x = (tq - t_old) / hseg
                p = np.cumprod(np.tile(x, 4))
                return hseg * np.dot(Q, p) + y_old

            roots = [
                brentq(lambda tq, e=e: events[e](tq, sol(tq)), t_old, t)
                for e in np.nonzero(active)[0]
            ]
            t_event = roots[int(np.argsort(roots)[0])]
            return sol(t_event), True
        g = g_new

        if t >= t_bound:
            return y, False
