"""Runge-Kutta tableaux of the fixed-substep physics.

Dormand-Prince 5(4) (Dormand & Prince 1980; scipy rk.RK45.{A,B,P}) and
Bogacki-Shampine 3(2) (scipy rk.RK23.{A,B,P}), and the Dormand-Prince step
and dense output of space_gym_tpu/ops/rk45.py on lane-first `(B, n)` states,
used by the fixed-substep tier (ops/fixed_rk.py).  The kernels' integrator is
the physics body in ops/physics.py and csrc/physics.cuh.
"""

import torch

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


def rk_step(rhs, t, y, f, h):
    """One Dormand-Prince step of y (B, n); returns (y_new, f_new, K list of
    the 7 stage derivatives)."""
    K = [f]
    for s in range(1, N_STAGES):
        dy = _wsum(K, DP_A[s]) * h
        K.append(rhs(t + DP_C[s] * h, y + dy))
    y_new = y + h * _wsum(K, DP_B)
    f_new = rhs(t + h, y_new)
    K.append(f_new)
    return y_new, f_new, K


def dense_q(K):
    """Dense-output coefficients Q = K^T P, shape (B, n, 4)."""
    cols = [_wsum(K, tuple(DP_P[j][m] for j in range(7))) for m in range(4)]
    return torch.stack(cols, dim=-1)


def dense_eval(t_old, h, y_old, Q, t):
    """The quartic interpolant at per-lane times t (B,) -> (B, n)."""
    x = ((t - t_old) / h)[:, None]
    p1 = x
    p2 = p1 * x
    p3 = p2 * x
    p4 = p3 * x
    y = h * (Q[..., 0] * p1 + Q[..., 1] * p2 + Q[..., 2] * p3 + Q[..., 3] * p4)
    return y + y_old
