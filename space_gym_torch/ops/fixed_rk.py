"""Fixed-substep Dormand-Prince integrator in plain PyTorch: `physics="fixed"`.

Twin of space_gym_tpu/ops/fixed_rk.py with the lane axis written out: a static
number of DP5 substeps per control interval, events checked at every substep
end, each crossing refined on its own by the safeguarded Illinois rule on the
substep's dense output, and the state returned at the earliest event time.

The kernels' physics (ops/physics.py, csrc/physics.cuh) refines one joint
function of all active events instead; both use `illinois_refine`, and on a
lane with one active event they produce the same iterates.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import torch

from .events import crossings
from .physics import illinois_refine
from .rk45 import N_STAGES, dense_eval, dense_q, rk_step


class FixedSolveResult(NamedTuple):
    y: torch.Tensor            # (B, n) state at t (event time if terminated)
    t: torch.Tensor            # (B,)
    terminated: torch.Tensor   # (B,) bool: a terminal event fired this step
    event_index: torch.Tensor  # (B,) int32 index of the earliest event, or -1


def _refine_scalar(ev, sol, g_lo, g_hi, t_lo, t_hi, iters: int):
    """Root of ev(sol(t)) on [t_lo, t_hi] given the end values, per lane: the
    event is sign-normalised so it decreases through its root, then refined by
    `illinois_refine`.  Meaningless without a sign change; the caller masks."""
    one = torch.ones_like(g_lo)
    s = torch.where(g_lo < 0, -one, one)
    return illinois_refine(lambda t: s * ev(sol(t)), t_lo, t_hi, s * g_lo, s * g_hi, iters)


def fixed_solve_step(
    rhs: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    event_fns: Sequence[Callable[[torch.Tensor], torch.Tensor]],
    y0: torch.Tensor,
    t_bound: float,
    n_substeps: int = 2,
    refine_iters: int = 12,
) -> FixedSolveResult:
    """Integrate one control interval [0, t_bound] of y0 (B, n) with
    `n_substeps` equal DP5 steps, stopping each lane at its first event root;
    each event_fns[e] maps (B, n) -> (B,)."""
    dtype, dev = y0.dtype, y0.device
    B = y0.shape[0]
    t_bound = torch.tensor(t_bound, dtype=dtype, device=dev)
    h = t_bound / n_substeps

    def eval_events(y):
        return torch.stack([f(y) for f in event_fns], dim=1)

    t = torch.zeros((), dtype=dtype, device=dev)
    y = y0
    f = rhs(t, y0)
    g = eval_events(y0)

    terminated = torch.zeros(B, dtype=torch.bool, device=dev)
    y_final = y0
    t_final = t.expand(B)
    event_index = torch.full((B,), -1, dtype=torch.int32, device=dev)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)

    for _ in range(n_substeps):
        y_new, f_new, K = rk_step(rhs, t, y, f, h)
        t_new = t + h
        g_new = eval_events(y_new)

        active = crossings(g, g_new)
        any_event = active.any(dim=1) & ~terminated

        Q = dense_q([K[j] for j in range(N_STAGES + 1)])

        def sol(tq, t_=t, y_=y, Q_=Q):
            return dense_eval(t_, h, y_, Q_, tq)

        roots = []
        for e, ev in enumerate(event_fns):
            root_e = _refine_scalar(ev, sol, g[:, e], g_new[:, e], t.expand(B), t_new.expand(B),
                                    refine_iters)
            roots.append(torch.where(active[:, e], root_e, inf))
        roots = torch.stack(roots, dim=1)
        t_root, e_idx = roots.min(dim=1)  # the first minimum, like jnp.argmin
        y_root = sol(t_root)

        y_final = torch.where(any_event[:, None], y_root,
                              torch.where(terminated[:, None], y_final, y_new))
        t_final = torch.where(any_event, t_root, torch.where(terminated, t_final, t_new))
        event_index = torch.where(any_event, e_idx.to(torch.int32), event_index)
        terminated = terminated | any_event

        # freeze terminated lanes; the others carry the FSAL derivative
        y = torch.where(terminated[:, None], y_final, y_new)
        f = torch.where(terminated[:, None], torch.zeros_like(f_new), f_new)
        g = torch.where(terminated[:, None], g, g_new)
        t = t_new

    return FixedSolveResult(y=y_final, t=t_final, terminated=terminated, event_index=event_index)
