"""Plain PyTorch twin of the fixed-substep physics, component-major.

Same semantics as space_gym_tpu/ops/pallas_step.py::_make_physics_body and
the CUDA device function in csrc/physics.cuh: velocity-steering override,
gravity + thrust RHS over P planets, `n_substeps` Dormand-Prince 5(4) or
Bogacki-Shampine 3(2) substeps with FSAL, P+3 terminal events checked at
each substep end, one joint safeguarded-Illinois refinement of the earliest
crossing on the dense interpolant, state returned at the event time, angle
wrapped into [0, 2pi).

Every tensor is one state component over the lane axis, shape (B,), and the
arithmetic follows the JAX body operation for operation (constants folded in
Python double where the JAX code folds them), so in float64 both sides agree
to rounding.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .constants import G
from .field import STEERING_ACCELERATION, STEERING_VELOCITY, VELOCITY_STEERING_SCALE, ShipParams
from .rk45 import TABLEAUX

TWO_PI = 6.283185307179586


def _wsum(vecs, coeffs):
    acc = vecs[0] * coeffs[0]
    for v, c in zip(vecs[1:], coeffs[1:]):
        acc = acc + v * c
    return acc


def illinois_refine(fn, lo, hi, f_lo, f_hi, iters: int):
    """Safeguarded Illinois false position on [lo, hi], exactly the reference
    rule (pallas_step.py:226-239, fixed_rk.py:70-81), grazing-crossing stall
    included.  `fn` is sign-normalised so it decreases through its root
    (f_lo >= 0 >= f_hi); returns the high end of the final bracket."""
    one = torch.ones_like(lo)
    side = torch.zeros_like(lo)  # +1: hi moved last, -1: lo moved
    for _ in range(iters):
        mid_fp = hi - f_hi * (hi - lo) / (f_hi - f_lo)
        good = torch.isfinite(mid_fp) & (mid_fp > lo) & (mid_fp < hi)
        mid = torch.where(good, mid_fp, 0.5 * (lo + hi))
        g_mid = fn(mid)
        left = g_mid <= 0  # root in [lo, mid]
        f_lo = torch.where(left, torch.where(side > 0, 0.5 * f_lo, f_lo), g_mid)
        f_hi = torch.where(left, g_mid, torch.where(side < 0, 0.5 * f_hi, f_hi))
        lo = torch.where(left, lo, mid)
        hi = torch.where(left, mid, hi)
        side = torch.where(left, one, -one)
    return hi


def make_physics_body(
    ship: ShipParams,
    planet_masses: Sequence[float],
    planet_radii: Sequence[float],
    world_size: float,
    max_abs_vel_angle: float,
    step_size: float,
    n_substeps: int,
    refine_iters: int,
    tableau: str = "dp5",
):
    """Returns `body(comp, px, py, ae, at) -> (y_final comps, terminated)`:
    comp a list of 6 (B,) tensors, px/py lists of per-planet (B,) tensors."""
    if tableau not in TABLEAUX:
        raise ValueError(f"unknown tableau {tableau!r}")
    T_A, T_B, T_P, n_stages = TABLEAUX[tableau]
    n_pw = len(T_P[0])
    n_planets = len(planet_masses)
    n_events = n_planets + 3
    half = world_size / 2
    radii = tuple(float(r) for r in planet_radii)
    masses = tuple(float(m) for m in planet_masses)
    h = step_size / n_substeps

    def rhs(comp, px, py, ae, at):
        x, y, th, vx, vy, w = comp
        efs = ae * ship.max_engine_force
        fx = -torch.cos(th) * efs
        fy = -torch.sin(th) * efs
        for i in range(n_planets):
            dx = px[i] - x
            dy = py[i] - y
            d2 = dx * dx + dy * dy
            inv_d = torch.rsqrt(d2)
            s = (G * ship.mass * masses[i]) / d2 * inv_d
            fx = fx + dx * s
            fy = fy + dy * s
        if ship.steering == STEERING_ACCELERATION:
            aang = at * (ship.max_thruster_force / ship.moi)
        else:
            aang = torch.zeros_like(at)
        return [vx, vy, w, fx / ship.mass, fy / ship.mass, aang]

    def events(comp, px, py):
        x, y, _, _, _, w = comp
        out = []
        for i in range(n_planets):
            dx = px[i] - x
            dy = py[i] - y
            out.append(torch.sqrt(dx * dx + dy * dy) - radii[i])
        out.append(torch.minimum(half - x, half - y))
        out.append(torch.minimum(half + x, half + y))
        out.append(max_abs_vel_angle - torch.abs(w))
        return out

    def lcomb(stacks, coeffs):
        return [_wsum([st[c] for st in stacks], coeffs) for c in range(6)]

    def body(comp, px, py, ae, at):
        if ship.steering == STEERING_VELOCITY:
            comp = list(comp)
            comp[5] = VELOCITY_STEERING_SCALE * at

        f = rhs(comp, px, py, ae, at)
        g = events(comp, px, py)
        zeros = torch.zeros_like(comp[0])
        terminated = torch.zeros(comp[0].shape, dtype=torch.bool, device=comp[0].device)
        y_final = [c + 0.0 for c in comp]
        t = 0.0

        for _ in range(n_substeps):
            K = [f]
            for s in range(1, n_stages):
                dy = lcomb(K, T_A[s])
                ys = [comp[c] + dy[c] * h for c in range(6)]
                K.append(rhs(ys, px, py, ae, at))
            inc = lcomb(K, T_B)
            y_new = [comp[c] + h * inc[c] for c in range(6)]
            f_new = rhs(y_new, px, py, ae, at)
            K.append(f_new)

            g_new = events(y_new, px, py)
            active = []
            for e in range(n_events):
                up = (g[e] <= 0) & (g_new[e] >= 0)
                down = (g[e] >= 0) & (g_new[e] <= 0)
                active.append(up | down)
            any_event = active[0]
            for e in range(1, n_events):
                any_event = any_event | active[e]
            fire = any_event & ~terminated

            Q = [
                [_wsum([st[c] for st in K], tuple(T_P[j][m] for j in range(n_stages + 1)))
                 for m in range(n_pw)]
                for c in range(6)
            ]
            t0 = t

            def sol(tq, Q=Q, comp=comp, t0=t0):
                xq = (tq - t0) / h
                pws, pw = [], xq
                for _m in range(n_pw):
                    pws.append(pw)
                    pw = pw * xq
                out = []
                for c in range(6):
                    acc = Q[c][0] * pws[0]
                    for m in range(1, n_pw):
                        acc = acc + Q[c][m] * pws[m]
                    out.append(h * acc + comp[c])
                return out

            # Joint refinement of the earliest crossing over the ACTIVE events,
            # sign-normalised so every active g decreases through its root;
            # inactive events sit at +inf (pallas_step.py:183-204).
            inf = float("inf")
            sgn = [torch.where(g[e] < 0, -1.0, 1.0).to(comp[0].dtype) for e in range(n_events)]

            def m_norm(ge):
                mm = None
                for e in range(n_events):
                    v = torch.where(active[e], sgn[e] * ge[e], inf)
                    mm = v if mm is None else torch.minimum(mm, v)
                return mm

            lo = torch.full_like(comp[0], t0)
            hi = torch.full_like(comp[0], t0 + h)
            hi = illinois_refine(
                lambda tq: m_norm(events(sol(tq), px, py)),
                lo, hi, m_norm(g), m_norm(g_new), refine_iters,
            )
            y_root = sol(hi)

            for c in range(6):
                y_final[c] = torch.where(
                    fire, y_root[c], torch.where(terminated, y_final[c], y_new[c])
                )
            terminated = terminated | fire
            comp = [torch.where(terminated, y_final[c], y_new[c]) for c in range(6)]
            f = [torch.where(terminated, zeros, f_new[c]) for c in range(6)]
            g = [torch.where(terminated, g[e], g_new[e]) for e in range(n_events)]
            t = t + h

        # wrap_ship_angle (dynamic_model.py:179-180); remainder takes the
        # divisor's sign, like jnp.mod.
        y_final[2] = torch.remainder(y_final[2], TWO_PI)
        return y_final, terminated

    return body


def physics_for_config(config, n_substeps: int, refine_iters: int, tableau: str):
    return make_physics_body(
        config.ship, config.planet_masses, config.planet_radii, config.world_size,
        config.max_abs_vel_angle, config.step_size, n_substeps, refine_iters, tableau,
    )
