"""Plain PyTorch twin of the full env-step kernel (csrc/full_step.cu).

Same computation as space_gym_tpu/ops/pallas_full.py::make_full_step's inner
`kernel`: physics (ops/physics.py), observation (final and post-reset),
per-task reward, Goal resample via the hex tiling, TimeLimit, and masked
auto-reset for Goal/Kepler/DNC.  Every tensor is one row of the
component-major (rows, B) layout.

Uniforms are read from the (n_u, B) block through a row cursor in exactly the
kernel's consumption order: the Goal resample first, unconditionally, then
the task's reset, unconditionally (pallas_full.py:550-599).  So the same `u`
gives the same resets as the JAX kernel and the CUDA kernel, lane for lane.
"""
from __future__ import annotations

import torch

from ..envs.config import TASK_GOAL, TASK_KEPLER
from ..tiling.geometry import DIAGONAL_CASES, MAX_GOAL_CANDIDATES
from .constants import G
from .physics import TWO_PI, physics_for_config

DUP = MAX_GOAL_CANDIDATES  # free-entry duplicate cap (tiling/device.py)

# Acklam's rational approximation of the standard normal inverse CDF.
_NI_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_NI_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
_NI_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_NI_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
_NI_PLOW = 0.02425


def norminv(u: torch.Tensor) -> torch.Tensor:
    """Acklam's inverse normal CDF (pallas_full.py:39-72), branchless lower /
    central / upper evaluation; max abs error ~4e-9 in float64."""
    a, b, c, d = _NI_A, _NI_B, _NI_C, _NI_D
    # dtype-aware clip: a fixed 1-1e-12 rounds to 1.0 in f32 and NaNs the tail.
    eps = torch.finfo(u.dtype).eps / 2  # numpy's epsneg
    u = torch.clamp(u, eps, 1 - eps)

    q = u - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r) + 1.0
    central = q * num / den

    ul = torch.minimum(u, 1 - u)
    ql = torch.sqrt(-2.0 * torch.log(ul))
    numt = ((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]
    dent = ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql) + 1.0
    tail = numt / dent
    tail = torch.where(u < 0.5, tail, -tail)

    in_tail = (u < _NI_PLOW) | (u > 1 - _NI_PLOW)
    return torch.where(in_tail, tail, central)


class U:
    """Row cursor over the (n_u, B) uniforms block."""

    def __init__(self, u: torch.Tensor):
        self.u = u
        self.i = 0

    def take(self) -> torch.Tensor:
        v = self.u[self.i]
        self.i += 1
        return v

    def uniform(self, lo=0.0, hi=1.0):
        return lo + self.take() * (hi - lo)

    def normal(self):
        return norminv(self.take())


def _check_layout(cfg):
    """The kernel's observation layout per task: lidar + goal for Goal,
    orbit parameters for Kepler, the bare ship state for DoNotCrash."""
    want = cfg.task == TASK_GOAL
    if cfg.with_lidar != want or cfg.with_goal != want:
        raise ValueError(f"{cfg.env_id}: lidar/goal flags do not match task {cfg.task!r}")


def count_uniform_rows(cfg) -> int:
    """Rows of u the full step consumes: the Goal resample then the reset
    (the same sequence as the kernel body; pallas_full.py:472-496 counts it
    by abstract tracing)."""
    if cfg.task == TASK_GOAL:
        nt, cols, npl = cfg.tiling.n_tiles, cfg.tiling.cols, cfg.n_planets
        goal_place = 1 + nt * DUP + 2
        reset = 2 + cols + nt + (2 if npl == 2 else 0) + 2 * (npl + 1) + goal_place + 4
        return goal_place + reset
    if cfg.task == TASK_KEPLER:
        return 6 + (2 if cfg.kepler.randomize else 0)
    return 6


def int_rows(cfg) -> int:
    """Integer state rows: free counts + ship + goal + steps + case + flip
    for Goal, else steps + two zero rows (pallas_full.py:470, :640)."""
    return cfg.tiling.n_tiles + 5 if cfg.task == TASK_GOAL else 3


def cs_rows(cfg) -> int:
    return max(cfg.tiling.cols if cfg.tiling is not None else 0, 1)


def make_full_step_plain(cfg, n_substeps=2, refine_iters=12, tableau="dp5"):
    """`step(y, a, p, g, ref, cs, u, ti) -> (yo, po, go, ro, cso, obs, fobs,
    rew, tio, flags)`, all component-major (rows, B); the float inputs share
    one dtype, ti is int32."""
    _check_layout(cfg)
    task = cfg.task
    n_planets = cfg.n_planets
    radii = tuple(float(r) for r in cfg.planet_radii)
    ws = cfg.world_size
    obs_dim = cfg.obs_dim
    k = cfg.kepler
    gl = cfg.goal
    d = cfg.dnc
    geom = cfg.tiling
    alpha_gm = G * k.planet_mass if k is not None else 0.0
    max_w = 0.7 * cfg.max_abs_vel_angle
    body = physics_for_config(cfg, n_substeps, refine_iters, tableau)

    if geom is not None:
        n_tiles, cols = geom.n_tiles, geom.cols
        tile_row = tuple(rc[0] for rc in geom.tiles_coord)
        tile_col = tuple(rc[1] for rc in geom.tiles_coord)
    else:
        n_tiles = cols = 0
        tile_row = tile_col = ()
    n_int = int_rows(cfg)

    def disk_noise(u, radius):
        """uniform_disk (helpers.py:48-53): angle then radius."""
        ang = u.take() * TWO_PI
        r = torch.sqrt(u.take()) * radius
        return r * torch.cos(ang), r * torch.sin(ang)

    def tile_center(tile, case_b, flip, cs):
        """tile_center_pos (hexagonal_tiling.py:136-158) for a (B,) int tile."""
        row = torch.zeros_like(cs[0])
        col = torch.zeros_like(row)
        shift = torch.zeros_like(row)
        parity = torch.zeros_like(row)
        for tnr in range(n_tiles):
            is_t = tile == tnr
            row = torch.where(is_t, float(tile_row[tnr]), row)
            col = torch.where(is_t, float(tile_col[tnr]), col)
            shift = torch.where(is_t, cs[tile_col[tnr]], shift)
            parity = torch.where(is_t, float(tile_col[tnr] % 2), parity)
        zero_x = -ws / 2 + geom.hex_width / 2
        zero_y = torch.where(case_b, torch.full_like(row, ws / 2 - geom.hex_height),
                             ws / 2 - geom.hex_height / 2)
        x = zero_x + col * (1.5 * geom.a) + shift
        y_cols = -parity * (geom.hex_height / 2)
        y_cols = torch.where(case_b, -y_cols, y_cols)
        y = zero_y - row * geom.hex_height + y_cols
        return torch.where(flip, y, x), torch.where(flip, x, y)

    def full_i32(like, v):
        return torch.full(like.shape, v, dtype=torch.int32, device=like.device)

    def pick_distinct(scores, n_pick):
        """n_pick sequential masked argmin passes over iid scores — the law of
        argsort[:n_pick]; a banned row is masked to 2.0."""
        banned = None
        picks = []
        for _ in range(n_pick):
            best_v = best_i = None
            for i, sc in enumerate(scores):
                scm = sc if banned is None else torch.where(banned[i], 2.0, sc)
                if best_v is None:
                    best_v, best_i = scm, full_i32(scm, i)
                else:
                    better = scm < best_v
                    best_v = torch.where(better, scm, best_v)
                    best_i = torch.where(better, i, best_i)
            picks.append(best_i)
            banned = [(banned[i] if banned is not None else best_v < -1.0) | (best_i == i)
                      for i in range(len(scores))]
        return picks

    def tile_rc(tile):
        r = torch.zeros_like(tile)
        c = torch.zeros_like(tile)
        for tnr in range(n_tiles):
            is_t = tile == tnr
            r = torch.where(is_t, tile_row[tnr], r)
            c = torch.where(is_t, tile_col[tnr], c)
        return r, c

    def goal_place(u, free, ship_tile, goal_tile, case_b, flip, cs):
        """find_new_goal (hexagonal_tiling.py:95-128): returns
        (free', ship', goal', gx, gy)."""
        subsequent = goal_tile >= 0
        free2 = [torch.where(subsequent & (ship_tile == i),
                             torch.clamp(free[i] + 1, max=DUP), free[i])
                 for i in range(n_tiles)]
        ship2 = torch.where(subsequent, goal_tile, ship_tile)

        same = u.take() < 0.25
        # invalid entries sit BELOW any valid score so argmax passes skip them
        entry_scores = []
        for i in range(n_tiles):
            for j in range(DUP):
                sc = u.take()
                entry_scores.append(torch.where(free2[i] > j, sc, -1.0))
        banned = [s < -2.0 for s in entry_scores]  # all False
        cand_tiles, cand_valid = [], []
        for _ in range(min(MAX_GOAL_CANDIDATES, n_tiles * DUP)):
            best_v = best_e = None
            for e, sc in enumerate(entry_scores):
                scm = torch.where(banned[e], -2.0, sc)
                if best_v is None:
                    best_v, best_e = scm, full_i32(scm, e)
                else:
                    better = scm > best_v
                    best_v = torch.where(better, scm, best_v)
                    best_e = torch.where(better, e, best_e)
            banned = [banned[e] | (best_e == e) for e in range(len(entry_scores))]
            cand_tiles.append(torch.div(best_e, DUP, rounding_mode="floor"))
            cand_valid.append(best_v >= 0)

        # farthest taxi distance from ship2; random candidate order breaks ties
        ship_r, ship_c = tile_rc(ship2)
        best_taxi = best_tile = None
        for t, v in zip(cand_tiles, cand_valid):
            tr, tc = tile_rc(t)
            taxi = torch.abs(tr - ship_r) + torch.abs(tc - ship_c)
            taxi = torch.where(v, taxi, -1)
            if best_taxi is None:
                best_taxi, best_tile = taxi, t
            else:
                better = taxi > best_taxi
                best_taxi = torch.where(better, taxi, best_taxi)
                best_tile = torch.where(better, t, best_tile)

        goal2 = torch.where(same, ship2, best_tile)
        free3 = [torch.where(~same & (best_tile == i), free2[i] - 1, free2[i])
                 for i in range(n_tiles)]
        cx, cy = tile_center(goal2, case_b, flip, cs)
        nx, ny = disk_noise(u, geom.hex_height / 2 - geom.goal_radius)
        return free3, ship2, goal2, cx + nx, cy + ny

    def goal_reset(u):
        """tiling_reset + first goal + ship kinematics (goal.py:133-145)."""
        case_b = u.take() < 0.5
        flip = u.take() < 0.5
        raws = [u.take() for _ in range(cols)]
        cums, acc = [], None
        for r in raws:
            acc = r if acc is None else acc + r
            cums.append(acc)
        free_x = ws - geom.tiling_width
        cs_new = [c * (free_x / cums[-1]) for c in cums]

        scores = [u.take() for _ in range(n_tiles)]
        picks = pick_distinct(scores, n_planets + 1)  # ship + planets
        if n_planets == 2:
            use_diag = u.take() < 0.25
            cu = u.take()
            case_i = torch.clamp((cu * len(DIAGONAL_CASES)).to(torch.int32),
                                 max=len(DIAGONAL_CASES) - 1)
            for slot in range(3):
                dv = torch.zeros_like(picks[slot])
                for ci, diag in enumerate(DIAGONAL_CASES):
                    dv = torch.where(case_i == ci, diag[slot], dv)
                picks[slot] = torch.where(use_diag, dv, picks[slot])

        free = []
        for i in range(n_tiles):
            occ = picks[0] == i
            for p in picks[1:]:
                occ = occ | (p == i)
            free.append(torch.where(occ, 0, full_i32(occ, 1)))

        obj_radii = [geom.ship_radius] + [geom.planets_radius] * n_planets
        pos = []
        for p, orad in zip(picks, obj_radii):
            cx, cy = tile_center(p, case_b, flip, cs_new)
            nx, ny = disk_noise(u, geom.hex_height / 2 - orad)
            pos.append((cx + nx, cy + ny))
        goal_tile0 = full_i32(picks[0], -1)
        free, ship_tile, goal_tile, gx, gy = goal_place(
            u, free, picks[0], goal_tile0, case_b, flip, cs_new)
        angle = u.take() * TWO_PI
        vx = u.normal() * 0.07
        vy = u.normal() * 0.07
        w0 = torch.clamp(u.normal() * (max_w / 3), -max_w, max_w)
        sx, sy = pos[0]
        y_new = [sx, sy, angle, vx, vy, w0]
        planets_new = [c for p in pos[1:] for c in p]
        return y_new, planets_new, (gx, gy), free, ship_tile, goal_tile, case_b, flip, cs_new

    def kepler_reset(u):
        pa = u.take() * TWO_PI
        dist = u.uniform(k.planet_radius + 0.5, k.border_radius - 0.5)
        px = torch.cos(pa) * dist
        py = torch.sin(pa) * dist
        sa = u.take() * TWO_PI
        ecc = oa = None
        if k.randomize:
            ecc = u.take() * 0.7
            oa = u.take() * TWO_PI
        vx = u.normal() * 0.05
        vy = u.normal() * 0.05
        w0 = torch.clamp(u.normal() * (max_w / 5), -max_w, max_w)
        return [px, py, sa, vx, vy, w0], (oa, ecc)

    def dnc_reset(u):
        pa = u.take() * TWO_PI
        dist = u.uniform(d.planet_radius + 0.2, d.border_radius - 0.15)
        px = torch.cos(pa) * dist
        py = torch.sin(pa) * dist
        sa = u.take() * TWO_PI
        vx = u.normal() * 0.07
        vy = u.normal() * 0.07
        w0 = torch.clamp(u.normal() * (max_w / 3), -max_w, max_w)
        return [px, py, sa, vx, vy, w0]

    def lidar(pos_x, pos_y, ox, oy, radius):
        vx = ox - pos_x
        vy = oy - pos_y
        dd = torch.sqrt(vx * vx + vy * vy)
        scale = (dd - radius) * (2.0 / ws) / dd
        return vx * scale, vy * scale

    def observe(comp, px, py, gx, gy, ref_rows):
        x, yy, th, vx, vy, w = comp
        out = [x, yy, torch.cos(th), torch.sin(th), vx, vy, w]
        if task == TASK_GOAL:
            for i in range(n_planets):
                out += list(lidar(x, yy, px[i], py[i], radii[i]))
            out += list(lidar(x, yy, gx, gy, 0.0))
        if task == TASK_KEPLER:
            out += list(ref_rows)
        assert len(out) == obs_dim
        return out

    def reward_fn(comp0, yf, px, py, gx, gy, ref_rows, ae, at):
        x, yy, _, vx, vy, _ = yf
        if task == TASK_GOAL:
            x0, y0 = comp0[0], comp0[1]
            cur = torch.sqrt((gx - x) ** 2 + (gy - yy) ** 2)
            last = torch.sqrt((gx - x0) ** 2 + (gy - y0) ** 2)
            gvr = (last - cur) * gl.distance_fctr
            mind = cx = cy = cr = None
            for i in range(n_planets):
                dx = px[i] - x
                dy = py[i] - yy
                dd = torch.sqrt(dx * dx + dy * dy)
                if mind is None:
                    mind, cx, cy, cr = dd, px[i], py[i], torch.full_like(dd, radii[i])
                else:
                    closer = dd < mind
                    cx = torch.where(closer, px[i], cx)
                    cy = torch.where(closer, py[i], cy)
                    cr = torch.where(closer, radii[i], cr)
                    mind = torch.minimum(dd, mind)
            prev = torch.sqrt((cx - x0) ** 2 + (cy - y0) ** 2)
            safety = torch.where(((mind - cr) < gl.danger_zone) & (prev > mind),
                                 -gl.distance_fctr * (prev - mind), 0.0)
            rew = (gl.survival_reward_scale + gl.goal_vel_reward_scale * gvr
                   + gl.safety_reward_scale * safety)
            reached = cur < cfg.goal_radius
            return rew + torch.where(reached, gl.goal_sparse_reward, 0.0), reached
        if task == TASK_KEPLER:
            ra, ecc, a_ax = ref_rows
            b_ax = torch.sqrt(a_ax * a_ax * (1 - ecc * ecc))
            c_f = torch.sqrt(a_ax * a_ax - b_ax * b_ax)
            ca = torch.cos(ra)
            sa = torch.sin(ra)
            wp = ca * x + sa * yy - c_f
            zp = -sa * x + ca * yy
            r2 = wp * wp + zp * zp
            cur_rad = torch.sqrt(r2)
            target_rad = b_ax * torch.rsqrt(1 - ecc * ecc * wp * wp / r2)
            sc = target_rad / cur_rad
            wq, zq = wp * sc, zp * sc
            vtw = -(a_ax / b_ax) * zq
            vtz = (b_ax / a_ax) * wq
            rfoc = torch.sqrt((wq + c_f) ** 2 + zq * zq)
            vmag = torch.sqrt(alpha_gm * (2 / rfoc - 1 / a_ax))
            vn = torch.sqrt(vtw * vtw + vtz * vtz)
            vtw, vtz = vtw * vmag / vn, vtz * vmag / vn
            tvx = ca * vtw - sa * vtz
            tvy = sa * vtw + ca * vtz
            act_pen = torch.sqrt(ae * ae + at * at)
            C = k.numerator_C
            rew = C / (k.rad_penalty_C * torch.abs(cur_rad - target_rad)
                       + torch.abs(tvx - vx) + torch.abs(tvy - vy)
                       + k.act_penalty_C * act_pen + C)
            return rew, torch.zeros_like(rew, dtype=torch.bool)
        rew = torch.full_like(x, d.reward_per_step)
        return rew, torch.zeros_like(rew, dtype=torch.bool)

    def step(y, a, p, g, r, cs, u_rows, ti):
        comp0 = [y[c] for c in range(6)]
        ae, at = a[0], a[1]
        px = [p[2 * i] for i in range(n_planets)]
        py = [p[2 * i + 1] for i in range(n_planets)]
        gx, gy = g[0], g[1]
        ref_rows = [r[i] for i in range(3)]
        col_shift = [cs[i] for i in range(cs.shape[0])]
        free = [ti[i] for i in range(n_tiles)]
        ship_tile = ti[n_tiles] if n_tiles else None
        goal_tile = ti[n_tiles + 1] if n_tiles else None
        steps = ti[n_int - 3]
        case_b = ti[n_int - 2] > 0
        flip = ti[n_int - 1] > 0
        u = U(u_rows)

        # ---- physics ----
        yf, terminated = body(comp0, px, py, ae, at)
        steps1 = steps + 1
        truncated = (steps1 >= cfg.max_episode_steps) & ~terminated
        done = terminated | truncated

        # ---- obs (pre-resample goal) + reward ----
        fobs = observe(yf, px, py, gx, gy, ref_rows)
        rew, reached = reward_fn(comp0, yf, px, py, gx, gy, ref_rows, ae, at)

        def sel(n, o):
            return torch.where(done, n, o)

        p_rows = [p[i] for i in range(2 * n_planets)]
        ref_out = ref_rows
        col_shift_out = col_shift
        if task == TASK_GOAL:
            # resample (consumes u unconditionally), applied where reached
            nfree, nship, ngoal, ngx, ngy = goal_place(
                u, free, ship_tile, goal_tile, case_b, flip, col_shift)
            free = [torch.where(reached, nf, f) for nf, f in zip(nfree, free)]
            ship_tile = torch.where(reached, nship, ship_tile)
            goal_tile = torch.where(reached, ngoal, goal_tile)
            gx1 = torch.where(reached, ngx, gx)
            gy1 = torch.where(reached, ngy, gy)
            # fresh reset (consumed unconditionally), applied where done
            (ry, rplan, (rgx, rgy), rfree, rship, rgoal, rcase, rflip, rcs) = goal_reset(u)
            y_out = [sel(ry[c], yf[c]) for c in range(6)]
            p_out = [sel(rp, pc) for rp, pc in zip(rplan, p_rows)]
            gx_out, gy_out = sel(rgx, gx1), sel(rgy, gy1)
            free = [sel(rf, f) for rf, f in zip(rfree, free)]
            ship_tile = sel(rship, ship_tile)
            goal_tile = sel(rgoal, goal_tile)
            case_b = sel(rcase, case_b)
            flip = sel(rflip, flip)
            col_shift_out = [sel(rc, c0) for rc, c0 in zip(rcs, col_shift)]
        elif task == TASK_KEPLER:
            ry, (roa, recc) = kepler_reset(u)
            y_out = [sel(ry[c], yf[c]) for c in range(6)]
            p_out = p_rows
            gx_out, gy_out = gx, gy
            if k.randomize:
                ref_out = [sel(roa, ref_rows[0]), sel(recc, ref_rows[1]), ref_rows[2]]
        else:
            ry = dnc_reset(u)
            y_out = [sel(ry[c], yf[c]) for c in range(6)]
            p_out = p_rows
            gx_out, gy_out = gx, gy

        steps_out = torch.where(done, 0, steps1)
        px_out = [p_out[2 * i] for i in range(n_planets)]
        py_out = [p_out[2 * i + 1] for i in range(n_planets)]
        obs = observe(y_out, px_out, py_out, gx_out, gy_out, ref_out)
        obs = [torch.where(done, o_new, o_f) for o_new, o_f in zip(obs, fobs)]

        i32 = torch.int32
        if n_tiles:
            tio = free + [ship_tile, goal_tile, steps_out, case_b.to(i32), flip.to(i32)]
        else:
            zero = torch.zeros_like(steps_out)
            tio = [steps_out, zero, zero]
        return (
            torch.stack(y_out), torch.stack(p_out), torch.stack([gx_out, gy_out]),
            torch.stack(ref_out), torch.stack(col_shift_out), torch.stack(obs),
            torch.stack(fobs), rew[None], torch.stack([t.to(i32) for t in tio]),
            torch.stack([terminated.to(i32), truncated.to(i32), done.to(i32)]),
        )

    return step
