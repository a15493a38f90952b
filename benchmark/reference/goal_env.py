"""Plain PyTorch reference of one batched Goal env step, frozen for the benchmark.

A standalone copy of the Goal path of the port's plain full-step twin
(physics, events, observation, reward, goal resample on the hexagonal tiling,
TimeLimit and masked auto-reset), kept independent of the program: it imports
neither the port, nor the JAX package, nor JAX, and builds every constant from
the configuration file (`benchmark/configs/<name>.json`).  It follows the
upstream Space-Gym semantics (MIMUW-RL/space-gym: gym_space/envs/goal.py,
dynamic_model.py, hexagonal_tiling.py) with fixed Dormand-Prince 5(4) or
Bogacki-Shampine 3(2) substeps and a safeguarded Illinois refinement of the
earliest terminal event, the integrator the configuration states.

Every tensor is one row over the sampled lanes, shape (n,).  The state is
`Lanes`: the ship's 6 components, the planets' 2P coordinates, the goal's 2,
the tiling's column shifts, and the integer rows (free counts per tile, the
ship's and the goal's tiles, the step counter, case and flip).  The step reads
its uniforms from an (n_u, n) block in the order the engine's draw lays them
out: the goal resample first, then the reset, both consumed on every lane.

`dtype` is the arithmetic's precision: float64 for the reference, bfloat16 for
the control that a lower precision must fail.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

G = 6.6743e-11
TWO_PI = 6.283185307179586
VELOCITY_STEERING_SCALE = 5.0
STEERING_VELOCITY = "velocity"

# hexagonal_tiling.py:8-10, 79-86
MAX_OBJ_TILES_RATIO = 0.6
PLANET_TILE_RATIO = 0.75
MAX_GOAL_CANDIDATES = 3
DIAGONAL_CASES = ((1, 0, 3), (2, 0, 3), (0, 1, 2), (3, 1, 2))

# Dormand-Prince 5(4) and Bogacki-Shampine 3(2) (scipy rk.RK45 / rk.RK23 A, B, P)
DP_A = ((), (1 / 5,), (3 / 40, 9 / 40), (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656))
DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
DP_P = (
    (1.0, -8048581381 / 2820520608, 8663915743 / 2820520608, -12715105075 / 11282082432),
    (0.0, 0.0, 0.0, 0.0),
    (0.0, 131558114200 / 32700410799, -68118460800 / 10900136933, 87487479700 / 32700410799),
    (0.0, -1754552775 / 470086768, 14199869525 / 1410260304, -10690763975 / 1880347072),
    (0.0, 127303824393 / 49829197408, -318862633887 / 49829197408, 701980252875 / 199316789632),
    (0.0, -282668133 / 205662961, 2019193451 / 616988883, -1453857185 / 822651844),
    (0.0, 40617522 / 29380423, -110615467 / 29380423, 69997945 / 29380423),
)
BS3_A = ((), (1 / 2,), (0.0, 3 / 4))
BS3_B = (2 / 9, 1 / 3, 4 / 9)
BS3_P = ((1.0, -4 / 3, 5 / 9), (0.0, 1.0, -2 / 3), (0.0, 4 / 3, -8 / 9), (0.0, -1.0, 1.0))
TABLEAUX = {"dp5": (DP_A, DP_B, DP_P, 6), "bs3": (BS3_A, BS3_B, BS3_P, 3)}


class Tiling(NamedTuple):
    """hexagonal_tiling.py:15-48 and :161-174, in closed form."""

    rows: int
    cols: int
    n_tiles: int
    a: float
    hex_height: float
    hex_width: float
    tiling_width: float
    planets_radius: float
    goal_radius: float
    ship_radius: float
    tile_row: tuple
    tile_col: tuple


def make_tiling(n_planets: int, world_size: float) -> Tiling:
    n_objects = n_planets + 2
    m = n_objects if n_planets == 2 else int(math.ceil(n_objects / MAX_OBJ_TILES_RATIO))
    r_ = math.sqrt(72 * math.sqrt(3) * m - 6 * math.sqrt(3) + 12) / 12 - 1 / 4 + math.sqrt(3) / 12
    r = int(math.ceil(r_))
    while True:
        c = int(math.floor(2 * math.sqrt(3) * r / 3 - 1 / 3 + math.sqrt(3) / 3))
        if r * c >= m:
            break
        r += 1
    a = 2 * math.sqrt(3) * world_size / (3 * (2 * r + 1))
    hex_height = a * math.sqrt(3)
    planets_radius = hex_height / 2 * PLANET_TILE_RATIO
    coords = [(row, col) for row in range(r) for col in range(c)]
    return Tiling(r, c, r * c, a, hex_height, 2 * a, 3 * a * (c - 1) / 2 + 2 * a,
                  planets_radius, planets_radius / 2, planets_radius / 2,
                  tuple(rc[0] for rc in coords), tuple(rc[1] for rc in coords))


class Lanes(NamedTuple):
    """One batch of env lanes as rows over the lanes."""

    y: list          # 6 rows: x, y, theta, vx, vy, omega
    planets: list    # 2P rows: x0, y0, x1, y1, ...
    goal: list       # 2 rows
    col_shift: list  # cols rows
    free: list       # n_tiles int32 rows
    ship_tile: torch.Tensor
    goal_tile: torch.Tensor
    steps: torch.Tensor
    case_b: torch.Tensor  # bool
    flip: torch.Tensor    # bool


class Step(NamedTuple):
    lanes: Lanes
    obs: list        # obs_dim rows after the auto-reset
    final_obs: list  # obs_dim rows before it
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor


class GoalEnv:
    """The Goal env of one configuration file, at one precision."""

    def __init__(self, config: dict, dtype=torch.float64):
        env = config["env"]
        eng = config["engine"]
        self.dtype = dtype
        self.n_planets = P = env["n_planets"]
        self.world_size = ws = float(env["world_size"])
        self.tiling = make_tiling(P, ws)
        self.max_episode_steps = env["max_episode_steps"]
        self.max_abs_vel_angle = float(env["max_abs_vel_angle"])
        self.step_size = float(env["step_size"])
        self.ship = env["ship"]
        self.goal = env["goal"]
        self.mass = self.goal["total_planets_mass"] / P
        self.radius = self.tiling.planets_radius
        self.substeps = eng["substeps"]
        self.refine_iters = eng["refine_iters"]
        self.tableau = eng["tableau"]
        self.obs_dim = 7 + 2 * P + 2
        t = self.tiling
        self.n_int = t.n_tiles + 5
        goal_place = 1 + t.n_tiles * MAX_GOAL_CANDIDATES + 2
        self.n_uniforms = goal_place + (2 + t.cols + t.n_tiles + (2 if P == 2 else 0)
                                        + 2 * (P + 1) + goal_place + 4)

    # ------------------------------------------------------------ physics --
    def _rhs(self, c, px, py, ae, at):
        x, y, th, vx, vy, w = c
        s_ = self.ship
        efs = ae * s_["max_engine_force"]
        fx = -torch.cos(th) * efs
        fy = -torch.sin(th) * efs
        for i in range(self.n_planets):
            dx = px[i] - x
            dy = py[i] - y
            d2 = dx * dx + dy * dy
            inv_d = torch.rsqrt(d2)
            s = (G * s_["mass"] * self.mass) / d2 * inv_d
            fx = fx + dx * s
            fy = fy + dy * s
        if s_["steering"] == STEERING_VELOCITY:
            aang = torch.zeros_like(at)
        else:
            aang = at * (s_["max_thruster_force"] / s_["moi"])
        return [vx, vy, w, fx / s_["mass"], fy / s_["mass"], aang]

    def _events(self, c, px, py):
        x, y, w = c[0], c[1], c[5]
        half = self.world_size / 2
        out = []
        for i in range(self.n_planets):
            dx = px[i] - x
            dy = py[i] - y
            out.append(torch.sqrt(dx * dx + dy * dy) - self.radius)
        out.append(torch.minimum(half - x, half - y))
        out.append(torch.minimum(half + x, half + y))
        out.append(self.max_abs_vel_angle - torch.abs(w))
        return out

    def physics(self, comp, px, py, ae, at):
        """dynamic_model.py with fixed substeps: (y at the step's end or at the
        earliest terminal event, terminated)."""
        T_A, T_B, T_P, n_stages = TABLEAUX[self.tableau]
        n_pw = len(T_P[0])
        n_events = self.n_planets + 3
        h = self.step_size / self.substeps
        if self.ship["steering"] == STEERING_VELOCITY:
            comp = list(comp)
            comp[5] = VELOCITY_STEERING_SCALE * at

        def wsum(vecs, coeffs):
            acc = vecs[0] * coeffs[0]
            for v, k in zip(vecs[1:], coeffs[1:]):
                acc = acc + v * k
            return acc

        def lcomb(stacks, coeffs):
            return [wsum([st[c] for st in stacks], coeffs) for c in range(6)]

        f = self._rhs(comp, px, py, ae, at)
        g = self._events(comp, px, py)
        zeros = torch.zeros_like(comp[0])
        terminated = torch.zeros(comp[0].shape, dtype=torch.bool, device=comp[0].device)
        y_final = [c + 0.0 for c in comp]
        t = 0.0
        for _ in range(self.substeps):
            K = [f]
            for s in range(1, n_stages):
                dy = lcomb(K, T_A[s])
                K.append(self._rhs([comp[c] + dy[c] * h for c in range(6)], px, py, ae, at))
            inc = lcomb(K, T_B)
            y_new = [comp[c] + h * inc[c] for c in range(6)]
            f_new = self._rhs(y_new, px, py, ae, at)
            K.append(f_new)
            g_new = self._events(y_new, px, py)
            active = [((g[e] <= 0) & (g_new[e] >= 0)) | ((g[e] >= 0) & (g_new[e] <= 0))
                      for e in range(n_events)]
            any_event = active[0]
            for e in range(1, n_events):
                any_event = any_event | active[e]
            fire = any_event & ~terminated
            Q = [[wsum([st[c] for st in K], tuple(T_P[j][m] for j in range(n_stages + 1)))
                  for m in range(n_pw)] for c in range(6)]
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

            sgn = [torch.where(g[e] < 0, -1.0, 1.0).to(comp[0].dtype) for e in range(n_events)]

            def m_norm(ge, active=active, sgn=sgn):
                mm = None
                for e in range(n_events):
                    v = torch.where(active[e], sgn[e] * ge[e], float("inf"))
                    mm = v if mm is None else torch.minimum(mm, v)
                return mm

            lo = torch.full_like(comp[0], t0)
            hi = torch.full_like(comp[0], t0 + h)
            hi = _illinois(lambda tq: m_norm(self._events(sol(tq), px, py)),
                           lo, hi, m_norm(g), m_norm(g_new), self.refine_iters)
            y_root = sol(hi)
            for c in range(6):
                y_final[c] = torch.where(fire, y_root[c],
                                         torch.where(terminated, y_final[c], y_new[c]))
            terminated = terminated | fire
            comp = [torch.where(terminated, y_final[c], y_new[c]) for c in range(6)]
            f = [torch.where(terminated, zeros, f_new[c]) for c in range(6)]
            g = [torch.where(terminated, g[e], g_new[e]) for e in range(n_events)]
            t = t + h
        y_final[2] = torch.remainder(y_final[2], TWO_PI)
        return y_final, terminated

    # ------------------------------------------------- observation, reward --
    def observe(self, comp, px, py, gx, gy):
        """spaceship_env.py:102-111: the ship, then the lidar to each planet
        and to the goal."""
        x, yy, th, vx, vy, w = comp
        out = [x, yy, torch.cos(th), torch.sin(th), vx, vy, w]

        def lidar(ox, oy, radius):
            vx_ = ox - x
            vy_ = oy - yy
            dd = torch.sqrt(vx_ * vx_ + vy_ * vy_)
            scale = (dd - radius) * (2.0 / self.world_size) / dd
            return [vx_ * scale, vy_ * scale]

        for i in range(self.n_planets):
            out += lidar(px[i], py[i], self.radius)
        out += lidar(gx, gy, 0.0)
        return out

    def reward(self, comp0, yf, px, py, gx, gy):
        """goal.py:74-131: survival, goal velocity, safety, sparse bonus."""
        gl = self.goal
        x, yy = yf[0], yf[1]
        x0, y0 = comp0[0], comp0[1]
        cur = torch.sqrt((gx - x) ** 2 + (gy - yy) ** 2)
        last = torch.sqrt((gx - x0) ** 2 + (gy - y0) ** 2)
        gvr = (last - cur) * gl["distance_fctr"]
        mind = cx = cy = None
        for i in range(self.n_planets):
            dx = px[i] - x
            dy = py[i] - yy
            dd = torch.sqrt(dx * dx + dy * dy)
            if mind is None:
                mind, cx, cy = dd, px[i], py[i]
            else:
                closer = dd < mind
                cx = torch.where(closer, px[i], cx)
                cy = torch.where(closer, py[i], cy)
                mind = torch.minimum(dd, mind)
        prev = torch.sqrt((cx - x0) ** 2 + (cy - y0) ** 2)
        safety = torch.where(((mind - self.radius) < gl["danger_zone"]) & (prev > mind),
                             -gl["distance_fctr"] * (prev - mind), 0.0)
        rew = (gl["survival_reward_scale"] + gl["goal_vel_reward_scale"] * gvr
               + gl["safety_reward_scale"] * safety)
        reached = cur < self.tiling.goal_radius
        return torch.where(reached, rew + gl["goal_sparse_reward"], rew), reached

    # --------------------------------------------------------------- tiling --
    def _i32(self, like, v):
        return torch.full(like.shape, v, dtype=torch.int32, device=like.device)

    def tile_center(self, tile, case_b, flip, cs):
        """tile_center_pos (hexagonal_tiling.py:136-158)."""
        t = self.tiling
        row = torch.zeros_like(cs[0])
        col = torch.zeros_like(row)
        shift = torch.zeros_like(row)
        parity = torch.zeros_like(row)
        for tnr in range(t.n_tiles):
            is_t = tile == tnr
            row = torch.where(is_t, float(t.tile_row[tnr]), row)
            col = torch.where(is_t, float(t.tile_col[tnr]), col)
            shift = torch.where(is_t, cs[t.tile_col[tnr]], shift)
            parity = torch.where(is_t, float(t.tile_col[tnr] % 2), parity)
        ws = self.world_size
        zero_x = -ws / 2 + t.hex_width / 2
        zero_y = torch.where(case_b, torch.full_like(row, ws / 2 - t.hex_height),
                             ws / 2 - t.hex_height / 2)
        x = zero_x + col * (1.5 * t.a) + shift
        y_cols = -parity * (t.hex_height / 2)
        y_cols = torch.where(case_b, -y_cols, y_cols)
        y = zero_y - row * t.hex_height + y_cols
        return torch.where(flip, y, x), torch.where(flip, x, y)

    def _tile_rc(self, tile):
        t = self.tiling
        r = torch.zeros_like(tile)
        c = torch.zeros_like(tile)
        for tnr in range(t.n_tiles):
            is_t = tile == tnr
            r = torch.where(is_t, t.tile_row[tnr], r)
            c = torch.where(is_t, t.tile_col[tnr], c)
        return r, c

    def _disk(self, u, radius):
        """uniform_disk (helpers.py:48-53): angle, then radius."""
        ang = u.take() * TWO_PI
        r = torch.sqrt(u.take()) * radius
        return r * torch.cos(ang), r * torch.sin(ang)

    def goal_place(self, u, free, ship_tile, goal_tile, case_b, flip, cs):
        """find_new_goal (hexagonal_tiling.py:95-128): (free, ship tile, goal
        tile, goal x, goal y)."""
        t = self.tiling
        dup = MAX_GOAL_CANDIDATES
        subsequent = goal_tile >= 0
        free2 = [torch.where(subsequent & (ship_tile == i), torch.clamp(free[i] + 1, max=dup),
                             free[i]) for i in range(t.n_tiles)]
        ship2 = torch.where(subsequent, goal_tile, ship_tile)
        same = u.take() < 0.25
        entry_scores = []
        for i in range(t.n_tiles):
            for j in range(dup):
                sc = u.take()
                entry_scores.append(torch.where(free2[i] > j, sc, -1.0))
        banned = [s < -2.0 for s in entry_scores]
        cand_tiles, cand_valid = [], []
        for _ in range(min(MAX_GOAL_CANDIDATES, t.n_tiles * dup)):
            best_v = best_e = None
            for e, sc in enumerate(entry_scores):
                scm = torch.where(banned[e], -2.0, sc)
                if best_v is None:
                    best_v, best_e = scm, self._i32(scm, e)
                else:
                    better = scm > best_v
                    best_v = torch.where(better, scm, best_v)
                    best_e = torch.where(better, e, best_e)
            banned = [banned[e] | (best_e == e) for e in range(len(entry_scores))]
            cand_tiles.append(torch.div(best_e, dup, rounding_mode="floor"))
            cand_valid.append(best_v >= 0)
        ship_r, ship_c = self._tile_rc(ship2)
        best_taxi = best_tile = None
        for tile, v in zip(cand_tiles, cand_valid):
            tr, tc = self._tile_rc(tile)
            taxi = torch.where(v, torch.abs(tr - ship_r) + torch.abs(tc - ship_c), -1)
            if best_taxi is None:
                best_taxi, best_tile = taxi, tile
            else:
                better = taxi > best_taxi
                best_taxi = torch.where(better, taxi, best_taxi)
                best_tile = torch.where(better, tile, best_tile)
        goal2 = torch.where(same, ship2, best_tile)
        free3 = [torch.where(~same & (best_tile == i), free2[i] - 1, free2[i])
                 for i in range(t.n_tiles)]
        cx, cy = self.tile_center(goal2, case_b, flip, cs)
        nx, ny = self._disk(u, t.hex_height / 2 - t.goal_radius)
        return free3, ship2, goal2, cx + nx, cy + ny

    def _pick_distinct(self, scores, n_pick):
        """n_pick masked argmin passes over iid scores: the law of
        argsort[:n_pick]."""
        banned = None
        picks = []
        for _ in range(n_pick):
            best_v = best_i = None
            for i, sc in enumerate(scores):
                scm = sc if banned is None else torch.where(banned[i], 2.0, sc)
                if best_v is None:
                    best_v, best_i = scm, self._i32(scm, i)
                else:
                    better = scm < best_v
                    best_v = torch.where(better, scm, best_v)
                    best_i = torch.where(better, i, best_i)
            picks.append(best_i)
            banned = [(banned[i] if banned is not None else best_v < -1.0) | (best_i == i)
                      for i in range(len(scores))]
        return picks

    def reset(self, u):
        """goal.py:133-145: the tiling's layout, ship and planets, the first
        goal, the ship's kinematics."""
        t = self.tiling
        P = self.n_planets
        case_b = u.take() < 0.5
        flip = u.take() < 0.5
        cums, acc = [], None
        for _ in range(t.cols):
            r = u.take()
            acc = r if acc is None else acc + r
            cums.append(acc)
        free_x = self.world_size - t.tiling_width
        cs = [c * (free_x / cums[-1]) for c in cums]
        picks = self._pick_distinct([u.take() for _ in range(t.n_tiles)], P + 1)
        if P == 2:
            use_diag = u.take() < 0.25
            case_i = torch.clamp((u.take() * len(DIAGONAL_CASES)).to(torch.int32),
                                 max=len(DIAGONAL_CASES) - 1)
            for slot in range(3):
                dv = torch.zeros_like(picks[slot])
                for ci, diag in enumerate(DIAGONAL_CASES):
                    dv = torch.where(case_i == ci, diag[slot], dv)
                picks[slot] = torch.where(use_diag, dv, picks[slot])
        free = []
        for i in range(t.n_tiles):
            occ = picks[0] == i
            for p in picks[1:]:
                occ = occ | (p == i)
            free.append(torch.where(occ, 0, self._i32(occ, 1)))
        pos = []
        for p, orad in zip(picks, [t.ship_radius] + [t.planets_radius] * P):
            cx, cy = self.tile_center(p, case_b, flip, cs)
            nx, ny = self._disk(u, t.hex_height / 2 - orad)
            pos.append((cx + nx, cy + ny))
        free, ship_tile, goal_tile, gx, gy = self.goal_place(
            u, free, picks[0], self._i32(picks[0], -1), case_b, flip, cs)
        max_w = 0.7 * self.max_abs_vel_angle
        angle = u.take() * TWO_PI
        vx = u.normal() * 0.07
        vy = u.normal() * 0.07
        w0 = torch.clamp(u.normal() * (max_w / 3), -max_w, max_w)
        return Lanes([pos[0][0], pos[0][1], angle, vx, vy, w0],
                     [c for p in pos[1:] for c in p], [gx, gy], cs, free, ship_tile,
                     goal_tile, torch.zeros_like(ship_tile), case_b, flip)

    # ----------------------------------------------------------------- step --
    def step(self, s: Lanes, action: torch.Tensor, u_rows: torch.Tensor) -> Step:
        """One step of every lane: `action` (n, 2) raw in [-1, 1], `u_rows`
        (n_u, n) uniforms."""
        dt = self.dtype
        s = s._replace(**{f: [r.to(dt) for r in getattr(s, f)]
                          for f in ("y", "planets", "goal", "col_shift")})
        a = torch.clamp(action.to(dt), -1.0, 1.0)
        ae, at = (a[:, 0] + 1) / 2, a[:, 1]
        u = Uniforms(u_rows.to(dt))
        P = self.n_planets
        px = [s.planets[2 * i] for i in range(P)]
        py = [s.planets[2 * i + 1] for i in range(P)]
        gx, gy = s.goal
        yf, terminated = self.physics(s.y, px, py, ae, at)
        steps1 = s.steps + 1
        truncated = (steps1 >= self.max_episode_steps) & ~terminated
        done = terminated | truncated
        fobs = self.observe(yf, px, py, gx, gy)
        rew, reached = self.reward(s.y, yf, px, py, gx, gy)

        nfree, nship, ngoal, ngx, ngy = self.goal_place(
            u, s.free, s.ship_tile, s.goal_tile, s.case_b, s.flip, s.col_shift)
        free = [torch.where(reached, nf, f) for nf, f in zip(nfree, s.free)]
        ship_tile = torch.where(reached, nship, s.ship_tile)
        goal_tile = torch.where(reached, ngoal, s.goal_tile)
        gx1 = torch.where(reached, ngx, gx)
        gy1 = torch.where(reached, ngy, gy)
        r = self.reset(u)

        def sel(new, old):
            return torch.where(done, new, old)

        out = Lanes(
            [sel(n, o) for n, o in zip(r.y, yf)],
            [sel(n, o) for n, o in zip(r.planets, s.planets)],
            [sel(r.goal[0], gx1), sel(r.goal[1], gy1)],
            [sel(n, o) for n, o in zip(r.col_shift, s.col_shift)],
            [sel(n, o) for n, o in zip(r.free, free)],
            sel(r.ship_tile, ship_tile), sel(r.goal_tile, goal_tile),
            torch.where(done, 0, steps1), sel(r.case_b, s.case_b), sel(r.flip, s.flip))
        opx = [out.planets[2 * i] for i in range(P)]
        opy = [out.planets[2 * i + 1] for i in range(P)]
        obs = self.observe(out.y, opx, opy, out.goal[0], out.goal[1])
        obs = [torch.where(done, n, o) for n, o in zip(obs, fobs)]
        return Step(out, obs, fobs, rew, terminated, truncated)


def _illinois(fn, lo, hi, f_lo, f_hi, iters: int):
    """Safeguarded Illinois false position on [lo, hi], fn decreasing through
    its root (f_lo >= 0 >= f_hi); returns the high end of the last bracket."""
    one = torch.ones_like(lo)
    side = torch.zeros_like(lo)
    for _ in range(iters):
        mid_fp = hi - f_hi * (hi - lo) / (f_hi - f_lo)
        good = torch.isfinite(mid_fp) & (mid_fp > lo) & (mid_fp < hi)
        mid = torch.where(good, mid_fp, 0.5 * (lo + hi))
        g_mid = fn(mid)
        left = g_mid <= 0
        f_lo = torch.where(left, torch.where(side > 0, 0.5 * f_lo, f_lo), g_mid)
        f_hi = torch.where(left, g_mid, torch.where(side < 0, 0.5 * f_hi, f_hi))
        lo = torch.where(left, lo, mid)
        hi = torch.where(left, mid, hi)
        side = torch.where(left, one, -one)
    return hi


# Acklam's rational approximation of the standard normal inverse CDF
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
    """Acklam's inverse normal CDF, evaluated on both branches."""
    a, b, c, d = _NI_A, _NI_B, _NI_C, _NI_D
    eps = torch.finfo(u.dtype).eps / 2
    u = torch.clamp(u, eps, 1 - eps)
    q = u - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r) + 1.0
    central = q * num / den
    ql = torch.sqrt(-2.0 * torch.log(torch.minimum(u, 1 - u)))
    numt = ((((c[0] * ql + c[1]) * ql + c[2]) * ql + c[3]) * ql + c[4]) * ql + c[5]
    dent = ((((d[0] * ql + d[1]) * ql + d[2]) * ql + d[3]) * ql) + 1.0
    tail = numt / dent
    tail = torch.where(u < 0.5, tail, -tail)
    return torch.where((u < _NI_PLOW) | (u > 1 - _NI_PLOW), tail, central)


class Uniforms:
    """Row cursor over an (n_u, n) block of uniforms."""

    def __init__(self, rows: torch.Tensor):
        self.rows = rows
        self.i = 0

    def take(self) -> torch.Tensor:
        v = self.rows[self.i]
        self.i += 1
        return v

    def normal(self):
        return norminv(self.take())
