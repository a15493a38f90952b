// Kernel K3: the whole env step, for every lane, in one launch.
//
// Replaces the Pallas TPU kernel space_gym_tpu/ops/pallas_full.py::
// make_full_step.<locals>.kernel (pallas_full.py:500, pallas_call at :663)
// with the uniforms drawn outside the kernel (in_kernel_rng=False).  Per lane:
// physics (csrc/physics.cuh), the final observation, the per-task reward,
// the Goal resample through the hex tiling where the goal is reached,
// TimeLimit, and the masked auto-reset for Goal/Kepler/DoNotCrash with the
// post-reset observation.  Plain twin: space_gym_torch/ops/full_step_plain.py.
//
// Operands are component-major (rows, B): inputs y 6, a 2, p 2P, g 2, ref 3,
// cs max(cols,1), u n_u (float32), ti int_rows (int32); outputs y' 6, p' 2P,
// g' 2, ref' 3, cs' max(cols,1), obs D, final obs D, reward 1 (float32),
// ti' int_rows, flags 3 = (terminated, truncated, done) (int32).
//
// Uniforms: the kernel reads the (n_u, B) block by row index in exactly the
// JAX kernel's consumption order — the Goal resample's rows first, then the
// reset's (pallas_full.py:550-599) — so the same u gives the same resets,
// lane for lane.  Because every row has a fixed index, a lane that does not
// reach its goal skips the resample and a lane that is not done skips the
// reset: their results would be discarded by the JAX kernel's selects.
//
// What bounds it on an H100: bytes.  It moves (in + out) x 4 bytes per lane
// (536 B for GoalContinuous2P-v0 by the operand list, less where lanes skip
// their uniform rows) against a few hundred float operations per lane, which
// at the card's f32 rate take a tenth of the memory time (chip_smoke.py
// prints both).  The operations form one long dependent chain per lane, so
// latency and occupancy, not the bound, set its time for now.  Design: one
// thread per lane with all state in
// registers; the planet count, tile count, column count, task and tableau
// are template parameters, so the tile loops unroll and the per-tile arrays
// stay in registers (printed by -Xptxas -v at build time); the ragged edge
// is masked, so any B works.  Not tuned yet: see PERF.md.
#include <cuda_runtime.h>

#include "physics.cuh"

#define SG_TASK_GOAL 0
#define SG_TASK_KEPLER 1
#define SG_TASK_DNC 2
#define SG_DUP 3  // free-entry duplicate cap = MAX_GOAL_CANDIDATES

// Row cursor over the (n_u, B) uniforms block, for one lane.
struct URows {
  const float* __restrict__ u;
  size_t n;
  int lane;
  int i;
  __device__ __forceinline__ float take() { return u[(size_t)(i++) * n + lane]; }
};

// Acklam's inverse normal CDF (pallas_full.py:39-72), clipped to
// [epsneg, 1 - epsneg] of float32.
__device__ __forceinline__ float sg_norminv(float u) {
  const float eps = 5.9604645e-08f;  // numpy finfo(float32).epsneg = 2**-24
  u = fminf(fmaxf(u, eps), 1.f - eps);
  const float a0 = (float)-3.969683028665376e+01, a1 = (float)2.209460984245205e+02,
              a2 = (float)-2.759285104469687e+02, a3 = (float)1.383577518672690e+02,
              a4 = (float)-3.066479806614716e+01, a5 = (float)2.506628277459239e+00;
  const float b0 = (float)-5.447609879822406e+01, b1 = (float)1.615858368580409e+02,
              b2 = (float)-1.556989798598866e+02, b3 = (float)6.680131188771972e+01,
              b4 = (float)-1.328068155288572e+01;
  const float c0 = (float)-7.784894002430293e-03, c1 = (float)-3.223964580411365e-01,
              c2 = (float)-2.400758277161838e+00, c3 = (float)-2.549732539343734e+00,
              c4 = (float)4.374664141464968e+00, c5 = (float)2.938163982698783e+00;
  const float d0 = (float)7.784695709041462e-03, d1 = (float)3.224671290700398e-01,
              d2 = (float)2.445134137142996e+00, d3 = (float)3.754408661907416e+00;
  const float q = u - 0.5f;
  const float r = q * q;
  const float num = ((((a0 * r + a1) * r + a2) * r + a3) * r + a4) * r + a5;
  const float den = (((((b0 * r + b1) * r + b2) * r + b3) * r + b4) * r) + 1.f;
  const float central = q * num / den;
  const float ul = fminf(u, 1.f - u);
  const float ql = sqrtf(-2.f * logf(ul));
  const float numt = ((((c0 * ql + c1) * ql + c2) * ql + c3) * ql + c4) * ql + c5;
  const float dent = ((((d0 * ql + d1) * ql + d2) * ql + d3) * ql) + 1.f;
  float tail = numt / dent;
  tail = u < 0.5f ? tail : -tail;
  const bool in_tail = (u < (float)0.02425) || (u > (float)(1.0 - 0.02425));
  return in_tail ? tail : central;
}

// uniform_disk (helpers.py:48-53): angle, then radius.
__device__ __forceinline__ void sg_disk_noise(URows& U, float radius, float& nx, float& ny) {
  const float ang = U.take() * SG_TWO_PI;
  const float r = sqrtf(U.take()) * radius;
  nx = r * cosf(ang);
  ny = r * sinf(ang);
}

// tile_center_pos (hexagonal_tiling.py:136-158); tiles are numbered row-major
// (tile = row * COLS + col), an index outside [0, NT) gives the (0, 0) tile
// coordinates like the JAX select chain.
template <int NT, int COLS>
__device__ __forceinline__ void sg_tile_center(const FullParams& P, int tile, bool case_b, bool flip,
                                               const float* cs, float& xf, float& yf) {
  float row = 0.f, col = 0.f, shift = 0.f, parity = 0.f;
  if (tile >= 0 && tile < NT) {
    const int c = tile % COLS;
    row = (float)(tile / COLS);
    col = (float)c;
    parity = (float)(c % 2);
#pragma unroll
    for (int k = 0; k < COLS; ++k) shift = (c == k) ? cs[k] : shift;
  }
  const float zero_y = case_b ? P.zero_y_b : P.zero_y_a;
  const float x = P.zero_x + col * P.col_step + shift;
  float y_cols = -parity * P.half_hex_height;
  y_cols = case_b ? -y_cols : y_cols;
  const float y = zero_y - row * P.hex_height + y_cols;
  xf = flip ? y : x;
  yf = flip ? x : y;
}

template <int NT, int COLS>
__device__ __forceinline__ void sg_tile_rc(int tile, int& r, int& c) {
  const bool in = tile >= 0 && tile < NT;
  r = in ? tile / COLS : 0;
  c = in ? tile % COLS : 0;
}

// find_new_goal (hexagonal_tiling.py:95-128): consumes 1 + NT*DUP + 2 rows.
// fr: in/out free-list entry counts; ship, goal: in/out tiles; gx, gy: new goal.
template <int NT, int COLS>
__device__ void sg_goal_place(const FullParams& P, URows& U, int* fr, int& ship, int& goal,
                              bool case_b, bool flip, const float* cs, float& gx, float& gy) {
  constexpr int NE = NT * SG_DUP;
  constexpr int NCAND = NE < 3 ? NE : 3;
  const bool subsequent = goal >= 0;
#pragma unroll
  for (int i = 0; i < NT; ++i)
    fr[i] = (subsequent && ship == i) ? min(fr[i] + 1, SG_DUP) : fr[i];
  const int ship2 = subsequent ? goal : ship;

  const bool same = U.take() < 0.25f;
  // invalid entries sit below any valid score so the argmax passes skip them
  float es[NE];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int j = 0; j < SG_DUP; ++j) {
      const float sc = U.take();
      es[i * SG_DUP + j] = fr[i] > j ? sc : -1.f;
    }
  }
  bool banned[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) banned[e] = false;
  int cand_t[NCAND];
  bool cand_v[NCAND];
#pragma unroll
  for (int k = 0; k < NCAND; ++k) {
    float best_v = banned[0] ? -2.f : es[0];
    int best_e = 0;
#pragma unroll
    for (int e = 1; e < NE; ++e) {
      const float scm = banned[e] ? -2.f : es[e];
      if (scm > best_v) {
        best_v = scm;
        best_e = e;
      }
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) banned[e] = banned[e] || (best_e == e);
    cand_t[k] = best_e / SG_DUP;
    cand_v[k] = best_v >= 0.f;
  }
  // farthest taxi distance from ship2; the random candidate order breaks ties
  int sr, sc;
  sg_tile_rc<NT, COLS>(ship2, sr, sc);
  int best_taxi = 0, best_tile = 0;
#pragma unroll
  for (int k = 0; k < NCAND; ++k) {
    int tr, tc;
    sg_tile_rc<NT, COLS>(cand_t[k], tr, tc);
    int taxi = abs(tr - sr) + abs(tc - sc);
    taxi = cand_v[k] ? taxi : -1;
    if (k == 0 || taxi > best_taxi) {
      best_taxi = taxi;
      best_tile = cand_t[k];
    }
  }
  const int goal2 = same ? ship2 : best_tile;
#pragma unroll
  for (int i = 0; i < NT; ++i) fr[i] = (!same && best_tile == i) ? fr[i] - 1 : fr[i];
  float cx, cy, nx, ny;
  sg_tile_center<NT, COLS>(P, goal2, case_b, flip, cs, cx, cy);
  sg_disk_noise(U, P.disk_r_goal, nx, ny);
  ship = ship2;
  goal = goal2;
  gx = cx + nx;
  gy = cy + ny;
}

// tiling_reset + first goal + ship kinematics (goal.py:133-145).
template <int NP, int NT, int COLS>
__device__ void sg_goal_reset(const FullParams& P, URows& U, float* y, float* pl, float& gx,
                              float& gy, int* fr, int& ship, int& goal, bool& case_b, bool& flip,
                              float* cs) {
  case_b = U.take() < 0.5f;
  flip = U.take() < 0.5f;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    const float r = U.take();
    acc = c == 0 ? r : acc + r;
    cs[c] = acc;
  }
  const float fac = P.free_x / cs[COLS - 1];
#pragma unroll
  for (int c = 0; c < COLS; ++c) cs[c] = cs[c] * fac;

  float scores[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) scores[i] = U.take();
  // NP+1 sequential masked argmin passes (the law of argsort[:NP+1])
  int picks[NP + 1];
  bool banned[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) banned[i] = false;
#pragma unroll
  for (int k = 0; k < NP + 1; ++k) {
    float best_v = banned[0] ? 2.f : scores[0];
    int best_i = 0;
#pragma unroll
    for (int i = 1; i < NT; ++i) {
      const float scm = banned[i] ? 2.f : scores[i];
      if (scm < best_v) {
        best_v = scm;
        best_i = i;
      }
    }
    picks[k] = best_i;
#pragma unroll
    for (int i = 0; i < NT; ++i) banned[i] = banned[i] || (best_i == i);
  }
  if constexpr (NP == 2) {
    // 25% forced diagonal layouts (hexagonal_tiling.py:75-87)
    const int diag[4][3] = {{1, 0, 3}, {2, 0, 3}, {0, 1, 2}, {3, 1, 2}};
    const bool use_diag = U.take() < 0.25f;
    const int case_i = min((int)(U.take() * 4.f), 3);
#pragma unroll
    for (int slot = 0; slot < 3; ++slot) {
      int dv = 0;
#pragma unroll
      for (int ci = 0; ci < 4; ++ci) dv = case_i == ci ? diag[ci][slot] : dv;
      picks[slot] = use_diag ? dv : picks[slot];
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    bool occ = false;
#pragma unroll
    for (int k = 0; k < NP + 1; ++k) occ = occ || (picks[k] == i);
    fr[i] = occ ? 0 : 1;
  }
  // disc positions: ship, then planets
#pragma unroll
  for (int k = 0; k < NP + 1; ++k) {
    float cx, cy, nx, ny;
    sg_tile_center<NT, COLS>(P, picks[k], case_b, flip, cs, cx, cy);
    sg_disk_noise(U, k == 0 ? P.disk_r_ship : P.disk_r_planet, nx, ny);
    if (k == 0) {
      y[0] = cx + nx;
      y[1] = cy + ny;
    } else {
      pl[2 * (k - 1)] = cx + nx;
      pl[2 * (k - 1) + 1] = cy + ny;
    }
  }
  ship = picks[0];
  goal = -1;
  sg_goal_place<NT, COLS>(P, U, fr, ship, goal, case_b, flip, cs, gx, gy);
  y[2] = U.take() * SG_TWO_PI;
  y[3] = sg_norminv(U.take()) * 0.07f;
  y[4] = sg_norminv(U.take()) * 0.07f;
  y[5] = fminf(fmaxf(sg_norminv(U.take()) * P.max_w_3, -P.max_w), P.max_w);
}

// Kepler (kepler.py:233-267) and DoNotCrash (do_not_crash.py:34-45) resets.
__device__ void sg_orbit_reset(const FullParams& P, URows& U, bool kepler, float* y, float& oa,
                               float& ecc) {
  const float pa = U.take() * SG_TWO_PI;
  const float dist = kepler ? P.k_dist_lo + U.take() * P.k_dist_span
                            : P.d_dist_lo + U.take() * P.d_dist_span;
  y[0] = cosf(pa) * dist;
  y[1] = sinf(pa) * dist;
  y[2] = U.take() * SG_TWO_PI;
  if (kepler && P.kepler_randomize) {
    ecc = U.take() * 0.7f;
    oa = U.take() * SG_TWO_PI;
  }
  const float vs = kepler ? 0.05f : 0.07f;
  y[3] = sg_norminv(U.take()) * vs;
  y[4] = sg_norminv(U.take()) * vs;
  y[5] = fminf(fmaxf(sg_norminv(U.take()) * (kepler ? P.max_w_5 : P.max_w_3), -P.max_w), P.max_w);
}

// unit(ship->obj) * (dist - radius) * 2 / world_size, as v/|v| * scale.
__device__ __forceinline__ void sg_lidar(const FullParams& P, float x, float y, float ox, float oy,
                                         float radius, float& lx, float& ly) {
  const float vx = ox - x;
  const float vy = oy - y;
  const float dd = sqrtf(vx * vx + vy * vy);
  const float scale = (dd - radius) * P.two_over_ws / dd;
  lx = vx * scale;
  ly = vy * scale;
}

template <int TASK, int NP>
__device__ __forceinline__ void sg_observe(const FullParams& P, const float* y, const float* pl,
                                           float gx, float gy, const float* ref, float* out) {
  out[0] = y[0];
  out[1] = y[1];
  out[2] = cosf(y[2]);
  out[3] = sinf(y[2]);
  out[4] = y[3];
  out[5] = y[4];
  out[6] = y[5];
  if constexpr (TASK == SG_TASK_GOAL) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      sg_lidar(P, y[0], y[1], pl[2 * i], pl[2 * i + 1], P.phys.radii[i], out[7 + 2 * i],
               out[8 + 2 * i]);
    sg_lidar(P, y[0], y[1], gx, gy, 0.f, out[7 + 2 * NP], out[8 + 2 * NP]);
  }
  if constexpr (TASK == SG_TASK_KEPLER) {
    out[7] = ref[0];
    out[8] = ref[1];
    out[9] = ref[2];
  }
}

// Per-task reward (goal.py:147-158, kepler.py:111-150 _dense_reward5, DNC
// constant); `reached` only for Goal.
template <int TASK, int NP>
__device__ __forceinline__ float sg_reward(const FullParams& P, const float* y0, const float* yf,
                                           const float* pl, float gx, float gy, const float* ref,
                                           float ae, float at, bool& reached) {
  reached = false;
  const float x = yf[0], yy = yf[1], vx = yf[3], vy = yf[4];
  if constexpr (TASK == SG_TASK_GOAL) {
    const float x0 = y0[0], y0_ = y0[1];
    const float dgx = gx - x, dgy = gy - yy;
    const float cur = sqrtf(dgx * dgx + dgy * dgy);
    const float dlx = gx - x0, dly = gy - y0_;
    const float last = sqrtf(dlx * dlx + dly * dly);
    const float gvr = (last - cur) * P.distance_fctr;
    float mind = 0.f, cx = 0.f, cy = 0.f, cr = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const float dx = pl[2 * i] - x;
      const float dy = pl[2 * i + 1] - yy;
      const float dd = sqrtf(dx * dx + dy * dy);
      if (i == 0 || dd < mind) {
        cx = pl[2 * i];
        cy = pl[2 * i + 1];
        cr = P.phys.radii[i];
      }
      mind = i == 0 ? dd : sg_min(dd, mind);
    }
    const float pdx = cx - x0, pdy = cy - y0_;
    const float prev = sqrtf(pdx * pdx + pdy * pdy);
    const float safety =
        ((mind - cr) < P.danger_zone && prev > mind) ? P.neg_distance_fctr * (prev - mind) : 0.f;
    const float rew = P.survival + P.gv_scale * gvr + P.safety_scale * safety;
    reached = cur < P.goal_radius;
    return rew + (reached ? P.sparse : 0.f);
  }
  if constexpr (TASK == SG_TASK_KEPLER) {
    const float ra = ref[0], ecc = ref[1], a_ax = ref[2];
    const float b_ax = sqrtf(a_ax * a_ax * (1.f - ecc * ecc));
    const float c_f = sqrtf(a_ax * a_ax - b_ax * b_ax);
    const float ca = cosf(ra), sa = sinf(ra);
    const float wp = ca * x + sa * yy - c_f;
    const float zp = -sa * x + ca * yy;
    const float r2 = wp * wp + zp * zp;
    const float cur_rad = sqrtf(r2);
    const float target_rad = b_ax * rsqrtf(1.f - ecc * ecc * wp * wp / r2);
    const float sc = target_rad / cur_rad;
    const float wq = wp * sc, zq = zp * sc;
    float vtw = -(a_ax / b_ax) * zq;
    float vtz = (b_ax / a_ax) * wq;
    const float wc = wq + c_f;
    const float rfoc = sqrtf(wc * wc + zq * zq);
    const float vmag = sqrtf(P.alpha_gm * (2.f / rfoc - 1.f / a_ax));
    const float vn = sqrtf(vtw * vtw + vtz * vtz);
    vtw = vtw * vmag / vn;
    vtz = vtz * vmag / vn;
    const float tvx = ca * vtw - sa * vtz;
    const float tvy = sa * vtw + ca * vtz;
    const float act_pen = sqrtf(ae * ae + at * at);
    return P.k_C / (P.k_rad_C * fabsf(cur_rad - target_rad) + fabsf(tvx - vx) + fabsf(tvy - vy) +
                    P.k_act_C * act_pen + P.k_C);
  }
  return P.dnc_reward;
}

template <int TASK, int NP, int NT, int COLS, int TAB>
__global__ void __launch_bounds__(128)
    full_step_kernel(const FullParams P, const float* __restrict__ y_in,
                     const float* __restrict__ a_in, const float* __restrict__ p_in,
                     const float* __restrict__ g_in, const float* __restrict__ r_in,
                     const float* __restrict__ cs_in, const float* __restrict__ u_in,
                     const int* __restrict__ ti_in, float* __restrict__ yo,
                     float* __restrict__ po, float* __restrict__ go, float* __restrict__ ro,
                     float* __restrict__ cso, float* __restrict__ obs_out,
                     float* __restrict__ fobs_out, float* __restrict__ rew_out,
                     int* __restrict__ tio, int* __restrict__ flags, int B) {
  constexpr bool GOAL = TASK == SG_TASK_GOAL;
  constexpr int NTA = NT > 0 ? NT : 1;  // array extents
  constexpr int CSR = COLS > 0 ? COLS : 1;
  constexpr int IR = GOAL ? NT + 5 : 3;
  constexpr int D = 7 + (GOAL ? 2 * NP + 2 : 0) + (TASK == SG_TASK_KEPLER ? 3 : 0);
  constexpr int GP_ROWS = 1 + NT * SG_DUP + 2;  // rows of one goal placement

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t n = (size_t)B;

  float y0[6], pl[2 * NP], ref[3], cs[CSR];
#pragma unroll
  for (int c = 0; c < 6; ++c) y0[c] = y_in[c * n + lane];
  const float ae = a_in[lane], at = a_in[n + lane];
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) pl[i] = p_in[i * n + lane];
  float gx = g_in[lane], gy = g_in[n + lane];
#pragma unroll
  for (int i = 0; i < 3; ++i) ref[i] = r_in[i * n + lane];
#pragma unroll
  for (int i = 0; i < CSR; ++i) cs[i] = cs_in[i * n + lane];
  int fr[NTA];
  int ship = 0, goal = 0;
  if (GOAL) {
#pragma unroll
    for (int i = 0; i < NT; ++i) fr[i] = ti_in[i * n + lane];
    ship = ti_in[NT * n + lane];
    goal = ti_in[(NT + 1) * n + lane];
  }
  const int steps = ti_in[(IR - 3) * n + lane];
  bool case_b = ti_in[(IR - 2) * n + lane] > 0;
  bool flip = ti_in[(IR - 1) * n + lane] > 0;

  // ---- physics ----
  float px[NP], py[NP], yf[6];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    px[i] = pl[2 * i];
    py[i] = pl[2 * i + 1];
  }
  const bool terminated = sg_physics<NP, TAB>(P.phys, y0, px, py, ae, at, yf);
  const int steps1 = steps + 1;
  const bool truncated = (steps1 >= P.max_episode_steps) && !terminated;
  const bool done = terminated || truncated;

  // ---- final obs (pre-resample goal) + reward ----
  float fobs[D];
  sg_observe<TASK, NP>(P, yf, pl, gx, gy, ref, fobs);
  bool reached;
  const float rew = sg_reward<TASK, NP>(P, y0, yf, pl, gx, gy, ref, ae, at, reached);

  URows U{u_in, n, lane, 0};
  // ---- Goal resample, where reached ----
  if constexpr (GOAL) {
    if (reached) sg_goal_place<NTA, CSR>(P, U, fr, ship, goal, case_b, flip, cs, gx, gy);
  }
  // ---- auto-reset, where done ----
  float y_out[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) y_out[c] = yf[c];
  if (done) {
    if constexpr (GOAL) {
      U.i = GP_ROWS;
      sg_goal_reset<NP, NTA, CSR>(P, U, y_out, pl, gx, gy, fr, ship, goal, case_b, flip, cs);
    } else {
      float oa = ref[0], ecc = ref[1];
      sg_orbit_reset(P, U, TASK == SG_TASK_KEPLER, y_out, oa, ecc);
      ref[0] = oa;
      ref[1] = ecc;
    }
  }
  const int steps_out = done ? 0 : steps1;

  // ---- write outputs ----
#pragma unroll
  for (int c = 0; c < 6; ++c) yo[c * n + lane] = y_out[c];
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) po[i * n + lane] = pl[i];
  go[lane] = gx;
  go[n + lane] = gy;
#pragma unroll
  for (int i = 0; i < 3; ++i) ro[i * n + lane] = ref[i];
#pragma unroll
  for (int i = 0; i < CSR; ++i) cso[i * n + lane] = cs[i];
  float obs[D];
  if (done) {
    sg_observe<TASK, NP>(P, y_out, pl, gx, gy, ref, obs);
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) obs[i] = fobs[i];
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    obs_out[i * n + lane] = obs[i];
    fobs_out[i * n + lane] = fobs[i];
  }
  rew_out[lane] = rew;
  if (GOAL) {
#pragma unroll
    for (int i = 0; i < NT; ++i) tio[i * n + lane] = fr[i];
    tio[NT * n + lane] = ship;
    tio[(NT + 1) * n + lane] = goal;
  }
  tio[(IR - 3) * n + lane] = steps_out;
  tio[(IR - 2) * n + lane] = GOAL ? (case_b ? 1 : 0) : 0;
  tio[(IR - 1) * n + lane] = GOAL ? (flip ? 1 : 0) : 0;
  flags[lane] = terminated ? 1 : 0;
  flags[n + lane] = truncated ? 1 : 0;
  flags[2 * n + lane] = done ? 1 : 0;
}

template <int TASK, int NP, int NT, int COLS, int TAB>
static int launch(const FullParams& P, const float* const* in, const int* ti, float* const* out,
                  int* tio, int* flags, int B, cudaStream_t s) {
  const int threads = 128;
  full_step_kernel<TASK, NP, NT, COLS, TAB><<<(B + threads - 1) / threads, threads, 0, s>>>(
      P, in[0], in[1], in[2], in[3], in[4], in[5], in[6], ti, out[0], out[1], out[2], out[3],
      out[4], out[5], out[6], out[7], tio, flags, B);
  return (int)cudaGetLastError();
}

template <int TASK, int NP, int NT, int COLS>
static int launch_tab(int tableau, const FullParams& P, const float* const* in, const int* ti,
                      float* const* out, int* tio, int* flags, int B, cudaStream_t s) {
  if (tableau == SG_TAB_DP5)
    return launch<TASK, NP, NT, COLS, SG_TAB_DP5>(P, in, ti, out, tio, flags, B, s);
  if (tableau == SG_TAB_BS3)
    return launch<TASK, NP, NT, COLS, SG_TAB_BS3>(P, in, ti, out, tio, flags, B, s);
  return SG_ERR_UNSUPPORTED;
}

// Returns 0 on a launched kernel, the cudaError_t of a refused launch, or
// SG_ERR_UNSUPPORTED for a configuration not instantiated here: Goal with
// 2/3/4 planets (4/9/16 tiles in 2/3/4 columns), Kepler and DoNotCrash with
// their planet + border.
extern "C" int sg_full_step(const FullParams* P, int task, int n_planets, int n_tiles, int cols,
                            int tableau, const float* y, const float* a, const float* p,
                            const float* g, const float* r, const float* cs, const float* u,
                            const int* ti, float* yo, float* po, float* go, float* ro, float* cso,
                            float* obs, float* fobs, float* rew, int* tio, int* flags, int B,
                            void* stream) {
  if (B <= 0) return SG_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  const float* in[7] = {y, a, p, g, r, cs, u};
  float* out[8] = {yo, po, go, ro, cso, obs, fobs, rew};
  if (task == SG_TASK_GOAL) {
    if (n_planets == 2 && n_tiles == 4 && cols == 2)
      return launch_tab<SG_TASK_GOAL, 2, 4, 2>(tableau, *P, in, ti, out, tio, flags, B, s);
    if (n_planets == 3 && n_tiles == 9 && cols == 3)
      return launch_tab<SG_TASK_GOAL, 3, 9, 3>(tableau, *P, in, ti, out, tio, flags, B, s);
    if (n_planets == 4 && n_tiles == 16 && cols == 4)
      return launch_tab<SG_TASK_GOAL, 4, 16, 4>(tableau, *P, in, ti, out, tio, flags, B, s);
  } else if (task == SG_TASK_KEPLER && n_planets == 2 && n_tiles == 0) {
    return launch_tab<SG_TASK_KEPLER, 2, 0, 0>(tableau, *P, in, ti, out, tio, flags, B, s);
  } else if (task == SG_TASK_DNC && n_planets == 2 && n_tiles == 0) {
    return launch_tab<SG_TASK_DNC, 2, 0, 0>(tableau, *P, in, ti, out, tio, flags, B, s);
  }
  return SG_ERR_UNSUPPORTED;
}
