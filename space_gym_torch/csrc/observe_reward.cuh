// Observation and per-task reward of one env step for one lane, in registers:
// the device code shared by the env-step kernel (csrc/env_step.cu) and the
// full-step kernel (csrc/full_step.cuh).  Same computation as the bodies of
// space_gym_tpu/ops/pallas_step.py::make_fused_env_step (:385-492) and
// pallas_full.py's observe / reward_fn; plain twins in
// space_gym_torch/ops/observe_reward.py.
#pragma once

#include "physics.cuh"

#define SG_TASK_GOAL 0
#define SG_TASK_KEPLER 1
#define SG_TASK_DNC 2

// Observation rows per task: ship state, lidars to planets and goal (Goal),
// the reference orbit (Kepler).
template <int TASK, int NP>
struct ObsDim {
  static constexpr int D =
      7 + (TASK == SG_TASK_GOAL ? 2 * NP + 2 : 0) + (TASK == SG_TASK_KEPLER ? 3 : 0);
};

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
