// Ship physics of one control step for one lane, in registers.
//
// The CUDA twin of space_gym_tpu/ops/pallas_step.py::_make_physics_body
// (shared there by the Pallas kernels of make_fused_step and make_full_step)
// and of the plain PyTorch body in space_gym_torch/ops/physics.py:
//   * velocity-steering override (omega := 5 * thruster);
//   * gravity + thrust right-hand side over NP planets;
//   * n_substeps Dormand-Prince 5(4) or Bogacki-Shampine 3(2) substeps + FSAL;
//   * NP+3 terminal events (planet surfaces, two border pairs, spin cap),
//     checked at each substep end;
//   * one joint refinement of the earliest crossing by safeguarded Illinois
//     false position on the dense interpolant, exactly the reference rule
//     (pallas_step.py:226-239), grazing-crossing stall included;
//   * state returned at the event time; angle wrapped into [0, 2pi) by the
//     caller (sg_wrap_angle).
//
// The phase clock's mark (csrc/step_clock.cuh) compiles to nothing without
// -DSG_PHASE_CLOCK.
//
// Design: one thread per lane, everything in registers, the planet count and
// the tableau as template parameters so every stage loop unrolls.  Operations
// follow the JAX body's order and are built without FMA contraction
// (-fmad=false, utils/cuda_build.py); the float results still differ from the
// plain twin by rounding (rsqrtf, sinf, cosf, logf are not bit-equal to
// PyTorch's), which the stated tolerances cover.  Two per-lane
// branches skip work whose result the JAX body computes and then discards:
// a lane that terminated in an earlier substep stops integrating (its state
// is frozen there), and a lane with no sign change skips the refinement.
// The step is two parts, sg_integrate (up to the substep whose events fire,
// and that substep's bracket) and sg_refine (the bracket to the state at the
// event; the caller wraps the angle); the env kernels K1, K2 and K3 refine in
// place or hand the bracket to another thread (csrc/env_lanes.cuh).  Either
// way the same operations on the same values give the same bits.
#pragma once

#include <math_constants.h>

#include "params.cuh"
#include "step_clock.cuh"

// Dormand-Prince 5(4) (rk45.py DP_A, DP_B, DP_P) and Bogacki-Shampine 3(2)
// (BS3_A, BS3_B, BS3_P); double literals rounded to float once, as JAX rounds
// a Python float constant.  Zero entries stay: the JAX body multiplies them.
__constant__ float kDP5_A[6][5] = {
    {0.f, 0.f, 0.f, 0.f, 0.f},
    {(float)(1.0 / 5), 0.f, 0.f, 0.f, 0.f},
    {(float)(3.0 / 40), (float)(9.0 / 40), 0.f, 0.f, 0.f},
    {(float)(44.0 / 45), (float)(-56.0 / 15), (float)(32.0 / 9), 0.f, 0.f},
    {(float)(19372.0 / 6561), (float)(-25360.0 / 2187), (float)(64448.0 / 6561),
     (float)(-212.0 / 729), 0.f},
    {(float)(9017.0 / 3168), (float)(-355.0 / 33), (float)(46732.0 / 5247),
     (float)(49.0 / 176), (float)(-5103.0 / 18656)},
};
__constant__ float kDP5_B[6] = {(float)(35.0 / 384), 0.f, (float)(500.0 / 1113),
                                (float)(125.0 / 192), (float)(-2187.0 / 6784),
                                (float)(11.0 / 84)};
__constant__ float kDP5_P[7][4] = {
    {1.f, (float)(-8048581381.0 / 2820520608.0), (float)(8663915743.0 / 2820520608.0),
     (float)(-12715105075.0 / 11282082432.0)},
    {0.f, 0.f, 0.f, 0.f},
    {0.f, (float)(131558114200.0 / 32700410799.0), (float)(-68118460800.0 / 10900136933.0),
     (float)(87487479700.0 / 32700410799.0)},
    {0.f, (float)(-1754552775.0 / 470086768.0), (float)(14199869525.0 / 1410260304.0),
     (float)(-10690763975.0 / 1880347072.0)},
    {0.f, (float)(127303824393.0 / 49829197408.0), (float)(-318862633887.0 / 49829197408.0),
     (float)(701980252875.0 / 199316789632.0)},
    {0.f, (float)(-282668133.0 / 205662961.0), (float)(2019193451.0 / 616988883.0),
     (float)(-1453857185.0 / 822651844.0)},
    {0.f, (float)(40617522.0 / 29380423.0), (float)(-110615467.0 / 29380423.0),
     (float)(69997945.0 / 29380423.0)},
};
__constant__ float kBS3_A[3][2] = {
    {0.f, 0.f},
    {(float)(1.0 / 2), 0.f},
    {0.f, (float)(3.0 / 4)},
};
__constant__ float kBS3_B[3] = {(float)(2.0 / 9), (float)(1.0 / 3), (float)(4.0 / 9)};
__constant__ float kBS3_P[4][3] = {
    {1.f, (float)(-4.0 / 3), (float)(5.0 / 9)},
    {0.f, 1.f, (float)(-2.0 / 3)},
    {0.f, (float)(4.0 / 3), (float)(-8.0 / 9)},
    {0.f, -1.f, 1.f},
};

#define SG_TAB_DP5 0
#define SG_TAB_BS3 1

template <int TAB>
struct Tab;

template <>
struct Tab<SG_TAB_DP5> {
  static constexpr int S = 6;    // stages (K has S + 1 entries with FSAL)
  static constexpr int NPW = 4;  // powers of the dense interpolant
  __device__ __forceinline__ static float A(int s, int j) { return kDP5_A[s][j]; }
  __device__ __forceinline__ static float B(int j) { return kDP5_B[j]; }
  __device__ __forceinline__ static float P(int j, int m) { return kDP5_P[j][m]; }
};

template <>
struct Tab<SG_TAB_BS3> {
  static constexpr int S = 3;
  static constexpr int NPW = 3;
  __device__ __forceinline__ static float A(int s, int j) { return kBS3_A[s][j]; }
  __device__ __forceinline__ static float B(int j) { return kBS3_B[j]; }
  __device__ __forceinline__ static float P(int j, int m) { return kBS3_P[j][m]; }
};

// jnp.minimum: NaN if either operand is NaN (fminf would drop the NaN).
__device__ __forceinline__ float sg_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? a + b : fminf(a, b);
}

// jnp.mod(x, 2pi): the result takes the divisor's sign.
__device__ __forceinline__ float sg_wrap_angle(float x) {
  float r = fmodf(x, SG_TWO_PI);
  return (r != 0.f && r < 0.f) ? r + SG_TWO_PI : r;
}

template <int NP>
__device__ __forceinline__ void sg_rhs(const PhysParams& P, const float* y, const float* px,
                                       const float* py, float ae, float at, float* f) {
  const float efs = ae * P.max_engine_force;
  // one argument reduction for both: the bits of cosf and sinf (every
  // --env-bits digest unchanged), in fewer instructions
  float sn, cs;
  sincosf(y[2], &sn, &cs);
  float fx = -cs * efs;
  float fy = -sn * efs;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float dx = px[i] - y[0];
    const float dy = py[i] - y[1];
    const float d2 = dx * dx + dy * dy;
    const float inv_d = rsqrtf(d2);
    const float s = P.gm[i] / d2 * inv_d;
    fx = fx + dx * s;
    fy = fy + dy * s;
  }
  f[0] = y[3];
  f[1] = y[4];
  f[2] = y[5];
  f[3] = fx / P.ship_mass;
  f[4] = fy / P.ship_mass;
  f[5] = P.steering == 0 ? at * P.aang_coef : 0.f;
}

template <int NP>
__device__ __forceinline__ void sg_events(const PhysParams& P, float x, float y, float w,
                                          const float* px, const float* py, float* g) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float dx = px[i] - x;
    const float dy = py[i] - y;
    g[i] = sqrtf(dx * dx + dy * dy) - P.radii[i];
  }
  g[NP] = sg_min(P.half - x, P.half - y);
  g[NP + 1] = sg_min(P.half + x, P.half + y);
  g[NP + 2] = P.max_abs_vel_angle - fabsf(w);
}

// Minimum over the active events of the sign-normalised event values;
// inactive events sit at +inf (pallas_step.py:199-204).
template <int NE>
__device__ __forceinline__ float sg_m_norm(const bool* active, const float* sgn, const float* ge) {
  float mm = 0.f;
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    const float v = active[e] ? sgn[e] * ge[e] : CUDART_INF_F;
    mm = e == 0 ? v : sg_min(mm, v);
  }
  return mm;
}

// What the refinement needs to finish a lane whose events changed sign in a
// substep (sg_refine): the substep's dense-output coefficients and start
// state, the sign-normalised event minimum at its two ends, and in `bits`
// the active events (bits 0-7), the events negative at its start (8-15) and
// the substep's index (16 on).  Kept in registers, or saved to a list and
// finished by another thread (the env kernels, csrc/env_lanes.cuh).
template <int TAB>
struct SgBracket {
  static constexpr int NPW = Tab<TAB>::NPW;
  float Q[6][NPW];
  float comp[6];
  float f_lo, f_hi;
  unsigned bits;
};

// Integrates one control step up to its first substep whose events change
// sign.  y0: the lane's state.  Returns false with yf the state at the step's
// end, or true with `br` the bracket of that substep (for sg_refine to
// finish into yf).
template <int NP, int TAB>
__device__ __forceinline__ bool sg_integrate(const PhysParams& P, const float* y0, const float* px,
                                             const float* py, float ae, float at, float* yf,
                                             SgBracket<TAB>& br) {
  using T = Tab<TAB>;
  constexpr int NE = NP + 3;
  constexpr int S = T::S;
  constexpr int NPW = T::NPW;
  const float h = P.h;

  float comp[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) comp[c] = y0[c];
  if (P.steering == 1) comp[5] = P.vel_steer_scale * at;

  float K[S + 1][6];
  sg_rhs<NP>(P, comp, px, py, ae, at, K[0]);
  float g[NE];
  sg_events<NP>(P, comp[0], comp[1], comp[5], px, py, g);
#pragma unroll
  for (int c = 0; c < 6; ++c) yf[c] = comp[c] + 0.f;

  for (int sub = 0; sub < P.n_substeps; ++sub) {
#pragma unroll
    for (int s = 1; s < S; ++s) {
      float ys[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        float dy = K[0][c] * T::A(s, 0);
#pragma unroll
        for (int j = 1; j < s; ++j) dy = dy + K[j][c] * T::A(s, j);
        ys[c] = comp[c] + dy * h;
      }
      sg_rhs<NP>(P, ys, px, py, ae, at, K[s]);
    }
    float y_new[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float inc = K[0][c] * T::B(0);
#pragma unroll
      for (int j = 1; j < S; ++j) inc = inc + K[j][c] * T::B(j);
      y_new[c] = comp[c] + h * inc;
    }
    sg_rhs<NP>(P, y_new, px, py, ae, at, K[S]);

    float g_new[NE];
    sg_events<NP>(P, y_new[0], y_new[1], y_new[5], px, py, g_new);
    bool active[NE];
    bool fire = false;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const bool up = (g[e] <= 0.f) && (g_new[e] >= 0.f);
      const bool down = (g[e] >= 0.f) && (g_new[e] <= 0.f);
      active[e] = up || down;
      fire = fire || active[e];
    }

    SG_K3_MARK(K3_SUBSTEPS);
    if (fire) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
#pragma unroll
        for (int m = 0; m < NPW; ++m) {
          float acc = K[0][c] * T::P(0, m);
#pragma unroll
          for (int j = 1; j <= S; ++j) acc = acc + K[j][c] * T::P(j, m);
          br.Q[c][m] = acc;
        }
        br.comp[c] = comp[c];
      }
      float sgn[NE];
      unsigned bits = (unsigned)sub << 16;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        sgn[e] = g[e] < 0.f ? -1.f : 1.f;
        bits |= (active[e] ? 1u << e : 0u) | (g[e] < 0.f ? 1u << (8 + e) : 0u);
      }
      br.f_lo = sg_m_norm<NE>(active, sgn, g);
      br.f_hi = sg_m_norm<NE>(active, sgn, g_new);
      br.bits = bits;
      return true;
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      yf[c] = y_new[c];
      comp[c] = y_new[c];
      K[0][c] = K[S][c];  // FSAL
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) g[e] = g_new[e];
  }
  return false;
}

// Finishes a lane from its bracket: one joint refinement of the earliest
// crossing by safeguarded Illinois false position on the dense interpolant,
// then the state there (angle not yet wrapped) into yf.
template <int NP, int TAB>
__device__ __forceinline__ void sg_refine(const PhysParams& P, const SgBracket<TAB>& br,
                                          const float* px, const float* py, float* yf) {
  constexpr int NE = NP + 3;
  constexpr int NPW = Tab<TAB>::NPW;
  const float h = P.h;
  bool active[NE];
  float sgn[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    active[e] = (br.bits >> e) & 1u;
    sgn[e] = (br.bits >> (8 + e)) & 1u ? -1.f : 1.f;
  }
  const int sub = (int)(br.bits >> 16);
  const float t0 = P.t0[sub];
  float lo = t0;
  float hi = P.t1[sub];
  float f_lo = br.f_lo;
  float f_hi = br.f_hi;
  float side = 0.f;  // +1: hi moved last, -1: lo moved last
  for (int it = 0; it < P.refine_iters; ++it) {
    const float mid_fp = hi - f_hi * (hi - lo) / (f_hi - f_lo);
    const bool good = isfinite(mid_fp) && (mid_fp > lo) && (mid_fp < hi);
    const float mid = good ? mid_fp : 0.5f * (lo + hi);
    // dense output at mid, only the components the events read
    const float xq = (mid - t0) / h;
    float pw[NPW];
    pw[0] = xq;
#pragma unroll
    for (int m = 1; m < NPW; ++m) pw[m] = pw[m - 1] * xq;
    float sv[3];
    const int cs[3] = {0, 1, 5};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = br.Q[cs[k]][0] * pw[0];
#pragma unroll
      for (int m = 1; m < NPW; ++m) acc = acc + br.Q[cs[k]][m] * pw[m];
      sv[k] = h * acc + br.comp[cs[k]];
    }
    float gm[NE];
    sg_events<NP>(P, sv[0], sv[1], sv[2], px, py, gm);
    const float g_mid = sg_m_norm<NE>(active, sgn, gm);
    const bool left = g_mid <= 0.f;  // root in [lo, mid]
    f_lo = left ? (side > 0.f ? 0.5f * f_lo : f_lo) : g_mid;
    f_hi = left ? g_mid : (side < 0.f ? 0.5f * f_hi : f_hi);
    lo = left ? lo : mid;
    hi = left ? mid : hi;
    side = left ? 1.f : -1.f;
  }
  const float xq = (hi - t0) / h;
  float pw[NPW];
  pw[0] = xq;
#pragma unroll
  for (int m = 1; m < NPW; ++m) pw[m] = pw[m - 1] * xq;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float acc = br.Q[c][0] * pw[0];
#pragma unroll
    for (int m = 1; m < NPW; ++m) acc = acc + br.Q[c][m] * pw[m];
    yf[c] = h * acc + br.comp[c];
  }
}
