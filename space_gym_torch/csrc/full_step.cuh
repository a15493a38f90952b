// Kernel K3 and its two in-kernel-random variants: the whole env step, for
// every lane, in one launch.  Included by full_step.cu (uniforms from memory),
// full_step_threefry.cu and full_step_philox.cu, one translation unit per
// source of uniforms so that the three build side by side; and, for the CPU,
// by host/full_step_host.cpp against the stand-in headers of host/.
//
// Replaces the Pallas TPU kernel space_gym_tpu/ops/pallas_full.py::
// make_full_step.<locals>.kernel (pallas_full.py:500, pallas_call at :663) in
// its three modes: in_kernel_rng=False (MemRows), "threefry" (ThreefryRows,
// pallas_full.py:529-536) and "hw" (PhiloxRows, pallas_full.py:518-528); see
// csrc/rng.cuh.  Per lane:
// physics (csrc/physics.cuh), the final observation, the per-task reward
// (csrc/observe_reward.cuh), the Goal resample through the hex tiling where
// the goal is reached, TimeLimit, and the masked auto-reset for
// Goal/Kepler/DoNotCrash with the post-reset observation.  Plain twin:
// space_gym_torch/ops/full_step_plain.py.
//
// Operands: inputs y 6, p 2P, g 2, ref 3, cs max(cols,1), u (float32 (n_u,
// B), or the two uint32 key words), ti int_rows (int32), component-major
// (rows, B), and the action a, lane-major (B, 2) float32: the policy's raw
// action for a continuous config, which the kernel translates
// (spaceship_env.py:189-214, `sg_action`), the looked-up table rows for a
// discrete one (FullParams::continuous); outputs, component-major, y' 6, p'
// 2P, g' 2, ref' 3, cs' max(cols,1), obs D, final obs D, reward 1 (float32),
// ti' int_rows (int32), flags 3 = (terminated, truncated, done) (bytes of 0
// or 1: torch.bool).  So the action comes in, and the flags go out, in the
// layouts the engine's callers hold and read, with no conversion between.
//
// Uniforms: every row has a fixed index in exactly the
// JAX kernel's consumption order: the Goal resample's rows first, then the
// reset's (pallas_full.py:550-599).  So the same u, or the same key, gives the
// same resets, lane for lane, and a lane that does not
// reach its goal skips the resample and a lane that is not done skips the
// reset: their results would be discarded by the JAX kernel's selects.  With
// a generator the skipped rows are never computed.  A done lane skips the
// resample too: the reset overwrites everything the resample writes, and
// takes its rows from GP_ROWS on either way.
//
// What bounds it on an H100: bytes.  It moves 4 bytes a row in and out and 1
// a flag per lane (527 B for GoalContinuous2P-v0 by the operand list, 327 B
// without the u rows, less where lanes skip their uniform rows) against a
// few hundred float operations per lane, which at the card's f32 rate take a
// tenth of the memory time (chip_smoke.py prints both).  But each lane's operations form
// one long dependent chain (physics, observation, reward) and the rare
// branches (resample, reset and its second observation) are long too, so
// latency, residency and divergence set its time (the phase clock,
// csrc/step_clock.cuh, splits it; PERF.md).  Design:
//   * persistent blocks of SG_TILE threads, one thread a lane of a tile of
//     SG_TILE lanes: as many blocks as the card holds at once (the
//     occupancy query), each walking an equal share of the tiles;
//     `__launch_bounds__` asks for a residency at which ptxas spills
//     nothing, or next to nothing (K3MinBlocks);
//   * each thread loads its lane's input rows into its own column of a
//     shared-memory stage, which keeps them out of its registers through
//     physics (no spills at that residency); the warps of a block need no
//     barrier between tiles.  Bulk copies of whole rows into a double-buffered
//     stage were no faster (PERF.md);
//   * the rare branches compacted across the block: a lane that must reset
//     or resample writes the outputs of the common path only and joins a
//     list in shared memory (ballot, one atomic a warp and list); at the
//     block's end its threads work through the lists together, reading what
//     they need from the operands in memory.  A lane's uniforms are a
//     function of (key or u, lane, row) only, so which thread runs a lane
//     does not change a bit;
//   * the event refinement deferred as in K1 and K2 (csrc/env_lanes.cuh):
//     about 1.4% of lanes fire on the main path's state, in a third of the
//     warps, and such a warp spent as long in refine_iters serial Illinois
//     iterations, one lane in 32 active, as in its substeps (16.4% of K3's
//     warp-cycles at DP5 x 2 / refine 12, PERF.md §5).  A lane whose events
//     fire saves its bracket to the block's list and writes nothing
//     else; since it terminates it is done and joins the list of done lanes.
//     At the block's end the block's threads finish the deferred lanes, from
//     the last thread down, one lane a thread: its rows staged again into
//     the thread's column, the refinement, the rest of the common path.
//     Its reset, which writes the other outputs, runs from the list of done
//     lanes, from thread 0 up, so that the two long chains run side by side
//     on different warps: run one after the other in one thread they made
//     the block's tail the kernel's critical path (PERF.md §6).  A lane that
//     finds the list full refines in place.  Every output bit is the same
//     either way: the bracket holds every value the refinement reads.  The
//     finish stays on the block's critical path, its tail: on an H100 at
//     DP5 x 2 / refine 12, the engine's default, the kernel takes 17% less
//     time, at BS3 x 1 / refine 8, whose memory stalls hid the in-place
//     refinement, 7% more (PERF.md §6);
//   * stores are streaming (evict-first), each row of a tile one coalesced
//     span; the uniform rows are read where a lane takes them.
// The source of uniforms, the planet count, tile count, column count, task
// and tableau are template parameters, so the loops unroll and the per-lane
// arrays stay in registers (printed by -Xptxas -v at build time).
#pragma once

#include <cuda_runtime.h>

#include "env_lanes.cuh"
#include "launch_info.cuh"
#include "observe_reward.cuh"
#include "rng.cuh"

#define SG_DUP 3  // free-entry duplicate cap = MAX_GOAL_CANDIDATES

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
template <class ROWS>
__device__ __forceinline__ void sg_disk_noise(ROWS& U, float radius, float& nx, float& ny) {
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
template <int NT, int COLS, class ROWS>
__device__ void sg_goal_place(const FullParams& P, ROWS& U, int* fr, int& ship, int& goal,
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
template <int NP, int NT, int COLS, class ROWS>
__device__ void sg_goal_reset(const FullParams& P, ROWS& U, float* y, float* pl, float& gx,
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
template <class ROWS>
__device__ void sg_orbit_reset(const FullParams& P, ROWS& U, bool kepler, float* y, float& oa,
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

// ------------------------------------------------------------ the kernel --
#define SG_TILE 128  // lanes a tile = threads a block

// Row layout of one env's operands: the input rows a lane stages (y, its
// translated action, p, g, ref, cs, ti; the u rows are read where they are
// taken) and the row counts; the block's shared memory.
template <int TASK, int NP, int NT, int COLS>
struct StepShape {
  static constexpr bool GOAL = TASK == SG_TASK_GOAL;
  static constexpr int NTA = NT > 0 ? NT : 1;  // array extents
  static constexpr int CSR = COLS > 0 ? COLS : 1;
  static constexpr int IR = GOAL ? NT + 5 : 3;
  static constexpr int D = ObsDim<TASK, NP>::D;
  static constexpr int GP_ROWS = 1 + NT * SG_DUP + 2;  // rows of one goal placement
  static constexpr int R_Y = 0, R_A = 6, R_P = 8, R_G = R_P + 2 * NP, R_REF = R_G + 2,
                       R_CS = R_REF + 3, R_TI = R_CS + CSR, ROWS = R_TI + IR;
  static constexpr int LIST = 3 * SG_TILE;  // entries of each rare-lane list
  // dynamic shared memory after the block's list of deferred lanes
  // (SgList<TAB>::SMEM bytes): two list counts, two lists, the stage
  static constexpr int SMEM = 2 * 4 + 2 * LIST * 4 + ROWS * SG_TILE * 4;
};

// The operands of one launch, in the kernel's order.
struct FullStepArgs {
  const float *y, *a, *p, *g, *r, *cs;  // a: (B, 2), 8-byte aligned
  const void* u;  // (n_u, B) float32 uniforms, or two uint32 key words
  int n_u;
  const int* ti;
  float *yo, *po, *go, *ro, *cso, *obs, *fobs, *rew;
  int* tio;
  unsigned char* flags;
  int B;
  cudaStream_t stream;
  int lane0;  // global index of lane 0 for the in-kernel generators (rng.cuh)
};

// The kernel's one parameter.
struct K3Args {
  FullParams P;
  FullStepArgs A;
  int tiles;  // ceil(B / SG_TILE)
};

// torch.clamp(x, -1, 1): a NaN passes as it is.
__device__ __forceinline__ float sg_clamp_unit(float x) {
  return x != x ? x : fminf(fmaxf(x, -1.f), 1.f);
}

// f(input row, row pointer) for every component-major input row a lane
// loads; the action is not one (`sg_action`).
template <class S, class F>
__device__ __forceinline__ void sg_each_input_row(const FullStepArgs& A, size_t n, F f) {
#pragma unroll
  for (int c = 0; c < 6; ++c) f(S::R_Y + c, A.y + c * n);
#pragma unroll
  for (int c = 0; c < S::R_G - S::R_P; ++c) f(S::R_P + c, A.p + c * n);
#pragma unroll
  for (int c = 0; c < 2; ++c) f(S::R_G + c, A.g + c * n);
#pragma unroll
  for (int c = 0; c < 3; ++c) f(S::R_REF + c, A.r + c * n);
#pragma unroll
  for (int c = 0; c < S::CSR; ++c) f(S::R_CS + c, A.cs + c * n);
#pragma unroll
  for (int c = 0; c < S::IR; ++c) f(S::R_TI + c, (const float*)(A.ti + c * n));
}

// A lane's action as the physics takes it, (thrust, turn), from its float2 of
// the (B, 2) operand.  A continuous config's raw action is translated as
// EnvEngine._translate_action does it, in the same float32 operations
// (spaceship_env.py:189-214): clamped to [-1, 1], thrust (a0 + 1) / 2, turn
// a1; a discrete config's rows are the table's, passed as they are.
__device__ __forceinline__ void sg_action(const FullParams& P, const float* a, int lane,
                                          float& thrust, float& turn) {
  const float2 v = reinterpret_cast<const float2*>(a)[lane];
  if (P.continuous) {
    thrust = (sg_clamp_unit(v.x) + 1.f) / 2.f;
    turn = sg_clamp_unit(v.y);
  } else {
    thrust = v.x;
    turn = v.y;
  }
}

// Loads one lane's input rows into its column `in` of the stage (row r at
// in[r * SG_TILE]; the int rows hold their bits), the action translated.
template <class S>
__device__ __forceinline__ void sg_stage_lane(const FullParams& P, const FullStepArgs& A, size_t n,
                                              int lane, float* in) {
  sg_each_input_row<S>(A, n, [&](int r, const float* row) { in[r * SG_TILE] = row[lane]; });
  sg_action(P, A.a, lane, in[S::R_A * SG_TILE], in[(S::R_A + 1) * SG_TILE]);
}

// The physics of one lane from its staged input rows `in`, up to its first
// substep whose events fire (sg_integrate): false with yf the state at the
// step's end, or true with `br` the bracket of that substep.
template <int TASK, int NP, int NT, int COLS, int TAB>
__device__ __forceinline__ bool sg_step_integrate(const FullParams& P, const float* in, float* yf,
                                                  SgBracket<TAB>& br) {
  using S = StepShape<TASK, NP, NT, COLS>;
  float y0[6], px[NP], py[NP];
#pragma unroll
  for (int c = 0; c < 6; ++c) y0[c] = in[(S::R_Y + c) * SG_TILE];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    px[i] = in[(S::R_P + 2 * i) * SG_TILE];
    py[i] = in[(S::R_P + 2 * i + 1) * SG_TILE];
  }
  return sg_integrate<NP, TAB>(P.phys, y0, px, py, in[S::R_A * SG_TILE],
                               in[(S::R_A + 1) * SG_TILE], yf, br);
}

// The rest of the common path of one lane, from its staged input rows `in`
// and sg_step_integrate's result (`terminated`: its events fired, `br` their
// bracket, else `yf` the step's end): the refinement, final observation,
// reward, flags; writes every output of a lane that neither resets nor
// resamples, and of the others what the rare path leaves (flags, reward,
// final observation, the step count; a lane that reached its goal without
// being done also its state, planets, ref, cs, observation and case/flip
// rows).  Returns 1 where the lane is done, 2 where it reached its goal and
// is not done, else 0.  `deferred`: run from the block's list at its end,
// which the phase clock counts apart.
template <int TASK, int NP, int NT, int COLS, int TAB>
__device__ __forceinline__ int sg_step_common(const FullParams& P, const FullStepArgs& A,
                                              const float* in, int lane, size_t n,
                                              bool terminated, const SgBracket<TAB>& br,
                                              float* yf, bool deferred) {
  using S = StepShape<TASK, NP, NT, COLS>;
  constexpr int T = SG_TILE;
  auto ti = [&](int i) { return __float_as_int(in[(S::R_TI + i) * T]); };
  float y0[6], pl[2 * NP], ref[3];
#pragma unroll
  for (int c = 0; c < 6; ++c) y0[c] = in[(S::R_Y + c) * T];
  const float ae = in[S::R_A * T], at = in[(S::R_A + 1) * T];
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) pl[i] = in[(S::R_P + i) * T];
  const float gx = in[S::R_G * T], gy = in[(S::R_G + 1) * T];
#pragma unroll
  for (int i = 0; i < 3; ++i) ref[i] = in[(S::R_REF + i) * T];
  const int steps = ti(S::IR - 3);

  // ---- physics: the refinement where the events fired ----
  if (terminated) {
    float px[NP], py[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      px[i] = pl[2 * i];
      py[i] = pl[2 * i + 1];
    }
    sg_refine<NP, TAB>(P.phys, br, px, py, yf);
  }
  SG_K3_MARK(deferred ? K3_DEFER : K3_REFINE);
  yf[2] = sg_wrap_angle(yf[2]);
  const int steps1 = steps + 1;
  const bool truncated = (steps1 >= P.max_episode_steps) && !terminated;
  const bool done = terminated || truncated;

  // ---- final obs (pre-resample goal) + reward ----
  float fobs[S::D];
  sg_observe<TASK, NP>(P, yf, pl, gx, gy, ref, fobs);
  bool reached;
  const float rew = sg_reward<TASK, NP>(P, y0, yf, pl, gx, gy, ref, ae, at, reached);
  reached = S::GOAL && reached;
  SG_K3_MARK(deferred ? K3_DEFER : K3_OBSERVE);

  // ---- the common outputs ----
#pragma unroll
  for (int i = 0; i < S::D; ++i) __stcs(A.fobs + i * n + lane, fobs[i]);
  __stcs(A.rew + lane, rew);
  __stcs(A.flags + lane, (unsigned char)terminated);
  __stcs(A.flags + n + lane, (unsigned char)truncated);
  __stcs(A.flags + 2 * n + lane, (unsigned char)done);
  __stcs(A.tio + (S::IR - 3) * n + lane, done ? 0 : steps1);
  if (!done) {
#pragma unroll
    for (int c = 0; c < 6; ++c) __stcs(A.yo + c * n + lane, yf[c]);
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) __stcs(A.po + i * n + lane, pl[i]);
#pragma unroll
    for (int i = 0; i < 3; ++i) __stcs(A.ro + i * n + lane, ref[i]);
#pragma unroll
    for (int i = 0; i < S::CSR; ++i) __stcs(A.cso + i * n + lane, in[(S::R_CS + i) * T]);
#pragma unroll
    for (int i = 0; i < S::D; ++i) __stcs(A.obs + i * n + lane, fobs[i]);
    __stcs(A.tio + (S::IR - 2) * n + lane, S::GOAL ? (ti(S::IR - 2) > 0 ? 1 : 0) : 0);
    __stcs(A.tio + (S::IR - 1) * n + lane, S::GOAL ? (ti(S::IR - 1) > 0 ? 1 : 0) : 0);
    if (!reached) {
      __stcs(A.go + lane, gx);
      __stcs(A.go + n + lane, gy);
      if (S::GOAL) {
#pragma unroll
        for (int i = 0; i < NT + 2; ++i) __stcs(A.tio + i * n + lane, ti(i));
      }
    }
  }
  SG_K3_MARK(deferred ? K3_DEFER : K3_STORES);
  return done ? 1 : (reached ? 2 : 0);
}

// The auto-reset of a done lane, with its second observation: writes its
// state, planets, goal, ref, cs, observation and tiling rows but the step
// count.  Reads the rows it passes through from the operands in memory.
template <class ROWS, int TASK, int NP, int NT, int COLS>
__device__ void sg_step_reset(const FullParams& P, const FullStepArgs& A, int lane, size_t n) {
  using S = StepShape<TASK, NP, NT, COLS>;
  float y_out[6], pl[2 * NP], ref[3], cs[S::CSR], gx, gy;
  int fr[S::NTA], ship = 0, goal = 0;
  bool case_b = false, flip = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) ref[i] = A.r[i * n + lane];
  ROWS U(A.u, n, lane, A.n_u, A.lane0);
  if constexpr (S::GOAL) {
    U.i = S::GP_ROWS;
    sg_goal_reset<NP, S::NTA, S::CSR>(P, U, y_out, pl, gx, gy, fr, ship, goal, case_b, flip, cs);
  } else {
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) pl[i] = A.p[i * n + lane];
#pragma unroll
    for (int i = 0; i < S::CSR; ++i) cs[i] = A.cs[i * n + lane];
    gx = A.g[lane];
    gy = A.g[n + lane];
    float oa = ref[0], ecc = ref[1];
    sg_orbit_reset(P, U, TASK == SG_TASK_KEPLER, y_out, oa, ecc);
    ref[0] = oa;
    ref[1] = ecc;
  }
  float obs[S::D];
  sg_observe<TASK, NP>(P, y_out, pl, gx, gy, ref, obs);
#pragma unroll
  for (int c = 0; c < 6; ++c) __stcs(A.yo + c * n + lane, y_out[c]);
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) __stcs(A.po + i * n + lane, pl[i]);
  __stcs(A.go + lane, gx);
  __stcs(A.go + n + lane, gy);
#pragma unroll
  for (int i = 0; i < 3; ++i) __stcs(A.ro + i * n + lane, ref[i]);
#pragma unroll
  for (int i = 0; i < S::CSR; ++i) __stcs(A.cso + i * n + lane, cs[i]);
#pragma unroll
  for (int i = 0; i < S::D; ++i) __stcs(A.obs + i * n + lane, obs[i]);
  if constexpr (S::GOAL) {
#pragma unroll
    for (int i = 0; i < NT; ++i) __stcs(A.tio + i * n + lane, fr[i]);
    __stcs(A.tio + NT * n + lane, ship);
    __stcs(A.tio + (NT + 1) * n + lane, goal);
  }
  __stcs(A.tio + (S::IR - 2) * n + lane, S::GOAL ? (case_b ? 1 : 0) : 0);
  __stcs(A.tio + (S::IR - 1) * n + lane, S::GOAL ? (flip ? 1 : 0) : 0);
}

// The Goal resample of a lane that reached its goal and is not done: writes
// its goal and its free-tile, ship-tile and goal-tile rows.
template <class ROWS, int TASK, int NP, int NT, int COLS>
__device__ void sg_step_resample(const FullParams& P, const FullStepArgs& A, int lane, size_t n) {
  using S = StepShape<TASK, NP, NT, COLS>;
  if constexpr (S::GOAL) {
    int fr[NT];
    float cs[S::CSR], gx, gy;
#pragma unroll
    for (int i = 0; i < NT; ++i) fr[i] = A.ti[i * n + lane];
    int ship = A.ti[NT * n + lane], goal = A.ti[(NT + 1) * n + lane];
    const bool case_b = A.ti[(S::IR - 2) * n + lane] > 0;
    const bool flip = A.ti[(S::IR - 1) * n + lane] > 0;
#pragma unroll
    for (int i = 0; i < S::CSR; ++i) cs[i] = A.cs[i * n + lane];
    ROWS U(A.u, n, lane, A.n_u, A.lane0);
    sg_goal_place<NT, S::CSR>(P, U, fr, ship, goal, case_b, flip, cs, gx, gy);
    __stcs(A.go + lane, gx);
    __stcs(A.go + n + lane, gy);
#pragma unroll
    for (int i = 0; i < NT; ++i) __stcs(A.tio + i * n + lane, fr[i]);
    __stcs(A.tio + NT * n + lane, ship);
    __stcs(A.tio + (NT + 1) * n + lane, goal);
  }
}

// Residency per SM that `__launch_bounds__` asks of ptxas, per instantiation:
// the most blocks at which its registers hold the body without spills, and
// no more than the main path's grid fills (B=262144: 512 blocks of four
// tiles, 3.9 an SM of 132).  On an H100, DP5 at 2 planets took 20% less time
// at 4 blocks and 127 registers than at 3 and 138; BS3 at 2 planets 1-2% less
// at 4 blocks and 98-100 registers than at 5 and 92-95; at 6 blocks, 80
// registers, every instantiation spilled and lost time (PERF.md).
template <int TASK, int NP, int TAB>
struct K3MinBlocks {
  static constexpr int value = (NP <= 2 || TAB == SG_TAB_BS3) ? 4 : 3;
};

template <class ROWS, int TASK, int NP, int NT, int COLS, int TAB>
__global__ void __launch_bounds__(SG_TILE, (K3MinBlocks<TASK, NP, TAB>::value))
    full_step_kernel(const K3Args args) {
  using S = StepShape<TASK, NP, NT, COLS>;
  constexpr int T = SG_TILE;
  const FullParams& P = args.P;
  const FullStepArgs& A = args.A;
  const size_t n = (size_t)A.B;
  const int tid = threadIdx.x, wl = tid % 32, G = gridDim.x;

#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char sg_smem[];
#else
  unsigned char* sg_smem = reinterpret_cast<unsigned char*>(host_shared_memory());
#endif
  // after the list of deferred lanes (sg_block_list):
  int* count = reinterpret_cast<int*>(sg_smem + SgList<TAB>::SMEM);  // [2]: lanes in each list
  int* list = count + 2;  // [2][S::LIST]: done lanes, reached lanes
  // [S::ROWS][T]: the input rows of the tile, each thread's own column only,
  // which holds them out of its registers through physics
  float* stage = reinterpret_cast<float*>(list + 2 * S::LIST);

  // The rare branch of one lane, where a thread takes it.
  auto rare = [&](int kind, int l) {
    if (kind == 1) {
      sg_step_reset<ROWS, TASK, NP, NT, COLS>(P, A, l, n);
      SG_K3_MARK(K3_RESET);
    } else if (kind == 2) {
      sg_step_resample<ROWS, TASK, NP, NT, COLS>(P, A, l, n);
      SG_K3_MARK(K3_RESAMPLE);
    }
  };

  if (tid == 0) count[0] = count[1] = 0;
  const SgList<TAB> L = sg_block_list<TAB>();  // a barrier
  SG_K3_CLOCK_START();
  for (int t = blockIdx.x; t < args.tiles; t += G) {
    const int lane = t * T + tid;
    const bool live = (size_t)lane < n;
    float yf[6];
    SgBracket<TAB> br;
    bool fire = false;
    if (live) {
      sg_stage_lane<S>(P, A, n, lane, stage + tid);
      SG_K3_MARK(K3_WAIT);
      fire = sg_step_integrate<TASK, NP, NT, COLS, TAB>(P, stage + tid, yf, br);
    }
    // A lane whose events fire hands its bracket to the list, and is
    // finished at the block's end; one that finds the list full goes on here.
    const bool deferred = sg_defer<TAB>(L, fire, br, lane);
    SG_K3_COUNT_FIRE(live, fire, deferred);
    SG_K3_MARK(K3_SYNC);
    // A deferred lane is done: it joins the list of done lanes.
    int kind = deferred ? 1 : 0;
    if (live && !deferred)
      kind = sg_step_common<TASK, NP, NT, COLS, TAB>(P, A, stage + tid, lane, n, fire, br, yf,
                                                     false);
    SG_K3_COUNT(live, kind == 2, kind == 1);

    // Join the rare-lane lists (one atomic a warp and list); a lane that
    // finds its list full takes its branch here.
    const unsigned wd = __ballot_sync(0xFFFFFFFFu, kind == 1);
    const unsigned wr = __ballot_sync(0xFFFFFFFFu, kind == 2);
    int bd = 0, bq = 0;
    if (wl == 0) {
      if (wd) bd = atomicAdd(&count[0], __popc(wd));
      if (wr) bq = atomicAdd(&count[1], __popc(wr));
    }
    bd = __shfl_sync(0xFFFFFFFFu, bd, 0);
    bq = __shfl_sync(0xFFFFFFFFu, bq, 0);
    const unsigned below = (1u << wl) - 1u;
    const int pos = kind == 1 ? bd + __popc(wd & below) : bq + __popc(wr & below);
    if (kind != 0 && pos < S::LIST) {
      list[(kind - 1) * S::LIST + pos] = lane;
      kind = 0;
    }
    SG_K3_MARK(K3_SYNC);
    rare(kind, lane);
  }

  // The block's end, one lane a thread: the deferred lanes from the last
  // thread down (their rows staged again, the rest of the common path from
  // the bracket), beside the resets, then the resamples, from thread 0 up.
  // A deferred lane's reset is its entry in the list of done lanes: it
  // writes other outputs than the finish and reads only the operands, so
  // the two run side by side, on other warps where the lists are short.
  __syncthreads();
  const int nq = sg_list_size(L), nd = min(count[0], S::LIST), nr = min(count[1], S::LIST);
  SG_K3_MARK(K3_SYNC);
  for (int s = T - 1 - tid; s < nq; s += T) {
    const int l = sg_list_lane(L, s);
    sg_stage_lane<S>(P, A, n, l, stage + tid);
    SgBracket<TAB> b;  // taken after the staging, which holds many loads in flight
    sg_list_take(L, s, b);
    float yq[6];
    sg_step_common<TASK, NP, NT, COLS, TAB>(P, A, stage + tid, l, n, true, b, yq, true);
  }
  for (int i = tid; i < nd + nr; i += T)
    rare(i < nd ? 1 : 2, i < nd ? list[i] : list[S::LIST + i - nd]);
  SG_K3_CLOCK_END();
}

// Launches one instantiation on a persistent grid (the blocks the current
// device holds at once, each with an equal share of the tiles), or with
// `info` fills sg_kernel_info's numbers instead.  The blocks an SM holds are queried once
// per device.
template <class ROWS, int TASK, int NP, int NT, int COLS, int TAB>
static int launch(const FullParams& P, const FullStepArgs& A, int* info) {
  using S = StepShape<TASK, NP, NT, COLS>;
  auto k = full_step_kernel<ROWS, TASK, NP, NT, COLS, TAB>;
  static int known_dev = -1, per_sm = 0;
  int resident = 0;
  constexpr int smem = SgList<TAB>::SMEM + S::SMEM;
  const int e = sg_resident_blocks(k, SG_TILE, smem, known_dev, per_sm, &resident);
  if (e) return e;
  K3Args args{P, A, (A.B + SG_TILE - 1) / SG_TILE};
  const int per_block = (args.tiles + resident - 1) / resident;
  const int grid = (args.tiles + per_block - 1) / per_block;
  if (info) return sg_kernel_info(k, grid, SG_TILE, smem, args.tiles, info);
  return sg_launch(k, grid, SG_TILE, smem, A.stream, args);
}

template <class ROWS, int TASK, int NP, int NT, int COLS>
static int launch_tab(int tableau, const FullParams& P, const FullStepArgs& A, int* info) {
  if (tableau == SG_TAB_DP5) return launch<ROWS, TASK, NP, NT, COLS, SG_TAB_DP5>(P, A, info);
  if (tableau == SG_TAB_BS3) return launch<ROWS, TASK, NP, NT, COLS, SG_TAB_BS3>(P, A, info);
  return SG_ERR_UNSUPPORTED;
}

// Returns 0 on a launched kernel, the cudaError_t of a refused launch, or
// SG_ERR_UNSUPPORTED for a configuration not instantiated here: Goal with
// 2/3/4 planets (4/9/16 tiles in 2/3/4 columns), Kepler and DoNotCrash with
// their planet + border.
template <class ROWS>
static int sg_full_step_impl(const FullParams& P, int task, int n_planets, int n_tiles, int cols,
                             int tableau, const FullStepArgs& A, int* info = nullptr) {
  if (A.B <= 0 || A.n_u <= 0 || A.lane0 < 0) return SG_ERR_UNSUPPORTED;
  if (task == SG_TASK_GOAL) {
    if (n_planets == 2 && n_tiles == 4 && cols == 2)
      return launch_tab<ROWS, SG_TASK_GOAL, 2, 4, 2>(tableau, P, A, info);
    if (n_planets == 3 && n_tiles == 9 && cols == 3)
      return launch_tab<ROWS, SG_TASK_GOAL, 3, 9, 3>(tableau, P, A, info);
    if (n_planets == 4 && n_tiles == 16 && cols == 4)
      return launch_tab<ROWS, SG_TASK_GOAL, 4, 16, 4>(tableau, P, A, info);
  } else if (task == SG_TASK_KEPLER && n_planets == 2 && n_tiles == 0) {
    return launch_tab<ROWS, SG_TASK_KEPLER, 2, 0, 0>(tableau, P, A, info);
  } else if (task == SG_TASK_DNC && n_planets == 2 && n_tiles == 0) {
    return launch_tab<ROWS, SG_TASK_DNC, 2, 0, 0>(tableau, P, A, info);
  }
  return SG_ERR_UNSUPPORTED;
}

// The C interface of one translation unit: `NAME` launches the step with the
// row source ROWS.  Arguments: params, task, planets, tiles, cols, tableau,
// the 8 inputs with n_u after u (the action (B, 2) lane-major), the 10
// outputs (the flags bytes), B, stream.  `NAME_at` takes
// lane0, the global index of lane 0 (rng.cuh), before the stream; `NAME` is
// lane0 = 0.  `NAME_info`
// writes sg_kernel_info's eight numbers of the instantiation a launch of B
// lanes would use; with -DSG_PHASE_CLOCK the library also has the clock's
// entry points (step_clock.cuh).
#define SG_DEFINE_FULL_STEP(NAME, ROWS)                                                         \
  extern "C" int NAME##_at(const FullParams* P, int task, int n_planets, int n_tiles, int cols,  \
                           int tableau, const float* y, const float* a, const float* p,          \
                           const float* g, const float* r, const float* cs, const void* u,       \
                           int n_u, const int* ti, float* yo, float* po, float* go, float* ro,   \
                           float* cso, float* obs, float* fobs, float* rew, int* tio,            \
                           unsigned char* flags, int B, int lane0, void* stream) {               \
    const FullStepArgs A{y,  a,  p,  g,  r,   cs,   u,   n_u, ti,    yo, po,                     \
                         go, ro, cso, obs, fobs, rew, tio, flags, B, (cudaStream_t)stream,       \
                         lane0};                                                                 \
    return sg_full_step_impl<ROWS>(*P, task, n_planets, n_tiles, cols, tableau, A);              \
  }                                                                                              \
  extern "C" int NAME(const FullParams* P, int task, int n_planets, int n_tiles, int cols,       \
                      int tableau, const float* y, const float* a, const float* p,               \
                      const float* g, const float* r, const float* cs, const void* u, int n_u,   \
                      const int* ti, float* yo, float* po, float* go, float* ro, float* cso,     \
                      float* obs, float* fobs, float* rew, int* tio, unsigned char* flags, int B,\
                      void* stream) {                                                            \
    return NAME##_at(P, task, n_planets, n_tiles, cols, tableau, y, a, p, g, r, cs, u, n_u, ti,  \
                     yo, po, go, ro, cso, obs, fobs, rew, tio, flags, B, 0, stream);             \
  }                                                                                              \
  extern "C" int NAME##_info(int task, int n_planets, int n_tiles, int cols, int tableau, int B, \
                             int* out) {                                                         \
    FullStepArgs A{};                                                                            \
    A.B = B;                                                                                     \
    A.n_u = 1;                                                                                   \
    return sg_full_step_impl<ROWS>(FullParams{}, task, n_planets, n_tiles, cols, tableau, A, out); \
  }                                                                                              \
  SG_K3_CLOCK_ENTRIES()

// `NAME` writes the (n_u, B) block that ROWS draws from the key words at `key`;
// `NAME_at` that of the lanes from global lane lane0 on.
#define SG_DEFINE_FILL_UNIFORMS(NAME, ROWS)                                                   \
  extern "C" int NAME##_at(const void* key, float* out, int n_u, int B, int lane0,            \
                           void* stream) {                                                    \
    return sg_fill_uniforms<ROWS>(key, out, n_u, B, lane0, stream);                           \
  }                                                                                           \
  extern "C" int NAME(const void* key, float* out, int n_u, int B, void* stream) {            \
    return sg_fill_uniforms<ROWS>(key, out, n_u, B, 0, stream);                               \
  }
