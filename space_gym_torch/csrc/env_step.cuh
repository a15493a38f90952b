// Kernel K2: physics, observation and reward of one control step, for every
// lane, without resample or reset.  Included by env_step.cu and, for the CPU,
// by host/env_step_host.cpp against the stand-in headers of host/.
//
// Replaces the Pallas TPU kernel space_gym_tpu/ops/pallas_step.py::
// make_fused_env_step.<locals>.kernel (pallas_step.py:370, launched through
// _grid_call at :499 -> :262).  Inputs are component-major (rows, B) float32:
// y (6,B), a (2,B), p (2P,B), g (2,B), ref (3,B) -> y' (6,B), terminated (1,B)
// int32, obs (D,B), reward (1,B).  The observation shows the pre-step goal;
// the Goal reward adds the sparse bonus where the goal is reached
// (pallas_step.py:451) but no `reached` flag leaves the kernel: the engine's
// tail recomputes it and draws the new goal.  Plain twin:
// space_gym_torch/ops/env_step.py::EnvStep.plain_rows.
//
// What bounds it on an H100 (phase clock, PERF.md §5): as for K1
// (fused_step.cuh), the dependent chain of each lane, not its bytes (152 a
// lane for GoalContinuous2P-v0, 0.012 ms at B=262144).  With one block a
// tile of 128 lanes and each lane refining in place, the substeps took 42%
// of the warp-cycles, the event refinement 25%, the operand loads 16% and
// observe + reward 13%.  Design: K1's (a block's
// list of deferred lanes in shared memory, persistent blocks walking an
// equal share of the tiles), and a deferred lane's observation and reward
// computed where it is finished, from its input rows read again from memory;
// the device functions of the full-step kernel (csrc/observe_reward.cuh)
// reused as they are; task, planet count and tableau are template
// parameters; the ragged edge is masked.
#pragma once

#include <cuda_runtime.h>

#include "env_lanes.cuh"
#include "launch_info.cuh"
#include "observe_reward.cuh"

#define SG_K2_THREADS 128

// The operands of one launch.
struct EnvStepArgs {
  const float *y, *a, *p, *g, *r;
  float* yo;
  int* term;
  float *obs, *rew;
  int B;
  cudaStream_t stream;
};

// The kernel's one parameter.
struct K2Args {
  FullParams P;
  EnvStepArgs A;
  int tiles;  // ceil(B / SG_K2_THREADS)
};

// One lane's inputs but its state, from the operands in memory.
template <int NP>
struct EnvLaneIn {
  float ae, at, pl[2 * NP], px[NP], py[NP], gx, gy, ref[3];
  __device__ __forceinline__ void load(const EnvStepArgs& A, size_t n, int lane) {
    ae = A.a[lane];
    at = A.a[n + lane];
#pragma unroll
    for (int i = 0; i < 2 * NP; ++i) pl[i] = A.p[i * n + lane];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      px[i] = pl[2 * i];
      py[i] = pl[2 * i + 1];
    }
    gx = A.g[lane];
    gy = A.g[n + lane];
#pragma unroll
    for (int i = 0; i < 3; ++i) ref[i] = A.r[i * n + lane];
  }
};

// Observation and reward of a lane from its state before (y0) and after
// (yf, angle wrapped) the step, then the clock's `mark`; writes its state,
// observation and reward.
template <int TASK, int NP>
__device__ __forceinline__ void sg_env_outputs(const FullParams& P, const EnvStepArgs& A, size_t n,
                                               int lane, const float* y0, const float* yf,
                                               const EnvLaneIn<NP>& in, int mark) {
  constexpr int D = ObsDim<TASK, NP>::D;
  float obs[D];
  sg_observe<TASK, NP>(P, yf, in.pl, in.gx, in.gy, in.ref, obs);
  bool reached;
  const float rew =
      sg_reward<TASK, NP>(P, y0, yf, in.pl, in.gx, in.gy, in.ref, in.ae, in.at, reached);
  SG_K3_MARK(mark);
#pragma unroll
  for (int c = 0; c < 6; ++c) A.yo[c * n + lane] = yf[c];
#pragma unroll
  for (int i = 0; i < D; ++i) A.obs[i * n + lane] = obs[i];
  A.rew[lane] = rew;
}

template <int TASK, int NP, int TAB>
__global__ void __launch_bounds__(SG_K2_THREADS) env_step_kernel(const K2Args args) {
  const FullParams& P = args.P;
  const EnvStepArgs& A = args.A;
  const size_t n = (size_t)A.B;
  const SgList<TAB> L = sg_block_list<TAB>();
  SG_K3_CLOCK_START();
  for (int t = blockIdx.x; t < args.tiles; t += gridDim.x) {
    const int lane = t * SG_K2_THREADS + threadIdx.x;
    const bool live = lane < A.B;
    float y0[6], yf[6];
    EnvLaneIn<NP> in;
    SgBracket<TAB> br;
    bool fire = false;
    if (live) {
#pragma unroll
      for (int c = 0; c < 6; ++c) y0[c] = A.y[c * n + lane];
      in.load(A, n, lane);
      SG_K3_MARK(K3_WAIT);
      fire = sg_integrate<NP, TAB>(P.phys, y0, in.px, in.py, in.ae, in.at, yf, br);
    }
    const bool deferred = sg_defer<TAB>(L, fire, br, lane);
    SG_K3_COUNT(live, false, false);
    SG_K3_COUNT_FIRE(live, fire, deferred);
    SG_K3_MARK(K3_SYNC);
    if (live) {
      if (!deferred) {
        if (fire) sg_refine<NP, TAB>(P.phys, br, in.px, in.py, yf);
        SG_K3_MARK(K3_REFINE);
        yf[2] = sg_wrap_angle(yf[2]);
        sg_env_outputs<TASK, NP>(P, A, n, lane, y0, yf, in, K3_OBSERVE);
      }
      A.term[lane] = fire ? 1 : 0;
      SG_K3_MARK(K3_STORES);
    }
  }

  // A deferred lane: its inputs from memory, refinement, observation,
  // reward, outputs.
  sg_finish_list<TAB>(L, [&](int l, const SgBracket<TAB>& b) {
    float x0[6], yq[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) x0[c] = A.y[c * n + l];
    EnvLaneIn<NP> lin;
    lin.load(A, n, l);
    sg_refine<NP, TAB>(P.phys, b, lin.px, lin.py, yq);
    yq[2] = sg_wrap_angle(yq[2]);
    sg_env_outputs<TASK, NP>(P, A, n, l, x0, yq, lin, K3_DEFER);
  });
  SG_K3_CLOCK_END();
}

// Launches one instantiation, or with `info` fills sg_kernel_info's numbers.
template <int TASK, int NP, int TAB>
static int sg_env_step_launch(const FullParams& P, const EnvStepArgs& A, int* info) {
  const int threads = SG_K2_THREADS, tiles = (A.B + threads - 1) / threads;
  auto k = env_step_kernel<TASK, NP, TAB>;
  constexpr int smem = SgList<TAB>::SMEM;
  static int known_dev = -1, per_sm = 0;
  int resident = 0;
  const int e = sg_resident_blocks(k, threads, smem, known_dev, per_sm, &resident);
  if (e) return e;
  const int grid = min(tiles, resident);
  if (info) return sg_kernel_info(k, grid, threads, smem, tiles, info);
  K2Args args{P, A, tiles};
  return sg_launch(k, grid, threads, smem, A.stream, args);
}

template <int TASK, int NP>
static int sg_env_step_tab(int tableau, const FullParams& P, const EnvStepArgs& A, int* info) {
  if (tableau == SG_TAB_DP5) return sg_env_step_launch<TASK, NP, SG_TAB_DP5>(P, A, info);
  if (tableau == SG_TAB_BS3) return sg_env_step_launch<TASK, NP, SG_TAB_BS3>(P, A, info);
  return SG_ERR_UNSUPPORTED;
}

// Returns 0 on a launched kernel, the cudaError_t of a refused launch, or
// SG_ERR_UNSUPPORTED for a configuration not instantiated here: Goal with 2,
// 3 or 4 planets, Kepler and DoNotCrash with their planet + border.
static int sg_env_step_impl(const FullParams& P, int task, int n_planets, int tableau,
                            const EnvStepArgs& A, int* info = nullptr) {
  if (A.B <= 0) return SG_ERR_UNSUPPORTED;
  if (task == SG_TASK_GOAL) {
    if (n_planets == 2) return sg_env_step_tab<SG_TASK_GOAL, 2>(tableau, P, A, info);
    if (n_planets == 3) return sg_env_step_tab<SG_TASK_GOAL, 3>(tableau, P, A, info);
    if (n_planets == 4) return sg_env_step_tab<SG_TASK_GOAL, 4>(tableau, P, A, info);
  } else if (task == SG_TASK_KEPLER && n_planets == 2) {
    return sg_env_step_tab<SG_TASK_KEPLER, 2>(tableau, P, A, info);
  } else if (task == SG_TASK_DNC && n_planets == 2) {
    return sg_env_step_tab<SG_TASK_DNC, 2>(tableau, P, A, info);
  }
  return SG_ERR_UNSUPPORTED;
}

// The C interface: `sg_env_step` launches (params, task, planets, tableau,
// y, a, p, g, ref, y', terminated, obs, reward, B, stream);
// `sg_env_step_info` writes sg_kernel_info's eight numbers of the
// instantiation a launch of B lanes would use; with -DSG_PHASE_CLOCK the
// library also has the clock's entry points.
#define SG_DEFINE_ENV_STEP()                                                                  \
  extern "C" int sg_env_step(const FullParams* P, int task, int n_planets, int tableau,       \
                             const float* y, const float* a, const float* p, const float* g, \
                             const float* r, float* yo, int* term, float* obs, float* rew,   \
                             int B, void* stream) {                                          \
    const EnvStepArgs A{y, a, p, g, r, yo, term, obs, rew, B, (cudaStream_t)stream};          \
    return sg_env_step_impl(*P, task, n_planets, tableau, A);                                 \
  }                                                                                           \
  extern "C" int sg_env_step_info(int task, int n_planets, int tableau, int B, int* out) {    \
    EnvStepArgs A{};                                                                          \
    A.B = B;                                                                                  \
    return sg_env_step_impl(FullParams{}, task, n_planets, tableau, A, out);                  \
  }                                                                                           \
  SG_K3_CLOCK_ENTRIES()
