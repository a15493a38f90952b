// Kernel K2: physics, observation and reward of one control step, for every
// lane, without resample or reset.
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
// What bounds it on an H100: bytes.  Per lane it reads 13 + 2P and writes
// 8 + D words (152 B for GoalContinuous2P-v0) against the few hundred float
// operations of the physics chain (csrc/physics.cuh), which at the card's f32
// rate take less than the memory time (chip_smoke.py prints both).  Design:
// one thread per lane, everything in registers, the device functions of the
// full-step kernel (csrc/observe_reward.cuh) reused as they are; task, planet
// count and tableau are template parameters; the ragged edge is masked.
#include <cuda_runtime.h>

#include "observe_reward.cuh"

template <int TASK, int NP, int TAB>
__global__ void __launch_bounds__(128)
    env_step_kernel(const FullParams P, const float* __restrict__ y_in,
                    const float* __restrict__ a_in, const float* __restrict__ p_in,
                    const float* __restrict__ g_in, const float* __restrict__ r_in,
                    float* __restrict__ yo, int* __restrict__ term, float* __restrict__ obs_out,
                    float* __restrict__ rew_out, int B) {
  constexpr int D = ObsDim<TASK, NP>::D;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t n = (size_t)B;

  float y0[6], pl[2 * NP], px[NP], py[NP], ref[3], yf[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) y0[c] = y_in[c * n + lane];
  const float ae = a_in[lane], at = a_in[n + lane];
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i) pl[i] = p_in[i * n + lane];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    px[i] = pl[2 * i];
    py[i] = pl[2 * i + 1];
  }
  const float gx = g_in[lane], gy = g_in[n + lane];
#pragma unroll
  for (int i = 0; i < 3; ++i) ref[i] = r_in[i * n + lane];

  const bool terminated = sg_physics<NP, TAB>(P.phys, y0, px, py, ae, at, yf);
  float obs[D];
  sg_observe<TASK, NP>(P, yf, pl, gx, gy, ref, obs);
  bool reached;
  const float rew = sg_reward<TASK, NP>(P, y0, yf, pl, gx, gy, ref, ae, at, reached);

#pragma unroll
  for (int c = 0; c < 6; ++c) yo[c * n + lane] = yf[c];
  term[lane] = terminated ? 1 : 0;
#pragma unroll
  for (int i = 0; i < D; ++i) obs_out[i * n + lane] = obs[i];
  rew_out[lane] = rew;
}

struct EnvStepArgs {
  const float *y, *a, *p, *g, *r;
  float* yo;
  int* term;
  float *obs, *rew;
  int B;
  cudaStream_t stream;
};

template <int TASK, int NP, int TAB>
static int launch(const FullParams& P, const EnvStepArgs& A) {
  const int threads = 128;
  env_step_kernel<TASK, NP, TAB><<<(A.B + threads - 1) / threads, threads, 0, A.stream>>>(
      P, A.y, A.a, A.p, A.g, A.r, A.yo, A.term, A.obs, A.rew, A.B);
  return (int)cudaGetLastError();
}

template <int TASK, int NP>
static int launch_tab(int tableau, const FullParams& P, const EnvStepArgs& A) {
  if (tableau == SG_TAB_DP5) return launch<TASK, NP, SG_TAB_DP5>(P, A);
  if (tableau == SG_TAB_BS3) return launch<TASK, NP, SG_TAB_BS3>(P, A);
  return SG_ERR_UNSUPPORTED;
}

// Returns 0 on a launched kernel, the cudaError_t of a refused launch, or
// SG_ERR_UNSUPPORTED for a configuration not instantiated here: Goal with 2,
// 3 or 4 planets, Kepler and DoNotCrash with their planet + border.
extern "C" int sg_env_step(const FullParams* P, int task, int n_planets, int tableau,
                           const float* y, const float* a, const float* p, const float* g,
                           const float* r, float* yo, int* term, float* obs, float* rew, int B,
                           void* stream) {
  if (B <= 0) return SG_ERR_UNSUPPORTED;
  const EnvStepArgs A{y, a, p, g, r, yo, term, obs, rew, B, (cudaStream_t)stream};
  if (task == SG_TASK_GOAL) {
    if (n_planets == 2) return launch_tab<SG_TASK_GOAL, 2>(tableau, *P, A);
    if (n_planets == 3) return launch_tab<SG_TASK_GOAL, 3>(tableau, *P, A);
    if (n_planets == 4) return launch_tab<SG_TASK_GOAL, 4>(tableau, *P, A);
  } else if (task == SG_TASK_KEPLER && n_planets == 2) {
    return launch_tab<SG_TASK_KEPLER, 2>(tableau, *P, A);
  } else if (task == SG_TASK_DNC && n_planets == 2) {
    return launch_tab<SG_TASK_DNC, 2>(tableau, *P, A);
  }
  return SG_ERR_UNSUPPORTED;
}
