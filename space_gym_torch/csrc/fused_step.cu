// Kernel K1: the physics of one control step, for every lane.
//
// Replaces the Pallas TPU kernel space_gym_tpu/ops/pallas_step.py::
// make_fused_step.<locals>.kernel (pallas_step.py:300, launched through
// _grid_call at :315 -> :262).  Inputs and outputs are component-major
// (rows, B) float32: y (6,B), a (2,B) = (engine in [0,1], thruster),
// p (2P,B) = (px0, py0, px1, ...) -> y' (6,B), terminated (1,B) int32.
//
// What bounds it on an H100: bytes.  Per lane it reads 8+2P and writes 7
// words (76 B at P=2) and runs a few hundred float operations (RK stages,
// events, up to refine_iters dense-output evaluations on lanes with an
// event), which at the card's f32 rate take less than the memory time
// (chip_smoke.py prints both).  They form one dependent chain per lane, so
// latency and occupancy set its time for now.  Design: one thread per lane
// (csrc/physics.cuh), the whole chain in registers, coalesced row-wise
// loads and stores; the ragged edge is masked, so any B works.  Nothing is
// tuned yet (block size, register count, fast math): see PERF.md.
#include <cuda_runtime.h>

#include "physics.cuh"

template <int NP, int TAB>
__global__ void __launch_bounds__(128)
    fused_step_kernel(const PhysParams P, const float* __restrict__ y,
                      const float* __restrict__ a, const float* __restrict__ p,
                      float* __restrict__ yo, int* __restrict__ term, int B) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const size_t n = (size_t)B;
  float y0[6], px[NP], py[NP], yf[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) y0[c] = y[c * n + lane];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    px[i] = p[(2 * i) * n + lane];
    py[i] = p[(2 * i + 1) * n + lane];
  }
  const bool t = sg_physics<NP, TAB>(P, y0, px, py, a[lane], a[n + lane], yf);
#pragma unroll
  for (int c = 0; c < 6; ++c) yo[c * n + lane] = yf[c];
  term[lane] = t ? 1 : 0;
}

template <int NP, int TAB>
static void launch(const PhysParams& P, const float* y, const float* a, const float* p,
                   float* yo, int* term, int B, cudaStream_t s) {
  const int threads = 128;
  fused_step_kernel<NP, TAB><<<(B + threads - 1) / threads, threads, 0, s>>>(P, y, a, p, yo,
                                                                            term, B);
}

// Returns 0 on a launched kernel, the cudaError_t of a refused launch, or
// SG_ERR_UNSUPPORTED for a planet count / tableau / batch not built here.
extern "C" int sg_fused_step(const PhysParams* P, int n_planets, int tableau, const float* y,
                             const float* a, const float* p, float* yo, int* term, int B,
                             void* stream) {
  if (B <= 0 || tableau < 0 || tableau > 1) return SG_ERR_UNSUPPORTED;
  cudaStream_t s = (cudaStream_t)stream;
  const int key = n_planets * 2 + tableau;
  switch (key) {
    case 2 * 1 + 0: launch<1, SG_TAB_DP5>(*P, y, a, p, yo, term, B, s); break;
    case 2 * 1 + 1: launch<1, SG_TAB_BS3>(*P, y, a, p, yo, term, B, s); break;
    case 2 * 2 + 0: launch<2, SG_TAB_DP5>(*P, y, a, p, yo, term, B, s); break;
    case 2 * 2 + 1: launch<2, SG_TAB_BS3>(*P, y, a, p, yo, term, B, s); break;
    case 2 * 3 + 0: launch<3, SG_TAB_DP5>(*P, y, a, p, yo, term, B, s); break;
    case 2 * 3 + 1: launch<3, SG_TAB_BS3>(*P, y, a, p, yo, term, B, s); break;
    case 2 * 4 + 0: launch<4, SG_TAB_DP5>(*P, y, a, p, yo, term, B, s); break;
    case 2 * 4 + 1: launch<4, SG_TAB_BS3>(*P, y, a, p, yo, term, B, s); break;
    default: return SG_ERR_UNSUPPORTED;
  }
  return (int)cudaGetLastError();
}
