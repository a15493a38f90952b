// Kernel K1: the physics of one control step, for every lane.  Included by
// fused_step.cu and, for the CPU, by host/env_step_host.cpp against the
// stand-in headers of host/.
//
// Replaces the Pallas TPU kernel space_gym_tpu/ops/pallas_step.py::
// make_fused_step.<locals>.kernel (pallas_step.py:300, launched through
// _grid_call at :315 -> :262).  Inputs and outputs are component-major
// (rows, B) float32: y (6,B), a (2,B) = (engine in [0,1], thruster),
// p (2P,B) = (px0, py0, px1, ...) -> y' (6,B), terminated (1,B) int32.
// Plain twin: space_gym_torch/ops/physics_step.py::PhysicsStep.plain_rows.
//
// What bounds it on an H100 (phase clock, PERF.md §5): not its bytes (76 a
// lane, 0.006 ms at B=262144) but the one long dependent chain of each lane
// and the instructions it issues.  With one block a tile of 128 lanes and
// each lane refining in place, 62% of the warp-cycles went to the substeps
// (right-hand sides of precise sine, cosine, reciprocal square root and
// divisions) and 29% to the event refinement: 1.4% of lanes fire, a
// third of the warps hold one, and such a warp spends as long in its
// refine_iters serial Illinois iterations, one lane in 32 active, as in its
// substeps.  Design:
//   * a lane that fires hands the bracket of its firing substep to its
//     block's list in shared memory (csrc/env_lanes.cuh), and the block's
//     threads finish the list after its last tile, 32 lanes a warp; only
//     lanes past the list's 128 slots refine in place;
//   * persistent blocks of 128 threads, as many as the card holds (the
//     occupancy query), each walking an equal share of the 128-lane tiles,
//     so one list gathers the firing lanes of three or four tiles (one tile
//     a block gathered too few to pay, PERF.md §6);
//   * one sincosf a right-hand side (physics.cuh);
//   * coalesced row-wise loads and stores; the ragged edge is masked, so any
//     B works.
#pragma once

#include <cuda_runtime.h>

#include "env_lanes.cuh"
#include "launch_info.cuh"

#define SG_K1_THREADS 128

// The kernel's one parameter.
struct K1Args {
  PhysParams P;
  const float *y, *a, *p;
  float* yo;
  int* term;
  int B;
  int tiles;  // ceil(B / SG_K1_THREADS)
};

template <int NP, int TAB>
__global__ void __launch_bounds__(SG_K1_THREADS) fused_step_kernel(const K1Args args) {
  const PhysParams& P = args.P;
  const float* __restrict__ y = args.y;
  const float* __restrict__ a = args.a;
  const float* __restrict__ p = args.p;
  float* __restrict__ yo = args.yo;
  int* __restrict__ term = args.term;
  const size_t n = (size_t)args.B;
  const SgList<TAB> L = sg_block_list<TAB>();
  SG_K3_CLOCK_START();
  for (int t = blockIdx.x; t < args.tiles; t += gridDim.x) {
    const int lane = t * SG_K1_THREADS + threadIdx.x;
    const bool live = lane < args.B;
    float px[NP], py[NP], yf[6];
    SgBracket<TAB> br;
    bool fire = false;
    if (live) {
      float y0[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) y0[c] = y[c * n + lane];
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        px[i] = p[(2 * i) * n + lane];
        py[i] = p[(2 * i + 1) * n + lane];
      }
      const float ae = a[lane], at = a[n + lane];
      SG_K3_MARK(K3_WAIT);
      fire = sg_integrate<NP, TAB>(P, y0, px, py, ae, at, yf, br);
    }
    const bool deferred = sg_defer<TAB>(L, fire, br, lane);
    SG_K3_COUNT(live, false, false);
    SG_K3_COUNT_FIRE(live, fire, deferred);
    SG_K3_MARK(K3_SYNC);
    if (live) {
      if (!deferred) {
        if (fire) sg_refine<NP, TAB>(P, br, px, py, yf);
        SG_K3_MARK(K3_REFINE);
        yf[2] = sg_wrap_angle(yf[2]);
#pragma unroll
        for (int c = 0; c < 6; ++c) yo[c * n + lane] = yf[c];
      }
      term[lane] = fire ? 1 : 0;
      SG_K3_MARK(K3_STORES);
    }
  }

  // A deferred lane: its planets from memory, refinement, state.
  sg_finish_list<TAB>(L, [&](int l, const SgBracket<TAB>& b) {
    float qx[NP], qy[NP], yq[6];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      qx[i] = p[(2 * i) * n + l];
      qy[i] = p[(2 * i + 1) * n + l];
    }
    sg_refine<NP, TAB>(P, b, qx, qy, yq);
    SG_K3_MARK(K3_DEFER);
    yq[2] = sg_wrap_angle(yq[2]);
#pragma unroll
    for (int c = 0; c < 6; ++c) yo[c * n + l] = yq[c];
  });
  SG_K3_CLOCK_END();
}

// Launches one instantiation, or with `info` fills sg_kernel_info's numbers.
template <int NP, int TAB>
static int sg_fused_step_launch(const PhysParams& P, const float* y, const float* a,
                                const float* p, float* yo, int* term, int B, cudaStream_t s,
                                int* info) {
  const int threads = SG_K1_THREADS, tiles = (B + threads - 1) / threads;
  auto k = fused_step_kernel<NP, TAB>;
  constexpr int smem = SgList<TAB>::SMEM;
  static int known_dev = -1, per_sm = 0;
  int resident = 0;
  const int e = sg_resident_blocks(k, threads, smem, known_dev, per_sm, &resident);
  if (e) return e;
  const int grid = min(tiles, resident);
  if (info) return sg_kernel_info(k, grid, threads, smem, tiles, info);
  K1Args args{P, y, a, p, yo, term, B, tiles};
  return sg_launch(k, grid, threads, smem, s, args);
}

// Returns 0 on a launched kernel, the cudaError_t of a refused launch, or
// SG_ERR_UNSUPPORTED for a planet count / tableau / batch not built here.
static int sg_fused_step_impl(const PhysParams& P, int n_planets, int tableau, const float* y,
                              const float* a, const float* p, float* yo, int* term, int B,
                              cudaStream_t s, int* info = nullptr) {
  if (B <= 0 || tableau < 0 || tableau > 1) return SG_ERR_UNSUPPORTED;
#define SG_K1_CASE(NP)                                                                      \
  if (n_planets == NP)                                                                      \
    return tableau == SG_TAB_DP5                                                            \
               ? sg_fused_step_launch<NP, SG_TAB_DP5>(P, y, a, p, yo, term, B, s, info)     \
               : sg_fused_step_launch<NP, SG_TAB_BS3>(P, y, a, p, yo, term, B, s, info);
  SG_K1_CASE(1)
  SG_K1_CASE(2)
  SG_K1_CASE(3)
  SG_K1_CASE(4)
#undef SG_K1_CASE
  return SG_ERR_UNSUPPORTED;
}

// The C interface: `sg_fused_step` launches (params, planets, tableau, y, a,
// p, y', terminated, B, stream);
// `sg_fused_step_info` writes sg_kernel_info's eight numbers of the
// instantiation a launch of B lanes would use; with -DSG_PHASE_CLOCK the
// library also has the clock's entry points.
#define SG_DEFINE_FUSED_STEP()                                                                 \
  extern "C" int sg_fused_step(const PhysParams* P, int n_planets, int tableau, const float* y, \
                               const float* a, const float* p, float* yo, int* term, int B,    \
                               void* stream) {                                                 \
    return sg_fused_step_impl(*P, n_planets, tableau, y, a, p, yo, term, B,                    \
                              (cudaStream_t)stream);                                           \
  }                                                                                            \
  extern "C" int sg_fused_step_info(int n_planets, int tableau, int B, int* out) {             \
    return sg_fused_step_impl(PhysParams{}, n_planets, tableau, nullptr, nullptr, nullptr,     \
                              nullptr, nullptr, B, nullptr, out);                              \
  }                                                                                            \
  SG_K3_CLOCK_ENTRIES()
