// The phase clock of the env kernels K1, K2, K3, K3-tf and K3-hw, in a build
// with -DSG_PHASE_CLOCK only (chip_smoke.py --phase-clock): for want of a
// profiler of a kernel's insides.  Without the flag every mark is nothing, so
// the physics device code they share (physics.cuh) keeps its marks for free.
//
// At a mark the lowest active lane of a warp reads clock64() and adds the
// cycles since its warp's previous mark to the block's counter of that mark;
// lanes that reach a mark in separate divergent passes each add their own
// interval, so a warp's counters always sum to its elapsed cycles.  At the
// block's end its threads add the block's counters to the device's.  The
// counts (lanes, lanes that reached their goal, done lanes, lanes whose
// events fire and those of them that refine in place because their block's
// list of deferred lanes is full, warp tiles and those with such a lane) are
// added the same way.
#pragma once

#define SG_K3_MARKS(X)                                                                   \
  X(K3_WAIT, "operand loads")                                                            \
  X(K3_SUBSTEPS, "physics substeps")                                                     \
  X(K3_REFINE, "event refinement")                                                       \
  X(K3_OBSERVE, "observe + reward")                                                      \
  X(K3_STORES, "stores")                                                                 \
  X(K3_SYNC, "rare-lane lists, block barrier")                                           \
  X(K3_DEFER, "deferred lanes: loads, refinement, observe + reward, stores")            \
  X(K3_RESAMPLE, "Goal resample")                                                        \
  X(K3_RESET, "auto-reset + second observe")
#define SG_K3_COUNTS(X)                                                                  \
  X(K3_LANES, "lanes") X(K3_REACHED, "lanes that reached their goal")                     \
  X(K3_DONE, "lanes done") X(K3_WARPS, "warp tiles")                                     \
  X(K3_WARPS_RARE, "warp tiles with a lane that reached its goal or is done")              \
  X(K3_FIRED, "lanes whose events fire")                                                 \
  X(K3_WARPS_FIRED, "warp tiles with a lane whose events fire")                          \
  X(K3_INPLACE, "lanes whose events fire and refine in place")
#define SG_K3_ID(id, name) id,
#define SG_K3_NAME(id, name) name,
enum K3Mark { SG_K3_MARKS(SG_K3_ID) K3_NMARKS };
enum K3Count { SG_K3_COUNTS(SG_K3_ID) K3_NCOUNTS };

#ifdef SG_PHASE_CLOCK
#include <cstdio>
__device__ unsigned long long sg_k3_device[K3_NMARKS + K3_NCOUNTS];
// Per block: the counters, then each warp's last clock reading.
struct K3Clock {
  unsigned long long acc[K3_NMARKS + K3_NCOUNTS];
  long long last[32];
};
__device__ __forceinline__ K3Clock& sg_k3_clock() {
  __shared__ K3Clock c;
  return c;
}
// Before any mark: zero the block's counters (all threads, then a barrier).
__device__ __forceinline__ void sg_k3_clock_start() {
  K3Clock& c = sg_k3_clock();
  for (int i = threadIdx.x; i < K3_NMARKS + K3_NCOUNTS; i += blockDim.x) c.acc[i] = 0;
  __syncthreads();
  if (threadIdx.x % 32 == 0) c.last[threadIdx.x / 32] = clock64();
  __syncwarp();
}
__device__ __forceinline__ void sg_k3_mark(int id) {
  const unsigned m = __activemask();
  if ((int)(threadIdx.x % 32) == __ffs(m) - 1) {
    K3Clock& c = sg_k3_clock();
    const long long t = clock64();
    atomicAdd(&c.acc[id], (unsigned long long)(t - c.last[threadIdx.x / 32]));
    c.last[threadIdx.x / 32] = t;
  }
}
// The warp's counts: `lane_ok` the lanes in range, `reached` (and not done),
// `done`; by every lane of the warp.
__device__ __forceinline__ void sg_k3_count(bool lane_ok, bool reached, bool done) {
  const unsigned m = 0xFFFFFFFFu;
  const unsigned ok = __ballot_sync(m, lane_ok), re = __ballot_sync(m, lane_ok && reached),
                 dn = __ballot_sync(m, lane_ok && done);
  if (threadIdx.x % 32 == 0) {
    unsigned long long* a = sg_k3_clock().acc + K3_NMARKS;
    atomicAdd(&a[K3_LANES], (unsigned long long)__popc(ok));
    atomicAdd(&a[K3_REACHED], (unsigned long long)__popc(re));
    atomicAdd(&a[K3_DONE], (unsigned long long)__popc(dn));
    atomicAdd(&a[K3_WARPS], ok ? 1ull : 0ull);
    atomicAdd(&a[K3_WARPS_RARE], (re | dn) ? 1ull : 0ull);
  }
}
// The warp's counts of lanes whose events fire: `fire` (of the lanes in
// range, `lane_ok`), and of those the ones not `deferred` to the block's
// list; by every lane of the warp.
__device__ __forceinline__ void sg_k3_count_fire(bool lane_ok, bool fire, bool deferred) {
  const unsigned m = 0xFFFFFFFFu;
  const unsigned fi = __ballot_sync(m, lane_ok && fire),
                 ip = __ballot_sync(m, lane_ok && fire && !deferred);
  if (threadIdx.x % 32 == 0) {
    unsigned long long* a = sg_k3_clock().acc + K3_NMARKS;
    atomicAdd(&a[K3_FIRED], (unsigned long long)__popc(fi));
    atomicAdd(&a[K3_WARPS_FIRED], fi ? 1ull : 0ull);
    atomicAdd(&a[K3_INPLACE], (unsigned long long)__popc(ip));
  }
}
// After the last mark, by every thread of the block.
__device__ __forceinline__ void sg_k3_clock_end() {
  __syncthreads();
  for (int i = threadIdx.x; i < K3_NMARKS + K3_NCOUNTS; i += blockDim.x)
    atomicAdd(&sg_k3_device[i], sg_k3_clock().acc[i]);
}
#define SG_K3_CLOCK_START() sg_k3_clock_start()
#define SG_K3_MARK(id) sg_k3_mark(id)
#define SG_K3_COUNT(ok, reached, done) sg_k3_count(ok, reached, done)
#define SG_K3_COUNT_FIRE(ok, fire, deferred) sg_k3_count_fire(ok, fire, deferred)
#define SG_K3_CLOCK_END() sg_k3_clock_end()
// `sg_k3_phase_read(out)` copies the marks' cycles, then the counts, out and
// zeroes them; `sg_k3_phase_name(i, out, n)` writes the name of entry i.
#define SG_K3_CLOCK_ENTRIES()                                                            \
  extern "C" int sg_k3_phase_read(unsigned long long* out) {                             \
    cudaError_t e = cudaMemcpyFromSymbol(out, sg_k3_device, sizeof(sg_k3_device));       \
    if (e != cudaSuccess) return (int)e;                                                 \
    static const unsigned long long zero[K3_NMARKS + K3_NCOUNTS] = {};                   \
    return (int)cudaMemcpyToSymbol(sg_k3_device, zero, sizeof(zero));                    \
  }                                                                                      \
  extern "C" int sg_k3_phase_name(int i, char* out, int n) {                             \
    static const char* const names[] = {SG_K3_MARKS(SG_K3_NAME) SG_K3_COUNTS(SG_K3_NAME)}; \
    return snprintf(out, n, "%s", i >= 0 && i < K3_NMARKS + K3_NCOUNTS ? names[i] : "?"); \
  }
#else
#define SG_K3_CLOCK_START() ((void)0)
#define SG_K3_MARK(id) ((void)0)
#define SG_K3_COUNT(ok, reached, done) ((void)0)
#define SG_K3_COUNT_FIRE(ok, fire, deferred) ((void)0)
#define SG_K3_CLOCK_END() ((void)0)
#define SG_K3_CLOCK_ENTRIES()
#endif
