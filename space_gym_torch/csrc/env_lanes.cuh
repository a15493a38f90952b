// The list of deferred lanes of the env kernels K1 (fused_step.cuh), K2
// (env_step.cuh) and K3 (full_step.cuh): a lane whose events fire saves the
// bracket of its firing substep (physics.cuh, SgBracket) to its block's list
// in shared memory, and the block's threads finish the list together after
// its last tile.
//
// Why (PERF.md §5-6): a refinement is refine_iters serial Illinois
// iterations (a division, a dense output and NP square roots each) on the
// one or two lanes of a warp whose events fire, while the warp's other lanes
// wait; about 1.4% of lanes fire on the main path's state, so about a third
// of the warps hold one and spend as long in it as in their substeps.  A
// persistent block walks several tiles of lanes, so its list gathers the
// firing lanes of all of them and one pass finishes them, 32 to a warp:
//   * a warp reserves slots for its firing lanes with one shared-memory
//     atomic (ballot); each such lane writes its bracket to its slot; a lane
//     whose slot lies past the list's end refines in place;
//   * no barrier between tiles: a slot is read only after the block's end
//     barrier, by the thread of the block that finishes it.
// A list across the grid, finished by the blocks as they end, was tried
// first and was 3 to 10 times slower than refining in place: its slot
// reservations, claims and completion flags went through a few words of
// device memory that every block of the card touched (PERF.md §6).  A
// deferred lane runs the same operations on the same values as in place
// (sg_refine), so which thread finishes it does not change a bit.
#pragma once

#include "physics.cuh"

#define SG_LIST_SLOTS 128  // slots of a block's list (its threads)

// Words of one slot: the bracket (Q, comp, f_lo, f_hi, bits) and the lane.
template <int TAB>
struct SgList {
  static constexpr int NPW = Tab<TAB>::NPW;
  static constexpr int WORDS = 6 * NPW + 6 + 4;
  // dynamic shared memory: the count of reserved slots, then word k of slot
  // s at words[k * SG_LIST_SLOTS + s]
  static constexpr int SMEM = 16 + WORDS * SG_LIST_SLOTS * 4;
  int* count;
  float* words;
};

// The block's list in its dynamic shared memory, emptied (a barrier).
template <int TAB>
__device__ __forceinline__ SgList<TAB> sg_block_list() {
#ifdef __CUDACC__
  extern __shared__ __align__(16) unsigned char sg_smem[];
#else
  unsigned char* sg_smem = reinterpret_cast<unsigned char*>(host_shared_memory());
#endif
  SgList<TAB> L{reinterpret_cast<int*>(sg_smem), reinterpret_cast<float*>(sg_smem + 16)};
  if (threadIdx.x == 0) *L.count = 0;
  __syncthreads();
  return L;
}

// By every lane of the warp: saves the bracket of each lane with `fire` to
// the list.  Returns true where the lane's slot was in the list (deferred),
// false where it must refine in place or did not fire.
template <int TAB>
__device__ __forceinline__ bool sg_defer(const SgList<TAB>& L, bool fire, const SgBracket<TAB>& br,
                                         int lane) {
  constexpr int NPW = SgList<TAB>::NPW;
  const unsigned fm = __ballot_sync(0xFFFFFFFFu, fire);
  if (fm == 0u) return false;
  const int wl = threadIdx.x % 32;
  int base = 0;
  if (wl == 0) base = atomicAdd(L.count, __popc(fm));
  base = __shfl_sync(0xFFFFFFFFu, base, 0);
  const int slot = base + __popc(fm & ((1u << wl) - 1u));
  if (!fire || slot >= SG_LIST_SLOTS) return false;
  float* w = L.words + slot;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int m = 0; m < NPW; ++m) w[(c * NPW + m) * SG_LIST_SLOTS] = br.Q[c][m];
    w[(6 * NPW + c) * SG_LIST_SLOTS] = br.comp[c];
  }
  w[(6 * NPW + 6) * SG_LIST_SLOTS] = br.f_lo;
  w[(6 * NPW + 7) * SG_LIST_SLOTS] = br.f_hi;
  w[(6 * NPW + 8) * SG_LIST_SLOTS] = __int_as_float((int)br.bits);
  w[(6 * NPW + 9) * SG_LIST_SLOTS] = __int_as_float(lane);
  return true;
}

// The deferred lanes in the list, after the block's end barrier.
template <int TAB>
__device__ __forceinline__ int sg_list_size(const SgList<TAB>& L) {
  return min(*L.count, SG_LIST_SLOTS);
}

// The lane of slot s of the list.
template <int TAB>
__device__ __forceinline__ int sg_list_lane(const SgList<TAB>& L, int s) {
  constexpr int NPW = SgList<TAB>::NPW;
  return __float_as_int(L.words[(6 * NPW + 9) * SG_LIST_SLOTS + s]);
}

// The bracket of slot s of the list.
template <int TAB>
__device__ __forceinline__ void sg_list_take(const SgList<TAB>& L, int s, SgBracket<TAB>& br) {
  constexpr int NPW = SgList<TAB>::NPW;
  const float* w = L.words + s;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
#pragma unroll
    for (int m = 0; m < NPW; ++m) br.Q[c][m] = w[(c * NPW + m) * SG_LIST_SLOTS];
    br.comp[c] = w[(6 * NPW + c) * SG_LIST_SLOTS];
  }
  br.f_lo = w[(6 * NPW + 6) * SG_LIST_SLOTS];
  br.f_hi = w[(6 * NPW + 7) * SG_LIST_SLOTS];
  br.bits = (unsigned)__float_as_int(w[(6 * NPW + 8) * SG_LIST_SLOTS]);
}

// By every thread of the block, after its last tile: the end barrier, then
// finish(lane, bracket) for every slot of the list, one slot a thread.  (K3
// walks its list from its last thread down, beside its resets.)
template <int TAB, class F>
__device__ __forceinline__ void sg_finish_list(const SgList<TAB>& L, F finish) {
  __syncthreads();
  SG_K3_MARK(K3_SYNC);
  const int n = sg_list_size(L);
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    SgBracket<TAB> br;
    sg_list_take(L, s, br);
    finish(sg_list_lane(L, s), br);
  }
  SG_K3_MARK(K3_STORES);
}
