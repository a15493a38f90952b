#pragma once
// Stand-in for the CUDA runtime, for running a kernel's LOGIC on the CPU with
// a host compiler (g++ -std=c++20 -I this directory): one OS thread per CUDA
// thread, __syncthreads, warp shuffles, ballots and the grid barrier as real
// barriers, shared memory as one array per block.  It says nothing about
// registers, memory coherence or speed; it finds wrong indices, missing
// barriers and wrong arithmetic where there is no card.  Used by
// tests/test_torch_sac_kernel_host.py through sac_update_host.cpp, by
// tests/test_torch_td3_kernel_host.py through td3_update_host.cpp and by
// tests/test_torch_full_step_host.py through full_step_host.cpp and by
// tests/test_torch_env_step_host.py through env_step_host.cpp.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <algorithm>
#include <bit>
#include <cstdlib>
#define __host__
#define __constant__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct uint4 { unsigned x, y, z, w; };
// a store and a load with a cache hint
template <class T> inline void __stcs(T* p, T v) { *p = v; }
template <class T> inline T __ldcs(const T* p) { return *p; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1) : x(a) {} };
// A warp's exchange area for the emulated warp-level instructions of
// mma_emul.h (ldmatrix, mma): two halves of one slot a lane.
struct WarpX {
    struct Lane { const void* ptr; unsigned reg[6]; } lane[2][32];
};
// A barrier of n threads that yields a while and then sleeps: with many more
// threads than cores a warp or block barrier mostly completes while its
// members yield to each other, without a sleep and a wake-up in the kernel
// per member; a member that waits longer (a loaded machine) sleeps on the
// atomic and leaves the cores to other processes.
struct Barrier {
    std::atomic<int> count{0}, phase{0};
    const int n;
    explicit Barrier(int n_) : n(n_) {}
    void arrive_and_wait() {
        constexpr int yields = 16;
        const int ph = phase.load(std::memory_order_acquire);
        if (count.fetch_add(1, std::memory_order_acq_rel) == n - 1) {
            count.store(0, std::memory_order_relaxed);
            phase.store(ph + 1, std::memory_order_release);
            phase.notify_all();
            return;
        }
        for (int i = 0; phase.load(std::memory_order_acquire) == ph; i++) {
            if (i < yields) std::this_thread::yield();
            else phase.wait(ph, std::memory_order_acquire);
        }
    }
};
struct ThreadCtx {
    dim3 tid, bid, bdim, gdim;
    Barrier* block_bar; Barrier* grid_bar; Barrier* warp_bar;
    float* warp_slots; unsigned* warp_bits; float* smem;
    WarpX* warpx; int xhalf;
};
inline thread_local ThreadCtx tctx;
#define threadIdx (tctx.tid)
#define blockIdx (tctx.bid)
#define blockDim (tctx.bdim)
#define gridDim (tctx.gdim)
inline void __syncthreads() { tctx.block_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int o) {
    int lane = tctx.tid.x % 32;
    tctx.warp_slots[lane] = v;
    tctx.warp_bar->arrive_and_wait();
    float r = tctx.warp_slots[lane ^ o];
    tctx.warp_bar->arrive_and_wait();
    return r;
}
inline int __shfl_sync(unsigned, int v, int src) {
    int lane = tctx.tid.x % 32;
    tctx.warp_slots[lane] = std::bit_cast<float>(v);
    tctx.warp_bar->arrive_and_wait();
    int r = std::bit_cast<int>(tctx.warp_slots[src]);
    tctx.warp_bar->arrive_and_wait();
    return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int atomicAdd(int* p, int v) { return std::atomic_ref<int>(*p).fetch_add(v); }

inline unsigned __umulhi(unsigned a, unsigned b) {
    return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline float __uint_as_float(unsigned x) { return std::bit_cast<float>(x); }
inline int __float_as_int(float x) { return std::bit_cast<int>(x); }
inline float __int_as_float(int x) { return std::bit_cast<float>(x); }
inline float rsqrtf(float x) { return 1.f / sqrtf(x); }
using std::isfinite;
using std::isnan;
inline unsigned __ballot_sync(unsigned, bool p) {
    int lane = tctx.tid.x % 32;
    tctx.warp_bits[lane] = p ? 1u : 0u;
    tctx.warp_bar->arrive_and_wait();
    unsigned r = 0;
    for (int i = 0; i < 32; i++) r |= tctx.warp_bits[i] << i;
    tctx.warp_bar->arrive_and_wait();
    return r;
}
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr int cudaSuccess = 0, cudaErrorInvalidConfiguration = 9;
enum { cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
       cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
    *a = {0, 0}; return 0; }
inline int EMUL_SMS = 4;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int a, int) {
    *v = a == cudaDevAttrMultiProcessorCount ? EMUL_SMS : 232448; return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline float* host_shared_memory() { return tctx.smem; }
template <class A>
cudaError_t launch_emul(void (*fn)(A), dim3 grid, dim3 block, void** params, size_t smem) {
    A args = *static_cast<A*>(params[0]);
    int G = grid.x, T = block.x, nw = (T + 31) / 32;
    Barrier gbar(G * T);
    std::vector<std::unique_ptr<Barrier>> bbar, wbar;
    std::vector<std::vector<float>> sm(G, std::vector<float>(smem / 4 + 16, NAN));
    std::vector<std::vector<float>> slots(G * nw, std::vector<float>(32));
    std::vector<std::vector<unsigned>> bits(G * nw, std::vector<unsigned>(32));
    std::vector<WarpX> xch(G * nw);
    for (int b = 0; b < G; b++) {
        bbar.emplace_back(new Barrier(T));
        for (int w = 0; w < nw; w++) wbar.emplace_back(new Barrier(std::min(32, T - 32 * w)));
    }
    std::vector<std::thread> th;
    for (int b = 0; b < G; b++)
        for (int t = 0; t < T; t++)
            th.emplace_back([&, b, t] {
                tctx.tid = dim3(t); tctx.bid = dim3(b); tctx.bdim = block; tctx.gdim = grid;
                tctx.block_bar = bbar[b].get(); tctx.grid_bar = &gbar;
                tctx.warp_bar = wbar[b * nw + t / 32].get();
                tctx.warp_slots = slots[b * nw + t / 32].data();
                tctx.warp_bits = bits[b * nw + t / 32].data();
                tctx.smem = sm[b].data();
                tctx.warpx = &xch[b * nw + t / 32];
                tctx.xhalf = 0;
                fn(args);
            });
    for (auto& x : th) x.join();
    return 0;
}
cudaError_t cudaLaunchCooperativeKernel(void* fn, dim3 grid, dim3 block, void** params, size_t smem, cudaStream_t);
