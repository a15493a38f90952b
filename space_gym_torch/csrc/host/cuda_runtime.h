#pragma once
// Stand-in for the CUDA runtime, for running a kernel's LOGIC on the CPU with
// a host compiler (g++ -std=c++20 -I this directory): one OS thread per CUDA
// thread, __syncthreads, warp shuffles, ballots and the grid barrier as real
// barriers, shared memory as one array per block.  It says nothing about
// registers, memory coherence or speed; it finds wrong indices, missing
// barriers and wrong arithmetic where there is no card.  Used by
// tests/test_torch_sac_kernel_host.py through sac_update_host.cpp and by
// tests/test_torch_td3_kernel_host.py through td3_update_host.cpp.
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#include <algorithm>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1) : x(a) {} };
struct ThreadCtx {
    dim3 tid, bid, bdim, gdim;
    std::barrier<>* block_bar; std::barrier<>* grid_bar; std::barrier<>* warp_bar;
    float* warp_slots; unsigned* warp_bits; float* smem;
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
constexpr int cudaSuccess = 0;
enum { cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
       cudaFuncAttributeMaxDynamicSharedMemorySize };
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
    std::barrier<> gbar(G * T);
    std::vector<std::unique_ptr<std::barrier<>>> bbar, wbar;
    std::vector<std::vector<float>> sm(G, std::vector<float>(smem / 4 + 16, NAN));
    std::vector<std::vector<float>> slots(G * nw, std::vector<float>(32));
    std::vector<std::vector<unsigned>> bits(G * nw, std::vector<unsigned>(32));
    for (int b = 0; b < G; b++) {
        bbar.emplace_back(new std::barrier<>(T));
        for (int w = 0; w < nw; w++) wbar.emplace_back(new std::barrier<>(std::min(32, T - 32 * w)));
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
                fn(args);
            });
    for (auto& x : th) x.join();
    return 0;
}
cudaError_t cudaLaunchCooperativeKernel(void* fn, dim3 grid, dim3 block, void** params, size_t smem, cudaStream_t);
