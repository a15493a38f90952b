#pragma once
// Stand-in for the CUDA runtime, for running a kernel's LOGIC on the CPU with
// a host compiler (g++ -std=c++20 -I this directory): one fiber (one OS
// thread off x86-64) per CUDA thread, __syncthreads, warp shuffles, ballots
// and the grid barrier as real barriers, shared memory as one array per
// block.  It says nothing about registers, memory coherence or speed; it
// finds wrong indices, missing barriers and wrong arithmetic where there is
// no card.
//
// Fibers: every CUDA thread of a launch runs on the launching OS thread, on
// a stack of its own, and gives way only where it waits at a barrier; the
// last member to arrive releases the others, in arrival order on even
// phases and in reverse on odd ones, so a read that misses its barrier sees
// the writer's value in one order and the unwritten NaN of the shared
// memory in the other.  A launch costs one core, however loaded the
// machine: with an OS thread per CUDA thread a barrier needs every member
// scheduled, and the same cases took ten times as long on a machine busy
// with other processes.  Threads left waiting when no fiber is ready are a
// deadlock, and abort.  With EMUL_LAG set, the last block of every thread
// block cluster starts last after each cluster barrier: its threads wait
// until no other is ready, so the cluster's other blocks run ahead to their
// next barrier that needs it, and a block that rewrites what the lagging one
// still has to read shows as a wrong sum.  Fibers are x86-64 only; elsewhere
// the OS threads run.  Used by
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
#include <cstdio>
#include <deque>
#include <functional>
#define __host__
#define __constant__
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__
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
// A barrier of n threads.  Fibers park on it (fiber_arrive).  OS threads
// yield a while and then sleep: with many more threads than cores a warp or
// block barrier mostly completes while its members yield to each other,
// without a sleep and a wake-up in the kernel per member; a member that
// waits longer (a loaded machine) sleeps on the atomic and leaves the cores
// to other processes.
struct Barrier;
inline bool fiber_running();
inline void fiber_arrive(Barrier& b);
struct Barrier {
    std::atomic<int> count{0}, phase{0};
    const int n;
    std::vector<int> waiting;  // fibers: the members parked here, in arrival order
    explicit Barrier(int n_) : n(n_) {}
    void arrive_and_wait() {
        if (fiber_running()) {
            fiber_arrive(*this);
            return;
        }
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
    // the thread block cluster: its barrier, this block's rank, its size and
    // the shared memory of its blocks in rank order
    Barrier* cluster_bar; int crank, csize; float* const* cluster_smem;
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
inline bool EMUL_LAG = false;   // the last block of a cluster lags (fibers only)
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int a, int) {
    *v = a == cudaDevAttrMultiProcessorCount ? EMUL_SMS : 232448; return 0; }
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
// A launch's configuration with attributes (cudaLaunchKernelEx): the cluster
// size and the cooperative flag are the ones read here.
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension, cudaLaunchAttributeCooperative };
struct cudaLaunchAttribute {
    cudaLaunchAttributeID id;
    struct { struct { unsigned x, y, z; } clusterDim; int cooperative; } val;
};
struct cudaLaunchConfig_t {    // gridDim and blockDim in order (the names are macros here)
    dim3 grid, block;
    size_t dynamicSmemBytes;
    cudaStream_t stream;
    cudaLaunchAttribute* attrs;
    unsigned numAttrs;
};
inline int cluster_dim(const cudaLaunchConfig_t* cfg) {
    for (unsigned i = 0; i < cfg->numAttrs; i++)
        if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
            return (int)cfg->attrs[i].val.clusterDim.x;
    return 1;
}
// The stand-in card holds one block a "SM" and a cluster on any SMs: as many
// clusters of n blocks at once as n divides into its SMs.
template <class F> cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t* cfg) {
    *n = EMUL_SMS / cluster_dim(cfg); return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline float* host_shared_memory() { return tctx.smem; }
// ---- fibers (x86-64): a stack switch that saves the callee-saved registers.
#if defined(__x86_64__)
extern "C" void sg_fiber_switch(void** save_sp, void* to_sp);
asm(R"(
.text
.globl sg_fiber_switch
.type sg_fiber_switch, @function
sg_fiber_switch:
    pushq %rbp
    pushq %rbx
    pushq %r12
    pushq %r13
    pushq %r14
    pushq %r15
    movq %rsp, (%rdi)
    movq %rsi, %rsp
    popq %r15
    popq %r14
    popq %r13
    popq %r12
    popq %rbx
    popq %rbp
    ret
.size sg_fiber_switch, .-sg_fiber_switch
)");
constexpr bool kFibers = true;
#else
inline void sg_fiber_switch(void**, void*) { std::abort(); }
constexpr bool kFibers = false;
#endif

struct Fiber {
    void* sp = nullptr;
    ThreadCtx ctx{};
    std::function<void()> body;
    bool done = false;
};
struct FiberRun {
    std::vector<Fiber> fibers;
    std::deque<int> ready;  // fibers to run, in order
    std::deque<int> lagging;  // with EMUL_LAG: to run once nothing else is ready
    void* sched_sp = nullptr;
    int cur = 0;
};
inline thread_local FiberRun* g_fibers = nullptr;
inline bool fiber_running() { return g_fibers != nullptr; }

// Does fiber i start last after barrier b (EMUL_LAG: b is its cluster's
// barrier and it is of the cluster's last block)?
inline bool fiber_lags(const Fiber& f, const Barrier& b) {
    return EMUL_LAG && f.ctx.cluster_bar == &b && f.ctx.csize > 1
        && f.ctx.crank == f.ctx.csize - 1;
}

// A member parks at the barrier and gives way; the last one to arrive
// releases the others to run after what is ready now, in arrival order on
// even phases and the reverse on odd ones, and goes on (those that lag go
// to the lagging queue, the last one too).
inline void fiber_arrive(Barrier& b) {
    FiberRun* r = g_fibers;
    Fiber& f = r->fibers[r->cur];
    f.ctx = tctx;
    const int ph = b.phase.load(std::memory_order_relaxed);
    if (b.count.fetch_add(1, std::memory_order_relaxed) == b.n - 1) {
        b.count.store(0, std::memory_order_relaxed);
        b.phase.store(ph + 1, std::memory_order_relaxed);
        if (ph % 2) std::reverse(b.waiting.begin(), b.waiting.end());
        for (int i : b.waiting)
            (fiber_lags(r->fibers[i], b) ? r->lagging : r->ready).push_back(i);
        b.waiting.clear();
        if (!fiber_lags(f, b)) return;
        r->lagging.push_back(r->cur);
    } else {
        b.waiting.push_back(r->cur);
    }
    sg_fiber_switch(&f.sp, r->sched_sp);
    tctx = r->fibers[r->cur].ctx;
}

[[noreturn]] inline void fiber_entry() {
    FiberRun* r = g_fibers;
    Fiber& f = r->fibers[r->cur];
    f.body();
    f.done = true;
    sg_fiber_switch(&f.sp, r->sched_sp);
    std::abort();  // a finished fiber is never resumed
}

// Runs body(b, t) for every thread (block b, thread t) as fibers; returns
// after all have ended.
template <class Body>
void run_fibers(int G, int T, Body body) {
    constexpr size_t kStack = 1 << 20;  // virtual; a page is committed where touched
    const int n = G * T;
    char* stacks = static_cast<char*>(std::malloc(size_t(n) * kStack));
    if (!stacks) std::abort();
    FiberRun run;
    run.fibers.resize(n);
    for (int i = 0; i < n; i++) {
        Fiber& f = run.fibers[i];
        f.body = [&body, i, T] { body(i / T, i % T); };
        // the initial frame: six zero registers, then fiber_entry as the
        // return address, with rsp = 8 mod 16 on entry as a call leaves it
        uintptr_t top = reinterpret_cast<uintptr_t>(stacks + (i + 1) * kStack) & ~uintptr_t(15);
        void** sp = reinterpret_cast<void**>(top) - 2;
        sp[1] = nullptr;
        sp[0] = reinterpret_cast<void*>(&fiber_entry);
        sp -= 6;
        for (int k = 0; k < 6; k++) sp[k] = nullptr;
        f.sp = sp;
        run.ready.push_back(i);
    }
    FiberRun* outer = g_fibers;
    const ThreadCtx saved = tctx;
    g_fibers = &run;
    int ended = 0;
    while (!run.ready.empty() || !run.lagging.empty()) {
        if (run.ready.empty()) std::swap(run.ready, run.lagging);
        run.cur = run.ready.front();
        run.ready.pop_front();
        sg_fiber_switch(&run.sched_sp, run.fibers[run.cur].sp);
        ended += run.fibers[run.cur].done;  // else it parked at a barrier
    }
    if (ended != n) {
        std::fprintf(stderr, "launch_emul: deadlock, %d of %d threads wait at a barrier\n",
                     n - ended, n);
        std::abort();
    }
    g_fibers = outer;
    tctx = saved;
    std::free(stacks);
}

template <class A>
cudaError_t launch_emul(void (*fn)(A), dim3 grid, dim3 block, void** params, size_t smem,
                        int cdim = 1) {
    A args = *static_cast<A*>(params[0]);
    int G = grid.x, T = block.x, nw = (T + 31) / 32;
    if (cdim < 1 || G % cdim) return cudaErrorInvalidConfiguration;
    Barrier gbar(G * T);
    std::vector<std::unique_ptr<Barrier>> bbar, wbar, cbar;
    std::vector<std::vector<float>> sm(G, std::vector<float>(smem / 4 + 16, NAN));
    std::vector<float*> smp(G);
    for (int b = 0; b < G; b++) smp[b] = sm[b].data();
    for (int c = 0; c < G / cdim; c++) cbar.emplace_back(new Barrier(cdim * T));
    std::vector<std::vector<float>> slots(G * nw, std::vector<float>(32));
    std::vector<std::vector<unsigned>> bits(G * nw, std::vector<unsigned>(32));
    std::vector<WarpX> xch(G * nw);
    for (int b = 0; b < G; b++) {
        bbar.emplace_back(new Barrier(T));
        for (int w = 0; w < nw; w++) wbar.emplace_back(new Barrier(std::min(32, T - 32 * w)));
    }
    auto thread_body = [&](int b, int t) {
        tctx.tid = dim3(t); tctx.bid = dim3(b); tctx.bdim = block; tctx.gdim = grid;
        tctx.block_bar = bbar[b].get(); tctx.grid_bar = &gbar;
        tctx.warp_bar = wbar[b * nw + t / 32].get();
        tctx.warp_slots = slots[b * nw + t / 32].data();
        tctx.warp_bits = bits[b * nw + t / 32].data();
        tctx.smem = sm[b].data();
        tctx.warpx = &xch[b * nw + t / 32];
        tctx.xhalf = 0;
        tctx.cluster_bar = cbar[b / cdim].get();
        tctx.crank = b % cdim;
        tctx.csize = cdim;
        tctx.cluster_smem = smp.data() + (b / cdim) * cdim;
        fn(args);
    };
    if (kFibers) {
        run_fibers(G, T, thread_body);
        return 0;
    }
    std::vector<std::thread> th;
    for (int b = 0; b < G; b++)
        for (int t = 0; t < T; t++) th.emplace_back(thread_body, b, t);
    for (auto& x : th) x.join();
    return 0;
}
cudaError_t cudaLaunchCooperativeKernel(void* fn, dim3 grid, dim3 block, void** params, size_t smem, cudaStream_t);
// A launch with attributes: the cluster size of the configuration, the
// whole grid resident (the cooperative flag changes nothing here).
template <class A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*fn)(A), A args) {
    void* params[] = {&args};
    return launch_emul(fn, cfg->grid, cfg->block, params, cfg->dynamicSmemBytes,
                       cluster_dim(cfg));
}
