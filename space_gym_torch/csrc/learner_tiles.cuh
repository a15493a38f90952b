// Device code shared by the fused learner kernels: K4 and K5 (sac_update.cuh)
// and K6 (td3_update.cuh).  Nothing here knows the algorithm: a thread's 8 x 8
// output tile, the three kinds of (batch, H) x (H, H) product on shared-memory
// activation buffers, the ReLU stores and masks, the minibatch tile loads from
// the replay ring, and the parts of an update that SAC and TD3 have in common
// (a critic's forward and backward against a given target, the critics' Adam
// stage, the actor's backward from its head gradients).
//
// In a launch of thread block clusters (sac_update.cuh) a cluster sums its
// blocks' gradients on chip and writes one slot: the weight gradients
// (gemm_wgrad, MTile::wgrad) and the exchange rows (xflush) below.
//
// The stages are templates over the tile type, which brings its products and
// their stores as members and the layout of the activation buffers as
// `ix(s, j)`: Tile<H> here (float32 multiply-adds on the CUDA cores, the
// float32 mode of K4, K5 and K6) or MTile<H> of learner_mma.cuh (the tensor
// cores, their bf16 mode).
//
// The algorithm's header supplies `Args` (the launch's operands; the functions
// here are templates over it and read the fields w, vec, mw, vw, mvec, vvec,
// data, row_idx, noise, losses, partials, wt, wb, B, W, lanes, rpb, od, tau) and a
// layout class `LY` with the row offsets r_cw1(c), r_tw1(c) in `w` and the
// rows V_CB1, V_CB2, V_CW3, V_TB1, V_TB2, V_TW3, V_MISC and columns M_CB3,
// M_TB3 in `vec`.
//
// Under a host compiler (no __CUDACC__) the same source runs on the CPU against
// the stand-in headers of csrc/host/.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace tiles {

typedef __nv_bfloat16 bf16;

constexpr int IN1 = 128;      // padded first-layer input width
constexpr int KC = 16;        // weight rows per shared-memory chunk
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_1MB1 = (float)(1.0 - 0.9);
constexpr float ADAM_1MB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;
constexpr float LOG_B1 = -0.10536051565782628f;    // log(0.9)
constexpr float LOG_B2 = -0.0010005003335835344f;  // log(0.999)

__host__ __device__ constexpr int row_groups(int H) { return H <= 128 ? 16 : H <= 256 ? 8 : 4; }
__host__ __device__ constexpr int ceil8(int x) { return (x + 7) / 8 * 8; }

__device__ __forceinline__ float rnd(float x, int bf) {
    return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float4 rnd4(float4 v, int bf) {
    if (bf) { v.x = rnd(v.x, 1); v.y = rnd(v.y, 1); v.z = rnd(v.z, 1); v.w = rnd(v.w, 1); }
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ void put(float* p, float v, bool first) { *p = first ? v : *p + v; }

// The thread block cluster of the launch: its barrier (every thread of every
// block; what a block wrote to its shared memory before it is visible to the
// others after it) and the address of `p` in the shared memory of block
// `rank` of the cluster.  A launch without clusters is one of clusters of one.
__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }
template <class T>
__device__ __forceinline__ T* peer(T* p, int rank) {
    return cg::this_cluster().map_shared_rank(p, rank);
}

// The activation buffers every stage works in: A and Bm (TS, H), the weight
// chunk wch (KC, H) or the ring of bf16 weight stages, and xin (W, TS), the
// first layer's feature-major input; with the block's place in its thread
// block cluster (cn blocks, this one of rank crank) and, where cn > 1, x: the
// exchange rows through which the cluster sums its gradients (`xflush`) and
// stages another block's operands (the weight gradients).
struct Bufs {
    float *A, *Bm, *wch, *xin;
    bf16* ring;
    float* x = nullptr;
    int cn = 1, crank = 0;
};

// One thread's 8 x 8 tile of a (TS, H) output: rows ty*8 + i, columns
// tx*4 + j (j < 4) and H/2 + tx*4 + j - 4 (j >= 4).  The products are float32
// multiply-adds on the CUDA cores (the free functions below); the members
// give them the interface that the stages call.
template <int H>
struct Tile {
    static constexpr int RG = row_groups(H);
    static constexpr int TS = 8 * RG;
    static constexpr int NT = (H / 8) * RG;
    static constexpr bool MMA = false;     // float32 multiply-adds on the CUDA cores
    float acc[8][8];
    int tx, ty;
    __device__ Tile() : tx(threadIdx.x % (H / 8)), ty(threadIdx.x / (H / 8)) {}
    // where element (s, j) of an activation buffer lies
    __device__ static int ix(int s, int j) { return s * H + j; }
    // acc = A . W (w: W in float32; rounded at staging in bf mode)
    __device__ void fwd(const Bufs& S, const float* A, const float* w, const bf16*, int bf);
    // acc = A . W^T (wt: the transposed float32 copy of W)
    __device__ void bwd(const Bufs& S, const float* A, const float* wt, const bf16*, int bf);
    // acc = xin^T . W1: the first Kdim rows, those below od rounded in bf mode
    __device__ void first(const Bufs& S, const float* w1, const bf16*, int Kdim, int od, int bf);
    __device__ void wgrad(const Bufs& S, const float* A, const float* Bm, float* out,
                          bool first);
    __device__ void relu(const float* bias, float* dst, int bf, float* gdst) const;
    __device__ void masked_inplace(float* A) const;
    __device__ void masked_bits(const unsigned* m, float* dst) const;
    // out[e][s] = sum_j buf[s][j] rnd(w[e ws + j]) + add[e], e < NR
    template <int NR>
    __device__ void row_dots(const float* buf, const float* w, size_t ws, const float (&add)[NR],
                             int bf, float* out) const;
    // the bits of buf > 0, one word per 32 columns of a sample
    __device__ void mask(const float* buf, unsigned* m) const;
    // a first layer's gradients from dz1 (in A) and its input xin: rows
    // [0, nrows) of W1 (obs rows [0, od) against rnd(dz1), the others against
    // dz1) and b1 as row nrows of out
    __device__ void w1grad(const Bufs& S, float* out, int nrows, int od, int bf, bool first) const;
    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < 8; i++)
#pragma unroll
            for (int j = 0; j < 8; j++) acc[i][j] = 0.0f;
    }
    __device__ void fma_row(const float (&a)[8], float4 w0, float4 w1) {
#pragma unroll
        for (int i = 0; i < 8; i++) {
            acc[i][0] += a[i] * w0.x; acc[i][1] += a[i] * w0.y;
            acc[i][2] += a[i] * w0.z; acc[i][3] += a[i] * w0.w;
            acc[i][4] += a[i] * w1.x; acc[i][5] += a[i] * w1.y;
            acc[i][6] += a[i] * w1.z; acc[i][7] += a[i] * w1.w;
        }
    }
};

// Stage KC rows k0.. of the global row-major (Kdim, H) matrix Wg into wch;
// rows below `nround` are rounded in bf mode, rows past Kdim are zero.
template <int H>
__device__ void stage_rows(const float* Wg, int k0, int Kdim, int nround, int bf, float* wch) {
    constexpr int NT = Tile<H>::NT;
    for (int idx = threadIdx.x; idx < KC * H / 4; idx += NT) {
        int r = idx / (H / 4), c4 = idx % (H / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < Kdim) {
            v = *reinterpret_cast<const float4*>(Wg + (size_t)(k0 + r) * H + c4 * 4);
            v = rnd4(v, bf && (k0 + r < nround));
        }
        reinterpret_cast<float4*>(wch)[idx] = v;
    }
}

// acc = A . Wg with A (TS, H) in shared memory (row stride H) and Wg (H, H)
// in device memory.  Starts with a block barrier, ends without one.
template <int H>
__device__ void gemm_sk(Tile<H>& t, const float* A, const float* Wg, int bf, float* wch) {
    t.zero();
    for (int k0 = 0; k0 < H; k0 += KC) {
        __syncthreads();
        stage_rows<H>(Wg, k0, H, H, bf, wch);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; kk += 4) {
            float4 a4[8];
#pragma unroll
            for (int i = 0; i < 8; i++)
                a4[i] = *reinterpret_cast<const float4*>(A + (t.ty * 8 + i) * H + k0 + kk);
#pragma unroll
            for (int q = 0; q < 4; q++) {
                float a[8];
#pragma unroll
                for (int i = 0; i < 8; i++)
                    a[i] = q == 0 ? a4[i].x : q == 1 ? a4[i].y : q == 2 ? a4[i].z : a4[i].w;
                const float* wr = wch + (kk + q) * H;
                t.fma_row(a, *reinterpret_cast<const float4*>(wr + t.tx * 4),
                          *reinterpret_cast<const float4*>(wr + H / 2 + t.tx * 4));
            }
        }
    }
}

// acc = xin^T . Wg with xin (Kdim, TS) in shared memory (feature-major, as the
// replay ring stores a tile) and Wg (Kdim, H) in device memory: a first
// layer.  Rows below `nround` of Wg are rounded in bf mode.
template <int H>
__device__ void gemm_ks(Tile<H>& t, const float* xin, const float* Wg, int Kdim, int nround,
                        int bf, float* wch) {
    constexpr int TS = Tile<H>::TS;
    t.zero();
    for (int k0 = 0; k0 < Kdim; k0 += KC) {
        __syncthreads();
        stage_rows<H>(Wg, k0, Kdim, nround, bf, wch);
        __syncthreads();
        int kn = min(KC, Kdim - k0);
        for (int kk = 0; kk < kn; kk++) {
            const float* xr = xin + (k0 + kk) * TS + t.ty * 8;
            float4 x0 = *reinterpret_cast<const float4*>(xr);
            float4 x1 = *reinterpret_cast<const float4*>(xr + 4);
            float a[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
            const float* wr = wch + kk * H;
            t.fma_row(a, *reinterpret_cast<const float4*>(wr + t.tx * 4),
                      *reinterpret_cast<const float4*>(wr + H / 2 + t.tx * 4));
        }
    }
}

// acc += A^T . Bm over the TS samples of A and Bm ((TS, H) in shared memory,
// this block's or another's of the cluster): rows i0.. of a weight gradient.
template <int H>
__device__ void wgrad_rows(Tile<H>& t, const float* A, const float* Bm, int i0) {
    constexpr int TS = Tile<H>::TS;
#pragma unroll 4
    for (int s = 0; s < TS; s++) {
        float4 a0 = *reinterpret_cast<const float4*>(A + s * H + i0);
        float4 a1 = *reinterpret_cast<const float4*>(A + s * H + i0 + 4);
        float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        t.fma_row(a, *reinterpret_cast<const float4*>(Bm + s * H + t.tx * 4),
                  *reinterpret_cast<const float4*>(Bm + s * H + H / 2 + t.tx * 4));
    }
}

// The thread's 8 rows i0.. of a weight gradient to out (+=).
template <int H>
__device__ void wgrad_store(const Tile<H>& t, float* out, int i0, bool first) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
#pragma unroll
        for (int hf = 0; hf < 2; hf++) {
            float4* p = reinterpret_cast<float4*>(out + (size_t)(i0 + i) * H + hf * (H / 2)
                                                  + t.tx * 4);
            float4 v = make_float4(t.acc[i][hf * 4], t.acc[i][hf * 4 + 1],
                                   t.acc[i][hf * 4 + 2], t.acc[i][hf * 4 + 3]);
            if (!first) {
                float4 o = *p;
                v.x += o.x; v.y += o.y; v.z += o.z; v.w += o.w;
            }
            *p = v;
        }
    }
}

// out (+)= A^T . Bm over the tile's samples: a weight gradient.  A and Bm are
// (TS, H) in shared memory, out is (H, H) in the slot.  Needs a block barrier
// before; reads shared memory only.  In a cluster of cn > 1 blocks the sum
// runs over the samples of all of them, in rank order, reading the others'
// A and Bm where they lie, and this block computes and writes only its rows
// [crank H / cn, (crank + 1) H / cn) of the cluster's gradient; a cluster
// barrier before (every block's A and Bm complete) and after (none is read
// any more).
template <int H>
__device__ void gemm_wgrad(Tile<H>& t, const Bufs& S, const float* A, const float* Bm, float* out,
                           bool first) {
    constexpr int TS = Tile<H>::TS;
    if (S.cn == 1) {
        for (int i0 = t.ty * 8; i0 < H; i0 += TS) {
            t.zero();
            wgrad_rows<H>(t, A, Bm, i0);
            wgrad_store<H>(t, out, i0, first);
        }
        return;
    }
    const int rr = H / S.cn, r0 = S.crank * rr;
    cluster_sync();
    for (int i0 = r0 + t.ty * 8; i0 < r0 + rr; i0 += TS) {
        t.zero();
        for (int c = 0; c < S.cn; c++) wgrad_rows<H>(t, peer(A, c), peer(Bm, c), i0);
        wgrad_store<H>(t, out, i0, first);
    }
    cluster_sync();
}

// dst = relu(acc + bias), rounded in bf mode; also to `gdst` where given.
template <int H>
__device__ void store_relu(const Tile<H>& t, const float* bias, float* dst, int bf, float* gdst) {
#pragma unroll
    for (int hf = 0; hf < 2; hf++) {
        int col = hf * (H / 2) + t.tx * 4;
        float4 b = *reinterpret_cast<const float4*>(bias + col);
#pragma unroll
        for (int i = 0; i < 8; i++) {
            float4 v;
            v.x = rnd(fmaxf(t.acc[i][hf * 4 + 0] + b.x, 0.f), bf);
            v.y = rnd(fmaxf(t.acc[i][hf * 4 + 1] + b.y, 0.f), bf);
            v.z = rnd(fmaxf(t.acc[i][hf * 4 + 2] + b.z, 0.f), bf);
            v.w = rnd(fmaxf(t.acc[i][hf * 4 + 3] + b.w, 0.f), bf);
            *reinterpret_cast<float4*>(dst + (t.ty * 8 + i) * H + col) = v;
            if (gdst) *reinterpret_cast<float4*>(gdst + (t.ty * 8 + i) * H + col) = v;
        }
    }
}

// A = A > 0 ? acc : 0, in place: a ReLU's backward from its own output.
template <int H>
__device__ void store_masked_inplace(const Tile<H>& t, float* A) {
#pragma unroll
    for (int hf = 0; hf < 2; hf++) {
        int col = hf * (H / 2) + t.tx * 4;
#pragma unroll
        for (int i = 0; i < 8; i++) {
            float4* p = reinterpret_cast<float4*>(A + (t.ty * 8 + i) * H + col);
            float4 h = *p;
            *p = make_float4(h.x > 0.f ? t.acc[i][hf * 4 + 0] : 0.f,
                             h.y > 0.f ? t.acc[i][hf * 4 + 1] : 0.f,
                             h.z > 0.f ? t.acc[i][hf * 4 + 2] : 0.f,
                             h.w > 0.f ? t.acc[i][hf * 4 + 3] : 0.f);
        }
    }
}

__device__ __forceinline__ bool mask_bit(const unsigned* m, int s, int j, int H) {
    return (m[s * (H / 32) + j / 32] >> (j % 32)) & 1u;
}

// dst = mask ? acc : 0 with the mask kept as bits.
template <int H>
__device__ void store_masked_bits(const Tile<H>& t, const unsigned* m, float* dst) {
#pragma unroll
    for (int hf = 0; hf < 2; hf++) {
        int col = hf * (H / 2) + t.tx * 4;
#pragma unroll
        for (int i = 0; i < 8; i++) {
            int s = t.ty * 8 + i;
            unsigned bits = m[s * (H / 32) + col / 32] >> (col % 32);
            *reinterpret_cast<float4*>(dst + s * H + col) =
                make_float4((bits & 1u) ? t.acc[i][hf * 4 + 0] : 0.f,
                            (bits & 2u) ? t.acc[i][hf * 4 + 1] : 0.f,
                            (bits & 4u) ? t.acc[i][hf * 4 + 2] : 0.f,
                            (bits & 8u) ? t.acc[i][hf * 4 + 3] : 0.f);
        }
    }
}

template <int H>
__device__ void Tile<H>::fwd(const Bufs& S, const float* A, const float* w, const bf16*, int bf) {
    gemm_sk<H>(*this, A, w, bf, S.wch);
}
template <int H>
__device__ void Tile<H>::bwd(const Bufs& S, const float* A, const float* wt, const bf16*, int bf) {
    gemm_sk<H>(*this, A, wt, bf, S.wch);
}
template <int H>
__device__ void Tile<H>::first(const Bufs& S, const float* w1, const bf16*, int Kdim, int od,
                               int bf) {
    gemm_ks<H>(*this, S.xin, w1, Kdim, od, bf, S.wch);
}
template <int H>
__device__ void Tile<H>::wgrad(const Bufs& S, const float* A, const float* Bm, float* out,
                               bool first) {
    gemm_wgrad<H>(*this, S, A, Bm, out, first);
}
template <int H>
__device__ void Tile<H>::relu(const float* bias, float* dst, int bf, float* gdst) const {
    store_relu<H>(*this, bias, dst, bf, gdst);
}
template <int H>
__device__ void Tile<H>::masked_inplace(float* A) const { store_masked_inplace<H>(*this, A); }
template <int H>
__device__ void Tile<H>::masked_bits(const unsigned* m, float* dst) const {
    store_masked_bits<H>(*this, m, dst);
}

// The bits of buf > 0, one word per 32 columns of a sample.
template <int H>
__device__ void make_mask(const float* buf, unsigned* m) {
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    for (int s = 0; s < TS; s++)
        for (int j = threadIdx.x; j < H; j += NT) {
            unsigned word = __ballot_sync(0xffffffffu, buf[s * H + j] > 0.f);
            if ((threadIdx.x & 31) == 0) m[s * (H / 32) + j / 32] = word;
        }
}

// out[s] = sum_j buf[s][j] * rnd(wrow[j]) + add, one warp per sample.
template <int H>
__device__ void row_dot(const float* buf, const float* wrow, float add, int bf, float* out) {
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int s = warp; s < TS; s += NT / 32) {
        float v = 0.f;
        for (int j = lane; j < H; j += 32) v += buf[s * H + j] * rnd(wrow[j], bf);
        v = warp_sum(v);
        if (lane == 0) out[s] = v + add;
    }
}

template <int H>
template <int NR>
__device__ void Tile<H>::row_dots(const float* buf, const float* w, size_t ws,
                                  const float (&add)[NR], int bf, float* out) const {
    for (int e = 0; e < NR; e++) row_dot<H>(buf, w + e * ws, add[e], bf, out + e * TS);
}
template <int H>
__device__ void Tile<H>::mask(const float* buf, unsigned* m) const { make_mask<H>(buf, m); }

// A first layer's gradients, a column a thread: b1 (row nrows of out) and
// the W1 rows [0, nrows), those below od against rnd(dz1).
template <int H>
__device__ void Tile<H>::w1grad(const Bufs& S, float* out, int nrows, int od, int bf,
                                bool first) const {
    for (int j = threadIdx.x; j < H; j += NT) {
        float gb1 = 0.f;
        for (int s = 0; s < TS; s++) gb1 += S.A[s * H + j];
        put(out + (size_t)nrows * H + j, gb1, first);
        for (int r0 = 0; r0 < nrows; r0 += 8) {
            float ga[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            for (int s = 0; s < TS; s++) {
                float dz = S.A[s * H + j], dzr = rnd(dz, bf);
#pragma unroll
                for (int i = 0; i < 8; i++)
                    if (r0 + i < nrows) ga[i] += S.xin[(r0 + i) * TS + s] * (r0 + i < od ? dzr : dz);
            }
#pragma unroll
            for (int i = 0; i < 8; i++)
                if (r0 + i < nrows) put(out + (size_t)(r0 + i) * H + j, ga[i], first);
        }
    }
}

// Sum of x[0..n) by warp 0 (n <= TS: the tile's samples), the same value in
// all its lanes.
template <int TS>
__device__ float tile_sum(const float* x, int n = TS) {
    float v = 0.f;
    for (int s = threadIdx.x % 32; s < n; s += 32) v += x[s];
    return warp_sum(v);
}

// The phase clock, in a build with -DSG_PHASE_CLOCK only (chip_smoke.py
// --phase-clock): at each mark, after a block barrier, block 0 adds the SM
// cycles since its previous mark to sg_phase_cycles[16 * site + mark], the
// site the one set by phase_site where `site` is -1: the caller of a shared
// stage sets it, so each call site of a stage has its own ids.  A kernel
// names its sites and its own marks (sac_update.cuh, SG_SITES); the marks of
// the shared stages are named here.  Without the flag a mark is nothing.
#define SG_STAGE_MARKS(X)                                                          \
    X(M_FIRST, "first layer") X(M_RELU1, "ReLU 1") X(M_W2, "W2 product")          \
    X(M_RELU2, "ReLU 2") X(M_DOTS, "row dots") X(M_DQ, "dq (masks)")              \
    X(M_W3B2, "w3, b2 loop") X(M_W2GRAD, "W2 weight gradient")                    \
    X(M_BWD, "dz2 . W2^T") X(M_DZ1, "dz1") X(M_W1B1, "W1, b1 loop")             \
    X(M_XCHG, "cluster exchange")
#define SG_ACTOR_BACK_MARKS(X)                                                     \
    X(A_STASH, "stash reload") X(A_HEAD, "head, b2 loop")                         \
    X(A_W2GRAD, "W2 weight gradient") X(A_BWD, "dz2 . W2^T") X(A_DZ1, "dz1")     \
    X(A_W1B1, "W1, b1 loop") X(A_XCHG, "cluster exchange")
#define SG_MARK_ID(id, name) id,
#define SG_MARK_NAME(id, name) name,
#define SG_SITE_ID(id, name, marks) id,
enum StageMark { SG_STAGE_MARKS(SG_MARK_ID) };
enum ActorBackMark { SG_ACTOR_BACK_MARKS(SG_MARK_ID) };
#ifdef SG_PHASE_CLOCK
__device__ unsigned long long sg_phase_cycles[256];
__device__ long long sg_phase_last;
__device__ int sg_phase_at;
__device__ __forceinline__ void phase(int mark, int site = -1) {
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        long long t = clock64();
        if (mark >= 0)
            sg_phase_cycles[(site < 0 ? sg_phase_at : 16 * site) + mark] +=
                (unsigned long long)(t - sg_phase_last);
        sg_phase_last = t;
    }
}
__device__ __forceinline__ void phase_site(int site) {
    if (blockIdx.x == 0 && threadIdx.x == 0) sg_phase_at = 16 * site;
}
#else
__device__ __forceinline__ void phase(int, int = -1) {}
__device__ __forceinline__ void phase_site(int) {}
#endif

// cp.async in 16-byte and 4-byte pieces, its group commit and its wait for
// all but the newest `N` groups.  Under a host compiler (no __CUDACC__: the
// kernel's logic run on the CPU against stand-in headers) the copy is
// synchronous.
#ifdef __CUDACC__
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// 4 bytes: .cg (L2 only) copies 16 bytes alone, .ca any of 4, 8, 16
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
#else
inline void cp_async16(void* smem, const void* gmem) {
    *static_cast<float4*>(smem) = *static_cast<const float4*>(gmem);
}
inline void cp_async4(void* smem, const void* gmem) {
    *static_cast<float*>(smem) = *static_cast<const float*>(gmem);
}
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
#endif

// The tiles of a launch.  Minibatch k is rpb ring rows of `lanes` samples
// (rpb 0: one gathered minibatch of lanes = B samples), and each row is cut
// into ceil(lanes / TS) tiles of TS samples, the last of a row partial when TS
// does not divide the lanes: tile t is samples [l0, l0 + nv) of row t / tpr
// of the minibatch, l0 = (t % tpr) TS.  Where TS divides the lanes this is
// the plain cut of the batch into B / TS tiles.
__host__ __device__ inline int tiles_per_row(int lanes, int TS) { return (lanes + TS - 1) / TS; }
__host__ __device__ inline int n_tiles(int lanes, int rpb, int TS) {
    return (rpb ? rpb : 1) * tiles_per_row(lanes, TS);
}
// The samples of tile t that lie inside its row: TS but for a row's last tile.
template <int TS, class Args>
__device__ int tile_samples(const Args& g, int t) {
    return min(TS, g.lanes - (t % tiles_per_row(g.lanes, TS)) * TS);
}

// Copy a tile's W data rows and NZ noise rows (of the (K, NZ, B) normals) into
// shared memory, (rows, TS) each: plain loads, or cp.async (completed by the
// caller).  A whole tile of rows whose stride is a multiple of 4 floats goes
// in 16-byte pieces; a partial tile, or rows not 16-byte aligned (lanes or a
// batch that is no multiple of 4), in 4-byte pieces, the samples past the
// row's end zero (plain stores).
template <int TS, int NZ, bool ASYNC, class Args>
__device__ void load_tile(const Args& g, int k, int t, float* xs, float* nz) {
    const int tpr = tiles_per_row(g.lanes, TS), r = t / tpr, l0 = (t % tpr) * TS;
    const int nv = min(TS, g.lanes - l0);
    // in ring mode B = rpb lanes, else lanes = B: the lanes' alignment is the rows'
    int ld;
    const float* base;
    if (g.rpb == 0) {
        ld = g.B;
        base = g.data + (size_t)k * g.W * g.B + l0;
    } else {
        ld = g.lanes;
        base = g.data + (size_t)g.row_idx[k * g.rpb + r] * g.W * g.lanes + l0;
    }
    const float* nbase = g.noise + (size_t)k * NZ * g.B + (size_t)r * g.lanes + l0;
    if (nv == TS && g.lanes % 4 == 0) {
        const int n_data = g.W * TS / 4;
        for (int idx = threadIdx.x; idx < n_data + NZ * TS / 4; idx += blockDim.x) {
            const float* src;
            float* dst;
            if (idx < n_data) {
                src = base + (size_t)(idx / (TS / 4)) * ld + (idx % (TS / 4)) * 4;
                dst = xs + idx * 4;
            } else {
                int i = idx - n_data;
                src = nbase + (size_t)(i / (TS / 4)) * g.B + (i % (TS / 4)) * 4;
                dst = nz + i * 4;
            }
            if (ASYNC) cp_async16(dst, src);
            else *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
        }
        return;
    }
    for (int idx = threadIdx.x; idx < (g.W + NZ) * TS; idx += blockDim.x) {
        const int row = idx / TS, s = idx % TS;
        float* dst = row < g.W ? xs + idx : nz + (idx - g.W * TS);
        const float* src = row < g.W ? base + (size_t)row * ld + s
                                     : nbase + (size_t)(row - g.W) * g.B + s;
        if (s >= nv) *dst = 0.f;
        else if (ASYNC) cp_async4(dst, src);
        else *dst = *src;
    }
}

// Rows [r0, r0 + n) of the tile -> rows [d0, d0 + n) of xin, rounded in bf mode.
template <int TS>
__device__ void copy_rows(const float* xs, int r0, float* xin, int d0, int n, int bf) {
    for (int idx = threadIdx.x; idx < n * TS; idx += blockDim.x)
        xin[d0 * TS + idx] = rnd(xs[r0 * TS + idx], bf);
}

// The sums over the grid's slots (`slot` floats apart, in index order) of
// the four neighbouring gradient elements at p: float4 loads, 32 slots in
// flight a thread, so the Adam stages are not bound by the latency of one
// load per slot; evict-first, since each is read once and the slots are
// larger than L2, where the weights and moments should stay.
__device__ __forceinline__ float4 slot_sum4(const float* p, int grid, size_t slot) {
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 32
    for (int b = 0; b < grid; b++) {
        float4 v = __ldcs(reinterpret_cast<const float4*>(p + b * slot));
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    return s;
}

// One Adam step of one element; returns the new weight.
__device__ __forceinline__ float adam_elem(float* wp, float* mp, float* vp, float gr, float a_lr,
                                           float c_eps) {
    float m = ADAM_B1 * *mp + ADAM_1MB1 * gr;
    float v = ADAM_B2 * *vp + ADAM_1MB2 * gr * gr;
    *mp = m; *vp = v;
    float wn = *wp - a_lr * m / (sqrtf(v) + c_eps);
    *wp = wn;
    return wn;
}

// One Adam step of the four neighbouring elements at wp, mp, vp (16-byte
// aligned): adam_elem's arithmetic with float4 loads and stores, all loads
// before any store.  Returns the new weights.
__device__ __forceinline__ float4 adam4(float* wp, float* mp, float* vp, float4 gr, float a_lr,
                                        float c_eps) {
    float4 w = *reinterpret_cast<const float4*>(wp), m = *reinterpret_cast<const float4*>(mp),
           v = *reinterpret_cast<const float4*>(vp);
    auto one = [&](float& w1, float& m1, float& v1, float g1) {
        m1 = ADAM_B1 * m1 + ADAM_1MB1 * g1;
        v1 = ADAM_B2 * v1 + ADAM_1MB2 * g1 * g1;
        w1 = w1 - a_lr * m1 / (sqrtf(v1) + c_eps);
    };
    one(w.x, m.x, v.x, gr.x);
    one(w.y, m.y, v.y, gr.y);
    one(w.z, m.z, v.z, gr.z);
    one(w.w, m.w, v.w, gr.w);
    *reinterpret_cast<float4*>(mp) = m;
    *reinterpret_cast<float4*>(vp) = v;
    *reinterpret_cast<float4*>(wp) = w;
    return w;
}

// Four bf16 values rounded from x to p.
__device__ __forceinline__ void store_bf16x4(bf16* p, float4 x) {
    p[0] = __float2bfloat16_rn(x.x);
    p[1] = __float2bfloat16_rn(x.y);
    p[2] = __float2bfloat16_rn(x.z);
    p[3] = __float2bfloat16_rn(x.w);
}

// The folded Adam scalars of step t (float): the update of an element is
// -a_lr m / (sqrt(v) + c_eps); b**t as exp(t log b).
__device__ __forceinline__ void adam_scalars(float tstep, float lr, float& a_lr, float& c_eps) {
    float bc1 = 1.0f - expf(tstep * LOG_B1);
    float sb2 = sqrtf(1.0f - expf(tstep * LOG_B2));
    a_lr = lr * sb2 / bc1;
    c_eps = ADAM_EPS * sb2;
}

// ------------------------------------------------------- cluster exchange --
// In a cluster of cn > 1 blocks a stage writes the gradient rows that are not
// an H x H product (first layers, biases, w3, heads) and its misc sums to its
// exchange rows instead of the slot: S.x holds XM misc floats, then rows of H
// floats in the slot's own order of the stage's group of rows.  xflush adds
// the cluster's blocks' rows [r0, r0 + nrows) and misc values [0, nm) in rank
// order into the cluster's slot, dst(i, j) the place of elements j..j+3 of
// group row i (16-byte aligned) and dstm(i) that of misc value i: a block
// takes the columns [crank H / cn, (crank + 1) H / cn) of every row, rank 0
// the misc values.  It starts
// with a cluster barrier (every block's rows complete) and ends with one (no
// block reads them any more), so a block may write its rows again right
// after it.  xrows and xfloats give the layout.
// The tensor cores' weight gradient stages another block's samples in the
// rows from 0 on (xstaged floats, learner_mma.cuh): where that leaves the rows
// from od + 1 on alone (xmerge), the rows written before it (b2, w3, the
// heads) wait there and go with the first layer's in one flush, else they go
// in a flush before it.
constexpr int XM = 8;
template <int H>
__device__ float* xrows(const Bufs& S) { return S.x + XM; }
template <int H>
__host__ __device__ constexpr size_t xstaged() {
    constexpr int TS = 8 * row_groups(H);
    return (size_t)8 * H + 16 * (TS + 4);
}
template <int H>
__host__ __device__ constexpr size_t xfloats(int rows) {
    // the group's rows, or the staging, whichever is larger
    const size_t group = (size_t)rows * H;
    return XM + (group > xstaged<H>() ? group : xstaged<H>());
}
template <int H, class T>
__device__ bool xmerge(int od) {
    return !T::MMA || xstaged<H>() <= (size_t)(od + 1) * H;
}

template <int H, class Dst, class DstM>
__device__ __noinline__ void xflush(Bufs S, int r0, int nrows, Dst dst, int nm, DstM dstm,
                                    bool first) {
    constexpr int U = 4;      // float4 sums a thread gathers before it stores them
    cluster_sync();
    const int w4 = H / 4 / S.cn, j0 = S.crank * 4 * w4, n4 = nrows * w4;
    const float* rows = xrows<H>(S);
    for (int base = threadIdx.x; base < n4; base += U * blockDim.x) {
        float4 v[U];
#pragma unroll
        for (int u = 0; u < U; u++) {
            const int idx = base + u * blockDim.x;
            v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (idx >= n4) continue;
            const size_t o = (size_t)(r0 + idx / w4) * H + j0 + idx % w4 * 4;
            for (int c = 0; c < S.cn; c++) {
                const float4 x = *reinterpret_cast<const float4*>(peer(rows, c) + o);
                v[u].x += x.x; v[u].y += x.y; v[u].z += x.z; v[u].w += x.w;
            }
        }
#pragma unroll
        for (int u = 0; u < U; u++) {
            const int idx = base + u * blockDim.x;
            if (idx >= n4) continue;
            float4* d = reinterpret_cast<float4*>(dst(r0 + idx / w4, j0 + idx % w4 * 4));
            if (!first) {
                const float4 o = *d;
                v[u].x += o.x; v[u].y += o.y; v[u].z += o.z; v[u].w += o.w;
            }
            *d = v[u];
        }
    }
    if (S.crank == 0 && (int)threadIdx.x < nm) {
        float v = 0.f;
        for (int c = 0; c < S.cn; c++) v += peer(S.x, c)[threadIdx.x];
        put(dstm(threadIdx.x), v, first);
    }
    cluster_sync();
}

// ---------------------------------------------------------------- forward --
// An actor's operands: its rows of `w` (wh: the NH rows of head^T) and `vec`
// (bh: the head's biases in the misc row); w1b and w2b its W1 and W2 in the
// bf16 shadow, where the tensor cores read them.
struct ActorRefs {
    const float *w1, *w2, *wh, *b1, *b2, *bh;
    const bf16 *w1b = nullptr, *w2b = nullptr;
};

// One critic's operands: its rows of `w` and `vec`; w2t, the transposed copy
// of its W2, only where it is trained; w1b and w2b as for the actor.
struct CriticRefs {
    const float *w1, *w2, *w2t, *b1, *b2, *w3;
    float b3;
    const bf16 *w1b = nullptr, *w2b = nullptr;
};

// head (NH, TS) = the actor's head outputs on xin's od rounded obs rows.  h1
// stays in A and h2 in Bm, and both go to `stash` ((2, TS, H) in device memory)
// where given.  Ends with a block barrier.
template <int H, int NH, class T>
__device__ void actor_forward(T& t, const Bufs& S, const ActorRefs& ar, int od, int bf,
                              float* head, float* stash) {
    constexpr int TS = Tile<H>::TS;
    t.first(S, ar.w1, ar.w1b, od, od, bf);
    phase(M_FIRST);
    t.relu(ar.b1, S.A, bf, stash);
    phase(M_RELU1);
    t.fwd(S, S.A, ar.w2, ar.w2b, bf);
    phase(M_W2);
    t.relu(ar.b2, S.Bm, bf, stash ? stash + TS * H : nullptr);
    __syncthreads();
    phase(M_RELU2);
    float bh[NH];
    for (int e = 0; e < NH; e++) bh[e] = ar.bh[e];
    t.row_dots(S.Bm, ar.wh, H, bh, bf, head);
    __syncthreads();
    phase(M_DOTS);
}

// q (TS,) = one critic on xin = (od rounded obs rows | 2 action rows): the obs
// rows go through the rounded product, the action rows and the bias stay
// float32.  h1 stays in A and h2 in Bm.  Ends without a barrier.
template <int H, class T>
__device__ void critic_forward(T& t, const Bufs& S, const CriticRefs& cr, int od, int bf,
                               float* q) {
    t.first(S, cr.w1, cr.w1b, od + 2, od, bf);
    phase(M_FIRST);
    t.relu(cr.b1, S.A, bf, nullptr);
    phase(M_RELU1);
    t.fwd(S, S.A, cr.w2, cr.w2b, bf);
    phase(M_W2);
    t.relu(cr.b2, S.Bm, bf, nullptr);
    __syncthreads();
    phase(M_RELU2);
    const float b3[1] = {cr.b3};
    t.row_dots(S.Bm, cr.w3, H, b3, bf, q);
    phase(M_DOTS);
}

// ---------------------------------------------------------------- critic --
// One critic's forward on xin = (obs rounded | action) and its hand-written
// backward against the target tq, over one tile.  Gradient rows in pc: [0, n1)
// W1 (obs rows then the two action rows), n1 b1, n1+1 b2, n1+2 w3, [n1+3,
// n1+3+H) W2; pm[0] takes the b3 gradient and pm[2] the loss sum.  q, dq and
// lsum are (TS,) scratch.  The obs rows go through the rounded product, the
// action rows, the bias and dq x w3 stay float32.  Only the tile's first nv
// samples are real: the others get dq = 0 and no loss, so they add nothing.
// In a cluster (S.cn > 1) the rows [0, n1 + 3) and pm's two values go through
// the exchange rows (xflush; pm[0] and pm[2] as misc values 0 and 1).
template <int H, class T>
__device__ void critic_grad(T& t, const Bufs& S, const CriticRefs& cr, const float* tq,
                            float* q, float* dq, float* lsum, float* pc, float* pm, int od, int B,
                            int bf, bool first, int nv) {
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    const int n1 = od + 2, tid = threadIdx.x;
    const float invb = (float)(1.0 / B);
    const bool xc = S.cn > 1;
    float* gr = xc ? xrows<H>(S) : pc;    // where the rows [0, n1 + 3) go
    const bool gfirst = xc || first;
    auto in_slot = [=](int i, int j) { return pc + (size_t)i * H + j; };
    critic_forward<H>(t, S, cr, od, bf, q);
    __syncthreads();
    if (tid < TS) {
        const bool real = tid < nv;
        float d = q[tid] - tq[tid];
        dq[tid] = real ? 2.0f * d * invb : 0.f;
        lsum[tid] = real ? d * d * invb : 0.f;
    }
    __syncthreads();
    phase(M_DQ);
    // w3 and b2 gradients; h2 becomes dz2 in place
    for (int j = tid; j < H; j += NT) {
        float w3j = cr.w3[j], gw3 = 0.f, gb2 = 0.f;
        for (int s = 0; s < TS; s++) {
            float h = S.Bm[T::ix(s, j)];
            gw3 += rnd(dq[s], bf) * h;
            float dz = h > 0.f ? dq[s] * w3j : 0.f;
            gb2 += dz;
            S.Bm[T::ix(s, j)] = rnd(dz, bf);
        }
        put(gr + (size_t)(n1 + 2) * H + j, gw3, gfirst);
        put(gr + (size_t)(n1 + 1) * H + j, gb2, gfirst);
    }
    if (tid < 32) {
        float gb3 = tile_sum<TS>(dq), ls = tile_sum<TS>(lsum);
        if (tid == 0) {
            put(xc ? S.x : pm, gb3, gfirst);
            put(xc ? S.x + 1 : pm + 2, ls, gfirst);
        }
    }
    __syncthreads();
    phase(M_W3B2);
    auto misc = [=](int i) { return pm + 2 * i; };
    const bool merge = xmerge<H, T>(od);
    if (xc && !merge) {
        xflush<H>(S, n1 + 1, 2, in_slot, 2, misc, first);
        phase(M_XCHG);
    }
    t.wgrad(S, S.A, S.Bm, pc + (size_t)(n1 + 3) * H, first);
    phase(M_W2GRAD);
    t.bwd(S, S.Bm, cr.w2t, cr.w2b, bf);
    phase(M_BWD);
    t.masked_inplace(S.A);      // dz1
    __syncthreads();
    phase(M_DZ1);
    // W1 and b1 gradients: obs rows through the rounded product, action
    // rows and bias in float32
    t.w1grad(S, gr, n1, od, bf, gfirst);
    __syncthreads();
    phase(M_W1B1);
    if (xc) {
        xflush<H>(S, 0, merge ? n1 + 3 : n1 + 1, in_slot, merge ? 2 : 0, misc, first);
        phase(M_XCHG);
    }
}

// Adam on both critics from the nslots partial slots summed in index order,
// and with POLYAK the targets' polyak step from the new weights; the whole
// grid takes part.  A slot holds critic 0's CS = n1 + 3 + H rows, critic 1's, and a row
// with the two b3 gradients [0, 2) and the two loss sums [2, 4); the critic
// loss of update k goes to losses[2 k].  The new W2 goes to the transposed
// copy `wt`; in bf16 mode (BF) the new W1 obs rows and W2 of the critics, and
// with POLYAK of the targets, go to the bf16 shadow `wb` (rows as in `w`)
// instead, and a thread takes four neighbouring elements (slot_sum4, adam4).
// Without POLYAK (TD3, whose targets move only on delayed updates) neither
// the targets nor their shadow rows are written here.
template <int H, class LY, bool POLYAK, bool BF = false, class Args>
__device__ void critic_apply(const Args& g, int k, int grid, int nslots, float a_lr, float c_eps) {
    const int n1 = g.od + 2, CS = n1 + 3 + H, prows = 2 * CS + 1;
    const float tau = g.tau, omt = 1.0f - g.tau;
    const size_t slot = (size_t)prows * H;
    const int total = 2 * CS * H;
    // where element (c, lr, j) of the slots' row layout lives: the weight, its
    // moments and its target
    auto where = [&](int c, int lr, int j, float*& wp, float*& mp, float*& vp, float*& tp) {
        if (lr < n1 || lr >= n1 + 3) {
            int row = lr < n1 ? lr : IN1 + lr - (n1 + 3);
            size_t o = (size_t)(LY::r_cw1(c) + row) * H + j;
            wp = g.w + o; mp = g.mw + o; vp = g.vw + o;
            tp = g.w + (size_t)(LY::r_tw1(c) + row) * H + j;
        } else {
            int vr = lr == n1 ? LY::V_CB1 : lr == n1 + 1 ? LY::V_CB2 : LY::V_CW3;
            int tr = lr == n1 ? LY::V_TB1 : lr == n1 + 1 ? LY::V_TB2 : LY::V_TW3;
            size_t o = (size_t)(vr + c) * H + j;
            wp = g.vec + o; mp = g.mvec + o; vp = g.vvec + o;
            tp = g.vec + (size_t)(tr + c) * H + j;
        }
    };
    if constexpr (BF) {
        for (int e = 4 * (blockIdx.x * blockDim.x + threadIdx.x); e < total;
             e += 4 * grid * blockDim.x) {
            int c = e / (CS * H), lr = (e / H) % CS, j = e % H;
            float4 gr = slot_sum4(g.partials + (size_t)(c * CS + lr) * H + j, nslots, slot);
            float *wp, *mp, *vp, *tp;
            where(c, lr, j, wp, mp, vp, tp);
            const float4 wn = adam4(wp, mp, vp, gr, a_lr, c_eps);
            float4 t = wn;
            if (POLYAK) {
                t = *reinterpret_cast<const float4*>(tp);
                t.x = omt * t.x + tau * wn.x;
                t.y = omt * t.y + tau * wn.y;
                t.z = omt * t.z + tau * wn.z;
                t.w = omt * t.w + tau * wn.w;
                *reinterpret_cast<float4*>(tp) = t;
            }
            if (lr < g.od || lr >= n1 + 3) {
                int row = lr < n1 ? lr : IN1 + lr - (n1 + 3);
                store_bf16x4(g.wb + (size_t)(LY::r_cw1(c) + row) * H + j, wn);
                if (POLYAK) store_bf16x4(g.wb + (size_t)(LY::r_tw1(c) + row) * H + j, t);
            }
        }
    } else {
        // element (c, lr, j), its summed gradient gr
        auto apply = [&](int c, int lr, int j, float gr) {
            float *wp, *mp, *vp, *tp;
            where(c, lr, j, wp, mp, vp, tp);
            float wn = adam_elem(wp, mp, vp, gr, a_lr, c_eps);
            if (POLYAK) *tp = omt * *tp + tau * wn;
            if (lr >= n1 + 3) g.wt[(size_t)c * H * H + (size_t)j * H + (lr - (n1 + 3))] = wn;
        };
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += grid * blockDim.x) {
            int c = e / (CS * H), lr = (e / H) % CS, j = e % H;
            const float* p = g.partials + (size_t)(c * CS + lr) * H + j;
            float gr = 0.f;
            for (int b = 0; b < nslots; b++) gr += p[b * slot];
            apply(c, lr, j, gr);
        }
    }
    if (blockIdx.x == 0 && threadIdx.x < 3) {
        const float* pm = g.partials + (size_t)2 * CS * H;
        int c = threadIdx.x;
        if (c < 2) {
            float gr = 0.f;
            for (int b = 0; b < nslots; b++) gr += pm[b * slot + c];
            size_t o = (size_t)LY::V_MISC * H + LY::M_CB3 + c;
            float wn = adam_elem(g.vec + o, g.mvec + o, g.vvec + o, gr, a_lr, c_eps);
            if (POLYAK) {
                size_t ot = (size_t)LY::V_MISC * H + LY::M_TB3 + c;
                g.vec[ot] = omt * g.vec[ot] + tau * wn;
            }
        } else {
            float ls = 0.f;
            for (int b = 0; b < nslots; b++) ls += pm[b * slot + 2] + pm[b * slot + 3];
            g.losses[k * 2] = ls;
        }
    }
}

// ----------------------------------------------------------------- actor --
// The actor's backward over one tile from gh, the (NH, TS) gradients of the
// loss by its head's outputs.  h1 and h2 come back from `stash` ((2, TS, H) in
// device memory) into the two buffers; xin still holds the rounded obs rows;
// wh is the head's NH rows of `w`, w2t the transposed copy of the actor's
// W2 and w2b its bf16 shadow (the tile type reads one of them).  Gradient
// rows in part: [0, od) W1, od b1, od+1 b2, [od+2, od+2+NH)
// head^T, [od+2+NH, od+2+NH+H) W2; the row after them takes the head's bias
// gradients [0, NH).  In a cluster (S.cn > 1) the rows [0, od+2+NH) and the
// first nm values of that last row go through the exchange rows (xflush;
// the caller has put those from NH on in the misc values).  Ends with a block
// barrier.
template <int H, int NH, class T>
__device__ void actor_backward(T& t, const Bufs& S, const float* gh, const float* stash,
                               const float* wh, const float* w2t, float* part, int od, int bf,
                               bool first, int nm, const bf16* w2b = nullptr) {
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    const int tid = threadIdx.x;
    const bool xc = S.cn > 1;
    float* gr = xc ? xrows<H>(S) : part;    // where the rows [0, od + 2 + NH) go
    const bool gfirst = xc || first;
    float* pm = part + (size_t)(od + 2 + NH + H) * H;
    auto in_slot = [=](int i, int j) { return part + (size_t)i * H + j; };
    // the actor's activations back into the two buffers
    for (int idx = tid; idx < TS * H / 4; idx += NT) {
        int o = T::ix(idx / (H / 4), idx % (H / 4) * 4);
        *reinterpret_cast<float4*>(S.A + o) = reinterpret_cast<const float4*>(stash)[idx];
        *reinterpret_cast<float4*>(S.Bm + o) = reinterpret_cast<const float4*>(stash + TS * H)[idx];
    }
    __syncthreads();
    phase(A_STASH);
    // head and b2 gradients; h2 becomes dz2 in place
    for (int j = tid; j < H; j += NT) {
        float whj[NH], gwh[NH], gb2 = 0.f;
#pragma unroll
        for (int e = 0; e < NH; e++) {
            whj[e] = rnd(wh[(size_t)e * H + j], bf);
            gwh[e] = 0.f;
        }
        for (int s = 0; s < TS; s++) {
            float h = S.Bm[T::ix(s, j)], dh = 0.f;
#pragma unroll
            for (int e = 0; e < NH; e++) {
                float ge = rnd(gh[e * TS + s], bf);
                gwh[e] += ge * h;
                dh += ge * whj[e];
            }
            float dz = h > 0.f ? dh : 0.f;
            gb2 += dz;
            S.Bm[T::ix(s, j)] = rnd(dz, bf);
        }
#pragma unroll
        for (int e = 0; e < NH; e++) put(gr + (size_t)(od + 2 + e) * H + j, gwh[e], gfirst);
        put(gr + (size_t)(od + 1) * H + j, gb2, gfirst);
    }
    if (tid < 32) {
        for (int e = 0; e < NH; e++) {
            float v = tile_sum<TS>(gh + e * TS);
            if (tid == 0) put((xc ? S.x : pm) + e, v, gfirst);
        }
    }
    __syncthreads();
    phase(A_HEAD);
    auto misc = [=](int i) { return pm + i; };
    const bool merge = xmerge<H, T>(od);
    if (xc && !merge) {
        xflush<H>(S, od + 1, 1 + NH, in_slot, nm, misc, first);
        phase(A_XCHG);
    }
    t.wgrad(S, S.A, S.Bm, part + (size_t)(od + 2 + NH) * H, first);
    phase(A_W2GRAD);
    t.bwd(S, S.Bm, w2t, w2b, bf);
    phase(A_BWD);
    t.masked_inplace(S.A);      // dz1
    __syncthreads();
    phase(A_DZ1);
    t.w1grad(S, gr, od, od, bf, gfirst);
    __syncthreads();
    phase(A_W1B1);
    if (xc) {
        xflush<H>(S, 0, merge ? od + 2 + NH : od + 1, in_slot, merge ? nm : 0, misc, first);
        phase(A_XCHG);
    }
}

// ------------------------------------------------------------------ host --
// The launch of a learner kernel of nt threads a block: out[0] the grid,
// out[1] the dynamic shared memory, out[2] the cluster size C.  kern1 is the
// kernel's instantiation without clusters, which C = 1 launches, and kernx
// the one with them; smem1 is the kernel's shared memory alone, smemx with
// the exchange rows that a cluster of C > 1 needs.  The grid of C = 1 is
// min(n_tiles, resident blocks); a cluster size C of 8, 4 or 2 (at most
// cmax; the first that passes) is taken where the card holds enough clusters
// of C blocks for a grid, a multiple of C, that gives no block more tiles
// than that, whose
// clusters' blocks all hold as many tiles (so they take the same cluster
// barriers), where H / C is a multiple of 32 (a warp's rows of a weight
// gradient) and where smemx fits.  -2: the shared memory does not fit.
template <class K>
int plan_launch(K kern1, K kernx, int nt, int H, size_t smem1, size_t smemx, int n_tiles,
                int cmax, int* out) {
    int dev = 0, sms = 0, optin = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem1 > (size_t)optin) return -2;
    const bool room = smemx <= (size_t)optin && cmax > 1;
    e = cudaFuncSetAttribute(kern1, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
    if (e == cudaSuccess && room)
        e = cudaFuncSetAttribute(kernx, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smemx);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern1, nt, smem1);
    if (e != cudaSuccess) return (int)e;
    const int resident = per_sm * sms;
    if (resident < 1) return -2;
    int grid = n_tiles < resident ? n_tiles : resident, C = 1;
    const int most = (n_tiles + grid - 1) / grid;   // tiles a block at C = 1
    for (int c = 8; c > 1 && room; c /= 2) {
        if (c > cmax || H % (32 * c)) continue;
        cudaLaunchAttribute at[1];
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = c;
        at[0].val.clusterDim.y = 1;
        at[0].val.clusterDim.z = 1;
        // gridDim, blockDim, dynamicSmemBytes, stream, attrs, numAttrs
        cudaLaunchConfig_t cfg = {dim3(c), dim3(nt), smemx, nullptr, at, 1};
        int clusters = 0;
        if (cudaOccupancyMaxActiveClusters(&clusters, kernx, &cfg) != cudaSuccess) {
            cudaGetLastError();
            continue;
        }
        const int gc = clusters * c < n_tiles / c * c ? clusters * c : n_tiles / c * c;
        if (gc < c || (n_tiles + gc - 1) / gc > most || (n_tiles % gc) % c) continue;
        grid = gc;
        C = c;
        break;
    }
    out[0] = grid;
    out[1] = (int)(C > 1 ? smemx : smem1);
    out[2] = C;
    return 0;
}

// A planned launch: cooperative (the grid barriers), kern1(args) where C = 1,
// else kernx(args) in clusters of C blocks.
template <class A>
int launch_planned(void (*kern1)(A), void (*kernx)(A), A args, int grid, int C, int nt,
                   size_t smem, cudaStream_t stream) {
    cudaError_t e;
    if (C == 1) {
        void* params[] = {&args};
        e = cudaLaunchCooperativeKernel((void*)kern1, dim3(grid), dim3(nt), params, smem, stream);
    } else {
        cudaLaunchAttribute at[2];
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = C;
        at[0].val.clusterDim.y = 1;
        at[0].val.clusterDim.z = 1;
        at[1].id = cudaLaunchAttributeCooperative;
        at[1].val.cooperative = 1;
        cudaLaunchConfig_t cfg = {dim3(grid), dim3(nt), smem, stream, at, 2};
        e = cudaLaunchKernelEx(&cfg, kernx, args);
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// A launch with the grid and cluster size that the kernel's plan gave:
// plan(n_tiles, cmax, out) is asked again with the cluster size as cmax.
// Launch errors: -4 not the planned grid or cluster size, -5 no scratch for
// the mode (wt in float32, wb in bf16).
template <int H, bool BF, class Plan, class A>
int launch_checked(Plan plan, void (*kern1)(A), void (*kernx)(A), const A& g, int grid,
                   int cluster, cudaStream_t stream) {
    int out[3];
    const int err = plan(n_tiles(g.lanes, g.rpb, Tile<H>::TS), cluster, out);
    if (err != 0) return err;
    if (grid != out[0] || cluster != out[2]) return -4;
    if ((BF && !g.wb) || (!BF && !g.wt)) return -5;
    return launch_planned(kern1, kernx, g, grid, cluster, Tile<H>::NT, (size_t)out[1], stream);
}

// f(std::integral_constant<int, H>()) for a hidden width the learner kernels
// are built for; -1 for any other.
template <class F>
int dispatch_width(int H, F f) {
    switch (H) {
        case 128: return f(std::integral_constant<int, 128>());
        case 256: return f(std::integral_constant<int, 256>());
        case 384: return f(std::integral_constant<int, 384>());
        case 512: return f(std::integral_constant<int, 512>());
    }
    return -1;
}

}  // namespace tiles

// The phase clock's two C entry points, for a library built with it:
// `sg_phase_read(out)` copies the 256 counters out and zeroes them;
// `sg_phase_name(i, out, n)` writes "site: mark" of id i into out[0, n), from
// the kernel's site list SITES (X(id, name, marks), namespace NS).
#ifdef SG_PHASE_CLOCK
#include <cstdio>
#define SG_SITE_CASE(id, name, marks)                                                      \
    case id: {                                                                             \
        static const char* const m[] = {marks(SG_MARK_NAME)};                              \
        return snprintf(out, n, "%s: %s", name,                                            \
                        mark < (int)(sizeof m / sizeof *m) ? m[mark] : "?");               \
    }
#define SG_PHASE_ENTRIES(NS, SITES)                                                        \
    extern "C" int sg_phase_read(unsigned long long* out) {                                \
        cudaError_t e = cudaMemcpyFromSymbol(out, tiles::sg_phase_cycles,                  \
                                             sizeof(tiles::sg_phase_cycles));              \
        if (e != cudaSuccess) return (int)e;                                               \
        static const unsigned long long zero[256] = {};                                    \
        return (int)cudaMemcpyToSymbol(tiles::sg_phase_cycles, zero, sizeof(zero));        \
    }                                                                                      \
    extern "C" int sg_phase_name(int i, char* out, int n) {                                \
        using namespace NS;                                                                \
        const int mark = i % 16;                                                           \
        switch (i / 16) { SITES(SG_SITE_CASE) }                                            \
        return snprintf(out, n, "%d", i);                                                  \
    }
#else
#define SG_PHASE_ENTRIES(NS, SITES)
#endif
