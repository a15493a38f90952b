// K SAC updates in one cooperative kernel launch: the device code shared by
// K4 (sac_update.cu, FOLD = false) and K5 (sac_update_fold.cu, FOLD = true).
//
// Replaces the Pallas kernels of space_gym_tpu/models/fused_sac.py: K4 the
// (K, 2, T) grid kernel at :759, K5 the folded (K,) grid kernels at :852 and
// :866.  What is computed is fused_sac.py::_make_bodies: per update, the twin
// critics' TD loss with a hand-written backward, Adam and polyak; then the
// tanh-Gaussian actor's loss and backward against the UPDATED critics, Adam
// on the actor and on the temperature.  The plain version is
// models/fused_sac.py::update_k_reference.
//
// Design for this card.  The work is a chain of (batch, H) x (H, H) products
// (16 per sample and update), about 5.8e11 float operations per launch at
// K=32, B=8192, H=256: operations bound it, not bytes.  The batch is spread
// over the SMs: a thread block owns tiles of TS samples, holds two (TS, H)
// activation buffers in shared memory and streams the weights in chunks of KC
// rows from L2, where the whole state (2 MB of weights, 4 MB of moments at
// H=256) stays for all K updates.  Every product is computed here, in float32
// multiply-adds on the CUDA cores, each thread an 8 x 8 tile of the output.
//
// Order across the batch: gradients are sums over all B samples, and the
// actor phase must see the critics that the critic phase updated.  So the
// launch is cooperative and an update is four stages with a grid-wide barrier
// after each: critic tiles -> critic Adam + polyak -> actor tiles -> actor
// and temperature Adam.
//
// Deterministic sums: a block writes the gradient of its own tiles to its own
// slot of `partials` (no atomics); the Adam stage sums the slots in index
// order.  The result is a function of the inputs and of the grid size only.
//
// The transposed products (dz2 . W2^T) read a transposed copy of the three
// trainable W2 matrices (`wt`), built at the start of the launch and kept
// current by the Adam stage, so every weight chunk is a run of whole rows.
//
// The critics' first-layer bias is added plainly (the TPU kernels fold it
// into a weight row for the launch's duration); w, vec and the moments come
// back in the JAX layout.
//
// mm_bf16 (args.bf): the operands of the products that the Pallas body sends
// through `dot`/`dg`, and the post-ReLU activations, are rounded to bfloat16
// and accumulated in float32, still on the CUDA cores; the products it sends
// through `_dg` (action rows and bias of the first layers, dq x w3) stay
// float32.
//
// FOLD: K4 loads a tile's W data rows and noise from device memory in each
// of the two phases.  K5 owns one tile per block, loads it once per update
// into one of two shared-memory buffers, keeps it for both phases, and starts
// the copy of the next update's tile (cp.async) before it computes this one.
// The arithmetic and its order are the same, so are the bits.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace sac {

constexpr int IN1 = 128;
constexpr int NHEAD = 4;
constexpr int KC = 16;        // weight rows per shared-memory chunk
constexpr int NSMALL = 28;    // per-sample scalar arrays in shared memory
constexpr float LOG_STD_MIN = -20.0f;
constexpr float LOG_STD_MAX = 2.0f;
constexpr float ADAM_B1 = 0.9f;
constexpr float ADAM_B2 = 0.999f;
constexpr float ADAM_1MB1 = (float)(1.0 - 0.9);
constexpr float ADAM_1MB2 = (float)(1.0 - 0.999);
constexpr float ADAM_EPS = 1e-8f;
constexpr float LOG_B1 = -0.10536051565782628f;    // log(0.9)
constexpr float LOG_B2 = -0.0010005003335835344f;  // log(0.999)
constexpr float LOG2PI = 1.8378770664093453f;
constexpr float LOG2 = 0.6931471805599453f;

// vec rows and misc columns (fused_sac.py:343-358)
constexpr int V_AB1 = 0, V_AB2 = 1, V_CB1 = 2, V_CB2 = 4, V_TB1 = 6, V_TB2 = 8;
constexpr int V_CW3 = 10, V_TW3 = 12, V_MISC = 14;
constexpr int M_ABH = 0, M_CB3 = 4, M_TB3 = 6, M_LA = 8;

struct Args {
    float *w, *vec, *mw, *vw, *mvec, *vvec;   // state, updated in place
    const float* data;     // (K, W, B) minibatches, or the (rows, W, lanes) ring
    const int* row_idx;    // (K * rpb,) ring rows, unused when rpb == 0
    const float* noise;    // (K, 4, B)
    float* losses;         // (K, 2)
    float* partials;       // (grid, prows, H) per-block gradient sums
    float* wt;             // (3, H, H) transposed W2 of critic 0, critic 1, actor
    float* stash;          // (n_tiles, 2, TS, H) the actor's activations
    int K, B, W, lanes, rpb, od, bf, has_floor;
    float gamma, tau, lr, te, count0, logfloor;
};

template <int H>
struct Lay {
    static constexpr int R_AW1 = 0;
    static constexpr int R_AW2 = IN1;
    static constexpr int R_AWH = IN1 + H + 4 * (IN1 + H);
    __host__ __device__ static constexpr int r_cw1(int c) { return IN1 + H + c * (IN1 + H); }
    __host__ __device__ static constexpr int r_tw1(int c) { return IN1 + H + (2 + c) * (IN1 + H); }
};

__host__ __device__ constexpr int row_groups(int H) { return H <= 128 ? 16 : H <= 256 ? 8 : 4; }
__host__ __device__ constexpr int ceil8(int x) { return (x + 7) / 8 * 8; }

template <int H, bool FOLD>
__host__ __device__ constexpr size_t smem_floats(int W) {
    constexpr int TS = 8 * row_groups(H);
    return (size_t)2 * TS * H + KC * H + (FOLD ? 2 : 1) * (W * TS + 4 * TS) + W * TS
           + NSMALL * TS + 4 * TS * (H / 32) + 32;
}

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

__device__ __forceinline__ float softplus(float x) {
    return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// One thread's 8 x 8 tile of a (TS, H) output: rows ty*8 + i, columns
// tx*4 + j (j < 4) and H/2 + tx*4 + j - 4 (j >= 4).
template <int H>
struct Tile {
    static constexpr int RG = row_groups(H);
    static constexpr int TS = 8 * RG;
    static constexpr int NT = (H / 8) * RG;
    float acc[8][8];
    int tx, ty;
    __device__ Tile() : tx(threadIdx.x % (H / 8)), ty(threadIdx.x / (H / 8)) {}
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

// out (+)= A^T . Bm over the tile's samples: a weight gradient.  A and Bm are
// (TS, H) in shared memory, out is (H, H) in this block's partial slot.
// Needs a block barrier before; reads shared memory only.
template <int H>
__device__ void gemm_wgrad(Tile<H>& t, const float* A, const float* Bm, float* out, bool first) {
    constexpr int TS = Tile<H>::TS;
    for (int i0 = t.ty * 8; i0 < H; i0 += TS) {
        t.zero();
#pragma unroll 4
        for (int s = 0; s < TS; s++) {
            float4 a0 = *reinterpret_cast<const float4*>(A + s * H + i0);
            float4 a1 = *reinterpret_cast<const float4*>(A + s * H + i0 + 4);
            float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            t.fma_row(a, *reinterpret_cast<const float4*>(Bm + s * H + t.tx * 4),
                      *reinterpret_cast<const float4*>(Bm + s * H + H / 2 + t.tx * 4));
        }
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

// Sum of x[0..TS) by warp 0, the same value in all its lanes.
template <int TS>
__device__ float tile_sum(const float* x) {
    float v = 0.f;
    for (int s = threadIdx.x % 32; s < TS; s += 32) v += x[s];
    return warp_sum(v);
}

__device__ __forceinline__ void put(float* p, float v, bool first) { *p = first ? v : *p + v; }

// The tanh-Gaussian sample of one action component (fused_sac.py:560-568).
__device__ __forceinline__ void sample1(float mean, float lsr, float eps, float& a, float& lp,
                                        float& pre, float& stdv) {
    float ls = fminf(fmaxf(lsr, LOG_STD_MIN), LOG_STD_MAX);
    stdv = expf(ls);
    pre = mean + stdv * eps;
    a = tanhf(pre);
    lp = -0.5f * (eps * eps + 2.0f * ls + LOG2PI);
    lp = lp - 2.0f * (LOG2 - pre - softplus(-2.0f * pre));
}

// cp.async in 16-byte pieces, its group commit and its wait for all but the
// newest `N` groups.  Under a host compiler (no __CUDACC__: the kernel's logic
// run on the CPU against stand-in headers) the copy is synchronous.
#ifdef __CUDACC__
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
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
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
#endif

// Where tile t of minibatch k starts in `data`, and its row stride: in ring
// mode lane block (t*TS) % lanes of ring row row_idx[k*rpb + (t*TS) / lanes].
template <int TS>
__device__ const float* tile_base(const Args& g, int k, int t, int& ld) {
    int b0 = t * TS;
    if (g.rpb == 0) {
        ld = g.B;
        return g.data + (size_t)k * g.W * g.B + b0;
    }
    int row = g.row_idx[k * g.rpb + b0 / g.lanes];
    ld = g.lanes;
    return g.data + (size_t)row * g.W * g.lanes + b0 % g.lanes;
}

// Copy a tile's W data rows and 4 noise rows into shared memory: plain loads
// (K4) or cp.async (K5, completed by the caller).
template <int TS, bool ASYNC>
__device__ void load_tile(const Args& g, int k, int t, float* xs, float* nz) {
    int ld;
    const float* base = tile_base<TS>(g, k, t, ld);
    const float* nbase = g.noise + (size_t)k * 4 * g.B + t * TS;
    int n_data = g.W * TS / 4;
    for (int idx = threadIdx.x; idx < n_data + TS; idx += blockDim.x) {
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
}

// Rows [r0, r0 + n) of the tile -> rows [d0, d0 + n) of xin, rounded in bf mode.
template <int TS>
__device__ void copy_rows(const float* xs, int r0, float* xin, int d0, int n, int bf) {
    for (int idx = threadIdx.x; idx < n * TS; idx += blockDim.x)
        xin[d0 * TS + idx] = rnd(xs[r0 * TS + idx], bf);
}

struct Smem {
    float *A, *Bm, *wch, *xs[2], *nz[2], *xin, *sm;
    unsigned* mask;
};

template <int H, bool FOLD>
__device__ Smem carve(float* base, int W) {
    constexpr int TS = Tile<H>::TS;
    Smem s;
    s.A = base; base += TS * H;
    s.Bm = base; base += TS * H;
    s.wch = base; base += KC * H;
    for (int i = 0; i < (FOLD ? 2 : 1); i++) {
        s.xs[i] = base; base += W * TS;
        s.nz[i] = base; base += 4 * TS;
    }
    if (!FOLD) { s.xs[1] = s.xs[0]; s.nz[1] = s.nz[0]; }
    s.xin = base; base += W * TS;
    s.sm = base; base += NSMALL * TS;
    s.mask = reinterpret_cast<unsigned*>(base);
    return s;
}

// ---------------------------------------------------------------- critic --
// Gradient rows of one critic in a block's partial slot: [0, n1) W1 (obs rows
// then the two action rows), n1 b1, n1+1 b2, n1+2 w3, [n1+3, n1+3+H) W2; the
// slot's row 2*(n1+3+H) holds b3 of both critics and their loss sums.
template <int H>
__device__ void critic_tile(const Args& g, const Smem& S, const float* xs, const float* nz,
                            float* part, bool first) {
    using L = Lay<H>;
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    const int od = g.od, n1 = od + 2, bf = g.bf, CS = n1 + 3 + H;
    const int n0 = ceil8(od), a0 = ceil8(n0 + od), rr = a0 + 2, dd = rr + 1;
    const float invb = (float)(1.0 / g.B);
    const float* misc = g.vec + V_MISC * H;
    const float alpha = expf(misc[M_LA]);
    float* na0 = S.sm; float* na1 = S.sm + TS; float* nlogp = S.sm + 2 * TS;
    float* qt = S.sm + 3 * TS;        // [2][TS]
    float* tq = S.sm + 5 * TS; float* q = S.sm + 6 * TS; float* dq = S.sm + 7 * TS;
    float* lsum = S.sm + 8 * TS;
    float* head = S.sm + 9 * TS;      // [4][TS]
    Tile<H> t;
    const int tid = threadIdx.x;

    // the actor on next_obs, sampled with the critic's normals
    copy_rows<TS>(xs, n0, S.xin, 0, od, bf);
    gemm_ks<H>(t, S.xin, g.w + L::R_AW1 * H, od, od, bf, S.wch);
    store_relu<H>(t, g.vec + V_AB1 * H, S.A, bf, nullptr);
    gemm_sk<H>(t, S.A, g.w + L::R_AW2 * H, bf, S.wch);
    store_relu<H>(t, g.vec + V_AB2 * H, S.Bm, bf, nullptr);
    __syncthreads();
    for (int e = 0; e < NHEAD; e++)
        row_dot<H>(S.Bm, g.w + (L::R_AWH + e) * H, misc[M_ABH + e], bf, head + e * TS);
    __syncthreads();
    if (tid < TS) {
        float a, lp0, lp1, pre, sd;
        sample1(head[tid], head[2 * TS + tid], nz[tid], a, lp0, pre, sd);
        na0[tid] = a;
        sample1(head[TS + tid], head[3 * TS + tid], nz[TS + tid], a, lp1, pre, sd);
        na1[tid] = a;
        nlogp[tid] = lp0 + lp1;
        S.xin[od * TS + tid] = na0[tid];
        S.xin[(od + 1) * TS + tid] = na1[tid];
    }
    // the target critics on (next_obs, next action)
    for (int c = 0; c < 2; c++) {
        gemm_ks<H>(t, S.xin, g.w + L::r_tw1(c) * H, n1, od, bf, S.wch);
        store_relu<H>(t, g.vec + (V_TB1 + c) * H, S.A, bf, nullptr);
        gemm_sk<H>(t, S.A, g.w + (L::r_tw1(c) + IN1) * H, bf, S.wch);
        store_relu<H>(t, g.vec + (V_TB2 + c) * H, S.Bm, bf, nullptr);
        __syncthreads();
        row_dot<H>(S.Bm, g.vec + (V_TW3 + c) * H, misc[M_TB3 + c], bf, qt + c * TS);
    }
    __syncthreads();
    if (tid < TS)
        tq[tid] = xs[rr * TS + tid] + g.gamma * xs[dd * TS + tid]
                  * (fminf(qt[tid], qt[TS + tid]) - alpha * nlogp[tid]);
    // the critics on (obs, action), forward and backward
    copy_rows<TS>(xs, 0, S.xin, 0, od, bf);
    copy_rows<TS>(xs, a0, S.xin, od, 2, 0);
    for (int c = 0; c < 2; c++) {
        float* pc = part + (size_t)c * CS * H;
        gemm_ks<H>(t, S.xin, g.w + L::r_cw1(c) * H, n1, od, bf, S.wch);
        store_relu<H>(t, g.vec + (V_CB1 + c) * H, S.A, bf, nullptr);
        gemm_sk<H>(t, S.A, g.w + (L::r_cw1(c) + IN1) * H, bf, S.wch);
        store_relu<H>(t, g.vec + (V_CB2 + c) * H, S.Bm, bf, nullptr);
        __syncthreads();
        row_dot<H>(S.Bm, g.vec + (V_CW3 + c) * H, misc[M_CB3 + c], bf, q);
        __syncthreads();
        if (tid < TS) {
            float d = q[tid] - tq[tid];
            dq[tid] = 2.0f * d * invb;
            lsum[tid] = d * d * invb;
        }
        __syncthreads();
        // w3 and b2 gradients; h2 becomes dz2 in place
        for (int j = tid; j < H; j += NT) {
            float w3j = g.vec[(V_CW3 + c) * H + j], gw3 = 0.f, gb2 = 0.f;
            for (int s = 0; s < TS; s++) {
                float h = S.Bm[s * H + j];
                gw3 += rnd(dq[s], bf) * h;
                float dz = h > 0.f ? dq[s] * w3j : 0.f;
                gb2 += dz;
                S.Bm[s * H + j] = rnd(dz, bf);
            }
            put(pc + (size_t)(n1 + 2) * H + j, gw3, first);
            put(pc + (size_t)(n1 + 1) * H + j, gb2, first);
        }
        if (tid < 32) {
            float gb3 = tile_sum<TS>(dq), ls = tile_sum<TS>(lsum);
            if (tid == 0) {
                float* pm = part + (size_t)2 * CS * H;
                put(pm + c, gb3, first);
                put(pm + 2 + c, ls, first);
            }
        }
        __syncthreads();
        gemm_wgrad<H>(t, S.A, S.Bm, pc + (size_t)(n1 + 3) * H, first);
        gemm_sk<H>(t, S.Bm, g.wt + (size_t)c * H * H, bf, S.wch);
        store_masked_inplace<H>(t, S.A);      // dz1
        __syncthreads();
        // W1 and b1 gradients: obs rows through the rounded product, action
        // rows and bias in float32
        for (int j = tid; j < H; j += NT) {
            float gb1 = 0.f;
            for (int s = 0; s < TS; s++) gb1 += S.A[s * H + j];
            put(pc + (size_t)n1 * H + j, gb1, first);
            for (int r0 = 0; r0 < n1; r0 += 8) {
                float ga[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
                for (int s = 0; s < TS; s++) {
                    float dz = S.A[s * H + j], dzr = rnd(dz, bf);
#pragma unroll
                    for (int i = 0; i < 8; i++)
                        if (r0 + i < n1) ga[i] += S.xin[(r0 + i) * TS + s] * (r0 + i < od ? dzr : dz);
                }
#pragma unroll
                for (int i = 0; i < 8; i++)
                    if (r0 + i < n1) put(pc + (size_t)(r0 + i) * H + j, ga[i], first);
            }
        }
        __syncthreads();
    }
}

// Adam on the critics from the summed partial slots, then polyak on the
// targets; the whole grid takes part.
template <int H>
__device__ void critic_apply(const Args& g, int k, int grid, float a_lr, float c_eps) {
    using L = Lay<H>;
    const int n1 = g.od + 2, CS = n1 + 3 + H, prows = 2 * CS + 1;
    const float tau = g.tau, omt = 1.0f - g.tau;
    const size_t slot = (size_t)prows * H;
    const int total = 2 * CS * H;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += grid * blockDim.x) {
        int c = e / (CS * H), lr = (e / H) % CS, j = e % H;
        const float* p = g.partials + (size_t)(c * CS + lr) * H + j;
        float gr = 0.f;
        for (int b = 0; b < grid; b++) gr += p[b * slot];
        float *wp, *mp, *vp, *tp;
        if (lr < n1 || lr >= n1 + 3) {
            int row = lr < n1 ? lr : IN1 + lr - (n1 + 3);
            size_t o = (size_t)(L::r_cw1(c) + row) * H + j;
            wp = g.w + o; mp = g.mw + o; vp = g.vw + o;
            tp = g.w + (size_t)(L::r_tw1(c) + row) * H + j;
        } else {
            int vr = lr == n1 ? V_CB1 : lr == n1 + 1 ? V_CB2 : V_CW3;
            int tr = lr == n1 ? V_TB1 : lr == n1 + 1 ? V_TB2 : V_TW3;
            size_t o = (size_t)(vr + c) * H + j;
            wp = g.vec + o; mp = g.mvec + o; vp = g.vvec + o;
            tp = g.vec + (size_t)(tr + c) * H + j;
        }
        float m = ADAM_B1 * *mp + ADAM_1MB1 * gr;
        float v = ADAM_B2 * *vp + ADAM_1MB2 * gr * gr;
        *mp = m; *vp = v;
        float wn = *wp - a_lr * m / (sqrtf(v) + c_eps);
        *wp = wn;
        *tp = omt * *tp + tau * wn;
        if (lr >= n1 + 3) g.wt[(size_t)c * H * H + (size_t)j * H + (lr - (n1 + 3))] = wn;
    }
    if (blockIdx.x == 0 && threadIdx.x < 3) {
        const float* pm = g.partials + (size_t)2 * CS * H;
        int c = threadIdx.x;
        if (c < 2) {
            float gr = 0.f;
            for (int b = 0; b < grid; b++) gr += pm[b * slot + c];
            size_t o = (size_t)V_MISC * H + M_CB3 + c;
            float m = ADAM_B1 * g.mvec[o] + ADAM_1MB1 * gr;
            float v = ADAM_B2 * g.vvec[o] + ADAM_1MB2 * gr * gr;
            g.mvec[o] = m; g.vvec[o] = v;
            float wn = g.vec[o] - a_lr * m / (sqrtf(v) + c_eps);
            g.vec[o] = wn;
            size_t ot = (size_t)V_MISC * H + M_TB3 + c;
            g.vec[ot] = omt * g.vec[ot] + tau * wn;
        } else {
            float ls = 0.f;
            for (int b = 0; b < grid; b++) ls += pm[b * slot + 2] + pm[b * slot + 3];
            g.losses[k * 2] = ls;
        }
    }
}

// ----------------------------------------------------------------- actor --
// Gradient rows of the actor in a block's partial slot: [0, od) W1, od b1,
// od+1 b2, [od+2, od+6) head^T, [od+6, od+6+H) W2; row od+6+H holds the head's
// bias gradients [0, 4), the loss sum [4] and the logp sum [5].
template <int H>
__device__ void actor_tile(const Args& g, const Smem& S, const float* xs, const float* nz,
                           float* part, float* stash, bool first) {
    using L = Lay<H>;
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    const int od = g.od, n1 = od + 2, bf = g.bf;
    const float invb = (float)(1.0 / g.B);
    const float* misc = g.vec + V_MISC * H;
    const float alpha = expf(misc[M_LA]);
    float* act = S.sm;               // [2][TS]
    float* pre = S.sm + 2 * TS;      // [2][TS]
    float* lsr = S.sm + 4 * TS;      // [2][TS]
    float* sdv = S.sm + 6 * TS;      // [2][TS]
    float* logp = S.sm + 8 * TS;
    float* qc = S.sm + 9 * TS;       // [2][TS]
    float* dq = S.sm + 11 * TS;
    float* lsum = S.sm + 12 * TS;
    float* da = S.sm + 13 * TS;      // [2][TS]
    float* head = S.sm + 15 * TS;    // [4][TS]
    float* gh = S.sm + 19 * TS;      // [4][TS]
    float* dav = S.sm + 23 * TS;     // [2][TS] one critic's share of da
    unsigned* m1[2] = {S.mask, S.mask + 2 * TS * (H / 32)};
    unsigned* m2[2] = {S.mask + TS * (H / 32), S.mask + 3 * TS * (H / 32)};
    Tile<H> t;
    const int tid = threadIdx.x;

    // the actor on obs, sampled with the actor's normals; h1, h2 are kept in
    // device memory (L2) while the critics use the two buffers
    copy_rows<TS>(xs, 0, S.xin, 0, od, bf);
    gemm_ks<H>(t, S.xin, g.w + L::R_AW1 * H, od, od, bf, S.wch);
    store_relu<H>(t, g.vec + V_AB1 * H, S.A, bf, stash);
    gemm_sk<H>(t, S.A, g.w + L::R_AW2 * H, bf, S.wch);
    store_relu<H>(t, g.vec + V_AB2 * H, S.Bm, bf, stash + TS * H);
    __syncthreads();
    for (int e = 0; e < NHEAD; e++)
        row_dot<H>(S.Bm, g.w + (L::R_AWH + e) * H, misc[M_ABH + e], bf, head + e * TS);
    __syncthreads();
    if (tid < TS) {
        float lp[2];
        for (int e = 0; e < 2; e++) {
            float a, p, sd;
            lsr[e * TS + tid] = head[(2 + e) * TS + tid];
            sample1(head[e * TS + tid], head[(2 + e) * TS + tid], nz[(2 + e) * TS + tid], a,
                    lp[e], p, sd);
            act[e * TS + tid] = a; pre[e * TS + tid] = p; sdv[e * TS + tid] = sd;
            S.xin[(od + e) * TS + tid] = a;
            da[e * TS + tid] = 0.f;
        }
        logp[tid] = lp[0] + lp[1];
    }
    // the updated critics on (obs, sampled action): q and the ReLU masks
    for (int c = 0; c < 2; c++) {
        gemm_ks<H>(t, S.xin, g.w + L::r_cw1(c) * H, n1, od, bf, S.wch);
        store_relu<H>(t, g.vec + (V_CB1 + c) * H, S.A, bf, nullptr);
        gemm_sk<H>(t, S.A, g.w + (L::r_cw1(c) + IN1) * H, bf, S.wch);
        store_relu<H>(t, g.vec + (V_CB2 + c) * H, S.Bm, bf, nullptr);
        __syncthreads();
        make_mask<H>(S.A, m1[c]);
        make_mask<H>(S.Bm, m2[c]);
        row_dot<H>(S.Bm, g.vec + (V_CW3 + c) * H, misc[M_CB3 + c], bf, qc + c * TS);
    }
    __syncthreads();
    if (tid < TS)
        lsum[tid] = (alpha * logp[tid] - fminf(qc[tid], qc[TS + tid])) * invb;
    // dL/da through the critic that gave the smaller q
    for (int c = 0; c < 2; c++) {
        __syncthreads();
        if (tid < TS) {
            bool pick0 = qc[tid] <= qc[TS + tid];
            dq[tid] = -invb * ((c == 0) == pick0 ? 1.0f : 0.0f);
        }
        __syncthreads();
        for (int j = tid; j < H; j += NT) {
            float w3j = g.vec[(V_CW3 + c) * H + j];
            for (int s = 0; s < TS; s++)
                S.Bm[s * H + j] = mask_bit(m2[c], s, j, H) ? rnd(dq[s] * w3j, bf) : 0.f;
        }
        gemm_sk<H>(t, S.Bm, g.wt + (size_t)c * H * H, bf, S.wch);
        store_masked_bits<H>(t, m1[c], S.A);       // dz1
        __syncthreads();
        for (int e = 0; e < 2; e++) {
            // only the action columns of the input gradient are needed
            int warp = tid / 32, lane = tid % 32;
            const float* wrow = g.w + (size_t)(L::r_cw1(c) + od + e) * H;
            for (int s = warp; s < TS; s += NT / 32) {
                float v = 0.f;
                for (int j = lane; j < H; j += 32) v += rnd(S.A[s * H + j], bf) * rnd(wrow[j], bf);
                v = warp_sum(v);
                if (lane == 0) dav[e * TS + s] = v;
            }
        }
        __syncthreads();
        if (tid < TS) {
            da[tid] += dav[tid];
            da[TS + tid] += dav[TS + tid];
        }
    }
    __syncthreads();
    // through tanh and the Gaussian to the head (fused_sac.py:693-699)
    if (tid < TS) {
        float dlogp = alpha * invb;
        for (int e = 0; e < 2; e++) {
            float a = act[e * TS + tid], p = pre[e * TS + tid], l = lsr[e * TS + tid];
            float sig = 1.0f / (1.0f + expf(2.0f * p));
            float dpre = da[e * TS + tid] * (1.0f - a * a) + dlogp * (2.0f - 4.0f * sig);
            float clip = (l > LOG_STD_MIN && l < LOG_STD_MAX) ? 1.0f : 0.0f;
            gh[e * TS + tid] = dpre;
            gh[(2 + e) * TS + tid] = (dpre * sdv[e * TS + tid] * nz[(2 + e) * TS + tid] - dlogp)
                                     * clip;
        }
    }
    // the actor's activations back into the two buffers
    for (int idx = tid; idx < TS * H / 4; idx += NT) {
        reinterpret_cast<float4*>(S.A)[idx] = reinterpret_cast<const float4*>(stash)[idx];
        reinterpret_cast<float4*>(S.Bm)[idx] = reinterpret_cast<const float4*>(stash + TS * H)[idx];
    }
    __syncthreads();
    // head and b2 gradients; h2 becomes dz2 in place
    for (int j = tid; j < H; j += NT) {
        float wh[NHEAD], gwh[NHEAD] = {0.f, 0.f, 0.f, 0.f}, gb2 = 0.f;
#pragma unroll
        for (int e = 0; e < NHEAD; e++) wh[e] = rnd(g.w[(size_t)(L::R_AWH + e) * H + j], bf);
        for (int s = 0; s < TS; s++) {
            float h = S.Bm[s * H + j], dh = 0.f;
#pragma unroll
            for (int e = 0; e < NHEAD; e++) {
                float ge = rnd(gh[e * TS + s], bf);
                gwh[e] += ge * h;
                dh += ge * wh[e];
            }
            float dz = h > 0.f ? dh : 0.f;
            gb2 += dz;
            S.Bm[s * H + j] = rnd(dz, bf);
        }
#pragma unroll
        for (int e = 0; e < NHEAD; e++) put(part + (size_t)(od + 2 + e) * H + j, gwh[e], first);
        put(part + (size_t)(od + 1) * H + j, gb2, first);
    }
    if (tid < 32) {
        float* pm = part + (size_t)(od + 6 + H) * H;
        for (int e = 0; e < NHEAD; e++) {
            float v = tile_sum<TS>(gh + e * TS);
            if (tid == 0) put(pm + e, v, first);
        }
        float ls = tile_sum<TS>(lsum), lp = tile_sum<TS>(logp);
        if (tid == 0) {
            put(pm + 4, ls, first);
            put(pm + 5, lp, first);
        }
    }
    __syncthreads();
    gemm_wgrad<H>(t, S.A, S.Bm, part + (size_t)(od + 6) * H, first);
    gemm_sk<H>(t, S.Bm, g.wt + (size_t)2 * H * H, bf, S.wch);
    store_masked_inplace<H>(t, S.A);      // dz1
    __syncthreads();
    for (int j = tid; j < H; j += NT) {
        float gb1 = 0.f;
        for (int s = 0; s < TS; s++) gb1 += S.A[s * H + j];
        put(part + (size_t)od * H + j, gb1, first);
        for (int r0 = 0; r0 < od; r0 += 8) {
            float ga[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
            for (int s = 0; s < TS; s++) {
                float dzr = rnd(S.A[s * H + j], bf);
#pragma unroll
                for (int i = 0; i < 8; i++)
                    if (r0 + i < od) ga[i] += S.xin[(r0 + i) * TS + s] * dzr;
            }
#pragma unroll
            for (int i = 0; i < 8; i++)
                if (r0 + i < od) put(part + (size_t)(r0 + i) * H + j, ga[i], first);
        }
    }
    __syncthreads();
}

// Adam on the actor and on the temperature from the summed partial slots.
template <int H>
__device__ void actor_apply(const Args& g, int k, int grid, float a_lr, float c_eps) {
    using L = Lay<H>;
    const int od = g.od, AS = od + 6 + H;
    const int prows = 2 * (od + 2 + 3 + H) + 1;
    const size_t slot = (size_t)prows * H;
    const int total = AS * H;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += grid * blockDim.x) {
        int lr = e / H, j = e % H;
        const float* p = g.partials + (size_t)lr * H + j;
        float gr = 0.f;
        for (int b = 0; b < grid; b++) gr += p[b * slot];
        float *wp, *mp, *vp;
        if (lr == od || lr == od + 1) {
            size_t o = (size_t)(lr == od ? V_AB1 : V_AB2) * H + j;
            wp = g.vec + o; mp = g.mvec + o; vp = g.vvec + o;
        } else {
            int row = lr < od ? L::R_AW1 + lr
                      : lr < od + 6 ? L::R_AWH + lr - (od + 2) : L::R_AW2 + lr - (od + 6);
            size_t o = (size_t)row * H + j;
            wp = g.w + o; mp = g.mw + o; vp = g.vw + o;
        }
        float m = ADAM_B1 * *mp + ADAM_1MB1 * gr;
        float v = ADAM_B2 * *vp + ADAM_1MB2 * gr * gr;
        *mp = m; *vp = v;
        float wn = *wp - a_lr * m / (sqrtf(v) + c_eps);
        *wp = wn;
        if (lr >= od + 6) g.wt[(size_t)2 * H * H + (size_t)j * H + (lr - (od + 6))] = wn;
    }
    if (blockIdx.x == 0 && threadIdx.x < 6) {
        const float* pm = g.partials + (size_t)AS * H;
        int c = threadIdx.x;
        float gr = 0.f;
        for (int b = 0; b < grid; b++) gr += pm[b * slot + c];
        if (c == 4) {
            g.losses[k * 2 + 1] = gr;
        } else {
            // c < 4: the head's bias; c == 5: the temperature, whose gradient
            // is -(mean logp + target entropy)
            size_t o = (size_t)V_MISC * H + (c < 4 ? M_ABH + c : M_LA);
            if (c == 5) gr = -(gr * (float)(1.0 / g.B) + g.te);
            float m = ADAM_B1 * g.mvec[o] + ADAM_1MB1 * gr;
            float v = ADAM_B2 * g.vvec[o] + ADAM_1MB2 * gr * gr;
            g.mvec[o] = m; g.vvec[o] = v;
            float wn = g.vec[o] - a_lr * m / (sqrtf(v) + c_eps);
            if (c == 5 && g.has_floor) wn = fmaxf(wn, g.logfloor);
            g.vec[o] = wn;
        }
    }
}

// ---------------------------------------------------------------- kernel --
template <int H, bool FOLD>
__global__ void __launch_bounds__(Tile<H>::NT, 1) sac_update_kernel(Args g) {
    using L = Lay<H>;
    constexpr int TS = Tile<H>::TS;
#ifdef __CUDACC__
    extern __shared__ __align__(16) float smem_base[];
#else
    float* smem_base = host_shared_memory();
#endif
    cg::grid_group grid = cg::this_grid();
    const int G = gridDim.x;
    const int n_tiles = g.B / TS;
    const int n1 = g.od + 2, prows = 2 * (n1 + 3 + H) + 1;
    Smem S = carve<H, FOLD>(smem_base, g.W);
    float* part = g.partials + (size_t)blockIdx.x * prows * H;

    // the transposed copies of the three trainable W2
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 3 * H * H; e += G * blockDim.x) {
        int m = e / (H * H), i = (e / H) % H, j = e % H;
        int row = (m < 2 ? L::r_cw1(m) + IN1 : L::R_AW2) + i;
        g.wt[(size_t)m * H * H + (size_t)j * H + i] = g.w[(size_t)row * H + j];
    }
    if (FOLD) {
        load_tile<TS, true>(g, 0, blockIdx.x, S.xs[0], S.nz[0]);
        cp_async_commit();
    }
    grid.sync();

    for (int k = 0; k < g.K; k++) {
        // per-update scalars (fused_sac.py:460-474); b**t as exp(t log b)
        float tstep = g.count0 + (float)k + 1.0f;
        float bc1 = 1.0f - expf(tstep * LOG_B1);
        float sb2 = sqrtf(1.0f - expf(tstep * LOG_B2));
        float a_lr = g.lr * sb2 / bc1, c_eps = ADAM_EPS * sb2;
        const int cur = FOLD ? (k & 1) : 0;
        if (FOLD) {
            // start the next update's copy, then wait for this update's
            if (k + 1 < g.K) {
                load_tile<TS, true>(g, k + 1, blockIdx.x, S.xs[cur ^ 1], S.nz[cur ^ 1]);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
        }
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            if (!FOLD) {
                __syncthreads();
                load_tile<TS, false>(g, k, t, S.xs[0], S.nz[0]);
                __syncthreads();
            }
            critic_tile<H>(g, S, S.xs[cur], S.nz[cur], part, t == (int)blockIdx.x);
        }
        grid.sync();
        critic_apply<H>(g, k, G, a_lr, c_eps);
        grid.sync();
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            if (!FOLD) {
                __syncthreads();
                load_tile<TS, false>(g, k, t, S.xs[0], S.nz[0]);
                __syncthreads();
            }
            actor_tile<H>(g, S, S.xs[cur], S.nz[cur], part, g.stash + (size_t)t * 2 * TS * H,
                          t == (int)blockIdx.x);
        }
        grid.sync();
        actor_apply<H>(g, k, G, a_lr, c_eps);
        grid.sync();
    }
}

// ------------------------------------------------------------------ host --
// Plan errors: -1 width not built, -2 shared memory does not fit, -3 K5 needs
// every tile resident (one per block).  Other non-zero codes are cudaError_t.
template <int H, bool FOLD>
int plan(int W, int n_tiles, int* out) {
    size_t smem = smem_floats<H, FOLD>(W) * sizeof(float);
    int dev = 0, sms = 0, optin = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return -2;
    e = cudaFuncSetAttribute(sac_update_kernel<H, FOLD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sac_update_kernel<H, FOLD>,
                                                      Tile<H>::NT, smem);
    if (e != cudaSuccess) return (int)e;
    int resident = per_sm * sms;
    if (resident < 1) return -2;
    if (FOLD && n_tiles > resident) return -3;
    out[0] = n_tiles < resident ? n_tiles : resident;
    out[1] = (int)smem;
    return 0;
}

template <int H, bool FOLD>
int launch(Args g, int grid, cudaStream_t stream) {
    int out[2];
    int err = plan<H, FOLD>(g.W, g.B / Tile<H>::TS, out);
    if (err != 0) return err;
    if (grid != out[0]) return -4;
    void* params[] = {&g};
    cudaError_t e = cudaLaunchCooperativeKernel((void*)sac_update_kernel<H, FOLD>, dim3(grid),
                                                dim3(Tile<H>::NT), params, (size_t)out[1], stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <bool FOLD>
int plan_any(int H, int W, int n_tiles, int* out) {
    switch (H) {
        case 128: return plan<128, FOLD>(W, n_tiles, out);
        case 256: return plan<256, FOLD>(W, n_tiles, out);
        case 384: return plan<384, FOLD>(W, n_tiles, out);
        case 512: return plan<512, FOLD>(W, n_tiles, out);
    }
    return -1;
}

template <bool FOLD>
int launch_any(int H, const Args& g, int grid, cudaStream_t stream) {
    switch (H) {
        case 128: return launch<128, FOLD>(g, grid, stream);
        case 256: return launch<256, FOLD>(g, grid, stream);
        case 384: return launch<384, FOLD>(g, grid, stream);
        case 512: return launch<512, FOLD>(g, grid, stream);
    }
    return -1;
}

}  // namespace sac

// The two C entry points of one library: `NAME_plan(H, W, n_tiles, out)` gives
// the grid size and the shared-memory bytes, `NAME(...)` launches.
#define SAC_UPDATE_ENTRY(NAME, FOLD)                                                          \
    extern "C" int NAME##_plan(int H, int W, int n_tiles, int* out) {                         \
        return sac::plan_any<FOLD>(H, W, n_tiles, out);                                       \
    }                                                                                         \
    extern "C" int NAME(float* w, float* vec, float* mw, float* vw, float* mvec, float* vvec, \
                        const float* data, const int* row_idx, const float* noise,            \
                        float* losses, float* partials, float* wt, float* stash, int H, int K, \
                        int B, int W, int lanes, int rpb, int od, int grid, int bf,           \
                        int has_floor, float gamma, float tau, float lr, float te,            \
                        float count0, float logfloor, void* stream) {                         \
        sac::Args g{w, vec, mw, vw, mvec, vvec, data, row_idx, noise, losses, partials, wt,   \
                    stash, K, B, W, lanes, rpb, od, bf, has_floor, gamma, tau, lr, te,        \
                    count0, logfloor};                                                        \
        return sac::launch_any<FOLD>(H, g, grid, (cudaStream_t)stream);                       \
    }
