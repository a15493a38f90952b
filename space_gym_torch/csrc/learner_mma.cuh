// Tensor-core products of the fused learner kernels: the bf16 mode of K4 and
// K5 (sac_update.cuh) and of K6 (td3_update.cuh).  MTile<H> has the interface
// of learner_tiles.cuh's Tile<H>, so the shared stages run on either.
//
// Every operand of these products is a bf16 value already: the post-ReLU
// activations and dz2 are rounded where they are stored, the weights are read
// from a bf16 shadow that the Adam stages rewrite.  A bf16 x bf16 product is
// exact in float32, so mma.sync.m16n8k16 (bf16 in, float32 accumulators)
// computes what the CUDA-core products compute; only the order of the sums
// differs.  Besides the (TS, H) x (H, H) products and the weight gradients,
// the first layers' obs rows (forward and gradient, K or M padded to 16) and
// the row dots (the heads, q, the action columns of dz1 . W1^T) run here.
//
// Layout.  The activation buffers stay float32 in shared memory (dz1 must
// reach the first-layer gradients unrounded); an A fragment is packed from
// them to bf16 pairs.  Element (s, j) lies at s*H + (j ^ sw(s)), an XOR of
// bits 3-4 of the column with sw(s) = ((s ^ s >> 1) & 3) << 3: every access
// of the fragments (rows, or pairs of samples for the weight gradients) and
// of the stages' row loops then hits 32 distinct banks.  Weights stream from
// L2 into a ring of two bf16 stages by cp.async, 16 bytes a thread; the copy
// of stage i + 1 overlaps the math on stage i, with one block barrier per
// stage (three stages measured no faster).  A stage is KR rows of W (forward
// products, read by ldmatrix.trans) or KR columns of all H rows of W (dz2 .
// W^T, read by ldmatrix from W's own rows), its 16-byte chunks XOR-swizzled so
// that the eight rows of an ldmatrix fall on distinct banks, at no cost in
// shared memory.  The weight gradients copy dz2 into the ring as bf16 first
// and write their (H, H) partial sums with evict-first stores (slot_sum4
// reads them back the same way); in a cluster a block computes its rows of
// the cluster's sum, the other blocks' operands staged 16 samples at a time
// (MTile::wgrad).
//
// Warps: the (TS, H) output is cut into pieces of 32 rows x 64 columns, one a
// warp (2 x 8 tiles of m16n8, 64 float32 accumulators a thread).
#pragma once

#include "learner_tiles.cuh"

#ifndef __CUDACC__
#include "mma_emul.h"
#endif

namespace tiles {

#ifdef __CUDACC__
// lo in the lower 16 bits, hi in the upper, each rounded to nearest even
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
    unsigned r;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
    return r;
}
// Four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
    unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
    unsigned s = (unsigned)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s)
                 : "memory");
}
// d += A (16 x 16, row) . B (16 x 8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
#endif

// Fragments packed from float32 (values that are bf16 already), at lane
// (g, q) = (lane / 4, lane % 4) as the PTX ISA lays out m16n8k16.  `at(r, c)`
// gives the offset of element (r, c) of the source.
// A (16 x 16) with element (m, k) at src[at(m0 + m, k0 + k)], m, k pairs adjacent
template <class At>
__device__ __forceinline__ void frag_a_rows(const float* src, At at, int m0, int k0, int g, int q,
                                            unsigned (&a)[4]) {
    const int r = m0 + g, c = k0 + 2 * q;
    float2 x0 = *reinterpret_cast<const float2*>(src + at(r, c));
    float2 x1 = *reinterpret_cast<const float2*>(src + at(r + 8, c));
    float2 x2 = *reinterpret_cast<const float2*>(src + at(r, c + 8));
    float2 x3 = *reinterpret_cast<const float2*>(src + at(r + 8, c + 8));
    a[0] = pack_bf16(x0.x, x0.y);
    a[1] = pack_bf16(x1.x, x1.y);
    a[2] = pack_bf16(x2.x, x2.y);
    a[3] = pack_bf16(x3.x, x3.y);
}
// A (16 x 16) with element (m, k) at src[at(k0 + k, m0 + m)]: the transpose
template <class At>
__device__ __forceinline__ void frag_a_cols(const float* src, At at, int m0, int k0, int g, int q,
                                            unsigned (&a)[4]) {
    const int m = m0 + g, k = k0 + 2 * q;
    a[0] = pack_bf16(src[at(k, m)], src[at(k + 1, m)]);
    a[1] = pack_bf16(src[at(k, m + 8)], src[at(k + 1, m + 8)]);
    a[2] = pack_bf16(src[at(k + 8, m)], src[at(k + 9, m)]);
    a[3] = pack_bf16(src[at(k + 8, m + 8)], src[at(k + 9, m + 8)]);
}
// B (16 x 8) with element (k, n) at src[at(k0 + k, n0 + n)]
template <class At>
__device__ __forceinline__ void frag_b_rows(const float* src, At at, int k0, int n0, int g, int q,
                                            unsigned& b0, unsigned& b1) {
    const int k = k0 + 2 * q, n = n0 + g;
    b0 = pack_bf16(src[at(k, n)], src[at(k + 1, n)]);
    b1 = pack_bf16(src[at(k + 8, n)], src[at(k + 9, n)]);
}

// The ring of NS weight stages: load(c, stage) issues the cp.async copies of
// chunk c, step(c, stage) computes on it, with the copies of the next NS - 1
// chunks in flight.  One cp.async group per chunk (empty past the last), so
// the wait for chunk c leaves the NS - 2 newer ones pending; groups committed
// before (K5's tile prefetch) are older and complete by then.  Starts with a
// block barrier (the ring and the activation buffers are free), ends without
// one.
template <int NS, class Load, class Step>
__device__ void staged(bf16* ring, int stage, int nch, Load load, Step step) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NS - 1; c++) {
        if (c < nch) load(c, ring + c * stage);
        cp_async_commit();
    }
    for (int c = 0; c < nch; c++) {
        cp_async_wait<NS - 2>();
        __syncthreads();
        if (c + NS - 1 < nch) load(c + NS - 1, ring + ((c + NS - 1) % NS) * stage);
        cp_async_commit();
        step(c, ring + (c % NS) * stage);
    }
}

template <int H>
__device__ void wgrad_cluster(float* x, bf16* ring, int cn, int crank, const float* A,
                              const float* Bm, float* out, bool first);

template <int H>
struct MTile {
    static constexpr int RG = row_groups(H);
    static constexpr int TS = 8 * RG;
    static constexpr int NT = (H / 8) * RG;
    static constexpr bool MMA = true;
    static constexpr int WN = H / 64;                              // warps across the columns
    static constexpr int KR = (H == 256 || H == 384) ? 32 : 16;    // k rows per weight stage
    static constexpr int NS = 2;                                   // weight stages in the ring
    static constexpr int STAGE = KR * H;                           // bf16 a stage
    static constexpr int CPR = KR / 8, RPL = 8 / CPR;   // backward stage: chunks a row, rows a 128 B
    static_assert(TS % 32 == 0 && H % 64 == 0 && (TS / 32) * WN * 32 == NT, "warp pieces");

    float acc[2][8][4];    // [m16 tile][n8 tile][c0..c3]
    int r0, c0, g, q;      // the warp's first row and column; lane / 4, lane % 4
    __device__ MTile() {
        const int w = threadIdx.x / 32, l = threadIdx.x % 32;
        r0 = (w / WN) * 32;
        c0 = (w % WN) * 64;
        g = l >> 2;
        q = l & 3;
    }
    __device__ static int ix(int s, int j) { return s * H + (j ^ (((s ^ (s >> 1)) & 3) << 3)); }
    struct At {
        __device__ int operator()(int s, int j) const { return ix(s, j); }
    };

    __device__ void zero() {
#pragma unroll
        for (int mt = 0; mt < 2; mt++)
#pragma unroll
            for (int nt = 0; nt < 8; nt++)
#pragma unroll
                for (int e = 0; e < 4; e++) acc[mt][nt][e] = 0.f;
    }

    // The 16-byte chunk c of row r of a stage: forward, rows of H (eight rows
    // of an ldmatrix are eight consecutive r); backward, rows of KR.
    __device__ static int fchunk(int r, int c) { return r * H + ((c ^ (r & 7)) << 3); }
    __device__ static int bchunk(int r, int c) { return r * KR + ((c ^ ((r / RPL) % CPR)) << 3); }

    // rows [k0, k0 + n) of the (., H) bf16 matrix Wb into a forward stage
    __device__ static void load_rows(const bf16* Wb, int k0, int n, bf16* st) {
        for (int idx = threadIdx.x; idx < n * (H / 8); idx += NT) {
            int r = idx / (H / 8), c = idx % (H / 8);
            cp_async16(st + fchunk(r, c), Wb + (size_t)(k0 + r) * H + c * 8);
        }
    }
    // columns [k0, k0 + KR) of all H rows of Wb into a backward stage
    __device__ static void load_cols(const bf16* Wb, int k0, bf16* st) {
        for (int idx = threadIdx.x; idx < H * CPR; idx += NT) {
            int n = idx / CPR, c = idx % CPR;
            cp_async16(st + bchunk(n, c), Wb + (size_t)n * H + k0 + c * 8);
        }
    }

    // the warp's 2 x 8 tiles of one k16 step, A fragments given, B from a
    // stage at k-row kk: forward (B[k][n] = stage[k][n], ldmatrix.trans) or
    // backward (B[k][n] = stage[n][k], ldmatrix)
    template <bool TRANS>
    __device__ void step_b(const unsigned (&a)[2][4], const bf16* st, int kk) {
        const int l = threadIdx.x % 32;
#pragma unroll
        for (int np = 0; np < 4; np++) {
            unsigned b[4];
            const int n = c0 + np * 16;
            if (TRANS)
                ldsm_x4_trans(b, st + fchunk(kk + (l & 7) + ((l >> 3) & 1) * 8, n / 8 + (l >> 4)));
            else
                ldsm_x4(b, st + bchunk(n + (l & 7) + (l >> 4) * 8, kk / 8 + ((l >> 3) & 1)));
#pragma unroll
            for (int mt = 0; mt < 2; mt++) {
                mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
                mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
            }
        }
    }

    // acc = A . W, A (TS, H) activations, Wb the (H, H) bf16 shadow of W
    __device__ void fwd(const Bufs& S, const float* A, const float*, const bf16* Wb, int) {
        zero();
        staged<NS>(S.ring, STAGE, H / KR,
               [&](int c, bf16* st) { load_rows(Wb, c * KR, KR, st); },
               [&](int c, const bf16* st) {
#pragma unroll
                   for (int kk = 0; kk < KR; kk += 16) {
                       unsigned a[2][4];
#pragma unroll
                       for (int mt = 0; mt < 2; mt++)
                           frag_a_rows(A, At{}, r0 + mt * 16, c * KR + kk, g, q, a[mt]);
                       step_b<true>(a, st, kk);
                   }
               });
    }
    // acc = A . W^T from W's own bf16 rows
    __device__ void bwd(const Bufs& S, const float* A, const float*, const bf16* Wb, int) {
        zero();
        staged<NS>(S.ring, STAGE, H / KR,
               [&](int c, bf16* st) { load_cols(Wb, c * KR, st); },
               [&](int c, const bf16* st) {
#pragma unroll
                   for (int kk = 0; kk < KR; kk += 16) {
                       unsigned a[2][4];
#pragma unroll
                       for (int mt = 0; mt < 2; mt++)
                           frag_a_rows(A, At{}, r0 + mt * 16, c * KR + kk, g, q, a[mt]);
                       step_b<false>(a, st, kk);
                   }
               });
    }
    // acc = xin^T . W1: the od obs rows (rounded in xin and in the shadow,
    // whose rows od.. are zero) through the tensor cores in k16 steps, then the
    // action rows [od, Kdim) added in float32 from w1
    __device__ void first(const Bufs& S, const float* w1, const bf16* w1b, int Kdim, int od, int) {
        constexpr int TS_ = TS;
        const float* xin = S.xin;
        const int kp = (od + 15) & ~15;
        zero();
        staged<NS>(S.ring, STAGE, (kp + KR - 1) / KR,
               [&](int c, bf16* st) { load_rows(w1b, c * KR, min(KR, kp - c * KR), st); },
               [&](int c, const bf16* st) {
                   for (int kk = 0; kk < min(KR, kp - c * KR); kk += 16) {
                       const int k = c * KR + kk + 2 * q;
                       auto x = [&](int kr, int s) { return kr < od ? xin[kr * TS_ + s] : 0.f; };
                       unsigned a[2][4];
#pragma unroll
                       for (int mt = 0; mt < 2; mt++) {
                           const int s = r0 + mt * 16 + g;
                           a[mt][0] = pack_bf16(x(k, s), x(k + 1, s));
                           a[mt][1] = pack_bf16(x(k, s + 8), x(k + 1, s + 8));
                           a[mt][2] = pack_bf16(x(k + 8, s), x(k + 9, s));
                           a[mt][3] = pack_bf16(x(k + 8, s + 8), x(k + 9, s + 8));
                       }
                       step_b<true>(a, st, kk);
                   }
               });
        for (int k = od; k < Kdim; k++) {
#pragma unroll
            for (int nt = 0; nt < 8; nt++) {
                const int col = c0 + nt * 8 + 2 * q;
                const float w0 = w1[(size_t)k * H + col], w1v = w1[(size_t)k * H + col + 1];
#pragma unroll
                for (int mt = 0; mt < 2; mt++)
#pragma unroll
                    for (int h = 0; h < 2; h++) {
                        const float xv = xin[k * TS + r0 + mt * 16 + g + 8 * h];
                        acc[mt][nt][2 * h] += xv * w0;
                        acc[mt][nt][2 * h + 1] += xv * w1v;
                    }
            }
        }
    }
    // 16 bf16 values of dz2 (float32 rows r of Bm, columns 8c..8c+7) to chunk
    // c of row r of a forward stage st
    __device__ static void stage_chunk(const float* Bm, int r, int c, int rs, bf16* st) {
        const float4 x0 = *reinterpret_cast<const float4*>(Bm + ix(r, c * 8));
        const float4 x1 = *reinterpret_cast<const float4*>(Bm + ix(r, c * 8) + 4);
        *reinterpret_cast<uint4*>(st + fchunk(rs, c)) =
            make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w), pack_bf16(x1.x, x1.y),
                       pack_bf16(x1.z, x1.w));
    }
    // acc += the warp's rows i0 + r0.. of A^T . Bm over this block's TS samples
    __device__ void wgrad_local(const Bufs& S, const float* A, const float* Bm, int i0) {
        constexpr bool RING = NS * KR >= TS;
#pragma unroll 2
        for (int k = 0; k < TS; k += 16) {
            unsigned a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; mt++)
                frag_a_cols(A, At{}, i0 + r0 + mt * 16, k, g, q, a[mt]);
            if constexpr (RING) {
                step_b<true>(a, S.ring, k);
            } else {
#pragma unroll
                for (int nt = 0; nt < 8; nt++) {
                    unsigned b0, b1;
                    frag_b_rows(Bm, At{}, k, c0 + nt * 8, g, q, b0, b1);
#pragma unroll
                    for (int mt = 0; mt < 2; mt++) mma_bf16(acc[mt][nt], a[mt], b0, b1);
                }
            }
        }
    }
    // the warp's rows i0 + r0.. of a weight gradient to out (+=), evict-first:
    // read once more, by the Adam stage or the next tile
    __device__ void wgrad_store(float* out, int i0, bool first) const {
#pragma unroll
        for (int mt = 0; mt < 2; mt++)
#pragma unroll
            for (int nt = 0; nt < 8; nt++)
#pragma unroll
                for (int h = 0; h < 2; h++) {
                    const int row = i0 + r0 + mt * 16 + g + 8 * h, col = c0 + nt * 8 + 2 * q;
                    float2* p = reinterpret_cast<float2*>(out + (size_t)row * H + col);
                    float2 v = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
                    if (!first) {
                        float2 o = *p;
                        v.x += o.x;
                        v.y += o.y;
                    }
                    __stcs(p, v);
                }
    }
    // out (+)= A^T . Bm over the tile's samples, (H, H) in the slot.  Where
    // the ring holds TS rows (H >= 256), Bm (bf16 values already) is copied
    // there first as bf16 rows in the forward stages' layout, and its
    // fragments come by ldmatrix.trans, once per k step for all four row
    // blocks i0 instead of packed from float32 for each.  Needs a block
    // barrier before (and the ring free); the next product's staging starts
    // with one.
    // In a cluster of cn > 1 blocks (learner_tiles.cuh, gemm_wgrad) this block
    // computes the rows [crank H / cn, (crank + 1) H / cn) of the cluster's
    // gradient over the samples of all its blocks, in rank order, in passes of
    // TS rows (a warp's 32 rows x 64 columns each): its own samples as above,
    // another block's 16 at a time staged into the exchange rows S.x (dz2 from
    // that block's ring as bf16 rows of a forward stage, or packed from its
    // Bm; the pass's TS columns of its h1, float32) and read from there as
    // from the ring.  A cluster barrier before and after.
    __device__ void wgrad(const Bufs& S, const float* A, const float* Bm, float* out, bool first) {
        constexpr bool RING = NS * KR >= TS;
        if constexpr (RING) {
            for (int idx = threadIdx.x; idx < TS * (H / 8); idx += NT)
                stage_chunk(Bm, idx / (H / 8), idx % (H / 8), idx / (H / 8), S.ring);
            __syncthreads();
        }
        if (S.cn == 1) {
            for (int i0 = 0; i0 < H; i0 += TS) {
                zero();
                wgrad_local(S, A, Bm, i0);
                wgrad_store(out, i0, first);
            }
            return;
        }
        wgrad_cluster<H>(S.x, S.ring, S.cn, S.crank, A, Bm, out, first);
    }
    // The cluster's part of wgrad (S.cn > 1), on this tile's accumulators:
    // the other blocks' samples staged 16 at a time through S.x, the next
    // piece's loads issued into registers before this piece's products, which
    // hide their latency.
    __device__ __forceinline__ void wgrad_cluster_body(const Bufs& S, const float* A,
                                                       const float* Bm, float* out, bool first) {
        constexpr bool RING = NS * KR >= TS;
        constexpr int XA = TS + 4;                        // the staged h1's row stride
        constexpr int KP = TS / 16;                       // pieces of 16 samples a block
        constexpr int NB = (2 * H + NT - 1) / NT;         // 16-byte chunks of dz2 a thread
        constexpr int NA = (4 * TS + NT - 1) / NT;        // float4 of h1 a thread
        struct AtX {
            __device__ int operator()(int s, int m) const { return s * XA + m; }
        };
        bf16* xb = reinterpret_cast<bf16*>(xrows<H>(S));  // 16 samples of dz2, bf16
        float* xa = xrows<H>(S) + 8 * H;                  // 16 samples of h1, TS columns
        const int rr = H / S.cn, R0 = S.crank * rr, np = (S.cn - 1) * KP;
        const int tid = threadIdx.x;
        uint4 pb[NB];
        float4 pa[NA];
        // piece j: samples 16 (j % KP).. of the (j / KP)-th other block in rank
        // order, h1's columns [p0, p0 + TS)
        auto fetch = [&](int j, int p0) {
            const int c = j / KP + (j / KP >= S.crank), k0 = (j % KP) * 16;
            const float* Ac = peer(A, c);
#pragma unroll
            for (int i = 0; i < NB; i++) {
                const int idx = tid + i * NT;
                if (idx >= 2 * H) break;
                if constexpr (RING) {
                    pb[i] = reinterpret_cast<const uint4*>(peer(S.ring, c))[k0 * H / 8 + idx];
                } else {
                    const float* b = peer(Bm, c) + ix(k0 + idx / (H / 8), idx % (H / 8) * 8);
                    const float4 x0 = *reinterpret_cast<const float4*>(b);
                    const float4 x1 = *reinterpret_cast<const float4*>(b + 4);
                    pb[i] = make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w),
                                       pack_bf16(x1.x, x1.y), pack_bf16(x1.z, x1.w));
                }
            }
#pragma unroll
            for (int i = 0; i < NA; i++) {
                const int idx = tid + i * NT;
                if (idx >= 4 * TS) break;
                pa[i] = *reinterpret_cast<const float4*>(Ac + ix(k0 + idx / (TS / 4),
                                                                 p0 + idx % (TS / 4) * 4));
            }
        };
        // the fetched piece into the staging area: dz2 as rows of a forward stage
        auto place = [&]() {
#pragma unroll
            for (int i = 0; i < NB; i++) {
                const int idx = tid + i * NT;
                if (idx >= 2 * H) break;
                const int at = RING ? idx * 8 : fchunk(idx / (H / 8), idx % (H / 8));
                *reinterpret_cast<uint4*>(xb + at) = pb[i];
            }
#pragma unroll
            for (int i = 0; i < NA; i++) {
                const int idx = tid + i * NT;
                if (idx >= 4 * TS) break;
                *reinterpret_cast<float4*>(xa + idx / (TS / 4) * XA + idx % (TS / 4) * 4) = pa[i];
            }
        };
        cluster_sync();
        for (int p0 = R0; p0 < R0 + rr; p0 += TS) {
            const bool on = p0 + r0 < R0 + rr;            // the warp has rows in this pass
            zero();
            fetch(0, p0);
            for (int j = 0; j <= np; j++) {
                if (j == S.crank * KP && on) wgrad_local(S, A, Bm, p0);   // its own, in rank order
                if (j == np) break;
                __syncthreads();                          // the staging area is free
                place();
                if (j + 1 < np) fetch(j + 1, p0);
                __syncthreads();
                if (on) {
                    unsigned a[2][4];
#pragma unroll
                    for (int mt = 0; mt < 2; mt++)
                        frag_a_cols(xa, AtX{}, r0 + mt * 16, 0, g, q, a[mt]);
                    step_b<true>(a, xb, 0);
                }
            }
            if (on) wgrad_store(out, p0, first);
        }
        cluster_sync();
    }

    // f(s, col, c_pair) over the thread's accumulator pairs: rows s, columns col, col + 1
    template <class F>
    __device__ void each_pair(F f) const {
#pragma unroll
        for (int mt = 0; mt < 2; mt++)
#pragma unroll
            for (int nt = 0; nt < 8; nt++)
#pragma unroll
                for (int h = 0; h < 2; h++)
                    f(r0 + mt * 16 + g + 8 * h, c0 + nt * 8 + 2 * q, acc[mt][nt][2 * h],
                      acc[mt][nt][2 * h + 1]);
    }
    // dst = relu(acc + bias), rounded to bf16 (this tile serves the bf16 mode
    // only); also to gdst, (TS, H) row-major
    __device__ void relu(const float* bias, float* dst, int, float* gdst) const {
#pragma unroll
        for (int nt = 0; nt < 8; nt++) {
            const int col = c0 + nt * 8 + 2 * q;
            const float2 b = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
            for (int mt = 0; mt < 2; mt++)
#pragma unroll
                for (int h = 0; h < 2; h++) {
                    const int s = r0 + mt * 16 + g + 8 * h;
                    float2 v = make_float2(rnd(fmaxf(acc[mt][nt][2 * h] + b.x, 0.f), 1),
                                           rnd(fmaxf(acc[mt][nt][2 * h + 1] + b.y, 0.f), 1));
                    *reinterpret_cast<float2*>(dst + ix(s, col)) = v;
                    if (gdst) *reinterpret_cast<float2*>(gdst + (size_t)s * H + col) = v;
                }
        }
    }
    // out[e][s] = sum_j rnd(buf[s][j]) rnd(w[e ws + j]) + add[e], e < NR <= 8:
    // a (TS, H) x (H, 8) product, a warp per 16 samples, the rows of w packed
    // to bf16 as the B operand (the lanes of rows NR.. give zeros), two
    // accumulators over alternate k steps.
    template <int NR>
    __device__ void row_dots(const float* buf, const float* w, size_t ws, const float (&add)[NR],
                             int, float* out) const {
        static_assert(NR <= 8, "one n8 tile");
        const int warp = threadIdx.x / 32;
        if (warp >= TS / 16) return;
        const int m0 = warp * 16;
        const float* wr = w + (size_t)(g < NR ? g : 0) * ws + 2 * q;
        float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
        for (int k0 = 0; k0 < H; k0 += 16) {
            unsigned a[4], b0 = 0u, b1 = 0u;
            frag_a_rows(buf, At{}, m0, k0, g, q, a);
            if (g < NR) {
                const float2 x0 = *reinterpret_cast<const float2*>(wr + k0);
                const float2 x1 = *reinterpret_cast<const float2*>(wr + k0 + 8);
                b0 = pack_bf16(x0.x, x0.y);
                b1 = pack_bf16(x1.x, x1.y);
            }
            mma_bf16(d[(k0 / 16) & 1], a, b0, b1);
        }
#pragma unroll
        for (int h = 0; h < 2; h++)
#pragma unroll
            for (int c = 0; c < 2; c++) {
                const int e = 2 * q + c;
                if (e < NR) out[e * TS + m0 + g + 8 * h] = d[0][2 * h + c] + d[1][2 * h + c] + add[e];
            }
    }
    // the bits of buf > 0, one word per 32 columns of a sample: a warp takes
    // 32 samples of one word, a ballot a sample, lane i keeps the word of
    // sample i and stores it after the 32 loads
    __device__ void mask(const float* buf, unsigned* m) const {
        constexpr int NWD = H / 32, NW = NT / 32;
        const int lane = threadIdx.x % 32;
        for (int task = threadIdx.x / 32; task < (TS / 32) * NWD; task += NW) {
            const int s0 = (task / NWD) * 32, wd = task % NWD;
            unsigned mine = 0u;
#pragma unroll 8
            for (int i = 0; i < 32; i++) {
                const unsigned word = __ballot_sync(0xffffffffu, buf[ix(s0 + i, wd * 32 + lane)] > 0.f);
                mine = lane == i ? word : mine;
            }
            m[(s0 + lane) * NWD + wd] = mine;
        }
    }
    // A first layer's gradients from dz1 (in A) and xin.  The obs rows [0, od)
    // of W1 through the tensor cores: xin^T (od rows padded to 16, rounded
    // already) . rnd(dz1), K = TS, a warp H / NW columns.  The other rows
    // [od, nrows) (the critics' two action rows) and b1 (row nrows) in
    // float32 against dz1 unrounded, a column a thread.
    __device__ void w1grad(const Bufs& S, float* out, int nrows, int od, int, bool first) const {
        constexpr int NW = NT / 32, WC = H / NW, NTL = WC / 8;
        static_assert(WC % 8 == 0 && TS % 16 == 0, "w1grad tiles");
        const float* xin = S.xin;
        const int n0 = (threadIdx.x / 32) * WC;
        auto xpair = [&](int m, int k) -> unsigned {
            if (m >= od) return 0u;
            const float2 x = *reinterpret_cast<const float2*>(xin + m * TS + k);
            return pack_bf16(x.x, x.y);
        };
        for (int m0 = 0; m0 < od; m0 += 16) {
            float d[NTL][4];
#pragma unroll
            for (int nt = 0; nt < NTL; nt++) d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
#pragma unroll 2
            for (int k0 = 0; k0 < TS; k0 += 16) {
                const unsigned a[4] = {xpair(m0 + g, k0 + 2 * q), xpair(m0 + g + 8, k0 + 2 * q),
                                       xpair(m0 + g, k0 + 2 * q + 8),
                                       xpair(m0 + g + 8, k0 + 2 * q + 8)};
#pragma unroll
                for (int nt = 0; nt < NTL; nt++) {
                    unsigned b0, b1;
                    frag_b_rows(S.A, At{}, k0, n0 + nt * 8, g, q, b0, b1);
                    mma_bf16(d[nt], a, b0, b1);
                }
            }
#pragma unroll
            for (int nt = 0; nt < NTL; nt++)
#pragma unroll
                for (int h = 0; h < 2; h++) {
                    const int row = m0 + g + 8 * h, col = n0 + nt * 8 + 2 * q;
                    if (row < od) {
                        put(out + (size_t)row * H + col, d[nt][2 * h], first);
                        put(out + (size_t)row * H + col + 1, d[nt][2 * h + 1], first);
                    }
                }
        }
        for (int j = threadIdx.x; j < H; j += NT) {
            float gb1 = 0.f, ga[2] = {0.f, 0.f};
            for (int s = 0; s < TS; s++) {
                const float dz = S.A[ix(s, j)];
                gb1 += dz;
#pragma unroll
                for (int e = 0; e < 2; e++)
                    if (od + e < nrows) ga[e] += xin[(od + e) * TS + s] * dz;
            }
            put(out + (size_t)nrows * H + j, gb1, first);
#pragma unroll
            for (int e = 0; e < 2; e++)
                if (od + e < nrows) put(out + (size_t)(od + e) * H + j, ga[e], first);
        }
    }

    // A = A > 0 ? acc : 0, in place
    __device__ void masked_inplace(float* A) const {
        each_pair([&](int s, int col, float x, float y) {
            float2* p = reinterpret_cast<float2*>(A + ix(s, col));
            float2 h = *p;
            *p = make_float2(h.x > 0.f ? x : 0.f, h.y > 0.f ? y : 0.f);
        });
    }
    // dst = mask ? acc : 0 with the mask kept as bits
    __device__ void masked_bits(const unsigned* m, float* dst) const {
        each_pair([&](int s, int col, float x, float y) {
            unsigned bits = m[s * (H / 32) + col / 32] >> (col % 32);
            *reinterpret_cast<float2*>(dst + ix(s, col)) =
                make_float2((bits & 1u) ? x : 0.f, (bits & 2u) ? y : 0.f);
        });
    }
};

// MTile::wgrad's cluster part, a function of its own with accumulators of
// its own, so that its registers do not weigh on the stages around it.
template <int H>
__device__ __noinline__ void wgrad_cluster(float* x, bf16* ring, int cn, int crank,
                                           const float* A, const float* Bm, float* out,
                                           bool first) {
    Bufs S;
    S.x = x;
    S.ring = ring;
    S.cn = cn;
    S.crank = crank;
    MTile<H> t;
    t.wgrad_cluster_body(S, A, Bm, out, first);
}

// The tile type of a mode: float32 products on the CUDA cores, or bf16
// products on the tensor cores.
template <int H, bool BF>
using TileOf = typename std::conditional<BF, MTile<H>, Tile<H>>::type;

}  // namespace tiles
