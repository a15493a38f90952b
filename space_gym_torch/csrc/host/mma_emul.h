// Host emulation of the warp-level tensor-core instructions that
// ../learner_mma.cuh issues as inline PTX on the card: cvt.rn.bf16x2.f32,
// ldmatrix.sync.aligned.m8n8.x4(.trans).shared.b16 and
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.  Each lane is an OS
// thread (cuda_runtime.h); what one lane holds in a register on the card it
// holds here too, and an instruction exchanges the lanes' operands through the
// warp's exchange area and one warp barrier, with the fragment layouts of the
// PTX ISA: for m16n8k16 at lane (g, q) = (lane / 4, lane % 4)
//   A (16 x 16, row): a0 a1 (g, 2q..2q+1), a2 a3 (g+8, 2q..), a4 a5 (g, 2q+8..),
//                     a6 a7 (g+8, 2q+8..), two bf16 a register, lower index low;
//   B (16 x 8, col):  b0 b1 (k = 2q..2q+1, n = g), b2 b3 (k = 2q+8.., n = g);
//   C, D (16 x 8):    c0 c1 (g, 2q..2q+1), c2 c3 (g+8, 2q..2q+1);
// and for ldmatrix, lane l gives the address of row l % 8 of matrix l / 8 and
// receives in register i the elements (l / 4, 2 (l % 4)..+1) of matrix i, or
// with .trans the elements (2 (l % 4)..+1, l / 4), i.e. of its transpose.
// The products are exact in float32 (bf16 x bf16); the sum runs in k order.
#pragma once
#include <cstdint>
#include <cstring>
#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace tiles {

inline unsigned pack_bf16(float lo, float hi) {
    return (unsigned)__float2bfloat16_rn(lo).v | ((unsigned)__float2bfloat16_rn(hi).v << 16);
}

inline float bf16_lo(unsigned r) { return __bfloat162float({(uint16_t)(r & 0xFFFFu)}); }
inline float bf16_hi(unsigned r) { return __bfloat162float({(uint16_t)(r >> 16)}); }

// This lane's slot of the exchange area, alternating between two halves: a
// lane writes a half again only after the barrier of the instruction in
// between, which every lane reaches after it has read that half.
inline WarpX::Lane* emul_slot(int& half) {
    half = tctx.xhalf;
    tctx.xhalf ^= 1;
    return &tctx.warpx->lane[half][tctx.tid.x % 32];
}

inline void ldsm_emul(unsigned (&r)[4], const void* p, bool trans) {
    int half;
    emul_slot(half)->ptr = p;
    tctx.warp_bar->arrive_and_wait();
    const WarpX::Lane* x = tctx.warpx->lane[half];
    const int l = tctx.tid.x % 32;
    for (int i = 0; i < 4; i++) {
        uint16_t lo, hi;
        if (!trans) {
            const uint16_t* row = static_cast<const uint16_t*>(x[i * 8 + l / 4].ptr);
            lo = row[2 * (l % 4)];
            hi = row[2 * (l % 4) + 1];
        } else {
            lo = static_cast<const uint16_t*>(x[i * 8 + 2 * (l % 4)].ptr)[l / 4];
            hi = static_cast<const uint16_t*>(x[i * 8 + 2 * (l % 4) + 1].ptr)[l / 4];
        }
        r[i] = (unsigned)lo | ((unsigned)hi << 16);
    }
}
inline void ldsm_x4(unsigned (&r)[4], const void* p) { ldsm_emul(r, p, false); }
inline void ldsm_x4_trans(unsigned (&r)[4], const void* p) { ldsm_emul(r, p, true); }

inline void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
    int half;
    WarpX::Lane* me = emul_slot(half);
    for (int i = 0; i < 4; i++) me->reg[i] = a[i];
    me->reg[4] = b0;
    me->reg[5] = b1;
    tctx.warp_bar->arrive_and_wait();
    const WarpX::Lane* x = tctx.warpx->lane[half];
    // element (m, k) of A and (k, n) of B, from the lane and register that hold it
    auto A = [&](int m, int k) {
        unsigned v = x[(m % 8) * 4 + (k % 8) / 2].reg[(m >= 8) + 2 * (k >= 8)];
        return k % 2 ? bf16_hi(v) : bf16_lo(v);
    };
    auto B = [&](int k, int n) {
        unsigned v = x[n * 4 + (k % 8) / 2].reg[4 + (k >= 8)];
        return k % 2 ? bf16_hi(v) : bf16_lo(v);
    };
    const int l = tctx.tid.x % 32, g = l / 4, q = l % 4;
    for (int e = 0; e < 4; e++) {
        const int m = g + 8 * (e / 2), n = 2 * q + e % 2;
        float s = d[e];
        for (int k = 0; k < 16; k++) s += A(m, k) * B(k, n);
        d[e] = s;
    }
}

}  // namespace tiles
