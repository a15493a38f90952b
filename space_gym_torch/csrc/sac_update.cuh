// K SAC updates in one cooperative kernel launch: the device code shared by
// K4 (sac_update.cu, FOLD = false) and K5 (sac_update_fold.cu, FOLD = true).
// The tiles, products and the stages that SAC has in common with TD3 are in
// learner_tiles.cuh (float32 products on the CUDA cores) and learner_mma.cuh
// (bf16 products on the tensor cores).
//
// Replaces the Pallas kernels of space_gym_tpu/models/fused_sac.py: K4 the
// (K, 2, T) grid kernel at :759, K5 the folded (K,) grid kernels at :852 and
// :866.  What is computed is fused_sac.py::_make_bodies: per update, the twin
// critics' TD loss with a hand-written backward, Adam and polyak; then the
// tanh-Gaussian actor's loss and backward against the UPDATED critics, Adam
// on the actor and on the temperature.  The plain version is
// models/fused_sac.py::update_k_reference.
//
// What bounds it on this card.  The work is a chain of (batch, H) x (H, H)
// products (16 per sample and update), about 5.8e11 operations per launch at
// K=32, B=8192, H=256: at the tensor cores' bf16 rate that is 0.6 ms, and the
// launch moves only about 58 MB of its own operands.  Between those two
// bounds sit the costs of doing it in one cooperative launch: the gradient
// slots (one per cluster of two blocks at the training shape: 66 x 562 KB,
// about 37 MB written per critic stage and read back by the Adam stage, half
// that per actor stage, and read back and written again where a block holds a
// second tile), the weights read from L2 by every block for every product
// (416 weight-reading products x 132 blocks x 128 KB of bf16, about 7 GB), and
// four grid barriers per update.
//
// Design.  The batch is spread over the SMs: a thread block owns tiles of TS
// samples, holds two (TS, H) float32 activation buffers in shared memory and
// streams the weights from L2, where the whole state (2 MB of weights, 4 MB
// of moments at H=256) stays for all K updates.  The mode is a template
// parameter of the kernel:
// - mm_bf16 (args.bf, the trainer's mode): the operands of the products that
//   the Pallas body sends through `dot`/`dg`, and the post-ReLU activations,
//   are bf16 values, so the products run on the tensor cores
//   (learner_mma.cuh: mma.sync.m16n8k16 bf16 -> float32, a warp a 32 x 64
//   piece of the output).  They read a bf16 shadow `wb` of the actor's,
//   critics' and targets' W1 and W2, built at the start of the launch and
//   rewritten by the Adam stages, so every weight is rounded once and read
//   at half the bytes; the weights stream into two XOR-swizzled shared-memory
//   stages by cp.async, the copy of one overlapping the math on the other,
//   one block barrier per stage.  The products that the Pallas body sends
//   through `_dg` (action rows and bias of the first layers, dq x w3, the b1
//   gradients and the first layers' action-row gradients) stay float32 on
//   the CUDA cores.
// - float32 (mm_bf16 False): every product in float32 multiply-adds on the
//   CUDA cores (learner_tiles.cuh: each thread an 8 x 8 tile, weights staged
//   16 rows at a time between two barriers); the transposed products
//   (dz2 . W2^T) read a transposed copy `wt` of the three trainable W2,
//   built at the start of the launch and kept current by the Adam stages.
// What is left after the tensor cores, by the phase clock (chip_smoke.py
// --phase-clock, PERF.md section 5): the gradient slots, written by the
// weight gradients and read back by the Adam stages (both with evict-first
// hints, so that the weights and moments stay in L2), and the weight-reading
// products, each block streaming the same weights from L2, take most of an
// update; ReLU stores, first layers and the column loops most of the rest;
// the grid barriers a few percent.  So wgmma pays only once the slots and the
// L2 traffic are cut: the reduction across a cluster below cuts the first,
// multicast of the weight stages would cut the second.
//
// Clusters.  The grid is min(n_tiles, resident blocks), 132 at the training
// shape (learner_tiles.cuh, plan_launch), launched in thread block clusters
// of C blocks where the card holds enough clusters of C for a grid that gives
// no block more tiles, whose clusters' blocks hold as many tiles each, and
// where the exchange rows fit: C = 2 at the training shape on an H100 80GB
// HBM3 (it holds 15 clusters of 8 and 30 of 4, 120 blocks, which would give
// blocks a third tile).  A cluster writes one slot, partials[blockIdx / C], and the Adam
// stages sum grid / C slots.  Its blocks sum their gradients on chip through
// distributed shared memory: an H x H weight gradient is computed by each
// block for its rows [rank H / C, (rank + 1) H / C) only, over the samples of
// every block of the cluster, reading the others' activations and dz2 where
// they lie; the other gradient rows and sums go through exchange rows in
// shared memory, each block adding its columns of them over the cluster's
// blocks (xflush).  Sums in rank order, no atomics.  C = 1 (no room, or a
// grid the rules refuse) is the launch without clusters, with its bits, of an
// instantiation of its own (the template flag CL false) from which the
// cluster code drops out.
//
// Order across the batch: gradients are sums over all B samples, and the
// actor phase must see the critics that the critic phase updated.  So the
// launch is cooperative and an update is four stages with a grid-wide barrier
// after each: critic tiles -> critic Adam + polyak -> actor tiles -> actor
// and temperature Adam.
//
// Deterministic sums: a cluster writes the gradient of its blocks' tiles to
// its own slot of `partials` (no atomics), its blocks' parts in rank order;
// the Adam stage sums the slots in index order; mma.sync sums in a fixed
// order.  The result is a function of the inputs, the grid size and C.
//
// The critics' first-layer bias is added plainly (the TPU kernels fold it
// into a weight row for the launch's duration); w, vec and the moments come
// back in the JAX layout.
//
// FOLD: K4 loads a tile's W data rows and noise from device memory in each
// of the two phases.  K5 keeps a block's first tile resident: it loads it
// once per update into one of two shared-memory buffers, keeps it for both
// phases, and starts the copy of the next update's first tile (cp.async)
// before it computes this one.  A block with more tiles than one (a batch
// with more tiles than resident blocks) loads the others in turn into the
// second buffer, in each phase, as K4 does, and starts the next update's copy
// after its last actor tile instead.  Both kernels take the same grid and
// cluster size and add a block's tiles into its slot in the same order, so
// they give the same bits.
//
// Partial tiles: a batch, or a ring's lanes, that TS does not divide ends in
// a partial tile (learner_tiles.cuh, load_tile).  Its samples past the end are
// zero inputs with zero seeds (dq, the actor's loss terms and head
// gradients), so they add nothing to a gradient or a loss; means divide by B.
#pragma once

#include "learner_mma.cuh"
#include "learner_tiles.cuh"

namespace sac {

using namespace tiles;

// The phase clock's ids in this kernel (learner_tiles.cuh): the kernel's own
// marks, and each call site of a shared stage with the marks of its stage;
// the site's index is its place in SG_SITES.
#define SG_KERNEL_MARKS(X)                                                          \
    X(K_PROLOGUE, "prologue") X(K_TILE, "tile load or wait")                       \
    X(K_CRITIC, "critic misc") X(K_SYNC_C, "grid sync") X(K_CRITIC_ADAM, "critic Adam") \
    X(K_SYNC_CA, "grid sync") X(K_ACTOR_TILE, "tile load") X(K_ACTOR, "actor misc") \
    X(K_SYNC_A, "grid sync") X(K_ACTOR_ADAM, "actor Adam") X(K_SYNC_AA, "grid sync")
#define SG_DLDA_MARKS(X)                                                            \
    X(D_FILL, "dz2 fill") X(D_BWD, "dz2 . W2^T") X(D_DZ1, "dz1 (mask bits)")      \
    X(D_DOTS, "action dots")
#define SG_SITES(X)                                                                 \
    X(SITE_KERNEL, "kernel", SG_KERNEL_MARKS)                                      \
    X(SITE_NEXT_ACTOR, "critic stage, actor on next obs", SG_STAGE_MARKS)          \
    X(SITE_TARGETS, "critic stage, targets", SG_STAGE_MARKS)                       \
    X(SITE_CRITICS, "critic stage, critics", SG_STAGE_MARKS)                       \
    X(SITE_ACTOR, "actor stage, actor", SG_STAGE_MARKS)                            \
    X(SITE_ACTOR_CRITICS, "actor stage, critics", SG_STAGE_MARKS)                  \
    X(SITE_DLDA, "actor stage, dL/da", SG_DLDA_MARKS)                              \
    X(SITE_ACTOR_BACK, "actor stage, actor backward", SG_ACTOR_BACK_MARKS)
enum KernelMark { SG_KERNEL_MARKS(SG_MARK_ID) };
enum DldaMark { SG_DLDA_MARKS(SG_MARK_ID) };
enum Site { SG_SITES(SG_SITE_ID) };

constexpr int NHEAD = 4;
constexpr int NSMALL = 28;    // per-sample scalar arrays in shared memory
constexpr float LOG_STD_MIN = -20.0f;
constexpr float LOG_STD_MAX = 2.0f;
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
    float* partials;       // (grid / C, prows, H) gradient sums, one slot a cluster of C blocks
    float* wt;             // (3, H, H) transposed W2 of critic 0, critic 1, actor (float32 mode)
    float* stash;          // (n_tiles, 2, TS, H) the actor's activations
    bf16* wb;              // (5 (IN1 + H), H) bf16 shadow of w's first 5 (IN1 + H) rows (bf16 mode)
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
    // the rows and columns of `vec` that the shared critic stage names
    static constexpr int V_CB1 = sac::V_CB1, V_CB2 = sac::V_CB2, V_CW3 = sac::V_CW3;
    static constexpr int V_TB1 = sac::V_TB1, V_TB2 = sac::V_TB2, V_TW3 = sac::V_TW3;
    static constexpr int V_MISC = sac::V_MISC, M_CB3 = sac::M_CB3, M_TB3 = sac::M_TB3;
};

template <int H, bool FOLD, bool BF>
__host__ __device__ constexpr size_t smem_floats(int W) {
    constexpr int TS = 8 * row_groups(H);
    return (size_t)2 * TS * H + (BF ? MTile<H>::NS * MTile<H>::STAGE / 2 : KC * H) + (FOLD ? 2 : 1) * (W * TS + 4 * TS)
           + W * TS + NSMALL * TS + 4 * TS * (H / 32) + 32;
}

__device__ __forceinline__ float softplus(float x) {
    return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

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

// The operands of the actor, and of trainable critic c, in `w` and `vec`.
// Row `row` of the bf16 shadow (rows as in `w`), null in float32 mode.
template <int H>
__device__ const bf16* shadow(const Args& g, int row) {
    return g.wb ? g.wb + (size_t)row * H : nullptr;
}

template <int H>
__device__ ActorRefs actor_refs(const Args& g) {
    using L = Lay<H>;
    return {g.w + L::R_AW1 * H, g.w + L::R_AW2 * H, g.w + (size_t)L::R_AWH * H,
            g.vec + V_AB1 * H, g.vec + V_AB2 * H, g.vec + V_MISC * H + M_ABH,
            shadow<H>(g, L::R_AW1), shadow<H>(g, L::R_AW2)};
}

// Critic c, or with `target` target c (never trained: no transposed copy).
template <int H>
__device__ CriticRefs critic_refs(const Args& g, int c, bool target = false) {
    using L = Lay<H>;
    const int r1 = target ? L::r_tw1(c) : L::r_cw1(c);
    const float* misc = g.vec + V_MISC * H;
    return {g.w + (size_t)r1 * H, g.w + (size_t)(r1 + IN1) * H,
            target || !g.wt ? nullptr : g.wt + (size_t)c * H * H,
            g.vec + ((target ? V_TB1 : V_CB1) + c) * H, g.vec + ((target ? V_TB2 : V_CB2) + c) * H,
            g.vec + ((target ? V_TW3 : V_CW3) + c) * H, misc[(target ? M_TB3 : M_CB3) + c],
            shadow<H>(g, r1), shadow<H>(g, r1 + IN1)};
}

struct Smem : Bufs {
    float *xs[2], *nz[2], *sm;
    unsigned* mask;
};

template <int H, bool FOLD, bool BF>
__device__ Smem carve(float* base, int W) {
    constexpr int TS = Tile<H>::TS;
    Smem s;
    s.A = base; base += TS * H;
    s.Bm = base; base += TS * H;
    s.wch = BF ? nullptr : base;
    s.ring = BF ? reinterpret_cast<bf16*>(base) : nullptr;
    base += BF ? MTile<H>::NS * MTile<H>::STAGE / 2 : KC * H;
    s.sm = base; base += NSMALL * TS;
    s.mask = reinterpret_cast<unsigned*>(base); base += 4 * TS * (H / 32);
    // the buffers whose size depends on W last: the others lie at constant
    // offsets, which the compiler need not keep in registers
    s.xin = base; base += W * TS;
    for (int i = 0; i < (FOLD ? 2 : 1); i++) {
        s.xs[i] = base; base += W * TS;
        s.nz[i] = base; base += 4 * TS;
    }
    if (!FOLD) { s.xs[1] = s.xs[0]; s.nz[1] = s.nz[0]; }
    s.x = base;    // the exchange rows, there in a launch of clusters only
    return s;
}

// ---------------------------------------------------------------- critic --
// Gradient rows of one critic in a block's partial slot: [0, n1) W1 (obs rows
// then the two action rows), n1 b1, n1+1 b2, n1+2 w3, [n1+3, n1+3+H) W2; the
// slot's row 2*(n1+3+H) holds b3 of both critics and their loss sums.
template <int H, class T>
__device__ void critic_tile(const Args& g, const Smem& S, const float* xs, const float* nz,
                            float* part, bool first, int nv) {
    constexpr int TS = Tile<H>::TS;
    const int od = g.od, n1 = od + 2, bf = g.bf, CS = n1 + 3 + H;
    const int n0 = ceil8(od), a0 = ceil8(n0 + od), rr = a0 + 2, dd = rr + 1;
    const float* misc = g.vec + V_MISC * H;
    const float alpha = expf(misc[M_LA]);
    float* na0 = S.sm; float* na1 = S.sm + TS; float* nlogp = S.sm + 2 * TS;
    float* qt = S.sm + 3 * TS;        // [2][TS]
    float* tq = S.sm + 5 * TS; float* q = S.sm + 6 * TS; float* dq = S.sm + 7 * TS;
    float* lsum = S.sm + 8 * TS;
    float* head = S.sm + 9 * TS;      // [4][TS]
    T t;
    const int tid = threadIdx.x;

    // the actor on next_obs, sampled with the critic's normals
    copy_rows<TS>(xs, n0, S.xin, 0, od, bf);
    phase(K_CRITIC, SITE_KERNEL);
    phase_site(SITE_NEXT_ACTOR);
    actor_forward<H, NHEAD>(t, S, actor_refs<H>(g), od, bf, head, nullptr);
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
    phase(K_CRITIC, SITE_KERNEL);
    phase_site(SITE_TARGETS);
    for (int c = 0; c < 2; c++)
        critic_forward<H>(t, S, critic_refs<H>(g, c, true), od, bf, qt + c * TS);
    __syncthreads();
    if (tid < TS)
        tq[tid] = xs[rr * TS + tid] + g.gamma * xs[dd * TS + tid]
                  * (fminf(qt[tid], qt[TS + tid]) - alpha * nlogp[tid]);
    // the critics on (obs, action), forward and backward
    copy_rows<TS>(xs, 0, S.xin, 0, od, bf);
    copy_rows<TS>(xs, a0, S.xin, od, 2, 0);
    phase(K_CRITIC, SITE_KERNEL);
    phase_site(SITE_CRITICS);
    for (int c = 0; c < 2; c++)
        critic_grad<H>(t, S, critic_refs<H>(g, c), tq, q, dq, lsum, part + (size_t)c * CS * H,
                       part + (size_t)2 * CS * H + c, od, g.B, bf, first, nv);
}

// ----------------------------------------------------------------- actor --
// Gradient rows of the actor in a block's partial slot: [0, od) W1, od b1,
// od+1 b2, [od+2, od+6) head^T, [od+6, od+6+H) W2; row od+6+H holds the head's
// bias gradients [0, 4), the loss sum [4] and the logp sum [5].  Samples from
// nv on (a partial tile) get zero seeds and add nothing.
template <int H, class T>
__device__ void actor_tile(const Args& g, const Smem& S, const float* xs, const float* nz,
                           float* part, float* stash, bool first, int nv) {
    using L = Lay<H>;
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    const int od = g.od, bf = g.bf;
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
    // critic c's masks of h1 and h2 (pointers computed, not an array indexed
    // at run time, which would live in local memory)
    auto m1 = [&](int c) { return S.mask + (2 * c) * TS * (H / 32); };
    auto m2 = [&](int c) { return S.mask + (2 * c + 1) * TS * (H / 32); };
    T t;
    const int tid = threadIdx.x;

    // the actor on obs, sampled with the actor's normals; h1, h2 are kept in
    // device memory (L2) while the critics use the two buffers
    copy_rows<TS>(xs, 0, S.xin, 0, od, bf);
    phase(K_ACTOR, SITE_KERNEL);
    phase_site(SITE_ACTOR);
    actor_forward<H, NHEAD>(t, S, actor_refs<H>(g), od, bf, head, stash);
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
    phase(K_ACTOR, SITE_KERNEL);
    phase_site(SITE_ACTOR_CRITICS);
    for (int c = 0; c < 2; c++) {
        critic_forward<H>(t, S, critic_refs<H>(g, c), od, bf, qc + c * TS);
        t.mask(S.A, m1(c));
        t.mask(S.Bm, m2(c));
        phase(M_DQ);
    }
    __syncthreads();
    if (tid < TS)
        lsum[tid] = tid < nv ? (alpha * logp[tid] - fminf(qc[tid], qc[TS + tid])) * invb : 0.f;
    // dL/da through the critic that gave the smaller q
    for (int c = 0; c < 2; c++) {
        __syncthreads();
        if (tid < TS) {
            bool pick0 = qc[tid] <= qc[TS + tid];
            dq[tid] = tid < nv ? -invb * ((c == 0) == pick0 ? 1.0f : 0.0f) : 0.f;
        }
        __syncthreads();
        for (int j = tid; j < H; j += NT) {
            const float w3j = g.vec[(V_CW3 + c) * H + j];
            for (int s0 = 0; s0 < TS; s0 += 8) {    // eight loads, then eight stores
                float v[8];
#pragma unroll
                for (int i = 0; i < 8; i++)
                    v[i] = mask_bit(m2(c), s0 + i, j, H) ? rnd(dq[s0 + i] * w3j, bf) : 0.f;
#pragma unroll
                for (int i = 0; i < 8; i++) S.Bm[T::ix(s0 + i, j)] = v[i];
            }
        }
        phase(D_FILL, SITE_DLDA);
        const CriticRefs cr = critic_refs<H>(g, c);
        t.bwd(S, S.Bm, cr.w2t, cr.w2b, bf);
        phase(D_BWD, SITE_DLDA);
        t.masked_bits(m1(c), S.A);       // dz1
        __syncthreads();
        phase(D_DZ1, SITE_DLDA);
        // only the action columns of the input gradient are needed
        const float* wact = g.w + (size_t)(L::r_cw1(c) + od) * H;
        if constexpr (T::MMA) {
            const float none[2] = {0.f, 0.f};
            t.row_dots(S.A, wact, H, none, bf, dav);     // rounds dz1 as it reads it
        } else {
            for (int e = 0; e < 2; e++) {
                int warp = tid / 32, lane = tid % 32;
                const float* wrow = wact + (size_t)e * H;
                for (int s = warp; s < TS; s += NT / 32) {
                    float v = 0.f;
                    for (int j = lane; j < H; j += 32) v += S.A[s * H + j] * wrow[j];
                    v = warp_sum(v);
                    if (lane == 0) dav[e * TS + s] = v;
                }
            }
        }
        __syncthreads();
        phase(D_DOTS, SITE_DLDA);
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
            const bool in = tid < nv;
            gh[e * TS + tid] = in ? dpre : 0.f;
            gh[(2 + e) * TS + tid] =
                in ? (dpre * sdv[e * TS + tid] * nz[(2 + e) * TS + tid] - dlogp) * clip : 0.f;
        }
    }
    if (tid < 32) {
        // in a cluster, misc values 4 and 5 of actor_backward's exchange
        float* pm = S.cn > 1 ? S.x : part + (size_t)(od + 6 + H) * H;
        float ls = tile_sum<TS>(lsum), lp = tile_sum<TS>(logp, nv);
        if (tid == 0) {
            put(pm + 4, ls, first || S.cn > 1);
            put(pm + 5, lp, first || S.cn > 1);
        }
    }
    phase(K_ACTOR, SITE_KERNEL);
    phase_site(SITE_ACTOR_BACK);
    actor_backward<H, NHEAD>(t, S, gh, stash, g.w + (size_t)L::R_AWH * H,
                             g.wt ? g.wt + (size_t)2 * H * H : nullptr, part, od, bf, first,
                             NHEAD + 2, shadow<H>(g, L::R_AW2));
}

// Adam on the actor and on the temperature from the nslots partial slots
// summed in index order; the new W2 to the transposed copy, or in bf16 mode
// W1 and W2 to the shadow, a thread four neighbouring elements (slot_sum4,
// adam4).
template <int H, bool BF>
__device__ void actor_apply(const Args& g, int k, int grid, int nslots, float a_lr, float c_eps) {
    using L = Lay<H>;
    const int od = g.od, AS = od + 6 + H;
    const int prows = 2 * (od + 2 + 3 + H) + 1;
    const size_t slot = (size_t)prows * H;
    const int total = AS * H;
    // where element (lr, j) of the slots' row layout lives: the weight and its moments
    auto where = [&](int lr, int j, float*& wp, float*& mp, float*& vp) {
        if (lr == od || lr == od + 1) {
            size_t o = (size_t)(lr == od ? V_AB1 : V_AB2) * H + j;
            wp = g.vec + o; mp = g.mvec + o; vp = g.vvec + o;
        } else {
            int row = lr < od ? L::R_AW1 + lr
                      : lr < od + 6 ? L::R_AWH + lr - (od + 2) : L::R_AW2 + lr - (od + 6);
            size_t o = (size_t)row * H + j;
            wp = g.w + o; mp = g.mw + o; vp = g.vw + o;
        }
    };
    if constexpr (BF) {
        for (int e = 4 * (blockIdx.x * blockDim.x + threadIdx.x); e < total;
             e += 4 * grid * blockDim.x) {
            int lr = e / H, j = e % H;
            float4 gr = slot_sum4(g.partials + (size_t)lr * H + j, nslots, slot);
            float *wp, *mp, *vp;
            where(lr, j, wp, mp, vp);
            const float4 wn = adam4(wp, mp, vp, gr, a_lr, c_eps);
            if (lr < od || lr >= od + 6)
                store_bf16x4(g.wb + (size_t)(lr < od ? L::R_AW1 + lr : L::R_AW2 + lr - (od + 6)) * H
                             + j, wn);
        }
    } else {
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += grid * blockDim.x) {
            int lr = e / H, j = e % H;
            const float* p = g.partials + (size_t)lr * H + j;
            float gr = 0.f;
            for (int b = 0; b < nslots; b++) gr += p[b * slot];
            float *wp, *mp, *vp;
            where(lr, j, wp, mp, vp);
            float wn = adam_elem(wp, mp, vp, gr, a_lr, c_eps);
            if (lr >= od + 6) g.wt[(size_t)2 * H * H + (size_t)j * H + (lr - (od + 6))] = wn;
        }
    }
    if (blockIdx.x == 0 && threadIdx.x < 6) {
        const float* pm = g.partials + (size_t)AS * H;
        int c = threadIdx.x;
        float gr = 0.f;
        for (int b = 0; b < nslots; b++) gr += pm[b * slot + c];
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
template <int H, bool FOLD, bool BF, bool CL>
__global__ void __launch_bounds__(Tile<H>::NT, 1) sac_update_kernel(Args g) {
    using L = Lay<H>;
    using T = TileOf<H, BF>;
    constexpr int TS = Tile<H>::TS;
#ifdef __CUDACC__
    extern __shared__ __align__(16) float smem_base[];
#else
    float* smem_base = host_shared_memory();
#endif
    cg::grid_group grid = cg::this_grid();
    const int G = gridDim.x;
    const int n_tiles = tiles::n_tiles(g.lanes, g.rpb, TS);
    const int n1 = g.od + 2, prows = 2 * (n1 + 3 + H) + 1;
    Smem S = carve<H, FOLD, BF>(smem_base, g.W);
    // the cluster's slot: one a cluster of C blocks (CL false: no clusters,
    // C = 1, and the stages' cluster code drops out of the instantiation)
    const int C = CL ? (int)cg::this_cluster().num_blocks() : 1;
    S.cn = C;
    S.crank = CL ? (int)cg::this_cluster().block_rank() : 0;
    float* part = g.partials + (size_t)(blockIdx.x / C) * prows * H;
    // K5: does this block hold more tiles than its resident one?
    const bool more = FOLD && (int)blockIdx.x + G < n_tiles;
    phase(-1, SITE_KERNEL);  // starts the clock

    if (BF) {
        // the bf16 shadow of the actor's, the critics' and the targets' W1 and
        // W2 (w's first 5 (IN1 + H) rows); W1's rows from od on are zero, the
        // critics' action rows stay float32 in `w`
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 5 * (IN1 + H) * H;
             e += G * blockDim.x) {
            int lr = (e / H) % (IN1 + H);
            g.wb[e] = __float2bfloat16_rn(lr < g.od || lr >= IN1 ? g.w[e] : 0.f);
        }
    } else {
        // the transposed copies of the three trainable W2
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 3 * H * H; e += G * blockDim.x) {
            int m = e / (H * H), i = (e / H) % H, j = e % H;
            int row = (m < 2 ? L::r_cw1(m) + IN1 : L::R_AW2) + i;
            g.wt[(size_t)m * H * H + (size_t)j * H + i] = g.w[(size_t)row * H + j];
        }
    }
    if (FOLD) {
        load_tile<TS, 4, true>(g, 0, blockIdx.x, S.xs[0], S.nz[0]);
        cp_async_commit();
    }
    grid.sync();
    phase(K_PROLOGUE, SITE_KERNEL);

    for (int k = 0; k < g.K; k++) {
        // per-update scalars (fused_sac.py:460-474); b**t as exp(t log b)
        float a_lr, c_eps;
        adam_scalars(g.count0 + (float)k + 1.0f, g.lr, a_lr, c_eps);
        // K5: this update's resident tile buffers and the other pair (the next
        // update's, and until its copy starts those of the further tiles),
        // chosen by selects: an array indexed at run time would put S in local
        // memory.  K4: both are the one pair.
        const bool odd = FOLD && (k & 1);
        float* xs = odd ? S.xs[1] : S.xs[0];
        float* nz = odd ? S.nz[1] : S.nz[0];
        float* xs2 = odd ? S.xs[0] : S.xs[1];
        float* nz2 = odd ? S.nz[0] : S.nz[1];
        if (FOLD) {
            // start the next update's copy, then wait for this update's; a
            // block with further tiles starts it after them
            if (k + 1 < g.K && !more) {
                load_tile<TS, 4, true>(g, k + 1, blockIdx.x, xs2, nz2);
                cp_async_commit();
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            phase(K_TILE, SITE_KERNEL);
        }
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            const bool resident = FOLD && t == (int)blockIdx.x;
            if (!resident) {
                __syncthreads();
                load_tile<TS, 4, false>(g, k, t, xs2, nz2);
                __syncthreads();
                phase(K_TILE, SITE_KERNEL);
            }
            critic_tile<H, T>(g, S, resident ? xs : xs2, resident ? nz : nz2, part,
                              t == (int)blockIdx.x, tile_samples<TS>(g, t));
            phase(K_CRITIC, SITE_KERNEL);
        }
        grid.sync();
        phase(K_SYNC_C, SITE_KERNEL);
        critic_apply<H, L, true, BF>(g, k, G, G / C, a_lr, c_eps);
        phase(K_CRITIC_ADAM, SITE_KERNEL);
        grid.sync();
        phase(K_SYNC_CA, SITE_KERNEL);
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            const bool resident = FOLD && t == (int)blockIdx.x;
            if (!resident) {
                __syncthreads();
                load_tile<TS, 4, false>(g, k, t, xs2, nz2);
                __syncthreads();
                phase(K_ACTOR_TILE, SITE_KERNEL);
            }
            actor_tile<H, T>(g, S, resident ? xs : xs2, resident ? nz : nz2, part,
                             g.stash + (size_t)t * 2 * TS * H, t == (int)blockIdx.x,
                             tile_samples<TS>(g, t));
            phase(K_ACTOR, SITE_KERNEL);
        }
        if (more && k + 1 < g.K) {
            // the further tiles are done with the second buffer: the next
            // update's resident tile goes there
            __syncthreads();
            load_tile<TS, 4, true>(g, k + 1, blockIdx.x, xs2, nz2);
            cp_async_commit();
        }
        grid.sync();
        phase(K_SYNC_A, SITE_KERNEL);
        actor_apply<H, BF>(g, k, G, G / C, a_lr, c_eps);
        phase(K_ACTOR_ADAM, SITE_KERNEL);
        grid.sync();
        phase(K_SYNC_AA, SITE_KERNEL);
    }
}

// ------------------------------------------------------------------ host --
// Plan errors: -1 width not built, -2 shared memory does not fit; launch
// errors: learner_tiles.cuh, launch_checked.  Other non-zero codes are
// cudaError_t.  K4 and K5 plan the same grid and cluster size
// (learner_tiles.cuh, plan_launch), each on K5's shared memory, so that they
// give the same bits.
template <int H, bool FOLD, bool BF>
int plan(int W, int od, int n_tiles, int cmax, int* out) {
    const size_t smem1 = smem_floats<H, FOLD, BF>(W) * sizeof(float);
    const size_t x = xfloats<H>(od + 2 + NHEAD) * sizeof(float);
    // clusters where K5's shared memory, the larger, leaves room for the exchange
    const size_t fold = smem_floats<H, true, BF>(W) * sizeof(float);
    int err = plan_launch(sac_update_kernel<H, FOLD, BF, false>,
                          sac_update_kernel<H, FOLD, BF, true>, Tile<H>::NT, H, smem1, fold + x,
                          n_tiles, cmax, out);
    if (err == 0 && out[2] > 1) out[1] = (int)(smem1 + x);
    return err;
}

template <bool FOLD, bool BF>
int plan_any(int H, int W, int od, int n_tiles, int cmax, int* out) {
    return dispatch_width(H, [&](auto h) {
        return plan<decltype(h)::value, FOLD, BF>(W, od, n_tiles, cmax, out);
    });
}

template <bool FOLD, bool BF>
int launch_any(int H, const Args& g, int grid, int cluster, cudaStream_t stream) {
    return dispatch_width(H, [&](auto h) {
        constexpr int HW = decltype(h)::value;
        auto plan_hw = [&](int tiles, int cmax, int* out) {
            return plan<HW, FOLD, BF>(g.W, g.od, tiles, cmax, out);
        };
        return launch_checked<HW, BF>(plan_hw, sac_update_kernel<HW, FOLD, BF, false>,
                                      sac_update_kernel<HW, FOLD, BF, true>, g, grid, cluster,
                                      stream);
    });
}

}  // namespace sac

// The phase clock's entry points (a -DSG_PHASE_CLOCK build only).
SG_PHASE_ENTRIES(sac, SG_SITES)

// The two C entry points of one library: `NAME_plan(H, W, od, n_tiles, bf,
// cmax, out)` gives the grid size, the shared-memory bytes and the cluster
// size (at most cmax) of a mode, `NAME(...)` launches with them (partials:
// one slot a cluster): bf (mm_bf16) 0 the float32 products on the CUDA
// cores, reading the transposed copy `wt`; 1 the bf16 products on the tensor
// cores, reading the shadow `wb`.  The scratch of the other mode may be null.
#define SAC_UPDATE_ENTRY(NAME, FOLD)                                                          \
    extern "C" int NAME##_plan(int H, int W, int od, int n_tiles, int bf, int cmax,           \
                               int* out) {                                                    \
        return bf ? sac::plan_any<FOLD, true>(H, W, od, n_tiles, cmax, out)                   \
                  : sac::plan_any<FOLD, false>(H, W, od, n_tiles, cmax, out);                 \
    }                                                                                         \
    extern "C" int NAME(float* w, float* vec, float* mw, float* vw, float* mvec, float* vvec, \
                        const float* data, const int* row_idx, const float* noise,            \
                        float* losses, float* partials, float* wt, float* stash,              \
                        __nv_bfloat16* wb, int H, int K, int B, int W, int lanes, int rpb,    \
                        int od, int grid, int cluster, int bf, int has_floor, float gamma,    \
                        float tau, float lr, float te, float count0, float logfloor,          \
                        void* stream) {                                                       \
        sac::Args g{w, vec, mw, vw, mvec, vvec, data, row_idx, noise, losses, partials, wt,   \
                    stash, wb, K, B, W, lanes, rpb, od, bf, has_floor, gamma, tau, lr, te,    \
                    count0, logfloor};                                                        \
        return bf ? sac::launch_any<FOLD, true>(H, g, grid, cluster, (cudaStream_t)stream)    \
                  : sac::launch_any<FOLD, false>(H, g, grid, cluster, (cudaStream_t)stream);  \
    }
