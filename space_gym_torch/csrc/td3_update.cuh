// K TD3 updates in one cooperative kernel launch: the device code of K6
// (td3_update.cu).
//
// Replaces the Pallas kernel of space_gym_tpu/models/fused_td3.py:421 (grid
// (K, 2, T)).  What is computed is its inner `kernel` (:431): per update, the
// target actor's action on next_obs with clipped smoothing noise, both target
// critics, the twin critics' TD loss with a hand-written backward and their
// Adam step; then the actor's loss -mean(q1) through the UPDATED critic 0,
// which is reported for every update, and, only on every policy_delay-th
// update, the actor's backward, its Adam step (with its own step count) and the
// polyak step of BOTH targets.  The plain version is
// models/fused_td3.py::update_k_reference.
//
// Design for this card: that of K4 (sac_update.cuh), on the same tile code.
// The work is a chain of (batch, H) x (H, H) products, 9 per sample in the
// critic stage, 2 in the actor stage and 3 more on a delayed update:
// operations bound it, not bytes.  A thread block owns tiles of TS samples,
// holds two (TS, H) activation buffers in shared memory and streams the
// weights from L2, where the whole state stays for all K updates.  The mode is
// a template parameter of the kernel:
// - mm_bf16 (args.bf, the trainer's mode): the operands of the products that
//   the Pallas body sends through `dot` (bf16 mode :435-436), and the
//   post-ReLU activations, are bf16 values, so the products run on the
//   tensor cores (learner_mma.cuh, MTile: mma.sync.m16n8k16 bf16 -> float32,
//   a warp a 32 x 64 piece): the H x H products, the weight gradients, the
//   first layers' obs rows and the row dots (heads, q, the action columns of
//   dz1 . W1^T).  They read a bf16 shadow `wb` of the W1 and W2 of all six
//   networks (actor, target actor, critics, target critics), built at the
//   start of the launch and rewritten where the float32 weights change: the
//   critics' Adam stage for the critics, the delayed stage for the actor and
//   for both targets (their polyak step).  The weights stream into two
//   XOR-swizzled shared-memory stages by cp.async.  The products that the
//   Pallas body sends through `_dg` (action rows and bias of the critics'
//   first layers, dq x w3, the b1 gradients and the critics' action-row
//   gradients) stay float32 on the CUDA cores.
// - float32 (mm_bf16 False): every product in float32 multiply-adds on the
//   CUDA cores (learner_tiles.cuh, Tile: each thread an 8 x 8 tile, weights
//   staged 16 rows at a time); dz2 . W2^T reads a transposed copy `wt` of the
//   three trainable W2, built at the start and kept current by the Adam stages.
//
// Order across the batch: the launch is cooperative.  Every update has the
// stages critic tiles -> critics' Adam -> actor tiles, with a grid-wide barrier
// after the first two; a delayed update adds a barrier, the stage actor's Adam
// + both polyak steps, and a barrier.  Whether an update is delayed depends on
// the counts and k alone, so every block takes the same barriers.  On the
// other updates the actor tiles run the forward only, park nothing and need no
// barrier after them: the next update's critic tiles read nothing they write.
//
// Deterministic sums: a cluster of C blocks writes the gradients of its
// blocks' tiles to its own slot of `partials`, summed on chip in rank order
// (the clusters and the plan as in sac_update.cuh), and a block its
// actor-loss sums to its own column of `alp`; the Adam stages and the end of
// the launch sum them in index order, no atomics.
//
// Partial tiles: a batch, or a ring's lanes, that TS does not divide ends in a
// partial tile (learner_tiles.cuh, load_tile); its samples past the end are
// zero inputs with zero seeds (dq, the actor's -1/B) and add nothing.
//
// The critics' first-layer bias is added plainly (the TPU kernel folds it
// into a weight row for the launch's duration): the moments of c_b1 stay in
// their vec rows and the padded rows of w stay zero.
#pragma once

#include "learner_mma.cuh"
#include "learner_tiles.cuh"

namespace td3 {

using namespace tiles;

// The phase clock's ids in this kernel (learner_tiles.cuh): the kernel's own
// marks, and each call site of a shared stage with the marks of its stage.
#define TD3_KERNEL_MARKS(X)                                                          \
    X(K_PROLOGUE, "prologue") X(K_TILE, "critic tile load") X(K_CRITIC, "critic misc") \
    X(K_SYNC_C, "grid sync") X(K_CRITIC_ADAM, "critic Adam") X(K_SYNC_CA, "grid sync") \
    X(K_ACTOR_TILE, "actor tile load") X(K_ACTOR, "actor misc")                     \
    X(K_SYNC_A, "grid sync") X(K_ACTOR_APPLY, "actor Adam, polyak") X(K_SYNC_AA, "grid sync")
#define TD3_DLDA_MARKS(X)                                                            \
    X(D_FILL, "dz2 fill") X(D_BWD, "dz2 . W2^T") X(D_DZ1, "dz1 (mask bits)")       \
    X(D_DOTS, "action dots")
#define TD3_SITES(X)                                                                 \
    X(SITE_KERNEL, "kernel", TD3_KERNEL_MARKS)                                      \
    X(SITE_TARGET_ACTOR, "critic stage, target actor on next obs", SG_STAGE_MARKS)  \
    X(SITE_TARGETS, "critic stage, targets", SG_STAGE_MARKS)                        \
    X(SITE_CRITICS, "critic stage, critics", SG_STAGE_MARKS)                        \
    X(SITE_ACTOR, "actor stage, actor", SG_STAGE_MARKS)                             \
    X(SITE_ACTOR_CRITIC, "actor stage, critic 0", SG_STAGE_MARKS)                   \
    X(SITE_DLDA, "actor stage, dL/da", TD3_DLDA_MARKS)                              \
    X(SITE_ACTOR_BACK, "actor stage, actor backward", SG_ACTOR_BACK_MARKS)
enum KernelMark { TD3_KERNEL_MARKS(SG_MARK_ID) };
enum DldaMark { TD3_DLDA_MARKS(SG_MARK_ID) };
enum Site { TD3_SITES(SG_SITE_ID) };

constexpr int AH = 2;         // actor head rows (deterministic: the action only)
constexpr int NSMALL = 12;    // per-sample scalar arrays in shared memory

// vec rows and misc columns (fused_td3.py:309-318)
constexpr int V_AB1 = 0, V_AB2 = 1, V_TAB1 = 2, V_TAB2 = 3;
constexpr int M_ABH = 0, M_TABH = 2;

struct Args {
    float *w, *vec, *mw, *vw, *mvec, *vvec;   // state, updated in place
    const float* data;     // (K, W, B) minibatches, or the (rows, W, lanes) ring
    const int* row_idx;    // (K * rpb,) ring rows, unused when rpb == 0
    const float* noise;    // (K, 2, B) target-smoothing normals
    float* losses;         // (K, 2)
    float* partials;       // (grid / C, prows, H) gradient sums, one slot a cluster of C blocks
    float* wt;             // (3, H, H) transposed W2 of critic 0, critic 1, actor (float32 mode)
    float* stash;          // (n_tiles, 2, TS, H) the actor's activations
    float* alp;            // (K, grid) per-block actor-loss sums
    bf16* wb;              // (6 (IN1 + H), H) bf16 shadow of w's first 6 (IN1 + H) rows (bf16 mode)
    int K, B, W, lanes, rpb, od, bf;
    int count0, count_a0, delay;   // updates and applied actor steps so far
    float gamma, tau, lr, sstd, sclip;
};

template <int H>
struct Lay {
    static constexpr int R_AW1 = 0;
    static constexpr int R_AW2 = IN1;
    static constexpr int R_TAW1 = IN1 + H;
    static constexpr int R_TAW2 = 2 * IN1 + H;
    static constexpr int R_AWH = 6 * (IN1 + H);
    static constexpr int R_TAWH = R_AWH + AH;
    __host__ __device__ static constexpr int r_cw1(int c) { return (2 + c) * (IN1 + H); }
    __host__ __device__ static constexpr int r_tw1(int c) { return (4 + c) * (IN1 + H); }
    static constexpr int V_CB1 = 4, V_CB2 = 6, V_TB1 = 8, V_TB2 = 10, V_CW3 = 12, V_TW3 = 14;
    static constexpr int V_MISC = 16, M_CB3 = 4, M_TB3 = 6;
};

template <int H, bool BF>
__host__ __device__ constexpr size_t smem_floats(int W) {
    constexpr int TS = 8 * row_groups(H);
    return (size_t)2 * TS * H + (BF ? MTile<H>::NS * MTile<H>::STAGE / 2 : KC * H) + W * TS
           + AH * TS + W * TS + NSMALL * TS + 2 * TS * (H / 32) + 32;
}

struct Smem : Bufs {
    float *xs, *nz, *sm;
    unsigned* mask;
};

template <int H, bool BF>
__device__ Smem carve(float* base, int W) {
    constexpr int TS = Tile<H>::TS;
    Smem s;
    s.A = base; base += TS * H;
    s.Bm = base; base += TS * H;
    s.wch = BF ? nullptr : base;
    s.ring = BF ? reinterpret_cast<bf16*>(base) : nullptr;
    base += BF ? MTile<H>::NS * MTile<H>::STAGE / 2 : KC * H;
    s.xs = base; base += W * TS;
    s.nz = base; base += AH * TS;
    s.xin = base; base += W * TS;
    s.sm = base; base += NSMALL * TS;
    s.mask = reinterpret_cast<unsigned*>(base); base += 2 * TS * (H / 32) + 32;
    s.x = base;    // the exchange rows, there in a launch of clusters only
    return s;
}

// Row `row` of the bf16 shadow (rows as in `w`), null in float32 mode.
template <int H>
__device__ const bf16* shadow(const Args& g, int row) {
    return g.wb ? g.wb + (size_t)row * H : nullptr;
}

// The operands of the actor (target false) or the target actor, and of critic
// c (target false) or target critic c, in `w`, `vec` and the shadow.
template <int H>
__device__ ActorRefs actor_refs(const Args& g, bool target) {
    using L = Lay<H>;
    const float* misc = g.vec + L::V_MISC * H;
    if (target)
        return {g.w + L::R_TAW1 * H, g.w + L::R_TAW2 * H, g.w + (size_t)L::R_TAWH * H,
                g.vec + V_TAB1 * H, g.vec + V_TAB2 * H, misc + M_TABH,
                shadow<H>(g, L::R_TAW1), shadow<H>(g, L::R_TAW2)};
    return {g.w + L::R_AW1 * H, g.w + L::R_AW2 * H, g.w + (size_t)L::R_AWH * H,
            g.vec + V_AB1 * H, g.vec + V_AB2 * H, misc + M_ABH,
            shadow<H>(g, L::R_AW1), shadow<H>(g, L::R_AW2)};
}

template <int H>
__device__ CriticRefs critic_refs(const Args& g, int c, bool target) {
    using L = Lay<H>;
    const float* misc = g.vec + L::V_MISC * H;
    const int r1 = target ? L::r_tw1(c) : L::r_cw1(c);
    if (target)
        return {g.w + (size_t)r1 * H, g.w + (size_t)(r1 + IN1) * H, nullptr,
                g.vec + (L::V_TB1 + c) * H, g.vec + (L::V_TB2 + c) * H,
                g.vec + (L::V_TW3 + c) * H, misc[L::M_TB3 + c],
                shadow<H>(g, r1), shadow<H>(g, r1 + IN1)};
    return {g.w + (size_t)r1 * H, g.w + (size_t)(r1 + IN1) * H,
            g.wt ? g.wt + (size_t)c * H * H : nullptr, g.vec + (L::V_CB1 + c) * H,
            g.vec + (L::V_CB2 + c) * H, g.vec + (L::V_CW3 + c) * H, misc[L::M_CB3 + c],
            shadow<H>(g, r1), shadow<H>(g, r1 + IN1)};
}

// ---------------------------------------------------------------- critic --
// The slot's rows are those of learner_tiles.cuh::critic_apply: critic 0's
// n1 + 3 + H gradient rows, critic 1's, and a row with b3 and the loss sums.
// The tile's first nv samples are real.
template <int H, class T>
__device__ void critic_tile(const Args& g, const Smem& S, float* part, bool first, int nv) {
    constexpr int TS = Tile<H>::TS;
    // the mode (args.bf) as a constant of the instantiation: float32 mode's
    // code carries no bf16 rounding
    const int od = g.od, n1 = od + 2, bf = T::MMA, CS = n1 + 3 + H;
    const int n0 = ceil8(od), a0 = ceil8(n0 + od), rr = a0 + 2, dd = rr + 1;
    float* qt = S.sm;                 // [2][TS]
    float* tq = S.sm + 2 * TS; float* q = S.sm + 3 * TS; float* dq = S.sm + 4 * TS;
    float* lsum = S.sm + 5 * TS;
    float* head = S.sm + 6 * TS;      // [2][TS]
    T t;
    const int tid = threadIdx.x;

    // the target actor on next_obs, its action smoothed with clipped noise
    copy_rows<TS>(S.xs, n0, S.xin, 0, od, bf);
    phase(K_CRITIC, SITE_KERNEL);
    phase_site(SITE_TARGET_ACTOR);
    actor_forward<H, AH>(t, S, actor_refs<H>(g, true), od, bf, head, nullptr);
    if (tid < TS)
        for (int e = 0; e < AH; e++) {
            float eps = fminf(fmaxf(S.nz[e * TS + tid] * g.sstd, -g.sclip), g.sclip);
            S.xin[(od + e) * TS + tid] = fminf(fmaxf(tanhf(head[e * TS + tid]) + eps, -1.0f), 1.0f);
        }
    // the target critics on (next_obs, next action)
    phase(K_CRITIC, SITE_KERNEL);
    phase_site(SITE_TARGETS);
    for (int c = 0; c < 2; c++)
        critic_forward<H>(t, S, critic_refs<H>(g, c, true), od, bf, qt + c * TS);
    __syncthreads();
    if (tid < TS)
        tq[tid] = S.xs[rr * TS + tid] + g.gamma * S.xs[dd * TS + tid] * fminf(qt[tid], qt[TS + tid]);
    // the critics on (obs, action), forward and backward
    copy_rows<TS>(S.xs, 0, S.xin, 0, od, bf);
    copy_rows<TS>(S.xs, a0, S.xin, od, 2, 0);
    phase(K_CRITIC, SITE_KERNEL);
    phase_site(SITE_CRITICS);
    for (int c = 0; c < 2; c++)
        critic_grad<H>(t, S, critic_refs<H>(g, c, false), tq, q, dq, lsum,
                       part + (size_t)c * CS * H, part + (size_t)2 * CS * H + c, od, g.B, bf,
                       first, nv);
}

// ----------------------------------------------------------------- actor --
// The actor's loss -sum(q1) / B over the tile's nv samples into *alp, and
// with `bwd` its backward through critic 0 into the block's partial slot:
// [0, od) W1, od b1, od+1 b2, [od+2, od+4) head^T, [od+4, od+4+H) W2, and a
// row with the head's bias gradients [0, 2).
template <int H, class T>
__device__ void actor_tile(const Args& g, const Smem& S, float* part, float* stash, float* alp,
                           bool bwd, bool first, int nv) {
    using L = Lay<H>;
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    const int od = g.od, bf = T::MMA;
    const float invb = (float)(1.0 / g.B);
    float* act = S.sm;               // [2][TS]
    float* head = S.sm + 2 * TS;     // [2][TS]
    float* q1 = S.sm + 4 * TS;
    float* gh = S.sm + 5 * TS;       // [2][TS]
    float* dav = S.sm + 7 * TS;      // [2][TS] the action columns of dz1 . W1^T
    unsigned* m1 = S.mask;
    unsigned* m2 = S.mask + TS * (H / 32);
    T t;
    const int tid = threadIdx.x;

    // the actor on obs; on a delayed update h1 and h2 are kept in device
    // memory (L2) while critic 0 uses the two buffers
    copy_rows<TS>(S.xs, 0, S.xin, 0, od, bf);
    phase(K_ACTOR, SITE_KERNEL);
    phase_site(SITE_ACTOR);
    actor_forward<H, AH>(t, S, actor_refs<H>(g, false), od, bf, head, bwd ? stash : nullptr);
    if (tid < TS)
        for (int e = 0; e < AH; e++) {
            float a = tanhf(head[e * TS + tid]);
            act[e * TS + tid] = a;
            S.xin[(od + e) * TS + tid] = a;
        }
    // the updated critic 0 on (obs, the actor's action)
    phase(K_ACTOR, SITE_KERNEL);
    phase_site(SITE_ACTOR_CRITIC);
    const CriticRefs c0 = critic_refs<H>(g, 0, false);
    critic_forward<H>(t, S, c0, od, bf, q1);
    if (bwd) {
        t.mask(S.A, m1);
        t.mask(S.Bm, m2);
    }
    __syncthreads();
    if (tid < 32) {
        float qs = tile_sum<TS>(q1, nv);
        if (tid == 0) put(alp, -qs * invb, first);
    }
    if (!bwd) return;
    // dL/da through critic 0: dq = -1/B for every real sample, none for the
    // padded ones (their mask bits cleared)
    if (nv < TS) {
        for (int i = nv * (H / 32) + tid; i < TS * (H / 32); i += NT) m2[i] = 0u;
        __syncthreads();
    }
    phase(M_DQ);
    for (int j = tid; j < H; j += NT) {
        float dh2 = rnd(-invb * c0.w3[j], bf);
        for (int s = 0; s < TS; s++) S.Bm[T::ix(s, j)] = mask_bit(m2, s, j, H) ? dh2 : 0.f;
    }
    phase(D_FILL, SITE_DLDA);
    t.bwd(S, S.Bm, c0.w2t, c0.w2b, bf);
    phase(D_BWD, SITE_DLDA);
    t.masked_bits(m1, S.A);       // dz1
    __syncthreads();
    phase(D_DZ1, SITE_DLDA);
    // only the action columns of the input gradient are needed, then through
    // tanh to the head
    const float* wact = c0.w1 + (size_t)od * H;
    if constexpr (T::MMA) {
        const float none[AH] = {0.f, 0.f};
        t.row_dots(S.A, wact, H, none, bf, dav);     // rounds dz1 as it reads it
        __syncthreads();
        if (tid < TS)
            for (int e = 0; e < AH; e++)
                gh[e * TS + tid] = dav[e * TS + tid] * (1.0f - act[e * TS + tid] * act[e * TS + tid]);
    } else {
        for (int e = 0; e < AH; e++) {
            int warp = tid / 32, lane = tid % 32;
            const float* wrow = wact + (size_t)e * H;
            for (int s = warp; s < TS; s += NT / 32) {
                float v = 0.f;
                for (int j = lane; j < H; j += 32) v += rnd(S.A[s * H + j], bf) * rnd(wrow[j], bf);
                v = warp_sum(v);
                if (lane == 0) gh[e * TS + s] = v * (1.0f - act[e * TS + s] * act[e * TS + s]);
            }
        }
    }
    __syncthreads();
    phase(D_DOTS, SITE_DLDA);
    phase_site(SITE_ACTOR_BACK);
    actor_backward<H, AH>(t, S, gh, stash, g.w + (size_t)L::R_AWH * H,
                          g.wt ? g.wt + (size_t)2 * H * H : nullptr, part, od, bf, first, AH,
                          shadow<H>(g, L::R_AW2));
}

// The delayed stage: Adam on the actor from the nslots partial slots summed in
// index order, then the
// polyak step of the target actor and of the target critics from the new
// weights; the whole grid takes part.  The new actor W2 goes to the
// transposed copy, or in bf16 mode the new W1 obs rows and W2 of the actor,
// the target actor and the target critics to the shadow, the actor's part a
// thread four neighbouring elements (slot_sum4, adam4).
template <int H, bool BF>
__device__ void actor_apply(const Args& g, int grid, int nslots, float a_lr, float c_eps) {
    using L = Lay<H>;
    const int od = g.od, AS = od + 2 + AH + H;
    const int prows = 2 * (od + 2 + 3 + H) + 1;
    const size_t slot = (size_t)prows * H;
    const float tau = g.tau, omt = 1.0f - g.tau;
    const int gtid = blockIdx.x * blockDim.x + threadIdx.x, gsz = grid * blockDim.x;
    // where element (lr, j) of the slots' row layout lives: the weight, its
    // moments, its target; for a row of w its row there and its target's (-1
    // for the bias rows of vec)
    auto where = [&](int lr, int j, float*& wp, float*& mp, float*& vp, float*& tp, int& row,
                     int& trow) {
        if (lr == od || lr == od + 1) {
            size_t o = (size_t)(lr == od ? V_AB1 : V_AB2) * H + j;
            wp = g.vec + o; mp = g.mvec + o; vp = g.vvec + o;
            tp = g.vec + (size_t)(lr == od ? V_TAB1 : V_TAB2) * H + j;
            row = trow = -1;
        } else {
            row = lr < od ? L::R_AW1 + lr
                  : lr < od + 2 + AH ? L::R_AWH + lr - (od + 2) : L::R_AW2 + lr - (od + 2 + AH);
            trow = lr < od ? L::R_TAW1 + lr
                   : lr < od + 2 + AH ? L::R_TAWH + lr - (od + 2) : L::R_TAW2 + lr - (od + 2 + AH);
            size_t o = (size_t)row * H + j;
            wp = g.w + o; mp = g.mw + o; vp = g.vw + o;
            tp = g.w + (size_t)trow * H + j;
        }
    };
    if constexpr (BF) {
        for (int e = 4 * gtid; e < AS * H; e += 4 * gsz) {
            int lr = e / H, j = e % H;
            float4 gr = slot_sum4(g.partials + (size_t)lr * H + j, nslots, slot);
            float *wp, *mp, *vp, *tp;
            int row, trow;
            where(lr, j, wp, mp, vp, tp, row, trow);
            const float4 wn = adam4(wp, mp, vp, gr, a_lr, c_eps);
            float4 t = *reinterpret_cast<const float4*>(tp);
            t.x = omt * t.x + tau * wn.x;
            t.y = omt * t.y + tau * wn.y;
            t.z = omt * t.z + tau * wn.z;
            t.w = omt * t.w + tau * wn.w;
            *reinterpret_cast<float4*>(tp) = t;
            if (lr < od || lr >= od + 2 + AH) {      // W1's obs rows and W2, not the head
                store_bf16x4(g.wb + (size_t)row * H + j, wn);
                store_bf16x4(g.wb + (size_t)trow * H + j, t);
            }
        }
    } else {
        for (int e = gtid; e < AS * H; e += gsz) {
            int lr = e / H, j = e % H;
            const float* p = g.partials + (size_t)lr * H + j;
            float gr = 0.f;
            for (int b = 0; b < nslots; b++) gr += p[b * slot];
            float *wp, *mp, *vp, *tp;
            int row, trow;
            where(lr, j, wp, mp, vp, tp, row, trow);
            float wn = adam_elem(wp, mp, vp, gr, a_lr, c_eps);
            *tp = omt * *tp + tau * wn;
            if (lr >= od + 2 + AH) g.wt[(size_t)2 * H * H + (size_t)j * H + (lr - (od + 2 + AH))] = wn;
        }
    }
    if (blockIdx.x == 0 && threadIdx.x < AH) {
        const float* pm = g.partials + (size_t)AS * H;
        int c = threadIdx.x;
        float gr = 0.f;
        for (int b = 0; b < nslots; b++) gr += pm[b * slot + c];
        size_t o = (size_t)L::V_MISC * H + M_ABH + c;
        float wn = adam_elem(g.vec + o, g.mvec + o, g.vvec + o, gr, a_lr, c_eps);
        size_t ot = (size_t)L::V_MISC * H + M_TABH + c;
        g.vec[ot] = omt * g.vec[ot] + tau * wn;
    }
    // the target critics: both (IN1 + H)-row blocks of w, the b1, b2 and w3
    // rows of vec, and b3 (padded rows are zero and stay zero)
    const int cw = 2 * (IN1 + H) * H;
    for (int e = gtid; e < cw + 6 * H + 2; e += gsz) {
        float *tp;
        const float* sp;
        if (e < cw) {
            sp = g.w + (size_t)L::r_cw1(0) * H + e;
            tp = g.w + (size_t)L::r_tw1(0) * H + e;
        } else if (e < cw + 6 * H) {
            int r = (e - cw) / H, j = (e - cw) % H;   // rows b1 (2), b2 (2), w3 (2)
            int vs = r < 4 ? L::V_CB1 + r : L::V_CW3 + r - 4;
            int vt = r < 4 ? L::V_TB1 + r : L::V_TW3 + r - 4;
            sp = g.vec + (size_t)vs * H + j;
            tp = g.vec + (size_t)vt * H + j;
        } else {
            sp = g.vec + (size_t)L::V_MISC * H + L::M_CB3 + (e - cw - 6 * H);
            tp = g.vec + (size_t)L::V_MISC * H + L::M_TB3 + (e - cw - 6 * H);
        }
        *tp = omt * *tp + tau * *sp;
        if constexpr (BF) {
            // the shadow of the targets' W1 obs rows and W2 (their action rows stay zero)
            const int lr = (e / H) % (IN1 + H);
            if (e < cw && (lr < od || lr >= IN1))
                g.wb[(size_t)L::r_tw1(0) * H + e] = __float2bfloat16_rn(*tp);
        }
    }
}

// ---------------------------------------------------------------- kernel --
template <int H, bool BF, bool CL>
__global__ void __launch_bounds__(Tile<H>::NT, 1) td3_update_kernel(Args g) {
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
    Smem S = carve<H, BF>(smem_base, g.W);
    // the cluster's slot: one a cluster of C blocks (CL false: no clusters,
    // C = 1, and the stages' cluster code drops out of the instantiation)
    const int C = CL ? (int)cg::this_cluster().num_blocks() : 1;
    S.cn = C;
    S.crank = CL ? (int)cg::this_cluster().block_rank() : 0;
    float* part = g.partials + (size_t)(blockIdx.x / C) * prows * H;
    phase(-1, SITE_KERNEL);  // starts the clock

    if (BF) {
        // the bf16 shadow of the W1 and W2 of the actor, the target actor, the
        // critics and the target critics (w's first 6 (IN1 + H) rows); W1's
        // rows from od on are zero, the critics' action rows stay float32 in w
        for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 6 * (IN1 + H) * H;
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
    grid.sync();
    phase(K_PROLOGUE, SITE_KERNEL);

    int applied = 0;   // actor steps applied in this launch so far
    for (int k = 0; k < g.K; k++) {
        // the counts are ints; an update is delayed when the updates so far
        // are a multiple of the delay (fused_td3.py:451)
        const int n_upd = g.count0 + k;
        const bool do_actor = n_upd % g.delay == 0;
        float a_lr, c_eps;
        adam_scalars((float)(n_upd + 1), g.lr, a_lr, c_eps);
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            __syncthreads();
            load_tile<TS, AH, false>(g, k, t, S.xs, S.nz);
            __syncthreads();
            phase(K_TILE, SITE_KERNEL);
            critic_tile<H, T>(g, S, part, t == (int)blockIdx.x, tile_samples<TS>(g, t));
            phase(K_CRITIC, SITE_KERNEL);
        }
        grid.sync();
        phase(K_SYNC_C, SITE_KERNEL);
        critic_apply<H, L, false, BF>(g, k, G, G / C, a_lr, c_eps);
        phase(K_CRITIC_ADAM, SITE_KERNEL);
        grid.sync();
        phase(K_SYNC_CA, SITE_KERNEL);
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            __syncthreads();
            load_tile<TS, AH, false>(g, k, t, S.xs, S.nz);
            __syncthreads();
            phase(K_ACTOR_TILE, SITE_KERNEL);
            actor_tile<H, T>(g, S, part, g.stash + (size_t)t * 2 * TS * H,
                             g.alp + (size_t)k * G + blockIdx.x, do_actor, t == (int)blockIdx.x,
                             tile_samples<TS>(g, t));
            phase(K_ACTOR, SITE_KERNEL);
        }
        if (do_actor) {
            grid.sync();
            phase(K_SYNC_A, SITE_KERNEL);
            applied++;
            adam_scalars((float)(g.count_a0 + applied), g.lr, a_lr, c_eps);
            actor_apply<H, BF>(g, G, G / C, a_lr, c_eps);
            phase(K_ACTOR_APPLY, SITE_KERNEL);
            grid.sync();
            phase(K_SYNC_AA, SITE_KERNEL);
        }
    }
    // the actor losses, each the sum of its blocks' sums in index order
    grid.sync();
    if (blockIdx.x == 0)
        for (int k = threadIdx.x; k < g.K; k += blockDim.x) {
            float ls = 0.f;
            for (int b = 0; b < G; b++) ls += g.alp[(size_t)k * G + b];
            g.losses[k * 2 + 1] = ls;
        }
}

// ------------------------------------------------------------------ host --
// Plan errors: -1 width not built, -2 shared memory does not fit; launch
// errors: learner_tiles.cuh, launch_checked.  Other non-zero codes are
// cudaError_t.  The grid and the cluster size: learner_tiles.cuh, plan_launch.
template <int H, bool BF>
int plan(int W, int od, int n_tiles, int cmax, int* out) {
    const size_t smem1 = smem_floats<H, BF>(W) * sizeof(float);
    // the largest group of exchange rows: a critic's n1 + 3
    const size_t smemx = smem1 + xfloats<H>(od + 5) * sizeof(float);
    return plan_launch(td3_update_kernel<H, BF, false>, td3_update_kernel<H, BF, true>,
                       Tile<H>::NT, H, smem1, smemx, n_tiles, cmax, out);
}

template <bool BF>
int plan_any(int H, int W, int od, int n_tiles, int cmax, int* out) {
    return dispatch_width(H, [&](auto h) {
        return plan<decltype(h)::value, BF>(W, od, n_tiles, cmax, out);
    });
}

template <bool BF>
int launch_any(int H, const Args& g, int grid, int cluster, cudaStream_t stream) {
    return dispatch_width(H, [&](auto h) {
        constexpr int HW = decltype(h)::value;
        auto plan_hw = [&](int tiles, int cmax, int* out) {
            return plan<HW, BF>(g.W, g.od, tiles, cmax, out);
        };
        return launch_checked<HW, BF>(plan_hw, td3_update_kernel<HW, BF, false>,
                                      td3_update_kernel<HW, BF, true>, g, grid, cluster, stream);
    });
}

}  // namespace td3

// The phase clock's entry points (a -DSG_PHASE_CLOCK build only).
SG_PHASE_ENTRIES(td3, TD3_SITES)

// The two C entry points: `sg_td3_update_plan(H, W, od, n_tiles, bf, cmax,
// out)` gives the grid size, the shared-memory bytes and the cluster size (at
// most cmax) of a mode, `sg_td3_update(...)` launches with them (partials:
// one slot a cluster): bf (mm_bf16) 0 the float32 products on the CUDA cores,
// reading the transposed copy `wt`; 1 the bf16 products on the tensor cores,
// reading the shadow `wb`.  The scratch of the other mode may be null.
#define TD3_UPDATE_ENTRY()                                                                     \
    extern "C" int sg_td3_update_plan(int H, int W, int od, int n_tiles, int bf, int cmax,     \
                                      int* out) {                                              \
        return bf ? td3::plan_any<true>(H, W, od, n_tiles, cmax, out)                          \
                  : td3::plan_any<false>(H, W, od, n_tiles, cmax, out);                        \
    }                                                                                          \
    extern "C" int sg_td3_update(float* w, float* vec, float* mw, float* vw, float* mvec,      \
                                 float* vvec, const float* data, const int* row_idx,           \
                                 const float* noise, float* losses, float* partials,           \
                                 float* wt, float* stash, float* alp, __nv_bfloat16* wb,       \
                                 int H, int K, int B, int W, int lanes, int rpb, int od,       \
                                 int grid, int cluster, int bf, int count0, int count_a0,      \
                                 int delay, float gamma, float tau, float lr, float sstd,      \
                                 float sclip, void* stream) {                                  \
        td3::Args g{w, vec, mw, vw, mvec, vvec, data, row_idx, noise, losses, partials, wt,    \
                    stash, alp, wb, K, B, W, lanes, rpb, od, bf, count0, count_a0, delay,      \
                    gamma, tau, lr, sstd, sclip};                                              \
        return bf ? td3::launch_any<true>(H, g, grid, cluster, (cudaStream_t)stream)           \
                  : td3::launch_any<false>(H, g, grid, cluster, (cudaStream_t)stream);         \
    }
