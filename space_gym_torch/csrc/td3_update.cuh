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
// Design for this card: that of K4 (sac_update.cuh), on the same tile code
// (learner_tiles.cuh).  The work is a chain of (batch, H) x (H, H) products,
// 9 per sample in the critic stage, 2 in the actor stage and 3 more on a
// delayed update: operations bound it, not bytes.  A thread block owns tiles of
// TS samples, holds two (TS, H) activation buffers in shared memory and streams
// the weights in chunks of KC rows from L2, where the whole state stays for
// all K updates; every product is float32 multiply-adds on the CUDA cores.
//
// Order across the batch: the launch is cooperative.  Every update has the
// stages critic tiles -> critics' Adam -> actor tiles, with a grid-wide barrier
// after the first two; a delayed update adds a barrier, the stage actor's Adam
// + both polyak steps, and a barrier.  Whether an update is delayed depends on
// the counts and k alone, so every block takes the same barriers.  On the
// other updates the actor tiles run the forward only, park nothing and need no
// barrier after them: the next update's critic tiles read nothing they write.
//
// Deterministic sums: a block writes the gradients of its own tiles to its own
// slot of `partials` and its actor-loss sums to its own column of `alp`; the
// Adam stages and the end of the launch sum them in index order, no atomics.
//
// The critics' first-layer bias is added plainly (the TPU kernel folds it
// into a weight row for the launch's duration): the moments of c_b1 stay in
// their vec rows and the padded rows of w stay zero.
//
// mm_bf16 (args.bf) rounds what the Pallas body sends through `dot`/`dg` and
// the post-ReLU activations to bfloat16, accumulation in float32; the action
// rows and bias of the critics' first layers and dq x w3 stay float32.
#pragma once

#include "learner_tiles.cuh"

namespace td3 {

using namespace tiles;

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
    float* partials;       // (grid, prows, H) per-block gradient sums
    float* wt;             // (3, H, H) transposed W2 of critic 0, critic 1, actor
    float* stash;          // (n_tiles, 2, TS, H) the actor's activations
    float* alp;            // (K, grid) per-block actor-loss sums
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

template <int H>
__host__ __device__ constexpr size_t smem_floats(int W) {
    constexpr int TS = 8 * row_groups(H);
    return (size_t)2 * TS * H + KC * H + W * TS + AH * TS + W * TS + NSMALL * TS
           + 2 * TS * (H / 32) + 32;
}

struct Smem : Bufs {
    float *xs, *nz, *sm;
    unsigned* mask;
};

template <int H>
__device__ Smem carve(float* base, int W) {
    constexpr int TS = Tile<H>::TS;
    Smem s;
    s.A = base; base += TS * H;
    s.Bm = base; base += TS * H;
    s.wch = base; base += KC * H;
    s.xs = base; base += W * TS;
    s.nz = base; base += AH * TS;
    s.xin = base; base += W * TS;
    s.sm = base; base += NSMALL * TS;
    s.mask = reinterpret_cast<unsigned*>(base);
    return s;
}

// The operands of the actor (target false) or the target actor, and of critic
// c (target false) or target critic c, in `w` and `vec`.
template <int H>
__device__ ActorRefs actor_refs(const Args& g, bool target) {
    using L = Lay<H>;
    const float* misc = g.vec + L::V_MISC * H;
    if (target)
        return {g.w + L::R_TAW1 * H, g.w + L::R_TAW2 * H, g.w + (size_t)L::R_TAWH * H,
                g.vec + V_TAB1 * H, g.vec + V_TAB2 * H, misc + M_TABH};
    return {g.w + L::R_AW1 * H, g.w + L::R_AW2 * H, g.w + (size_t)L::R_AWH * H,
            g.vec + V_AB1 * H, g.vec + V_AB2 * H, misc + M_ABH};
}

template <int H>
__device__ CriticRefs critic_refs(const Args& g, int c, bool target) {
    using L = Lay<H>;
    const float* misc = g.vec + L::V_MISC * H;
    if (target)
        return {g.w + (size_t)L::r_tw1(c) * H, g.w + (size_t)(L::r_tw1(c) + IN1) * H, nullptr,
                g.vec + (L::V_TB1 + c) * H, g.vec + (L::V_TB2 + c) * H,
                g.vec + (L::V_TW3 + c) * H, misc[L::M_TB3 + c]};
    return {g.w + (size_t)L::r_cw1(c) * H, g.w + (size_t)(L::r_cw1(c) + IN1) * H,
            g.wt + (size_t)c * H * H, g.vec + (L::V_CB1 + c) * H, g.vec + (L::V_CB2 + c) * H,
            g.vec + (L::V_CW3 + c) * H, misc[L::M_CB3 + c]};
}

// ---------------------------------------------------------------- critic --
// The slot's rows are those of learner_tiles.cuh::critic_apply: critic 0's
// n1 + 3 + H gradient rows, critic 1's, and a row with b3 and the loss sums.
template <int H>
__device__ void critic_tile(const Args& g, const Smem& S, float* part, bool first) {
    constexpr int TS = Tile<H>::TS;
    const int od = g.od, n1 = od + 2, bf = g.bf, CS = n1 + 3 + H;
    const int n0 = ceil8(od), a0 = ceil8(n0 + od), rr = a0 + 2, dd = rr + 1;
    float* qt = S.sm;                 // [2][TS]
    float* tq = S.sm + 2 * TS; float* q = S.sm + 3 * TS; float* dq = S.sm + 4 * TS;
    float* lsum = S.sm + 5 * TS;
    float* head = S.sm + 6 * TS;      // [2][TS]
    Tile<H> t;
    const int tid = threadIdx.x;

    // the target actor on next_obs, its action smoothed with clipped noise
    copy_rows<TS>(S.xs, n0, S.xin, 0, od, bf);
    actor_forward<H, AH>(t, S, actor_refs<H>(g, true), od, bf, head, nullptr);
    if (tid < TS)
        for (int e = 0; e < AH; e++) {
            float eps = fminf(fmaxf(S.nz[e * TS + tid] * g.sstd, -g.sclip), g.sclip);
            S.xin[(od + e) * TS + tid] = fminf(fmaxf(tanhf(head[e * TS + tid]) + eps, -1.0f), 1.0f);
        }
    // the target critics on (next_obs, next action)
    for (int c = 0; c < 2; c++)
        critic_forward<H>(t, S, critic_refs<H>(g, c, true), od, bf, qt + c * TS);
    __syncthreads();
    if (tid < TS)
        tq[tid] = S.xs[rr * TS + tid] + g.gamma * S.xs[dd * TS + tid] * fminf(qt[tid], qt[TS + tid]);
    // the critics on (obs, action), forward and backward
    copy_rows<TS>(S.xs, 0, S.xin, 0, od, bf);
    copy_rows<TS>(S.xs, a0, S.xin, od, 2, 0);
    for (int c = 0; c < 2; c++)
        critic_grad<H>(t, S, critic_refs<H>(g, c, false), tq, q, dq, lsum,
                       part + (size_t)c * CS * H, part + (size_t)2 * CS * H + c, od, g.B, bf,
                       first);
}

// ----------------------------------------------------------------- actor --
// The actor's loss -sum(q1) / B over one tile into *alp, and with `bwd` its
// backward through critic 0 into the block's partial slot: [0, od) W1, od b1,
// od+1 b2, [od+2, od+4) head^T, [od+4, od+4+H) W2, and a row with the head's
// bias gradients [0, 2).
template <int H>
__device__ void actor_tile(const Args& g, const Smem& S, float* part, float* stash, float* alp,
                           bool bwd, bool first) {
    using L = Lay<H>;
    constexpr int TS = Tile<H>::TS, NT = Tile<H>::NT;
    const int od = g.od, bf = g.bf;
    const float invb = (float)(1.0 / g.B);
    float* act = S.sm;               // [2][TS]
    float* head = S.sm + 2 * TS;     // [2][TS]
    float* q1 = S.sm + 4 * TS;
    float* gh = S.sm + 5 * TS;       // [2][TS]
    unsigned* m1 = S.mask;
    unsigned* m2 = S.mask + TS * (H / 32);
    Tile<H> t;
    const int tid = threadIdx.x;

    // the actor on obs; on a delayed update h1 and h2 are kept in device
    // memory (L2) while critic 0 uses the two buffers
    copy_rows<TS>(S.xs, 0, S.xin, 0, od, bf);
    actor_forward<H, AH>(t, S, actor_refs<H>(g, false), od, bf, head, bwd ? stash : nullptr);
    if (tid < TS)
        for (int e = 0; e < AH; e++) {
            float a = tanhf(head[e * TS + tid]);
            act[e * TS + tid] = a;
            S.xin[(od + e) * TS + tid] = a;
        }
    // the updated critic 0 on (obs, the actor's action)
    const CriticRefs c0 = critic_refs<H>(g, 0, false);
    critic_forward<H>(t, S, c0, od, bf, q1);
    if (bwd) {
        make_mask<H>(S.A, m1);
        make_mask<H>(S.Bm, m2);
    }
    __syncthreads();
    if (tid < 32) {
        float qs = tile_sum<TS>(q1);
        if (tid == 0) put(alp, -qs * invb, first);
    }
    if (!bwd) return;
    // dL/da through critic 0: dq = -1/B for every sample
    for (int j = tid; j < H; j += NT) {
        float dh2 = rnd(-invb * c0.w3[j], bf);
        for (int s = 0; s < TS; s++) S.Bm[s * H + j] = mask_bit(m2, s, j, H) ? dh2 : 0.f;
    }
    gemm_sk<H>(t, S.Bm, c0.w2t, bf, S.wch);
    store_masked_bits<H>(t, m1, S.A);       // dz1
    __syncthreads();
    for (int e = 0; e < AH; e++) {
        // only the action columns of the input gradient are needed
        int warp = tid / 32, lane = tid % 32;
        const float* wrow = c0.w1 + (size_t)(od + e) * H;
        for (int s = warp; s < TS; s += NT / 32) {
            float v = 0.f;
            for (int j = lane; j < H; j += 32) v += rnd(S.A[s * H + j], bf) * rnd(wrow[j], bf);
            v = warp_sum(v);
            // through tanh to the head
            if (lane == 0) gh[e * TS + s] = v * (1.0f - act[e * TS + s] * act[e * TS + s]);
        }
    }
    __syncthreads();
    actor_backward<H, AH>(t, S, gh, stash, g.w + (size_t)L::R_AWH * H, g.wt + (size_t)2 * H * H,
                          part, od, bf, first);
}

// The delayed stage: Adam on the actor from the summed partial slots, then the
// polyak step of the target actor and of the target critics from the new
// weights; the whole grid takes part.
template <int H>
__device__ void actor_apply(const Args& g, int grid, float a_lr, float c_eps) {
    using L = Lay<H>;
    const int od = g.od, AS = od + 2 + AH + H;
    const int prows = 2 * (od + 2 + 3 + H) + 1;
    const size_t slot = (size_t)prows * H;
    const float tau = g.tau, omt = 1.0f - g.tau;
    const int gtid = blockIdx.x * blockDim.x + threadIdx.x, gsz = grid * blockDim.x;
    for (int e = gtid; e < AS * H; e += gsz) {
        int lr = e / H, j = e % H;
        const float* p = g.partials + (size_t)lr * H + j;
        float gr = 0.f;
        for (int b = 0; b < grid; b++) gr += p[b * slot];
        float *wp, *mp, *vp, *tp;
        if (lr == od || lr == od + 1) {
            size_t o = (size_t)(lr == od ? V_AB1 : V_AB2) * H + j;
            wp = g.vec + o; mp = g.mvec + o; vp = g.vvec + o;
            tp = g.vec + (size_t)(lr == od ? V_TAB1 : V_TAB2) * H + j;
        } else {
            int row = lr < od ? L::R_AW1 + lr
                      : lr < od + 2 + AH ? L::R_AWH + lr - (od + 2) : L::R_AW2 + lr - (od + 2 + AH);
            int trow = lr < od ? L::R_TAW1 + lr
                       : lr < od + 2 + AH ? L::R_TAWH + lr - (od + 2)
                                          : L::R_TAW2 + lr - (od + 2 + AH);
            size_t o = (size_t)row * H + j;
            wp = g.w + o; mp = g.mw + o; vp = g.vw + o;
            tp = g.w + (size_t)trow * H + j;
        }
        float wn = adam_elem(wp, mp, vp, gr, a_lr, c_eps);
        *tp = omt * *tp + tau * wn;
        if (lr >= od + 2 + AH) g.wt[(size_t)2 * H * H + (size_t)j * H + (lr - (od + 2 + AH))] = wn;
    }
    if (blockIdx.x == 0 && threadIdx.x < AH) {
        const float* pm = g.partials + (size_t)AS * H;
        int c = threadIdx.x;
        float gr = 0.f;
        for (int b = 0; b < grid; b++) gr += pm[b * slot + c];
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
    }
}

// ---------------------------------------------------------------- kernel --
template <int H>
__global__ void __launch_bounds__(Tile<H>::NT, 1) td3_update_kernel(Args g) {
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
    Smem S = carve<H>(smem_base, g.W);
    float* part = g.partials + (size_t)blockIdx.x * prows * H;

    // the transposed copies of the three trainable W2
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < 3 * H * H; e += G * blockDim.x) {
        int m = e / (H * H), i = (e / H) % H, j = e % H;
        int row = (m < 2 ? L::r_cw1(m) + IN1 : L::R_AW2) + i;
        g.wt[(size_t)m * H * H + (size_t)j * H + i] = g.w[(size_t)row * H + j];
    }
    grid.sync();

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
            critic_tile<H>(g, S, part, t == (int)blockIdx.x);
        }
        grid.sync();
        critic_apply<H, L, false>(g, k, G, a_lr, c_eps);
        grid.sync();
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            __syncthreads();
            load_tile<TS, AH, false>(g, k, t, S.xs, S.nz);
            __syncthreads();
            actor_tile<H>(g, S, part, g.stash + (size_t)t * 2 * TS * H,
                          g.alp + (size_t)k * G + blockIdx.x, do_actor, t == (int)blockIdx.x);
        }
        if (do_actor) {
            grid.sync();
            applied++;
            adam_scalars((float)(g.count_a0 + applied), g.lr, a_lr, c_eps);
            actor_apply<H>(g, G, a_lr, c_eps);
            grid.sync();
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
// Plan errors: -1 width not built, -2 shared memory does not fit.  Other
// non-zero codes are cudaError_t.
template <int H>
int plan(int W, int n_tiles, int* out) {
    size_t smem = smem_floats<H>(W) * sizeof(float);
    int dev = 0, sms = 0, optin = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (smem > (size_t)optin) return -2;
    e = cudaFuncSetAttribute(td3_update_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, td3_update_kernel<H>, Tile<H>::NT,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    int resident = per_sm * sms;
    if (resident < 1) return -2;
    out[0] = n_tiles < resident ? n_tiles : resident;
    out[1] = (int)smem;
    return 0;
}

template <int H>
int launch(Args g, int grid, cudaStream_t stream) {
    int out[2];
    int err = plan<H>(g.W, g.B / Tile<H>::TS, out);
    if (err != 0) return err;
    if (grid != out[0]) return -4;
    void* params[] = {&g};
    cudaError_t e = cudaLaunchCooperativeKernel((void*)td3_update_kernel<H>, dim3(grid),
                                                dim3(Tile<H>::NT), params, (size_t)out[1], stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

inline int plan_any(int H, int W, int n_tiles, int* out) {
    switch (H) {
        case 128: return plan<128>(W, n_tiles, out);
        case 256: return plan<256>(W, n_tiles, out);
        case 384: return plan<384>(W, n_tiles, out);
        case 512: return plan<512>(W, n_tiles, out);
    }
    return -1;
}

inline int launch_any(int H, const Args& g, int grid, cudaStream_t stream) {
    switch (H) {
        case 128: return launch<128>(g, grid, stream);
        case 256: return launch<256>(g, grid, stream);
        case 384: return launch<384>(g, grid, stream);
        case 512: return launch<512>(g, grid, stream);
    }
    return -1;
}

}  // namespace td3

// The two C entry points: `sg_td3_update_plan(H, W, n_tiles, out)` gives the
// grid size and the shared-memory bytes, `sg_td3_update(...)` launches.
#define TD3_UPDATE_ENTRY()                                                                     \
    extern "C" int sg_td3_update_plan(int H, int W, int n_tiles, int* out) {                   \
        return td3::plan_any(H, W, n_tiles, out);                                              \
    }                                                                                          \
    extern "C" int sg_td3_update(float* w, float* vec, float* mw, float* vw, float* mvec,      \
                                 float* vvec, const float* data, const int* row_idx,           \
                                 const float* noise, float* losses, float* partials,           \
                                 float* wt, float* stash, float* alp, int H, int K, int B,     \
                                 int W, int lanes, int rpb, int od, int grid, int bf,          \
                                 int count0, int count_a0, int delay, float gamma, float tau,  \
                                 float lr, float sstd, float sclip, void* stream) {            \
        td3::Args g{w, vec, mw, vw, mvec, vvec, data, row_idx, noise, losses, partials, wt,    \
                    stash, alp, K, B, W, lanes, rpb, od, bf, count0, count_a0, delay, gamma,   \
                    tau, lr, sstd, sclip};                                                     \
        return td3::launch_any(H, g, grid, (cudaStream_t)stream);                              \
    }
