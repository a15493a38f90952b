// K SAC updates in one cooperative kernel launch: the device code shared by
// K4 (sac_update.cu, FOLD = false) and K5 (sac_update_fold.cu, FOLD = true).
// The tiles, products and the stages that SAC has in common with TD3 are in
// learner_tiles.cuh.
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

#include "learner_tiles.cuh"

namespace sac {

using namespace tiles;

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
    // the rows and columns of `vec` that the shared critic stage names
    static constexpr int V_CB1 = sac::V_CB1, V_CB2 = sac::V_CB2, V_CW3 = sac::V_CW3;
    static constexpr int V_TB1 = sac::V_TB1, V_TB2 = sac::V_TB2, V_TW3 = sac::V_TW3;
    static constexpr int V_MISC = sac::V_MISC, M_CB3 = sac::M_CB3, M_TB3 = sac::M_TB3;
};

template <int H, bool FOLD>
__host__ __device__ constexpr size_t smem_floats(int W) {
    constexpr int TS = 8 * row_groups(H);
    return (size_t)2 * TS * H + KC * H + (FOLD ? 2 : 1) * (W * TS + 4 * TS) + W * TS
           + NSMALL * TS + 4 * TS * (H / 32) + 32;
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
template <int H>
__device__ ActorRefs actor_refs(const Args& g) {
    using L = Lay<H>;
    return {g.w + L::R_AW1 * H, g.w + L::R_AW2 * H, g.w + (size_t)L::R_AWH * H,
            g.vec + V_AB1 * H, g.vec + V_AB2 * H, g.vec + V_MISC * H + M_ABH};
}

template <int H>
__device__ CriticRefs critic_refs(const Args& g, int c) {
    using L = Lay<H>;
    return {g.w + L::r_cw1(c) * H, g.w + (L::r_cw1(c) + IN1) * H, g.wt + (size_t)c * H * H,
            g.vec + (V_CB1 + c) * H, g.vec + (V_CB2 + c) * H, g.vec + (V_CW3 + c) * H,
            g.vec[V_MISC * H + M_CB3 + c]};
}

struct Smem : Bufs {
    float *xs[2], *nz[2], *sm;
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
    Tile<H> t;
    const int tid = threadIdx.x;

    // the actor on next_obs, sampled with the critic's normals
    copy_rows<TS>(xs, n0, S.xin, 0, od, bf);
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
    for (int c = 0; c < 2; c++) {
        CriticRefs tr{g.w + L::r_tw1(c) * H, g.w + (L::r_tw1(c) + IN1) * H, nullptr,
                      g.vec + (V_TB1 + c) * H, g.vec + (V_TB2 + c) * H, g.vec + (V_TW3 + c) * H,
                      misc[M_TB3 + c]};
        critic_forward<H>(t, S, tr, od, bf, qt + c * TS);
    }
    __syncthreads();
    if (tid < TS)
        tq[tid] = xs[rr * TS + tid] + g.gamma * xs[dd * TS + tid]
                  * (fminf(qt[tid], qt[TS + tid]) - alpha * nlogp[tid]);
    // the critics on (obs, action), forward and backward
    copy_rows<TS>(xs, 0, S.xin, 0, od, bf);
    copy_rows<TS>(xs, a0, S.xin, od, 2, 0);
    for (int c = 0; c < 2; c++)
        critic_grad<H>(t, S, critic_refs<H>(g, c), tq, q, dq, lsum, part + (size_t)c * CS * H,
                       part + (size_t)2 * CS * H + c, od, g.B, bf, first);
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
    unsigned* m1[2] = {S.mask, S.mask + 2 * TS * (H / 32)};
    unsigned* m2[2] = {S.mask + TS * (H / 32), S.mask + 3 * TS * (H / 32)};
    Tile<H> t;
    const int tid = threadIdx.x;

    // the actor on obs, sampled with the actor's normals; h1, h2 are kept in
    // device memory (L2) while the critics use the two buffers
    copy_rows<TS>(xs, 0, S.xin, 0, od, bf);
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
    for (int c = 0; c < 2; c++) {
        critic_forward<H>(t, S, critic_refs<H>(g, c), od, bf, qc + c * TS);
        make_mask<H>(S.A, m1[c]);
        make_mask<H>(S.Bm, m2[c]);
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
    if (tid < 32) {
        float* pm = part + (size_t)(od + 6 + H) * H;
        float ls = tile_sum<TS>(lsum), lp = tile_sum<TS>(logp);
        if (tid == 0) {
            put(pm + 4, ls, first);
            put(pm + 5, lp, first);
        }
    }
    actor_backward<H, NHEAD>(t, S, gh, stash, g.w + (size_t)L::R_AWH * H,
                             g.wt + (size_t)2 * H * H, part, od, bf, first);
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
        float wn = adam_elem(wp, mp, vp, gr, a_lr, c_eps);
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
        load_tile<TS, 4, true>(g, 0, blockIdx.x, S.xs[0], S.nz[0]);
        cp_async_commit();
    }
    grid.sync();

    for (int k = 0; k < g.K; k++) {
        // per-update scalars (fused_sac.py:460-474); b**t as exp(t log b)
        float a_lr, c_eps;
        adam_scalars(g.count0 + (float)k + 1.0f, g.lr, a_lr, c_eps);
        const int cur = FOLD ? (k & 1) : 0;
        if (FOLD) {
            // start the next update's copy, then wait for this update's
            if (k + 1 < g.K) {
                load_tile<TS, 4, true>(g, k + 1, blockIdx.x, S.xs[cur ^ 1], S.nz[cur ^ 1]);
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
                load_tile<TS, 4, false>(g, k, t, S.xs[0], S.nz[0]);
                __syncthreads();
            }
            critic_tile<H>(g, S, S.xs[cur], S.nz[cur], part, t == (int)blockIdx.x);
        }
        grid.sync();
        critic_apply<H, L, true>(g, k, G, a_lr, c_eps);
        grid.sync();
        for (int t = blockIdx.x; t < n_tiles; t += G) {
            if (!FOLD) {
                __syncthreads();
                load_tile<TS, 4, false>(g, k, t, S.xs[0], S.nz[0]);
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
