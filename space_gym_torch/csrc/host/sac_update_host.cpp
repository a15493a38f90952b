// K4 and K5 (../sac_update.cuh) compiled for the CPU against the stand-in
// headers of this directory: both C entry points in one library, the
// cooperative launch as fibers, the tensor-core instructions of the bf16
// mode emulated lane by lane (mma_emul.h).  Build:
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -I <this directory> -o libsac_update_host.so sac_update_host.cpp
#include "../sac_update.cuh"

SAC_UPDATE_ENTRY(sg_sac_update, false)
SAC_UPDATE_ENTRY(sg_sac_update_fold, true)

cudaError_t cudaLaunchCooperativeKernel(void* fn, dim3 grid, dim3 block, void** params, size_t smem,
                                        cudaStream_t) {
    return launch_emul(reinterpret_cast<void (*)(sac::Args)>(fn), grid, block, params, smem);
}

// How many blocks the stand-in device holds at once (one per "SM").
extern "C" void host_set_sms(int n) { EMUL_SMS = n; }

// Whether the last block of every thread block cluster lags behind the
// others (cuda_runtime.h, EMUL_LAG).
extern "C" void host_set_lag(int on) { EMUL_LAG = on != 0; }

// One warp computes D (16 x 16) = A (16 x 16) . B (16 x 16) as two
// m16n8k16 products, its fragments taken as the kernels take them:
// amode 0 ldmatrix from bf16 rows of A, 1 packed from float32 rows of A
// (frag_a_rows), 2 packed from float32 rows of A^T (frag_a_cols); bmode 0
// ldmatrix.trans from bf16 rows of B, 1 ldmatrix from bf16 rows of B^T, 2
// packed from float32 rows of B (frag_b_rows).  The float32 sources lie in
// the XOR-swizzled layout of the kernels' activation buffers (MTile<128>).
namespace {
struct MmaArgs {
    const float *A, *B;
    float* D;
    int amode, bmode;
};

void mma_tile_kernel(MmaArgs a) {
    using namespace tiles;
    using T = MTile<128>;
    constexpr int LDB = 24;   // a bf16 row of 16, padded by 16 bytes
    float* fa = host_shared_memory();
    float* fb = fa + 16 * 128;
    bf16* ba = reinterpret_cast<bf16*>(fb + 16 * 128);
    bf16* bb = ba + 16 * LDB;
    const int l = threadIdx.x, g = l / 4, q = l % 4;
    if (l == 0)
        for (int r = 0; r < 16; r++)
            for (int c = 0; c < 16; c++) {
                float x = a.A[r * 16 + c], y = a.B[r * 16 + c];
                fa[a.amode == 2 ? T::ix(c, r) : T::ix(r, c)] = x;
                fb[T::ix(r, c)] = y;
                ba[r * LDB + c] = __float2bfloat16_rn(x);
                bb[(a.bmode == 1 ? c : r) * LDB + (a.bmode == 1 ? r : c)] = __float2bfloat16_rn(y);
            }
    __syncthreads();
    unsigned af[4], b[4];
    if (a.amode == 0) ldsm_x4(af, ba + ((l & 7) + ((l >> 3) & 1) * 8) * LDB + (l >> 4) * 8);
    else if (a.amode == 1) frag_a_rows(fa, T::At{}, 0, 0, g, q, af);
    else frag_a_cols(fa, T::At{}, 0, 0, g, q, af);
    if (a.bmode == 0) ldsm_x4_trans(b, bb + ((l & 7) + ((l >> 3) & 1) * 8) * LDB + (l >> 4) * 8);
    else if (a.bmode == 1) ldsm_x4(b, bb + ((l & 7) + (l >> 4) * 8) * LDB + ((l >> 3) & 1) * 8);
    else {
        frag_b_rows(fb, T::At{}, 0, 0, g, q, b[0], b[1]);
        frag_b_rows(fb, T::At{}, 0, 8, g, q, b[2], b[3]);
    }
    float d[2][4] = {};
    mma_bf16(d[0], af, b[0], b[1]);
    mma_bf16(d[1], af, b[2], b[3]);
    for (int nt = 0; nt < 2; nt++)
        for (int e = 0; e < 4; e++) a.D[(g + 8 * (e / 2)) * 16 + nt * 8 + 2 * q + e % 2] = d[nt][e];
}
}  // namespace

extern "C" int host_mma_tile(const float* A, const float* B, float* D, int amode, int bmode) {
    MmaArgs a{A, B, D, amode, bmode};
    void* params[] = {&a};
    return launch_emul(mma_tile_kernel, dim3(1), dim3(32), params,
                       (2 * 16 * 128) * sizeof(float) + 2 * 16 * 24 * 2);
}
