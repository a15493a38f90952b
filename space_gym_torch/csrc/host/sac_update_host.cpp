// K4 and K5 (../sac_update.cuh) compiled for the CPU against the stand-in
// headers of this directory: both C entry points in one library, the
// cooperative launch as OS threads.  Build:
//   g++ -std=c++20 -O2 -shared -fPIC -pthread -I <this directory> -o libsac_update_host.so sac_update_host.cpp
#include "../sac_update.cuh"

SAC_UPDATE_ENTRY(sg_sac_update, false)
SAC_UPDATE_ENTRY(sg_sac_update_fold, true)

cudaError_t cudaLaunchCooperativeKernel(void* fn, dim3 grid, dim3 block, void** params, size_t smem,
                                        cudaStream_t) {
    return launch_emul(reinterpret_cast<void (*)(sac::Args)>(fn), grid, block, params, smem);
}

// How many blocks the stand-in device holds at once (one per "SM").
extern "C" void host_set_sms(int n) { EMUL_SMS = n; }
