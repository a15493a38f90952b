// K6 (../td3_update.cuh) compiled for the CPU against the stand-in headers of
// this directory: the C entry points as on the card, the cooperative launch as
// fibers.  Build:
//   g++ -std=c++20 -O1 -shared -fPIC -pthread -I <this directory> -o libtd3_update_host.so td3_update_host.cpp
#include "../td3_update.cuh"

TD3_UPDATE_ENTRY()

cudaError_t cudaLaunchCooperativeKernel(void* fn, dim3 grid, dim3 block, void** params, size_t smem,
                                        cudaStream_t) {
    return launch_emul(reinterpret_cast<void (*)(td3::Args)>(fn), grid, block, params, smem);
}

// How many blocks the stand-in device holds at once (one per "SM").
extern "C" void host_set_sms(int n) { EMUL_SMS = n; }

// Whether the last block of every thread block cluster lags behind the
// others (cuda_runtime.h, EMUL_LAG).
extern "C" void host_set_lag(int on) { EMUL_LAG = on != 0; }
