// K1 (../fused_step.cuh) and K2 (../env_step.cuh) compiled for the CPU
// against the stand-in headers of this directory: the C entry points as on
// the card, the grid's threads as fibers.  Build:
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread -I <this directory> -o libenv_step_host.so env_step_host.cpp
#include "../env_step.cuh"
#include "../fused_step.cuh"

SG_DEFINE_FUSED_STEP()
SG_DEFINE_ENV_STEP()

// How many blocks the stand-in device holds at once (one per "SM").
extern "C" void host_set_sms(int n) { EMUL_SMS = n; }
