// K3, K3-tf and K3-hw (../full_step.cuh) compiled for the CPU against the
// stand-in headers of this directory: the three C entry points as on the
// card, the persistent grid's threads as fibers.  Build:
//   g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC -pthread -I <this directory> -o libfull_step_host.so full_step_host.cpp
#include "../full_step.cuh"

SG_DEFINE_FULL_STEP(sg_full_step, MemRows)
SG_DEFINE_FULL_STEP(sg_full_step_threefry, ThreefryRows)
SG_DEFINE_FULL_STEP(sg_full_step_philox, PhiloxRows)

// How many blocks the stand-in device holds at once (one per "SM").
extern "C" void host_set_sms(int n) { EMUL_SMS = n; }
