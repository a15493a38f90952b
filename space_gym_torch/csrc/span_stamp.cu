// The device clock of the port's spans (utils/profiling.py): one thread
// writes %globaltimer, the device's nanosecond timer, into a slot, in stream
// order.  A kernel and not a CUDA timing event: under CUPTI a timing event on
// the stream holds a large graph's first launch back by milliseconds.
#include <cuda_runtime.h>

__global__ void span_stamp(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

extern "C" int sg_span_stamp(unsigned long long* slot, cudaStream_t stream) {
  span_stamp<<<1, 1, 0, stream>>>(slot);
  return (int)cudaGetLastError();
}
