// The full-step kernel's sources of uniforms in [0, 1), one struct each with
// the same interface: built per lane from (operand pointer, B, lane, n_u,
// lane0), a public row cursor `i`, and take(), the uniform of row i++ of this
// lane.  `lane0` is the global index of the launch's lane 0 when the lanes
// are split over ranks (parallel/mesh.py): the generators draw for the global
// lane lane0 + lane, so a lane's uniforms do not depend on the split; the
// block read from memory is the rank's own and ignores it.
//
//   MemRows       the (n_u, B) float block drawn outside the kernel;
//   ThreefryRows  threefry2x32 in the kernel, the bits of
//                 jax.random.uniform(key, (B, n_u)).T: replaces the TPU
//                 kernel's _threefry_uniform_matrix
//                 (space_gym_tpu/ops/pallas_full.py:75-109, :529-536);
//   PhiloxRows    Philox4x32-10 in the kernel, an own stream with the same
//                 law: stands where the TPU kernel seeds its core's hardware
//                 generator (pallas_full.py:518-528), which this card lacks.
//
// For the two generators the operand is two 32-bit key words in device
// memory, so no step waits for the host.  Both are counter-based: the uniform
// of (lane, row) depends on the key, the lane and the row only, never on the
// launch geometry, so a lane computes just the rows it takes and jumping the
// cursor is free.  Plain versions: space_gym_torch/ops/rng_plain.py, bit for bit.
//
// Cost per uniform: threefry 20 rounds of add/rotate/xor plus 5 key
// injections, about 100 integer operations; Philox 10 rounds of two 32x32->64
// multiplies for four uniforms, about 25 per uniform.  Neither touches memory.
#pragma once

#include <cuda_runtime.h>

// jax/_src/random.py::_uniform: fill the mantissa, subtract 1.
__device__ __forceinline__ float sg_bits_to_uniform(unsigned bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ unsigned sg_rotl(unsigned x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry2x32 of counter (0, index) under key (k0, k1); returns x0 ^ x1, the
// word of jax's partitionable layout (jax/_src/prng.py).
__device__ __forceinline__ unsigned sg_threefry_bits(unsigned k0, unsigned k1, unsigned index) {
  const unsigned ks[3] = {k0, k1, 0x1BD11BDAu ^ k0 ^ k1};
  unsigned x0 = ks[0];
  unsigned x1 = index + ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
    if (g % 2 == 0) {
      x0 += x1; x1 = sg_rotl(x1, 13) ^ x0;
      x0 += x1; x1 = sg_rotl(x1, 15) ^ x0;
      x0 += x1; x1 = sg_rotl(x1, 26) ^ x0;
      x0 += x1; x1 = sg_rotl(x1, 6) ^ x0;
    } else {
      x0 += x1; x1 = sg_rotl(x1, 17) ^ x0;
      x0 += x1; x1 = sg_rotl(x1, 29) ^ x0;
      x0 += x1; x1 = sg_rotl(x1, 16) ^ x0;
      x0 += x1; x1 = sg_rotl(x1, 24) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (unsigned)(g + 1);
  }
  return x0 ^ x1;
}

// Philox4x32-10 (Salmon et al. 2011) of counter c[0..3] under key (k0, k1),
// in place.
__device__ __forceinline__ void sg_philox4x32_10(unsigned k0, unsigned k1, unsigned* c) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const unsigned hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const unsigned hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    c[0] = hi1 ^ c[1] ^ k0;
    c[1] = lo1;
    c[2] = hi0 ^ c[3] ^ k1;
    c[3] = lo0;
  }
}

struct MemRows {
  const float* __restrict__ u;
  size_t n;
  int lane;
  int i;
  __device__ __forceinline__ MemRows(const void* operand, size_t B, int lane_, int /*n_u*/,
                                     int /*lane0*/)
      : u((const float*)operand), n(B), lane(lane_), i(0) {}
  __device__ __forceinline__ float take() { return u[(size_t)(i++) * n + lane]; }
};

struct ThreefryRows {
  unsigned k0, k1, base;  // base: flat index of this lane's row 0, global lane * n_u
  int i;
  __device__ __forceinline__ ThreefryRows(const void* operand, size_t /*B*/, int lane, int n_u,
                                          int lane0)
      : k0(((const unsigned*)operand)[0]), k1(((const unsigned*)operand)[1]),
        base(((unsigned)lane + (unsigned)lane0) * (unsigned)n_u), i(0) {}
  __device__ __forceinline__ float take() {
    return sg_bits_to_uniform(sg_threefry_bits(k0, k1, base + (unsigned)(i++)));
  }
};

// Row r is word r % 4 of the block at counter (global lane, r / 4, 0, 0); the
// lane keeps its current block's four words and recomputes when r / 4 changes.
struct PhiloxRows {
  unsigned k0, k1, lane;
  int i;
  int block;
  unsigned w0, w1, w2, w3;
  __device__ __forceinline__ PhiloxRows(const void* operand, size_t /*B*/, int lane_, int /*n_u*/,
                                        int lane0)
      : k0(((const unsigned*)operand)[0]), k1(((const unsigned*)operand)[1]),
        lane((unsigned)lane_ + (unsigned)lane0), i(0), block(-1), w0(0), w1(0), w2(0), w3(0) {}
  __device__ __forceinline__ float take() {
    const int b = i >> 2, k = i & 3;
    ++i;
    if (b != block) {
      unsigned c[4] = {lane, (unsigned)b, 0u, 0u};
      sg_philox4x32_10(k0, k1, c);
      w0 = c[0]; w1 = c[1]; w2 = c[2]; w3 = c[3];
      block = b;
    }
    return sg_bits_to_uniform(k == 0 ? w0 : k == 1 ? w1 : k == 2 ? w2 : w3);
  }
};

// Writes the (n_u, B) block that a kernel of this row source would draw, row
// by row through take(): what the full-step kernel sees, made visible.
template <class ROWS>
__global__ void fill_uniforms_kernel(const void* __restrict__ operand, float* __restrict__ out,
                                     int n_u, int B, int lane0) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  ROWS U(operand, (size_t)B, lane, n_u, lane0);
  for (int r = 0; r < n_u; ++r) out[(size_t)r * B + lane] = U.take();
}

#ifdef __CUDACC__
template <class ROWS>
static int sg_fill_uniforms(const void* operand, float* out, int n_u, int B, int lane0,
                            void* stream) {
  if (B <= 0 || n_u <= 0 || lane0 < 0) return -1;
  const int threads = 128;
  fill_uniforms_kernel<ROWS><<<(B + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      operand, out, n_u, B, lane0);
  return (int)cudaGetLastError();
}
#endif
