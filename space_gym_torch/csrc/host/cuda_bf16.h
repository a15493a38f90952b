// Stand-in for <cuda_bf16.h>: round to nearest even on the upper 16 bits.
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { uint16_t v; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    u += 0x7FFFu + ((u >> 16) & 1u);
    return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
    uint32_t u = (uint32_t)b.v << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
