// Host stand-in for <cuda_bf16.h>: the storage type and the two conversions
// the sources use (round to nearest even, as the card's intrinsics do).

#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline __nv_bfloat16 __float2bfloat16(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __nv_bfloat16{0x7fc0};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{(uint16_t)(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}
