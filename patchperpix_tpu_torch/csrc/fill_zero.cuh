// The zero fill of a consensus half, shared by consensus.cu and
// consensus2d.cu: most of the half is zero, and whole-line stores in address
// order, 16 bytes a thread and turn, reach the memory's rate (3.2 TB/s on an
// H100), which the kernels' scattered stores of their live outputs would not.

#pragma once

#include <cuda_runtime.h>

namespace ppp {

__global__ void fill_zero_kernel(unsigned char* __restrict__ p,
                                 long long n_bytes) {
  const long long n16 = n_bytes / 16;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint4* p16 = reinterpret_cast<uint4*>(p);
  for (long long i = t; i < n16; i += step)
    p16[i] = make_uint4(0u, 0u, 0u, 0u);
  if (t < n_bytes - n16 * 16) p[n16 * 16 + t] = 0;
}

// Writes n_bytes zeros at p (16-byte aligned) on `s`; up to 16 blocks of 256
// threads per SM of an H100 (132 SMs), each thread looping over the rest.
inline void fill_zero(void* p, long long n_bytes, cudaStream_t s) {
  const long long blocks = min(n_bytes / (16 * 256) + 1, 132LL * 16);
  fill_zero_kernel<<<(unsigned)blocks, 256, 0, s>>>(
      static_cast<unsigned char*>(p), n_bytes);
}

}  // namespace ppp
