// Probe of the row-window primitive: an 8-row window read at a run-time
// start out of n_slab stacked 8-row slabs, staged in shared memory or read
// straight from global memory.
//
// Replaces the Mosaic probe scripts/probe_dynslice.py::probe
// (probe_dynslice.py:30, pallas_call :69), which checked the same read for
// the TPU's 2D fold kernels in two staging modes (roll, scratch).  Plain
// PyTorch version: ops/probe.py::probe_window_plain.
//
// Function.  x is (ZS, 8, W) float32, read as ZS * 8 rows.  For each output
// slab z in [0, ZS - n_slab + 1):
//
//   out[z][v][col] = sum over s in [0, (n_slab - 1) * 8) of
//                    x_rows[z * 8 + s + v][col] * (s + 1)
//
// Modes: 0 (smem) copies the block's n_slab * 8 rows into dynamic shared
// memory, then reads the window at row offset s from there; 1 (gmem) reads
// the same rows from global memory.  At W = 768, n_slab = 3 the staged rows
// take 72 KB, above the 48 KB a block gets without
// cudaFuncAttributeMaxDynamicSharedMemorySize, so the probe also checks
// that opt-in.
//
// Bound: bytes (each x row read once, each output written once; a few
// hundred KB), far below a launch's own latency: the probe checks a
// primitive, its time says nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kV = 8;

template <bool kStage>
__global__ void probe_window_kernel(const float* __restrict__ x,
                                    float* __restrict__ out, int W,
                                    int n_slab) {
  extern __shared__ float rows[];  // (n_slab * kV, W) when staged
  const int z = blockIdx.x;
  const int n_rows = n_slab * kV;
  const float* src = x + (long long)z * kV * W;
  if (kStage) {
    for (int i = threadIdx.x; i < n_rows * W; i += blockDim.x) rows[i] = src[i];
    __syncthreads();
  }
  const float* win = kStage ? rows : src;
  const int n_start = (n_slab - 1) * kV;
  for (int i = threadIdx.x; i < kV * W; i += blockDim.x) {
    const int v = i / W, col = i % W;
    float acc = 0.f;
    for (int s = 0; s < n_start; ++s)
      acc += win[(long long)(s + v) * W + col] * (float)(s + 1);
    out[(long long)z * kV * W + i] = acc;
  }
}

}  // namespace

// x (ZS, 8, W) -> out (ZS - n_slab + 1, 8, W).  Launches on `stream`;
// returns the CUDA error code (0 on success).
extern "C" int ppp_probe_window(const float* x, float* out, int ZS, int W,
                                int n_slab, int mode, void* stream) {
  const int n_out = ZS - n_slab + 1;
  if (n_out <= 0 || W <= 0 || n_slab < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (mode == 0) {
    const size_t smem = (size_t)n_slab * kV * W * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          probe_window_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    probe_window_kernel<true><<<n_out, threads, smem, s>>>(x, out, W, n_slab);
  } else {
    probe_window_kernel<false><<<n_out, threads, 0, s>>>(x, out, W, n_slab);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_probe_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
