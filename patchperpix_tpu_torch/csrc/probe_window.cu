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
// Design.  One thread per (output slab, column): a block is 128 columns of
// one output slab, the grid (ZS - n_slab + 1, ceil(W / 128)).  For n_slab
// <= 3 the thread keeps the (n_slab - 1) * 8 + 7 rows its column needs (at
// most 23) in registers and produces its 8 outputs as sliding weighted
// sums; a larger n_slab reads the rows where they lie, row by row.  Modes:
// 0 (smem) stages the block's n_slab * 8 rows x 128 columns in dynamic
// shared memory (12 KB at n_slab = 3; above 48 KB from n_slab = 13, which
// needs cudaFuncAttributeMaxDynamicSharedMemorySize, set once per process,
// device and size); 1 (gmem) reads the same rows from global memory.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn, no
// contraction to an FMA) in the plain version's order, s ascending, so the
// result equals the plain version's bit for bit.
//
// Bound: bytes (each x row read once, each output written once: 344 KB at
// W = 768, n_slab = 3), far below a launch's own latency.

#include <cuda_runtime.h>

namespace {

constexpr int kV = 8;
constexpr int kCols = 128;
constexpr int kMaxDevices = 64;

// kNSlab > 0: that many slabs, rows in registers; 0: n_slab at run time.
template <int kNSlab, bool kStage>
__global__ void __launch_bounds__(kCols)
    probe_window_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int W, int n_slab) {
  extern __shared__ float tile[];  // (n_slab * kV, kCols) when staged
  if (kNSlab > 0) n_slab = kNSlab;
  const int z = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  const bool live = col < W;
  const float* src = x + (long long)z * kV * W;
  if (kStage) {
    for (int r = 0; r < n_slab * kV; ++r)
      tile[r * kCols + threadIdx.x] = live ? src[(long long)r * W + col] : 0.f;
    __syncthreads();
  }
  if (!live) return;
  // row r of this column, staged or in global memory
  const float* rows = kStage ? tile + threadIdx.x : src + col;
  const long long pitch = kStage ? kCols : W;
  float* dst = out + (long long)z * kV * W + col;
  if constexpr (kNSlab > 0) {
    constexpr int kStart = (kNSlab - 1) * kV;   // window starts per output
    constexpr int kRows = kStart + kV - 1;      // rows the column needs
    float r[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) r[i] = rows[i * pitch];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < kStart; ++s)
        acc = __fadd_rn(acc, __fmul_rn(r[s + v], (float)(s + 1)));
      dst[(long long)v * W] = acc;
    }
  } else {
    const int n_start = (n_slab - 1) * kV;
    for (int v = 0; v < kV; ++v) {
      float acc = 0.f;
      for (int s = 0; s < n_start; ++s)
        acc = __fadd_rn(acc, __fmul_rn(rows[(s + v) * pitch], (float)(s + 1)));
      dst[(long long)v * W] = acc;
    }
  }
}

template <int kNSlab>
cudaError_t launch(const float* x, float* out, int n_out, int W, int n_slab,
                   int mode, cudaStream_t s) {
  const dim3 grid(n_out, (W + kCols - 1) / kCols);
  if (mode == 1) {
    probe_window_kernel<kNSlab, false><<<grid, kCols, 0, s>>>(x, out, W,
                                                              n_slab);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)n_slab * kV * kCols * sizeof(float);
  if (smem > 48 * 1024) {
    // the opt-in above 48 KB, once per device and size
    static size_t opted[kMaxDevices] = {};
    int d = 0;
    cudaError_t e = cudaGetDevice(&d);
    if (e != cudaSuccess) return e;
    if (d >= kMaxDevices) return cudaErrorInvalidDevice;
    if (opted[d] < smem) {
      e = cudaFuncSetAttribute(probe_window_kernel<kNSlab, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
      opted[d] = smem;
    }
  }
  probe_window_kernel<kNSlab, true><<<grid, kCols, smem, s>>>(x, out, W,
                                                              n_slab);
  return cudaGetLastError();
}

}  // namespace

// x (ZS, 8, W) -> out (ZS - n_slab + 1, 8, W).  mode 0 stages in shared
// memory, 1 reads global memory.  Launches on `stream`; returns the CUDA
// error code (0 on success).
extern "C" int ppp_probe_window(const float* x, float* out, int ZS, int W,
                                int n_slab, int mode, void* stream) {
  const int n_out = ZS - n_slab + 1;
  if (n_out <= 0 || W <= 0 || n_slab < 1 || (mode != 0 && mode != 1) ||
      (W + kCols - 1) / kCols > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_slab) {
    case 1: return (int)launch<1>(x, out, n_out, W, n_slab, mode, s);
    case 2: return (int)launch<2>(x, out, n_out, W, n_slab, mode, s);
    case 3: return (int)launch<3>(x, out, n_out, W, n_slab, mode, s);
    default: return (int)launch<0>(x, out, n_out, W, n_slab, mode, s);
  }
}

extern "C" const char* ppp_probe_window_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
