// Weight and bias gradient of a valid 3x3x3 float32 convolution (stride 1,
// no padding, one group), the backward pass of the U-Net's ConvPass
// convolutions in exact float32 training.
//
// Replaces no TPU kernel: the JAX package leaves every convolution and its
// gradient to XLA.  It is here because cuDNN's exact-f32 choice for these
// shapes (wgrad2d_grouped_direct_kernel) ran at about 2 % of the card's
// float32 peak and took most of the training step.  Plain PyTorch version:
// ops/conv_kernels.py::conv3d_wgrad_plain.
//
// Function.  x is (N, Ci, D, H, W), dy is (N, Co, D - 2, H - 2, W - 2), both
// float32 and contiguous:
//
//   dW[co][ci][kz][ky][kx] = sum over n, z, y, x of
//                            dy[n][co][z][y][x] * x[n][ci][z+kz][y+ky][x+kx]
//   dB[co] = sum over n, z, y, x of dy[n][co][z][y][x]
//
// Bound: operations.  dW is an implicit matrix product of M = Co rows,
// N = Ci * 27 columns and a depth of K = N * Do * Ho * Wo output positions,
// 2 * M * N * K operations in FMA on the float32 pipes (67 TFLOP/s on an
// H100 SXM; no TF32, no 3xTF32, no Winograd or FFT: the result is exact
// float32 arithmetic).  The U-Net's 14 shapes at batch 2 of 140^3 are 564
// GFLOP, 8.4 ms at that rate; each input byte is read once from memory for
// thousands of operations, so bytes do not bound it.
//
// Design.  K is large and the output small (10,800 weights against K = 5.0
// M positions at 20 -> 20 channels), so the depth is split: a CTA owns a
// tile of BM output channels x BC input channels x all 27 taps and walks
// one share of the positions (split-K over bricks).  Positions are taken
// plane by plane of the output (one z) in chunks of P flattened positions
// q = y * W + x over the *input's* row width W: the columns x in [Wo, W)
// carry dy = 0, so that the tap (ky, kx) of position q reads x at q + ky *
// W + kx, one contiguous run for every tap.  A CTA stages, per plane, its
// dy chunk (BM x P) and the input chunk with its halo (BC x (P + 2W + 2))
// in shared memory by cp.async, double-buffered; walking down z it keeps a
// ring of four input planes, so each plane is loaded once per chunk, not
// three times.  Nine warps, one per (kz, ky); a warp reads its plane z +
// kz at row offset ky * W, and each thread keeps a register tile of TM
// output channels x TC input channels x the 3 kx taps: for four positions
// it loads TM float4 of dy and 6 input values per channel, and the three
// kx taps are the window sliding over those 6 values (12 * TM * TC FMAs
// for TM + 6 * TC shared-memory loads).  Tile sizes are template instances
// chosen from the shape by the wrapper.  The bias gradient is summed in
// the same pass by the lanes of warp 0 that hold input channel 0.
//
// Reduction.  With S > 1 shares, each CTA writes its partial tile into a
// workspace (S, Co * Ci * 27 + Co) and a second kernel sums the S partials
// in a fixed order: no atomics, so two runs give the same bits.  With S = 1
// the CTAs write the result directly.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 9;  // one per (kz, ky)
constexpr int kThreads = kWarps * 32;
constexpr int kMaxDevices = 64;
constexpr int kConfigs = 4;

struct Shape {
  int Ci, Co, D, H, W;     // the input's extents; the output is 2 smaller
  int P;                   // positions of a chunk, a multiple of 4
  int nchunk;              // chunks of a plane
  int xstr;                // input row stride in shared memory (odd)
  int dstr;                // dy row stride in shared memory (4 mod 8)
  int splits;              // shares of the positions
  long long units;         // N * nchunk * (D - 2): chunk-planes to walk
  long long stride;        // floats of one share in the workspace
};

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool ok) {
#ifdef PPP_HOST_MOCK
  *dst = ok ? *src : 0.f;
#else
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
#endif
}

__device__ __forceinline__ void copy_commit() {
#ifndef PPP_HOST_MOCK
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void copy_wait_all() {
#ifndef PPP_HOST_MOCK
  asm volatile("cp.async.wait_group 0;\n" ::);
#endif
}

// Shared memory: the input ring (4, BC, xstr), then dy (2, BM, dstr).
template <int BM, int BC>
__host__ __device__ inline long long smem_floats(int xstr, int dstr) {
  return 4LL * BC * xstr + 2LL * BM * dstr;
}

template <int TM, int TC, int GM, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    wgrad_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                 float* __restrict__ out, Shape s) {
  constexpr int GC = 32 / GM;
  constexpr int BM = TM * GM, BC = TC * GC;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ds = xs + 4 * BC * s.xstr;

  const int Do = s.D - 2, Ho = s.H - 2, Wo = s.W - 2;
  const long long HW = (long long)s.H * s.W, HWo = (long long)Ho * Wo;
  const int W = s.W, P = s.P, xlen = P + 2 * W + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kz = warp / 3, ky = warp % 3;
  const int gm = lane % GM, gc = lane / GM;
  const int co0 = blockIdx.x * BM, ci0 = blockIdx.y * BC;
  const int split = blockIdx.z;
  const bool bias_lane = blockIdx.y == 0 && warp == 0 && gc == 0;
  const long long u_end = s.units * (split + 1) / s.splits;

  float acc[TM][TC][3];
  float bsum[TM];
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    bsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TC; ++i)
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[j][i][k] = 0.f;
  }

  for (long long u = s.units * split / s.splits; u < u_end;) {
    const long long nc = u / Do;  // (n, chunk)
    const int z0 = static_cast<int>(u - nc * Do);
    const int n = static_cast<int>(nc / s.nchunk);
    const int c = static_cast<int>(nc - (long long)n * s.nchunk);
    const int len = static_cast<int>(
        u_end - u < (long long)(Do - z0) ? u_end - u : (long long)(Do - z0));
    const long long q0 = (long long)c * P;
    const float* xsrc = x + ((long long)n * s.Ci + ci0) * s.D * HW + q0;
    const float* dsrc = dy + ((long long)n * s.Co + co0) * Do * HWo;

    // the input plane zx of this chunk into ring slot zx % 4
    auto load_x = [&](int zx) {
      float* dst = xs + (zx & 3) * BC * s.xstr;
      const float* src = xsrc + zx * HW;
      for (int t = tid; t < xlen; t += kThreads) {
        const bool in = q0 + t < HW;
#pragma unroll 4
        for (int ci = 0; ci < BC; ++ci) {
          const bool ok = in && ci0 + ci < s.Ci;
          copy4(dst + ci * s.xstr + t,
                ok ? src + ci * s.D * HW + t : x, ok);
        }
      }
    };
    // dy plane z of this chunk into slot b; zero where x >= Wo or y >= Ho
    auto load_dy = [&](int z, int b) {
      float* dst = ds + b * BM * s.dstr;
      for (int t = tid; t < P; t += kThreads) {
        const long long q = q0 + t;
        const int y = static_cast<int>(q / W), xx = static_cast<int>(q - (long long)y * W);
        const bool in = y < Ho && xx < Wo;
        const float* src = dsrc + z * HWo + (long long)y * Wo + xx;
#pragma unroll 4
        for (int co = 0; co < BM; ++co) {
          const bool ok = in && co0 + co < s.Co;
          copy4(dst + co * s.dstr + t, ok ? src + co * Do * HWo : dy, ok);
        }
      }
    };

    __syncthreads();  // the previous run's last planes are read
    load_x(z0);
    load_x(z0 + 1);
    load_x(z0 + 2);
    load_dy(z0, 0);
    copy_commit();
    for (int t = 0; t < len; ++t) {
      copy_wait_all();
      __syncthreads();
      // the slots of plane t - 1 are free: stage plane t + 1 behind this one
      if (t + 1 < len) {
        load_x(z0 + t + 3);
        load_dy(z0 + t + 1, (t + 1) & 1);
      }
      copy_commit();

      const float* xb = xs + (((z0 + t + kz) & 3) * BC + gc) * s.xstr + ky * W;
      const float* db = ds + ((t & 1) * BM + gm) * s.dstr;
      for (int q = 0; q < P; q += 4) {
        float4 d[TM];
#pragma unroll
        for (int j = 0; j < TM; ++j)
          d[j] = *reinterpret_cast<const float4*>(db + j * GM * s.dstr + q);
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          const float* xp = xb + i * GC * s.xstr + q;
          float v[6];
#pragma unroll
          for (int m = 0; m < 6; ++m) v[m] = xp[m];
#pragma unroll
          for (int j = 0; j < TM; ++j)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              float a = acc[j][i][k];
              a = fmaf(d[j].x, v[k], a);
              a = fmaf(d[j].y, v[k + 1], a);
              a = fmaf(d[j].z, v[k + 2], a);
              a = fmaf(d[j].w, v[k + 3], a);
              acc[j][i][k] = a;
            }
        }
        if (bias_lane) {
#pragma unroll
          for (int j = 0; j < TM; ++j)
            bsum[j] += (d[j].x + d[j].y) + (d[j].z + d[j].w);
        }
      }
    }
    u += len;
  }

  float* ow = out + (long long)split * s.stride;
  const long long nw = (long long)s.Co * s.Ci * 27;
#pragma unroll
  for (int j = 0; j < TM; ++j) {
    const int co = co0 + gm + GM * j;
    if (co >= s.Co) continue;
#pragma unroll
    for (int i = 0; i < TC; ++i) {
      const int ci = ci0 + gc + GC * i;
      if (ci >= s.Ci) continue;
      float* w = ow + ((long long)co * s.Ci + ci) * 27 + kz * 9 + ky * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = acc[j][i][k];
    }
    if (bias_lane) ow[nw + co] = bsum[j];
  }
}

// out[i] = sum over k in [0, splits) of ws[k * n + i], k ascending.
__global__ void sum_shares(const float* __restrict__ ws,
                           float* __restrict__ out, long long n, int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < splits; ++k) acc += ws[k * n + i];
    out[i] = acc;
  }
}

// Lets instance (TM, TC, GM, MINB) take the device's opt-in shared memory,
// once per device; *limit is that opt-in size.
template <int TM, int TC, int GM, int MINB>
cudaError_t opt_in(int* limit) {
  static int opted[kMaxDevices];
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d >= kMaxDevices) return cudaErrorInvalidDevice;
  e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             d);
  if (e != cudaSuccess || opted[d]) return e;
  e = cudaFuncSetAttribute(wgrad_kernel<TM, TC, GM, MINB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *limit);
  if (e == cudaSuccess) opted[d] = 1;
  return e;
}

template <int TM, int TC, int GM, int MINB>
cudaError_t launch(const float* x, const float* dy, float* ws, float* out,
                   const Shape& s, cudaStream_t stream) {
  constexpr int GC = 32 / GM;
  constexpr int BM = TM * GM, BC = TC * GC;
  const long long smem = 4 * smem_floats<BM, BC>(s.xstr, s.dstr);
  int limit = 0;
  cudaError_t e = opt_in<TM, TC, GM, MINB>(&limit);
  if (e != cudaSuccess) return e;
  if (smem > limit) return cudaErrorInvalidValue;
  const dim3 grid((s.Co + BM - 1) / BM, (s.Ci + BC - 1) / BC, s.splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  wgrad_kernel<TM, TC, GM, MINB><<<grid, kThreads, smem, stream>>>(
      x, dy, s.splits > 1 ? ws : out, s);
  e = cudaGetLastError();
  if (e != cudaSuccess || s.splits == 1) return e;
  const long long need = (s.stride + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(need < 4096 ? need : 4096);
  sum_shares<<<blocks, 256, 0, stream>>>(ws, out, s.stride, s.splits);
  return cudaGetLastError();
}

}  // namespace

// The tile instances, by index: (TM, TC, GM, blocks an SM should hold).
// A CTA's tile is BM = TM * GM output channels x BC = TC * (32 / GM) input
// channels; ops/conv_kernels.py::CONFIGS lists the same, and chooses.
#define PPP_WGRAD_CONFIGS(X) \
  X(0, 5, 1, 4, 2)           \
  X(1, 5, 3, 4, 1)           \
  X(2, 6, 3, 4, 1)           \
  X(3, 4, 3, 8, 2)

// x (N, Ci, D, H, W), dy (N, Co, D-2, H-2, W-2) -> out (Co * Ci * 27 + Co):
// dW in (Co, Ci, 3, 3, 3) order, then dB.  ws holds splits * (Co * Ci * 27
// + Co) floats when splits > 1 (unused otherwise).  P, xstr, dstr and
// splits come from the wrapper's plan.  Launches on `stream`; returns the
// CUDA error code (0 on success).
extern "C" int ppp_conv3d_wgrad(const float* x, const float* dy, float* ws,
                                float* out, int N, int Ci, int Co, int D,
                                int H, int W, int config, int P, int xstr,
                                int dstr, int splits, void* stream) {
  if (N < 1 || Ci < 1 || Co < 1 || D < 3 || H < 3 || W < 3 || P < 4 ||
      P % 4 != 0 || dstr < P || dstr % 8 != 4 || xstr < P + 2 * W + 2 ||
      xstr % 2 != 1 || splits < 1 || config < 0 || config >= kConfigs)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.Ci = Ci, s.Co = Co, s.D = D, s.H = H, s.W = W;
  s.P = P, s.xstr = xstr, s.dstr = dstr, s.splits = splits;
  const long long Q = (long long)(H - 2) * W;
  s.nchunk = static_cast<int>((Q + P - 1) / P);
  s.units = (long long)N * s.nchunk * (D - 2);
  s.stride = (long long)Co * Ci * 27 + Co;
  if (splits > s.units) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (config) {
#define PPP_CASE(id, TM, TC, GM, MINB) \
  case id:                             \
    return (int)launch<TM, TC, GM, MINB>(x, dy, ws, out, s, st);
    PPP_WGRAD_CONFIGS(PPP_CASE)
#undef PPP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ppp_conv3d_wgrad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
