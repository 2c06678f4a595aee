// Weight and bias gradient of a convolution that is a matrix product: the
// backward pass of the pointwise (1x1x1) convolutions and of the transposed
// convolutions whose kernel equals their stride, in exact float32 training.
//
// Replaces no TPU kernel: the JAX package leaves every convolution and its
// gradient to XLA.  It is here because cuDNN's exact-f32 choice for these
// shapes (wgrad2d_grouped_direct_kernel) ran under 1 % of the card's bound
// for them.  Plain PyTorch version:
// ops/conv_kernels.py::conv_wgrad_gemm_plain.
//
// Function.  A is (N, M, S), B is (N, K, S), both float32 and contiguous:
//
//   dW[m][k] = sum over n, s of A[n][m][s] * B[n][k][s]
//   dB[m]    = sum over n, s of A[n][m][s]
//
// A pointwise convolution's weight gradient is this with A = dy (N, Co, S)
// and B = x (N, Ci, S) over its S positions.  A transposed convolution with
// kernel = stride f takes it after the wrapper regroups dy (N, Co, f D,
// f H, f W) into (N, f^3 Co, D H W): each tap's outputs are then one row of
// A, read against the input's positions.
//
// Bound.  2 M K N S operations in FMA on the float32 pipes (67 TFLOP/s on
// an H100 SXM; no TF32, no 3xTF32 split: exact float32 arithmetic) against
// 4 (M + K) N S bytes read (3.35 TB/s).  Where M or K is a few channels
// (the heads, 24 -> 176 and 24 -> 1; the decoder's 64 -> 1), the bytes of
// A or B bound it; where both are tens to hundreds of channels (the U-Net's
// transposed convolutions, the decoder's 128 -> 64), the operations do.
//
// Design.  The depth N S is large and the output small (176 x 24 weights
// against 281,216 positions at the heads), so the depth is split (split-K):
// a CTA owns a tile of BM rows of A x BN rows of B and walks one share of
// the depth in chunks of KC = 32 positions.  Both operands are contiguous
// along the depth, so a chunk is staged row by row with 16-byte
// asynchronous copies (cp.async; 4-byte copies where S is not a multiple
// of 4 or an operand is not 16-byte aligned) into a double-buffered ring
// in shared memory, the next chunk landing while this one is read.  Rows
// are KC + 4 floats apart, so that eight consecutive rows start in eight
// different groups of four banks: each quarter-warp's 16-byte reads are
// free of conflicts.  A thread holds a register tile of TM rows of A x TN
// rows of B (rows strided by the thread grid): per four positions it reads
// TM + TN float4 and issues 4 TM TN FMAs.  Instances of (TM, TN, thread
// grid) cover a large tile for the operation-bound shapes and thin ones
// where a side has few rows, which the bytes bound; the wrapper's plan
// chooses the instance and the number of shares from the shape.  The bias
// gradient is summed in the same pass by the CTAs of the first column of
// tiles, each thread over a fixed slice of every chunk's A rows, then
// added across the slices in a fixed order.
//
// Reduction.  With more than one share, each CTA writes its partial tile
// into a workspace (splits, M K + M) and a second kernel sums the shares
// in a fixed order: no atomics, so two runs give the same bits.  With one
// share the CTAs write the result directly.

#include <cuda_runtime.h>

namespace {

constexpr int KC = 32;          // positions of a chunk
constexpr int LD = KC + 4;      // floats between rows in shared memory
constexpr int kMaxDevices = 64;
constexpr int kConfigs = 5;

struct Gemm {
  int M, K;
  long long S;        // positions of one batch element
  long long R;        // N * S: the depth
  long long chunks;   // chunks of KC positions in the depth
  int splits;         // shares of the chunks
  int vec;            // stage by 16-byte copies
  long long stride;   // floats of one share in the workspace: M K + M
};

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
#ifdef PPP_HOST_MOCK
  for (int e = 0; e < 4; ++e) dst[e] = 4 * e < bytes ? src[e] : 0.f;
#else
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
#endif
}

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

// Stage rows [row0, row0 + BR) of `src` (N, rows, S) at depth [r0, r0 + KC)
// into dst (BR, LD); rows past `rows` and depth past R read as zero.
// Thread t copies the four positions at column 4 (t % 8) of rows t / 8,
// t / 8 + NT / 8, ...
template <int BR, int NT>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int rows, int row0, long long r0,
                                      const Gemm& g) {
  constexpr int G = KC / 4;
  const int tid = threadIdx.x;
  const int col = 4 * (tid % G);
  const long long r = r0 + col;
  const long long left = g.R - r;
  if (g.vec) {
    // S % 4 == 0 and r % 4 == 0: the four positions lie in one element
    const long long n = r / g.S, s = r - n * g.S;
    const int bytes = left >= 4 ? 16 : left > 0 ? 4 * (int)left : 0;
    for (int row = tid / G; row < BR; row += NT / G) {
      const bool ok = row0 + row < rows && bytes > 0;
      copy16(dst + row * LD + col,
             ok ? src + (n * rows + row0 + row) * g.S + s : src,
             ok ? bytes : 0);
    }
  } else {
    long long n[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      n[e] = (r + e) / g.S;
      s[e] = r + e - n[e] * g.S;
    }
    for (int row = tid / G; row < BR; row += NT / G) {
      const bool in = row0 + row < rows;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = in && e < left;
        copy4(dst + row * LD + col + e,
              ok ? src + (n[e] * rows + row0 + row) * g.S + s[e] : src, ok);
      }
    }
  }
}

template <int TM, int TN, int WY, int WX, int MINB>
__global__ void __launch_bounds__(WY * WX, MINB)
    gemm_wgrad(const float* __restrict__ A, const float* __restrict__ B,
               float* __restrict__ out, Gemm g) {
  constexpr int NT = WY * WX, BM = TM * WY, BN = TN * WX;
  // the bias: thread t < BM * PARTS sums row t % BM over a slice of KC /
  // PARTS positions of each chunk
  constexpr int PARTS = NT / BM < KC / 4 ? NT / BM : KC / 4;
  constexpr int SLICE = KC / PARTS;
  extern __shared__ float4 smem4[];
  float* as = reinterpret_cast<float*>(smem4);  // (2, BM, LD)
  float* bs = as + 2 * BM * LD;                 // (2, BN, LD)

  const int tid = threadIdx.x, ty = tid / WX, tx = tid % WX;
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const bool bias_cta = blockIdx.y == 0;
  const bool bias_thread = bias_cta && tid < BM * PARTS;
  const int brow = tid % BM, bcol = (tid / BM) * SLICE;
  const long long c0 = g.chunks * blockIdx.z / g.splits;
  const long long c1 = g.chunks * (blockIdx.z + 1) / g.splits;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;

  if (c0 < c1) {
    stage<BM, NT>(as, A, g.M, m0, c0 * KC, g);
    stage<BN, NT>(bs, B, g.K, k0, c0 * KC, g);
  }
  copy_commit();
  for (long long c = c0; c < c1; ++c) {
    const int buf = static_cast<int>((c - c0) & 1);
    copy_wait_all();
    __syncthreads();
    // every thread is done with the other slot: stage the next chunk there
    if (c + 1 < c1) {
      stage<BM, NT>(as + (buf ^ 1) * BM * LD, A, g.M, m0, (c + 1) * KC, g);
      stage<BN, NT>(bs + (buf ^ 1) * BN * LD, B, g.K, k0, (c + 1) * KC, g);
    }
    copy_commit();

    const float* ab = as + (buf * BM + ty) * LD;
    const float* bb = bs + (buf * BN + tx) * LD;
#pragma unroll 2
    for (int q = 0; q < KC; q += 4) {
      float4 b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = *reinterpret_cast<const float4*>(bb + j * WX * LD + q);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(ab + i * WY * LD + q);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float v = acc[i][j];
          v = fmaf(a.x, b[j].x, v);
          v = fmaf(a.y, b[j].y, v);
          v = fmaf(a.z, b[j].z, v);
          v = fmaf(a.w, b[j].w, v);
          acc[i][j] = v;
        }
      }
    }
    if (bias_thread) {
      const float* p = as + (buf * BM + brow) * LD + bcol;
#pragma unroll
      for (int q = 0; q < SLICE; q += 4) {
        const float4 a = *reinterpret_cast<const float4*>(p + q);
        bsum += (a.x + a.y) + (a.z + a.w);
      }
    }
  }

  float* o = out + blockIdx.z * g.stride;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * WY;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx + j * WX;
      if (k < g.K) o[(long long)m * g.K + k] = acc[i][j];
    }
  }
  if (bias_cta) {
    __syncthreads();  // every thread is done reading the ring
    float* parts = as;
    if (bias_thread) parts[(tid / BM) * BM + brow] = bsum;
    __syncthreads();
    if (tid < BM && m0 + tid < g.M) {
      float v = parts[tid];
      for (int p = 1; p < PARTS; ++p) v += parts[p * BM + tid];
      o[(long long)g.M * g.K + m0 + tid] = v;
    }
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

// Lets an instance take the device's opt-in shared memory, once per
// device; *limit is that opt-in size.
template <int TM, int TN, int WY, int WX, int MINB>
cudaError_t opt_in(int* limit) {
  static int opted[kMaxDevices];
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  if (d >= kMaxDevices) return cudaErrorInvalidDevice;
  e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             d);
  if (e != cudaSuccess || opted[d]) return e;
  e = cudaFuncSetAttribute(gemm_wgrad<TM, TN, WY, WX, MINB>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *limit);
  if (e == cudaSuccess) opted[d] = 1;
  return e;
}

template <int TM, int TN, int WY, int WX, int MINB>
cudaError_t launch(const float* A, const float* B, float* ws, float* out,
                   const Gemm& g, cudaStream_t stream) {
  constexpr int BM = TM * WY, BN = TN * WX;
  const int smem = 2 * (BM + BN) * LD * 4;
  int limit = 0;
  cudaError_t e = opt_in<TM, TN, WY, WX, MINB>(&limit);
  if (e != cudaSuccess) return e;
  if (smem > limit) return cudaErrorInvalidValue;
  const dim3 grid((g.M + BM - 1) / BM, (g.K + BN - 1) / BN, g.splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  gemm_wgrad<TM, TN, WY, WX, MINB><<<grid, WY * WX, smem, stream>>>(
      A, B, g.splits > 1 ? ws : out, g);
  e = cudaGetLastError();
  if (e != cudaSuccess || g.splits == 1) return e;
  const long long need = (g.stride + 255) / 256;
  const unsigned blocks = static_cast<unsigned>(need < 4096 ? need : 4096);
  sum_shares<<<blocks, 256, 0, stream>>>(ws, out, g.stride, g.splits);
  return cudaGetLastError();
}

}  // namespace

// The instances, by index: (TM, TN, WY, WX, blocks an SM should hold).  A
// CTA's tile is BM = TM WY rows of A x BN = TN WX rows of B, with WY WX
// threads; ops/conv_kernels.py::GEMM_CONFIGS lists the same, and chooses.
#define PPP_GEMM_CONFIGS(X) \
  X(0, 8, 8, 16, 16, 2)     \
  X(1, 4, 4, 16, 16, 3)     \
  X(2, 8, 4, 16, 8, 3)      \
  X(3, 4, 4, 16, 8, 4)      \
  X(4, 1, 2, 8, 16, 8)

// A (N, M, S), B (N, K, S) -> out (M K + M): dW in (M, K) order, then dB.
// ws holds splits * (M K + M) floats when splits > 1 (unused otherwise).
// vec: S % 4 == 0 and A, B 16-byte aligned, to stage by 16-byte copies.
// config and splits come from the wrapper's plan.  Launches on `stream`;
// returns the CUDA error code (0 on success).
extern "C" int ppp_conv_wgrad_gemm(const float* A, const float* B, float* ws,
                                   float* out, int N, int M, int K,
                                   long long S, int config, int splits,
                                   int vec, void* stream) {
  if (N < 1 || M < 1 || K < 1 || S < 1 || splits < 1 || config < 0 ||
      config >= kConfigs || (vec && S % 4 != 0))
    return (int)cudaErrorInvalidValue;
  Gemm g;
  g.M = M, g.K = K, g.S = S, g.R = (long long)N * S;
  g.chunks = (g.R + KC - 1) / KC;
  g.splits = splits, g.vec = vec;
  g.stride = (long long)M * K + M;
  if (splits > g.chunks) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (config) {
#define PPP_CASE(id, TM, TN, WY, WX, MINB) \
  case id:                                 \
    return (int)launch<TM, TN, WY, WX, MINB>(A, B, ws, out, g, st);
    PPP_GEMM_CONFIGS(PPP_CASE)
#undef PPP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ppp_conv_wgrad_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
