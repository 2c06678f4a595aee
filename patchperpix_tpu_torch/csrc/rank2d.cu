// Per-pixel 2D patch rank sum over the canonical-half consensus: one block
// per run of 32 consecutive centers, the patch pixels q split over its warps.
//
// Replaces the Pallas TPU kernel patchperpix_tpu/ops/pallas_consensus_2d.py
// ::_rank2d_kernel (pallas_consensus_2d.py:531, launched by _rank2d_call at
// :664 / pallas_call :709, plus the reshape at :726).  Plain PyTorch
// version: ops/consensus.py::rank_acc_2d_plain.  The fgCnt normalisation, the
// center gate and the sentinel (rank_epilogue_2d) stay in PyTorch.
//
// Function.  Inputs: the gated stack ag (P = p*p, H, W) and the target plane
// tgt (H, W) of consensus2d.cu, and the (p, 2p-1, H, W) canonical half S,
// float32 or bf16.  For center c, with hi_q = (ag[q][c] > th) t_q,
// lo_q = (0 <= ag[q][c] < bg) t_q and t_q = tgt[c + q - rad] (0 outside):
//
//   acc[c] = sum over patch pixels q and canonical d (dy > 0, or dy == 0 and
//            dx > 0) with r = q + d inside the patch of
//            (hi_q hi_r - hi_q lo_r - lo_q hi_r) * S[d][c + q - rad]
//
// or, with int_counter, w_hh (S != 0 ? sign S : -1) - w_hl (S != 0 ? sign S
// : 1) (pallas_consensus_2d.py:602-608).  Canonical d is r > q in the
// patch's linear order, so the sum runs over ordered pairs q < r: the full
// ordered sum with no factor.  A pixel pair counts only if q's target lies
// in the image, so S is never read outside it.
//
// Bound.  The function reads what the data needs: the target plane, the
// stack's mid plane and its columns at eligible centers, and the half's live
// entries (both ends target-eligible; every other entry is zero and is never
// read), and writes one plane; chip_smoke.py counts them for each run.  On
// the 16-worm 520x696 image at 25x25 (8,215 eligible centers, 1.19 M live
// entries of 4.4e8) that is 29.6 MB, 0.009 ms at 3.35 TB/s; its arithmetic,
// 7 operations per eligible pair term (81 M terms), is 0.008 ms at 67
// TFLOP/s.  The bound is memory bytes, just.  Measured on an NVIDIA H100
// 80GB HBM3 at a 700 W limit (chip_smoke.py): 3.1 ms (f32 half), 2.9 ms
// (bf16 half).
//
// Design (simple first).  One thread per center cannot do here what it does
// in 3D: a 25x25 patch has up to 195,000 ordered pairs per center.  A block
// takes 32 consecutive centers of one image row (its lanes) and leaves at
// once when none is eligible (the worm foreground is a few percent).  It
// first stores each (q, lane)'s 2-bit code (hi, lo) in shared memory, P * 32
// bytes, so the pair loop reads codes from shared memory and touches device
// memory only for S, where neighbouring lanes read neighbouring addresses.
// Warp w walks q = w, w + NW, ... (interleaved, so long and short partner
// lists mix), every thread sums its terms in a fixed order, and warp 0 adds
// the NW partial sums in order: the result does not depend on the run.
// The TPU kernel's pre-skewed right stack and its q2x grid axis answer VMEM
// limits and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename ST, bool kIntCounter>
__global__ void rank2d_kernel(const float* __restrict__ ag,
                              const float* __restrict__ tgt,
                              const ST* __restrict__ S,
                              float* __restrict__ acc, int H, int W, int p,
                              float th, float bg) {
  extern __shared__ unsigned char code[];  // (P, kLanes): bit 0 hi, bit 1 lo
  __shared__ float part[kWarps][kLanes];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int x = blockIdx.x * kLanes + lane, y = blockIdx.y;
  const int P = p * p, rad = p / 2, nd = 2 * p - 1;
  const long long HW = (long long)H * W;
  const long long c = (long long)y * W + x;
  const bool active = x < W && ag[(long long)(rad * p + rad) * HW + c] >= 0.f;
  if (!__syncthreads_or(active ? 1 : 0)) {
    if (w == 0 && x < W) acc[c] = 0.f;
    return;
  }
  for (int q = w; q < P; q += kWarps) {
    unsigned char cd = 0;
    if (active) {
      const int ty = y + q / p - rad, tx = x + q % p - rad;
      if (ty >= 0 && ty < H && tx >= 0 && tx < W &&
          tgt[(long long)ty * W + tx] != 0.f) {
        const float v = ag[(long long)q * HW + c];
        cd = (v > th ? 1 : 0) | ((v >= 0.f && v < bg) ? 2 : 0);
      }
    }
    code[q * kLanes + lane] = cd;
  }
  __syncthreads();
  float sum = 0.f;
  if (active) {
    for (int q = w; q < P; q += kWarps) {
      const int cq = code[q * kLanes + lane];
      if (cq == 0) continue;
      const int qy = q / p, qx = q % p;
      const float hq = (float)(cq & 1), lq = (float)(cq >> 1);
      // S[d][c + q - rad]: inside the image, or cq would be 0
      const ST* s_at = S + ((long long)(y + qy - rad) * W + (x + qx - rad));
      for (int ry = qy; ry < p; ++ry) {
        for (int rx = (ry == qy ? qx + 1 : 0); rx < p; ++rx) {
          const int cr = code[(ry * p + rx) * kLanes + lane];
          if (cr == 0) continue;
          const float hr = (float)(cr & 1), lr = (float)(cr >> 1);
          const float w_hh = hq * hr, w_hl = hq * lr + lq * hr;
          if (w_hh == 0.f && w_hl == 0.f) continue;
          const long long di = (long long)(ry - qy) * nd + (rx - qx + p - 1);
          const float s = load(s_at + di * HW);
          if (kIntCounter) {
            const float sgn = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
            sum += w_hh * (s != 0.f ? sgn : -1.f) -
                   w_hl * (s != 0.f ? sgn : 1.f);
          } else {
            sum += (w_hh - w_hl) * s;
          }
        }
      }
    }
  }
  part[w][lane] = sum;
  __syncthreads();
  if (w == 0 && x < W) {
    float total = 0.f;
    for (int k = 0; k < kWarps; ++k) total += part[k][lane];
    acc[c] = total;
  }
}

template <typename ST, bool kIntCounter>
int launch(const float* ag, const float* tgt, const void* S, float* acc,
           int H, int W, int p, float th, float bg, cudaStream_t s) {
  const size_t smem = (size_t)p * p * kLanes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank2d_kernel<ST, kIntCounter>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((W + kLanes - 1) / kLanes), (unsigned)H);
  const dim3 block(kLanes, kWarps);
  rank2d_kernel<ST, kIntCounter><<<grid, block, smem, s>>>(
      ag, tgt, static_cast<const ST*>(S), acc, H, W, p, th, bg);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns the CUDA error code (0 on success).
extern "C" int ppp_rank2d_half(const float* ag, const float* tgt,
                               const void* S, int s_bf16, float* acc, int H,
                               int W, int p, float th, float bg,
                               int int_counter, void* stream) {
  if (H == 0 || W == 0) return 0;
  if (H > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_bf16) {
    return int_counter
               ? launch<__nv_bfloat16, true>(ag, tgt, S, acc, H, W, p, th, bg, s)
               : launch<__nv_bfloat16, false>(ag, tgt, S, acc, H, W, p, th, bg,
                                              s);
  }
  return int_counter ? launch<float, true>(ag, tgt, S, acc, H, W, p, th, bg, s)
                     : launch<float, false>(ag, tgt, S, acc, H, W, p, th, bg, s);
}

extern "C" const char* ppp_rank2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
