// Per-voxel patch rank sum over the canonical-half consensus, one thread
// per center voxel.
//
// Replaces the Pallas TPU kernel patchperpix_tpu/ops/pallas_consensus.py
// ::_rank_kernel_v5 (pallas_consensus.py:514, launched by
// rank_scores_pallas at :598 / pallas_call :656); the v4 body
// ::_rank_kernel (:439, pallas_call :706) computes the same function.
// Plain PyTorch version: ops/consensus.py::rank_acc_plain.
//
// Function.  For center c:
//
//   acc[c] = sum over patch pixels q and canonical displacements d with
//            r = q + d inside the patch of
//            (hi_q hi_r - hi_q lo_r - lo_q hi_r)[c] * S[d][c + q - rad]
//
// (S zero outside the volume), or, with int_counter, the sign variant
// w_hh * (S != 0 ? sign S : -1) - w_hl * (S != 0 ? sign S : 1) of
// pallas_consensus.py:560-566.  The fgCnt normalisation, the center gate
// and the -1 sentinel (rank_epilogue) stay in PyTorch.  S is the
// (psz, 2psy-1, 2psx-1, Z, Y, X) canonical half, float32 or bf16.
//
// Bound.  At the FlyLight crop (50^3, 7^3) the function reads hi and lo
// once (2 * 343 * 125000 * 4 B = 343 MB) and the half once (592 MB), and
// writes 0.5 MB: 0.94 GB, 0.28 ms at 3.35 TB/s.  Its arithmetic is 6 float
// operations per eligible (q, d) term at an eligible center
// (data-dependent, counted by chip_smoke.py), far below that: the bound is
// memory bytes.
//
// Design (simple first).  Loads across a warp are consecutive centers and
// coalesce, for the mask stacks and for S.  A q whose hi and lo are both
// zero at c (every q of a background or border center) adds exactly zero
// and is skipped, as is a partner r with hi = lo = 0.  Only the eligible
// centers (about a sixth of the crop) do work, so the grid is thin; a
// (center, q)-parallel split with a reduction, or fusing with the
// consensus kernel, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// kIntCounter is a template argument, so the plain variant's inner loop
// carries neither the variant's branch nor the out-of-volume select.
template <typename ST, bool kIntCounter>
__global__ void rank_half_kernel(const float* __restrict__ hi,
                                 const float* __restrict__ lo,
                                 const ST* __restrict__ S,
                                 float* __restrict__ acc, int Z, int Y, int X,
                                 int psz, int psy, int psx) {
  const long long V = (long long)Z * Y * X;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= V) return;
  const int x = (int)(c % X);
  const int y = (int)((c / X) % Y);
  const int z = (int)(c / ((long long)X * Y));
  const int ndy = 2 * psy - 1, ndx = 2 * psx - 1;
  const int rz = psz / 2, ry = psy / 2, rx = psx / 2;
  float sum = 0.f;
  for (int qz = 0; qz < psz; ++qz) {
    const int sz = z + qz - rz;
    for (int qy = 0; qy < psy; ++qy) {
      const int sy = y + qy - ry;
      for (int qx = 0; qx < psx; ++qx) {
        const int sx = x + qx - rx;
        const int q = (qz * psy + qy) * psx + qx;
        const float hq = hi[(long long)q * V + c];
        const float lq = lo[(long long)q * V + c];
        if (hq == 0.f && lq == 0.f) continue;
        // S reads 0 outside the volume; only the int_counter variant
        // counts such a term
        const bool s_in =
            sz >= 0 && sz < Z && sy >= 0 && sy < Y && sx >= 0 && sx < X;
        if (!kIntCounter && !s_in) continue;
        const long long s_at = s_in ? ((long long)sz * Y + sy) * X + sx : 0;
        for (int dz = 0; dz < psz - qz; ++dz) {
          // canonical half: at dz == 0 only dy > 0, or dy == 0 and dx > 0
          const int dy_lo = dz == 0 ? 0 : -qy;
          for (int dy = dy_lo; dy < psy - qy; ++dy) {
            const int dx_lo = (dz == 0 && dy == 0) ? 1 : -qx;
            for (int dx = dx_lo; dx < psx - qx; ++dx) {
              const int r = q + (dz * psy + dy) * psx + dx;
              const float hr = hi[(long long)r * V + c];
              const float lr = lo[(long long)r * V + c];
              if (hr == 0.f && lr == 0.f) continue;
              const long long di =
                  ((long long)dz * ndy + (dy + psy - 1)) * ndx + (dx + psx - 1);
              const float s =
                  (!kIntCounter || s_in) ? load(S + di * V + s_at) : 0.f;
              const float w_hh = hq * hr;
              const float w_hl = hq * lr + lq * hr;
              if (kIntCounter) {
                const float sgn = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
                const float pos_v = s != 0.f ? sgn : -1.f;
                const float neg_v = s != 0.f ? sgn : 1.f;
                sum += w_hh * pos_v - w_hl * neg_v;
              } else {
                sum += (w_hh - w_hl) * s;
              }
            }
          }
        }
      }
    }
  }
  acc[c] = sum;
}

template <typename ST>
void launch(const float* hi, const float* lo, const void* S, float* acc,
            int Z, int Y, int X, int psz, int psy, int psx, int int_counter,
            unsigned blocks, int threads, cudaStream_t s) {
  const ST* st = static_cast<const ST*>(S);
  if (int_counter) {
    rank_half_kernel<ST, true><<<blocks, threads, 0, s>>>(
        hi, lo, st, acc, Z, Y, X, psz, psy, psx);
  } else {
    rank_half_kernel<ST, false><<<blocks, threads, 0, s>>>(
        hi, lo, st, acc, Z, Y, X, psz, psy, psx);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ppp_rank_half(const float* hi, const float* lo, const void* S,
                             int s_bf16, float* acc, int Z, int Y, int X,
                             int psz, int psy, int psx, int int_counter,
                             void* stream) {
  const long long V = (long long)Z * Y * X;
  if (V == 0) return 0;
  const int threads = 128;
  const long long blocks = (V + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (s_bf16) {
    launch<__nv_bfloat16>(hi, lo, S, acc, Z, Y, X, psz, psy, psx, int_counter,
                          (unsigned)blocks, threads, s);
  } else {
    launch<float>(hi, lo, S, acc, Z, Y, X, psz, psy, psx, int_counter,
                  (unsigned)blocks, threads, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_rank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
