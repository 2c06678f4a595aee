// Per-voxel patch rank sum over the canonical-half consensus: the masks
// packed to bits, one block per run of 32 consecutive centers, one thread
// per live (center, patch pixel) item.
//
// Replaces the Pallas TPU kernel patchperpix_tpu/ops/pallas_consensus.py
// ::_rank_kernel_v5 (pallas_consensus.py:514, launched by
// rank_scores_pallas at :598 / pallas_call :656); the v4 body
// ::_rank_kernel (:439, pallas_call :706) computes the same function.
// Plain PyTorch version: ops/consensus.py::rank_acc_plain.
//
// Function.  hi, lo are the (P, Z, Y, X) float32 0/1 mask stacks.  For
// center c:
//
//   acc[c] = sum over patch pixels q and canonical displacements d with
//            r = q + d inside the patch of
//            (hi_q hi_r - hi_q lo_r - lo_q hi_r)[c] * S[d][c + q - rad]
//
// (S zero outside the volume), or, with int_counter, the sign variant
// w_hh * (S != 0 ? sign S : -1) - w_hl * (S != 0 ? sign S : 1) of
// pallas_consensus.py:560-566.  The fgCnt normalisation, the center gate
// and the -1 sentinel (rank_epilogue) stay in PyTorch.  S is the
// (psz, 2psy-1, 2psx-1, Z, Y, X) canonical half, float32 or bf16.  The
// canonical d of a pixel q are exactly the pixels r > q in the patch's
// linear order, so the sum runs over ordered pairs q < r.
//
// Bound.  At the FlyLight crop (50^3, 7^3) the function reads hi and lo
// once (2 * 343 * 125000 * 4 B = 343 MB) and the half once (592 MB), and
// writes 0.5 MB: 0.94 GB, 0.28 ms at 3.35 TB/s.  Its arithmetic is 7 float
// operations per live (q, r) term at an eligible center (data-dependent,
// counted by chip_smoke.py: 117.3 M terms on the crop, 0.012 ms at 67
// TFLOP/s), far below that: the bound is memory bytes.
//
// Design.  Two kernels on one stream; their time together is the kernel's.
// (1) pack_codes.cuh, centre-aligned: hi / lo as two bits per (q, c)
//     (11 MB instead of 343 MB at the crop) and the byte plane E of
//     eligible centers.
// (2) A block takes 32 consecutive centers in memory order and leaves at
//     once when E is zero for all of them (a block without an eligible
//     center does no work).  It copies the run's code words into shared
//     memory (asynchronous 8-byte copies) and lists the run's items: one
//     (lane, q) for every set bit, lane by lane and q ascending, so a
//     center's items are contiguous (a fixed order: counts by popcount,
//     offsets by a scan over the 32 lanes).  Then one thread per item walks
//     that item's live partners, the set bits r > q of the center's words
//     (hi | lo for q in hi, hi for q in lo: lo-lo pairs weigh zero), and
//     reads S[r - q][c + q - rad] for each: only live terms, no float
//     mask, no dead S entry.  A warp's 32 items are live whatever the
//     run's fill; on the crop an eligible center holds about 100 items.
//     The displacement index is dlin[r] - dlin[q] + const from a P-entry
//     table in shared memory (no division per term).  An item's sum goes to
//     shared memory and one thread per center adds its items in order: no
//     atomics, equal bits on every launch.  Where a run holds more items
//     than the list (4,096, or P if larger) it takes its lanes in groups.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit (chip_smoke.py and
// scripts/time_kernels_3d.py, FlyLight crop): 1.5-1.7 ms for the wrapper
// (pack 0.12-0.14, blocks 1.27; 1.11 with a bf16 half), against 29.8 ms
// for the one-thread-per-center kernel it replaces.  The S reads, 4 bytes
// at scattered addresses, take 1.0 of the 1.27 ms.  Designs measured and
// dropped are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pack_codes.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
// Items of one round, at least (a host rehearsal may set it low to force
// several rounds at a tiny shape).
#ifndef PPP_RANK_ITEMS_MIN
#define PPP_RANK_ITEMS_MIN 4096
#endif
constexpr int kItemsMin = PPP_RANK_ITEMS_MIN;
constexpr int kQBits = 11;       // an item is (lane << kQBits) | q

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// kIntCounter is a template argument, so the plain variant's inner loop
// carries neither the variant's branch nor the out-of-volume select.
template <typename ST, bool kIntCounter>
__global__ void rank_half_kernel(const uint2* __restrict__ codes,
                                 const unsigned char* __restrict__ E,
                                 const ST* __restrict__ S,
                                 float* __restrict__ acc, int Z, int Y, int X,
                                 int psz, int psy, int psx, int W, int cap) {
  // (W, kLanes) code words, dlin (P), the partial sums (cap), the items (cap)
  extern __shared__ uint2 smem[];
  __shared__ int s_z[kLanes], s_y[kLanes], s_x[kLanes];
  __shared__ int s_cnt[kLanes], s_off[kLanes];
  const int P = psz * psy * psx;
  uint2* s_code = smem;
  int* s_dlin = reinterpret_cast<int*>(s_code + W * kLanes);
  float* s_part = reinterpret_cast<float*>(s_dlin + P);
  unsigned short* s_item = reinterpret_cast<unsigned short*>(s_part + cap);

  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kLanes + lane;
  const int ndy = 2 * psy - 1, ndx = 2 * psx - 1;
  const long long V = (long long)Z * Y * X;
  const long long c0 = (long long)blockIdx.x * kLanes;
  const long long c = c0 + lane;
  const bool live = c < V && E[c] != 0;
  if (!__syncthreads_or(live ? 1 : 0)) {
    if (w == 0 && c < V) acc[c] = 0.f;
    return;
  }
  for (int k = w; k < W; k += kWarps) {
    if (live) {
      PPP_CP_ASYNC_8(&s_code[k * kLanes + lane], &codes[(long long)k * V + c]);
    } else {
      s_code[k * kLanes + lane] = make_uint2(0u, 0u);
    }
  }
  for (int r = tid; r < P; r += kThreads) {
    const int rx = r % psx, ry = (r / psx) % psy, rz = r / (psx * psy);
    s_dlin[r] = (rz * ndy + ry) * ndx + rx;
  }
  if (w == 0) {
    s_x[lane] = (int)(c % X);
    s_y[lane] = (int)((c / X) % Y);
    s_z[lane] = (int)(c / ((long long)X * Y));
  }
  PPP_CP_ASYNC_WAIT_ALL();
  __syncthreads();
  if (w == 0) {
    int n = 0;
    for (int k = 0; k < W; ++k) {
      const uint2 cd = s_code[k * kLanes + lane];
      n += __popc(cd.x | cd.y);
    }
    s_cnt[lane] = n;
  }
  __syncthreads();

  const int rz0 = psz / 2, ry0 = psy / 2, rx0 = psx / 2;
  const int d_off = (psy - 1) * ndx + (psx - 1);
  // rounds over groups of lanes whose items fit the list (a lane has at
  // most P <= cap items)
  for (int l0 = 0; l0 < kLanes;) {
    int l1 = l0, total = 0;
    while (l1 < kLanes && total + s_cnt[l1] <= cap) total += s_cnt[l1++];
    // the items (lane, q) of the group, lane by lane and q ascending
    if (w == 0 && lane >= l0 && lane < l1) {
      int at = 0;
      for (int l = l0; l < lane; ++l) at += s_cnt[l];
      s_off[lane] = at;
      for (int k = 0; k < W; ++k) {
        const uint2 cd = s_code[k * kLanes + lane];
        unsigned bits = cd.x | cd.y;
        while (bits) {
          const int qb = __ffs(bits) - 1;
          bits &= bits - 1;
          s_item[at++] = (unsigned short)((lane << kQBits) | (k * 32 + qb));
        }
      }
    }
    __syncthreads();
    // one thread per item: the sum over the item's live partners r > q
    for (int i = tid; i < total; i += kThreads) {
      const int l = s_item[i] >> kQBits, q = s_item[i] & ((1 << kQBits) - 1);
      const int qw = q >> 5, qb = q & 31;
      const uint2 cq = s_code[qw * kLanes + l];
      const unsigned hq = (cq.x >> qb) & 1u, lq = (cq.y >> qb) & 1u;
      const int sz = s_z[l] + q / (psx * psy) - rz0;
      const int sy = s_y[l] + (q / psx) % psy - ry0;
      const int sx = s_x[l] + q % psx - rx0;
      // S reads 0 outside the volume; only the int_counter variant counts
      // such a term
      const bool s_in =
          sz >= 0 && sz < Z && sy >= 0 && sy < Y && sx >= 0 && sx < X;
      float sum = 0.f;
      if (kIntCounter || s_in) {
        const ST* s_at = S + (s_in ? ((long long)sz * Y + sy) * X + sx : 0);
        const int d_base = d_off - s_dlin[q];
        for (int rw = qw; rw < W; ++rw) {
          const uint2 cr = s_code[rw * kLanes + l];
          // live partners: hi | lo for q in hi, hi for q in lo
          unsigned rbits = (hq ? (cr.x | cr.y) : 0u) | (lq ? cr.x : 0u);
          if (rw == qw) rbits &= ~((2u << qb) - 1u);  // r > q only
          while (rbits) {
            const int rb = __ffs(rbits) - 1;
            rbits &= rbits - 1;
            const unsigned hr = (cr.x >> rb) & 1u, lr = (cr.y >> rb) & 1u;
            const float w_hh = (float)(hq & hr);
            const float w_hl = (float)((hq & lr) + (lq & hr));
            const long long di = d_base + s_dlin[rw * 32 + rb];
            const float s = (!kIntCounter || s_in) ? load(s_at + di * V) : 0.f;
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
      s_part[i] = sum;
    }
    __syncthreads();
    // each center's items added in order
    if (w == 0 && lane >= l0 && lane < l1 && c < V) {
      float total_c = 0.f;
      const int at = s_off[lane];
      for (int k = 0; k < s_cnt[lane]; ++k) total_c += s_part[at + k];
      acc[c] = total_c;
    }
    __syncthreads();
    l0 = l1;
  }
}

template <typename ST, bool kIntCounter>
int launch(const void* codes, const unsigned char* E, const void* S,
           float* acc, int Z, int Y, int X, int psz, int psy, int psx,
           cudaStream_t s) {
  const long long V = (long long)Z * Y * X;
  const int P = psz * psy * psx, W = (P + 31) / 32;
  if (P > (1 << kQBits)) return (int)cudaErrorInvalidConfiguration;
  const int cap = max(P, kItemsMin);
  const size_t smem = (size_t)W * kLanes * sizeof(uint2) +
                      (size_t)P * sizeof(int) +
                      (size_t)cap * (sizeof(float) + sizeof(unsigned short));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank_half_kernel<ST, kIntCounter>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (V + kLanes - 1) / kLanes;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kLanes, kWarps);
  rank_half_kernel<ST, kIntCounter><<<(unsigned)blocks, block, smem, s>>>(
      static_cast<const uint2*>(codes), E, static_cast<const ST*>(S), acc, Z,
      Y, X, psz, psy, psx, W, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// hi, lo (P, Z, Y, X) float32 0/1; S the canonical half; acc (Z, Y, X).
// Scratch from the caller: codes, ceil(P / 32) * Z*Y*X * 8 bytes, and
// elig, Z*Y*X bytes (pack_codes.cuh).  Launches on `stream`; returns the
// CUDA error code (0 on success).
extern "C" int ppp_rank_half(const float* hi, const float* lo, const void* S,
                             int s_bf16, float* acc, int Z, int Y, int X,
                             int psz, int psy, int psx, int int_counter,
                             void* codes, void* elig, void* stream) {
  if ((long long)Z * Y * X == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* E = static_cast<unsigned char*>(elig);
  const int e =
      ppp::pack_codes<false>(hi, lo, nullptr, nullptr, codes, E, nullptr, Z, Y,
                             X, psz, psy, psx, s);
  if (e != 0) return e;
  if (s_bf16) {
    return int_counter
               ? launch<__nv_bfloat16, true>(codes, E, S, acc, Z, Y, X, psz,
                                             psy, psx, s)
               : launch<__nv_bfloat16, false>(codes, E, S, acc, Z, Y, X, psz,
                                              psy, psx, s);
  }
  return int_counter
             ? launch<float, true>(codes, E, S, acc, Z, Y, X, psz, psy, psx, s)
             : launch<float, false>(codes, E, S, acc, Z, Y, X, psz, psy, psx,
                                    s);
}

extern "C" const char* ppp_rank_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
