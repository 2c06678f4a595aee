// Per-pixel 2D patch rank sum over the canonical-half consensus: one block
// per run of 8 consecutive centers of a row, their masks packed to bit words
// in shared memory, one thread per live (center, patch pixel) item.
//
// Replaces the Pallas TPU kernel patchperpix_tpu/ops/pallas_consensus_2d.py
// ::_rank2d_kernel (pallas_consensus_2d.py:531, launched by _rank2d_call at
// :664 / pallas_call :709, plus the reshape at :726).  Plain PyTorch
// version: ops/consensus.py::rank_acc_2d_plain.  The fgCnt normalisation, the
// center gate and the sentinel (rank_epilogue_2d) stay in PyTorch.
//
// Function.  Inputs: the gated stack ag (P = p*p, H, W) and the target plane
// tgt (H, W) of consensus2d.cu, and the (p, 2p-1, H, W) canonical half S,
// float32 or bf16.  For a center c with ag[mid][c] >= 0 (an eligible
// center; acc is 0 at every other), with hi_q = (ag[q][c] > th) t_q,
// lo_q = (0 <= ag[q][c] < bg) t_q and t_q = tgt[c + q - rad] (0 outside):
//
//   acc[c] = sum over patch pixels q and canonical d (dy > 0, or dy == 0 and
//            dx > 0) with r = q + d inside the patch of
//            (hi_q hi_r - hi_q lo_r - lo_q hi_r) * S[d][c + q - rad]
//
// or, with int_counter, w_hh (S != 0 ? sign S : -1) - w_hl (S != 0 ? sign S
// : 1) (pallas_consensus_2d.py:602-608).  Canonical d is r > q in the
// patch's linear order, so the sum runs over ordered pairs q < r.  A pixel
// pair counts only if q's target lies in the image, so S is never read
// outside it.
//
// Bound.  The function reads what the data needs: the target plane, the
// stack's mid plane and its columns at eligible centers, and the half's live
// entries (both ends target-eligible; every other entry is zero and is never
// read), and writes one plane; chip_smoke.py counts them for each run.  On
// the 16-worm 520x696 image at 25x25 (8,215 eligible centers, 1.19 M live
// entries of 4.4e8) that is 29.6 MB, 0.009 ms at 3.35 TB/s; its arithmetic,
// 7 operations per eligible pair term (81 M terms), is 0.008 ms at 67
// TFLOP/s.  The bound is memory bytes, just.
//
// Design (K2's, rank.cu, with the pack pass inside the block).  A block of
// 256 threads takes 8 consecutive centers of one image row (its lanes) and
// leaves at once when none is eligible (the worm foreground is a few
// percent), after writing their zeros.  Each lane's column of 32 threads
// packs its hi / lo to two bits per patch pixel in shared memory (P / 32
// uint2 words a lane: no scratch in device memory, no host sync).  Then it
// lists the run's items: one (lane, q) for every set bit, lane by lane and
// q ascending, so a center's items are contiguous (counts by popcount,
// offsets in order).  One thread per item walks that item's live partners,
// the set bits r > q of the center's words (hi | lo for q in hi, hi for q
// in lo: lo-lo pairs weigh zero), and reads S[r - q][c + q - rad] for each:
// only live terms, no float mask, no dead S entry.  Every thread holds a
// live item whatever the run's fill; a thread takes the loads of up to 8
// partners before it adds them (kBatch).  The displacement index is
// dlin[r] - dlin[q] + p - 1 from a P-entry table in shared memory, S's
// offset of q a second table.  An item's sum goes to shared memory and one
// thread per center adds its items in order: no atomics, equal bits on
// every launch.  Where a run holds more items than the list (4,096, or P if
// larger) it takes its lanes in groups.  The work of a block is serial in
// its threads, so the blocks with the most pair terms set the time: 8
// lanes rather than 32 cut the longest chains fourfold.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit
// (scripts/time_kernels_2d.py, 16-worm image): about 0.6 ms (f32 or bf16
// half; see PERF.md), against 3.0 ms for the kernel it replaces, which
// walked every r > q of a live q.  kLanes and kBatch were chosen by
// timing; the trials are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// A block is kLanes consecutive centers (threadIdx.x) by kRows rows of
// threads; each center's words are packed by its column of threads.
constexpr int kLanes = 8;
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kLanes;
// S entries whose loads a thread starts before it adds them: loads in
// flight hide the latency of the scattered reads; the terms are added in
// order.
constexpr int kBatch = 8;
// Items of one round, at least (a host rehearsal may set it low to force
// several rounds at a tiny shape).
#ifndef PPP_RANK_ITEMS_MIN
#define PPP_RANK_ITEMS_MIN 4096
#endif
constexpr int kItemsMin = PPP_RANK_ITEMS_MIN;
constexpr int kQBits = 11;  // an item is (lane << kQBits) | q

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// kIntCounter is a template argument, so the plain variant's inner loop
// carries no branch of the other.
template <typename ST, bool kIntCounter>
__global__ void rank2d_kernel(const float* __restrict__ ag,
                              const float* __restrict__ tgt,
                              const ST* __restrict__ S,
                              float* __restrict__ acc, int H, int W, int p,
                              int nw, float th, float bg, int cap) {
  // (nw, kLanes) code words, dlin (P), S's offset of q from the center (P),
  // the partial sums (cap), the items (cap)
  extern __shared__ uint2 smem[];
  __shared__ int s_cnt[kLanes], s_off[kLanes];
  const int P = p * p, rad = p / 2, ndx = 2 * p - 1;
  uint2* s_code = smem;
  int* s_dlin = reinterpret_cast<int*>(s_code + nw * kLanes);
  int* s_toff = s_dlin + P;
  float* s_part = reinterpret_cast<float*>(s_toff + P);
  unsigned short* s_item = reinterpret_cast<unsigned short*>(s_part + cap);

  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kLanes + lane;
  const int x0 = blockIdx.x * kLanes, x = x0 + lane, y = blockIdx.y;
  const long long HW = (long long)H * W;
  const long long c0 = (long long)y * W + x0, c = c0 + lane;
  const bool live = x < W && ag[(long long)(P / 2) * HW + c] >= 0.f;
  if (!__syncthreads_or(live ? 1 : 0)) {
    if (w == 0 && x < W) acc[c] = 0.f;
    return;
  }
  // word k of a lane: bit q - 32 k is hi (.x) / lo (.y) of (q, c)
  for (int k = w; k < nw; k += kRows) {
    unsigned h = 0, l = 0;
    if (live) {
      const int q0 = 32 * k, q1 = min(P, q0 + 32);
      int qy = q0 / p, qx = q0 - qy * p;
#pragma unroll 4
      for (int q = q0; q < q1; ++q) {
        const int ty = y + qy - rad, tx = x + qx - rad;
        const bool t_in = ty >= 0 && ty < H && tx >= 0 && tx < W;
        const float t = t_in ? tgt[(long long)ty * W + tx] : 0.f;
        const float v = ag[(long long)q * HW + c];
        if (t != 0.f) {
          h |= (v > th ? 1u : 0u) << (q - q0);
          l |= (v >= 0.f && v < bg ? 1u : 0u) << (q - q0);
        }
        if (++qx == p) {
          qx = 0;
          ++qy;
        }
      }
    }
    s_code[k * kLanes + lane] = make_uint2(h, l);
  }
  for (int r = tid; r < P; r += kThreads) {
    const int ry = r / p, rx = r - ry * p;
    s_dlin[r] = ry * ndx + rx;
    s_toff[r] = (ry - rad) * W + (rx - rad);
  }
  __syncthreads();
  if (w == 0) {
    int n = 0;
    for (int k = 0; k < nw; ++k) {
      const uint2 cd = s_code[k * kLanes + lane];
      n += __popc(cd.x | cd.y);
    }
    s_cnt[lane] = n;
  }
  __syncthreads();

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
      for (int k = 0; k < nw; ++k) {
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
      // S[d][c + q - rad]: inside the image, or q would have no bit
      const ST* s_at = S + (c0 + l + s_toff[q]);
      const int d_base = (p - 1) - s_dlin[q];
      float sum = 0.f;
      for (int rw = qw; rw < nw; ++rw) {
        const uint2 cr = s_code[rw * kLanes + l];
        // live partners: hi | lo for q in hi, hi for q in lo
        unsigned rbits = (hq ? (cr.x | cr.y) : 0u) | (lq ? cr.x : 0u);
        if (rw == qw) rbits &= ~((2u << qb) - 1u);  // r > q only
        while (rbits) {
          // up to kBatch partners: their loads first, then the terms in
          // order of r
          int rbs[kBatch];
          float sv[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            rbs[u] = rbits ? __ffs(rbits) - 1 : -1;
            rbits &= rbits - 1;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const long long di = d_base + s_dlin[rw * 32 + max(rbs[u], 0)];
            sv[u] = rbs[u] >= 0 ? load(s_at + di * HW) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (rbs[u] < 0) break;
            const unsigned hr = (cr.x >> rbs[u]) & 1u;
            const unsigned lr = (cr.y >> rbs[u]) & 1u;
            const float w_hh = (float)(hq & hr);
            const float w_hl = (float)((hq & lr) + (lq & hr));
            const float s = sv[u];
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
    if (w == 0 && lane >= l0 && lane < l1 && x < W) {
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
int launch(const float* ag, const float* tgt, const void* S, float* acc,
           int H, int W, int p, float th, float bg, cudaStream_t s) {
  const int P = p * p, nw = (P + 31) / 32;
  if (P > (1 << kQBits)) return (int)cudaErrorInvalidConfiguration;
  const int cap = max(P, kItemsMin);
  const size_t smem = (size_t)nw * kLanes * sizeof(uint2) +
                      (size_t)2 * P * sizeof(int) +
                      (size_t)cap * (sizeof(float) + sizeof(unsigned short));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rank2d_kernel<ST, kIntCounter>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((W + kLanes - 1) / kLanes), (unsigned)H);
  const dim3 block(kLanes, kRows);
  rank2d_kernel<ST, kIntCounter><<<grid, block, smem, s>>>(
      ag, tgt, static_cast<const ST*>(S), acc, H, W, p, nw, th, bg, cap);
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
