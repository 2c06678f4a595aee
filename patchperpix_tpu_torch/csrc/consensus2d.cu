// Canonical half of the 2D consensus vote array: the target pixels listed,
// their masks packed to target-aligned bit words, the half zero-filled, and
// a block per run of 32 listed pixels that computes only the live outputs,
// whose pairs are the set bits of two words.
//
// Replaces the Pallas TPU kernel patchperpix_tpu/ops/pallas_consensus_2d.py
// ::_cons2d_kernel (pallas_consensus_2d.py:261, launched by
// consensus_fold_pallas_2d at :387 / pallas_call :445).  Plain PyTorch
// version: ops/consensus.py::consensus_half_2d_plain.
//
// Function.  Inputs: the gated stack ag (P = p*p, H, W), centre-aligned
// (ag[q][c] = affs[q][c] at an eligible center c, else the sentinel -1; the
// center gate is ag[mid][c] >= 0), and the target plane tgt (H, W), 1 where
// a pixel is target-eligible.  For a canonical displacement d = (dy, dx)
// (dy > 0, or dy == 0 and dx > 0) and output pixel x:
//
//   cons[d][x] = sum over patch pixels q with q and r = q + d inside the
//                patch and eligible center c = x - (q - rad) inside the
//                image of w(q, r) at c,
//
// where the four stacks of the 3D kernel are derived in registers
// (pallas_consensus_2d.py:242 _derive): with v = ag[q][c] and t the target
// plane at q's target pixel (x for q, x + d for r),
//
//   hi = (v > th) t,  lo = (0 <= v < bg) t,  a = v hi,  b = (1 - v) lo
//   pp  = a_q (a_r - b_r) - b_q a_r        sc = hi_q (hi_r - lo_r) - lo_q hi_r
//   cnt = hi_q (hi_r + lo_r) + lo_q hi_r
//   norm_prob_product: (pp - th^2 sc) / (1 - th^2);  prob_product: pp;
//   count: sc;  then cons / cnt where cnt != 0 when norm_aff.
//
// Output: the standard layout (p, 2p-1, H, W), float32 or bf16, index
// (dy, dx + p - 1); the dx <= 0 entries of the dy == 0 plane are 0.  The TPU
// kernel's (slab, 8-row) fold and its dual group reads serve Mosaic and are
// not carried over; device memory holds ONE (P, H, W) stack, as there.
//
// Bound.  At 520x696 with 25x25 patches the function writes the half once
// (1,225 * 361,920 * 4 B = 1.773 GB in f32) and reads what the data needs:
// the target plane, the stack's mid plane and its columns at eligible
// centers (chip_smoke.py counts them for each run).  On the 16-worm image
// (8,215 eligible centers) that is 1.797 GB, 0.54 ms at 3.35 TB/s; its 81 M
// eligible pair terms at 15 float operations are 0.02 ms at 67 TFLOP/s.  The
// bound is memory bytes, and 99.7 % of the half is zero.
//
// Design.  Six kernels on one stream; their time together is the kernel's.
// (1) count_rows / scan_rows: the target pixels per row and their running
//     offsets.  The caller reads the total n (one host sync) and sizes the
//     scratch by it: idx (H, W) int32, pix (n) int32 and the words G
//     (ceil(P / 32), n) uint2, 160 bytes per target pixel at 25x25 (1.3 MB
//     on the 16-worm image), nothing of size H * W * P.
// (2) index_rows: idx[x] = the target pixel's place in row-major order (-1
//     off the target), pix = its inverse.
// (3) pack_targets, target-aligned: bit q of word q / 32 of G[x] is hi
//     (.x) / lo (.y) of patch pixel q of center c = x - q + rad, the pixel q
//     that points at x.  ag and the mid plane are read once per (x, q).
// (4) fill_zero.cuh writes the whole half as zeros in address order.
// (5) consensus2d_tiles: a block owns 32 consecutive listed pixels and 64
//     displacements (grid (n / 32, 20) at 25x25).  An output (d, x) can be
//     nonzero only where x and x + d are both target pixels; the warps test
//     idx[x + d] and put the live (d, lane) on a list in shared memory, then
//     all 256 threads take list entries, so every lane holds a live output.
//     For an output, q and r = q + d share a center exactly when bit q of
//     G[x] and bit r = q + dq (dq = dy p + dx, the patch's linear order) of
//     G[x + d] are set and q + d fits the patch: the thread moves G[x + d]'s
//     words down by dq (funnel shifts), masks them with the fit words of dx
//     (shared memory; a row past the patch lands past G's last bit), and
//     ANDs them with G[x]'s words (staged in shared memory).  sc and cnt are
//     popcounts; only the set bits, the live pairs, load floats: ag[q][c]
//     and ag[r][c], whose neighbours in a warp (same d, next x) stand at
//     the next center of the same plane.  A thread takes the loads of up to
//     8 pairs before it adds them (kBatch): with one pair at a time it
//     waited on each load.  Each output is one thread's sum in a fixed order
//     (the list's order only decides which thread): equal bits on every
//     launch.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit
// (scripts/time_kernels_2d.py, 16-worm image, f32): 1.4-1.5 ms for the
// wrapper (fill 0.56, tiles 0.65, the rest 0.04 and a host sync; see
// PERF.md), against 5.4 ms for the one-thread-per-output kernel it
// replaces.  kDPerWarp and kBatch were chosen by timing; the trials are in
// PERF.md.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fill_zero.cuh"

namespace {

enum WeightMode { kNormProbProduct = 0, kProbProduct = 1, kCount = 2 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kDPerWarp = 8;                     // displacements per warp
constexpr int kDPerBlock = kWarps * kDPerWarp;   // per block
constexpr int kListMax = kLanes * kDPerBlock;
// pairs whose loads a thread starts before it adds them: loads in flight
// hide the latency of the scattered reads; the terms are added in order
constexpr int kBatch = 8;

// Block-wide inclusive sum of one int per thread (kThreads threads, s of
// kThreads ints); returns this thread's inclusive sum, s[kThreads - 1] holds
// the total until s is written again.
__device__ int block_inclusive_sum(int v, int* s) {
  const int tid = threadIdx.x;
  s[tid] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const int add = tid >= off ? s[tid - off] : 0;
    __syncthreads();
    s[tid] += add;
    __syncthreads();
  }
  return s[tid];
}

// (1) row_off[y] = the number of target pixels of row y.
__global__ void count_rows_kernel(const float* __restrict__ tgt,
                                  int* __restrict__ row_off, int W) {
  __shared__ int s[kThreads];
  const int y = blockIdx.x;
  int n = 0;
  for (int x = threadIdx.x; x < W; x += kThreads)
    n += tgt[(long long)y * W + x] != 0.f ? 1 : 0;
  block_inclusive_sum(n, s);
  if (threadIdx.x == 0) row_off[y] = s[kThreads - 1];
}

// (1) counts -> exclusive offsets in place, row_off[H] = the total; one
// block, each thread a run of rows.
__global__ void scan_rows_kernel(int* __restrict__ row_off, int H) {
  __shared__ int s[kThreads];
  const int chunk = (H + kThreads - 1) / kThreads;
  const int y0 = min(H, (int)threadIdx.x * chunk), y1 = min(H, y0 + chunk);
  int sum = 0;
  for (int y = y0; y < y1; ++y) sum += row_off[y];
  int run = block_inclusive_sum(sum, s) - sum;
  const int total = s[kThreads - 1];
  for (int y = y0; y < y1; ++y) {
    const int n = row_off[y];
    row_off[y] = run;
    run += n;
  }
  if (threadIdx.x == 0) row_off[H] = total;
}

// (2) idx and pix for row y, 256 pixels a turn.
__global__ void index_rows_kernel(const float* __restrict__ tgt,
                                  const int* __restrict__ row_off,
                                  int* __restrict__ idx, int* __restrict__ pix,
                                  int W) {
  __shared__ int s[kThreads];
  const int y = blockIdx.x;
  int base = row_off[y];
  for (int x0 = 0; x0 < W; x0 += kThreads) {
    const int x = x0 + (int)threadIdx.x;
    const long long at = (long long)y * W + x;
    const int f = x < W && tgt[at] != 0.f ? 1 : 0;
    const int i = base + block_inclusive_sum(f, s) - f;
    base += s[kThreads - 1];
    if (x < W) idx[at] = f ? i : -1;
    if (f) pix[i] = (int)at;
    __syncthreads();  // s is written again next turn
  }
}

// (3) One thread per (listed pixel i, word k): 32 patch pixels.
__global__ void pack_targets_kernel(const float* __restrict__ ag,
                                    const int* __restrict__ pix,
                                    uint2* __restrict__ G, int n, int H,
                                    int W, int p, int nw, float th,
                                    float bg) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * nw) return;
  const int i = (int)(t % n), k = (int)(t / n);
  const int x_lin = pix[i];
  const int y = x_lin / W, x = x_lin - y * W;
  const long long HW = (long long)H * W;
  const int P = p * p, rad = p / 2;
  const float* mid = ag + (long long)(P / 2) * HW;
  const int q0 = 32 * k, q1 = min(P, q0 + 32);
  int qy = q0 / p, qx = q0 - qy * p;
  unsigned h = 0, l = 0;
  for (int q = q0; q < q1; ++q) {
    // the center whose pixel q targets x
    const int cy = y - qy + rad, cx = x - qx + rad;
    if (cy >= 0 && cy < H && cx >= 0 && cx < W) {
      const long long c = (long long)cy * W + cx;
      const float v = ag[q * HW + c];
      if (mid[c] >= 0.f) {
        h |= (v > th ? 1u : 0u) << (q - q0);
        l |= (v >= 0.f && v < bg ? 1u : 0u) << (q - q0);
      }
    }
    if (++qx == p) {
      qx = 0;
      ++qy;
    }
  }
  G[(long long)k * n + i] = make_uint2(h, l);
}

// (5) grid (ceil(n / 32), ceil(p (2p-1) / kDPerBlock)), block (32, 8).
template <typename OutT>
__global__ void __launch_bounds__(kThreads) consensus2d_tiles_kernel(
    const float* __restrict__ ag, const int* __restrict__ idx,
    const int* __restrict__ pix, const uint2* __restrict__ G,
    OutT* __restrict__ out, int n, int H, int W, int p, int nw, int mode,
    float th, int norm_aff) {
  // the block's own words (nw, kLanes); the live outputs as (di << 5) |
  // lane and the listed index of x + d (kListMax each); per pixel q its
  // center's offset from the output pixel (P); per dx the words of the
  // pixels q whose column keeps q + d in the patch (2p-1 rows of nw)
  extern __shared__ uint2 smem[];
  __shared__ int n_list;
  __shared__ int s_pix[kLanes];
  const int P = p * p, rad = p / 2, ndx = 2 * p - 1, nd = p * ndx;
  uint2* s_code = smem;
  unsigned* list = reinterpret_cast<unsigned*>(s_code + nw * kLanes);
  int* list_j = reinterpret_cast<int*>(list + kListMax);
  int* s_coff = list_j + kListMax;
  unsigned* s_fit_x = reinterpret_cast<unsigned*>(s_coff + P);

  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kLanes + lane;
  const long long HW = (long long)H * W;
  const int i = blockIdx.x * kLanes + lane;
  const bool in = i < n;
  const int x_lin = in ? pix[i] : 0;
  const int y = x_lin / W, x = x_lin - y * W;
  if (w == 0) s_pix[lane] = x_lin;
  for (int k = w; k < nw; k += kWarps)
    s_code[k * kLanes + lane] =
        in ? G[(long long)k * n + i] : make_uint2(0u, 0u);
  for (int q = tid; q < P; q += kThreads)
    s_coff[q] = (rad - q / p) * W + (rad - q % p);
  for (int e = tid; e < ndx * nw; e += kThreads) {
    const int dx = e / nw - (p - 1), k = e % nw;
    int qx = (32 * k) % p;
    unsigned m = 0;
    for (int b = 0; b < 32 && 32 * k + b < P; ++b) {
      if (qx + dx >= 0 && qx + dx < p) m |= 1u << b;
      if (++qx == p) qx = 0;
    }
    s_fit_x[e] = m;
  }
  if (tid == 0) n_list = 0;
  __syncthreads();

  // the live outputs of this block's displacements go on the list
  const int d0 = blockIdx.y * kDPerBlock + w * kDPerWarp;
  for (int kk = 0; kk < kDPerWarp && in; ++kk) {
    const int di = d0 + kk;
    if (di >= nd) break;
    const int dy = di / ndx, dx = di - dy * ndx - (p - 1);
    const int uy = y + dy, ux = x + dx;
    if ((dy == 0 && dx <= 0) || uy >= H || ux < 0 || ux >= W) continue;
    const int j = idx[(long long)uy * W + ux];
    if (j < 0) continue;
    const int at = atomicAdd(&n_list, 1);
    list[at] = ((unsigned)di << 5) | (unsigned)lane;
    list_j[at] = j;
  }
  __syncthreads();

  // one thread per live output (d, x): its live pairs are the set bits of
  // (x's words) & (x + d's words moved down by dq)
  const int nl = n_list;
  for (int e = tid; e < nl; e += kThreads) {
    const unsigned ent = list[e];
    const int di = (int)(ent >> 5), l = (int)(ent & 31u);
    const int dy = di / ndx, dx = di - dy * ndx - (p - 1);
    const int dq = dy * p + dx;  // > 0 for a canonical d
    const int shift = dq & 31, jump = dq >> 5;
    const unsigned* fit_x = s_fit_x + (dx + p - 1) * nw;
    // the words of the q with qy + dy < p; for the others r = q + dq is
    // past the patch, where G has no bit
    const int kmax = ((p - dy) * p + 31) >> 5;
    const long long xl = s_pix[l];
    const uint2* g = G + list_j[e];
    uint2 g0 = g[(long long)jump * n];
    float pp = 0.f;
    int sc = 0, cnt = 0;
    for (int k = 0; k < kmax; ++k) {
      const int jj = k + jump + 1;
      const uint2 g1 = jj < nw ? g[(long long)jj * n] : make_uint2(0u, 0u);
      // the words of r = q + dq, bit for bit beside q's; r is the pixel
      // q + d only where qx + dx stays in the patch's row
      const unsigned hr = __funnelshift_r(g0.x, g1.x, shift) & fit_x[k];
      const unsigned lr = __funnelshift_r(g0.y, g1.y, shift) & fit_x[k];
      g0 = g1;
      const uint2 cq = s_code[k * kLanes + l];
      const int n_hh = __popc(cq.x & hr);
      const int n_hl = __popc(cq.x & lr) + __popc(cq.y & hr);
      sc += n_hh - n_hl;
      cnt += n_hh + n_hl;
      // with s = a - b a pair's product a_q (a_r - b_r) - b_q a_r is
      // s_q s_r - b_q b_r; the pairs outside m weigh zero
      unsigned m = (cq.x & (hr | lr)) | (cq.y & hr);
      while (m) {
        // up to kBatch pairs: their loads first, then the terms in order
        int bs[kBatch];
        float vq[kBatch], vr[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          bs[u] = m ? __ffs(m) - 1 : -1;
          m &= m - 1;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = 32 * k + max(bs[u], 0);
          const long long at = (long long)q * HW + xl + s_coff[q];
          vq[u] = bs[u] >= 0 ? ag[at] : 0.f;
          vr[u] = bs[u] >= 0 ? ag[at + dq * HW] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int b = bs[u];
          if (b < 0) break;
          const float bq = 1.f - vq[u], br = 1.f - vr[u];
          const float sq = ((cq.x >> b) & 1u ? vq[u] : 0.f) -
                           ((cq.y >> b) & 1u ? bq : 0.f);
          const float sr =
              ((hr >> b) & 1u ? vr[u] : 0.f) - ((lr >> b) & 1u ? br : 0.f);
          pp += sq * sr;
          if (((cq.y & lr) >> b) & 1u) pp -= bq * br;
        }
      }
    }
    float val;
    if (mode == kNormProbProduct) {
      val = (pp - th * th * (float)sc) / (1.f - th * th);
    } else if (mode == kProbProduct) {
      val = pp;
    } else {
      val = (float)sc;
    }
    if (norm_aff && cnt != 0) val = val / (float)cnt;
    store(out + (long long)di * HW + xl, val);
  }
}

template <typename OutT>
int launch_tiles(const float* ag, const int* idx, const int* pix,
                 const uint2* G, void* out, int n, int H, int W, int p,
                 int mode, float th, int norm_aff, cudaStream_t s) {
  const int P = p * p, nw = (P + 31) / 32, ndx = 2 * p - 1;
  const size_t smem = (size_t)nw * kLanes * sizeof(uint2) +
                      (size_t)kListMax * 2 * sizeof(int) +
                      (size_t)P * sizeof(int) +
                      (size_t)ndx * nw * sizeof(unsigned);
  // 44 KB at 25x25: with the static arrays near the 48 KB default
  cudaError_t e = cudaFuncSetAttribute(
      consensus2d_tiles_kernel<OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((n + kLanes - 1) / kLanes),
                  (unsigned)((p * ndx + kDPerBlock - 1) / kDPerBlock));
  consensus2d_tiles_kernel<OutT><<<grid, dim3(kLanes, kWarps), smem, s>>>(
      ag, idx, pix, G, static_cast<OutT*>(out), n, H, W, p, nw, mode, th,
      norm_aff);
  return (int)cudaGetLastError();
}

}  // namespace

// Step (1): row_off (H + 1) int32 gets each row's first listed index and
// row_off[H] the number n of target pixels (tgt != 0).  Launches on
// `stream`; returns the CUDA error code (0 on success).
extern "C" int ppp_consensus2d_count(const float* tgt, int H, int W,
                                     int* row_off, void* stream) {
  if ((long long)H * W > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > 0) count_rows_kernel<<<H, kThreads, 0, s>>>(tgt, row_off, W);
  scan_rows_kernel<<<1, kThreads, 0, s>>>(row_off, H);
  return (int)cudaGetLastError();
}

// Steps (2)-(5): ag (P, H, W), tgt (H, W) float32; out the canonical half;
// row_off from ppp_consensus2d_count and its total n; scratch idx (H, W)
// int32, pix (n) int32, G (ceil(P / 32), n, 2) int32.  Launches on
// `stream`; returns the CUDA error code (0 on success).
extern "C" int ppp_consensus2d_half(const float* ag, const float* tgt,
                                    void* out, int out_bf16, int H, int W,
                                    int p, int mode, float th, float bg,
                                    int norm_aff, const int* row_off, int n,
                                    int* idx, int* pix, void* G,
                                    void* stream) {
  if (H == 0 || W == 0) return 0;
  if ((long long)H * W > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long elems = (long long)p * (2 * p - 1) * H * W;
  ppp::fill_zero(out, elems * (out_bf16 ? 2 : 4), s);
  if (n == 0) return (int)cudaGetLastError();
  index_rows_kernel<<<H, kThreads, 0, s>>>(tgt, row_off, idx, pix, W);
  const int nw = (p * p + 31) / 32;
  const long long threads = 256;
  const long long blocks = ((long long)n * nw + threads - 1) / threads;
  pack_targets_kernel<<<(unsigned)blocks, (unsigned)threads, 0, s>>>(
      ag, pix, static_cast<uint2*>(G), n, H, W, p, nw, th, bg);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const uint2* g = static_cast<const uint2*>(G);
  return out_bf16 ? launch_tiles<__nv_bfloat16>(ag, idx, pix, g, out, n, H,
                                                W, p, mode, th, norm_aff, s)
                  : launch_tiles<float>(ag, idx, pix, g, out, n, H, W, p,
                                        mode, th, norm_aff, s);
}

extern "C" const char* ppp_consensus2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
