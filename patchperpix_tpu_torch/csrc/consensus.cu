// Canonical half of the consensus vote array: the masks packed to
// target-aligned bit words, a block per row tile of 32 output voxels, the
// live pairs of an output as the set bits of two words.
//
// Replaces the Pallas TPU kernel patchperpix_tpu/ops/pallas_consensus.py
// ::_kernel_v5 (pallas_consensus.py:209, launched by consensus_array_pallas
// at :311 / pallas_call :395); the v4 body ::_kernel (:88) computes the same
// function.  Plain PyTorch version: ops/consensus.py::consensus_half_plain.
//
// Function.  For a canonical displacement d (dz > 0, or dz == 0 and
// (dy, dx) lex-positive) and output voxel x:
//
//   cons[d][x] = sum over patch pixels q with q and r = q + d inside the
//                patch and center c = x - (q - rad) inside the volume of
//                w(q, r) at c,
//
// with the 0/1 mask stacks hi, lo and the stacks a = affs*hi, b =
// (1-affs)*lo (a is zero where hi is, b where lo is), each (P, Z, Y, X)
// float32, centre-aligned, read at c for both q and r (the target alignment
// G[q][x] = stack[q][x - (q - rad)] and G[r][x + d] land on the same
// center), and
//
//   pp  = a_q (a_r - b_r) - b_q a_r        sc = hi_q (hi_r - lo_r) - lo_q hi_r
//   cnt = hi_q (hi_r + lo_r) + lo_q hi_r
//   norm_prob_product: (pp - th^2 sc) / (1 - th^2);  prob_product: pp;
//   count: sc;  then cons / cnt where cnt != 0 when norm_aff.
//
// Output: (psz, 2psy-1, 2psx-1, Z, Y, X), float32 or bf16; the
// lex-nonpositive (dy, dx) entries of the dz == 0 plane are written 0.
//
// Bound.  At the FlyLight crop (50^3 voxels, 7^3 patch) the function reads
// the four f32 stacks once (4 * 343 * 125000 * 4 B = 686 MB) and writes the
// half once (1183 * 125000 * 4 B = 592 MB): 1.28 GB, 0.38 ms at 3.35 TB/s.
// The arithmetic it needs is 15 float operations per live unordered pixel
// pair at an eligible center (data-dependent; scripts/time_kernels_3d.py
// counts it for each run: 117.3 M pairs on the crop, 0.026 ms at 67 TFLOP/s), below the
// byte time.  So the bound is memory bytes.
//
// Design.  Three kernels on one stream; their time together is the
// kernel's.
// (1) pack_codes.cuh, target-aligned: two bits per (q, c), kept at q's
//     target voxel, so the words G[x] of a voxel say which pixels of which
//     centers point at it (15 MB instead of 343 MB at the crop: it stays in
//     L2); the byte plane T of voxels with any bit; and the values a - b
//     (and b) under set bits, centre-major.
// (2) fill_zero.cuh writes the whole half as zeros in address order at
//     the memory's rate: on the crop 95 % of it stays zero.
// (3) A block owns up to 32 voxels of one row for all displacements.  An
//     output (d, x) can be nonzero only where T[x] and T[x + d] both hold;
//     a tile with no T leaves at once.  In rounds of 128 displacements the
//     warps test T[x + d] and put the live (d, lane) on a list in shared
//     memory; then all 256 threads take list entries, so a warp's lanes
//     all hold a live output whatever the tile's fill.  For an output, q
//     and r = q + d share a center exactly when bit q of G[x] and bit
//     r = q + dq of G[x + d] are set (dq = r - q in the patch's linear
//     order) and q + d fits the patch: the thread moves G[x + d]'s words
//     down by dq (funnel shifts), masks them with per-axis fit words from
//     shared memory, and ANDs them with G[x]'s words (staged in shared
//     memory by asynchronous copies).  sc and cnt are popcounts of those
//     words.  Only the set bits, the live pairs, are walked: with
//     s = a - b a pair's product a_q (a_r - b_r) - b_q a_r is
//     s_q s_r - b_q b_r, and b_q b_r is nonzero only where both bits are
//     lo, so a pair costs two float loads, and neighbouring list entries
//     (same d, next x) stand at the same center and the next pixel, one
//     line in the centre-major scratch.  No float of a dead pair is
//     loaded, and the float masks are read by the pack pass alone.  Each
//     output is one thread's sum in a fixed order (the list's order only
//     decides which thread): equal bits on every launch.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit
// (scripts/time_kernels_3d.py, FlyLight crop): 2.1 ms for the wrapper
// (pack 0.31, fill 0.19, tiles 1.35), against 18.0 ms for the
// one-thread-per-output kernel it replaces, which read the float masks at
// every (d, q, x) step.  Designs measured and dropped are in PERF.md.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fill_zero.cuh"
#include "pack_codes.cuh"

namespace {

enum WeightMode { kNormProbProduct = 0, kProbProduct = 1, kCount = 2 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

constexpr int kLanes = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kLanes * kWarps;
constexpr int kDPerWarp = 16;  // displacements per warp in one round
constexpr int kListMax = kThreads * kDPerWarp;

struct Shape {
  int Z, Y, X, psz, psy, psx;
};

template <typename OutT>
__global__ void __launch_bounds__(256, 6) consensus_half_kernel(
    const float* __restrict__ vals, const uint2* __restrict__ G,
    const unsigned char* __restrict__ T, OutT* __restrict__ out, Shape sh,
    int W, int mode, float th, int norm_aff) {
  // the tile's own code words (W, kLanes); the list of live outputs as
  // (di << 5) | lane (kListMax); per pixel q its center's offset from the
  // output voxel (P); per displacement its components (nd); per
  // displacement component the words of the pixels
  // q that keep q + d inside the patch (psz + ndy + ndx rows of W)
  extern __shared__ uint2 smem[];
  __shared__ int n_list;
  uint2* s_code = smem;
  unsigned* list = reinterpret_cast<unsigned*>(s_code + W * kLanes);
  int* s_coff = reinterpret_cast<int*>(list + kListMax);
  const int Z = sh.Z, Y = sh.Y, X = sh.X;
  const int psz = sh.psz, psy = sh.psy, psx = sh.psx;
  const int P = psz * psy * psx;
  const int ndy = 2 * psy - 1, ndx = 2 * psx - 1;
  const int nd = psz * ndy * ndx;
  int* s_d3 = s_coff + P;  // (dzi << 16) | (dyi << 8) | dxi per di
  unsigned* s_fit_z = reinterpret_cast<unsigned*>(s_d3 + nd);
  unsigned* s_fit_y = s_fit_z + psz * W;
  unsigned* s_fit_x = s_fit_y + ndy * W;

  const int lane = threadIdx.x, w = threadIdx.y;
  const int tid = w * kLanes + lane;
  const long long V = (long long)Z * Y * X;
  // the tile: up to kLanes voxels of one row
  const int x0 = blockIdx.x * kLanes, x = x0 + lane;
  const int y = blockIdx.y % Y, z = blockIdx.y / Y;
  const bool in = x < X;
  const long long v = ((long long)z * Y + y) * X + x;
  const int rz = psz / 2, ry = psy / 2, rx = psx / 2;
  const int Zp = Z + 2 * rz, Yp = Y + 2 * ry, Xp = X + 2 * rx;
  const long long Vp = (long long)Zp * Yp * Xp;
  // this voxel in the padded coordinates of T and G
  const int tz = z + rz, ty = y + ry, tx = x + rx;
  const long long tv = ((long long)tz * Yp + ty) * Xp + tx;
  const bool t_here = in && T[tv] != 0;
  // the half is zero already: a tile without a live voxel is done
  if (!__syncthreads_or(t_here ? 1 : 0)) return;
  for (int k = w; k < W; k += kWarps) {
    if (t_here) {
      PPP_CP_ASYNC_8(&s_code[k * kLanes + lane], &G[(long long)k * Vp + tv]);
    } else {
      s_code[k * kLanes + lane] = make_uint2(0u, 0u);
    }
  }
  for (int q = tid; q < P; q += kThreads) {
    const int qz = q / (psx * psy), qy = (q / psx) % psy, qx = q % psx;
    s_coff[q] = ((rz - qz) * Y + (ry - qy)) * X + (rx - qx);
  }
  for (int di = tid; di < nd; di += kThreads)
    s_d3[di] = ((di / (ndx * ndy)) << 16) | (((di / ndx) % ndy) << 8) |
               (di % ndx);
  // word k of row i: the pixels q = 32 k + bit whose coordinate on that axis
  // keeps q + d inside the patch, for dz = i, dy = i - (psy - 1), dx alike
  for (int i = tid; i < (psz + ndy + ndx) * W; i += kThreads) {
    const int row = i / W, k = i % W;
    unsigned m = 0;
    for (int bit = 0; bit < 32 && k * 32 + bit < P; ++bit) {
      const int q = k * 32 + bit;
      int coord, extent, d;
      if (row < psz) {
        coord = q / (psx * psy), extent = psz, d = row;
      } else if (row < psz + ndy) {
        coord = (q / psx) % psy, extent = psy, d = row - psz - (psy - 1);
      } else {
        coord = q % psx, extent = psx, d = row - psz - ndy - (psx - 1);
      }
      if (coord + d >= 0 && coord + d < extent) m |= 1u << bit;
    }
    s_fit_z[i] = m;
  }
  PPP_CP_ASYNC_WAIT_ALL();
  for (int d0 = 0; d0 < nd; d0 += kWarps * kDPerWarp) {
    if (tid == 0) n_list = 0;
    __syncthreads();
    // the live outputs of this round go on the block's list
    for (int k = 0; k < kDPerWarp; ++k) {
      const int di = d0 + w * kDPerWarp + k;
      if (di >= nd) break;
      const int d3 = s_d3[di];
      const int dz = d3 >> 16;
      const int dy = ((d3 >> 8) & 255) - (psy - 1), dx = (d3 & 255) - (psx - 1);
      const int uz = tz + dz, uy = ty + dy, ux = tx + dx;
      const bool canon = dz > 0 || dy > 0 || (dy == 0 && dx > 0);
      const bool live = t_here && canon && uz < Zp && uy >= 0 && uy < Yp &&
                        ux >= 0 && ux < Xp &&
                        T[((long long)uz * Yp + uy) * Xp + ux] != 0;
      if (live)
        list[atomicAdd(&n_list, 1)] = ((unsigned)di << 5) | (unsigned)lane;
    }
    __syncthreads();
    // one thread per live output (d, voxel x): its live pairs are the set
    // bits of (x's words) & (x + d's words moved down by dq = r - q)
    const int n = n_list;
    for (int i = tid; i < n; i += kThreads) {
      const unsigned e = list[i];
      const int di = (int)(e >> 5), l = (int)(e & 31u);
      const int d3 = s_d3[di];
      const int dzi = d3 >> 16, dyi = (d3 >> 8) & 255, dxi = d3 & 255;
      const int dy = dyi - (psy - 1), dx = dxi - (psx - 1);
      const int dq = (dzi * psy + dy) * psx + dx;  // > 0 for a canonical d
      const int shift = dq & 31, jump = dq >> 5;
      const unsigned* fit_z = s_fit_z + dzi * W;
      const unsigned* fit_y = s_fit_y + dyi * W;
      const unsigned* fit_x = s_fit_x + dxi * W;
      const uint2* g_at =
          G + (tv - lane + l) + ((long long)dzi * Yp + dy) * Xp + dx;
      const long long v_l = v - lane + l;
      const float* s_c = vals;          // a - b, centre-major
      const float* b_c = vals + V * P;  // b
      float pp = 0.f;
      int sc = 0, cnt = 0;
      uint2 g0 = jump < W ? g_at[(long long)jump * Vp] : make_uint2(0u, 0u);
      for (int k = 0; k < W; ++k) {
        const int j = k + jump + 1;
        const uint2 g1 = j < W ? g_at[(long long)j * Vp] : make_uint2(0u, 0u);
        // the words of r = q + dq, bit for bit beside q's; r = q + dq is
        // the pixel q + d only where q + d fits the patch
        const unsigned fit = fit_z[k] & fit_y[k] & fit_x[k];
        const unsigned hr_w = __funnelshift_r(g0.x, g1.x, shift) & fit;
        const unsigned lr_w = __funnelshift_r(g0.y, g1.y, shift) & fit;
        g0 = g1;
        const uint2 cq = s_code[k * kLanes + l];
        // sc and cnt count pairs by kind; with s = a - b a pair's product
        // a_q (a_r - b_r) - b_q a_r is s_q s_r - b_q b_r, and b_q b_r is
        // nonzero only where both are lo
        const int n_hh = __popc(cq.x & hr_w);
        const int n_hl = __popc(cq.x & lr_w) + __popc(cq.y & hr_w);
        sc += n_hh - n_hl;
        cnt += n_hh + n_hl;
        unsigned m = (cq.x & (hr_w | lr_w)) | (cq.y & hr_w);
        unsigned both_lo = m & cq.y & lr_w;
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          const int q = k * 32 + bit;
          const long long iq = (v_l + s_coff[q]) * P + q;
          pp += s_c[iq] * s_c[iq + dq];
        }
        while (both_lo) {
          const int bit = __ffs(both_lo) - 1;
          both_lo &= both_lo - 1;
          const int q = k * 32 + bit;
          const long long iq = (v_l + s_coff[q]) * P + q;
          pp -= b_c[iq] * b_c[iq + dq];
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
      store(out + (long long)di * V + v_l, val);
    }
    __syncthreads();
  }
}

template <typename OutT>
int launch(const float* vals, const void* G, const unsigned char* T,
           void* out, Shape sh, int mode, float th, int norm_aff,
           cudaStream_t s) {
  const int P = sh.psz * sh.psy * sh.psx, W = (P + 31) / 32;
  const long long rows = (long long)sh.Z * sh.Y;
  const int ndy = 2 * sh.psy - 1, ndx = 2 * sh.psx - 1;
  if (rows > INT_MAX || (long long)sh.psz * ndy * ndx > (1 << 16) ||
      ndy > 255 || ndx > 255)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)W * kLanes * sizeof(uint2) +
                      (size_t)kListMax * sizeof(unsigned) +
                      (size_t)(P + sh.psz * ndy * ndx) * sizeof(int) +
                      (size_t)(sh.psz + ndy + ndx) * W * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        consensus_half_kernel<OutT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ppp::fill_zero(out, rows * sh.X * sh.psz * ndy * ndx * sizeof(OutT), s);
  const dim3 grid((unsigned)((sh.X + kLanes - 1) / kLanes), (unsigned)rows);
  const dim3 block(kLanes, kWarps);
  consensus_half_kernel<OutT><<<grid, block, smem, s>>>(
      vals, static_cast<const uint2*>(G), T, static_cast<OutT*>(out), sh, W,
      mode, th, norm_aff);
  return (int)cudaGetLastError();
}

}  // namespace

// a, b, hi, lo (P, Z, Y, X) float32; out the canonical half.  Scratch from
// the caller (pack_codes.cuh, target-aligned): codes, ceil(P / 32) * 8
// bytes per voxel of the rad-padded volume; targets, one byte per such
// voxel; vals, 2 * Z*Y*X * P floats.  Launches on `stream`; returns the
// CUDA error code (0 on success).
extern "C" int ppp_consensus_half(const float* a, const float* b,
                                  const float* hi, const float* lo,
                                  void* out, int out_bf16, int Z, int Y,
                                  int X, int psz, int psy, int psx,
                                  int mode, float th, int norm_aff,
                                  void* codes, void* targets, float* vals,
                                  void* stream) {
  if ((long long)psz * psy * psx * Z * Y * X == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* T = static_cast<unsigned char*>(targets);
  const int e = ppp::pack_codes<true>(hi, lo, a, b, codes, T, vals, Z, Y, X,
                                      psz, psy, psx, s);
  if (e != 0) return e;
  const Shape sh = {Z, Y, X, psz, psy, psx};
  return out_bf16 ? launch<__nv_bfloat16>(vals, codes, T, out, sh, mode, th,
                                          norm_aff, s)
                  : launch<float>(vals, codes, T, out, sh, mode, th, norm_aff,
                                  s);
}

extern "C" const char* ppp_consensus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
