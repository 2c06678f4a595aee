// Canonical half of the consensus vote array, one thread per output element.
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
// with the stacks a = affs*hi, b = (1-affs)*lo, hi, lo (P, Z, Y, X),
// centre-aligned, read at c for both q and r (the target alignment
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
// The arithmetic it needs is 15 float operations per eligible unordered
// pixel pair at an eligible center (data-dependent; chip_smoke.py counts
// it for each run), below the byte time at the crop's fill.  So the bound
// is memory bytes.
//
// Design (simple first).  The thread order is x fastest, then the
// displacement index, then y, then z: the blocks resident at one time
// cover a few (z, y) rows for every displacement, so their reads of the
// stacks at the centers around those rows stay in L2 instead of streaming
// the 686 MB once per displacement.  Loads across a warp are consecutive x
// and coalesce.  A pair whose hi/lo entries are all zero adds exactly zero
// and is skipped before its a/b loads.  Every stack element is still read
// from L2 once per (d, q) that touches it; tiling the hi/lo planes in
// shared memory and reusing them across d is later work.

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum WeightMode { kNormProbProduct = 0, kProbProduct = 1, kCount = 2 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename OutT>
__global__ void consensus_half_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ hi, const float* __restrict__ lo,
    OutT* __restrict__ out, int Z, int Y, int X, int psz, int psy, int psx,
    int mode, float th, int norm_aff) {
  const int ndy = 2 * psy - 1, ndx = 2 * psx - 1;
  const long long nd = (long long)psz * ndy * ndx;
  const long long V = (long long)Z * Y * X;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nd * V) return;
  const int x = (int)(idx % X);
  long long t = idx / X;
  const int di = (int)(t % nd);
  t /= nd;
  const int y = (int)(t % Y);
  const int z = (int)(t / Y);
  const int dxi = di % ndx;
  const int dyi = (di / ndx) % ndy;
  const int dz = di / (ndx * ndy);
  const int dy = dyi - (psy - 1), dx = dxi - (psx - 1);

  float pp = 0.f, sc = 0.f, cnt = 0.f;
  const bool canon = dz > 0 || dy > 0 || (dy == 0 && dx > 0);
  if (canon) {
    const int rz = psz / 2, ry = psy / 2, rx = psx / 2;
    const long long dstep = (long long)((dz * psy + dy) * psx + dx) * V;
    const int qy_lo = max(0, -dy), qy_hi = min(psy, psy - dy);
    const int qx_lo = max(0, -dx), qx_hi = min(psx, psx - dx);
    for (int qz = 0; qz < psz - dz; ++qz) {
      const int cz = z - qz + rz;
      if (cz < 0 || cz >= Z) continue;
      for (int qy = qy_lo; qy < qy_hi; ++qy) {
        const int cy = y - qy + ry;
        if (cy < 0 || cy >= Y) continue;
        for (int qx = qx_lo; qx < qx_hi; ++qx) {
          const int cx = x - qx + rx;
          if (cx < 0 || cx >= X) continue;
          const long long c = ((long long)cz * Y + cy) * X + cx;
          const long long iq = (long long)((qz * psy + qy) * psx + qx) * V + c;
          const float hl = hi[iq], ll = lo[iq];
          if (hl == 0.f && ll == 0.f) continue;
          const long long ir = iq + dstep;
          const float hr = hi[ir], lr = lo[ir];
          if (hr == 0.f && lr == 0.f) continue;
          const float al = a[iq], bl = b[iq], ar = a[ir], br = b[ir];
          pp += al * (ar - br) - bl * ar;
          sc += hl * (hr - lr) - ll * hr;
          cnt += hl * (hr + lr) + ll * hr;
        }
      }
    }
  }
  float v;
  if (mode == kNormProbProduct) {
    v = (pp - th * th * sc) / (1.f - th * th);
  } else if (mode == kProbProduct) {
    v = pp;
  } else {
    v = sc;
  }
  if (norm_aff && cnt != 0.f) v = v / fmaxf(cnt, 1e-30f);
  const long long o = (((long long)di * Z + z) * Y + y) * X + x;
  store(out + o, v);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ppp_consensus_half(const float* a, const float* b,
                                  const float* hi, const float* lo,
                                  void* out, int out_bf16, int Z, int Y,
                                  int X, int psz, int psy, int psx,
                                  int mode, float th, int norm_aff,
                                  void* stream) {
  const long long total =
      (long long)psz * (2 * psy - 1) * (2 * psx - 1) * Z * Y * X;
  if (total == 0) return 0;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    consensus_half_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        a, b, hi, lo, static_cast<__nv_bfloat16*>(out), Z, Y, X, psz, psy,
        psx, mode, th, norm_aff);
  } else {
    consensus_half_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        a, b, hi, lo, static_cast<float*>(out), Z, Y, X, psz, psy, psx, mode,
        th, norm_aff);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_consensus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
