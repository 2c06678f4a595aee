// The pack pass shared by consensus.cu and rank.cu: the two 0/1 mask
// stacks hi, lo (P, Z, Y, X) float32 as bit masks, and the byte plane the
// kernels leave early on.  W = ceil(P / 32) words per voxel; the words of a
// voxel u are codes[k][u], a uint2 of the hi word and the lo word (one
// 8-byte load gives both).  Two alignments:
//
// - centre-aligned (rank.cu): voxels are the centers c of the volume; bit
//   (q & 31) of codes[q >> 5][c] is hi / lo[q][c] != 0.  Plane E (Z*Y*X
//   bytes): 1 where any bit of center c is set (an eligible center).
// - target-aligned (consensus.cu): voxels are those of the rad-padded
//   volume (Z + 2rz, Y + 2ry, X + 2rx); the bit of (q, c) sits at the
//   padded voxel c + q, that is at q's target voxel c + q - rad, so a
//   voxel's words say which patch pixels of which centers point at it.
//   Plane T (the padded volume in bytes): 1 where any bit is set.  This
//   pass also writes centre-major scratch vals (2, Z*Y*X, P) from the
//   float stacks a, b (P, Z, Y, X): vals[0] = a - b wherever a bit is set
//   (a counted only under the hi bit, b only under the lo bit), vals[1] = b
//   wherever the lo bit is set, and nothing elsewhere.  The consensus
//   kernel reads a value only under its bit, and its neighbouring threads
//   then stand at one center and neighbouring pixels, which centre-major
//   keeps in one line.
//
// At 50^3 / 7^3 the stacks are 343 MB and the codes 11 MB (15 MB padded),
// which stays in the 50 MB L2, so the kernels after this pass never touch
// the float masks.  One thread packs one word of one voxel: 32 loads from
// each stack, consecutive threads on consecutive voxels, so on consecutive
// centers for every q.  The plane is set by plain byte stores of the value
// 1 (every writer stores the same value, so the order does not matter); it
// is cleared first on the same stream.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The only Hopper-era instructions of these sources: an 8-byte asynchronous
// copy from global to shared memory and the wait for all of a thread's
// copies.  A host build that defines PPP_HOST_MOCK takes plain loads.
#ifdef PPP_HOST_MOCK
#define PPP_CP_ASYNC_8(dst, src) (*(dst) = *(src))
#define PPP_CP_ASYNC_WAIT_ALL() ((void)0)
#else
#define PPP_CP_ASYNC_8(dst, src)                                            \
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(          \
                   (unsigned)__cvta_generic_to_shared(dst)),                \
               "l"(src)                                                     \
               : "memory")
#define PPP_CP_ASYNC_WAIT_ALL() \
  asm volatile("cp.async.wait_all;\n" ::: "memory")
#endif

namespace ppp {

template <bool kTarget>
__global__ void pack_codes_kernel(const float* __restrict__ hi,
                                  const float* __restrict__ lo,
                                  const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  uint2* __restrict__ codes,
                                  unsigned char* __restrict__ plane,
                                  float* __restrict__ vals, int Z, int Y,
                                  int X, int psz, int psy, int psx, int W) {
  const long long V = (long long)Z * Y * X;
  // the voxels the words are kept for
  const int nz = kTarget ? Z + 2 * (psz / 2) : Z;
  const int ny = kTarget ? Y + 2 * (psy / 2) : Y;
  const int nx = kTarget ? X + 2 * (psx / 2) : X;
  const long long n_vox = (long long)nz * ny * nx;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_vox * W) return;
  const long long u = idx % n_vox;
  const int k = (int)(idx / n_vox);
  const int ux = (int)(u % nx), uy = (int)((u / nx) % ny);
  const int uz = (int)(u / ((long long)nx * ny));
  const int P = psz * psy * psx;
  const int q0 = k * 32, q1 = min(P, q0 + 32);
  int qx = q0 % psx, qy = (q0 / psx) % psy, qz = q0 / (psx * psy);
  unsigned h = 0, l = 0;
  for (int q = q0; q < q1; ++q) {
    // the center whose pixel q this voxel holds
    const int cz = kTarget ? uz - qz : uz;
    const int cy = kTarget ? uy - qy : uy;
    const int cx = kTarget ? ux - qx : ux;
    if (cz >= 0 && cz < Z && cy >= 0 && cy < Y && cx >= 0 && cx < X) {
      const long long c = ((long long)cz * Y + cy) * X + cx;
      const long long at = (long long)q * V + c;
      const bool hq = hi[at] != 0.f, lq = lo[at] != 0.f;
      if (hq) h |= 1u << (q - q0);
      if (lq) l |= 1u << (q - q0);
      if (kTarget && (hq || lq)) {
        const float bq = lq ? b[at] : 0.f;
        vals[c * P + q] = (hq ? a[at] : 0.f) - bq;
        if (lq) vals[(V + c) * P + q] = bq;
      }
    }
    if (++qx == psx) {
      qx = 0;
      if (++qy == psy) {
        qy = 0;
        ++qz;
      }
    }
  }
  codes[(long long)k * n_vox + u] = make_uint2(h, l);
  if ((h | l) != 0) plane[u] = 1;
}

// Clears the plane and launches the pass on `s`; returns the CUDA error
// code.  kTarget false: codes (W, Z*Y*X) and plane E (a, b, vals unused);
// true: codes over the padded volume, plane T and vals.
template <bool kTarget>
int pack_codes(const float* hi, const float* lo, const float* a,
               const float* b, void* codes, unsigned char* plane, float* vals,
               int Z, int Y, int X, int psz, int psy, int psx,
               cudaStream_t s) {
  const long long n_vox =
      kTarget ? (long long)(Z + 2 * (psz / 2)) * (Y + 2 * (psy / 2)) *
                    (X + 2 * (psx / 2))
              : (long long)Z * Y * X;
  const int W = (psz * psy * psx + 31) / 32;
  cudaError_t e = cudaMemsetAsync(plane, 0, (size_t)n_vox, s);
  if (e != cudaSuccess) return (int)e;
  const int threads = 256;
  const long long blocks = (n_vox * W + threads - 1) / threads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  pack_codes_kernel<kTarget><<<(unsigned)blocks, threads, 0, s>>>(
      hi, lo, a, b, static_cast<uint2*>(codes), plane, vals, Z, Y, X, psz,
      psy, psx, W);
  return (int)cudaGetLastError();
}

}  // namespace ppp
