// What the two cover loops share (cover_cascade.cu, thin_cover.cu): the
// geometry of a patch window over the rad-padded volume, the pack passes
// that turn the affinity columns and the mask to cover into bits, and the
// warp-level count and take of one window.
//
// Layout.
// - Patch masks: candidate i's fc-thresholded column as bits, Wp = W + 1
//   words a candidate (W = ceil(P / 32); the last word is 0, so that a read
//   of word w + 1 never leaves the row): bit q % 32 of word q / 32 is
//   affs[q][center i] > fc, q in patch_offsets' C order.
// - Running volume: the mask to cover padded by rad on every side, one bit
//   per padded voxel in row-major order, plus one zero word at the end.
//   Candidate i's window starts at the padded voxel c_i (the unpadded
//   center): pixel q lies at c_i + off(q).
// - A window is read in items: patch row (dz, dy) cut into segments of at
//   most 32 pixels.  An item's mask bits are contiguous in the candidate's
//   words and its volume bits in the running words, so each is one funnel
//   shift of two words, and the item's count is one popcount.
// - The interior (the voxels at least rad from every border; in padded
//   coordinates [2 rad, extent) on each axis) is computed, not stored.
//
// Counts are exact integers.  The JAX package sums 0/1 float32 products,
// exact below 2^24, so integer counts make the same comparisons and the
// same argmax.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ppp_cover {

struct Geom {
  int Z, Y, X;          // volume
  int pz, py, px;       // patch shape
  int rz, ry, rx;       // patch radius
  int PY, PX;           // padded extents of y and x
  long long nbits;      // padded voxels
  long long nwords;     // running words: ceil(nbits / 32) + 1
  int P, W, Wp;         // patch pixels, words of a mask, words a candidate
  int segs, items;      // segments of a patch row, items of a window
};

inline Geom make_geom(int Z, int Y, int X, int pz, int py, int px) {
  Geom g;
  g.Z = Z; g.Y = Y; g.X = X;
  g.pz = pz; g.py = py; g.px = px;
  g.rz = pz / 2; g.ry = py / 2; g.rx = px / 2;
  g.PY = Y + 2 * g.ry;
  g.PX = X + 2 * g.rx;
  g.nbits = (long long)(Z + 2 * g.rz) * g.PY * g.PX;
  g.nwords = (g.nbits + 31) / 32 + 1;
  g.P = pz * py * px;
  g.W = (g.P + 31) / 32;
  g.Wp = g.W + 1;
  g.segs = (px + 31) / 32;
  g.items = pz * py * g.segs;
  return g;
}

inline bool geom_ok(int Z, int Y, int X, int pz, int py, int px) {
  return Z > 0 && Y > 0 && X > 0 && pz > 0 && py > 0 && px > 0;
}

// Statistics a launch writes (int32 each): the interior pixels to cover at
// the start, then the loop's own counts (cover_cascade.cu, thin_cover.cu).
constexpr int kStatRem = 0;
constexpr int kStats = 8;

__device__ __forceinline__ unsigned low_mask(int L) {
  return L >= 32 ? 0xffffffffu : ((1u << L) - 1u);
}

// L <= 32 bits of `words` from bit `pos` on.
__device__ __forceinline__ unsigned bits_at(const unsigned* words,
                                            long long pos, int L) {
  const long long w = pos >> 5;
  return __funnelshift_r(words[w], words[w + 1], (unsigned)(pos & 31)) &
         low_mask(L);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Item k of the window at center (cz, cy, cx): its first padded voxel, its
// first patch pixel, its length, and its padded row (z, y) and first x.
struct Item {
  long long pos;
  int q0, L, z, y, x;
};

__device__ __forceinline__ Item window_item(const Geom& g, const int* c,
                                            int k) {
  const int row = k / g.segs;
  const int x0 = (k - row * g.segs) * 32;
  const int dz = row / g.py, dy = row - dz * g.py;
  Item it;
  it.z = c[0] + dz;
  it.y = c[1] + dy;
  it.x = c[2] + x0;
  it.L = min(32, g.px - x0);
  it.q0 = row * g.px + x0;
  it.pos = ((long long)it.z * g.PY + it.y) * g.PX + it.x;
  return it;
}

// The item's bits that lie in the interior.
__device__ __forceinline__ unsigned inner_bits(const Geom& g, const Item& it) {
  if (it.z < 2 * g.rz || it.z >= g.Z || it.y < 2 * g.ry || it.y >= g.Y)
    return 0u;
  const int lo = max(0, 2 * g.rx - it.x);
  const int hi = min(it.L, g.X - it.x);
  return lo < hi ? low_mask(hi) & ~low_mask(lo) : 0u;
}

// Still-uncovered pixels of candidate `pm`'s window at center `c`; called
// by all 32 lanes of a warp, every lane gets the count.
__device__ __forceinline__ int warp_count(const Geom& g, const unsigned* pm,
                                          const unsigned* run, const int* c) {
  int cnt = 0;
  for (int k = threadIdx.x & 31; k < g.items; k += 32) {
    const Item it = window_item(g, c, k);
    cnt += __popc(bits_at(pm, it.q0, it.L) & bits_at(run, it.pos, it.L));
  }
  return warp_sum(cnt);
}

// Take candidate `pm` at `c`: clear its newly covered pixels in `run` and
// return how many of them lie in the interior; all 32 lanes of a warp call
// it.  Items of neighbouring rows may share a running word, so the clears
// are atomic; an item reads only its own bits, which no other lane clears.
__device__ __forceinline__ int warp_take(const Geom& g, const unsigned* pm,
                                         unsigned* run, const int* c) {
  int dec = 0;
  for (int k = threadIdx.x & 31; k < g.items; k += 32) {
    const Item it = window_item(g, c, k);
    const unsigned nw =
        bits_at(pm, it.q0, it.L) & bits_at(run, it.pos, it.L);
    if (nw == 0u) continue;
    dec += __popc(nw & inner_bits(g, it));
    const long long w = it.pos >> 5;
    const unsigned s = (unsigned)(it.pos & 31);
    atomicAnd(run + w, ~(nw << s));
    if (s != 0u && (nw >> (32u - s)) != 0u)
      atomicAnd(run + w + 1, ~(nw >> (32u - s)));
  }
  __syncwarp();
  return warp_sum(dec);
}

// pm[i * Wp + w] for one (i, w) a thread.
__global__ void pack_masks(const float* __restrict__ affs,
                           const int* __restrict__ centers, int n, Geom g,
                           float fc, unsigned* __restrict__ pm) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n * g.Wp) return;
  const int i = (int)(t / g.Wp);
  const int w = (int)(t - (long long)i * g.Wp);
  unsigned bits = 0u;
  if (w < g.W) {
    const long long V = (long long)g.Z * g.Y * g.X;
    const long long col =
        ((long long)centers[3 * i] * g.Y + centers[3 * i + 1]) * g.X +
        centers[3 * i + 2];
    const int q_end = min(g.P, 32 * w + 32);
    for (int q = 32 * w; q < q_end; ++q)
      bits |= (unsigned)(affs[(long long)q * V + col] > fc) << (q - 32 * w);
  }
  pm[t] = bits;
}

// run[w] for one word a thread; the interior pixels to cover are added to
// *rem (zeroed before).
__global__ void pack_running(const unsigned char* __restrict__ mask, Geom g,
                             unsigned* __restrict__ run, int* rem) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= g.nwords) return;
  unsigned bits = 0u;
  int inner = 0;
  for (int b = 0; b < 32; ++b) {
    const long long p = w * 32 + b;
    if (p >= g.nbits) break;
    const int x = (int)(p % g.PX);
    const long long zy = p / g.PX;
    const int y = (int)(zy % g.PY);
    const int z = (int)(zy / g.PY);
    const int uz = z - g.rz, uy = y - g.ry, ux = x - g.rx;
    if (uz < 0 || uz >= g.Z || uy < 0 || uy >= g.Y || ux < 0 || ux >= g.X)
      continue;
    if (!mask[((long long)uz * g.Y + uy) * g.X + ux]) continue;
    bits |= 1u << b;
    inner += z >= 2 * g.rz && z < g.Z && y >= 2 * g.ry && y < g.Y &&
             x >= 2 * g.rx && x < g.X;
  }
  run[w] = bits;
  if (inner) atomicAdd(rem, inner);
}

// Both pack passes on `s`, after zeroing `stats`.
inline cudaError_t pack_all(const float* affs, const unsigned char* mask,
                            const int* centers, int n, const Geom& g,
                            float fc, unsigned* pm, unsigned* run,
                            int* stats, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(stats, 0, kStats * sizeof(int), s);
  if (e != cudaSuccess) return e;
  const long long mask_threads = (long long)n * g.Wp;
  pack_masks<<<(unsigned)((mask_threads + 255) / 256), 256, 0, s>>>(
      affs, centers, n, g, fc, pm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pack_running<<<(unsigned)((g.nwords + 255) / 256), 256, 0, s>>>(
      mask, g, run, stats + kStatRem);
  return cudaGetLastError();
}

// The most dynamic shared memory a block of the current device may opt in
// to.
inline cudaError_t smem_limit(int* limit) {
  int d = 0;
  cudaError_t e = cudaGetDevice(&d);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, d);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in.  It is set
// to the device's limit, the same value from every host thread that asks,
// so that launches of other sizes from several threads cannot undo it.
template <typename K>
cudaError_t opt_in(K kernel, size_t smem, int limit) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
}

}  // namespace ppp_cover
