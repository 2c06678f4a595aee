// What the two cover loops share (cover_cascade.cu, thin_cover.cu): the
// geometry of a patch window over the rad-padded volume, the pack passes
// that turn the affinity columns and the mask to cover into bits, the
// warp-level count and visit of one window, and the Hopper primitives that
// stage masks in shared memory (a bulk asynchronous copy that completes on
// an mbarrier) and hand work between warps (mbarrier arrive / wait).
//
// Layout.
// - Patch masks: candidate i's fc-thresholded column as bits, Wp = W + 1
//   words a candidate (W = ceil(P / 32); the last word is 0, so that a read
//   of word w + 1 never leaves the row): bit q % 32 of word q / 32 is
//   affs[q][center i] > fc, q in patch_offsets' C order.  The buffer holds
//   n Wp words rounded up to a multiple of 4 (16 bytes), so that a bulk
//   copy of any run of rows, widened to 16-byte bounds, stays inside it.
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

// positive extents, and a window's span of padded voxels in an int
inline bool geom_ok(int Z, int Y, int X, int pz, int py, int px) {
  return Z > 0 && Y > 0 && X > 0 && pz > 0 && py > 0 && px > 0 &&
         (long long)pz * (Y + 2 * (py / 2)) * (X + 2 * (px / 2)) <
             (1ll << 31);
}

// Statistics a launch writes: int32 slots, the interior pixels to cover at
// the start, then the loop's own counts (cover_cascade.cu, thin_cover.cu);
// from kStatCycles on, kCycleSlots int64 sums of clock64() deltas: slot 0
// the loop kernel's cycles from start to end (thread 0), then the cycles
// that a thread spent in each phase of the loop.
constexpr int kStatRem = 0;
constexpr int kStatCycles = 8;
constexpr int kCycleSlots = 8;
constexpr int kStats = kStatCycles + 2 * kCycleSlots;

__device__ __forceinline__ long long* cycle_slots(int* stats) {
  return reinterpret_cast<long long*>(stats + kStatCycles);
}

__host__ __device__ constexpr size_t round16(size_t b) {
  return (b + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned low_mask(int L) {
  return L >= 32 ? 0xffffffffu : ((1u << L) - 1u);
}

// Reads of running words that another warp may be clearing at the same
// time (K5's bound pass runs beside its walk): a relaxed load, which the
// compiler neither caches nor splits.  Bits only ever clear, so a word
// read at any time holds every bit that it holds later.
__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
#ifdef PPP_HOST_MOCK
  return __atomic_load_n(p, __ATOMIC_RELAXED);
#else
  return *reinterpret_cast<const volatile unsigned*>(p);
#endif
}

__device__ __forceinline__ void store_relaxed(unsigned* p, unsigned v) {
#ifdef PPP_HOST_MOCK
  __atomic_store_n(p, v, __ATOMIC_RELAXED);
#else
  *reinterpret_cast<volatile unsigned*>(p) = v;
#endif
}

// L <= 32 bits of a candidate's mask words from bit `pos` on.
__device__ __forceinline__ unsigned mask_bits(const unsigned* words, int pos,
                                              int L) {
  const int w = pos >> 5;
  return __funnelshift_r(words[w], words[w + 1], (unsigned)(pos & 31)) &
         low_mask(L);
}

// L <= 32 bits of the running words from bit `pos` on.
__device__ __forceinline__ unsigned run_bits(const unsigned* run,
                                             long long pos, int L) {
  const long long w = pos >> 5;
  return __funnelshift_r(load_relaxed(run + w), load_relaxed(run + w + 1),
                         (unsigned)(pos & 31)) &
         low_mask(L);
}

// sums and maxima over the 32 lanes of a warp (sm_80's redux.sync), every
// lane gets the result
__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(v >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, (unsigned)(v >> 32) == hi ? (unsigned)v : 0u);
  return ((unsigned long long)hi << 32) | lo;
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

// Lane l takes items l, l + 32, ... of a window; the first kTab items of
// every window are described by one table a block keeps in shared memory
// (init_items), so that a window costs its base voxel and table reads.
constexpr int kKeep = 4;
constexpr int kTab = 32 * kKeep;

// Item k's table entry: x the offset of its first padded voxel from the
// window's first one (center c at padded voxel c, the window's corner),
// y its first patch pixel << 6 | its length (0 past the last item), z
// dz << 16 | dy, w its first x in the patch.
__device__ __forceinline__ void init_items(const Geom& g, int4* tab) {
  for (int k = threadIdx.x; k < kTab; k += blockDim.x) {
    int4 t = make_int4(0, 0, 0, 0);
    if (k < g.items) {
      const int row = k / g.segs;
      const int x0 = (k - row * g.segs) * 32;
      const int dz = row / g.py, dy = row - dz * g.py;
      t.x = (dz * g.PY + dy) * g.PX + x0;
      t.y = ((row * g.px + x0) << 6) | min(32, g.px - x0);
      t.z = (dz << 16) | dy;
      t.w = x0;
    }
    tab[k] = t;
  }
}

__device__ __forceinline__ long long window_base(const Geom& g,
                                                 const int* c) {
  return ((long long)c[0] * g.PY + c[1]) * g.PX + c[2];
}

// The item of table entry t in the window at `c` (for inner_bits).
__device__ __forceinline__ Item tab_item(const int* c, long long base,
                                         int4 t) {
  Item it;
  it.pos = base + t.x;
  it.q0 = t.y >> 6;
  it.L = t.y & 63;
  it.z = c[0] + (t.z >> 16);
  it.y = c[1] + (t.z & 0xffff);
  it.x = c[2] + t.w;
  return it;
}

// Still-uncovered pixels of candidate `pm`'s window at center `c`; called
// by all 32 lanes of a warp, every lane gets the count.
__device__ __forceinline__ int warp_count(const Geom& g, const int4* tab,
                                          const unsigned* pm,
                                          const unsigned* run, const int* c) {
  const int lane = threadIdx.x & 31;
  const long long base = window_base(g, c);
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    if (32 * j >= g.items) break;
    const int4 t = tab[lane + 32 * j];
    const int L = t.y & 63;
    if (L != 0)
      cnt += __popc(mask_bits(pm, t.y >> 6, L) & run_bits(run, base + t.x, L));
  }
  for (int k = lane + kTab; k < g.items; k += 32) {
    const Item it = window_item(g, c, k);
    cnt += __popc(mask_bits(pm, it.q0, it.L) & run_bits(run, it.pos, it.L));
  }
  return warp_sum(cnt);
}

// Clear the bits `nw` of an item at padded voxel `pos` from `run`.  Items
// of neighbouring rows may share a running word, so the clears are atomic.
__device__ __forceinline__ void clear_bits(unsigned* run, long long pos,
                                           unsigned nw) {
  const long long w = pos >> 5;
  const unsigned s = (unsigned)(pos & 31);
  atomicAnd(run + w, ~(nw << s));
  if (s != 0u && (nw >> (32u - s)) != 0u)
    atomicAnd(run + w + 1, ~(nw >> (32u - s)));
}

// Visit candidate `pm` at `c`, all 32 lanes of one warp, the only warp
// that clears bits of `run`: count its still-uncovered pixels and, if
// they are more than `th`, clear them.  Returns the interior pixels
// cleared (every lane), or -1 if the window was not taken.  A lane keeps
// the newly covered bits of its table items from the count, so that a
// take reads no word twice; items past the table (windows of more than
// kTab items) are read again, and read the same bits, since the items of
// one window are disjoint and no one else clears them.
__device__ __forceinline__ int warp_visit(const Geom& g, const int4* tab,
                                          const unsigned* pm, unsigned* run,
                                          const int* c, int th) {
  const int lane = threadIdx.x & 31;
  const long long base = window_base(g, c);
  unsigned keep[kKeep] = {};
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    if (32 * j >= g.items) break;
    const int4 t = tab[lane + 32 * j];
    const int L = t.y & 63;
    if (L != 0) {
      keep[j] = mask_bits(pm, t.y >> 6, L) & run_bits(run, base + t.x, L);
      cnt += __popc(keep[j]);
    }
  }
  for (int k = lane + kTab; k < g.items; k += 32) {
    const Item it = window_item(g, c, k);
    cnt += __popc(mask_bits(pm, it.q0, it.L) & run_bits(run, it.pos, it.L));
  }
  if (warp_sum(cnt) <= th) return -1;
  int dec = 0;
#pragma unroll
  for (int j = 0; j < kKeep; ++j) {
    if (keep[j] != 0u) {
      const Item it = tab_item(c, base, tab[lane + 32 * j]);
      dec += __popc(keep[j] & inner_bits(g, it));
      clear_bits(run, it.pos, keep[j]);
    }
  }
  for (int k = lane + kTab; k < g.items; k += 32) {
    const Item it = window_item(g, c, k);
    const unsigned nw =
        mask_bits(pm, it.q0, it.L) & run_bits(run, it.pos, it.L);
    if (nw == 0u) continue;
    dec += __popc(nw & inner_bits(g, it));
    clear_bits(run, it.pos, nw);
  }
  __syncwarp();
  return warp_sum(dec);
}

// Hopper's mbarrier and bulk asynchronous copy (cp.async.bulk, no tensor
// map), on a 64-bit barrier word in shared memory.  Under PPP_HOST_MOCK
// the mock's barrier and a plain copy (tests/cuda_mock/cuda_runtime.h).
#ifdef PPP_HOST_MOCK
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  ppp_mock::mbar_init(bar, count);
}
__device__ __forceinline__ void mbar_fence_init() {}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  ppp_mock::mbar_arrive(bar, 0);
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  ppp_mock::mbar_wait(bar, parity);
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  ppp_mock::mbar_arrive(bar, bytes);
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  ppp_mock::bulk_copy(dst, src, bytes, bar);
}
#else
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// `count` arrivals complete a phase (one thread)
__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// after the inits, before any other thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// one arrival, with release semantics
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// until the phase of parity `parity` has completed (acquire)
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned ok = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!ok);
}
// One arrival on `bar` that also expects `bytes` of bulk copies to land
// in this phase before it completes.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into shared memory, counted as landed on `bar` when they have.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
#endif

// Rows [s, e) of `width` bytes each, widened to 16-byte bounds [lo, hi)
// in bytes from the array's start (whose allocation reaches hi): a bulk
// copy of them puts row s at byte (s width - lo) of the copy.
struct RowSpan {
  long long lo, hi;
};
__host__ __device__ __forceinline__ RowSpan row_span(int s, int e,
                                                     int width) {
  RowSpan r;
  r.lo = (long long)s * width / 16 * 16;
  r.hi = ((long long)e * width + 15) / 16 * 16;
  return r;
}

// One thread: rows [s, e) of `src` into `dst`, their bytes expected on
// `bar` by the caller.  Returns row s in `dst`.
__device__ __forceinline__ const void* copy_rows(void* dst, const void* src,
                                                 int s, int e, int width,
                                                 unsigned long long* bar) {
  const RowSpan r = row_span(s, e, width);
  bulk_copy(dst, static_cast<const unsigned char*>(src) + r.lo,
            (unsigned)(r.hi - r.lo), bar);
  return static_cast<unsigned char*>(dst) + ((long long)s * width - r.lo);
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
  if (reinterpret_cast<uintptr_t>(pm) % 16 != 0) return cudaErrorInvalidValue;
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
