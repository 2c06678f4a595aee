// Greedy set-cover thinning of the selected patches, the whole loop in one
// persistent thread block (kernel K6).
//
// Replaces the JAX package's device loops
// patchperpix_tpu/ops/cover.py::_thin_cover_volume_lazy (cover.py:144, one
// lax.while_loop; mode 0 here) and its exact full-recompute fallback
// ::_thin_cover_volume (cover.py:238; mode 1), which the JAX package runs
// when the lazy loop reaches its cap.  Plain versions: ops/cover.py::
// _thin_cover_lazy and ::_thin_cover_full (host loops over the same masks).
//
// Function.  Candidates i in [0, n) with centers c_i, their fc-thresholded
// patch masks and the rad-padded mask to cover (cover_window.cuh).  The
// selection is that of the greedy loop: while picks < n, rem (interior
// pixels still to cover) > 0 and the last pick's size was above 0, pick
// the first index of the largest size |mask_i & window_i(running)|, select
// it, and if its size is above 0 clear its newly covered pixels from the
// running volume and lower rem by those in the interior.
//
// Mode 0, the lazy loop, in rounds.  sizes[i] are upper bounds of the true
// sizes (counted at the start, exact where not stale; a pick marks every
// other center within |dc| < ps on every axis stale, and sets its own size
// to 0).  Keys order the entries: size << 32 | ~index (larger size, then
// smaller index).  Each round: b = the largest key among the fresh
// entries, S = the stale entries whose key is above key(b).  If S is
// empty, b is picked: its key is at least every other entry's, stale or
// not, so b is the first index of the largest true size, ties included.
// Else the sizes in S are counted anew (S up to kList entries at once; any
// left over stay stale and come back in the next round), and the round
// ends.  While rounds < max_it; capped = rounds >= max_it, and the wrapper
// then launches mode 1, the full loop: each round every size is counted
// anew and their largest key picked.
//
// Bound.  The inputs that the loop needs are the n affinity columns at the
// centers (4 P bytes each), the mask to cover and the centers; read once,
// they take about a microsecond at 3.35 TB/s on the 3D main path (2,484 x
// 343 columns).  What bounds the loop is its rounds, each a reduction over
// n keys and a few windows, one after the other, on one SM.
//
// Design.  One block, resident for the whole loop, as the JAX loop is one
// device program: no host round trip per step.  Two pack passes first
// (grid launches on the same stream): the masks and the running volume as
// bits (cover_window.cuh).  The block then stages in shared memory, as far
// as they fit, in this order: the running bits (24 KB on the 3D path), the
// entries (a center packed in one word, and a state word of size and
// stale flag: 30 KB), and the masks (119 KB), these by
// one bulk asynchronous copy that completes on an mbarrier; what does not
// fit is used in device memory (L2), so that the kernel takes any shape
// the host loop takes.  The threads of warps 1 .. N-1 own the entries, one
// in every blockDim - 32: an owner keeps their stale flags and computes
// the largest fresh and the largest stale key among them; warp shuffles
// and one block barrier give every thread the block's two maxima.  A pick
// round is one such reduction: warp 0 takes b (one pass:
// cover_window.cuh's warp_visit) while the owners mark their entries near
// b stale and reduce their keys as they now stand.  A refresh round puts S
// into a shared list (atomicAdd on its length) and the warps count one
// window each at once, one item a lane; when all of S fit in the list, the
// next round's b is the largest of the old b and the refreshed keys (every
// entry still stale lies below the old b), one reduction of the warps'
// refreshed keys.  Window items come from a table of their offsets built
// once (cover_window.cuh).  Everything is an integer, so the result does
// not depend on the order of any sum.

#include <cuda_runtime.h>

#include "cover_window.cuh"

namespace {

using ppp_cover::Geom;

// stats[] after a launch (int32; kStatRem from the pack pass)
constexpr int kStatRounds = 1;
constexpr int kStatPicks = 2;
constexpr int kStatRefreshes = 3;  // windows counted anew in the loop
constexpr int kStatCapped = 4;
// cycle slots (thread 0): the loop kernel, staging and first counts, the
// key maxima after a refresh (mode 1: after the counts), refresh rounds'
// counts (mode 1: every size counted anew), pick rounds (take, stale marks
// and the key maxima), and of those the take; thread 32 (the first owner):
// its stale marks and key maxima in the pick rounds, up to the reduction
enum { kCyTotal, kCySetup, kCyArgmax, kCyRefresh, kCyPick, kCyTake,
       kCyMark };

// The refresh list: the most entries of S counted in one round.
#ifndef PPP_THIN_LIST
#define PPP_THIN_LIST 1024
#endif
constexpr int kList = PPP_THIN_LIST;

// Shared memory: two sets (used in turn) of 32 warp maxima of the fresh
// keys and 32 of the stale ones, the mbarrier, 4 ints (the refresh list's
// length, two slots for the interior pixels a take cleared), the window
// items' table, the refresh list; then, where staged, the masks, the
// running words and the arrays (packed centers, state words), each from a
// 16-byte boundary.
constexpr size_t kBarOff = 2 * 64 * 8;
constexpr size_t kIntOff = kBarOff + 8;
constexpr size_t kTabOff = kIntOff + 4 * 4 + 8;
constexpr size_t kListOff = kTabOff + ppp_cover::kTab * 16;
constexpr size_t kSmemBase = ppp_cover::round16(kListOff + kList * 4);

// The arrays: a packed center and a state word an entry.
inline size_t arrays_bytes(int n) { return ppp_cover::round16((size_t)n * 12); }

// An entry's state word: its size (bits 0-30) and its stale flag (bit 31).
constexpr unsigned kStale = 1u << 31;

__device__ __forceinline__ unsigned long long key_of(unsigned state, int j) {
  return ((unsigned long long)(state & ~kStale) << 32) |
         (unsigned long long)(0xffffffffu - (unsigned)j);
}

// A center as one word, 21 bits an axis (z, y, x), so that a pick's stale
// marks read an entry in two loads.
__device__ __forceinline__ unsigned long long pack_center(const int* c) {
  return ((unsigned long long)c[0] << 42) | ((unsigned long long)c[1] << 21) |
         (unsigned long long)c[2];
}

__device__ __forceinline__ void unpack_center(unsigned long long v, int* c) {
  c[0] = (int)(v >> 42);
  c[1] = (int)((v >> 21) & 0x1fffffu);
  c[2] = (int)(v & 0x1fffffu);
}

// A block-wide maximum of a fresh and a stale key: each warp reduces its
// lanes' (f, s) into set `r` (32 fresh, then 32 stale slots), one block
// barrier, then every warp reduces the set, so that every thread gets
// (kf, ks).  The callers use the two sets in turn: a thread writes a set
// again only after the barrier of the next reduction, which every thread
// reaches after it has read this one.
__device__ __forceinline__ void block_max(unsigned long long f,
                                          unsigned long long s,
                                          unsigned long long* r,
                                          unsigned long long& kf,
                                          unsigned long long& ks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  f = ppp_cover::warp_max(f);
  s = ppp_cover::warp_max(s);
  if (lane == 0) {
    r[warp] = f;
    r[32 + warp] = s;
  }
  __syncthreads();
  const bool live = lane < (int)(blockDim.x >> 5);
  kf = ppp_cover::warp_max(live ? r[lane] : 0ull);
  ks = ppp_cover::warp_max(live ? r[32 + lane] : 0ull);
}

// The entries j a thread owns: j = t - 32 mod (blockDim - 32) for the
// threads t of warps 1 .. N-1; warp 0, which takes the picks, owns none.
__device__ __forceinline__ int first_owned(int n) {
  return threadIdx.x >= 32 ? (int)threadIdx.x - 32 : n;
}
__device__ __forceinline__ int owners() { return (int)blockDim.x - 32; }

// The largest fresh and stale keys of the entries a thread owns.
__device__ __forceinline__ void own_keys(int n, const unsigned* state,
                                         unsigned long long& f,
                                         unsigned long long& s) {
  f = s = 0ull;
  for (int j = first_owned(n); j < n; j += owners()) {
    const unsigned st = state[j];
    const unsigned long long k = key_of(st, j);
    if (st & kStale)
      s = k > s ? k : s;
    else
      f = k > f ? k : f;
  }
}

// Still-uncovered pixels of entry i's window (all lanes of a warp).
__device__ __forceinline__ int count_entry(const Geom& g, const int4* tab,
                                           const unsigned* pm,
                                           const unsigned* run,
                                           const unsigned long long* cpk,
                                           int i) {
  int c[3];
  unpack_center(cpk[i], c);
  return ppp_cover::warp_count(g, tab, pm + (long long)i * g.Wp, run, c);
}

__global__ void __launch_bounds__(1024)
    thin_cover_kernel(Geom g, int n, const int* __restrict__ centers,
                      const unsigned* __restrict__ g_pm, unsigned* g_run,
                      unsigned* g_state, unsigned long long* g_cpk, int mode,
                      int max_it, int stage_run, int stage_arrays,
                      int stage_masks, int* stats,
                      unsigned char* selected) {
  extern __shared__ uint4 smem_raw[];  // 16-byte aligned
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_raw);
  const long long t_start = clock64();
  unsigned long long* red = reinterpret_cast<unsigned long long*>(sm);
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(sm + kBarOff);
  // slot 1 the refresh list's length; slots 2, 3 a take's interior pixels
  // cleared, in turn as the sets of warp maxima
  int* s_int = reinterpret_cast<int*>(sm + kIntOff);
  int4* tab = reinterpret_cast<int4*>(sm + kTabOff);
  int* list = reinterpret_cast<int*>(sm + kListOff);
  unsigned char* next = sm + kSmemBase;
  const unsigned* pm = g_pm;
  unsigned* run = g_run;
  unsigned* state = g_state;
  unsigned long long* cpk = g_cpk;
  const size_t pm_bytes =
      ppp_cover::round16((size_t)n * g.Wp * sizeof(unsigned));
  unsigned* pm_s = nullptr;
  if (stage_masks) {
    pm_s = reinterpret_cast<unsigned*>(next);
    pm = pm_s;
    next += pm_bytes;
  }
  if (stage_run) {
    run = reinterpret_cast<unsigned*>(next);
    next += ppp_cover::round16(g.nwords * sizeof(unsigned));
  }
  if (stage_arrays) {
    cpk = reinterpret_cast<unsigned long long*>(next);
    state = reinterpret_cast<unsigned*>(cpk + n);
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (tid == 0) {
    ppp_cover::mbar_init(bar, 1);
    ppp_cover::mbar_fence_init();
    s_int[1] = 0;
  }
  __syncthreads();
  if (stage_masks && tid == 0) {
    ppp_cover::mbar_expect(bar, (unsigned)pm_bytes);
    ppp_cover::bulk_copy(pm_s, g_pm, (unsigned)pm_bytes, bar);
  }
  ppp_cover::init_items(g, tab);
  if (stage_run)
    for (long long w = tid; w < g.nwords; w += blockDim.x) run[w] = g_run[w];
  for (int j = tid; j < n; j += blockDim.x) {
    cpk[j] = pack_center(centers + 3 * j);
    state[j] = 0u;
    selected[j] = 0;
  }
  __syncthreads();
  if (stage_masks) ppp_cover::mbar_wait(bar, 0);
  long long cyc[ppp_cover::kCycleSlots] = {0, 0, 0, 0, 0, 0, 0, 0};
  int rem = stats[ppp_cover::kStatRem];
  int p = 0;  // the set of warp maxima the next reduction writes
  unsigned long long kf = 0ull, ks = 0ull, f, s;
  if (mode == 0) {
    for (int i = warp; i < n; i += nwarps) {
      const int c = count_entry(g, tab, pm, run, cpk, i);
      if (lane == 0) state[i] = (unsigned)c;
    }
    __syncthreads();
    own_keys(n, state, f, s);
    block_max(f, s, red + 64 * p, kf, ks);
    p ^= 1;
  }
  long long t0 = clock64();
  cyc[kCySetup] = t0 - t_start;
  int rounds = 0, picks = 0, refreshes = 0, done = 0;
  while (!done && picks < n && rem > 0 && (mode == 1 || rounds < max_it)) {
    ++rounds;
    if (mode == 1) {
      for (int i = warp; i < n; i += nwarps) {
        const int c = count_entry(g, tab, pm, run, cpk, i);
        if (lane == 0) state[i] = (unsigned)c;
      }
      refreshes += n;
      __syncthreads();
      const long long t1 = clock64();
      cyc[kCyRefresh] += t1 - t0;
      own_keys(n, state, f, s);
      block_max(f, s, red + 64 * p, kf, ks);
      p ^= 1;
      t0 = clock64();
      cyc[kCyArgmax] += t0 - t1;
    }
    if (ks > kf) {
      // refresh round: S = the stale entries above the best fresh key
      for (int j = first_owned(n); j < n; j += owners()) {
        const unsigned st = state[j];
        if ((st & kStale) && key_of(st, j) > kf) {
          const int slot = atomicAdd(s_int + 1, 1);
          if (slot < kList) list[slot] = j;
        }
      }
      __syncthreads();
      const int cnt = s_int[1], m = min(cnt, kList);
      unsigned long long top = 0ull;  // lane 0: the largest refreshed key
      for (int l = warp; l < m; l += nwarps) {
        const int j = list[l];
        const int c = count_entry(g, tab, pm, run, cpk, j);
        if (lane == 0) {
          state[j] = (unsigned)c;
          const unsigned long long k = key_of((unsigned)c, j);
          top = k > top ? k : top;
        }
      }
      refreshes += m;
      const long long t1 = clock64();
      cyc[kCyRefresh] += t1 - t0;
      // the list's length goes back to 0 after every thread has read it
      // and before the next round's collect
      if (cnt <= kList) {
        // every stale key left is below kf: the next round picks the
        // largest of kf and the refreshed keys
        unsigned long long kt, none;
        block_max(top, 0ull, red + 64 * p, kt, none);
        kf = kt > kf ? kt : kf;
        ks = 0ull;
        if (tid == 0) s_int[1] = 0;
      } else {
        __syncthreads();
        if (tid == 0) s_int[1] = 0;
        own_keys(n, state, f, s);
        block_max(f, s, red + 64 * p, kf, ks);
      }
      p ^= 1;
      t0 = clock64();
      cyc[kCyArgmax] += t0 - t1;
      continue;
    }
    // pick round: b, the first index of the largest true size
    const int best = (int)(0xffffffffu - (unsigned)(kf & 0xffffffffull));
    const int bsize = (int)(kf >> 32);
    if (tid == 0) selected[best] = 1;
    if (bsize > 0) {
      // warp 0 takes b while the owners mark their entries near b stale
      // and reduce their keys as they now stand
      int b[3];
      unpack_center(cpk[best], b);
      if (warp == 0) {
        const long long t1 = clock64();
        const int dec = ppp_cover::warp_visit(
            g, tab, pm + (long long)best * g.Wp, run, b, 0);
        if (lane == 0) s_int[2 + p] = dec;
        cyc[kCyTake] += clock64() - t1;
      }
      const long long t1 = clock64();
      f = s = 0ull;
      for (int j = first_owned(n); j < n; j += owners()) {
        unsigned st = state[j];
        int c[3];
        unpack_center(cpk[j], c);
        if (j == best) {
          st = 0u;
          state[j] = 0u;
        } else if (mode == 0 && !(st & kStale) &&
                   (abs(c[0] - b[0]) < g.pz) & (abs(c[1] - b[1]) < g.py) &
                       (abs(c[2] - b[2]) < g.px)) {
          st |= kStale;
          state[j] = st;
        }
        const unsigned long long k = key_of(st, j);
        if (st & kStale)
          s = k > s ? k : s;
        else
          f = k > f ? k : f;
      }
      cyc[kCyMark] += clock64() - t1;
      block_max(f, s, red + 64 * p, kf, ks);
      rem -= s_int[2 + p];
      p ^= 1;
    }
    ++picks;
    done = bsize <= 0;
    const long long t1 = clock64();
    cyc[kCyPick] += t1 - t0;
    t0 = t1;
  }
  if (tid == 0) {
    stats[kStatRounds] = rounds;
    stats[kStatPicks] = picks;
    stats[kStatRefreshes] = refreshes;
    stats[kStatCapped] = mode == 0 && rounds >= max_it;
    cyc[kCyTotal] = clock64() - t_start;
    long long* out = ppp_cover::cycle_slots(stats);
    for (int k = 0; k < kCyMark; ++k) out[k] = cyc[k];
  }
  if (tid == 32) ppp_cover::cycle_slots(stats)[kCyMark] = cyc[kCyMark];
}

}  // namespace

// Candidates: affs (P, Z, Y, X) float32, centers (n, 3) int32, mask
// (Z, Y, X) uint8, each extent below 2^21; patch (pz, py, px).  mode 0 lazy (stops at max_it
// rounds and sets stats[4]), 1 full.  Scratch the caller allocates: pm
// (n * (ceil(P / 32) + 1) rounded up to a multiple of 4, 16-byte aligned)
// and run (ceil(padded voxels / 32) + 1) uint32, state (n) uint32, cpk (n)
// uint64.  Outputs: stats (ppp_cover::kStats int32: interior pixels to
// cover, rounds, picks, windows refreshed, capped; then the cycles by
// phase) and selected (n) uint8.  threads: the block's size, a multiple of
// 32 from 64 up to 1024; smem_cap: the most shared memory the block may
// stage in (the device's limit where larger).  Launches on `stream`;
// returns the CUDA error code.
extern "C" int ppp_thin_cover(const float* affs, const unsigned char* mask,
                              const int* centers, int n, int Z, int Y, int X,
                              int pz, int py, int px, float fc, int mode,
                              int max_it, int threads, int smem_cap,
                              unsigned* pm, unsigned* run, unsigned* state,
                              unsigned long long* cpk, int* stats,
                              unsigned char* selected, void* stream) {
  if (n < 1 || !ppp_cover::geom_ok(Z, Y, X, pz, py, px) || Z >= (1 << 21) ||
      Y >= (1 << 21) || X >= (1 << 21) || (mode != 0 && mode != 1) ||
      threads < 64 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g = ppp_cover::make_geom(Z, Y, X, pz, py, px);
  cudaError_t e =
      ppp_cover::pack_all(affs, mask, centers, n, g, fc, pm, run, stats, s);
  if (e != cudaSuccess) return (int)e;
  int limit = 0;
  e = ppp_cover::smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t cap = (size_t)(smem_cap < limit ? smem_cap : limit);
  const size_t run_bytes = ppp_cover::round16(g.nwords * sizeof(unsigned));
  const size_t pm_bytes = ppp_cover::round16((size_t)n * g.Wp * 4);
  size_t smem = kSmemBase;
  const int stage_run = smem + run_bytes <= cap;
  smem += stage_run ? run_bytes : 0;
  const int stage_arrays = smem + arrays_bytes(n) <= cap;
  smem += stage_arrays ? arrays_bytes(n) : 0;
  const int stage_masks = smem + pm_bytes <= cap;
  smem += stage_masks ? pm_bytes : 0;
  e = ppp_cover::opt_in(thin_cover_kernel, smem, limit);
  if (e != cudaSuccess) return (int)e;
  thin_cover_kernel<<<1, threads, smem, s>>>(
      g, n, centers, pm, run, state, cpk, mode, max_it, stage_run,
      stage_arrays, stage_masks, stats, selected);
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_thin_cover_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
