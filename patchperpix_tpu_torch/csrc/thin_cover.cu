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
// patch masks and the rad-padded mask to cover (cover_window.cuh).  Mode 0,
// the lazy loop: sizes[i] = |mask_i & window_i(running)| at the start; then,
// while not done, picks < n, rem > 0 and it < max_it (it counted up first):
// best = the first index of the largest size; if best is stale, its size is
// counted again and it is no longer stale; else best is selected (before the
// zero-size stop, as the reference does), and if its size is above 0 its
// newly covered pixels leave the running volume, rem (interior pixels still
// to cover) falls by those in the interior, sizes[best] = 0 and every other
// center within |dc| < ps on every axis turns stale; picks += 1, done = the
// size was 0.  capped = it >= max_it; the wrapper then launches mode 1, the
// full loop: while rem > 0, the last size > 0 and picks < n: every size
// counted anew, best their argmax, selected, taken if above 0.
//
// Bound.  The inputs that the loop needs are the n affinity columns at the
// centers (4 P bytes each), the mask to cover and the centers; read once,
// they take about a microsecond at 3.35 TB/s on the 3D main path (2,484 x
// 343 columns).  What bounds the loop is its iterations: each one is an
// argmax over n sizes and a window, one after the other, on one SM.
//
// Design.  One block, resident for the whole loop, as the JAX loop is one
// device program: no host round trip per step.  Two pack passes first
// (grid launches on the same stream): the masks and the running volume as
// bits (cover_window.cuh).  The block then holds the running bits, sizes,
// centers and stale flags in shared memory where they fit (the 3D path:
// 24 KB of running bits and 43 KB of arrays), else in device memory (the
// running volume first: where it does not fit, it is worked on in place in
// `run`, which L2 holds), so that it takes any shape the host loop takes.
// Each iteration: every thread scans its share of `sizes` for the largest
// key (size << 33 | ~index << 1 | stale: larger size, then smaller index,
// as argmax breaks ties; the flag rides along), a warp shuffle and one
// barrier give the block's best and whether it is stale; warp
// 0 counts (a refresh) or takes (a pick) the window, one item a lane; a
// pick's stale marks are one pass of all threads over the centers.
// Everything is an integer, so the result does not depend on the order of
// any sum.

#include <cuda_runtime.h>

#include "cover_window.cuh"

namespace {

using ppp_cover::Geom;

// stats[] after a launch (int32; kStatRem from the pack pass)
constexpr int kStatIters = 1;
constexpr int kStatPicks = 2;
constexpr int kStatRefreshes = 3;
constexpr int kStatCapped = 4;

// Shared memory: 32 warp keys, 8 ints, then the running words and the
// arrays (sizes, centers, stale) where they are staged.
constexpr size_t kSmemBase = 32 * sizeof(unsigned long long) + 8 * sizeof(int);

inline size_t arrays_bytes(int n) { return (size_t)n * (4 + 12 + 1); }

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  return v;
}

__global__ void __launch_bounds__(1024)
    thin_cover_kernel(Geom g, int n, const int* __restrict__ centers,
                      const unsigned* __restrict__ pm, unsigned* g_run,
                      int* g_sizes, unsigned char* g_stale, int mode,
                      int max_it, int stage_run, int stage_arrays, int* stats,
                      unsigned char* selected) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* red = smem;
  int* s_dec = reinterpret_cast<int*>(smem + 32);
  unsigned char* next = reinterpret_cast<unsigned char*>(s_dec + 8);
  unsigned* run = g_run;
  int* sizes = g_sizes;
  const int* cen = centers;
  unsigned char* stale = g_stale;
  if (stage_run) {
    run = reinterpret_cast<unsigned*>(next);
    next += g.nwords * sizeof(unsigned);
  }
  int* cen_s = nullptr;
  if (stage_arrays) {
    sizes = reinterpret_cast<int*>(next);
    cen_s = sizes + n;
    stale = reinterpret_cast<unsigned char*>(cen_s + 3 * n);
    cen = cen_s;
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (stage_run)
    for (long long w = tid; w < g.nwords; w += blockDim.x) run[w] = g_run[w];
  if (stage_arrays)
    for (int j = tid; j < 3 * n; j += blockDim.x) cen_s[j] = centers[j];
  for (int j = tid; j < n; j += blockDim.x) {
    stale[j] = 0;
    selected[j] = 0;
  }
  __syncthreads();
  int rem = stats[ppp_cover::kStatRem];
  if (mode == 0) {
    for (int i = warp; i < n; i += nwarps) {
      const int c = ppp_cover::warp_count(g, pm + (long long)i * g.Wp, run,
                                          cen + 3 * i);
      if (lane == 0) sizes[i] = c;
    }
    __syncthreads();
  }
  int it = 0, picks = 0, refreshes = 0, done = 0;
  while (!done && picks < n && rem > 0 && (mode == 1 || it < max_it)) {
    ++it;
    if (mode == 1) {
      for (int i = warp; i < n; i += nwarps) {
        const int c = ppp_cover::warp_count(g, pm + (long long)i * g.Wp, run,
                                            cen + 3 * i);
        if (lane == 0) sizes[i] = c;
      }
      __syncthreads();
    }
    // argmax, the first index of the largest size (keys are > 0); the
    // key also carries the entry's stale flag, so that the branch below is
    // taken on what every thread read before anyone writes the flag
    unsigned long long key = 0ull;
    for (int j = tid; j < n; j += blockDim.x) {
      const unsigned long long k =
          ((unsigned long long)(unsigned)sizes[j] << 33) |
          ((unsigned long long)(0xffffffffu - (unsigned)j) << 1) |
          (mode == 0 ? stale[j] : 0u);
      key = k > key ? k : key;
    }
    key = warp_max(key);
    if (lane == 0) red[warp] = key;
    __syncthreads();
    key = 0ull;
    for (int w = 0; w < nwarps; ++w) key = red[w] > key ? red[w] : key;
    const int best =
        (int)(0xffffffffu - (unsigned)((key >> 1) & 0xffffffffull));
    const int bsize = (int)(key >> 33);
    if (key & 1ull) {
      ++refreshes;
      if (warp == 0) {
        const int c = ppp_cover::warp_count(g, pm + (long long)best * g.Wp,
                                            run, cen + 3 * best);
        if (lane == 0) {
          sizes[best] = c;
          stale[best] = 0;
        }
      }
      __syncthreads();
      continue;
    }
    if (tid == 0) selected[best] = 1;
    if (bsize > 0) {
      const int bz = cen[3 * best], by = cen[3 * best + 1],
                bx = cen[3 * best + 2];
      if (warp == 0) {
        const int dec = ppp_cover::warp_take(
            g, pm + (long long)best * g.Wp, run, cen + 3 * best);
        if (lane == 0) {
          s_dec[0] = dec;
          sizes[best] = 0;
        }
      }
      if (mode == 0)
        for (int j = tid; j < n; j += blockDim.x) {
          if (j != best && abs(cen[3 * j] - bz) < g.pz &&
              abs(cen[3 * j + 1] - by) < g.py &&
              abs(cen[3 * j + 2] - bx) < g.px)
            stale[j] = 1;
        }
      __syncthreads();
      rem -= s_dec[0];
    }
    ++picks;
    done = bsize <= 0;
  }
  if (tid == 0) {
    stats[kStatIters] = it;
    stats[kStatPicks] = picks;
    stats[kStatRefreshes] = refreshes;
    stats[kStatCapped] = mode == 0 && it >= max_it;
  }
}

}  // namespace

// Candidates: affs (P, Z, Y, X) float32, centers (n, 3) int32, mask
// (Z, Y, X) uint8; patch (pz, py, px).  mode 0 lazy (stops at max_it
// iterations and sets stats[4]), 1 full.  Scratch the caller allocates: pm
// (n * (ceil(P / 32) + 1)) and run (ceil(padded voxels / 32) + 1) uint32,
// sizes (n) int32, stale (n) uint8.  Outputs: stats (8 int32: interior
// pixels to cover, iterations, picks, refreshes, capped) and selected (n)
// uint8.  threads: the block's size, a multiple of 32 up to 1024;
// smem_cap: the most shared memory the block may stage in (the device's
// limit where larger).  Launches on `stream`; returns the CUDA error code.
extern "C" int ppp_thin_cover(const float* affs, const unsigned char* mask,
                              const int* centers, int n, int Z, int Y, int X,
                              int pz, int py, int px, float fc, int mode,
                              int max_it, int threads, int smem_cap,
                              unsigned* pm, unsigned* run, int* sizes,
                              unsigned char* stale, int* stats,
                              unsigned char* selected, void* stream) {
  if (n < 1 || !ppp_cover::geom_ok(Z, Y, X, pz, py, px) ||
      (mode != 0 && mode != 1) || threads < 32 || threads > 1024 ||
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
  const size_t run_bytes = (size_t)g.nwords * sizeof(unsigned);
  const int stage_run = kSmemBase + run_bytes <= cap;
  const size_t base = kSmemBase + (stage_run ? run_bytes : 0);
  const int stage_arrays = base + arrays_bytes(n) <= cap;
  const size_t smem = base + (stage_arrays ? arrays_bytes(n) : 0);
  e = ppp_cover::opt_in(thin_cover_kernel, smem, limit);
  if (e != cudaSuccess) return (int)e;
  thin_cover_kernel<<<1, threads, smem, s>>>(
      g, n, centers, pm, run, sizes, stale, mode, max_it, stage_run,
      stage_arrays, stats, selected);
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_thin_cover_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
