// Ranked-order greedy foreground cover for dense data, the whole cascade in
// one persistent thread block (kernel K5).
//
// Replaces the JAX package's device loop patchperpix_tpu/ops/cover.py::
// _greedy_cover_volume (cover.py:30: a lax.scan over the pixel thresholds
// of lax.fori_loops over the candidates).  Plain version: ops/cover.py::
// _greedy_cover_cascade (a host loop over the same masks).
//
// Function.  Candidates i in [0, n) in ranked order with centers c_i, their
// fc-thresholded patch masks, overlap rows, and the rad-padded mask to
// cover (cover_window.cuh); rem = the interior pixels to cover (an exact
// integer count).  For each pixel threshold th in order, for each i in
// order: i is taken iff it is not selected, not on an overlap row, its
// window covers more than th still-uncovered pixels and rem > 0; a take
// clears those pixels from the running volume, lowers rem by those in the
// interior and selects i.  Outputs: selected (n) and the still-uncovered
// volume, unpadded.
//
// Bound.  The inputs the loop needs are the n affinity columns at the
// candidates (4 P bytes each), the mask to cover, the centers and the
// overlap rows, read once; the outputs are n bytes and the volume: on 2D
// setting (B) (8,215 candidates of 625 pixels, 520 x 696) about 21 MB, some
// 6 microseconds at 3.35 TB/s.  What bounds the loop is its visits, one
// after the other.
//
// Design.  One block, resident for the whole cascade, as the JAX scan is
// one device program.  Two pack passes first (grid launches on the same
// stream): the masks and the running volume as bits.  The running bits
// stay in shared memory where they fit (24 KB for the 3D crop, 49 KB for
// 2D at 520 x 696, 55 KB for a 70^3 block), else in device memory (L2).
// Coverage only falls as the cascade goes on, so a candidate's count at
// the start of a chunk bounds its count at its visit from above: for each
// chunk of candidates, every warp counts its share of the chunk's windows
// at once (selected and overlap rows skipped); then warp 0 walks the chunk
// in order and visits only the candidates whose bound is above th, with an
// exact count, taking each that still covers more than th.  Once rem is 0
// no candidate is taken in any later chunk or sweep, and the loop ends.
// Integer counts make the result independent of any summation order.

#include <cuda_runtime.h>

#include "cover_window.cuh"

namespace {

using ppp_cover::Geom;

// stats[] after a launch (int32; kStatRem from the pack pass)
constexpr int kStatVisits = 1;    // exact counts in the walks
constexpr int kStatTakes = 2;
constexpr int kStatBounds = 3;    // windows counted at chunk starts
constexpr int kStatSweeps = 4;    // thresholds entered
constexpr int kMaxThresholds = 8;

struct Thresholds {
  int n;
  int v[kMaxThresholds];
};

// Shared memory: 8 ints, the chunk's bounds, then the running words where
// they are staged.
inline size_t smem_base(int chunk) { return (size_t)(8 + chunk) * sizeof(int); }

__global__ void __launch_bounds__(1024)
    cover_cascade_kernel(Geom g, int n, const int* __restrict__ centers,
                         const unsigned char* __restrict__ overlap_rows,
                         const unsigned* __restrict__ pm, unsigned* g_run,
                         Thresholds ths, int chunk, int stage_run, int* stats,
                         unsigned char* selected,
                         unsigned char* __restrict__ running) {
  extern __shared__ int smem_i[];
  int* s_rem = smem_i;
  int* bound = smem_i + 8;
  unsigned* run =
      stage_run ? reinterpret_cast<unsigned*>(bound + chunk) : g_run;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  if (stage_run)
    for (long long w = tid; w < g.nwords; w += blockDim.x) run[w] = g_run[w];
  for (int j = tid; j < n; j += blockDim.x) selected[j] = 0;
  __syncthreads();
  int rem = stats[ppp_cover::kStatRem];
  int visits = 0, takes = 0, bounds = 0, sweeps = 0;
  for (int t = 0; t < ths.n && rem > 0; ++t) {
    const int th = ths.v[t];
    ++sweeps;
    for (int s = 0; s < n && rem > 0; s += chunk) {
      const int e = min(n, s + chunk);
      for (int i = s + warp; i < e; i += nwarps) {
        int c = -1;
        if (!selected[i] && !overlap_rows[i])
          c = ppp_cover::warp_count(g, pm + (long long)i * g.Wp, run,
                                    centers + 3 * i);
        if (lane == 0) bound[i - s] = c;
      }
      __syncthreads();
      if (warp == 0) {
        for (int i = s; i < e && rem > 0; ++i) {
          const int b = bound[i - s];
          bounds += b >= 0;
          if (b <= th) continue;
          ++visits;
          const unsigned* pmi = pm + (long long)i * g.Wp;
          if (ppp_cover::warp_count(g, pmi, run, centers + 3 * i) <= th)
            continue;
          rem -= ppp_cover::warp_take(g, pmi, run, centers + 3 * i);
          ++takes;
          if (lane == 0) selected[i] = 1;
        }
        if (lane == 0) s_rem[0] = rem;
      }
      __syncthreads();
      rem = s_rem[0];
    }
  }
  // the still-uncovered volume, unpadded
  const long long V = (long long)g.Z * g.Y * g.X;
  for (long long v = tid; v < V; v += blockDim.x) {
    const int x = (int)(v % g.X);
    const long long zy = v / g.X;
    const int y = (int)(zy % g.Y), z = (int)(zy / g.Y);
    const long long p =
        ((long long)(z + g.rz) * g.PY + y + g.ry) * g.PX + x + g.rx;
    running[v] = (unsigned char)((run[p >> 5] >> (p & 31)) & 1u);
  }
  if (tid == 0) {
    stats[kStatVisits] = visits;
    stats[kStatTakes] = takes;
    stats[kStatBounds] = bounds;
    stats[kStatSweeps] = sweeps;
  }
}

}  // namespace

// Candidates in ranked order: affs (P, Z, Y, X) float32, centers (n, 3)
// int32, overlap_rows (n) uint8, mask (Z, Y, X) uint8; patch (pz, py, px);
// the pixel thresholds ths[0 .. n_ths) (host memory, at most 8), chunk the
// candidates bounded at once (1 .. 4096).  Scratch the caller allocates: pm
// (n * (ceil(P / 32) + 1)) and run (ceil(padded voxels / 32) + 1) uint32.
// Outputs: stats (8 int32: interior pixels to cover, visits, takes,
// windows bounded, sweeps), selected (n) uint8 and running (Z, Y, X) uint8,
// the pixels still uncovered.  threads: the block's size, a multiple of 32
// up to 1024; smem_cap: the most shared memory the block may stage in (the
// device's limit where larger).  Launches on `stream`; returns the CUDA
// error code.
extern "C" int ppp_cover_cascade(const float* affs, const unsigned char* mask,
                                 const int* centers,
                                 const unsigned char* overlap_rows, int n,
                                 int Z, int Y, int X, int pz, int py, int px,
                                 float fc, const int* ths, int n_ths,
                                 int chunk, int threads, int smem_cap,
                                 unsigned* pm, unsigned* run, int* stats,
                                 unsigned char* selected,
                                 unsigned char* running, void* stream) {
  if (n < 1 || !ppp_cover::geom_ok(Z, Y, X, pz, py, px) || n_ths < 0 ||
      n_ths > kMaxThresholds || chunk < 1 || chunk > 4096 || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  Thresholds t;
  t.n = n_ths;
  for (int k = 0; k < kMaxThresholds; ++k) t.v[k] = k < n_ths ? ths[k] : 0;
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
  const int stage_run = smem_base(chunk) + run_bytes <= cap;
  const size_t smem = smem_base(chunk) + (stage_run ? run_bytes : 0);
  e = ppp_cover::opt_in(cover_cascade_kernel, smem, limit);
  if (e != cudaSuccess) return (int)e;
  cover_cascade_kernel<<<1, threads, smem, s>>>(
      g, n, centers, overlap_rows, pm, run, t, chunk, stage_run, stats,
      selected, running);
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_cover_cascade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
