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
// integer count).  For each pixel threshold th (>= 0) in order, for each i
// in order: i is taken iff it is not selected, not on an overlap row, its
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
// The candidates go in chunks (`chunk` of them, across all sweeps one
// sequence of chunks), and the warps split into two roles:
// - warps 1 .. N-1 bound chunk k + 1 while warp 0 walks chunk k: each
//   counts its share of the chunk's windows on the running bits as they
//   stand (overlap rows get -1).  Bits only ever clear, so a count read at
//   any time before a visit, even part-way through a take, bounds the
//   count at the visit from above; and a selected candidate's window has
//   no still-uncovered pixel left, so it is never above th again;
// - warp 0 walks chunk k in order: a ballot finds the candidates whose
//   bound is above th, and each of them is visited in order with an exact
//   count, and taken in the same pass if it still covers more than th
//   (cover_window.cuh's warp_visit); it alone clears running bits, and
//   the bounding warps read them with relaxed loads.
// The bounds are double-buffered, and so are the chunk's rows of masks,
// centers and overlap flags, which are contiguous: where they fit in
// shared memory (2 x 25 KB at 25 x 25), warp 0 brings them in with bulk
// asynchronous copies, chunk k + 2's as soon as it has walked chunk k.
// Each buffer's hand-off is an mbarrier: `full` (the bounding warps
// arrive), `empty` (warp 0 arrives after its walk), `masks` (the copies'
// bytes).  A window's items come
// from a table of their offsets built once (cover_window.cuh).  No
// block barrier runs inside the loop.  Once rem is 0 warp 0 raises `done`
// and stops; the bounding warps stop at their next chunk.  Integer counts
// make the result independent of any summation order.

#include <cuda_runtime.h>

#include "cover_window.cuh"

namespace {

using ppp_cover::Geom;

// stats[] after a launch (int32; kStatRem from the pack pass)
constexpr int kStatVisits = 1;    // exact counts in the walks
constexpr int kStatTakes = 2;
constexpr int kStatBounds = 3;    // windows the bounding warps counted
constexpr int kStatSweeps = 4;    // thresholds entered
constexpr int kMaxThresholds = 8;
// cycle slots: the loop kernel and its staging (thread 0); bounding and
// waiting for the walk or the masks (thread 32, the first bounding warp's
// lane 0); walking and waiting for bounds (thread 0); the output pass
enum { kCyTotal, kCySetup, kCyBound, kCyBoundWait, kCyWalk, kCyWalkWait,
       kCyOutput };

struct Thresholds {
  int n;
  int v[kMaxThresholds];
};

// Shared memory: 6 mbarriers (full, empty, masks; two of each), 4 ints
// (done, windows bounded), the window items' table, the two bound
// buffers; then, where staged, the two chunk buffers and the running
// words, each from a 16-byte boundary.
constexpr size_t kTabOff = 64;
constexpr size_t kBoundOff = kTabOff + ppp_cover::kTab * 16;

__host__ __device__ inline size_t smem_base(int chunk) {
  return ppp_cover::round16(kBoundOff + 2 * (size_t)chunk * 4);
}

// A chunk buffer: the chunk's mask rows, centers and overlap rows, each
// widened to 16-byte bounds.
__host__ __device__ inline size_t masks_part(const Geom& g, int chunk) {
  return ppp_cover::round16((size_t)chunk * g.Wp * 4 + 32);
}
__host__ __device__ inline size_t centers_part(int chunk) {
  return ppp_cover::round16((size_t)chunk * 12 + 32);
}
__host__ __device__ inline size_t chunk_buffer_bytes(const Geom& g,
                                                     int chunk) {
  return masks_part(g, chunk) + centers_part(chunk) +
         ppp_cover::round16((size_t)chunk + 32);
}

// Where the block reads chunk rows from: mask rows, centers, overlap rows.
struct Rows {
  const unsigned* pm;
  const int* cen;
  const unsigned char* ovl;
};

__global__ void __launch_bounds__(1024)
    cover_cascade_kernel(Geom g, int n, const int* __restrict__ centers,
                         const unsigned char* __restrict__ overlap_rows,
                         const unsigned* __restrict__ pm, unsigned* g_run,
                         Thresholds ths, int chunk, int stage_run,
                         int stage_chunks, int* stats,
                         unsigned char* selected,
                         unsigned char* __restrict__ running) {
  extern __shared__ uint4 smem_raw[];  // 16-byte aligned
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_raw);
  const long long t_start = clock64();
  unsigned long long* full = reinterpret_cast<unsigned long long*>(sm);
  unsigned long long* empty = full + 2;
  unsigned long long* masks = full + 4;
  unsigned* s_done = reinterpret_cast<unsigned*>(full + 6);
  int* s_bounds = reinterpret_cast<int*>(s_done + 1);
  int4* tab = reinterpret_cast<int4*>(sm + kTabOff);
  int* bound = reinterpret_cast<int*>(sm + kBoundOff);
  unsigned char* bufs = sm + smem_base(chunk);
  const size_t buf_bytes = chunk_buffer_bytes(g, chunk);
  const size_t mb = masks_part(g, chunk), cb = centers_part(chunk);
  unsigned* run =
      stage_run ? reinterpret_cast<unsigned*>(
                      bufs + (stage_chunks ? 2 * buf_bytes : 0))
                : g_run;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = (blockDim.x >> 5) - 1;  // bounding warps
  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      ppp_cover::mbar_init(full + b, nb);
      ppp_cover::mbar_init(empty + b, 1);
      ppp_cover::mbar_init(masks + b, 1);
    }
    ppp_cover::mbar_fence_init();
    *s_done = 0u;
    *s_bounds = 0;
  }
  ppp_cover::init_items(g, tab);
  if (stage_run)
    for (long long w = tid; w < g.nwords; w += blockDim.x) run[w] = g_run[w];
  for (int j = tid; j < n; j += blockDim.x) selected[j] = 0;
  __syncthreads();
  long long cyc[ppp_cover::kCycleSlots] = {0, 0, 0, 0, 0, 0, 0, 0};
  cyc[kCySetup] = clock64() - t_start;
  int rem = stats[ppp_cover::kStatRem];
  const int nchunks = (n + chunk - 1) / chunk;
  const int G = rem > 0 ? ths.n * nchunks : 0;  // chunks in all sweeps
  // chunk k's rows [s, e): in its buffer (k & 1) where staged
  auto rows_of = [&](int k, int s, int e) -> Rows {
    if (!stage_chunks)
      return {pm + (long long)s * g.Wp, centers + 3 * s, overlap_rows + s};
    const unsigned char* buf = bufs + (k & 1) * buf_bytes;
    const int wb = g.Wp * 4;
    return {reinterpret_cast<const unsigned*>(
                buf + ((long long)s * wb - ppp_cover::row_span(s, e, wb).lo)),
            reinterpret_cast<const int*>(
                buf + mb + (12ll * s - ppp_cover::row_span(s, e, 12).lo)),
            buf + mb + cb + (s - ppp_cover::row_span(s, e, 1).lo)};
  };
  // one thread: chunk k's rows into its buffer, their bytes expected on
  // the buffer's `masks` barrier
  auto issue = [&](int k) {
    const int s = (k % nchunks) * chunk, e = min(n, s + chunk);
    const int wb = g.Wp * 4;
    const ppp_cover::RowSpan rm = ppp_cover::row_span(s, e, wb),
                             rc = ppp_cover::row_span(s, e, 12),
                             ro = ppp_cover::row_span(s, e, 1);
    unsigned char* buf = bufs + (k & 1) * buf_bytes;
    unsigned long long* bar = masks + (k & 1);
    ppp_cover::mbar_expect(
        bar, (unsigned)(rm.hi - rm.lo + rc.hi - rc.lo + ro.hi - ro.lo));
    ppp_cover::copy_rows(buf, pm, s, e, wb, bar);
    ppp_cover::copy_rows(buf + mb, centers, s, e, 12, bar);
    ppp_cover::copy_rows(buf + mb + cb, overlap_rows, s, e, 1, bar);
  };
  if (warp > 0) {
    // bounding warps
    int counted = 0;
    for (int k = 0; k < G; ++k) {
      const int b = k & 1;
      const unsigned use = (unsigned)(k >> 1);
      const long long t0 = clock64();
      if (k >= 2) ppp_cover::mbar_wait(empty + b, (use - 1) & 1);
      // one decision for the whole warp: its lanes leave the wait above
      // one by one and may read the flag on either side of its store.
      // Warps may decide at different chunks; none waits on another.  A
      // warp that has not seen the flag reaches at most chunk K + 2 (K the
      // walk's last chunk), whose wait above acquires it.
      if (__reduce_max_sync(0xffffffffu, ppp_cover::load_relaxed(s_done)))
        break;
      const int s = (k % nchunks) * chunk, e = min(n, s + chunk);
      if (stage_chunks) ppp_cover::mbar_wait(masks + b, use & 1);
      const long long t1 = clock64();
      cyc[kCyBoundWait] += t1 - t0;
      const Rows r = rows_of(k, s, e);
      for (int i = warp - 1; i < e - s; i += nb) {
        int c = -1;
        if (!r.ovl[i]) {
          c = ppp_cover::warp_count(g, tab, r.pm + (long long)i * g.Wp, run,
                                    r.cen + 3 * i);
          ++counted;
        }
        if (lane == 0) bound[b * chunk + i] = c;
      }
      __syncwarp();
      if (lane == 0) ppp_cover::mbar_arrive(full + b);
      cyc[kCyBound] += clock64() - t1;
    }
    if (lane == 0) atomicAdd(s_bounds, counted);
  } else {
    // warp 0: the walk.  It issues the chunks' copies: the first two here,
    // chunk k + 2 once it has walked chunk k (the bounding warps are done
    // with that buffer too: they arrived on `full` for chunk k), so that
    // every chunk up to K + 1 has its rows.
    int visits = 0, takes = 0, sweeps = 0;
    if (stage_chunks && lane == 0)
      for (int k = 0; k < min(2, G); ++k) issue(k);
    for (int k = 0; k < G; ++k) {
      const int b = k & 1;
      const unsigned use = (unsigned)(k >> 1);
      const int t = k / nchunks;
      const int s = (k - t * nchunks) * chunk, e = min(n, s + chunk);
      const int th = ths.v[t];
      sweeps += s == 0;
      const long long t0 = clock64();
      ppp_cover::mbar_wait(full + b, use & 1);
      if (stage_chunks) ppp_cover::mbar_wait(masks + b, use & 1);
      const long long t1 = clock64();
      cyc[kCyWalkWait] += t1 - t0;
      const Rows r = rows_of(k, s, e);
      for (int base = 0; base < e - s && rem > 0; base += 32) {
        const int v = base + lane < e - s ? bound[b * chunk + base + lane]
                                          : -1;
        unsigned todo = __ballot_sync(0xffffffffu, v > th);
        while (todo != 0u && rem > 0) {
          const int i = base + __ffs(todo) - 1;
          todo &= todo - 1u;
          ++visits;
          const int dec = ppp_cover::warp_visit(
              g, tab, r.pm + (long long)i * g.Wp, run, r.cen + 3 * i, th);
          if (dec < 0) continue;
          rem -= dec;
          ++takes;
          if (lane == 0) selected[s + i] = 1;
        }
      }
      __syncwarp();
      if (lane == 0) {
        if (rem <= 0)
          ppp_cover::store_relaxed(s_done, 1u);
        else if (stage_chunks && k + 2 < G)
          issue(k + 2);
        ppp_cover::mbar_arrive(empty + b);
      }
      cyc[kCyWalk] += clock64() - t1;
      if (rem <= 0) break;
    }
    if (tid == 0) {
      stats[kStatVisits] = visits;
      stats[kStatTakes] = takes;
      stats[kStatSweeps] = sweeps;
    }
  }
  __syncthreads();
  // the still-uncovered volume, unpadded
  const long long t_out = clock64();
  const long long V = (long long)g.Z * g.Y * g.X;
  for (long long v = tid; v < V; v += blockDim.x) {
    const int x = (int)(v % g.X);
    const long long zy = v / g.X;
    const int y = (int)(zy % g.Y), z = (int)(zy / g.Y);
    const long long p =
        ((long long)(z + g.rz) * g.PY + y + g.ry) * g.PX + x + g.rx;
    running[v] = (unsigned char)((run[p >> 5] >> (p & 31)) & 1u);
  }
  long long* out = ppp_cover::cycle_slots(stats);
  if (tid == 32) {
    out[kCyBound] = cyc[kCyBound];
    out[kCyBoundWait] = cyc[kCyBoundWait];
  }
  if (tid == 0) {
    stats[kStatBounds] = *s_bounds;
    out[kCySetup] = cyc[kCySetup];
    out[kCyWalk] = cyc[kCyWalk];
    out[kCyWalkWait] = cyc[kCyWalkWait];
    const long long t_end = clock64();
    out[kCyOutput] = t_end - t_out;
    out[kCyTotal] = t_end - t_start;
  }
}

}  // namespace

// Candidates in ranked order: affs (P, Z, Y, X) float32, centers (n, 3)
// int32, overlap_rows (n) uint8, mask (Z, Y, X) uint8 (centers and overlap
// rows 16-byte aligned, their allocations rounded up to 16 bytes); patch
// (pz, py, px);
// the pixel thresholds ths[0 .. n_ths) (host memory, at most 8, each >= 0),
// chunk the candidates bounded at once (1 .. 4096).  Scratch the caller
// allocates: pm (n * (ceil(P / 32) + 1) rounded up to a multiple of 4,
// 16-byte aligned) and run (ceil(padded voxels / 32) + 1) uint32.
// Outputs: stats (ppp_cover::kStats int32: interior pixels to cover,
// visits, takes, windows bounded, sweeps; then the cycles by phase),
// selected (n) uint8 and running (Z, Y, X) uint8, the pixels still
// uncovered.  threads: the block's size, a multiple of 32 from 64 up to
// 1024 (one walking warp, the others bound); smem_cap: the most shared
// memory the block may stage in (the device's limit where larger).
// Launches on `stream`; returns the CUDA error code.
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
      n_ths > kMaxThresholds || chunk < 1 || chunk > 4096 || threads < 64 ||
      threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(centers) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(overlap_rows) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Thresholds t;
  t.n = n_ths;
  for (int k = 0; k < kMaxThresholds; ++k) {
    t.v[k] = k < n_ths ? ths[k] : 0;
    if (t.v[k] < 0) return (int)cudaErrorInvalidValue;
  }
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
  const size_t bufs_bytes = 2 * chunk_buffer_bytes(g, chunk);
  size_t smem = smem_base(chunk);
  const int stage_run = smem + run_bytes <= cap;
  smem += stage_run ? run_bytes : 0;
  const int stage_chunks = smem + bufs_bytes <= cap;
  smem += stage_chunks ? bufs_bytes : 0;
  e = ppp_cover::opt_in(cover_cascade_kernel, smem, limit);
  if (e != cudaSuccess) return (int)e;
  cover_cascade_kernel<<<1, threads, smem, s>>>(
      g, n, centers, overlap_rows, pm, run, t, chunk, stage_run,
      stage_chunks, stats, selected, running);
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_cover_cascade_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
