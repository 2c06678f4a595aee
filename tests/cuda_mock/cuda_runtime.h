// A host stand-in for the parts of the CUDA runtime that the sources under
// patchperpix_tpu_torch/csrc/ use, so that g++ can compile a kernel and a
// test can run it on the CPU at tiny shapes (tests/test_torch_kernel_mock.py).
//
// A launch `kernel<<<grid, block, smem, stream>>>(args)` is rewritten by the
// test to `PPP_MOCK_LAUNCH(grid, block, smem, kernel(args))`, and
// `extern __shared__ T name[];` to a pointer into the launch's dynamic
// shared memory.  The grid runs as loops: one std::thread per CUDA thread of
// a block, the blocks one after the other, __syncthreads as a barrier
// over the block's threads that have not yet returned from the kernel.
// `__shared__` variables are statics, which is right because only one block
// runs at a time.  A warp's shuffles and __syncwarp meet at a barrier over
// the warp's threads, so the lanes of a warp must call them together, as
// on the card.  PPP_HOST_MOCK tells the sources to take plain loads where
// the card's build uses Hopper instructions; the mbarriers and bulk copies
// of csrc/cover_window.cuh come here: an mbarrier as a counter of
// arrivals and bytes with its completed phases, under one mutex and
// condition variable, and a bulk copy as a memcpy that then counts its
// bytes as landed.

#pragma once

#define PPP_HOST_MOCK 1

#include <algorithm>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __shared__ static
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
struct uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
struct alignas(16) float4 {
  float x, y, z, w;
};

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorInvalidDevice = 101
};
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "mock CUDA error";
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return cudaSuccess;
}
template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
// an H100's opt-in limit
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 232448;
  return cudaSuccess;
}

using std::max;
using std::min;
inline int __ffs(unsigned v) { return v ? __builtin_ctz(v) + 1 : 0; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
// one rounding each (the test builds without -ffp-contract=fast on a target
// without FMA, so a * b + c is never fused on the host)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}
// the SM's cycle counter: nanoseconds of the host's steady clock
inline long long clock64() {
  return std::chrono::steady_clock::now().time_since_epoch().count();
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned atomicAnd(unsigned* p, unsigned v) {
  return __atomic_fetch_and(p, v, __ATOMIC_SEQ_CST);
}

namespace ppp_mock {

// A barrier over the threads of the running block that are still inside the
// kernel: a thread that returns leaves the barrier, as a CUDA thread that
// has exited no longer counts for __syncthreads.
struct Block {
  std::mutex m;
  std::condition_variable cv;
  unsigned alive = 0, waiting = 0, generation = 0;
  int vote = 0, result = 0;

  int sync(int pred) {
    std::unique_lock<std::mutex> lk(m);
    vote |= pred;
    if (++waiting == alive) return release();
    const unsigned gen = generation;
    cv.wait(lk, [&] { return gen != generation; });
    return result;
  }
  void leave() {
    std::unique_lock<std::mutex> lk(m);
    --alive;
    if (alive != 0 && waiting == alive) release();
  }
  int release() {  // with the lock held
    result = vote;
    vote = 0;
    waiting = 0;
    ++generation;
    cv.notify_all();
    return result;
  }
};

inline Block block;
inline unsigned char* dyn_smem = nullptr;

// A warp: the same barrier over its threads, and one 8-byte slot a lane
// for the shuffles.
struct Warp {
  Block barrier;
  unsigned long long slot[32];
};
inline std::vector<std::unique_ptr<Warp>> warps;

}  // namespace ppp_mock

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

inline void __syncthreads() { ppp_mock::block.sync(0); }
inline int __syncthreads_or(int pred) {
  return ppp_mock::block.sync(pred != 0);
}

namespace ppp_mock {
inline unsigned thread_rank() {
  return threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z);
}
inline Warp& my_warp() { return *warps[thread_rank() / 32]; }
}  // namespace ppp_mock

inline void __syncwarp(unsigned = 0xffffffffu) {
  ppp_mock::my_warp().barrier.sync(0);
}
// v of lane (this lane ^ lane_mask); every lane of the warp calls it
template <typename T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  ppp_mock::Warp& w = ppp_mock::my_warp();
  const unsigned lane = ppp_mock::thread_rank() % 32;
  unsigned long long bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[lane] = bits;
  w.barrier.sync(0);  // every lane has written
  bits = w.slot[(lane ^ (unsigned)lane_mask) % 32];
  w.barrier.sync(0);  // every lane has read
  T out;
  std::memcpy(&out, &bits, sizeof(T));
  return out;
}

namespace ppp_mock {
// op over the lanes' values; every lane calls it and gets the result
template <typename T, typename Op>
T warp_reduce(T v, Op op) {
  Warp& w = my_warp();
  const unsigned rank = thread_rank();
  const unsigned lanes =
      std::min(32u, blockDim.x * blockDim.y * blockDim.z - rank / 32 * 32);
  w.slot[rank % 32] = (unsigned long long)v;
  w.barrier.sync(0);
  T out = (T)w.slot[0];
  for (unsigned l = 1; l < lanes; ++l) out = op(out, (T)w.slot[l]);
  w.barrier.sync(0);
  return out;
}
}  // namespace ppp_mock

inline int __reduce_add_sync(unsigned, int v) {
  return ppp_mock::warp_reduce(v, [](int a, int b) { return a + b; });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return ppp_mock::warp_reduce(
      v, [](unsigned a, unsigned b) { return a > b ? a : b; });
}

// the lanes' predicates as bits, bit l for lane l; every lane calls it
inline unsigned __ballot_sync(unsigned, int pred) {
  ppp_mock::Warp& w = ppp_mock::my_warp();
  const unsigned rank = ppp_mock::thread_rank();
  const unsigned lanes = std::min(32u, blockDim.x * blockDim.y * blockDim.z -
                                           rank / 32 * 32);
  w.slot[rank % 32] = pred != 0;
  w.barrier.sync(0);
  unsigned out = 0;
  for (unsigned l = 0; l < lanes; ++l) out |= (unsigned)(w.slot[l] != 0) << l;
  w.barrier.sync(0);
  return out;
}

namespace ppp_mock {

// mbarriers, by the address of their 64-bit word: the arrivals a phase
// takes, those still to come, the bytes still in flight, and the phases
// completed.  A phase completes when its arrivals are in and its bytes
// have landed; a wait for parity p returns once the phase of parity p has
// completed, i.e. while the count of completed phases has parity != p.
struct MBar {
  unsigned count = 0, pending = 0;
  long long tx = 0;
  unsigned completed = 0;
};
inline std::mutex mbar_mutex;
inline std::condition_variable mbar_cv;
inline std::map<const void*, MBar> mbars;

inline void mbar_settle(MBar& b) {  // with the lock held
  if (b.pending == 0 && b.tx == 0) {
    ++b.completed;
    b.pending = b.count;
    mbar_cv.notify_all();
  }
}
inline void mbar_init(unsigned long long* bar, unsigned count) {
  std::lock_guard<std::mutex> lk(mbar_mutex);
  mbars[bar] = MBar{count, count, 0, 0};
}
// one arrival, expecting `bytes` more to land in this phase
inline void mbar_arrive(unsigned long long* bar, unsigned bytes) {
  std::lock_guard<std::mutex> lk(mbar_mutex);
  MBar& b = mbars.at(bar);
  b.tx += bytes;
  --b.pending;
  mbar_settle(b);
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  std::unique_lock<std::mutex> lk(mbar_mutex);
  MBar& b = mbars.at(bar);
  mbar_cv.wait(lk, [&] { return (b.completed & 1u) != (parity & 1u); });
}
inline void bulk_copy(void* dst, const void* src, unsigned bytes,
                      unsigned long long* bar) {
  std::memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> lk(mbar_mutex);
  MBar& b = mbars.at(bar);
  b.tx -= bytes;
  mbar_settle(b);
}

inline void launch(dim3 grid, dim3 blk, size_t smem,
                   const std::function<void()>& body) {
  gridDim = grid;
  blockDim = blk;
  std::vector<unsigned char> shared(smem + 16);
  dyn_smem = shared.data();
  const unsigned n = blk.x * blk.y * blk.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        block.alive = n;
        block.waiting = 0;
        block.vote = 0;
        warps.clear();
        for (unsigned w = 0; w * 32 < n; ++w) {
          warps.emplace_back(new Warp());
          warps.back()->barrier.alive = std::min(32u, n - w * 32);
        }
        std::vector<std::thread> threads;
        threads.reserve(n);
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t % blk.x, (t / blk.x) % blk.y,
                             t / (blk.x * blk.y));
            blockIdx = dim3(bx, by, bz);
            body();
            warps[t / 32]->barrier.leave();
            block.leave();
          });
        for (auto& th : threads) th.join();
      }
  dyn_smem = nullptr;
}

}  // namespace ppp_mock

#define PPP_MOCK_LAUNCH(grid, blk, smem, ...) \
  ppp_mock::launch(dim3(grid), dim3(blk), (size_t)(smem), [&] { __VA_ARGS__; })
