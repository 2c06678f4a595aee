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
// runs at a time.  PPP_HOST_MOCK tells the sources to take plain loads
// where the card's build uses Hopper instructions.

#pragma once

#define PPP_HOST_MOCK 1

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
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

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9
};
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

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

using std::max;
using std::min;
inline int __ffs(unsigned v) { return v ? __builtin_ctz(v) + 1 : 0; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  return (unsigned)((((uint64_t)hi << 32) | lo) >> (shift & 31));
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
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

}  // namespace ppp_mock

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

inline void __syncthreads() { ppp_mock::block.sync(0); }
inline int __syncthreads_or(int pred) {
  return ppp_mock::block.sync(pred != 0);
}

namespace ppp_mock {

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
        std::vector<std::thread> threads;
        threads.reserve(n);
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            threadIdx = dim3(t % blk.x, (t / blk.x) % blk.y,
                             t / (blk.x * blk.y));
            blockIdx = dim3(bx, by, bz);
            body();
            block.leave();
          });
        for (auto& th : threads) th.join();
      }
  dyn_smem = nullptr;
}

}  // namespace ppp_mock

#define PPP_MOCK_LAUNCH(grid, blk, smem, ...) \
  ppp_mock::launch(dim3(grid), dim3(blk), (size_t)(smem), [&] { __VA_ARGS__; })
