// Canonical half of the 2D consensus vote array from one sentinel-gated
// stack, one thread per output element.
//
// Replaces the Pallas TPU kernel patchperpix_tpu/ops/pallas_consensus_2d.py
// ::_cons2d_kernel (pallas_consensus_2d.py:261, launched by
// consensus_fold_pallas_2d at :387 / pallas_call :445).  Plain PyTorch
// version: ops/consensus.py::consensus_half_2d_plain.
//
// Function.  Inputs: the gated stack ag (P = p*p, H, W), centre-aligned
// (ag[q][c] = affs[q][c] at an eligible center c, else the sentinel -1), and
// the target plane tgt (H, W), 1 where a pixel is target-eligible.  For a
// canonical displacement d = (dy, dx) (dy > 0, or dy == 0 and dx > 0) and
// output pixel x:
//
//   cons[d][x] = sum over patch pixels q with q and r = q + d inside the
//                patch and center c = x - (q - rad) inside the image of
//                w(q, r) at c,
//
// where the four stacks of the 3D kernel are derived in registers
// (pallas_consensus_2d.py:242 _derive): with v = ag[q][c] and t the target
// plane at q's target pixel (x for q, x + d for r),
//
//   hi = (v > th) t,  lo = (0 <= v < bg) t,  a = v hi,  b = (1 - v) lo
//   pp  = a_q (a_r - b_r) - b_q a_r        sc = hi_q (hi_r - lo_r) - lo_q hi_r
//   cnt = hi_q (hi_r + lo_r) + lo_q hi_r
//   norm_prob_product: (pp - th^2 sc) / (1 - th^2);  prob_product: pp;
//   count: sc;  then cons / cnt where cnt != 0 when norm_aff.
//
// Output: the standard layout (p, 2p-1, H, W), float32 or bf16, index
// (dy, dx + p - 1); the dx <= 0 entries of the dy == 0 plane are written 0.
// The TPU kernel's (slab, 8-row) fold, its d = 8 dzb + dyr split, the dual
// group reads and the fold output layout serve Mosaic and are not carried
// over.  What is kept is the point of that design: device memory holds ONE
// (P, H, W) stack instead of four.
//
// Bound.  At 520x696 with 25x25 patches the function writes the half once
// (1,225 * 361,920 * 4 B = 1.773 GB in f32) and reads what the data needs:
// the target plane, the stack's mid plane (the center gate) and the stack's
// columns at eligible centers (the rest holds the sentinel); chip_smoke.py
// counts them for each run.  On the 16-worm image (8,215 eligible centers)
// that is 1.797 GB, 0.54 ms at 3.35 TB/s.  Its arithmetic is 15 float
// operations per eligible pixel pair at an eligible center (81 M pairs
// there, 0.02 ms at 67 TFLOP/s).  The bound is memory bytes.  Measured on an
// NVIDIA H100 80GB HBM3 at a 700 W limit (chip_smoke.py): 5.3 ms, f32 or
// bf16 half.
//
// Design (simple first).  The output is dense but sparse in content: an
// element is nonzero only where both x and x + d are target-eligible, so a
// thread whose two target reads fail writes its zero at once; the rest loop
// over q, skip centers whose mid-plane entry is the sentinel (one hot plane)
// and pairs with hi = lo = 0 before the second load.  Threads of a warp are
// consecutive x: stores and the stack loads of a given q coalesce.  All
// offsets are 64-bit (the half alone is 4.4e8 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum WeightMode { kNormProbProduct = 0, kProbProduct = 1, kCount = 2 };

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename OutT>
__global__ void consensus2d_kernel(const float* __restrict__ ag,
                                   const float* __restrict__ tgt,
                                   OutT* __restrict__ out, int H, int W, int p,
                                   int mode, float th, float bg,
                                   int norm_aff) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int di = blockIdx.z;
  const int nd = 2 * p - 1;
  const int dy = di / nd, dx = di % nd - (p - 1);
  const long long HW = (long long)H * W;

  float pp = 0.f, sc = 0.f, cnt = 0.f;
  const int y2 = y + dy, x2 = x + dx;
  const bool canon = dy > 0 || dx > 0;
  if (canon && y2 < H && x2 >= 0 && x2 < W &&
      tgt[(long long)y * W + x] != 0.f && tgt[(long long)y2 * W + x2] != 0.f) {
    const int rad = p / 2;
    const float* mid = ag + (long long)(rad * p + rad) * HW;
    const long long dstep = (long long)(dy * p + dx) * HW;
    const int qx_lo = max(0, -dx), qx_hi = min(p, p - dx);
    for (int qy = 0; qy < p - dy; ++qy) {
      const int cy = y - qy + rad;
      if (cy < 0 || cy >= H) continue;
      for (int qx = qx_lo; qx < qx_hi; ++qx) {
        const int cx = x - qx + rad;
        if (cx < 0 || cx >= W) continue;
        const long long c = (long long)cy * W + cx;
        if (mid[c] < 0.f) continue;  // not an eligible center
        const long long iq = (long long)(qy * p + qx) * HW + c;
        const float vl = ag[iq];
        const float hl = vl > th ? 1.f : 0.f;
        const float ll = (vl >= 0.f && vl < bg) ? 1.f : 0.f;
        if (hl == 0.f && ll == 0.f) continue;
        const float vr = ag[iq + dstep];
        const float hr = vr > th ? 1.f : 0.f;
        const float lr = (vr >= 0.f && vr < bg) ? 1.f : 0.f;
        if (hr == 0.f && lr == 0.f) continue;
        const float al = vl * hl, bl = (1.f - vl) * ll;
        const float ar = vr * hr, br = (1.f - vr) * lr;
        pp += al * (ar - br) - bl * ar;
        sc += hl * (hr - lr) - ll * hr;
        cnt += hl * (hr + lr) + ll * hr;
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
  store(out + ((long long)di * H + y) * W + x, v);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ppp_consensus2d_half(const float* ag, const float* tgt,
                                    void* out, int out_bf16, int H, int W,
                                    int p, int mode, float th, float bg,
                                    int norm_aff, void* stream) {
  if (H == 0 || W == 0) return 0;
  const int threads = 128;
  const long long planes = (long long)p * (2 * p - 1);
  if (H > 65535 || planes > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((W + threads - 1) / threads), (unsigned)H,
                  (unsigned)planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16) {
    consensus2d_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        ag, tgt, static_cast<__nv_bfloat16*>(out), H, W, p, mode, th, bg,
        norm_aff);
  } else {
    consensus2d_kernel<float><<<grid, threads, 0, s>>>(
        ag, tgt, static_cast<float*>(out), H, W, p, mode, th, bg, norm_aff);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ppp_consensus2d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
