"""The weight-gradient kernel of the training step's pointwise and
kernel = stride convolutions (W2,
``patchperpix_tpu_torch/csrc/conv_wgrad_gemm.cu``, built with nvcc at
first use) at the eight such convolutions of the published FlyLight
ppp+dec step (``parity.cases.GEMM_SHAPES``): against its plain PyTorch
version in float64 (``cases.WGRAD_TOL`` of the largest value), a second
call's bits, and its ms (CUDA events around the call, and the card's own
time from a profile) beside its bound (bytes or operations, whichever is
larger), the plain version and cuDNN's exact-f32 weight gradient of the
same convolution (heuristic and best algorithm), each in turns with the
kernel (``kernel_timing.time_pair``); for a transposed convolution also
the ms of the copy that regroups dy by tap.  Then the decoder's SAME
3x3x3 convolutions (``cases.SAME_SHAPES``): W1 on the input zero-padded
by one (the pad included) against cuDNN's exact-f32 weight gradient of
the SAME convolution.  Prints the card's name and power limit, the
build's register and spill lines, one line per shape, the totals, and
W2's row of the kernel table in PERF.md; exits non-zero on a mismatch.

With ``--short-rows`` it times only W1 against cuDNN where
``conv_kernels.serves`` rules on the rows' length (``SHORT_ROWS``: valid
and SAME 3x3x3 convolutions on rows of 4 to 16 values once padded, 1 to
64 channels, batch 2 to 2,048), one line a shape; it exits non-zero where
two calls differ in their bits or dW exceeds ``cases.WGRAD_TOL`` (dB's
error is printed: with one output channel it is one sum of up to 10^6
terms of mean zero, whose cancellation leaves a small sum to divide
by).

Run: python scripts/conv_wgrad_gemm_cuda.py [--short-rows]
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (padding, extent) x (channels in, out) x batch: W1 against cuDNN on
# short rows, where cuDNN's exact-f32 heuristic leaves its direct kernels
SHORT_ROWS = [(p, e, ci, co, n)
              for p, e in ((0, 4), (0, 6), (0, 8), (0, 10), (0, 12),
                           (0, 16), (1, 4), (1, 6))
              for ci, co in ((1, 1), (4, 4), (16, 16), (16, 32), (32, 32),
                             (16, 64), (64, 64))
              for n in (2, 256, 2048)]


def cudnn_wgrad(x, dy, w, stride, padding, transposed):
    """cuDNN's weight and bias gradient of the convolution (the library's
    yardstick; the port's routed path never calls it)."""
    import torch

    co = w.shape[1] if transposed else w.shape[0]
    return torch.ops.aten.convolution_backward(
        dy, x, w, [co], list(stride), [padding] * 3, [1, 1, 1], transposed,
        [0, 0, 0], 1, [False, True, True])[1:]


def library_ms(fn, kernel, dev) -> tuple:
    """ms of ``fn`` in exact f32 by cuDNN's heuristic and by its best
    algorithm (``cudnn.benchmark``, after one call that chooses it)."""
    import torch

    import kernel_timing as kt
    from patchperpix_tpu_torch.utils.device import exact_f32

    bench = torch.backends.cudnn.benchmark
    with exact_f32():
        try:
            torch.backends.cudnn.benchmark = False
            _, heuristic = kt.time_pair(fn, kernel, dev)
            torch.backends.cudnn.benchmark = True
            fn()
            _, best = kt.time_pair(fn, kernel, dev)
        finally:
            torch.backends.cudnn.benchmark = bench
    return heuristic, best


def gemm_row(ci, co, e, n, f, dev) -> dict:
    """One convolution: W2 against its plain version in float64 (largest
    error over the largest |value|, for dW and dB), a second call's bits,
    and ms of W2, the plain version in float32, the regrouping copy and
    cuDNN's exact-f32 weight gradient."""
    import torch

    import kernel_timing as kt
    from parity import cases as cs
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    a, b = cs.gemm_operands(ci, co, e, n, f, dev)
    N, M, S = a.shape
    K = b.shape[1]
    ops = 2.0 * M * K * N * S
    bound = kt.bound_ms(4.0 * (M + K) * N * S, ops)
    row = {"ci": ci, "co": co, "extent": e, "batch": n, "f": f, "M": M,
           "K": K, "S": S, "gflop": ops / 1e9, "bound_ms": bound[0],
           "bound_by": bound[1],
           "plan": CK.device_gemm_plan(N, M, K, S, dev)._asdict()}
    dw, db = CK.conv_wgrad_gemm_cuda(a, b)
    rw, rb = CK.conv_wgrad_gemm_plain(a.double(), b.double())
    row["err_w"] = float((dw.double() - rw).abs().max() / rw.abs().max())
    row["err_b"] = float((db.double() - rb).abs().max() / rb.abs().max())
    del rw, rb
    dw2, db2 = CK.conv_wgrad_gemm_cuda(a, b)
    row["same_bits"] = bool(torch.equal(dw, dw2) and torch.equal(db, db2))

    def kernel():
        CK.conv_wgrad_gemm_cuda(a, b)

    row["ms"], row["plain_ms"] = kt.time_pair(
        lambda: CK.conv_wgrad_gemm_plain(a, b), kernel, dev)
    # the card's own time: the kernel and the sum of the shares, without
    # the host's launch (which the events above include)
    row["device_ms"] = sum(kt.device_ms(kernel, dev, 10).values())
    row["pct_of_bound"] = 100.0 * bound[0] / row["device_ms"]
    x, dy = cs.gemm_inputs(ci, co, e, n, f, dev)
    if f > 1:
        row["regroup_ms"] = kt.event_ms(
            lambda: CK.tap_rows(dy, (f,) * 3), dev, 5)["median"]
        w = torch.empty((ci, co, f, f, f), device=dev)
    else:
        w = torch.empty((co, ci, 1, 1, 1), device=dev)
    row["library_ms"], row["library_best_ms"] = library_ms(
        lambda: cudnn_wgrad(x, dy, w, (f,) * 3, 0, f > 1), kernel, dev)
    return row


def w1_row(ci, co, e, n, dev, p=1) -> dict:
    """A 3x3x3 convolution, SAME (``p`` 1) or valid (0), on an input of
    extent ``e``: W1 on the input zero-padded by ``p`` (the route's way,
    the pad included) against cuDNN's exact-f32 weight gradient of the
    convolution, and W1's error against float64."""
    import torch
    import torch.nn.functional as F

    import kernel_timing as kt
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    gen = torch.Generator(device=dev).manual_seed(0)
    eo = e + 2 * p - 2
    x = torch.randn((n, ci, e, e, e), generator=gen, device=dev)
    dy = torch.randn((n, co, eo, eo, eo), generator=gen, device=dev)
    ops = 2.0 * co * ci * 27 * dy[:, 0].numel()
    row = {"ci": ci, "co": co, "extent": e, "batch": n,
           "route": "W1 same" if p else "W1 valid", "row": e + 2 * p,
           "gflop": ops / 1e9, "bound_ms": kt.bound_ms(0, ops)[0],
           "served": CK.serves(ci, co, e + 2 * p)}

    def kernel():
        return CK.conv3d_wgrad_cuda(F.pad(x, (p,) * 6) if p else x, dy)

    dw, db = kernel()
    rw, rb = CK.conv3d_wgrad_plain(
        (F.pad(x, (p,) * 6) if p else x).double(), dy.double())
    row["err_w"] = float((dw.double() - rw).abs().max() / rw.abs().max())
    row["err_b"] = float((db.double() - rb).abs().max() / rb.abs().max())
    dw2, db2 = kernel()
    row["same_bits"] = bool(torch.equal(dw, dw2) and torch.equal(db, db2))
    row["ms"] = kt.event_ms(kernel, dev, 5)["median"]
    w = torch.empty((co, ci, 3, 3, 3), device=dev)
    row["library_ms"], row["library_best_ms"] = library_ms(
        lambda: cudnn_wgrad(x, dy, w, (1, 1, 1), p, False), kernel, dev)
    row["w1_over_library"] = row["ms"] / row["library_ms"]
    return row


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    import kernel_timing as kt
    from parity import cases as cs
    from patchperpix_tpu_torch.ops import _build
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    if not torch.cuda.is_available():
        print("conv_wgrad_gemm_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t = time.perf_counter()
    info = _build.build([CK.GEMM.name, CK.WGRAD.name])
    print(json.dumps({"build_s": time.perf_counter() - t, "ptxas": [
        ln for ln in info[CK.GEMM.name]["log"].splitlines()
        if "registers" in ln or "spill" in ln or "entry" in ln]}),
          flush=True)
    dev = torch.device("cuda", 0)
    if "--short-rows" in sys.argv[1:]:
        short = []
        for p, e, ci, co, n in SHORT_ROWS:
            short.append(w1_row(ci, co, e, n, dev, p))
            print(json.dumps(short[-1]), flush=True)
        bad = [r for r in short if not (r["err_w"] <= cs.WGRAD_TOL
                                        and r["same_bits"])]
        if bad:
            print(f"conv_wgrad_gemm_cuda: W1 disagrees: {bad}",
                  file=sys.stderr)
        return 1 if bad else 0
    rows = []
    for shape in cs.GEMM_SHAPES:
        rows.append(gemm_row(*shape, dev))
        print(json.dumps(rows[-1]), flush=True)
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                       "library_ms", "library_best_ms", "gflop")}
    total["regroup_ms"] = sum(r.get("regroup_ms", 0.0) for r in rows)
    print(json.dumps({"total": total}), flush=True)
    print(json.dumps({"row": kt.kernel_row(
        CK.GEMM, max(max(r["err_w"], r["err_b"]) for r in rows),
        total["ms"], total["plain_ms"], (total["bound_ms"], "per shape"),
        total["library_best_ms"])}), flush=True)
    same = []
    for shape in cs.SAME_SHAPES:
        same.append(w1_row(*shape, dev))
        print(json.dumps(same[-1]), flush=True)
    bad = [r for r in rows + same if not (r["err_w"] <= cs.WGRAD_TOL
                                          and r["err_b"] <= cs.WGRAD_TOL
                                          and r["same_bits"])]
    if bad:
        print(f"conv_wgrad_gemm_cuda: a kernel disagrees: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
