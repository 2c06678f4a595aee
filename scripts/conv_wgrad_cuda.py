"""The weight-gradient kernel of the U-Net's valid 3x3x3 convolutions
(``patchperpix_tpu_torch/csrc/conv3d_wgrad.cu``, built with nvcc at first
use) at the convolutions of the published FlyLight ppp+dec U-Net at batch
2 of 140^3 (``parity.cases.WGRAD_SHAPES``): against its plain PyTorch
version in float64 (``cases.WGRAD_TOL`` of the largest value), a second
call's bits, and its ms beside the bound, the plain version and cuDNN's
exact-f32 weight gradient (heuristic and best algorithm), each in turns
with the kernel (``kernel_timing.time_pair``).  Prints the card's name
and power limit, the build's register and spill lines, one line per
shape, the totals, and W1's row of the kernel table in PERF.md (the sums
over the shapes, its library ms cuDNN's best); exits non-zero on a
mismatch.

Run: python scripts/conv_wgrad_cuda.py [--shapes i,j,...]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cudnn_wgrad(x, dy):
    """cuDNN's weight and bias gradient of the same convolution (the
    library's yardstick; the port's routed path never calls it)."""
    import torch

    w = torch.empty((dy.shape[1], x.shape[1], 3, 3, 3), device=x.device)
    return torch.ops.aten.convolution_backward(
        dy, x, w, [dy.shape[1]], [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
        [0, 0, 0], 1, [False, True, True])[1:]


def shape_row(ci, co, e, dev) -> dict:
    """One shape: the kernel against its plain version in float64
    (largest error over the largest |value|, for dW and dB), a second
    call's bits, and ms of the kernel, the plain version in float32 and
    cuDNN's exact-f32 weight gradient by its heuristic and by its best
    algorithm (``cudnn.benchmark``, after one call that chooses it)."""
    import torch

    import kernel_timing as kt
    from parity import cases as cs
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.utils.device import exact_f32

    x, dy = cs.wgrad_inputs(ci, co, e, dev)
    N, _, D, H, W = x.shape
    gflop = 2.0 * co * ci * 27 * dy[:, 0].numel() / 1e9
    plan = CK.device_plan(N, ci, co, D, H, W, x.device)
    row = {"ci": ci, "co": co, "extent": e, "gflop": gflop,
           "bound_ms": kt.bound_ms(0, gflop * 1e9)[0],
           "plan": plan._asdict()}
    dw, db = CK.conv3d_wgrad_cuda(x, dy)
    rw, rb = CK.conv3d_wgrad_plain(x.double(), dy.double())
    row["err_w"] = float((dw.double() - rw).abs().max() / rw.abs().max())
    row["err_b"] = float((db.double() - rb).abs().max() / rb.abs().max())
    del rw, rb
    dw2, db2 = CK.conv3d_wgrad_cuda(x, dy)
    row["same_bits"] = bool(torch.equal(dw, dw2) and torch.equal(db, db2))

    def kernel():
        CK.conv3d_wgrad_cuda(x, dy)

    row["ms"], row["plain_ms"] = kt.time_pair(
        lambda: CK.conv3d_wgrad_plain(x, dy), kernel, dev)
    bench = torch.backends.cudnn.benchmark
    with exact_f32():
        try:
            torch.backends.cudnn.benchmark = False
            _, row["library_ms"] = kt.time_pair(lambda: cudnn_wgrad(x, dy),
                                                kernel, dev)
            torch.backends.cudnn.benchmark = True
            cudnn_wgrad(x, dy)
            _, row["library_best_ms"] = kt.time_pair(
                lambda: cudnn_wgrad(x, dy), kernel, dev)
        finally:
            torch.backends.cudnn.benchmark = bench
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None,
                    help="indices into parity.cases.WGRAD_SHAPES")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import kernel_timing as kt
    from parity import cases as cs
    from patchperpix_tpu_torch.ops import _build
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    if not torch.cuda.is_available():
        print("conv_wgrad_cuda: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t = time.perf_counter()
    info = _build.build([CK.WGRAD.name])[CK.WGRAD.name]
    print(json.dumps({"build_s": time.perf_counter() - t, "ptxas": [
        ln for ln in info["log"].splitlines()
        if "registers" in ln or "spill" in ln or "entry" in ln]}),
          flush=True)
    dev = torch.device("cuda", 0)
    shapes = cs.WGRAD_SHAPES if args.shapes is None else [
        cs.WGRAD_SHAPES[int(i)] for i in args.shapes.split(",")]
    rows = []
    for ci, co, e in shapes:
        rows.append(shape_row(ci, co, e, dev))
        print(json.dumps(rows[-1]), flush=True)
    total = {k: sum(r[k] for r in rows)
             for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                       "library_best_ms", "gflop")}
    print(json.dumps({"total": total}), flush=True)
    print(json.dumps({"row": kt.kernel_row(
        CK.WGRAD, max(max(r["err_w"], r["err_b"]) for r in rows),
        total["ms"], total["plain_ms"], kt.bound_ms(0, total["gflop"] * 1e9),
        total["library_best_ms"])}), flush=True)
    bad = [r for r in rows if not (r["err_w"] <= cs.WGRAD_TOL
                                   and r["err_b"] <= cs.WGRAD_TOL
                                   and r["same_bits"])]
    if bad:
        print(f"conv_wgrad_cuda: the kernel disagrees: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
