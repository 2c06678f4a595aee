"""The weight-gradient kernel of the U-Net's valid 3x3x3 convolutions
(``patchperpix_tpu_torch/csrc/conv3d_wgrad.cu``, built with nvcc at first
use) at the convolutions of the published FlyLight ppp+dec U-Net at batch
2 of 140^3 (``chip_smoke.WGRAD_SHAPES``): against its plain PyTorch
version in float64, a second call's bits, and its ms beside the bound,
the plain version and cuDNN's exact-f32 weight gradient (heuristic and
best algorithm): ``chip_smoke.py``'s conv_wgrad phase
(``run_conv_wgrad``) alone.  Prints the card's name and power limit, the
build's register and spill lines, then the phase's lines (one per shape,
the totals, the kernel's row); exits non-zero on a mismatch.

Run: python scripts/conv_wgrad_cuda.py [--shapes i,j,...]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shapes", default=None,
                    help="indices into chip_smoke.WGRAD_SHAPES")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    import chip_smoke as cs
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
    cs.emit(cs.run_conv_wgrad(dev, shapes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
