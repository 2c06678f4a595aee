"""Probe of the row-window read on an NVIDIA GPU: an 8-row window read at a
run-time start out of n_slab stacked 8-row slabs, staged in shared memory
(smem) or read from global memory (gmem), for n_slab in {2, 3} and W in
{696, 720, 768}, and one case staging past 48 KB; the CUDA kernel
(``patchperpix_tpu_torch/csrc/probe_window.cu``, built with nvcc at first
use) against its plain PyTorch version.  Prints one line per case and
exits non-zero on a mismatch.

With ``--time`` it times the case W = 768, n_slab = 3 instead, with the
probe phase's own harness (``chip_smoke.probe_timed_case`` and
``probe_times``: CUDA events around one call of the kernel in each mode
in turns with ``F.conv2d`` along the rows, and of the plain version), at
medians of 4 and of 50 calls, and takes the card's own time per call of
each from a ``torch.profiler`` trace of 50 calls
(``time_kernels_3d.device_ms``).  ``--root DIR`` times the package of
another checkout (an earlier commit unpacked with ``git archive``), whose
wrappers take the same arguments, with this checkout's harness.  Prints
the card's name and power limit, then one JSON line.

Run: python scripts/probe_window_cuda.py [cpu]
     python scripts/probe_window_cuda.py --time [--root DIR]
     (``cpu`` runs the plain version against itself, a dry run of the
     script where there is no GPU)
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# medians of 4 calls (time_pair's default) and of 50 (the probe phase's)
ROUNDS = (2, 25)
TRACED = 50        # profiled calls of each


def check(device) -> int:
    from patchperpix_tpu_torch.ops.probe import run_cases

    bad = 0
    for r in run_cases(device):
        print(f"MODE={r['mode']} n_slab={r['n_slab']} W={r['W']} "
              f"device={device} max_err={r['max_err']}", flush=True)
        bad += not r["ok"]
    print("PROBE DONE" if not bad else f"PROBE FAILED: {bad} cases",
          flush=True)
    return 1 if bad else 0


def timed(root: str) -> int:
    # this checkout's harness, whatever package is timed
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chip_smoke as cs
    import time_kernels_3d as tk
    sys.path.insert(0, root)

    import torch

    from patchperpix_tpu_torch.ops import probe as PR

    if not torch.cuda.is_available():
        print("probe_window_cuda --time: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    x, want, fns = cs.probe_timed_case(PR, dev)
    timed_fns = ("smem", "gmem", "library")
    err = {m: float((fns[m]() - want).abs().max()) for m in timed_fns}
    out = {"root": os.path.relpath(root, REPO),
           "case": dict(zip(("n_slab", "W"), cs.PROBE_CASE)),
           "max_abs_err": err, "bytes": 4 * (x.numel() + want.numel())}
    for rounds in ROUNDS:
        out[f"medians_of_{2 * rounds}"] = cs.probe_times(fns, dev, rounds)
    traced = {m: tk.device_ms(fns[m], dev, TRACED) for m in timed_fns}
    out["device_ms"] = {m: sum(v.values()) for m, v in traced.items()}
    out["device_ms_by_kernel"] = traced
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cpu", nargs="?")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    if args.time:
        return timed(os.path.abspath(args.root))
    sys.path.insert(0, REPO)
    return check("cpu" if args.cpu == "cpu" else "cuda")


if __name__ == "__main__":
    sys.exit(main())
