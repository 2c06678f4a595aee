"""Probe of the row-window read on an NVIDIA GPU: an 8-row window read at a
run-time start out of n_slab stacked 8-row slabs, staged in shared memory
(smem) or read from global memory (gmem), for n_slab in {2, 3} and W in
{696, 720, 768}; the CUDA kernel (``patchperpix_tpu_torch/csrc/
probe_window.cu``, built with nvcc at first use) against its plain PyTorch
version.  Prints one line per case and exits non-zero on a mismatch.

Run: python scripts/probe_window_cuda.py [cpu]
     (``cpu`` runs the plain version against itself, a dry run of the
     script where there is no GPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from patchperpix_tpu_torch.ops.probe import run_cases

    device = "cpu" if len(sys.argv) > 1 and sys.argv[1] == "cpu" else "cuda"
    bad = 0
    for r in run_cases(device):
        print(f"MODE={r['mode']} n_slab={r['n_slab']} W={r['W']} "
              f"device={device} max_err={r['max_err']}", flush=True)
        bad += not r["ok"]
    print("PROBE DONE" if not bad else f"PROBE FAILED: {bad} cases",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
