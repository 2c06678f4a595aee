"""Probe of the row-window read on an NVIDIA GPU: an 8-row window read at a
run-time start out of n_slab stacked 8-row slabs, staged in shared memory
(smem) or read from global memory (gmem), for n_slab in {2, 3} and W in
{696, 720, 768}, and one case staging past 48 KB; the CUDA kernel
(``patchperpix_tpu_torch/csrc/probe_window.cu``, built with nvcc at first
use) against its plain PyTorch version.  Prints one line per case and
exits non-zero on a mismatch.

With ``--time`` it times the case W = 768, n_slab = 3 instead
(``probe_timed_case`` and ``probe_times``: CUDA events around one call of
the kernel in each mode in turns with ``F.conv2d`` along the rows, and of
the plain version), at medians of 4 and of 50 calls, takes the card's own
time per call of each from a ``torch.profiler`` trace of 50 calls
(``kernel_timing.device_ms``), and gives P1's row of the kernel table in
PERF.md (the medians of 50, the bound of the bytes read and written once
against 2 (n_slab - 1) V operations an output).  ``--root DIR`` times the
package of another checkout (an earlier commit unpacked with ``git
archive``), whose wrappers take the same arguments, with this checkout's
harness.  Prints the card's name and power limit, then one JSON line.

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
PROBE_CASE = (3, 768)   # n_slab, W of the timed case
# medians of 4 calls (time_pair's default) and of 50: tens of
# microseconds a call, most of it host work
ROUNDS = (2, 25)
TRACED = 50        # profiled calls of each


def probe_timed_case(PR, dev):
    """The timed case (``PROBE_CASE``) on ``dev``: its seeded input, the
    plain version's result, and the callables that are timed: the kernel
    in each mode, the plain version, and the one PyTorch call that
    computes the same sums (a convolution along the row axis with the
    weights s + 1).  ``PR`` is a checkout's ``ops/probe`` module."""
    import torch
    import torch.nn.functional as F

    n_slab, W = PROBE_CASE
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((8, PR.V, W), generator=gen, device=dev)
    n_out, n_start = 8 - n_slab + 1, (n_slab - 1) * PR.V
    k = torch.arange(1, n_start + 1, dtype=torch.float32,
                     device=dev).reshape(1, 1, n_start, 1)
    fns = {"plain": lambda: PR.probe_window_plain(x, n_slab),
           "smem": lambda: PR.probe_window_cuda(x, n_slab, "smem"),
           "gmem": lambda: PR.probe_window_cuda(x, n_slab, "gmem"),
           "library": lambda: F.conv2d(x.reshape(1, 1, 8 * PR.V, W), k)[
               0, 0, :n_out * PR.V].reshape(n_out, PR.V, W)}
    return x, fns["plain"](), fns


def probe_times(kt, fns, dev, rounds) -> dict:
    """ms of one call of each of ``probe_timed_case``'s callables, as
    ``time_pair`` times them (medians of 2 * rounds calls): each kernel
    in turns with the library call, so that both are timed beside the
    same work (a call timed after the plain version's many small
    launches reads slower), and the plain version alone."""
    ms, lib = kt.time_pair(fns["library"], fns["smem"], dev, rounds)
    gmem, lib2 = kt.time_pair(fns["library"], fns["gmem"], dev, rounds)
    _, plain = kt.time_pair(fns["plain"], lambda: None, dev, rounds)
    return {"ms": ms, "gmem_ms": gmem, "plain_ms": plain, "library_ms": lib,
            "library_ms_beside_gmem": lib2}


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
    import kernel_timing as kt
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
    x, want, fns = probe_timed_case(PR, dev)
    timed_fns = ("smem", "gmem", "library")
    err = {m: float((fns[m]() - want).abs().max()) for m in timed_fns}
    nbytes = 4 * (x.numel() + want.numel())
    out = {"root": os.path.relpath(root, REPO),
           "case": dict(zip(("n_slab", "W"), PROBE_CASE)),
           "max_abs_err": err, "bytes": nbytes}
    for rounds in ROUNDS:
        out[f"medians_of_{2 * rounds}"] = probe_times(kt, fns, dev, rounds)
    t = out[f"medians_of_{2 * ROUNDS[-1]}"]
    out["row"] = kt.kernel_row(
        PR.PROBE, err["smem"], t["ms"], t["plain_ms"],
        kt.bound_ms(nbytes, 2 * (PROBE_CASE[0] - 1) * PR.V * want.numel()),
        t["library_ms"])
    traced = {m: kt.device_ms(fns[m], dev, TRACED) for m in timed_fns}
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
