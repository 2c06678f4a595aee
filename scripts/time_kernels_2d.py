#!/usr/bin/env python3
"""Where the 2D consensus and rank wrappers spend their device time.

    python3 scripts/time_kernels_2d.py [--rounds N] [--root DIR]

Builds the 2D inputs of ``chip_smoke.py`` on one NVIDIA GPU, the gated
stack and target plane of setting (A) (pt 0.5, 25x25 patches) on the
16-worm 520x696 image (``A``) and on the 64-worm image (``dense2d``), and
times ``consensus_half_2d_cuda`` and ``rank_acc_2d_cuda`` on them, with an
f32 and a bf16 half:

- ``wrapper_ms``: CUDA events around the wrapper (scratch, every step),
  median and minimum of ``--rounds`` launches after one warm-up;
- ``device_ms``: each device kernel and memset of one launch by name, from
  a ``torch.profiler`` trace (median over the rounds), which splits the
  steps (count, index, pack pass, zero fill, kernel proper);
- ``scratch_mb``: the wrapper's peak device memory above its inputs and
  its output.

``--root DIR`` times the package ``patchperpix_tpu_torch`` of another
checkout (an earlier commit unpacked with ``git archive``), whose wrappers
take the same arguments, so that two versions can be timed in one call.
Prints the card's name and power limit, then one JSON line.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# this checkout's inputs and timers, whatever package is timed
import chip_smoke as cs  # noqa: E402
import time_kernels_3d as tk  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--root", default=REPO,
                    help="checkout whose patchperpix_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("time_kernels_2d: no CUDA device", file=sys.stderr)
        return 2
    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.ops import _build
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    built = _build.build([K.CONSENSUS2D.name, K.RANK2D.name])

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    ccfg = VoteInstancesParams(**cs.PATH2D["A"]).consensus_config()
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": os.path.relpath(root, REPO), "rounds": args.rounds,
           "size": list(cs.IMG2D), "patch": list(cs.PS2D[1:]),
           "ptxas": {n: [ln.strip() for ln in v["log"].splitlines()
                         if "registers" in ln or "spill" in ln]
                     for n, v in built.items()}}
    for case, affs_np in (("A", cs.path2d_inputs("A")["affs"]),
                          ("dense2d", cs.dense2d_affs())):
        affs = torch.as_tensor(affs_np, device=dev)
        del affs_np
        ag, tgt = C.gated_stack_2d(affs, ccfg)
        del affs
        res[case] = {"eligible_centers": int((ag[ccfg.mid] >= 0).sum()),
                     "target_pixels": int((tgt != 0).sum())}
        for name, bf16 in (("f32", False), ("bf16", True)):
            c = dataclasses.replace(ccfg, cons_bf16=bf16)
            half = K.consensus_half_2d_cuda(ag, tgt, c)

            def cons():
                return K.consensus_half_2d_cuda(ag, tgt, c)

            def rank():
                return K.rank_acc_2d_cuda(ag, tgt, half, c)

            out = {}
            for kname, fn, size in (("consensus", cons, half.nbytes),
                                    ("rank", rank, 4 * tgt.numel())):
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                fn()
                torch.cuda.synchronize(dev)
                scratch = torch.cuda.max_memory_allocated(dev) - base - size
                out[kname] = {
                    "wrapper_ms": tk.event_ms(fn, dev, args.rounds),
                    "device_ms": tk.device_ms(fn, dev, args.rounds),
                    "scratch_mb": scratch / 1e6}
            res[case][name] = out
            del half
        del ag, tgt
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
