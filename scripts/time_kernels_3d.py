#!/usr/bin/env python3
"""Where the 3D consensus and rank wrappers spend their device time.

    python3 scripts/time_kernels_3d.py [--rounds N]

Runs the f32 main path of ``chip_smoke.py`` once on one NVIDIA GPU (the
trained crop model on the 50^3 FlyLight fixture) to get the path's decoded
affinities and masks, then times ``consensus_half_cuda`` and
``rank_acc_cuda`` on them, with an f32 and a bf16 half:

- ``wrapper_ms``: CUDA events around the wrapper (scratch allocation, the
  pack pass and the kernel), median and minimum of ``--rounds`` launches
  after one warm-up;
- ``device_ms``: each device kernel and memset of one launch by name, from
  a ``torch.profiler`` trace (median over the rounds), which splits the
  pack pass from the kernel proper.

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def event_ms(fn, dev, rounds):
    import torch

    fn()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        out.append(start.elapsed_time(end))
    return {"median": statistics.median(out), "min": min(out)}


def device_ms(fn, dev, rounds):
    """Median device time of each kernel / memset name over ``rounds``
    profiled launches (a name launched k times in one call counts k
    times its median)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    by_name = defaultdict(list)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize(dev)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name].append(e.device_time if hasattr(e, "device_time")
                                   else e.cuda_time)
    return {n[:80]: statistics.median(v) * len(v) / rounds / 1e3
            for n, v in by_name.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_kernels_3d: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K
    from patchperpix_tpu_torch.utils.io import IoZarr
    from patchperpix_tpu_torch.weights import build_model

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    raw = np.clip(IoZarr(cs.FIXTURE).read(key="volumes/raw").astype(
        np.float32), 0, 1500.0) / 1500.0
    cfg = cs.crop_config("float32")
    run = cs.run_path(build_model(cfg, device=dev), cfg, raw, dev)
    ccfg = cs.vote_params().consensus_config()
    dec = run["dec"]
    hi, lo, _ = C._masks(dec, ccfg,
                         torch.as_tensor(run["numinst"] > 1, device=dev))
    a, b = dec * hi, (1.0 - dec) * lo
    del run

    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "rounds": args.rounds, "volume": list(hi.shape[1:]),
           "eligible_centers": int(((hi != 0) | (lo != 0)).any(0).sum())}
    for name, bf16 in (("f32", False), ("bf16", True)):
        c = dataclasses.replace(ccfg, cons_bf16=bf16)
        half = K.consensus_half_cuda(a, b, hi, lo, c)

        def cons():
            return K.consensus_half_cuda(a, b, hi, lo, c)

        def rank():
            return K.rank_acc_cuda(hi, lo, half, c)

        res[name] = {
            "consensus": {"wrapper_ms": event_ms(cons, dev, args.rounds),
                          "device_ms": device_ms(cons, dev, args.rounds)},
            "rank": {"wrapper_ms": event_ms(rank, dev, args.rounds),
                     "device_ms": device_ms(rank, dev, args.rounds)}}
        del half
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
