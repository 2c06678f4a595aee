#!/usr/bin/env python3
"""Time the cover kernels K5 / K6 at each block size on the paths' inputs.

    python3 scripts/time_cover_kernels.py [--rounds N] [--split]

Runs, on one NVIDIA GPU, the f32 main path of ``chip_smoke.py`` (the
trained crop model on the 50^3 FlyLight fixture) and the 2D assembly of
setting (B) (the 16-worm 520x696 image, 25x25 patches), each once, with
``chip_smoke.CoverCapture`` recording their cover inputs.  Then, for each
block size of 64, 128, 256, 512 and 1,024 threads, times the wrappers
(``ops/cover_kernels.py``: the pack passes, the loop's block and the copy
of the selection to the host) with CUDA events, median and minimum of
``--rounds`` calls after one warm-up:

- ``thin_3d``: K6 on the 3D thin-cover input, the loop's shared memory
  staged (``staged``) and, for comparison, in device memory (``gmem``);
- ``cascade_2d``: K5 on (B)'s cascade input (chunks of 256);
- ``thin_2d``: K6 on (B)'s thin-cover input;

and then K5 on (B)'s cascade input at chunks of 32 to 1,024 candidates
(the default block size).

Each selection is checked against the wrapper's default launch.  With
``--split``, first one JSON line per case at the default block size
(``thin_3d``, ``thin_3d_capped``: the lazy loop capped at a quarter of
its candidates, then the full loop; ``cascade_2d``, ``thin_2d``): the
device ms of each kernel of the call (``pack_masks``, ``pack_running``,
the loop) from ``torch.profiler``, the loop's counts, and its cycles by
phase with their shares (``chip_smoke.cover_split``).  Prints the card's
name and power limit, then one JSON line per block size and one per
chunk.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--split", action="store_true",
                    help="first the device and phase split of each case")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("time_cover_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from patchperpix_tpu_torch.ops import cover_kernels as CK
    from patchperpix_tpu_torch.utils.io import IoZarr
    from patchperpix_tpu_torch.weights import build_model

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    io = IoZarr(cs.FIXTURE)
    raw = np.clip(io.read(key="volumes/raw").astype(np.float32), 0,
                  1500.0) / 1500.0
    cfg = cs.crop_config("float32")
    with cs.CoverCapture() as cap3d:
        cs.run_path(build_model(cfg, device=dev), cfg, raw, dev)
    full = cs.path2d_inputs("B")
    with cs.CoverCapture() as cap2d:
        cs.assemble_2d("B", full, torch.as_tensor(full["affs"], device=dev),
                       dev)
    t3, c2, t2 = cap3d.thin, cap2d.cascade, cap2d.thin
    ths = cs.pix_thresholds(c2["ps"])

    def thin(t, **kw):
        return CK.thin_cover_cuda(t["affs"], t["mask"], t["centers"],
                                  t["ps"], t["fc"], **kw)[0]

    def cascade(**kw):
        return CK.cover_cascade_cuda(c2["affs"], c2["mask"], c2["centers"],
                                     c2["overlap_rows"], c2["ps"], c2["fc"],
                                     ths, **kw)[0]

    want = {"thin_3d": thin(t3), "cascade_2d": cascade(),
            "thin_2d": thin(t2)}
    if args.split:
        cap_it = len(t3["centers"]) // 4
        for name, fn in (
                ("thin_3d", lambda: CK.thin_cover_cuda(
                    t3["affs"], t3["mask"], t3["centers"], t3["ps"],
                    t3["fc"])),
                ("thin_3d_capped", lambda: CK.thin_cover_cuda(
                    t3["affs"], t3["mask"], t3["centers"], t3["ps"],
                    t3["fc"], max_it=cap_it)),
                ("cascade_2d", lambda: CK.cover_cascade_cuda(
                    c2["affs"], c2["mask"], c2["centers"],
                    c2["overlap_rows"], c2["ps"], c2["fc"], ths)),
                ("thin_2d", lambda: CK.thin_cover_cuda(
                    t2["affs"], t2["mask"], t2["centers"], t2["ps"],
                    t2["fc"]))):
            sel = fn()[0]
            print(json.dumps({
                "case": name, "equal": bool(np.array_equal(
                    sel, want[name.replace("_capped", "")])),
                "stats": fn()[-1], "wrapper_ms": event_ms(fn, dev,
                                                          args.rounds),
                **cs.cover_split(fn, dev, args.rounds)}), flush=True)
    for threads in (64, 128, 256, 512, 1024):
        got = {"thin_3d": thin(t3, threads=threads),
               "cascade_2d": cascade(threads=threads),
               "thin_2d": thin(t2, threads=threads)}
        print(json.dumps({
            "threads": threads,
            "equal": {k: bool(np.array_equal(got[k], want[k]))
                      for k in want},
            "thin_3d": {
                "staged": event_ms(lambda: thin(t3, threads=threads), dev,
                                   args.rounds),
                "gmem": event_ms(lambda: thin(t3, threads=threads,
                                              smem_cap=0), dev,
                                 args.rounds)},
            "cascade_2d": event_ms(lambda: cascade(threads=threads), dev,
                                   args.rounds),
            "thin_2d": event_ms(lambda: thin(t2, threads=threads), dev,
                                args.rounds),
            "n": {"thin_3d": len(t3["centers"]),
                  "cascade_2d": len(c2["centers"]),
                  "thin_2d": len(t2["centers"])}}), flush=True)
    for chunk in (32, 64, 128, 256, 512, 1024):
        print(json.dumps({
            "chunk": chunk,
            "equal": bool(np.array_equal(cascade(chunk=chunk),
                                         want["cascade_2d"])),
            "cascade_2d": event_ms(lambda: cascade(chunk=chunk), dev,
                                   args.rounds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
