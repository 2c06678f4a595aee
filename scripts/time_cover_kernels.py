#!/usr/bin/env python3
"""Time the cover kernels K5 / K6 at each block size on the paths' inputs.

    python3 scripts/time_cover_kernels.py [--rounds N] [--split]

Runs, on one NVIDIA GPU, the f32 main path (``parity/cases.py``: the
trained crop model on the 50^3 FlyLight fixture) and the 2D assembly of
setting (B) (the 16-worm 520x696 image, 25x25 patches), each once, with
``cases.CoverCapture`` recording their cover inputs.  First one JSON line
of K5's and K6's rows of the kernel table in PERF.md, a row per case
(``thin_3d``; ``thin_3d_capped``: the lazy loop capped at a quarter of
its candidates, then the full loop; ``cascade_2d``; ``thin_2d``): the
largest difference from the plain version (the host loops of
``ops/cover.py``; integer counts), the wrapper's and the plain version's
ms (``kernel_timing.time_pair``: each call from the host's arrays to the
host's selection) and the bound of the bytes the loop needs (the n
affinity columns, the mask, centers and overlap rows read once, the
selection and the volume written once) against 2 P operations for each
window the run counted, with those counts.

Then, for each block size of 64, 128, 256, 512 and 1,024 threads, times
the wrappers (``ops/cover_kernels.py``: the pack passes, the loop's block
and the copy of the selection to the host) with CUDA events, median and
minimum of ``--rounds`` calls after one warm-up:

- ``thin_3d``: K6 on the 3D thin-cover input, the loop's shared memory
  staged (``staged``) and, for comparison, in device memory (``gmem``);
- ``cascade_2d``: K5 on (B)'s cascade input (chunks of 256);
- ``thin_2d``: K6 on (B)'s thin-cover input;

and then K5 on (B)'s cascade input at chunks of 32 to 1,024 candidates
(the default block size).

Each selection is checked against the wrapper's default launch.  With
``--split``, before the sweeps one JSON line per case at the default
block size: the device ms of each kernel of the call (``pack_masks``,
``pack_running``, the loop) from ``torch.profiler``, the loop's counts,
and its cycles by phase with their shares (``cover_split``).  Prints the
card's name and power limit, then the lines above.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import kernel_timing as kt  # noqa: E402

COVER_DEVICE_KERNELS = ("pack_masks", "pack_running", "thin_cover_kernel",
                        "cover_cascade_kernel")


def cover_split(fn, dev, rounds=3):
    """Where a cover wrapper's call goes on the card: the device ms of each
    of its kernels (``COVER_DEVICE_KERNELS``), a mean over ``rounds`` calls
    under ``torch.profiler`` (where the profiler sees no device time, the
    call's CUDA-event ms instead), and each phase's share of the loop
    kernel's cycles (the ``clock64`` sums in the statistics that ``fn``
    returns last; K5's bounding and walking warps run side by side, so its
    shares need not add up to 1)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    st = fn()[-1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize(dev)
    dev_ms = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in COVER_DEVICE_KERNELS if k in e.name), None)
        if name is not None:
            t = e.device_time if hasattr(e, "device_time") else e.cuda_time
            dev_ms[name] = dev_ms.get(name, 0.0) + t / rounds / 1e3
    out = {"device_ms": dev_ms or None}
    if not dev_ms:
        out["call_ms"] = kt.event_ms(fn, dev, 1)["median"]
    cyc = dict(st["cycles"])
    total = cyc.pop("total")
    out["cycle_share"] = {k: v / total if total else 0.0
                          for k, v in cyc.items()}
    return out


def cover_row(name, kind, inp, dev, max_it=None, rounds=2):
    """K5 (``kind`` "cascade") or K6 ("thin", capped at ``max_it`` where
    given) against its plain version on a captured input: the table's
    row, with the case, its counts and the windows of its bound."""
    import numpy as np

    from parity import cases as cs
    from patchperpix_tpu_torch.ops import cover as COV
    from patchperpix_tpu_torch.ops import cover_kernels as CK

    a, mask, centers = inp["affs"], inp["mask"], inp["centers"]
    ps, fc, ovl = inp["ps"], inp["fc"], inp["overlap_rows"]
    n, P, V = len(centers), int(np.prod(ps)), int(mask.size)
    if kind == "cascade":
        ths = cs.pix_thresholds(ps)
        kernel = CK.COVER_CASCADE

        def kern():
            return CK.cover_cascade_cuda(a, mask, centers, ovl, ps, fc, ths)

        def plain():
            return COV.cover_cascade_plain(a, mask, centers, ovl, ps, fc, ths)
        sel_k, run_k, st = kern()
        sel_p, run_p = plain()
        err = max(int(np.abs(sel_k.astype(int) - sel_p).max()),
                  int(np.abs(run_k.astype(int) - run_p).max()))
        windows = st["bounded"] + st["visits"] + st["takes"]
        nbytes = 4 * n * P + 2 * V + 12 * n + 2 * n
    else:
        kernel = CK.THIN_COVER

        def kern():
            return CK.thin_cover_cuda(a, mask, centers, ps, fc, max_it=max_it)

        def plain():
            return COV.thin_cover_plain(a, mask, centers, ps, fc, max_it)
        sel_k, st = kern()
        sel_p = plain()
        err = int(np.abs(sel_k.astype(int) - sel_p).max())
        windows = n + st["refreshes"] + st["picks"]
        if "full" in st:
            windows += st["full"]["refreshes"] + st["full"]["picks"]
        nbytes = 4 * n * P + V + 12 * n + n
    ms, plain_ms = kt.time_pair(plain, kern, dev, rounds)
    row = kt.kernel_row(kernel, float(err), ms, plain_ms,
                        kt.bound_ms(nbytes, 2 * P * windows))
    return {"case": name, "n": n, "P": P, "volume": list(mask.shape),
            "selected": int(sel_k.sum()), "max_it": max_it, "stats": st,
            "bytes": nbytes, "windows": windows, **row}


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
    from parity import cases as cs
    from patchperpix_tpu_torch.ops import cover_kernels as CK
    from patchperpix_tpu_torch.weights import build_model

    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    cfg = cs.crop_config("float32")
    with cs.CoverCapture() as cap3d:
        cs.run_path(build_model(cfg, device=dev), cfg, cs.crop_raw(), dev)
    full = cs.path2d_inputs("B")
    with cs.CoverCapture() as cap2d:
        cs.assemble_2d("B", full, torch.as_tensor(full["affs"], device=dev),
                       dev)
    t3, c2, t2 = cap3d.thin, cap2d.cascade, cap2d.thin
    ths = cs.pix_thresholds(c2["ps"])
    cap_it = len(t3["centers"]) // 4
    print(json.dumps({"rows": [
        cover_row("thin_3d", "thin", t3, dev),
        cover_row("thin_3d_capped", "thin", t3, dev, max_it=cap_it,
                  rounds=1),
        cover_row("cascade_2d", "cascade", c2, dev),
        cover_row("thin_2d", "thin", t2, dev)]}), flush=True)

    def thin(t, **kw):
        return CK.thin_cover_cuda(t["affs"], t["mask"], t["centers"],
                                  t["ps"], t["fc"], **kw)[0]

    def cascade(**kw):
        return CK.cover_cascade_cuda(c2["affs"], c2["mask"], c2["centers"],
                                     c2["overlap_rows"], c2["ps"], c2["fc"],
                                     ths, **kw)[0]

    want = {"thin_3d": thin(t3), "cascade_2d": cascade(),
            "thin_2d": thin(t2)}

    def timed(fn):
        return kt.event_ms(fn, dev, args.rounds)

    if args.split:
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
                "stats": fn()[-1], "wrapper_ms": timed(fn),
                **cover_split(fn, dev, args.rounds)}), flush=True)
    for threads in (64, 128, 256, 512, 1024):
        got = {"thin_3d": thin(t3, threads=threads),
               "cascade_2d": cascade(threads=threads),
               "thin_2d": thin(t2, threads=threads)}
        print(json.dumps({
            "threads": threads,
            "equal": {k: bool(np.array_equal(got[k], want[k]))
                      for k in want},
            "thin_3d": {
                "staged": timed(lambda: thin(t3, threads=threads)),
                "gmem": timed(lambda: thin(t3, threads=threads,
                                           smem_cap=0))},
            "cascade_2d": timed(lambda: cascade(threads=threads)),
            "thin_2d": timed(lambda: thin(t2, threads=threads)),
            "n": {"thin_3d": len(t3["centers"]),
                  "cascade_2d": len(c2["centers"]),
                  "thin_2d": len(t2["centers"])}}), flush=True)
    for chunk in (32, 64, 128, 256, 512, 1024):
        print(json.dumps({
            "chunk": chunk,
            "equal": bool(np.array_equal(cascade(chunk=chunk),
                                         want["cascade_2d"])),
            "cascade_2d": timed(lambda: cascade(chunk=chunk))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
