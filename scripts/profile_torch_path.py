#!/usr/bin/env python3
"""Profile the PyTorch port's main path on one NVIDIA GPU.

    python3 scripts/profile_torch_path.py [--trace PATH] [--2d]

Runs the main path of ``parity/cases.py`` (the trained crop model on the
50^3 FlyLight fixture) in float32 and then in bfloat16: for each, once to
warm up and once under ``torch.profiler`` (CPU and CUDA activities).
With ``--2d`` it runs the cases' 2D path instead (the 520x696 worm image
at 25x25 patches, float32, settings A and B).
Prints one JSON line per dtype (per setting with ``--2d``):

- ``device`` and ``nvidia_smi``: the card, its name and power limit;
- ``stages``: for each stage of ``cases.run_path``, its wall seconds
  in the profiled run, the seconds the device was busy in it (kernel,
  memcpy and memset intervals of the trace, merged), its idle share, its
  number of kernels, and the seconds and count of Python's garbage
  collections in it (``gc_s``, ``gc_gen2``).  Stage windows are laid end
  to end from the run's start by the stage times the run reports (each
  ends in a device synchronise);
- ``total``: the same over the whole run;
- ``top_kernels``: the kernels with the most device time;
- ``top_host_ops``: the operators with the most self CPU time.

The profiler adds host cost to every operator, so the walls and idle
shares here are upper bounds of an unprofiled run's.  ``--trace`` also
keeps the Chrome trace.  Exits 2 without a CUDA device.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def merged_busy(intervals, lo, hi) -> float:
    """Microseconds of [lo, hi) covered by the union of the intervals."""
    busy, end = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s or e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def summarize(prof, times, h0, gcs, trace, dtype, device, smi) -> dict:
    """The JSON line for one profiled run (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    main_ev = next(e for e in events if e.get("name") == "main_path"
                   and e.get("cat") == "user_annotation")
    t0 = float(main_ev["ts"])
    dev_ev = [e for e in events if e.get("cat") in DEVICE_CATS]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in dev_ev]
    kernels = [e for e in dev_ev if e["cat"] == "kernel"]

    def window(lo, hi, h_lo, h_hi):
        busy = merged_busy(intervals, lo, hi)
        n = sum(1 for e in kernels if lo <= float(e["ts"]) < hi)
        in_gc = [(a, b, g) for a, b, g in gcs if h_lo <= a < h_hi]
        return {"wall_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
                "idle_share": 1.0 - busy / max(hi - lo, 1e-9),
                "kernels": n, "gc_s": sum(b - a for a, b, _ in in_gc),
                "gc_gen2": sum(1 for *_, g in in_gc if g == 2)}

    stages, lo, h_lo = {}, t0, h0
    for name, sec in times.items():
        if name == "total":
            continue
        stages[name] = window(lo, lo + sec * 1e6, h_lo, h_lo + sec)
        lo += sec * 1e6
        h_lo += sec
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_kernel[e["name"]][0] += float(e.get("dur", 0)) / 1e3
        by_kernel[e["name"]][1] += 1
    top_k = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    dur = float(main_ev["dur"])
    return {
        "dtype": dtype, "device": device, "nvidia_smi": smi,
        "stages": stages,
        "total": window(t0, t0 + dur, h0, h0 + dur / 1e6),
        "top_kernels": [{"name": k[:120], "ms": v[0], "count": v[1]}
                        for k, v in top_k],
        "top_host_ops": [{"name": a.key[:120],
                          "self_cpu_ms": a.self_cpu_time_total / 1e3,
                          "count": a.count} for a in host[:10]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", help="also write the float32 run's Chrome "
                    "trace here (with --2d: setting A's)")
    ap.add_argument("--2d", dest="two_d", action="store_true",
                    help="profile the 2D assembly path instead")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_path: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from parity import cases as cs
    from patchperpix_tpu_torch.ops import _build
    from patchperpix_tpu_torch.ops.consensus_kernels import KERNELS
    from patchperpix_tpu_torch.weights import build_model

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    _build.build([k.name for k in KERNELS])

    def profiled(run_once):
        """(profile, run_once()'s result, host clock at its start, garbage
        collections) of one run under the profiler."""
        gcs, t_gc = [], {}

        def on_gc(phase, info):
            if phase == "start":
                t_gc["start"] = time.perf_counter()
            else:
                gcs.append((t_gc["start"], time.perf_counter(),
                            info["generation"]))

        gc.callbacks.append(on_gc)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                with record_function("main_path"):
                    h0 = time.perf_counter()
                    res = run_once()
        finally:
            gc.callbacks.remove(on_gc)
        return prof, res, h0, gcs

    kind = torch.cuda.get_device_name(0)
    if args.two_d:
        inputs = {s: cs.path2d_inputs(s) for s in cs.PATH2D}
        affs = torch.as_tensor(inputs["A"]["affs"], device=dev)
        for s in cs.PATH2D:
            cs.assemble_2d(s, inputs[s], affs, dev)
            times = {}
            prof, _, h0, gcs = profiled(
                lambda: cs.assemble_2d(s, inputs[s], affs, dev, times))
            print(json.dumps(summarize(
                prof, times, h0, gcs, args.trace if s == "A" else None,
                f"float32, 2D setting {s}", kind, smi)), flush=True)
            del prof
        return 0
    raw = cs.crop_raw()
    for dtype in ("float32", "bfloat16"):
        cfg = cs.crop_config(dtype)
        model = build_model(cfg, device=dev)
        cs.run_path(model, cfg, raw, dev)
        prof, run, h0, gcs = profiled(
            lambda: cs.run_path(model, cfg, raw, dev))
        trace = args.trace if dtype == "float32" else None
        print(json.dumps(summarize(prof, run["times"], h0, gcs, trace,
                                   dtype, kind, smi)), flush=True)
        del model, run, prof
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
