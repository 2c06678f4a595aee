"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The run loads the cell's configuration and
traffic mix (``harness.Cell``), sets up the program under test
(``patchperpix_tpu_torch``, the PyTorch / CUDA port) from the seed, warms
up every shape the mix uses, measures for ``--seconds`` and then checks
what the timed path produced against the plain reference in
``reference/``.  Its last line on standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number with its limit; the same numbers are the last lines on
standard error.  Without a CUDA card with enough devices, or with a
forbidden module loaded (``harness.FORBIDDEN``), it prints no result and
exits with code 2.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".portbench_cache")

# the program's kernel caches live at fixed paths inside the checkout (the
# port builds its own CUDA libraries into patchperpix_tpu_torch/build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402


class Ctx:
    """What a driver gets: the cell, the run's arguments, the clock and the
    tracing of a traced run."""

    def __init__(self, cell, seed, seconds, trace, device, root, checkout,
                 t0):
        self.cell = cell
        self.checkout = checkout
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = bool(trace)
        self.device = device
        self.root = root
        self.t0 = t0
        self.spans = harness.Spans(self.traced)
        self.timeline = harness.DeviceTimeline(
            self.traced, cell.traffic.get("trace_seconds"))
        self.trace = harness.Trace(self.spans)
        self.device_info = None
        self.setup_s = None

    def open_window(self) -> float:
        """Mark the end of set-up, after a garbage collection, so that every
        window starts from the same heap; returns the window's start."""
        gc.collect()
        now = time.perf_counter()
        self.setup_s = now - self.t0
        return now

    def read_device(self):
        """The device readings, taken once the window has closed and
        before the reference runs."""
        import torch

        if self.device.type == "cuda":
            self.device_info = harness.device_info(torch, self.cell.chips)
        else:
            self.device_info = {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(args, root=HERE, bench_path=None, device=None, checkout=ROOT,
        t0=T0) -> dict:
    """One run of a cell; returns the result line as a dict.  ``root`` is
    the folder of the benchmark's files, ``checkout`` the root the
    configurations' data paths start from; a ``device`` given (the tests'
    CPU runs) skips the look for a card."""
    bench = harness.read_json(bench_path or os.path.join(ROOT,
                                                         "BENCHMARK.json"))
    cell = harness.Cell.find(bench, args.workload, root)
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise harness.BenchError("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise harness.BenchError(
                f"{cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    ctx = Ctx(cell, args.seed, args.seconds, args.trace, device, root,
              checkout, t0)
    out = cell.driver(root).run(ctx)
    checks = out["checks"]
    correct = bool(checks) and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    if ctx.traced:
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"], root).read(ctx.trace)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    device_info = dict(ctx.device_info)
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device_info}
    if ctx.traced:
        device_info["busy_s"] = ctx.trace.busy_s
        device_info["window_s"] = ctx.trace.window_s
        line["breakdown"] = {
            "device_ops": harness.top(ctx.trace.kernels),
            "idle_gaps": harness.top(ctx.trace.idle_by_span)}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    try:
        line = run(args)
    except harness.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
