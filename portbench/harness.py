"""What every cell of the port's benchmark shares: finding its files by
name, the window, host spans, the traced window's device timeline, and
the result line.

The harness is driven by data.  A cell of ``BENCHMARK.json`` names a
configuration and a traffic mix; the configuration is
``configs/<config>.json``, the mix ``traffic/<traffic>.json``, whose
``driver`` key names the code that runs it, ``drivers/<driver>.py``; a
per-layer metric is ``metrics/<metric>.py``, a reader with a function
``read(trace) -> float | None``.  Nothing here lists them.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "patchperpix_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file, a
    forbidden module); the runner prints it and exits with code 2."""


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file of the benchmark as a module under ``name``."""
    if not os.path.isfile(path):
        raise BenchError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One cell as ``BENCHMARK.json`` and its files define it."""
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, bench: dict, name: str, root: str = HERE) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise BenchError(f"no cell {name!r} in BENCHMARK.json")
        w = cells[name]

        def mine(m):
            return name in m.get("workloads", (name,))

        return cls(
            name=name, chips=int(w["chips"]),
            config=read_json(os.path.join(root, "configs",
                                          w["config"] + ".json")),
            traffic=read_json(os.path.join(root, "traffic",
                                           w["traffic"] + ".json")),
            end_to_end=[m for m in bench["end_to_end"] if mine(m)],
            per_layer=[m for m in bench["per_layer"] if mine(m)])

    def driver(self, root: str = HERE):
        d = self.traffic["driver"]
        return load_module(os.path.join(root, "drivers", d + ".py"),
                           "portbench_driver_" + d)

    def reader(self, metric: str, root: str = HERE):
        return load_module(os.path.join(root, "metrics", metric + ".py"),
                           "portbench_metric_" + metric.replace(".", "_"))


class Spans:
    """Host spans of the traced run: seconds per name, and, when
    a profiler is running, a ``record_function`` range of the same name
    so that idle device time can be charged to what the host was doing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.seconds: dict = {}

    def span(self, name: str):
        """Context manager timing a block; a no-op when tracing is off."""
        return _Span(self, name)

    def add(self, name: str, seconds: float):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        if not self.spans.enabled:
            return self
        import torch

        self.rf = torch.profiler.record_function("pb:" + self.name)
        self.rf.__enter__()
        self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.spans.enabled:
            return False
        self.spans.add(self.name, time.perf_counter() - self.t)
        self.rf.__exit__(*exc)
        return False


@dataclass
class Trace:
    """What the per-layer readers read: the host spans, the program's own
    counters and stage times, the device timeline of the traced window,
    and the cell's counts (work done, FLOPs, bytes)."""
    spans: Spans
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)   # name -> device seconds
    idle_by_span: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)


class DeviceTimeline:
    """``torch.profiler`` over the traced window: the union of the device
    kernels' intervals (busy), seconds by kernel name, and the idle gaps
    charged to the innermost benchmark span that covers their middle.

    The profile covers the window's first ``seconds`` (then the first
    chunk of steps that ends after them closes it, ``tick``), so that
    reading it keeps a traced run short; ``window_s`` and ``items`` are
    the profiled part's length and the steps done in it."""

    def __init__(self, enabled: bool, seconds: float | None = None):
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.window_s = 0.0
        self.items = 0

    def __enter__(self):
        if self.enabled:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        return self

    def tick(self, items: int, last: bool = False):
        """After each step or chunk whose device work has ended (``items``
        done so far): close the profile once its seconds have passed, or
        at the window's ``last`` item."""
        if self.prof is None or self.window_s:
            return
        if last or (self.seconds is not None and
                    time.perf_counter() - self.t0 >= self.seconds):
            self.window_s = time.perf_counter() - self.t0
            self.items = items
            self.prof.__exit__(None, None, None)

    def __exit__(self, *exc):
        if self.prof is not None and not self.window_s:
            self.prof.__exit__(*exc)
        return False

    def read(self, trace: Trace):
        """Fill ``trace`` from the profile: window_s, busy_s, kernels,
        idle_by_span."""
        if self.prof is None:
            return
        trace.window_s = self.window_s
        dev, host = [], []
        for e in self.prof.events():
            span = e.name.startswith("pb:")
            if e.device_type.name == "CUDA":
                # a record_function range also leaves an annotation on the
                # device's timeline: it is no device work
                if not span and not getattr(e, "is_user_annotation", False):
                    dev.append((e.time_range.start, e.time_range.end,
                                e.name))
            elif span:
                host.append((e.time_range.start, e.time_range.end,
                             e.name[3:]))
        dev.sort()
        busy, kern = 0.0, {}
        gaps = []
        cur_s = cur_e = None
        for s, e, name in dev:
            kern[name] = kern.get(name, 0.0) + (e - s) * 1e-6
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        trace.busy_s = busy * 1e-6
        trace.kernels = kern
        host.sort()
        starts = [s for s, _, _ in host]
        idle = {}
        for gs, ge in gaps:
            mid = 0.5 * (gs + ge)
            inner, width = "none", None
            # spans nest only a few deep: the covering ones start shortly
            # before the gap's middle
            i = bisect.bisect_right(starts, mid) - 1
            for s, e, name in host[max(0, i - 8):i + 1]:
                if e >= mid and (width is None or e - s < width):
                    inner, width = name, e - s
            idle[inner] = idle.get(inner, 0.0) + (ge - gs) * 1e-6
        trace.idle_by_span = idle


def device_info(torch, chips: int) -> dict:
    """The result line's ``device`` of a run on ``chips`` cards."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def top(items: dict, n: int = 10) -> list:
    """The n largest entries of a {name: seconds} dict as [[name, s]]."""
    return [[k, v] for k, v in sorted(items.items(), key=lambda kv: -kv[1])
            [:n]]
