"""Host cost of the port's spans and counters (``utils/trace.py``).

    python3 scripts/trace_cost.py [--device cuda] [--n 20000]
        [--step-ms 551]

Times ``--n`` spans around an empty block, nested two deep as the
training step's are, and ``--n`` counts, with no profiler running
(recording off: one check each) and inside a ``torch.profiler`` session
over the CPU and, on a card, CUDA (recording on: a ``record_function``
range, the host clock and two timing events on the device's current
stream), then ``summary()``.  Prints one JSON line: microseconds per
span and per count each way, and what the loop thread's five spans of a
training step (``train.step``, ``train.forward``, ``train.backward``,
``train.optimizer``, ``train.data_wait``) cost as a share of a step of
``--step-ms`` milliseconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def per_call_us(fn, n: int) -> float:
    t = time.perf_counter()
    fn(n)
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    import torch

    from patchperpix_tpu_torch.utils import trace

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n", type=int, default=20000)
    p.add_argument("--step-ms", type=float, default=551.0)
    a = p.parse_args(argv)
    dev = torch.device(a.device)

    def spans(n):      # n spans: n / 2 parents, each with one child
        for _ in range(n // 2):
            with trace.span("cost.outer", dev, step=1):
                with trace.span("cost.inner", dev):
                    pass

    def counts(n):
        for _ in range(n):
            trace.count("cost.n")

    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.init()
    spans(200)
    off = {"span_us": per_call_us(spans, a.n),
           "count_us": per_call_us(counts, a.n)}
    with torch.profiler.profile(activities=acts):
        spans(200)
        on = {"span_us": per_call_us(spans, a.n),
              "count_us": per_call_us(counts, a.n)}
    t = time.perf_counter()
    s = trace.summary()
    on["summary_s"] = time.perf_counter() - t
    assert s["spans"]["cost.inner"]["count"] == (a.n + 200) // 2
    print(json.dumps({
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "n": a.n, "off": off, "on": on,
        "step_ms": a.step_ms,
        "loop_spans_per_step": 5,
        "on_share_of_step_pct": 100.0 * 5 * on["span_us"] * 1e-3
        / a.step_ms,
        "off_share_of_step_pct": 100.0 * 5 * off["span_us"] * 1e-3
        / a.step_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
