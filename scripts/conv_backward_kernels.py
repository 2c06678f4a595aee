"""Which device kernels compute the backward of each convolution of the
benchmark's training step (``flylight_ppp_dec.train``): the cell's own
set-up and step (``portbench/drivers/train_host_sampler.py``
``Session``), float32 with TF32 off, profiled with ``record_shapes``
over a few steps after warm steps.  Each kernel is charged to the
convolution whose backward launched it: the ``aten::convolution_backward``
call above it (cuDNN's weight and data gradients), or the route's
autograd Function (the weight-gradient kernels of ``ops/conv_kernels.py``,
launched from ``_HandWgradBackward`` / ``_GemmWgradBackward``), charged
to the convolution of the input gradient it asks cuDNN for, or to the
Function's name where it asks for none.  Prints the card's name and power
limit and one JSON line per convolution (input and weight shapes, the
kernels with their ms per step) and a total per kernel name.

``--root DIR`` runs the package and benchmark of another checkout (an
earlier commit unpacked with ``git archive``), with this script.

Run: python scripts/conv_backward_kernels.py [--root DIR] [--steps 3]
"""

import argparse
import collections
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 4


def conv_of(evt):
    """The convolution a backward call serves, from its recorded shapes:
    (input shape, weight shape), or None for another call."""
    if evt.name == "aten::convolution_backward":
        return tuple(evt.input_shapes[1]), tuple(evt.input_shapes[2])
    return None


def charge(events) -> dict:
    """{(input shape, weight shape) or the call's name: {kernel: ms}} over
    the trees of ``events``: each kernel under the nearest convolution
    backward above it, else under the nearest call named ``*Backward*``
    (an autograd Function's backward; a route's ``*Wgrad*`` Function under
    the first convolution backward inside it, where there is one)."""
    out = collections.defaultdict(lambda: collections.defaultdict(float))

    def first_conv(evt):
        own = conv_of(evt)
        if own is not None:
            return own
        for c in evt.cpu_children:
            own = first_conv(c)
            if own is not None:
                return own
        return None

    def walk(evt, key):
        own = conv_of(evt)
        if own is not None:
            key = own
        elif key is None and "Backward" in evt.name:
            key = (first_conv(evt) if "Wgrad" in evt.name else None) \
                or evt.name
        for k in evt.kernels:
            out[key if key is not None else "other"][k.name] += \
                k.duration / 1e3
        for c in evt.cpu_children:
            walk(c, key)

    for evt in events:
        if evt.cpu_parent is None:
            walk(evt, None)
    return out


class _NoSpans:
    def span(self, name):
        import contextlib

        return contextlib.nullcontext()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=4170000101)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    from portbench import harness
    from portbench.drivers import train_host_sampler as drv
    from patchperpix_tpu_torch.utils.device import exact_f32

    if not torch.cuda.is_available():
        print("conv_backward_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    cell = harness.Cell.find(bench, "flylight_ppp_dec.train", root=os.path.join(root, "portbench"))
    dev = torch.device("cuda", 0)
    ses = drv.Session(cell.config, root, dev, args.seed, _NoSpans())
    try:
        with exact_f32():
            for _ in range(WARM):
                ses.one()
            torch.cuda.synchronize(dev)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU,
                                torch.profiler.ProfilerActivity.CUDA],
                    record_shapes=True) as prof:
                for _ in range(args.steps):
                    ses.one()
                torch.cuda.synchronize(dev)
    finally:
        ses.close()
    table = charge(prof.events())
    totals = collections.defaultdict(float)
    for key, kernels in sorted(table.items(), key=lambda kv: str(kv[0])):
        per_step = {k: v / args.steps for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1])}
        for k, v in per_step.items():
            totals[k] += v
        if isinstance(key, tuple):
            row = {"input": key[0], "weight": key[1]}
        else:
            row = {"call": key}
        print(json.dumps({**row, "ms_per_step": per_step}), flush=True)
    print(json.dumps({"total_ms_per_step": dict(sorted(
        totals.items(), key=lambda kv: -kv[1]))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
