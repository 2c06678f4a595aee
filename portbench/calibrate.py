"""Readings that the limits of a cell's ``correct`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ...

For each seed, on the chip at the cell's own size, the numbers that a
run compares (``drivers/train_host_sampler.py``, ``reference/train.py``)
for three sides:

- ``program``: the program, run as the benchmark runs it;
- ``control``: the reference put in the program's place and computed in
  TF32, the precision below the configuration's float32
  (``reference/model.py``'s ``tf32``);
- the faults a later change could bring, planted in the program:
  ``half_batch`` (the losses of the first half of each batch only) and
  ``frozen`` (an optimizer step that leaves the parameters as they
  were).

One JSON line per side and seed.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402


def _control_record(rec, ref_batches, net_cfg, lr, dev):
    """The control's first steps in the program's record layout."""
    ctl = ref_train.reference_steps(net_cfg, rec["tree"], ref_batches,
                                    rec["gen_states"], dev, lr=lr,
                                    tf32=True)
    return dict(rec, batches=ref_batches, losses=ctl["losses"],
                grad1=ctl["grad1"], change=ctl["change"])


def train_readings(cell, checkout, dev, seeds):
    """(side, seed, numbers) for the program, the control and the faults."""
    from patchperpix_tpu_torch.train import trainer
    from patchperpix_tpu_torch.utils.device import exact_f32

    drv = cell.driver()
    cfg = cell.config
    lr = float(cfg["training"]["lr"])
    n = drv.CHECK_STEPS
    losses = trainer.compute_losses

    def half(model, mcfg, tcfg, raw, labels, *a, **kw):
        h = max(1, raw.shape[0] // 2)
        return losses(model, mcfg, tcfg, raw[:h], labels[:h], *a, **kw)

    for seed in seeds:
        for side in ("program", "half_batch", "frozen"):
            ses = drv.Session(cfg, checkout, dev, seed, harness.Spans(False))
            try:
                if side == "half_batch":
                    trainer.compute_losses = half
                if side == "frozen":
                    ses.opt.step = lambda *a, **kw: None
                with exact_f32():
                    rec = ses.first_steps(n)
            finally:
                trainer.compute_losses = losses
                ses.close()
            ses.free_program()
            ref_b = ses.reference_batches(n)
            yield side, seed, drv.compare(rec, ref_b, ses.net_cfg, lr, dev)
            if side == "program":
                yield "control", seed, drv.compare(
                    _control_record(rec, ref_b, ses.net_cfg, lr, dev),
                    ref_b, ses.net_cfg, lr, dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell.find(bench, args.workload)
    for side, key, numbers in train_readings(cell, ROOT, dev, args.seeds):
        print(json.dumps({"side": side, "at": key, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
