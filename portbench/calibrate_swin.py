"""Readings that the limits of ``flylight_swin_unetr.train``'s ``correct``
are set from.

    python3 portbench/calibrate_swin.py --seeds <n> ... [--sides ...]

For each seed, on the chip at the cell's own size, the numbers that a
run compares (``drivers/train_swin_unetr.py``) for these sides:

- ``program``: the program, run as the benchmark runs it;
- ``control``: the reference put in the program's place and computed in
  TF32, the precision below the configuration's float32;
- the faults a later change could bring, planted in the program:
  ``half_batch`` (the losses of the first half of each batch only),
  ``frozen`` (an optimizer step that leaves the parameters as they
  were), ``no_shift_mask`` (the shifted blocks' region mask left out)
  and ``no_rel_bias`` (the relative-position bias left out).

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

CELL = "flylight_swin_unetr.train"
FAULTS = ("half_batch", "frozen", "no_shift_mask", "no_rel_bias")


class planted:
    """Within the block, the program carries the fault ``side`` (none
    for ``program``)."""

    def __init__(self, side: str, ses):
        self.side, self.ses = side, ses

    def __enter__(self):
        import torch

        from patchperpix_tpu_torch.models import swin_unetr
        from patchperpix_tpu_torch.train import trainer

        self.saved = (trainer.compute_losses, swin_unetr.region_mask,
                      swin_unetr.relative_bias)
        losses = trainer.compute_losses

        def half(model, mcfg, tcfg, raw, labels, *a, **kw):
            h = max(1, raw.shape[0] // 2)
            return losses(model, mcfg, tcfg, raw[:h], labels[:h], *a, **kw)

        if self.side == "half_batch":
            trainer.compute_losses = half
        elif self.side == "frozen":
            self.ses.opt.step = lambda *a, **kw: None
        elif self.side == "no_shift_mask":
            swin_unetr.region_mask = lambda regions, dtype: torch.zeros(
                (regions.shape[0], 1, 1), dtype=dtype, device=regions.device)
        elif self.side == "no_rel_bias":
            swin_unetr.relative_bias = lambda table, index: torch.zeros(
                (), dtype=table.dtype, device=table.device)
        return self

    def __exit__(self, *exc):
        from patchperpix_tpu_torch.models import swin_unetr
        from patchperpix_tpu_torch.train import trainer

        (trainer.compute_losses, swin_unetr.region_mask,
         swin_unetr.relative_bias) = self.saved
        return False


def readings(cell, checkout, dev, seeds, sides):
    """(side, seed, numbers) for each side asked for; ``control`` comes
    with ``program``'s record."""
    from patchperpix_tpu_torch.utils.device import exact_f32

    drv = cell.driver()
    cfg = cell.config
    lr = float(cfg["training"]["lr"])
    n = drv.CHECK_STEPS
    runs = [s for s in sides if s != "control"]
    if "control" in sides and "program" not in runs:
        runs.insert(0, "program")
    for seed in seeds:
        for side in runs:
            ses = drv.Session(cfg, checkout, dev, seed, harness.Spans(False))
            try:
                with planted(side, ses), exact_f32():
                    rec = ses.first_steps(n)
            finally:
                ses.close()
            ses.free_program()
            ref_b = ses.reference_batches(n)
            if side in sides:
                yield side, seed, drv.compare(rec, ref_b, ses.net_cfg, lr,
                                              dev)
            if side == "program" and "control" in sides:
                yield "control", seed, drv.compare(rec, ref_b, ses.net_cfg,
                                                   lr, dev, tf32=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sides", nargs="+",
                   default=["program", "control", *FAULTS])
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell.find(bench, CELL)
    for side, key, numbers in readings(cell, ROOT, dev, args.seeds,
                                       args.sides):
        print(json.dumps({"side": side, "at": key, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
