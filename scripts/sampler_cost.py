"""Host cost of one batch of the training cell's crop sampler, on the CPU.

    python3 scripts/sampler_cost.py [--batches 6] [--seed 2718281829]
        [--config portbench/configs/flylight_ppp_dec.json]

Builds the benchmark's training sample as its driver does (the committed
FlyLight crop reflected to the configuration's extent through
``portbench/data.py``, at a phase drawn from the seed) and the sampler
settings of the configuration (batch 2 of 140^3 crops with overlay,
permute, hue and ``min_masked`` for ``flylight_ppp_dec``).  Then draws
``--batches`` batches in turns from the program's ``CropSampler`` and
from ``portbench/reference/sampler.py`` (the frozen full-extent path),
under one sampler seed, and checks that they are equal element for
element.  Prints one JSON line: seconds a batch of each (median and
each batch), their ratio, the elements that differ (0 when equal) and
the host's CPU.  No cell runs this; the timing is of this host's cores.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--config", default=os.path.join(
        ROOT, "portbench", "configs", "flylight_ppp_dec.json"))
    args = ap.parse_args(argv)

    from patchperpix_tpu_torch.train import data as program
    from portbench import data, harness
    from portbench.reference import sampler as reference

    driver = harness.load_module(
        os.path.join(ROOT, "portbench", "drivers", "train_host_sampler.py"),
        "sampler_cost_driver")
    cfg = harness.read_json(args.config)
    s_phase, s_sampler = data.seeds(args.seed, 2)
    raw0, lab0 = data.load_sample(cfg["data"], ROOT)
    phase = np.random.RandomState(s_phase).randint(
        0, 2 * np.asarray(raw0.shape[1:]))
    raw = data.reflect_to(raw0, cfg["data"]["reflect_to"], phase)
    labels = data.reflect_to(lab0, cfg["data"]["reflect_to"], phase)
    augment, sampling = driver.sampler_settings(
        cfg, cfg["train_input_shape"], cfg["train_output_shape"], s_sampler)
    max_gt = labels.shape[0] * (2 if augment["probability_overlay"] > 0
                                else 1)
    inst = labels > 0
    t = time.perf_counter()
    prog = program.CropSampler(
        [program.SampleData(raw=raw, labels=labels, fg_mask=inst.any(0),
                            overlap_mask=inst.sum(0, dtype=np.uint8) > 1)],
        program.SamplerConfig(augment=program.AugmentConfig(**augment),
                              **sampling))
    init_s = time.perf_counter() - t
    ref = reference.CropSampler(
        [reference.Sample.of(raw, labels)],
        reference.SamplerConfig(augment=reference.AugmentConfig(**augment),
                                **sampling))

    times = {"program": [], "reference": []}
    differ = 0
    for _ in range(args.batches):
        got = {}
        for name, smp in (("program", prog), ("reference", ref)):
            t = time.perf_counter()
            got[name] = smp.batch(max_gt)
            times[name].append(time.perf_counter() - t)
        for a, b in zip(got["program"], got["reference"]):
            differ += (int(np.count_nonzero(a != b)) if a.shape == b.shape
                       else max(a.size, b.size))
    med = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({
        "batch": [int(sampling["batch_size"]), int(raw.shape[0])]
        + [int(v) for v in sampling["input_shape"]],
        "program_s": med["program"], "reference_s": med["reference"],
        "speedup": med["reference"] / med["program"],
        "program_batches_s": times["program"],
        "reference_batches_s": times["reference"],
        "program_init_s": init_s, "elements_differ": differ,
        "cpu": platform.processor() or platform.machine(),
        "cores": os.cpu_count()}))
    return 0 if differ == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
