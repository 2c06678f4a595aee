"""The per-layer metrics read from the program's own spans and counters
(``patchperpix_tpu_torch/utils/trace.py``): a traced CPU run of the
training cell at the small sizes gives all seven, the step's four shares
account for the profiled window, and each reader gives nothing for a
program without spans."""

from __future__ import annotations

import builtins
import gc

import pytest

from conftest import TRAIN
from portbench import harness

SPLIT = ("forward_share.train", "backward_share.train",
         "optimizer_share.train", "between_steps_share.train")
NEW = SPLIT + ("prefetch_wait_share.train", "sampler_busy_share.train",
               "crop_accept_ratio.train")


def test_traced_run_splits_the_window_into_the_step_phases(run_cell):
    # the window opens with a garbage collection (``Ctx.open_window``),
    # which lies in no step: with the test process's heap frozen it takes
    # a few milliseconds, as in the benchmark's own process
    gc.collect()
    gc.freeze()
    try:
        line = run_cell(TRAIN, seconds=2.0, trace=1)
    finally:
        gc.unfreeze()
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(NEW) <= set(m)
    assert all(line["metrics"][k]["unit"] == "%" for k in NEW[:-1])
    assert 97.0 <= sum(m[k] for k in SPLIT) <= 101.0
    assert 0.0 < m["crop_accept_ratio.train"] <= 1.0
    assert 0.0 < m["sampler_busy_share.train"] < 100.0
    assert 0.0 <= m["prefetch_wait_share.train"] < 100.0


@pytest.mark.parametrize("metric", NEW)
def test_reader_gives_nothing_without_the_programs_spans(metric, small,
                                                         monkeypatch):
    real = builtins.__import__

    def no_trace(name, *a, **k):
        if name.startswith("patchperpix_tpu_torch.utils.trace"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    cell = harness.Cell.find(harness.read_json(small[1]), TRAIN, small[0])
    trace = harness.Trace(harness.Spans(True), window_s=10.0)
    assert cell.reader(metric, small[0]).read(trace) is None
