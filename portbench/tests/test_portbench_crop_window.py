"""``crop_window_ratio.train``: the program's counters
``train.crops_windowed`` over ``train.crops``, read from a traced CPU run
of the small training cell (no elastic augmentation: every crop is
rendered in its windows) and from given counts; nothing for a program
without the counter."""

from __future__ import annotations

import pytest

from conftest import TRAIN
from portbench import harness

METRIC = "crop_window_ratio.train"


def _reader(small):
    cell = harness.Cell.find(harness.read_json(small[1]), TRAIN, small[0])
    return cell.reader(METRIC, small[0])


@pytest.mark.parametrize("counts, want", [
    ({"train.crops": 8, "train.crops_drawn": 9,
      "train.crops_windowed": 6}, 0.75),
    ({"train.crops": 8, "train.crops_windowed": 8}, 1.0),
    ({"train.crops": 8, "train.crops_drawn": 8}, None),
    ({}, None),
])
def test_reads_the_counters_ratio(counts, want, small, monkeypatch):
    from patchperpix_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "summary", lambda: {"counts": counts})
    assert _reader(small).read(harness.Trace(harness.Spans(True),
                                             window_s=10.0)) == want


def test_traced_run_renders_every_crop_in_its_windows(run_cell):
    line = run_cell(TRAIN, seconds=1.0, trace=1)
    assert line["metrics"][METRIC] == {"value": 1.0, "unit": "1"}


def test_nothing_without_the_programs_counters(small, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_trace(name, *a, **k):
        if name.startswith("patchperpix_tpu_torch.utils.trace"):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert _reader(small).read(harness.Trace(harness.Spans(True),
                                             window_s=10.0)) is None
