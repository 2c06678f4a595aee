"""The control: the reference put in the program's place and computed in
TF32, the precision below the configuration's float32, fails the
comparison, as do the planted faults; the program passes it.  On the CPU
at the small sizes (TF32 emulated by rounding), and on the card at the
cell's own size over three seeds (``calibrate.py``)."""

from __future__ import annotations

import os

import pytest

from conftest import ROOT, TRAIN
from portbench import calibrate, harness


def _cell(small, name):
    return harness.Cell.find(harness.read_json(small[1]), name, small[0])


def _fails(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items())


def test_control_and_faults_fail_train_small(small):
    import torch

    cell = _cell(small, TRAIN)
    rows = list(calibrate.train_readings(cell, ROOT, torch.device("cpu"),
                                         [3]))
    limits = cell.config["limits"]
    sides = {s: n for s, _, n in rows}
    assert set(sides) == {"program", "control", "half_batch", "frozen"}
    assert not _fails(sides["program"], limits)
    for s in ("control", "half_batch", "frozen"):
        assert _fails(sides[s], limits), s


SEEDS = (101, 202, 303)


@pytest.mark.cuda
def test_control_fails_at_full_size(card):
    bench = harness.read_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell.find(bench, TRAIN)
    limits = cell.config["limits"]
    rows = list(calibrate.train_readings(cell, ROOT, card, SEEDS))
    assert all(not _fails(n, limits) for s, _, n in rows if s == "program")
    assert all(_fails(n, limits) for s, _, n in rows if s != "program")
