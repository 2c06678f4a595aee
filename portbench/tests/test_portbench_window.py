"""The window rule: a rate is all the work of the window over the whole
window, which closes at the end of the first chunk of steps that ends
after ``--seconds``."""

from __future__ import annotations

from conftest import TRAIN
from portbench import harness


def test_train_rate_over_all_steps_of_the_window(small, run_cell):
    cell = harness.Cell.find(harness.read_json(small[1]), TRAIN, small[0])
    chunk = cell.driver(small[0]).CHUNK_STEPS
    batch = cell.config["training"]["batch_size"]
    line = run_cell(TRAIN, seconds=1.0)
    assert line["correct"] is True
    # whole chunks only: the window ends after the chunk that passes 1 s
    assert line["attempted"] % chunk == 0 and line["attempted"] >= chunk
    rate = line["metrics"]["train_crops_per_s"]["value"]
    # crops of every step over the window, which lasts 1 s or more
    assert 0 < rate <= line["attempted"] * batch / 1.0
