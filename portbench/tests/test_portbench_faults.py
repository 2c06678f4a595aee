"""A whole run, the look for a card skipped, with the timed path broken
underneath: ``correct`` comes out false for each fault the cell can
have, and true without one."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TRAIN


def test_sound_run_is_correct(run_cell):
    line = run_cell(TRAIN, seed=2 ** 31 + 11)
    assert line["correct"] is True, line["checks"]


def test_batch_altered_where_produced(run_cell, monkeypatch):
    """One voxel of each batch's raw crop changed as the data layer hands
    the batch over."""
    from patchperpix_tpu_torch.train import data as train_data

    real = train_data.Prefetcher.next

    def altered(self):
        b = real(self)
        raw = np.array(b[0], copy=True)
        raw.reshape(-1)[0] += 0.5
        return (raw,) + tuple(b[1:])

    monkeypatch.setattr(train_data.Prefetcher, "next", altered)
    line = run_cell(TRAIN)
    assert line["correct"] is False
    assert line["checks"]["data_err"]["value"] > 0


def test_step_returns_its_state_unchanged(run_cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    line = run_cell(TRAIN)
    assert line["correct"] is False
    assert line["checks"]["change_err"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(run_cell, monkeypatch):
    """The losses of the first half of each batch only, the mean taken
    over it."""
    from patchperpix_tpu_torch.train import trainer

    real = trainer.compute_losses

    def half(model, mcfg, tcfg, raw, labels, *a, **kw):
        h = max(1, raw.shape[0] // 2)
        return real(model, mcfg, tcfg, raw[:h], labels[:h], *a, **kw)

    monkeypatch.setattr(trainer, "compute_losses", half)
    line = run_cell(TRAIN)
    assert line["correct"] is False
