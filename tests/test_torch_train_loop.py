"""The port's training loops on the CPU, at a tiny 2D size.

``train_until`` in both loops (host ``Prefetcher``, device
``DeviceSampler``): checkpoints at the JAX package's steps, resume from
the latest with the Adam state read back bit for bit, SWA counts, a
params-only checkpoint re-initialising the moments with a warning,
snapshots under the JAX keys, TensorBoard optional; the rows of
``train_log.jsonl`` carry the JAX package's keys at its steps (the JAX
``train_until`` runs the same intervals beside it).
"""

import json
import logging
import os
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.train import data as JD
from patchperpix_tpu.train import device_data as JDD
from patchperpix_tpu.train import trainer as JT
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.models import PPPConfig, PPPModel
from patchperpix_tpu_torch.train import data as TD
from patchperpix_tpu_torch.train.device_data import DeviceSampler
from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                 get_latest_checkpoint,
                                                 train_until)
from patchperpix_tpu_torch.utils import io as tio

torch.set_num_threads(1)

MODEL = dict(patchshape=(1, 5, 5), num_channels=1, num_fmaps=4,
             fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
             downsample_factors=((1, 2, 2),), train_code=True, code_units=8,
             ae_code_fmaps=2, ae_num_fmaps=(4, 8),
             ae_downsample_factors=((2, 2), (2, 2)), num_code_samples=8,
             overlapping_inst=True, padding="same")


def _toy(mod, seed=0, size=40):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, size, size), dtype=np.int32)
    labels[0, 5:18, 5:18] = 1
    labels[1, 14:28, 14:28] = 2
    raw = (labels.sum(0) > 0).astype(np.float32)[None]
    raw = np.clip(raw + 0.05 * rng.randn(1, size, size), 0, 1).astype(
        np.float32)
    return mod.SampleData(raw=raw, labels=labels,
                          fg_mask=np.any(labels > 0, axis=0),
                          overlap_mask=np.sum(labels > 0, axis=0) > 1)


def _scfg(mod, **kw):
    return mod.SamplerConfig(
        input_shape=(16, 16), output_shape=(16, 16), patchshape=(5, 5),
        batch_size=2, augment=mod.AugmentConfig(elastic=False,
                                                probability_overlay=0.0),
        **kw)


def _sampler(kind):
    samples = [_toy(TD, 0), _toy(TD, 1)]
    if kind == "device":
        return DeviceSampler(samples, _scfg(TD), max_gt_channels=2,
                             device="cpu")
    return TD.Prefetcher(TD.CropSampler(samples, _scfg(TD)), cache_size=2,
                         max_gt_channels=2)


def _rows(folder):
    with open(os.path.join(folder, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tcfg(folder, **kw):
    base = dict(max_iterations=6, checkpoints=2, snapshots=0, lr=3e-3,
                output_folder=str(folder), log_every=2, use_swa=True,
                swa_start=2, swa_freq=2, tensorboard=False)
    base.update(kw)
    return TrainConfig(**base)


def _same_state(a, b):
    assert a["step"] == b["step"]
    for key in ("params", "swa_params"):
        assert set(a[key]) == set(b[key])
        for k in a[key]:
            np.testing.assert_array_equal(a[key][k], b[key][k])
    oa, ob = a["opt_state"], b["opt_state"]
    assert {k: oa[k] for k in ("name", "schedule", "count")} == \
        {k: ob[k] for k in ("name", "schedule", "count")}
    for m in ("mu", "nu"):
        for k in oa[m]:
            np.testing.assert_array_equal(np.asarray(oa[m][k]),
                                          np.asarray(ob[m][k]))


@pytest.mark.parametrize("kind", ["device", "host"])
def test_train_until_checkpoints_resumes_round_trips(kind, tmp_path):
    cfg = PPPConfig(**MODEL)
    pf = _sampler(kind)
    state = train_until(PPPModel(cfg), cfg, _tcfg(tmp_path), pf,
                        device="cpu")
    assert state["step"] == 6 and state["swa_n"] == 3   # steps 2, 4, 6
    assert sorted(os.listdir(tmp_path)) == [
        "train_log.jsonl", "train_net_checkpoint_2",
        "train_net_checkpoint_4", "train_net_checkpoint_6"]
    path, step = get_latest_checkpoint(str(tmp_path))
    assert step == 6
    saved = weights.load_checkpoint(path)
    assert saved["opt_state"]["count"] == 6
    _same_state(state, saved)

    # resume: 6 -> 10 with the Adam state read back
    model = PPPModel(cfg)
    state2 = train_until(model, cfg, _tcfg(tmp_path, max_iterations=10), pf,
                         device="cpu")
    pf.stop()
    assert state2["step"] == 10 and state2["swa_n"] == 5
    assert state2["opt_state"]["count"] == 10
    _same_state(state2, weights.load_checkpoint(
        get_latest_checkpoint(str(tmp_path))[0]))
    assert not np.allclose(state2["params"]["params/head_code_affs/kernel"],
                           state2["swa_params"][
                               "params/head_code_affs/kernel"])
    # the module holds the final parameters
    sd = weights.to_state_dict(state2["params"])
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    rows = [r for r in _rows(tmp_path) if "loss" in r]
    assert [r["step"] for r in rows] == [1, 2, 4, 6, 8, 10]
    assert all(np.isfinite(r["loss"]) for r in rows)


def test_resume_reads_moments_back_exactly(tmp_path):
    """Training 0 -> 4 in one call equals 0 -> 2, resume, 2 -> 4 on the
    same batches (the host loop; the same corners from a fixed stream)."""
    cfg = PPPConfig(**dict(MODEL, train_code=False))

    class Fixed:
        def __init__(self):
            self.s = TD.CropSampler([_toy(TD)], _scfg(TD, seed=3))
            self.batches = [self.s.batch(2) for _ in range(4)]
            self.i = 0

        def next(self):
            self.i += 1
            return self.batches[self.i - 1]

        def stop(self):
            pass

    one = train_until(PPPModel(cfg), cfg, _tcfg(
        tmp_path / "a", max_iterations=4, use_swa=False), Fixed(),
        device="cpu")
    pf = Fixed()
    train_until(PPPModel(cfg), cfg, _tcfg(
        tmp_path / "b", max_iterations=2, use_swa=False), pf, device="cpu")
    two = train_until(PPPModel(cfg), cfg, _tcfg(
        tmp_path / "b", max_iterations=4, use_swa=False), pf, device="cpu")
    for k in one["params"]:
        np.testing.assert_array_equal(one["params"][k], two["params"][k])
    for k in one["opt_state"]["mu"]:
        np.testing.assert_array_equal(one["opt_state"]["nu"][k],
                                      two["opt_state"]["nu"][k])


def test_params_only_checkpoint_reinitialises_moments(tmp_path, caplog):
    cfg = PPPConfig(**MODEL)
    model = PPPModel(cfg)
    tree = weights.from_state_dict(model.state_dict())
    weights.write_checkpoint(tree, str(tmp_path), 0)
    with caplog.at_level(logging.WARNING):
        st = train_until(model, cfg, _tcfg(tmp_path, max_iterations=2,
                                           use_swa=False),
                         _sampler("device"), device="cpu")
    assert "reinitializing optimizer moments" in caplog.text
    assert st["opt_state"]["count"] == 2
    # started from the checkpoint's parameters, not a fresh init
    start = weights.load_checkpoint(
        os.path.join(str(tmp_path), "train_net_checkpoint_0"))["params"]
    k = "params/head_fgbg_numinst/kernel"
    assert np.abs(st["params"][k] - start[k]).max() < 0.1
    # another structure (SGD now): moments re-initialised, warned
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        st = train_until(PPPModel(cfg), cfg, _tcfg(
            tmp_path, max_iterations=3, use_swa=False, optimizer="sgd"),
            _sampler("device"), device="cpu")
    assert "structure changed" in caplog.text
    assert st["opt_state"]["count"] == 1 and "mu" not in st["opt_state"]


def test_snapshots_and_optional_tensorboard(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = PPPConfig(**MODEL)
    with caplog.at_level(logging.WARNING):
        train_until(PPPModel(cfg), cfg, _tcfg(
            tmp_path, max_iterations=2, snapshots=2, tensorboard=True),
            _sampler("device"), device="cpu")
    assert "tensorboard unavailable" in caplog.text
    assert not os.path.exists(tmp_path / "tb")
    io = tio.IoHDF5(str(tmp_path / "snapshots" / "snapshot_2.hdf"))
    assert io.read(key="volumes/raw").shape == (2, 1, 16, 16)
    assert io.read(key="volumes/gt_labels").shape == (2, 2, 20, 20)
    assert io.read(key="volumes/pred_head1").dtype == np.float16
    assert io.read(key="volumes/pred_head2").shape == (2, 3, 16, 16)
    # the JAX package's keys, read through h5py
    with h5py.File(tmp_path / "snapshots" / "snapshot_2.hdf", "r") as f:
        keys = []
        f.visititems(lambda k, v: keys.append(k)
                     if isinstance(v, h5py.Dataset) else None)
        assert sorted(keys) == ["volumes/gt_labels", "volumes/pred_head1",
                                "volumes/pred_head2", "volumes/raw"]
        for key in keys:
            np.testing.assert_array_equal(f[key][()], io.read(key=key))


@pytest.mark.parametrize("kind", ["device", "host"])
def test_log_rows_carry_jax_keys_at_jax_steps(kind, tmp_path):
    kw = dict(max_iterations=8, checkpoints=4, snapshots=0, lr=3e-3,
              log_every=2, val_log_step=4, tensorboard=False)
    jcfg = JConfig(**MODEL)
    if kind == "device":
        jpf = JDD.DeviceSampler([_toy(JD, 0), _toy(JD, 1)], _scfg(JD),
                                max_gt_channels=2)
    else:
        jpf = JD.Prefetcher(JD.CropSampler([_toy(JD, 0), _toy(JD, 1)],
                                           _scfg(JD)), max_gt_channels=2)
    jval = JD.CropSampler([_toy(JD, 1)], _scfg(JD))
    JT.train_until(JModel(jcfg), jcfg, JT.TrainConfig(
        output_folder=str(tmp_path / "jax"), **kw), jpf,
        val_batch_fn=lambda: jval.batch(2))
    jpf.stop()
    cfg = PPPConfig(**MODEL)
    tval = TD.CropSampler([_toy(TD, 1)], _scfg(TD))
    pf = _sampler(kind)
    train_until(PPPModel(cfg), cfg, TrainConfig(
        output_folder=str(tmp_path / "port"), **kw), pf,
        val_batch_fn=lambda: tval.batch(2), device="cpu")
    pf.stop()

    def shape(rows):
        return [(r["step"], sorted(r)) for r in rows]
    want, got = _rows(tmp_path / "jax"), _rows(tmp_path / "port")
    assert shape(got) == shape(want)
    assert [r["step"] for r in got if "loss" in r] == [1, 2, 4, 6, 8]
    assert [r["step"] for r in got if "val_loss" in r] == [4, 8]
    jax.clear_caches()
