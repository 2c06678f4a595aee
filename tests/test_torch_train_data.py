"""The port's training data vs the JAX package's, on the CPU.

- The host ``CropSampler`` is numpy in both packages: under one seed the
  port's batches equal the JAX package's draw for draw, through every
  augmentation (mirror, transpose, elastic, overlay, permute, hue,
  intensity, min_masked rejection, the point-balanced overlap pool).
  The port renders a crop only in its output windows (elastic aside),
  the JAX package at the union extent: equal over 2D and 3D, borders,
  odd margins, labels wider than raw, unequal axes, 1-4 raw channels and
  overlay channels beyond ``max_gt``; the counter
  ``train.crops_windowed`` counts the windowed crops.
- ``load_sample``'s partly flag and overlap CSV; the ``Prefetcher``
  surfacing a sampler error in the caller.
- The device sampler (run here on CPU tensors) on the JAX package's
  device-sampler cases: unsupported configs, shapes and value range,
  foreground bias, centre semantics against host padding, mirror and
  transpose preserving the label multiset, the partly flag and the
  weighted overlap pool; its ``apply`` on given decisions equals the host
  sampler's ``_crop_at`` / ``np.flip`` / ``np.transpose`` path exactly,
  and one generator seed gives one batch.
"""

import numpy as np
import pytest
import torch

from patchperpix_tpu.train import data as JD
from patchperpix_tpu_torch.train import data as TD
from patchperpix_tpu_torch.train.device_data import (DeviceSampler,
                                                     device_sampler_supported)
from patchperpix_tpu_torch.utils import io as tio

torch.set_num_threads(1)


def _toy(mod, seed=0, size=40, channels=1):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, size, size), dtype=np.int32)
    labels[0, 5:18, 5:18] = 1
    labels[1, 14:28, 14:28] = 2
    raw = np.repeat((labels.sum(0) > 0).astype(np.float32)[None],
                    channels, 0)
    raw += 0.05 * rng.randn(channels, size, size).astype(np.float32)
    raw = np.clip(raw, 0, 1)
    return mod.SampleData(raw=raw, labels=labels,
                          fg_mask=np.any(labels > 0, axis=0),
                          overlap_mask=np.sum(labels > 0, axis=0) > 1)


def _toy3d(mod, seed=0, shape=(14, 15, 16), channels=3):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2,) + shape, np.int32)
    labels[0, 2:9, 3:10, 1:12] = 1
    labels[1, 6:13, 5:14, 8:15] = 2
    raw = rng.rand(channels, *shape).astype(np.float32)
    return mod.SampleData(raw=raw, labels=labels,
                          fg_mask=np.any(labels > 0, axis=0),
                          overlap_mask=np.sum(labels > 0, axis=0) > 1)


HOST_CASES = {
    "simple": dict(augment=dict(probability_overlay=0.0)),
    "overlay": dict(augment=dict(probability_overlay=0.5)),
    "elastic": dict(augment=dict(elastic=True, jitter_sigma=(1.0, 1.0),
                                 control_point_spacing=(8, 8))),
    "colour": dict(channels=3, augment=dict(probability_permute=0.5,
                                            probability_hue=0.5)),
    "min_masked": dict(min_masked=0.2, augment=dict()),
    "balanced": dict(points=True, point_balance_radius=3.0,
                     probability_fg=0.2, probability_overlap=0.7,
                     augment=dict()),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_crop_sampler_equals_jax_draw_for_draw(case):
    kw = dict(HOST_CASES[case])
    channels = kw.pop("channels", 1)
    points = kw.pop("points", False)
    aug = kw.pop("augment")
    batches = []
    for mod in (JD, TD):
        samples = [_toy(mod, 0, channels=channels),
                   _toy(mod, 1, channels=channels)]
        samples[1].partly = True
        if points:
            samples[1].overlap_points = np.array(
                [[15, 15], [15, 16], [16, 15], [16, 16], [30, 30]])
        cfg = mod.SamplerConfig(
            input_shape=(32, 32), output_shape=(16, 16), patchshape=(5, 5),
            batch_size=3, seed=7, augment=mod.AugmentConfig(**aug), **kw)
        s = mod.CropSampler(samples, cfg)
        batches.append([s.batch(max_gt_channels=4, with_partly=True)
                        for _ in range(3)])
    for want, got in zip(*batches):
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    raw, labels, partly = batches[1][0]
    assert raw.shape == (3, channels, 32, 32)
    assert labels.shape == (3, 4, 20, 20) and partly.dtype == bool


def _volume(mod, seed, shape, channels, gt_channels, partly=False):
    """Random raw and up to ``gt_channels`` boxes of labels 1-8, one box
    per channel, some of them touching the volume's border."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((gt_channels,) + shape, np.int32)
    for c in range(gt_channels):
        lo = [rng.randint(0, s // 2) for s in shape]
        hi = [a + rng.randint(2, s // 2 + 2) for a, s in zip(lo, shape)]
        labels[(c,) + tuple(slice(a, b) for a, b in zip(lo, hi))] = \
            rng.randint(1, 9)
    raw = rng.rand(channels, *shape).astype(np.float32)
    return mod.SampleData(raw=raw, labels=labels,
                          fg_mask=np.any(labels > 0, axis=0),
                          overlap_mask=np.sum(labels > 0, axis=0) > 1,
                          partly=partly)


# (volume, input, output, patch, raw channels, gt channels, max_gt, config)
WINDOW_CASES = {
    # crops at the border of volumes barely larger than the crop
    "3d_overlay_border": ((14, 15, 16), (12, 12, 12), (6, 6, 6), (3, 3, 3),
                          3, 2, 4, dict(min_masked=0.2, augment=dict(
                              probability_overlay=0.5,
                              probability_permute=0.5,
                              probability_hue=0.5))),
    "2d": ((30, 26), (24, 24), (12, 12), (5, 5), 1, 2, 4,
           dict(augment=dict(probability_overlay=0.5))),
    "label_larger": ((16, 18, 17), (10, 10, 10), (10, 10, 10), (3, 3, 3),
                     2, 2, 4, dict(augment=dict(probability_overlay=0.5,
                                                probability_permute=0.5))),
    "odd_margins": ((20, 20, 20), (13, 13, 13), (6, 6, 6), (3, 3, 3), 3,
                    1, 2, dict(augment=dict(probability_overlay=0.5,
                                            probability_hue=1.0))),
    "odd_margin_label_larger": ((24, 22), (9, 9), (10, 10), (3, 3), 2, 2, 4,
                                dict(augment=dict(probability_overlay=0.5))),
    "non_cubic": ((15, 18, 18), (8, 12, 12), (4, 8, 8), (3, 3, 3), 4, 2, 4,
                  dict(min_masked=0.05, augment=dict(
                      probability_overlay=0.5, probability_permute=0.5,
                      probability_hue=0.5))),
    # the overlaid crop's channels beyond max_gt are dropped
    "overlay_beyond_max_gt": ((16, 16, 16), (12, 12, 12), (6, 6, 6),
                              (3, 3, 3), 3, 2, 3,
                              dict(augment=dict(probability_overlay=1.0,
                                                probability_hue=0.5))),
    "no_mirror_transpose": ((18, 18), (16, 16), (8, 8), (5, 5), 3, 2, 4,
                            dict(augment=dict(mirror=False, transpose=False,
                                              probability_overlay=0.5))),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_windowed_crops_equal_jax_element_for_element(case):
    """The port renders each crop only in its output windows; the JAX
    package makes it at the union extent: over several seeds and
    batches their batches and partly flags are equal."""
    vol, inp, out, ps, ch, gt, max_gt, kw = WINDOW_CASES[case]
    kw = dict(kw)
    aug = kw.pop("augment")
    for seed in (0, 1, 2):
        batches = []
        for mod in (JD, TD):
            samples = [_volume(mod, 10 * seed, vol, ch, gt),
                       _volume(mod, 10 * seed + 1,
                               tuple(v + 3 for v in vol), ch, gt,
                               partly=True)]
            cfg = mod.SamplerConfig(
                input_shape=inp, output_shape=out, patchshape=ps,
                batch_size=3, seed=seed,
                augment=mod.AugmentConfig(**aug), **kw)
            s = mod.CropSampler(samples, cfg)
            batches.append([s.batch(max_gt_channels=max_gt,
                                    with_partly=True) for _ in range(3)])
        for want, got in zip(*batches):
            for w, g in zip(want, got):
                assert g.shape == w.shape and g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    label_shape = tuple(o + 2 * (p // 2) for o, p in zip(out, ps))
    assert got[0].shape == (3, ch) + inp
    assert got[1].shape == (3, max_gt) + label_shape


@pytest.mark.parametrize("elastic", [False, True])
def test_crops_windowed_counts_the_window_path(elastic):
    from patchperpix_tpu_torch.utils import trace

    aug = TD.AugmentConfig(elastic=elastic, jitter_sigma=(1.0, 1.0),
                           control_point_spacing=(8, 8),
                           probability_overlay=0.5)
    cfg = TD.SamplerConfig(input_shape=(32, 32), output_shape=(16, 16),
                           patchshape=(5, 5), batch_size=3, seed=5,
                           min_masked=0.2, augment=aug)
    s = TD.CropSampler([_toy(TD, 0), _toy(TD, 1)], cfg)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            s.batch(4)
    counts = trace.summary()["counts"]
    assert counts["train.crops"] == 6
    assert counts["train.crops_drawn"] >= 6
    assert counts.get("train.crops_windowed", 0) == (0 if elastic else 6)


def test_load_sample_partly_and_overlap_csv(tmp_path):
    sd = _toy(TD)
    path = str(tmp_path / "partly_x.zarr")
    io = tio.IoZarr(path, mode="w")
    for key, arr in (("volumes/raw", sd.raw),
                     ("volumes/gt_instances", sd.labels.astype(np.uint8))):
        io.create(key, arr.shape, arr.dtype)
        io.write(arr, key=key)
    io.close()
    csv = tmp_path / "pts.csv"
    csv.write_text("3,4\n10,12\n")
    for mod in (JD, TD):
        got = mod.load_sample(path, "volumes/raw", "volumes/gt_instances",
                              overlap_csv=str(csv))
        assert got.partly
        np.testing.assert_array_equal(got.overlap_points, [[3, 4], [10, 12]])
        assert not mod.load_sample(path, "volumes/raw",
                                   "volumes/gt_instances",
                                   partly=False).partly
    np.testing.assert_array_equal(
        TD.load_sample(path, "volumes/raw", "volumes/gt_instances").labels,
        JD.load_sample(path, "volumes/raw", "volumes/gt_instances").labels)


def test_prefetcher_propagates_sampler_error():
    class Bad:
        def batch(self, *a, **k):
            raise ValueError("boom")

    pf = TD.Prefetcher(Bad(), cache_size=2)
    with pytest.raises(RuntimeError, match="sampler thread failed"):
        pf.next()
    pf.stop()


def test_prefetcher_serves_the_sampler_batches():
    cfg = TD.SamplerConfig(input_shape=(32, 32), output_shape=(16, 16),
                           patchshape=(5, 5), batch_size=2, seed=3)
    pf = TD.Prefetcher(TD.CropSampler([_toy(TD)], cfg), cache_size=2,
                       max_gt_channels=4, with_partly=True)
    got = pf.next()
    pf.stop()
    want = TD.CropSampler([_toy(TD)], cfg).batch(4, with_partly=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the device sampler --------------------------------------------------------

def _cfg(**kw):
    base = dict(input_shape=(32, 32), output_shape=(32, 32),
                patchshape=(5, 5), batch_size=3,
                augment=TD.AugmentConfig(elastic=False,
                                         probability_overlay=0.0))
    base.update(kw)
    return TD.SamplerConfig(**base)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_unsupported_configs_go_to_the_host_sampler():
    from patchperpix_tpu.train.device_data import \
        device_sampler_supported as j_supported

    for cfg, reason in (
            (_cfg(augment=TD.AugmentConfig(elastic=True)),
             "elastic augmentation"),
            (_cfg(augment=TD.AugmentConfig(probability_overlay=0.5)),
             "overlay augmentation"),
            (_cfg(min_masked=0.5), "min_masked rejection sampling"),
            (_cfg(), None)):
        assert device_sampler_supported(cfg) == reason
        assert j_supported(cfg) == reason
    with pytest.raises(ValueError, match="unsupported"):
        DeviceSampler([_toy(TD)], _cfg(min_masked=0.5), device="cpu")


def test_batch_shapes_and_values():
    ds = DeviceSampler([_toy(TD, 0), _toy(TD, 1)], _cfg(),
                       max_gt_channels=4, device="cpu")
    raw, labels, partly = ds.sample_batch(_gen(0))
    assert raw.shape == (3, 1, 32, 32) and raw.dtype == torch.float32
    assert labels.shape == (3, 4, 36, 36) and labels.dtype == torch.int32
    assert partly.shape == (3,) and partly.dtype == torch.bool
    assert raw.min() >= 0 and raw.max() <= 1
    assert set(np.unique(labels.numpy())) <= {0, 1, 2}
    # one generator seed, one batch
    raw2, labels2, _ = ds.sample_batch(_gen(0))
    assert torch.equal(raw, raw2) and torch.equal(labels, labels2)
    raw3, _, _ = ds.sample_batch(_gen(1))
    assert not torch.equal(raw, raw3)


def test_fg_bias_on_device():
    ds = DeviceSampler([_toy(TD)], _cfg(probability_fg=1.0,
                                        probability_overlap=0.0,
                                        probability_random=0.0),
                       device="cpu")
    hits = 0
    for i in range(8):
        _, labels, _ = ds.sample_batch(_gen(i))
        # the centre voxel is big // 2, or big // 2 - 1 along a flipped
        # axis of even extent
        c = labels.shape[-1] // 2
        hits += int((labels[:, :, c - 1:c + 1, c - 1:c + 1] > 0).flatten(
            1).any(dim=1).sum())
    assert hits == 24     # every crop centred on a foreground voxel


def test_center_semantics_match_host_padding():
    """A crop centred at voxel (0, 0) zero-pads like CropSampler._crop_at."""
    s = _toy(TD)
    ds = DeviceSampler([s], _cfg(), device="cpu")
    big = tuple(int(b) for b in ds.big)
    raw = ds._window(ds.raw_all, torch.zeros(1, dtype=torch.long),
                     torch.zeros((1, 2), dtype=torch.long), big)[0]
    host = TD.CropSampler([s], _cfg())._crop_at(s.raw, np.zeros(2, int),
                                                np.array(big))
    np.testing.assert_array_equal(raw.numpy(), host)
    half = big[0] // 2
    assert float(raw[0, :half, :half].abs().max()) == 0.0
    assert float(raw[0, half, half]) == float(s.raw[0, 0, 0])


def test_mirror_transpose_preserve_multiset():
    s = _toy(TD, size=24)
    cfg = _cfg(input_shape=(24, 24), output_shape=(24, 24),
               probability_fg=0.0, probability_overlap=0.0,
               probability_random=1.0, batch_size=2,
               augment=TD.AugmentConfig(elastic=False, mirror=True,
                                        transpose=True,
                                        intensity_scale=(1.0, 1.0),
                                        intensity_shift=(0.0, 0.0)))
    ds = DeviceSampler([s], cfg, device="cpu")
    ref = {i: int((s.labels == i).sum()) for i in (1, 2)}
    distinct = False
    for i in range(8):
        raw, labels, _ = ds.sample_batch(_gen(i))
        lab = labels.numpy()
        for b in range(lab.shape[0]):
            ids, cnts = np.unique(lab[b], return_counts=True)
            assert set(ids) <= {0, 1, 2}
            for idv, c in zip(ids, cnts):
                if idv > 0:
                    assert c <= ref[int(idv)]
            # raw (no intensity change) stays aligned with the labels:
            # the toy's raw is its foreground plus small noise
            fg = (lab[b] > 0).any(axis=0)[2:-2, 2:-2]
            assert (raw[b, 0].numpy()[fg] > 0.6).mean() > 0.97
            distinct |= not np.array_equal(lab[b], lab[0])
    assert distinct


def test_partly_flag_and_weighted_overlap_pool():
    s_complete, s_partly = _toy(TD, 0), _toy(TD, 1)
    s_partly.partly = True
    pts = np.array([[15, 15], [15, 16], [16, 15], [16, 16], [30, 30]])
    s_partly.overlap_points = pts
    cfg = _cfg(probability_fg=0.0, probability_overlap=1.0,
               probability_random=0.0, point_balance_radius=3.0,
               batch_size=16)
    ds = DeviceSampler([s_complete, s_partly], cfg, device="cpu")
    assert ds.ov_cumw is not None
    _, _, partly = ds.sample_batch(_gen(0))
    assert partly.any() and not partly.all()
    one = DeviceSampler([s_partly], cfg, device="cpu")
    draws = one._choose_center(_gen(1), torch.zeros(256, dtype=torch.long))
    iso = int((draws.numpy() == pts[4]).all(axis=1).sum())
    assert iso > 256 * 0.3   # weight 1/1 against 1/4: ~50 %, unweighted 20 %


def test_apply_equals_host_numpy_on_given_decisions():
    """Decisions drawn by the device sampler, applied by it and by the host
    sampler's own crop, flip and transpose (3D, three channels, permute
    and hue on), through the card's gate (``cases.check_sampler_alignment``):
    raw within 1e-6, labels equal."""
    from parity import cases

    samples = [_toy3d(TD, 0), _toy3d(TD, 1, shape=(12, 15, 13))]
    aug = TD.AugmentConfig(probability_permute=0.5, probability_hue=0.5,
                           intensity_scale=(0.8, 1.2))
    cfg = TD.SamplerConfig(input_shape=(8, 8, 8), output_shape=(4, 4, 4),
                           patchshape=(3, 3, 3), batch_size=4,
                           probability_fg=0.6, probability_overlap=0.2,
                           augment=aug)
    ds = DeviceSampler(samples, cfg, max_gt_channels=3, device="cpu")
    seen = cases.check_sampler_alignment(ds, samples, TD, draws=6)
    assert all(v > 0 for v in seen.values()), seen
