"""Plain reference of the training data layer's host crop sampler.

A frozen copy of the program's ``CropSampler`` (``train/data.py``, a
numpy port of the reference's gunpowder graph): the same draws from the
same ``np.random.RandomState`` stream, so that a seed gives the same
batches.  The benchmark holds the batches the program's data layer hands
to the training step against these, element for element, and the
reference training step then runs on its own batches.  Being a copy, it
is no independent witness of the sampler's semantics: a fault that the
program's sampler had when the copy was made passes; what the check
catches is a later change to the batches the data layer makes.  Elastic
augmentation and point balancing, which no configuration here uses, are
left out.

Nothing here imports the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Sample:
    raw: np.ndarray          # (C, *spatial) float32 in [0, 1]
    labels: np.ndarray       # (C_gt, *spatial) int32
    fg_mask: np.ndarray
    overlap_mask: np.ndarray
    partly: bool = False
    overlap_points: np.ndarray | None = None

    @classmethod
    def of(cls, raw, labels):
        return cls(raw=raw, labels=labels.astype(np.int32),
                   fg_mask=np.any(labels > 0, axis=0),
                   overlap_mask=np.sum(labels > 0, axis=0) > 1)


@dataclass
class AugmentConfig:
    mirror: bool = True
    transpose: bool = True
    elastic: bool = False
    intensity_scale: tuple = (0.9, 1.1)
    intensity_shift: tuple = (-0.1, 0.1)
    probability_permute: float = 0.0
    probability_hue: float = 0.0
    hue_max_change: float = 0.5
    probability_overlay: float = 0.0


@dataclass
class SamplerConfig:
    input_shape: tuple
    output_shape: tuple
    patchshape: tuple
    batch_size: int = 2
    probability_fg: float = 0.7
    probability_overlap: float = 0.25
    probability_random: float = 0.05
    min_masked: float = 0.0
    point_balance_radius: float = 0.0
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 0


class CropSampler:
    """Draws augmented (raw, labels, fg, loss_mask) crops from samples."""

    def __init__(self, samples: list[SampleData], cfg: SamplerConfig):
        if not samples:
            raise ValueError("no training samples")
        if cfg.augment.elastic or cfg.point_balance_radius > 0:
            raise ValueError("reference sampler: no elastic augmentation "
                             "and no point balancing")
        self.samples = samples
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        self.ndim = len(cfg.input_shape)
        ps = np.asarray(cfg.patchshape)
        # label crop needs patch-radius context around the output
        # (gt_affinities windows index corner .. corner+ps)
        self.label_shape = tuple(int(o + 2 * (p // 2))
                                 for o, p in zip(cfg.output_shape, ps))
        self._fg_coords = [np.argwhere(s.fg_mask) for s in samples]
        # overlap pool: CSV close_to_overlap points when provided
        # (train.py:841-855), else the derived overlap mask
        self._ov_coords = [s.overlap_points if s.overlap_points is not None
                           else np.argwhere(s.overlap_mask)
                           for s in samples]
        self._ov_weights = [None] * len(samples)

    def _choose_center(self, si: int) -> np.ndarray:
        s = self.samples[si]
        spatial = np.array(s.fg_mask.shape)
        r = self.rng.rand()
        p_fg = self.cfg.probability_fg
        p_ov = self.cfg.probability_overlap
        if r < p_fg and len(self._fg_coords[si]):
            pool = self._fg_coords[si]
        elif r < p_fg + p_ov and len(self._ov_coords[si]):
            pool = self._ov_coords[si]
            w = self._ov_weights[si]
            if w is not None:
                return pool[self.rng.choice(len(pool), p=w)]
        else:
            return np.array([self.rng.randint(0, d) for d in spatial])
        return pool[self.rng.randint(len(pool))]

    def _crop_at(self, arr: np.ndarray, center: np.ndarray, shape,
                 pad_value=0):
        """Channel-first crop around center with constant padding."""
        shape = np.asarray(shape)
        start = center - shape // 2
        stop = start + shape
        spatial = np.array(arr.shape[1:])
        rs = np.maximum(start, 0)
        re = np.minimum(stop, spatial)
        sl = (slice(None),) + tuple(slice(int(a), int(b))
                                    for a, b in zip(rs, re))
        out = arr[sl]
        pad = [(0, 0)] + [(int(a - b), int(c - d))
                          for a, b, c, d in zip(rs, start, stop, re)]
        if any(p != (0, 0) for p in pad):
            out = np.pad(out, pad, mode="constant", constant_values=pad_value)
        return out

    # ---- augmentations -------------------------------------------------

    def _simple_augment(self, raw, labels):
        a = self.cfg.augment
        spatial_axes = list(range(1, 1 + self.ndim))
        if a.mirror:
            for ax in spatial_axes:
                if raw.shape[ax] > 1 and self.rng.rand() < 0.5:
                    raw = np.flip(raw, axis=ax)
                    labels = np.flip(labels, axis=ax)
        if a.transpose:
            # only axes with equal extent are transposable
            tr = [ax for ax in spatial_axes
                  if raw.shape[ax] == raw.shape[spatial_axes[-1]]]
            if len(tr) >= 2 and self.rng.rand() < 0.5:
                i, j = self.rng.choice(tr, 2, replace=False)
                order = list(range(raw.ndim))
                order[i], order[j] = order[j], order[i]
                raw = np.transpose(raw, order)
                labels = np.transpose(labels, order)
        return np.ascontiguousarray(raw), np.ascontiguousarray(labels)

    def _intensity(self, raw):
        a = self.cfg.augment
        scale = self.rng.uniform(*a.intensity_scale)
        shift = self.rng.uniform(*a.intensity_shift)
        return np.clip(raw * scale + shift, 0, 1)

    def _hue(self, raw):
        """RandomHue (neurolight): rotate channels by a random blend."""
        a = self.cfg.augment
        if raw.shape[0] < 3 or self.rng.rand() > a.probability_hue:
            return raw
        amount = self.rng.uniform(-a.hue_max_change, a.hue_max_change)
        rolled = np.roll(raw[:3], 1, axis=0)
        out = raw.copy()
        out[:3] = np.clip((1 - abs(amount)) * raw[:3] + abs(amount) * rolled,
                          0, 1)
        return out

    def _permute(self, raw):
        a = self.cfg.augment
        if raw.shape[0] < 2 or self.rng.rand() > a.probability_permute:
            return raw
        perm = self.rng.permutation(raw.shape[0])
        return raw[perm]

    def _overlay(self, raw, labels):
        """OverlayAugment: blend a second crop in to synthesize overlaps
        (train.py:276-297, neurolight)."""
        a = self.cfg.augment
        if self.rng.rand() > a.probability_overlay:
            return raw, labels, False
        si = self.rng.randint(len(self.samples))
        center = self._choose_center(si)
        raw2 = self._crop_at(self.samples[si].raw, center,
                             np.array(raw.shape[1:]))
        labels2 = self._crop_at(self.samples[si].labels, center,
                                np.array(labels.shape[1:]))
        raw = np.maximum(raw, raw2)
        offset = int(labels.max())
        labels2 = np.where(labels2 > 0, labels2 + offset, 0)
        labels = np.concatenate([labels, labels2], axis=0)
        return raw, labels, self.samples[si].partly

    # ---- batch production ----------------------------------------------

    def one_crop(self):
        cfg = self.cfg
        # crop at the union extent so raw and labels see identical
        # augmentation grids, then center-crop each to its own shape
        big = np.maximum(np.array(cfg.input_shape),
                         np.array(self.label_shape))
        for _ in range(20):  # Reject node equivalent
            si = self.rng.randint(len(self.samples))
            s = self.samples[si]
            center = self._choose_center(si)
            raw = self._crop_at(s.raw, center, big)
            labels = self._crop_at(s.labels, center, big)
            if cfg.min_masked <= 0 or \
                    (labels > 0).any(axis=0).mean() >= cfg.min_masked:
                break

        raw, labels = self._simple_augment(raw, labels)
        raw, labels, overlay_partly = self._overlay(raw, labels)
        raw = self._permute(raw)
        raw = self._hue(raw)
        raw = self._intensity(raw)

        c = big // 2
        raw = self._crop_at(raw, c, np.array(cfg.input_shape))
        labels_out = self._crop_at(labels, c, np.array(self.label_shape))
        return (raw.astype(np.float32), labels_out,
                s.partly or overlay_partly)

    def batch(self, max_gt_channels: int = 6, with_partly: bool = False):
        """One (raw, labels[, partly]) batch; gt channel count is
        padded/truncated to a fixed ``max_gt_channels`` so the jitted train
        step never recompiles.  ``with_partly`` adds the per-item
        partly-labeled flag vector (bool (B,)) the masked losses consume."""
        raws, labs, partly = [], [], []
        for _ in range(self.cfg.batch_size):
            r, l, p = self.one_crop()
            raws.append(r)
            labs.append(l)
            partly.append(p)
        cmax = max_gt_channels
        labs = [np.pad(l[:cmax], [(0, cmax - min(l.shape[0], cmax))]
                       + [(0, 0)] * (l.ndim - 1)) for l in labs]
        out = (np.stack(raws), np.stack(labs))
        if with_partly:
            out = out + (np.array(partly, dtype=bool),)
        return out
