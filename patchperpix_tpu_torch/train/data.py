"""Host-side training data: samples, the crop sampler, the prefetcher.

Counterpart of ``patchperpix_tpu/train/data.py``, which replaces the
reference's gunpowder graph (experiments/.../train.py:233-335, 575-862)
with a plain numpy sampler producing fixed-shape crops.  This is numpy on
the host in both packages; the port keeps its own copy, draw for draw the
same under the same seed:

- per-sample zarr / hdf sources (raw + multi-channel gt instances), the
  partly-labeled flag and close_to_overlap CSV points;
- three sampling pools mixed by probability: foreground-biased,
  overlap-biased (optionally point_balance_radius-weighted), uniform
  random (train.py:841-855);
- augmentations: mirror / transpose (SimpleAugment), elastic (rotation +
  control-point jitter via scipy), channel permutation, random hue,
  intensity scale / shift, synthetic-overlap OverlayAugment, and
  min_masked rejection;
- a background prefetch thread stands in for gp.PreCache.

``train/device_data.py`` draws the same crops on the card for the configs
it can reproduce.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from dataclasses import dataclass, field

import numpy as np
from scipy import ndimage

from ..utils import io as vio

logger = logging.getLogger(__name__)


@dataclass
class SampleData:
    raw: np.ndarray          # (C, *spatial) float32, normalized
    labels: np.ndarray       # (C_gt, *spatial) int
    fg_mask: np.ndarray      # (*spatial) bool
    overlap_mask: np.ndarray  # (*spatial) bool
    partly: bool = False     # partly-labeled sample -> per-pixel loss mask
                             # derived in the train step (ref CreateMask,
                             # train.py:735-741)
    overlap_points: np.ndarray | None = None  # CSV point source for the
                             # overlap-biased pool (ref close_to_overlap
                             # csv sources, train.py:600-611, 841-855)


def load_overlap_csv(path: str) -> np.ndarray:
    """(N, d) int coordinates from a close_to_overlap CSV (one point per
    line, comma/whitespace separated)."""
    pts = np.loadtxt(path, delimiter=",", dtype=np.int64, ndmin=2)
    return pts


def load_sample(path: str, raw_key: str, gt_key: str,
                clipmax: float | None = None,
                partly: bool | None = None,
                overlap_csv: str | None = None) -> SampleData:
    """Raw (clipped to ``clipmax`` and scaled to [0, 1], else scaled by its
    maximum when above 1.5) and ground-truth labels of one sample (a zarr
    store or an HDF5 file: ``utils/io.open_volume``),
    each with a leading channel axis; ``partly`` defaults to '"partly" in
    path', and ``overlap_csv`` (if it exists) gives the overlap pool."""
    io = vio.open_volume(path, mode="r")
    raw = io.read(key=raw_key).astype(np.float32)
    labels = io.read(key=gt_key)
    io.close()
    if raw.ndim == labels.ndim - 1:
        raw = raw[None]
    if labels.ndim == raw.ndim - 1:
        labels = labels[None]
    if clipmax:
        raw = np.clip(raw, 0, clipmax) / clipmax
    elif raw.max() > 1.5:
        raw = raw / max(raw.max(), 1e-6)
    fg = np.any(labels > 0, axis=0)
    overlap = np.sum(labels > 0, axis=0) > 1
    if partly is None:
        partly = "partly" in str(path)  # ref train.py:700 ('"partly" in fn')
    pts = None
    if overlap_csv is not None:
        if os.path.exists(overlap_csv):
            pts = load_overlap_csv(overlap_csv)
    return SampleData(raw=raw, labels=labels.astype(np.int32),
                      fg_mask=fg, overlap_mask=overlap, partly=bool(partly),
                      overlap_points=pts)


@dataclass
class AugmentConfig:
    mirror: bool = True
    transpose: bool = True
    elastic: bool = False
    control_point_spacing: tuple = (20, 20, 20)
    jitter_sigma: tuple = (1.0, 1.0, 1.0)
    rotation_min: float = -45.0
    rotation_max: float = 45.0
    intensity_scale: tuple = (0.9, 1.1)
    intensity_shift: tuple = (-0.1, 0.1)
    probability_permute: float = 0.0
    probability_hue: float = 0.0
    hue_max_change: float = 0.5
    probability_overlay: float = 0.0


@dataclass
class SamplerConfig:
    input_shape: tuple = (140, 140, 140)
    output_shape: tuple = (60, 60, 60)
    patchshape: tuple = (7, 7, 7)
    batch_size: int = 2
    probability_fg: float = 0.7
    probability_overlap: float = 0.25
    probability_random: float = 0.05
    min_masked: float = 0.0
    point_balance_radius: float = 0.0   # balance CSV point density
                                        # (gp.RandomLocation analog,
                                        # train.py:849-852)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    seed: int = 0


class CropSampler:
    """Draws augmented (raw, labels, fg, loss_mask) crops from samples."""

    def __init__(self, samples: list[SampleData], cfg: SamplerConfig):
        assert samples, "no training samples"
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
        # point_balance_radius: weight each point by 1/#neighbors within
        # the radius so dense clusters don't dominate (gp.RandomLocation)
        self._ov_weights = []
        pbr = cfg.point_balance_radius
        for pts in self._ov_coords:
            if pbr > 0 and len(pts) > 1:
                from scipy.spatial import cKDTree

                tree = cKDTree(pts)
                counts = np.array([len(tree.query_ball_point(p, pbr))
                                   for p in pts], dtype=np.float64)
                w = 1.0 / np.maximum(counts, 1)
                self._ov_weights.append(w / w.sum())
            else:
                self._ov_weights.append(None)

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

    def _elastic(self, raw, labels):
        """Rotation (around the last two axes) + smooth jitter
        (gp.ElasticAugment equivalent, host-side)."""
        a = self.cfg.augment
        angle = self.rng.uniform(a.rotation_min, a.rotation_max)
        axes = (-2, -1)
        raw = ndimage.rotate(raw, angle, axes=axes, reshape=False, order=1,
                             mode="constant")
        labels = ndimage.rotate(labels, angle, axes=axes, reshape=False,
                                order=0, mode="constant")
        if any(js > 0 for js in a.jitter_sigma):
            spatial = raw.shape[1:]
            grids = np.meshgrid(*[np.arange(s) for s in spatial],
                                indexing="ij")
            coords = []
            for d, g in enumerate(grids):
                n_ctrl = max(2, spatial[d] // a.control_point_spacing[
                    min(d, len(a.control_point_spacing) - 1)] + 1)
                ctrl = self.rng.randn(*([n_ctrl] * len(spatial))) \
                    * a.jitter_sigma[min(d, len(a.jitter_sigma) - 1)]
                disp = ndimage.zoom(ctrl, [s / n_ctrl for s in spatial],
                                    order=1)
                coords.append(g + disp)
            for c in range(raw.shape[0]):
                raw[c] = ndimage.map_coordinates(raw[c], coords, order=1,
                                                 mode="constant")
            for c in range(labels.shape[0]):
                labels[c] = ndimage.map_coordinates(labels[c], coords,
                                                    order=0, mode="constant")
        return raw, labels

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

        a = cfg.augment
        if a.elastic:
            raw, labels = self._elastic(raw, labels)
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


class Prefetcher:
    """Background thread keeping a queue of ready batches (gp.PreCache)."""

    def __init__(self, sampler: CropSampler, cache_size: int = 8,
                 max_gt_channels: int = 6, with_partly: bool = False):
        self.sampler = sampler
        self.queue: queue.Queue = queue.Queue(maxsize=cache_size)
        self.max_gt_channels = max_gt_channels
        self.with_partly = with_partly
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            # build the batch once; retry the put until it fits (a put
            # inside the try would recompute and discard a full augmented
            # batch on every queue.Full, busy-burning host CPU)
            try:
                batch = self.sampler.batch(self.max_gt_channels,
                                           with_partly=self.with_partly)
            except Exception as e:  # propagate instead of deadlocking
                batch = e
            while not self._stop.is_set():
                try:
                    self.queue.put(batch, timeout=1.0)
                    break
                except queue.Full:
                    continue
            if isinstance(batch, Exception):
                return

    def next(self):
        batch = self.queue.get()
        if isinstance(batch, Exception):
            # the sampler thread died; surface its error in the caller
            # (a silent dead thread would block next() forever)
            raise RuntimeError("prefetcher sampler thread failed") \
                from batch
        return batch

    def stop(self):
        self._stop.set()
