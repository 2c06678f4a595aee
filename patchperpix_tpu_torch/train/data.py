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

The port splits a crop into its draws, taken from the sampler's
``RandomState`` in the reference's order, and its rendering: without
elastic augmentation each crop is written straight into its batch slot,
only in its output windows (the labels' and raw's centres of the union
extent), raw slab by slab; the elastic path, whose rotation and jitter
read the window's surround, makes the crop at the union extent.

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
from ..utils import trace

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


# raw is rendered in slabs of about this many bytes, so that the
# augmentation's passes over a slab run in cache
_SLAB_BYTES = 1 << 19


@dataclass
class _Draws:
    """Every random draw of one crop (``CropSampler._draw``)."""
    si: int                  # sample
    center: np.ndarray
    drawn: int               # draws of min_masked's rejection loop
    elastic: tuple | None    # (angle, control-point grids)
    flips: tuple             # mirror, per spatial axis
    swap: tuple | None       # transposed pair of spatial axes
    overlay: tuple | None    # (sample, centre) of the overlaid crop
    perm: np.ndarray | None  # channel permutation
    hue: float | None        # |amount| of hue's channel blend
    scale: float             # intensity
    shift: float


def _window(src: np.ndarray, axes, first, steps, shape):
    """The part of a window that lies inside ``src`` (C, *spatial).  The
    window's voxel w (over ``shape``, in output axis order) reads ``src``
    at index ``first[o] + steps[o] * w[o]`` along its axis ``axes[o]``
    (steps of +-1, ``axes`` a permutation).  Returns that part as a view
    of ``src`` in output axis order, its index in the window, and whether
    it is the whole window (else the rest lies outside ``src``)."""
    nd = len(shape)
    src_idx, rev, dst_idx = [slice(0, 0)] * nd, [None] * nd, []
    for k, f, st, n in zip(axes, first, steps, shape):
        size = src.shape[1 + k]
        lo, hi = ((max(0, -f), min(n, size - f)) if st > 0
                  else (max(0, f - size + 1), min(n, f + 1)))
        hi = max(lo, hi)
        dst_idx.append(slice(lo, hi))
        if hi > lo:
            a, b = sorted((f + st * lo, f + st * (hi - 1)))
            src_idx[k] = slice(a, b + 1)
        rev[k] = slice(None, None, st)
    view = src[(slice(None),) + tuple(src_idx)][(slice(None),) + tuple(rev)]
    view = view.transpose([0] + [1 + k for k in axes])
    inside = all(sl.start == 0 and sl.stop == n
                 for sl, n in zip(dst_idx, shape))
    return view, (slice(None),) + tuple(dst_idx), inside


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
        # crops are drawn at the union extent, so that raw and labels
        # see identical augmentation grids, then cut to their windows
        self.big = np.maximum(np.array(cfg.input_shape),
                              np.array(self.label_shape))
        self._big_size = int(np.prod(self.big))
        channels = {s.raw.shape[0] for s in samples}
        if len(channels) != 1:
            raise ValueError(f"samples differ in raw channels: {channels}")
        self.channels = channels.pop()
        self.label_dtype = np.result_type(*(s.labels.dtype
                                            for s in samples))
        # min_masked's test counts the voxels any label covers, in this
        # mask of each sample, without making the crop
        self._masked = ([np.any(s.labels > 0, axis=0) for s in samples]
                        if cfg.min_masked > 0 else None)
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

    # ---- draws -----------------------------------------------------------

    def _box(self, spatial, origin):
        """The part of the union extent with corner ``origin`` that lies
        inside a volume of extent ``spatial``, and whether any of it lies
        outside (where a crop reads zero)."""
        lo = np.maximum(origin, 0)
        hi = np.maximum(np.minimum(origin + self.big, spatial), lo)
        box = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        return box, bool(np.any(hi - lo != self.big))

    def _masked_share(self, si: int, center: np.ndarray) -> float:
        """min_masked's test statistic: the share of the union-extent
        crop at ``center`` that some label covers, counted in the
        sample's mask without making the crop (padding covers nothing)."""
        box, _ = self._box(self._masked[si].shape, center - self.big // 2)
        return np.count_nonzero(self._masked[si][box]) / self._big_size

    def _draw_elastic(self):
        """ElasticAugment's draws: the rotation angle, then one grid of
        control-point jitter per axis."""
        a = self.cfg.augment
        angle = self.rng.uniform(a.rotation_min, a.rotation_max)
        ctrl = []
        if any(js > 0 for js in a.jitter_sigma):
            spatial = tuple(int(b) for b in self.big)
            for d in range(len(spatial)):
                n_ctrl = max(2, spatial[d] // a.control_point_spacing[
                    min(d, len(a.control_point_spacing) - 1)] + 1)
                ctrl.append(self.rng.randn(*([n_ctrl] * len(spatial)))
                            * a.jitter_sigma[min(d, len(a.jitter_sigma) - 1)])
        return angle, ctrl

    def _draw(self) -> _Draws:
        """Every random draw of one crop, in the order of the reference's
        graph (sample and centre with min_masked's rejection, elastic,
        mirror, transpose, OverlayAugment (train.py:276-297), permute,
        RandomHue (neurolight), intensity); nothing is rendered."""
        cfg, a, rng = self.cfg, self.cfg.augment, self.rng
        big = self.big
        for drawn in range(1, 21):  # Reject node equivalent
            si = rng.randint(len(self.samples))
            center = self._choose_center(si)
            if cfg.min_masked <= 0 or \
                    self._masked_share(si, center) >= cfg.min_masked:
                break
        elastic = self._draw_elastic() if a.elastic else None
        flips = tuple(bool(a.mirror and big[k] > 1 and rng.rand() < 0.5)
                      for k in range(self.ndim))
        swap = None
        if a.transpose:
            # only axes with equal extent are transposable
            tr = [ax for ax in range(1, 1 + self.ndim)
                  if big[ax - 1] == big[-1]]
            if len(tr) >= 2 and rng.rand() < 0.5:
                i, j = rng.choice(tr, 2, replace=False)
                swap = (int(i) - 1, int(j) - 1)
        overlay = None
        if rng.rand() <= a.probability_overlay:
            osi = rng.randint(len(self.samples))
            overlay = (osi, self._choose_center(osi))
        perm = None
        if self.channels >= 2 and rng.rand() <= a.probability_permute:
            perm = rng.permutation(self.channels)
        hue = None
        if self.channels >= 3 and rng.rand() <= a.probability_hue:
            hue = abs(rng.uniform(-a.hue_max_change, a.hue_max_change))
        scale = rng.uniform(*a.intensity_scale)
        shift = rng.uniform(*a.intensity_shift)
        return _Draws(si, center, drawn, elastic, flips, swap, overlay,
                      perm, hue, scale, shift)

    # ---- rendering -------------------------------------------------------

    def _axis_map(self, origin, start, flips, swap):
        """Where a window of the augmented crop reads its sample: per
        output axis, the sample's axis, the index there of the window's
        first voxel and the step (-1 where mirrored), through the crop's
        mirror and then transpose.  ``origin`` is the crop's corner in
        the sample, ``start`` the window's corner in the crop."""
        axes = list(range(self.ndim))
        if swap is not None:
            i, j = swap
            axes[i], axes[j] = j, i
        first, steps = [], []
        for o, k in enumerate(axes):
            if flips[k]:
                first.append(int(origin[k] + self.big[k] - 1 - start[o]))
                steps.append(-1)
            else:
                first.append(int(origin[k] + start[o]))
                steps.append(1)
        return axes, first, steps

    def _label_max(self, s: SampleData, origin) -> int:
        """``labels.max()`` of the union-extent crop at ``origin``, padding
        counting as 0, reduced over a view of the sample."""
        box, padded = self._box(s.labels.shape[1:], origin)
        top = int(s.labels[(slice(None),) + box].max())
        return max(top, 0) if padded else top

    def _render_window(self, d: _Draws, raw_out, labels_out):
        """Render a crop straight into its batch slots, each array only in
        its output window of the union extent: the labels in one strided
        copy per crop, raw slab by slab along the first axis so that
        overlay, permute, hue and intensity run on data in cache.  The
        same float operations as the full-extent path, in its order."""
        nd = self.ndim
        half = self.big // 2
        s = self.samples[d.si]
        origin = d.center - half
        still = (False,) * nd
        o = None if d.overlay is None else self.samples[d.overlay[0]]

        # labels: the crop's channels, then the overlaid crop's (not
        # mirrored) past the first's largest label; channels beyond the
        # slot are dropped, missing ones stay zero
        start = half - np.asarray(self.label_shape) // 2
        cmax = labels_out.shape[0]
        n1 = min(s.labels.shape[0], cmax)
        view, idx, _ = _window(s.labels[:n1],
                               *self._axis_map(origin, start, d.flips,
                                               d.swap), self.label_shape)
        labels_out[:n1][idx] = view
        c1 = s.labels.shape[0]
        n2 = 0 if o is None else min(o.labels.shape[0], cmax - c1)
        if n2 > 0:
            offset = self._label_max(s, origin)
            view, idx, _ = _window(o.labels[:n2], *self._axis_map(
                d.overlay[1] - half, start, still, None), self.label_shape)
            labels_out[c1:c1 + n2][idx] = np.where(view > 0, view + offset,
                                                   0)

        # raw: per slab, the crop's read (zero outside the sample), its
        # maximum with the overlaid crop's, the channels permuted, hue's
        # blend of channels 0-2, intensity, written into the slot
        shape = tuple(self.cfg.input_shape)
        start = half - np.asarray(shape) // 2
        maps = [(s.raw, self._axis_map(origin, start, d.flips, d.swap))]
        if o is not None:
            maps.append((o.raw, self._axis_map(d.overlay[1] - half, start,
                                               still, None)))
        C = self.channels
        dtype = np.result_type(*(src.dtype for src, _ in maps))
        h = max(1, _SLAB_BYTES // (C * int(np.prod(shape[1:]))
                                   * dtype.itemsize))
        slab = (C, min(h, shape[0])) + shape[1:]
        bufs = [np.empty(slab, src.dtype) for src, _ in maps]
        work = np.empty(slab, dtype)
        rolled = np.empty((3,) + slab[1:], dtype) if d.hue is not None \
            else None
        perm = range(C) if d.perm is None else d.perm
        for p in range(0, shape[0], h):
            n = min(h, shape[0] - p)
            reads = []
            for (src, (axes, first, steps)), buf in zip(maps, bufs):
                view, idx, inside = _window(
                    src, axes, [first[0] + steps[0] * p] + first[1:], steps,
                    (n,) + shape[1:])
                if not inside:
                    buf = buf[:, :n]
                    buf.fill(0)
                    buf[idx] = view
                    view = buf
                reads.append(view)
            w = work[:, :n]
            for c, pc in enumerate(perm):
                if o is None:
                    w[c] = reads[0][pc]
                else:
                    np.maximum(reads[0][pc], reads[1][pc], out=w[c])
            if d.hue is not None:
                r = rolled[:, :n]
                for c in range(3):
                    np.multiply(w[(c - 1) % 3], d.hue, out=r[c])
                np.multiply(w[:3], 1 - d.hue, out=w[:3])
                np.add(w[:3], r, out=w[:3])
                np.clip(w[:3], 0, 1, out=w[:3])
            np.multiply(w, d.scale, out=w)
            np.add(w, d.shift, out=w)
            np.clip(w, 0, 1, out=raw_out[:, p:p + n])

    def _elastic(self, raw, labels, angle, ctrl):
        """Rotation (around the last two axes) + smooth jitter
        (gp.ElasticAugment equivalent, host-side), from the drawn angle
        and control-point grids."""
        axes = (-2, -1)
        raw = ndimage.rotate(raw, angle, axes=axes, reshape=False, order=1,
                             mode="constant")
        labels = ndimage.rotate(labels, angle, axes=axes, reshape=False,
                                order=0, mode="constant")
        if ctrl:
            spatial = raw.shape[1:]
            grids = np.meshgrid(*[np.arange(s) for s in spatial],
                                indexing="ij")
            coords = []
            for g, c in zip(grids, ctrl):
                disp = ndimage.zoom(c, [s / c.shape[0] for s in spatial],
                                    order=1)
                coords.append(g + disp)
            for c in range(raw.shape[0]):
                raw[c] = ndimage.map_coordinates(raw[c], coords, order=1,
                                                 mode="constant")
            for c in range(labels.shape[0]):
                labels[c] = ndimage.map_coordinates(labels[c], coords,
                                                    order=0, mode="constant")
        return raw, labels

    def _render_full(self, d: _Draws, raw_out, labels_out):
        """The elastic path: the crop made at the whole union extent, whose
        surround the rotation and jitter read, then each augmentation over
        all of it in turn and the windows cut out at the end."""
        big = self.big
        s = self.samples[d.si]
        raw = self._crop_at(s.raw, d.center, big)
        labels = self._crop_at(s.labels, d.center, big)
        raw, labels = self._elastic(raw, labels, *d.elastic)
        for k, f in enumerate(d.flips):
            if f:
                raw = np.flip(raw, axis=1 + k)
                labels = np.flip(labels, axis=1 + k)
        if d.swap is not None:
            order = list(range(raw.ndim))
            i, j = (1 + k for k in d.swap)
            order[i], order[j] = order[j], order[i]
            raw = np.transpose(raw, order)
            labels = np.transpose(labels, order)
        raw, labels = np.ascontiguousarray(raw), np.ascontiguousarray(labels)
        if d.overlay is not None:
            o = self.samples[d.overlay[0]]
            raw2 = self._crop_at(o.raw, d.overlay[1], big)
            labels2 = self._crop_at(o.labels, d.overlay[1], big)
            raw = np.maximum(raw, raw2)
            offset = int(labels.max())
            labels2 = np.where(labels2 > 0, labels2 + offset, 0)
            labels = np.concatenate([labels, labels2], axis=0)
        if d.perm is not None:
            raw = raw[d.perm]
        if d.hue is not None:
            rolled = np.roll(raw[:3], 1, axis=0)
            raw = raw.copy()
            raw[:3] = np.clip((1 - d.hue) * raw[:3] + d.hue * rolled, 0, 1)
        raw = np.clip(raw * d.scale + d.shift, 0, 1)
        c = big // 2
        raw_out[...] = self._crop_at(raw, c, self.cfg.input_shape)
        lab = self._crop_at(labels, c, self.label_shape)[:labels_out.shape[0]]
        labels_out[:lab.shape[0]] = lab

    # ---- batch production ----------------------------------------------

    def one_crop(self, raw_out: np.ndarray, labels_out: np.ndarray) -> bool:
        """Draw one crop and render it into ``raw_out`` (C, *input_shape)
        and ``labels_out`` (C_gt, *label_shape, zeros on entry); returns
        its partly-labeled flag.  Without elastic augmentation the crop
        is rendered only in its output windows; the elastic path makes
        it at the union extent."""
        d = self._draw()
        if d.elastic is None:
            self._render_window(d, raw_out, labels_out)
            trace.count("train.crops_windowed")
        else:
            self._render_full(d, raw_out, labels_out)
        trace.count("train.crops_drawn", d.drawn)
        trace.count("train.crops")
        return self.samples[d.si].partly or (
            d.overlay is not None and self.samples[d.overlay[0]].partly)

    def batch(self, max_gt_channels: int = 6, with_partly: bool = False):
        """One (raw, labels[, partly]) batch; gt channel count is
        padded/truncated to a fixed ``max_gt_channels`` so the jitted train
        step never recompiles.  ``with_partly`` adds the per-item
        partly-labeled flag vector (bool (B,)) the masked losses consume.
        The arrays are new for every batch: a caller may keep them."""
        B = self.cfg.batch_size
        raw = np.empty((B, self.channels) + tuple(self.cfg.input_shape),
                       np.float32)
        labels = np.zeros((B, max_gt_channels) + self.label_shape,
                          self.label_dtype)
        partly = np.array([self.one_crop(raw[b], labels[b])
                           for b in range(B)], dtype=bool)
        return (raw, labels, partly) if with_partly else (raw, labels)


class Prefetcher:
    """Background thread keeping a queue of ready batches (gp.PreCache).

    While a profiler runs in the thread that calls ``next`` (the loop),
    the spans ``train.data_wait`` (the loop blocked on the queue) and
    ``train.sample`` (the thread producing one batch), and the counters
    ``train.crops_drawn`` (the draws of ``min_masked``'s rejection loop,
    counted with the crop they gave), ``train.crops`` (each crop
    returned) and ``train.crops_windowed`` (each crop rendered only in
    its output windows) are recorded (``utils/trace.py``); the thread's
    share is clipped to the loop's traced interval."""

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
                with trace.span("train.sample"):
                    batch = self.sampler.batch(
                        self.max_gt_channels, with_partly=self.with_partly)
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
        with trace.span("train.data_wait"):
            batch = self.queue.get()
        if isinstance(batch, Exception):
            # the sampler thread died; surface its error in the caller
            # (a silent dead thread would block next() forever)
            raise RuntimeError("prefetcher sampler thread failed") \
                from batch
        return batch

    def stop(self):
        self._stop.set()
