"""Device-resident training data.

Counterpart of ``patchperpix_tpu/train/device_data.py``: the sample volumes
are padded and uploaded to the card once, and every batch is drawn,
cropped and augmented there, with no per-step host <-> device traffic and
no host synchronisation.

Semantics mirror ``train/data.py``'s ``CropSampler`` (itself the gunpowder
graph of experiments/.../train.py:575-862):

- three sampling pools mixed by probability: foreground-biased,
  overlap-biased (optionally point_balance_radius-weighted), uniform
  random (train.py:841-855);
- volumes are pre-padded by the crop half-extent, so border centres get
  zero padding exactly like the host sampler's padded crops;
- SimpleAugment mirror / transpose, channel permute, random hue,
  intensity scale / shift.

A batch is made in two steps: ``draw(generator)`` takes every random
decision (the sample, the pool-mixed centre, the flips, a transpose pair,
the permutation, hue and intensity), each from its own draw of a
``torch.Generator`` on the card; ``apply(decisions)`` crops the union
extent at the centre, augments and centre-crops raw and labels to their
own shapes.  A test applies given decisions and compares with the host
sampler's ``_crop_at`` / ``np.flip`` / ``np.transpose``.

Not supported on the card (the CLI sends configs using them to the host
sampler, with a warning): elastic deformation, OverlayAugment, min_masked
rejection.  The device sampler itself never falls back to the CPU.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..utils.device import resolve_device
from .data import SampleData, SamplerConfig

logger = logging.getLogger(__name__)


def device_sampler_supported(cfg: SamplerConfig) -> str | None:
    """None when the device sampler can reproduce this config, else the
    reason for the host sampler."""
    a = cfg.augment
    if a.elastic:
        return "elastic augmentation"
    if a.probability_overlay > 0:
        return "overlay augmentation"
    if cfg.min_masked > 0:
        return "min_masked rejection sampling"
    return None


def _balance_weights(pts: np.ndarray, radius: float) -> np.ndarray | None:
    """1 / #neighbours within ``radius``, normalised (gp.RandomLocation's
    point balancing), or None when there is nothing to balance."""
    if radius <= 0 or len(pts) <= 1:
        return None
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    counts = np.array([len(tree.query_ball_point(p, radius)) for p in pts],
                      np.float64)
    w = 1.0 / np.maximum(counts, 1)
    return w / w.sum()


class DeviceSampler:
    """Batches sampled and augmented on the card.

    ``sample_batch(generator)`` returns (raw (B, C, *input_shape) float32,
    labels (B, G, *label_shape) int32, partly (B,) bool), all on
    ``device``."""

    def __init__(self, samples: list[SampleData], cfg: SamplerConfig,
                 max_gt_channels: int = 6, device="cuda"):
        assert samples, "no training samples"
        reason = device_sampler_supported(cfg)
        if reason is not None:
            raise ValueError(f"device sampler unsupported: {reason}")
        dev = self.device = resolve_device(device)
        self.cfg = cfg
        self.ndim = len(cfg.input_shape)
        ps = np.asarray(cfg.patchshape)
        self.label_shape = tuple(int(o + 2 * (p // 2))
                                 for o, p in zip(cfg.output_shape, ps))
        self.big = np.maximum(np.array(cfg.input_shape),
                              np.array(self.label_shape))
        self.G = int(max_gt_channels)

        # pad every sample to the common extent, then by the crop
        # half-extent on each side: the window starting at voxel v of the
        # padded volume is centred on voxel v of the original, with zeros
        # wherever it leaves the volume (CropSampler._crop_at's semantics)
        spatial = np.max([s.fg_mask.shape for s in samples], axis=0)
        half = self.big // 2
        pad_sp = tuple(int(s + 2 * h) for s, h in zip(spatial, half))
        S, C = len(samples), samples[0].raw.shape[0]
        raw_all = np.zeros((S, C) + pad_sp, np.float32)
        lab_all = np.zeros((S, self.G) + pad_sp, np.int32)
        fg_list, ov_list, ovw_list = [], [], []
        for i, s in enumerate(samples):
            sl = tuple(slice(int(h), int(h + e))
                       for h, e in zip(half, s.fg_mask.shape))
            raw_all[(i, slice(None)) + sl] = s.raw
            g = min(self.G, s.labels.shape[0])
            lab_all[(i, slice(0, g)) + sl] = s.labels[:g]
            fg_list.append(np.argwhere(s.fg_mask))
            pts = (s.overlap_points if s.overlap_points is not None
                   else np.argwhere(s.overlap_mask))
            ov_list.append(pts)
            ovw_list.append(_balance_weights(pts, cfg.point_balance_radius))

        self.raw_all = torch.from_numpy(raw_all).to(dev)
        self.lab_all = torch.from_numpy(lab_all).to(dev)
        self.partly = torch.tensor([bool(s.partly) for s in samples],
                                   device=dev)
        self.spatial = torch.tensor([s.fg_mask.shape for s in samples],
                                    dtype=torch.int64, device=dev)
        self.fg_coords, self.fg_counts, _ = self._pools(fg_list, None)
        self.ov_coords, self.ov_counts, self.ov_cumw = self._pools(
            ov_list, ovw_list)
        self.n_samples = S
        # transpose candidates: pairs of spatial axes (batched layout,
        # axis 2 + d) of equal extent to the last one
        last = int(self.big[-1])
        tr = [2 + d for d in range(self.ndim) if int(self.big[d]) == last]
        self.pairs = [(i, j) for n, i in enumerate(tr) for j in tr[n + 1:]]

    def _pools(self, coord_list, weight_list):
        """(coords (S, Nmax, d) int64, counts (S,), cumulative weights
        (S, Nmax) float32 or None) on the card."""
        S = len(coord_list)
        nmax = max(1, max(len(c) for c in coord_list))
        coords = np.zeros((S, nmax, self.ndim), np.int64)
        counts = np.zeros(S, np.int64)
        have_w = weight_list is not None and any(
            w is not None for w in weight_list)
        cumw = np.ones((S, nmax), np.float32) if have_w else None
        for i, c in enumerate(coord_list):
            counts[i] = len(c)
            if len(c):
                coords[i, :len(c)] = c
                if have_w:
                    w = (weight_list[i] if weight_list[i] is not None
                         else np.full(len(c), 1.0 / len(c)))
                    cumw[i, :len(c)] = np.cumsum(w)
        dev = self.device
        return (torch.from_numpy(coords).to(dev),
                torch.from_numpy(counts).to(dev),
                None if cumw is None else torch.from_numpy(cumw).to(dev))

    # ---- draw decisions --------------------------------------------------

    def _uniform(self, g, shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=g, device=self.device,
                       dtype=torch.float64)
        return lo + (hi - lo) * u

    def _index(self, g, n):
        """Uniform integers in [0, max(n, 1)) for an int64 tensor n."""
        n = n.clamp(min=1)
        return torch.minimum((self._uniform(g, n.shape) * n).long(), n - 1)

    def _choose_center(self, g, si):
        """Pool-mixed centre (original-volume coordinates)."""
        B = si.shape[0]
        p_fg = self.cfg.probability_fg
        p_ov = self.cfg.probability_overlap
        u = self._uniform(g, (B,))
        fg_n, ov_n = self.fg_counts[si], self.ov_counts[si]
        c_fg = self.fg_coords[si, self._index(g, fg_n)]
        if self.ov_cumw is not None:
            uu = self._uniform(g, (B, 1)).float()
            ov_idx = torch.searchsorted(self.ov_cumw[si], uu)[:, 0]
            ov_idx = torch.minimum(ov_idx, ov_n.clamp(min=1) - 1)
        else:
            ov_idx = self._index(g, ov_n)
        c_ov = self.ov_coords[si, ov_idx]
        sp = self.spatial[si]
        c_rand = torch.minimum((self._uniform(g, sp.shape) * sp).long(),
                               sp - 1)
        use_fg = (u < p_fg) & (fg_n > 0)
        use_ov = ~use_fg & (u < p_fg + p_ov) & (ov_n > 0)
        return torch.where(use_fg[:, None], c_fg,
                           torch.where(use_ov[:, None], c_ov, c_rand))

    def draw(self, g: torch.Generator) -> dict:
        """Every random decision of one batch, each an independent draw
        (a decision and a value never share one: a transposed crop must
        not always land in one half of the intensity range)."""
        a, B = self.cfg.augment, self.cfg.batch_size
        C = self.raw_all.shape[1]
        si = self._index(g, torch.full((B,), self.n_samples,
                                       device=self.device))
        d = {"si": si, "center": self._choose_center(g, si)}
        d["flip"] = self._uniform(g, (B, self.ndim)) < 0.5
        d["transpose"] = self._uniform(g, (B,)) < 0.5
        d["pair"] = self._index(g, torch.full((B,), max(len(self.pairs), 1),
                                              device=self.device))
        d["permute"] = self._uniform(g, (B,)) < a.probability_permute
        d["perm"] = torch.argsort(self._uniform(g, (B, C)), dim=1)
        d["hue"] = self._uniform(g, (B,)) < a.probability_hue
        d["hue_amount"] = self._uniform(g, (B,), -a.hue_max_change,
                                        a.hue_max_change).abs().float()
        d["scale"] = self._uniform(g, (B,), *a.intensity_scale).float()
        d["shift"] = self._uniform(g, (B,), *a.intensity_shift).float()
        return d

    # ---- apply decisions ---------------------------------------------------

    def _window(self, vol, si, center, shape):
        """vol[si, :, c : c + shape] per item, as one gather: (B, C,
        *shape)."""
        nd = self.ndim
        idx = []
        for dim in range(nd):
            r = center[:, dim, None] + torch.arange(
                int(shape[dim]), device=self.device)
            idx.append(r.reshape((-1,) + tuple(
                int(shape[dim]) if k == dim else 1 for k in range(nd))))
        si = si.reshape((-1,) + (1,) * nd)
        return vol[(si, slice(None)) + tuple(idx)].movedim(-1, 1)

    def apply(self, d: dict):
        """(raw, labels, partly) of the decisions ``d``."""
        a, nd = self.cfg.augment, self.ndim
        big = self.big
        raw = self._window(self.raw_all, d["si"], d["center"], big)
        labels = self._window(self.lab_all, d["si"], d["center"], big)

        def per_item(m):
            return m.reshape((-1,) + (1,) * (1 + nd))

        if a.mirror:
            for dim in range(nd):
                if big[dim] > 1:
                    m = per_item(d["flip"][:, dim])
                    raw = torch.where(m, raw.flip(2 + dim), raw)
                    labels = torch.where(m, labels.flip(2 + dim), labels)
        if a.transpose:
            for p, (i, j) in enumerate(self.pairs):
                m = per_item(d["transpose"] & (d["pair"] == p))
                raw = torch.where(m, raw.transpose(i, j), raw)
                labels = torch.where(m, labels.transpose(i, j), labels)
        C = raw.shape[1]
        if a.probability_permute > 0 and C >= 2:
            perm = d["perm"].reshape((-1, C) + (1,) * nd).expand_as(raw)
            raw = torch.where(per_item(d["permute"]), raw.gather(1, perm),
                              raw)
        if a.probability_hue > 0 and C >= 3:
            amt = per_item(d["hue_amount"])
            mixed = ((1 - amt) * raw[:, :3]
                     + amt * raw[:, :3].roll(1, dims=1)).clamp(0, 1)
            raw = torch.where(per_item(d["hue"]),
                              torch.cat([mixed, raw[:, 3:]], dim=1), raw)
        raw = (raw * per_item(d["scale"]) + per_item(d["shift"])).clamp(0, 1)

        def center_crop(x, shape):
            # CropSampler crops around big // 2: start = big // 2 - s // 2
            return x[(slice(None), slice(None)) + tuple(
                slice(int(b // 2 - s // 2), int(b // 2 - s // 2 + s))
                for b, s in zip(big, shape))]

        return (center_crop(raw, self.cfg.input_shape).contiguous(),
                center_crop(labels, self.label_shape).contiguous(),
                self.partly[d["si"]])

    def sample_batch(self, generator: torch.Generator):
        """(raw, labels, partly) batch on the card."""
        return self.apply(self.draw(generator))

    def stop(self):
        """Prefetcher-interface no-op (no background thread to stop)."""
