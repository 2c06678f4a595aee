"""Flip test-time averaging (TTA) for ppp / ppp+dec prediction.

Counterpart of ``patchperpix_tpu/infer/tta.py``: the ``2^d`` spatial
flips of the input are each predicted by the same model, and each
prediction is mapped back to the canonical orientation before averaging.
Mapping a flipped patch-affinity volume back takes a spatial unflip and a
permutation of the patch channels: channel p encodes the offset
off(p) - rad, whose flipped-axis coordinates mirror with the volume
(o_a -> ps_a - 1 - o_a).  That keeps the center fixed only for odd patch
extents, so ``flip_channel_perm`` refuses even ones.  numinst / fg heads
only unflip spatially.

For direct-affinity models ``predict_tta`` adds each unflipped head 1
into one running sum inside the flip loop instead of keeping all 2^ndim
volumes.  For ppp+dec the codes are not flip-equivariant: ``decode_tta``
decodes each flip's codes at the flipped foreground and averages the
decoded patch probabilities.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["all_flips", "flip_channel_perm", "unflip_affs", "unflip_volume",
           "predict_tta", "average_affs", "decode_tta"]


def all_flips(ndim: int):
    """All 2^ndim spatial-axis subsets, identity first."""
    return [tuple(i for i, b in enumerate(bits) if b)
            for bits in itertools.product((False, True), repeat=ndim)]


def flip_channel_perm(patchshape, axes) -> np.ndarray:
    """Channel permutation matching a spatial flip of ``axes``: an
    involution with ``canonical_affs = unflipped_affs[perm]``.  Every
    patch extent must be odd (an even extent has no fixed center)."""
    ps = tuple(int(p) for p in patchshape)
    if any(p % 2 == 0 for p in ps):
        raise ValueError(f"flip TTA needs odd patch extents, got {ps}")
    idx = np.arange(int(np.prod(ps)), dtype=np.int64).reshape(ps)
    for a in axes:
        idx = np.flip(idx, axis=a)
    return np.ascontiguousarray(idx).reshape(-1)


def unflip_affs(affs, axes, patchshape):
    """A flipped-orientation affinity volume (P, *vol), numpy or tensor,
    in the canonical orientation: spatial unflip + channel permutation."""
    if not axes:
        return affs
    spatial_axes = tuple(a + 1 for a in axes)
    perm = flip_channel_perm(patchshape, axes)
    if isinstance(affs, np.ndarray):
        return np.flip(affs, spatial_axes)[perm]
    return torch.flip(affs, spatial_axes)[torch.as_tensor(
        perm, device=affs.device)]


def unflip_volume(vol, axes):
    """Spatially unflip a (C, *vol) head (no channel permutation)."""
    if not axes:
        return vol
    spatial_axes = tuple(a + 1 for a in axes)
    if isinstance(vol, np.ndarray):
        return np.flip(vol, spatial_axes)
    return torch.flip(vol, spatial_axes)


def predict_tta(model, raw: np.ndarray, cfg, input_shape, output_shape,
                flips=None, device="cuda"):
    """Predict the requested flips of ``raw`` (default: all).

    Returns ``(heads1, prob_mean)``.  ppp+dec: ``heads1`` lists
    ``(axes, code)`` in FLIPPED orientation, for ``decode_tta``.  Direct
    affinities: each flip's head 1 is unflipped and added to one running
    sum in the loop, and ``heads1`` is ``[((), mean)]`` (canonical), which
    ``average_affs`` returns as it is.  ``prob_mean`` is the flip-averaged
    head 2 in canonical orientation; all tensors on ``device``."""
    from .fused import predict_volume_device

    ndim = raw.ndim - 1
    if flips is None:
        flips = all_flips(ndim)
    ps = tuple(int(p) for p in cfg.patchshape_squeezed)
    heads1, aff_sum, prob_sum = [], None, None
    for axes in flips:
        raw_f = np.flip(raw, tuple(a + 1 for a in axes)) if axes else raw
        h1, h2 = predict_volume_device(model, np.ascontiguousarray(raw_f),
                                       cfg, input_shape, output_shape,
                                       device=device)
        if cfg.train_code:
            heads1.append((axes, h1))
        else:
            a = unflip_affs(h1, axes, ps)
            aff_sum = a if aff_sum is None else aff_sum + a
        h2c = unflip_volume(h2, axes)
        prob_sum = h2c if prob_sum is None else prob_sum + h2c
    if not cfg.train_code:
        heads1 = [((), aff_sum / float(len(flips)))]
    return heads1, prob_sum / float(len(flips))


def average_affs(heads1, patchshape):
    """Average direct-affinity heads over flips."""
    acc = None
    for axes, h1 in heads1:
        a = unflip_affs(h1, axes, patchshape)
        acc = a if acc is None else acc + a
    return acc / float(len(heads1))


def decode_tta(model, heads1, fg_mask: np.ndarray, cfg,
               batch_size: int = 4096, device="cuda"):
    """ppp+dec: decode each flip's codes at the flipped CANONICAL
    foreground ``fg_mask`` (every flip decodes the same voxel set),
    unflip the decoded patch probabilities, and average."""
    from .fused import decode_volume_device

    ps = tuple(int(p) for p in cfg.patchshape_squeezed)
    acc = None
    for axes, code in heads1:
        fg_f = np.flip(fg_mask, axes) if axes else fg_mask
        affs_f = decode_volume_device(model, code, np.ascontiguousarray(fg_f),
                                      cfg, batch_size=batch_size,
                                      device=device)
        a = unflip_affs(affs_f, axes, ps)
        acc = a if acc is None else acc + a
    return acc / float(len(heads1))
