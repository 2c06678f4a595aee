"""Masked losses and training metrics.

Counterpart of ``patchperpix_tpu/models/losses.py`` (reference
torch_loss.py): masked BCE-with-logits on patch affinities, masked CE (or
BCE) on numinst / fgbg with partly-labeled loss masks, BCE over sampled
patches, and the jaccard / accuracy / mse summaries.  ``optax``'s
``sigmoid_binary_cross_entropy`` is ``F.binary_cross_entropy_with_logits``
without reduction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ratio(total, cnt):
    """total / cnt, and 0 where cnt == 0 (the JAX package's
    ``jnp.where(cnt == 0, 0.0, total / max(cnt, 1e-30))``)."""
    return torch.where(cnt == 0, torch.zeros_like(total),
                       total / cnt.clamp(min=1e-30))


def _mean_or_sum(x):
    # an empty tensor's mean is nan; the JAX package returns its sum, 0
    return x.sum() if x.numel() == 0 else x.mean()


def masked_bce_logits(logits, targets, mask=None, num_channels=1.0):
    """MaskedBCEWithLogitsLoss (torch_loss.py:47-67).

    mask: (B, Cm, *sp) or None; channel 1 is used when Cm > 1 (the fg
    channel of the 3-class mask), channel 0 otherwise."""
    loss = F.binary_cross_entropy_with_logits(logits, targets,
                                              reduction="none")
    if mask is None:
        return _mean_or_sum(loss)
    m = mask[:, 0 if mask.shape[1] == 1 else 1]
    cnt = m.sum() * num_channels
    return _ratio((loss * m[:, None]).sum(), cnt)


def masked_ce(logits, targets_int, mask=None, use_gt_extra=False):
    """MaskedCrossEntropyLoss (torch_loss.py:12-44).

    logits: (B, K, *sp); targets_int: (B, *sp) integers."""
    logp = F.log_softmax(logits, dim=1)
    onehot = F.one_hot(targets_int.long(), logits.shape[1]).movedim(
        -1, 1).to(logits.dtype)
    loss = -(logp * onehot)
    if mask is None:
        return _mean_or_sum(loss.sum(dim=1))
    if use_gt_extra:
        return _ratio((loss * mask).sum(), mask.sum())
    per_pix = loss.sum(dim=1)
    m = mask[:, 0] if mask.ndim == per_pix.ndim + 1 else mask
    return _ratio((per_pix * m).sum(), m.sum())


def sampled_bce(logits, targets, valid=None):
    """BCE over sampled patches (the ppp+dec path): (N, *ps) with a
    per-sample validity mask (rows of batch items without foreground are
    left out)."""
    loss = F.binary_cross_entropy_with_logits(logits, targets,
                                              reduction="none")
    if valid is None:
        return loss.mean()
    v = valid.to(loss.dtype).reshape((-1,) + (1,) * (loss.ndim - 1))
    cnt = v.sum() * float(loss[0].numel())
    return _ratio((loss * v).sum(), cnt)


def binary_jaccard(pred, target, thresh=0.5):
    p = pred > thresh
    t = target > thresh
    inter = (p & t).sum()
    union = (p | t).sum()
    return torch.where(union == 0, 0.0,
                       inter / union.clamp(min=1)).float()


def binary_accuracy(pred, target, thresh=0.5, ignore_bg=False):
    p = pred > thresh
    t = target > thresh
    if ignore_bg:
        cnt = t.sum()
        return torch.where(cnt == 0, 0.0,
                           ((p == t) & t).sum() / cnt.clamp(min=1)).float()
    return (p == t).float().mean()


def mse(pred, target):
    return ((pred - target) ** 2).mean()


def summaries(pred_affs_prob, gt_affs, pred_fg_prob, gt_fg):
    """The torch_loss.py:99-117 metric dict."""
    return {
        "jaccard_patch": binary_jaccard(pred_affs_prob, gt_affs),
        "accuracy_patch": binary_accuracy(pred_affs_prob, gt_affs),
        "accuracy2_patch": binary_accuracy(pred_affs_prob, gt_affs,
                                           ignore_bg=True),
        "mse_patch": mse(pred_affs_prob, gt_affs),
        "jaccard_fg": binary_jaccard(pred_fg_prob, gt_fg),
        "accuracy_fg": binary_accuracy(pred_fg_prob, gt_fg),
        "accuracy2_fg": binary_accuracy(pred_fg_prob, gt_fg,
                                        ignore_bg=True),
        "mse_fg": mse(pred_fg_prob, gt_fg),
    }
