"""Sample loading.

Counterpart of ``patchperpix_tpu/train/data.py``, for now ``SampleData``
and ``load_sample`` (the CLI's ``predict``, ``infer_fused`` and
``evaluate_prediction`` read samples with it); the training port adds the
partly-labeled flag, the overlap points, the crop sampler and its
augmentations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import io as vio


@dataclass
class SampleData:
    raw: np.ndarray          # (C, *spatial) float32, normalized
    labels: np.ndarray       # (C_gt, *spatial) int32
    fg_mask: np.ndarray      # (*spatial) bool
    overlap_mask: np.ndarray  # (*spatial) bool


def load_sample(path: str, raw_key: str, gt_key: str,
                clipmax: float | None = None) -> SampleData:
    """Raw (clipped to ``clipmax`` and scaled to [0, 1], else scaled by its
    maximum when above 1.5) and ground-truth labels of one zarr sample,
    each with a leading channel axis."""
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
    return SampleData(raw=raw, labels=labels.astype(np.int32),
                      fg_mask=fg, overlap_mask=overlap)
