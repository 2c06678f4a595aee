"""Label postprocessing; counterpart of ``patchperpix_tpu/utils/postprocess.py``
trimmed to the slice."""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def remove_small_components(labels: np.ndarray, min_size: int) -> np.ndarray:
    """Zero out instances smaller than ``min_size`` voxels."""
    if min_size <= 0:
        return labels
    out = labels.copy()
    ids, counts = np.unique(out[out > 0], return_counts=True)
    for i, c in zip(ids, counts):
        if c < min_size:
            out[out == i] = 0
    return out


def relabel(labels: np.ndarray) -> np.ndarray:
    """Consecutive ids 1..N, in the order of the old ids."""
    out = np.zeros_like(labels)
    for new_id, old_id in enumerate(np.unique(labels[labels > 0]), start=1):
        out[labels == old_id] = new_id
    return out


def connected_components(mask: np.ndarray, connectivity: int = 1):
    """Label a binary mask (1 = faces only, len(shape) = full)."""
    structure = ndimage.generate_binary_structure(mask.ndim, connectivity)
    lab, n = ndimage.label(mask, structure=structure)
    return lab, n


def clean_mask(mask: np.ndarray, min_size: int) -> np.ndarray:
    """Drop connected components smaller than ``min_size`` from a binary
    mask (full connectivity)."""
    lab, n = connected_components(mask > 0, connectivity=mask.ndim)
    if n == 0:
        return mask > 0
    counts = np.bincount(lab.ravel())
    keep = np.zeros(n + 1, dtype=bool)
    keep[1:] = counts[1:] >= min_size
    return keep[lab]
