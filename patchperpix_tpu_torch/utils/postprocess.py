"""Label postprocessing; counterpart of ``patchperpix_tpu/utils/postprocess.py``
trimmed to the slice."""

from __future__ import annotations

import numpy as np


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
