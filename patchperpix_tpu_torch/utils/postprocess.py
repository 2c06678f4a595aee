"""Label postprocessing; counterpart of ``patchperpix_tpu/utils/postprocess.py``
trimmed to what the port's paths run (``postprocess_fg``, ``color_labels``
and ``crop_to_shape`` are not ported)."""

from __future__ import annotations

import os

import numpy as np
from scipy import ndimage

from . import io as vio
from .skeleton import skeletonize


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


def postprocess_instances(result_path: str, res_key: str = "vote_instances",
                          remove_small_comps: int = 600,
                          export_skeleton_nrrds: bool = False) -> str:
    """Clean an instance result store in place and optionally export
    per-instance skeleton NRRDs (util/postprocess.py:76-119 semantics):
    small components removed, relabeled, written back into the zarr store
    as ``<res_key>_rm_<N>``; each surviving instance's skeleton saved as
    ``<sample>_<id>.nrrd`` beside the store (z / x transposed like the
    reference)."""
    store = vio.IoZarr(result_path, mode="r+")
    inst = store.read(key=res_key)
    cleaned = relabel(remove_small_components(inst, remove_small_comps))
    cleaned = cleaned.astype(np.uint16 if cleaned.max() < 65535
                             else np.uint32)
    new_key = f"{res_key}_rm_{remove_small_comps}"
    store.create(new_key, cleaned.shape, cleaned.dtype)
    store.write(cleaned, key=new_key)
    store.close()

    if export_skeleton_nrrds:
        out_dir = os.path.dirname(result_path.rstrip("/"))
        name = os.path.splitext(os.path.basename(result_path.rstrip("/")))[0]
        flat = cleaned if cleaned.ndim == 3 else np.max(cleaned, axis=0)
        for label in np.unique(flat[flat > 0]):
            sk = (skeletonize(flat == label) > 0).astype(np.uint8)
            vio.write_nrrd(
                os.path.join(out_dir, f"{name}_{int(label)}.nrrd"),
                np.transpose(sk, (2, 1, 0)))
    return result_path
