"""Label postprocessing; counterpart of ``patchperpix_tpu/utils/postprocess.py``
(reference PatchPerPix/util/postprocess.py:12-199)."""

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


def postprocess_fg(fg: np.ndarray, min_size: int = 0,
                   max_dist_to_big: float | None = None) -> np.ndarray:
    """Foreground components as instances: label the components (full
    connectivity), drop those under ``min_size`` pixels unless within
    ``max_dist_to_big`` of a big one, relabel 1..N (uint16)."""
    lab, n = connected_components(fg > 0, connectivity=fg.ndim)
    if n == 0:
        return lab.astype(np.uint16)
    counts = np.bincount(lab.ravel())
    big = np.isin(lab, np.where(counts >= max(min_size, 1))[0][1:])
    if max_dist_to_big is not None and big.any():
        dist = ndimage.distance_transform_edt(~big)
        keep = big | ((lab > 0) & (dist <= max_dist_to_big))
    else:
        keep = big
    out = lab.copy()
    out[~keep] = 0
    return relabel(out).astype(np.uint16)


def color_table(n: int, seed: int = 0) -> np.ndarray:
    """(n, 3) uint8 random colours of labels 0 .. n - 1, 0 black (the
    table ``color_labels`` indexes)."""
    rng = np.random.RandomState(seed)
    lut = rng.randint(64, 255, size=(n, 3), dtype=np.uint8)
    lut[0] = 0
    return lut


def color_labels(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """(..., 3) uint8 random colours of a label volume, 0 black."""
    return color_table(int(labels.max()) + 1, seed)[labels]


def crop_to_shape(arr: np.ndarray, shape) -> np.ndarray:
    """Centre crop of the trailing axes to ``shape``."""
    offsets = [(s - t) // 2 for s, t in zip(arr.shape[-len(shape):], shape)]
    return arr[(Ellipsis,) + tuple(slice(o, o + t)
                                   for o, t in zip(offsets, shape))]


def postprocess_instances(result_path: str, res_key: str = "vote_instances",
                          remove_small_comps: int = 600,
                          export_skeleton_nrrds: bool = False) -> str:
    """Clean an instance result in place and optionally export
    per-instance skeleton NRRDs (util/postprocess.py:76-119 semantics):
    small components removed, relabeled, written back into the result
    (the ``.hdf`` file ``label`` writes, or a zarr store) as
    ``<res_key>_rm_<N>``, uint16 or, from 65535 labels on, uint32; each
    surviving instance's skeleton saved as ``<sample>_<id>.nrrd`` beside
    the result (z / x transposed like the reference)."""
    store = vio.open_volume(result_path, mode="r+")
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
