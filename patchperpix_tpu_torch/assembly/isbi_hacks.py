"""ISBI 2012 assembly tweaks, copied from
``patchperpix_tpu/assembly/isbi_hacks.py``.

For the dense EM-neurite benchmark the candidate patch grid is sparsified
(only centers on a fixed coordinate grid are candidates) and pixels on
instance boundaries are removed from the mask to cover, by how many
patches' dilation rings hold them (reference
PatchPerPix/vote_instances/isbi_hacks.py:10-49).  Host numpy, as in the
JAX package: ``sparsify_patches`` runs on the candidate list, the other
two only on stacks of more than one slice (the reference's three-slice
ISBI stack keeps slice z = 1).
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_dilation

from ..ops.np_reference import patch_offsets


def sparsify_patches(all_patches, stride: int = 20, vol_shape=None):
    """Keep the patches on the sparse coordinate grid ``coord % stride ==
    1`` on every axis (isbi_hacks.py:10-14): a fixed grid over the volume,
    not every Nth list element.

    Flat axes (volume extent 1) always pass: the reference's ISBI stack
    keeps slice z = 1, which passes ``1 % 20 == 1``; a single-slice volume
    has only z = 0, which must not empty the candidate grid."""
    if not all_patches:
        return all_patches
    pts = np.asarray(list(all_patches), dtype=np.int64)
    on_grid = pts % stride == 1
    if vol_shape is not None:
        on_grid |= (np.asarray(vol_shape, dtype=np.int64) == 1)[None, :]
    return [tuple(p) for p in pts[np.all(on_grid, axis=1)]]


def keep_single_slice(foreground: np.ndarray) -> np.ndarray:
    """Keep only z-slice 1 as foreground (vote_instances.py:215-218)."""
    out = foreground.copy()
    out[0] = 0
    out[2:] = 0
    return out


def _ball(radius: int) -> np.ndarray:
    """3D ball structuring element, z^2 + y^2 + x^2 <= r^2 (as
    skimage.morphology.ball)."""
    zz, yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1,
                          -radius:radius + 1]
    return (zz * zz + yy * yy + xx * xx) <= radius * radius


def filter_instance_boundaries_from_fg(
    pred_affs: np.ndarray,
    foreground: np.ndarray,
    all_patches,
    patchshape,
    mask_to_cover: np.ndarray,
    boundary_count_factor: float = 0.33,
    patch_threshold: float = 0.5,
) -> np.ndarray:
    """Remove likely instance-boundary pixels from the cover mask
    (isbi_hacks.py:34-48 with get_patch_sets.py's ``get_boundary_set``):
    each in-bounds patch, thresholded at ``patch_threshold`` and grown by a
    radius-2 ball, contributes its dilation ring (grown minus patch); a
    pixel leaves the mask when it lies in the rings of at least
    ``boundary_count_factor * prod(patchshape[1:])`` patches.
    ``pred_affs`` is the (P, *vol) stack on the host."""
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    offs = patch_offsets(ps)
    vol_shape = np.array(foreground.shape)
    centers = np.asarray(list(all_patches), dtype=np.int64).reshape(
        -1, len(vol_shape))
    if centers.size:
        ok = np.all(centers >= rad, axis=1) & np.all(
            centers + rad + 1 <= vol_shape, axis=1)
        centers = centers[ok]
    if not centers.size:
        return mask_to_cover.astype(bool).copy()

    # all patch windows at once, (N, *ps) binary; one 4D dilation with no
    # connectivity across the patch axis (the reference dilates each patch
    # alone, border value 0)
    patches = pred_affs[(slice(None),) + tuple(centers.T)].T
    patches = (patches > patch_threshold).reshape(
        (len(centers),) + tuple(ps))
    grown = binary_dilation(patches, structure=_ball(2)[None])
    ring = grown & ~patches

    # one count per patch whose ring holds the pixel (the reference also
    # ANDs with an all-ones foreground, a no-op)
    tgt = (centers[:, None, :] + offs[None] - rad[None, None]).reshape(
        -1, len(vol_shape))
    boundary_count = np.zeros(foreground.shape, dtype=np.int64)
    np.add.at(boundary_count, tuple(tgt.T), ring.reshape(-1))
    return np.logical_and(
        mask_to_cover.astype(bool),
        boundary_count < boundary_count_factor * np.prod(ps[1:]))
