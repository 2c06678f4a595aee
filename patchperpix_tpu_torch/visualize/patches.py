"""Patch-prediction mosaics.

Counterpart of ``patchperpix_tpu/visualize/patches.py`` (reference
PatchPerPix/visualize/patches.py:12-203): the (prod(ps), *vol) affinities
tiled so that each volume pixel becomes a ps_y x ps_x tile of its
predicted patch; 3D volumes are max-projected over the patch z and, unless
one volume plane ``z`` is asked for, over the volume z; grid lines separate
the tiles, and the tiles of selected patch centers get value-1 borders.
Computed with tensor operations on ``device``; equal to the JAX package's
mosaic bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.io import save_tif, write_png


def patch_mosaic(affs, patchshape, z: int | None = None, selected=None,
                 grid_value: float = 0.5, device="cuda") -> np.ndarray:
    """(P, *vol) -> (H * ps_y, W * ps_x) float32 mosaic."""
    dev = resolve_device(device)
    ps = tuple(int(p) for p in patchshape)
    a = torch.as_tensor(np.asarray(affs), device=dev)
    vol_shape = tuple(a.shape[1:])
    a = a.reshape(ps + vol_shape)
    if len(vol_shape) == 3:
        if z is not None:
            a = a[:, :, :, z]          # (psz, psy, psx, H, W)
        a = a.amax(dim=0)              # project the patch z
        if z is None:
            a = a.amax(dim=2)          # project the volume z
        psy, psx = ps[1], ps[2]
    else:
        psy, psx = ps[-2], ps[-1]
        a = a.reshape(psy, psx, *vol_shape[-2:])
    H, W = a.shape[2], a.shape[3]
    mosaic = a.permute(2, 0, 3, 1).reshape(H * psy, W * psx).clone()
    mosaic[::psy, :] = grid_value
    mosaic[:, ::psx] = grid_value
    if selected is not None:
        for c in selected:
            y, x = int(c[-2]), int(c[-1])
            mosaic[y * psy, x * psx:(x + 1) * psx] = 1.0
            mosaic[y * psy:(y + 1) * psy, x * psx] = 1.0
    return mosaic.cpu().numpy()


def mosaic_png(mosaic: np.ndarray) -> np.ndarray:
    """The mosaic as the uint8 image its PNG holds."""
    return (np.clip(mosaic, 0, 1) * 255).astype(np.uint8)


def visualize_patches(affs, patchshape, out_file: str,
                      z: int | None = None, selected=None,
                      device="cuda") -> str:
    """The mosaic as a gray PNG, or as a float32 TIF when ``out_file`` ends
    in .tif (reference visualize/patches.py:190-198)."""
    mosaic = patch_mosaic(np.asarray(affs, dtype=np.float32), patchshape,
                          z=z, selected=selected, device=device)
    if out_file.endswith(".tif"):
        return save_tif(out_file, mosaic.astype(np.float32))
    return write_png(out_file, mosaic_png(mosaic))
