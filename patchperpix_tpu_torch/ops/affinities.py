"""Ground-truth patch affinities.

Counterpart of ``patchperpix_tpu/ops/affinities.py``, for now its
``gt_affinities_dense`` only (the evaluation of predictions uses it; the
training port adds the sampled variant and reuses this one).

Multi-channel ground truth encodes overlapping instances one per channel;
the affinity of pixel x to x + offset is 1 iff some channel carries the
same non-zero label at both, gated on both pixels being foreground in any
channel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .np_reference import patch_offsets


@torch.no_grad()
def gt_affinities_dense(labels, patchshape, device="cuda") -> torch.Tensor:
    """labels (B, C, *S) integers (numpy or tensor) -> (B, P, *(S - 2 *
    (ps // 2))) float32 on ``device``: channel p at interior pixel x
    compares x with x + offset(p) - rad, so the output covers the pixels
    whose whole patch window is in bounds."""
    dev = resolve_device(device)
    if not torch.is_tensor(labels):
        labels = torch.from_numpy(np.asarray(labels, dtype=np.int64))
    labels = labels.to(device=dev, dtype=torch.int64)
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    spatial = np.array(labels.shape[2:])
    out_sp = tuple(int(s - 2 * r) for s, r in zip(spatial, rad))
    fg = (labels != 0).any(dim=1)                        # (B, *S)
    center_sl = tuple(slice(int(r), int(r + o)) for r, o in zip(rad, out_sp))
    center = labels[(slice(None), slice(None)) + center_sl]
    fg_center = fg[(slice(None),) + center_sl]
    out = torch.empty((labels.shape[0], len(patch_offsets(ps))) + out_sp,
                      dtype=torch.float32, device=dev)
    for p, start in enumerate(patch_offsets(ps)):
        sl = tuple(slice(int(s), int(s + o)) for s, o in zip(start, out_sp))
        other = labels[(slice(None), slice(None)) + sl]
        same = ((center == other) & (center != 0)).any(dim=1)
        out[:, p] = (same & fg_center & fg[(slice(None),) + sl]).float()
    return out
