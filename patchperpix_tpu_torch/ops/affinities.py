"""Ground-truth patch affinities, and the sampling of code locations.

Counterpart of ``patchperpix_tpu/ops/affinities.py``:

- ``gt_affinities_sampled``: per sampled window corner, the label window
  compared against its centre (the ppp+dec training path);
- ``gt_affinities_dense``: all pixels at once from shifted slices (the
  direct-affinity path, and the evaluation of predictions);
- ``sample_fg_corners`` / ``gather_at``: foreground locations drawn with
  replacement, and the feature vectors there.

All of them run on the device of their inputs.

Multi-channel ground truth encodes overlapping instances one per channel;
the affinity of pixel x to x + offset is 1 iff some channel carries the
same non-zero label at both, gated on both pixels being foreground in any
channel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def _unravel(idx: torch.Tensor, shape) -> torch.Tensor:
    """C-order coordinates (..., len(shape)) of flat indices, on their
    device with Python-int divisors (``torch.unravel_index`` copies its
    strides from the host on every call, a synchronisation in a loop that
    must have none)."""
    out = []
    for s in reversed(tuple(int(s) for s in shape)):
        out.append(idx % s)
        idx = idx // s
    return torch.stack(out[::-1], dim=-1)


@torch.no_grad()
def gt_affinities_sampled(labels: torch.Tensor, corners: torch.Tensor,
                          patchshape) -> torch.Tensor:
    """labels (B, C, *S) integers; corners (N, 1 + ndim) window top-left
    (batch index first), windows inside the labels.  Returns (N, P)
    float32 affinities, P over the window in C order.

    The window centre is at corner + ps // 2: the sampled foreground
    location is the *corner* into the context-padded labels
    (train_util.py:457-478)."""
    ps = tuple(int(p) for p in patchshape)
    offs = _unravel(torch.arange(int(np.prod(ps)), device=labels.device),
                    ps)                                      # (P, nd)
    corners = corners.to(device=labels.device, dtype=torch.int64)
    idx = corners[:, None, 1:] + offs[None]                  # (N, P, nd)
    b = corners[:, :1].expand(-1, offs.shape[0])             # (N, P)
    win = labels[(b, slice(None)) + tuple(idx.unbind(-1))]   # (N, P, C)
    mid = int(np.ravel_multi_index(tuple(p // 2 for p in ps), ps))
    center = win[:, mid:mid + 1]                             # (N, 1, C)
    same = ((win == center) & (center != 0)).any(dim=-1)
    fg = (win != 0).any(dim=-1)                              # (N, P)
    return (same & fg[:, mid:mid + 1] & fg).float()


@torch.no_grad()
def sample_fg_corners(gt_fg: torch.Tensor, sample_cnt: int,
                      generator: torch.Generator | None = None):
    """``sample_cnt`` foreground locations per batch item, with
    replacement (``torch.multinomial``), on the device of ``gt_fg``.

    gt_fg: (B, *S) bool.  Returns (corners (B * sample_cnt, 1 + ndim)
    int64, valid (B * sample_cnt,) bool).  A batch item with no foreground
    gives valid = False rows (the reference skips them,
    torch_model.py:344-346); their corners are drawn uniformly over the
    item, so they stay in range and gather_at never leaves the volume."""
    B, spatial = gt_fg.shape[0], tuple(gt_fg.shape[1:])
    flat = gt_fg.reshape(B, -1)
    has_fg = flat.any(dim=1)
    w = torch.where(has_fg[:, None], flat, True).float()
    idx = torch.multinomial(w, sample_cnt, replacement=True,
                            generator=generator)            # (B, N)
    coords = _unravel(idx, spatial)
    b_col = torch.arange(B, device=gt_fg.device)[:, None, None].expand(
        B, sample_cnt, 1)
    corners = torch.cat([b_col, coords], dim=-1)
    valid = has_fg[:, None].expand(B, sample_cnt)
    return corners.reshape(-1, 1 + len(spatial)), valid.reshape(-1)


def gather_at(volume: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """Feature vectors at (batch, *coords) locations: volume (B, *S, F),
    corners (N, 1 + ndim) -> (N, F) (gather_nd_torch_no_batch,
    train_util.py:305-345)."""
    corners = corners.to(device=volume.device, dtype=torch.int64)
    return volume[tuple(corners.unbind(-1))]


@torch.no_grad()
def gt_affinities_dense(labels, patchshape, device="cuda") -> torch.Tensor:
    """labels (B, C, *S) integers (numpy or tensor) -> (B, P, *(S - 2 *
    (ps // 2))) float32 on ``device``: channel p at interior pixel x
    compares x with x + offset(p) - rad, so the output covers the pixels
    whose whole patch window is in bounds.  All P offsets at once, through
    a strided view of the labels (one pass of a few kernels, not a loop of
    P: at 25x25 patches the loop's ~4,000 launches were most of a
    training step)."""
    dev = resolve_device(device)
    if not torch.is_tensor(labels):
        labels = torch.from_numpy(np.asarray(labels, dtype=np.int64))
    labels = labels.to(device=dev, dtype=torch.int64).contiguous()
    ps = tuple(int(p) for p in patchshape)
    rad = [p // 2 for p in ps]
    spatial = labels.shape[2:]
    out_sp = tuple(int(s - 2 * r) for s, r in zip(spatial, rad))
    nd = len(ps)
    # win[b, c, q, x] = labels[b, c, x + q]: q over the patch, x over the
    # interior (both in C order, so q flattens to the patch index p)
    st = labels.stride()
    win = labels.as_strided(labels.shape[:2] + ps + out_sp,
                            st[:2] + st[2:] + st[2:])
    center = labels[(slice(None), slice(None)) + tuple(
        slice(r, r + o) for r, o in zip(rad, out_sp))]
    center = center.reshape(center.shape[:2] + (1,) * nd + out_sp)
    same = ((win == center) & (center != 0)).any(dim=1)
    fg_other = (win != 0).any(dim=1)
    fg_center = (center != 0).any(dim=1)
    out = same & fg_other & fg_center
    return out.reshape((labels.shape[0], int(np.prod(ps))) + out_sp).float()
