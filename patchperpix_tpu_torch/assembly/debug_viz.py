"""Debug renderings of the assembly's internals.

Counterpart of ``patchperpix_tpu/assembly/debug_viz.py`` (reference
seams, SURVEY §4):

- ``vote_debug``: every foreground pixel's predicted patch tiled at its
  position in a (ps * vol) canvas with grid lines (vote_instances.py:
  270-274, 341-360);
- ``vote_debug2``: the selected patch-graph edges drawn as weight-valued
  lines between tile centers (graph_to_labeling.py:118-137).

As in the JAX package, 2D data renders the whole canvas and 3D data one
z-plane (default the middle), a (ps_y * Y, ps_x * X) image of that
plane's patch predictions: the reference's full (ps * Z, ps * Y, ps * X)
canvas would be 171 GB at FlyLight scale.  ``render_patch_tiles`` is one
reshape and permute of the patch plane on ``device``, masked by the
foreground, where the JAX package loops over the foreground pixels; the
canvas is the same bit for bit.  ``render_graph_edges`` is the JAX
package's host loop.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def _line(r0, c0, r1, c1):
    """Integer pixel coordinates of the segment (skimage.draw.line's
    role)."""
    n = int(max(abs(r1 - r0), abs(c1 - c0))) + 1
    rr = np.linspace(r0, r1, n).round().astype(np.int64)
    cc = np.linspace(c0, c1, n).round().astype(np.int64)
    return rr, cc


def render_patch_tiles(affs, foreground, patchshape, z: int | None = None,
                       grid_value: float = 2.0,
                       device="cuda") -> np.ndarray:
    """Tiled patch canvas (vote_instances.py:341-360).

    affs: (P, Z, Y, X) array or tensor; foreground: (Z, Y, X).  Returns the
    (ps_y * Y, ps_x * X) float32 canvas of plane ``z`` (the patch's own-z
    channel plane), the whole image for 2D-lifted input (Z == 1)."""
    dev = resolve_device(device)
    psz, psy, psx = (int(p) for p in patchshape)
    a = torch.as_tensor(affs, device=dev).to(torch.float32)
    fg = torch.as_tensor(np.asarray(foreground) > 0, device=dev)
    Z, Y, X = fg.shape
    if z is None:
        z = 0 if Z == 1 else Z // 2
    # flat channel index (pz, py, px): the pz center plane, volume plane z
    plane = a.reshape(psz, psy, psx, Z, Y, X)[psz // 2, :, :, z]
    plane = torch.where(fg[z], plane, torch.zeros((), device=dev))
    canvas = plane.permute(2, 0, 3, 1).reshape(psy * Y, psx * X).clone()
    # grid lines (graph_to_labeling.py:119-126 paints instance_value + 2)
    canvas[::psy, :] = grid_value
    canvas[:, ::psx] = grid_value
    return canvas.cpu().numpy()


def render_graph_edges(pairs, weights, vol_shape,
                       patchshape) -> np.ndarray:
    """Edge-weight line canvas (graph_to_labeling.py:128-137).

    pairs: (E, 2 * d) voxel coordinates of the two patch centers of each
    edge; weights: (E,).  Edges are projected along z (the reference draws
    on debug_output2[0]); returns (ps_y * Y, ps_x * X) float32 where each
    drawn pixel holds the largest edge weight crossing it."""
    _, Y, X = vol_shape
    psy, psx = int(patchshape[1]), int(patchshape[2])
    canvas = np.zeros((psy * Y, psx * X), np.float32)
    pairs = np.asarray(pairs)
    weights = np.asarray(weights, np.float32)
    if len(pairs) == 0:
        return canvas
    d = pairs.shape[1] // 2
    for p, w in zip(pairs, weights):
        (y0, x0), (y1, x1) = p[:d][-2:], p[d:][-2:]
        rr, cc = _line(int(y0) * psy + psy // 2, int(x0) * psx + psx // 2,
                       int(y1) * psy + psy // 2, int(x1) * psx + psx // 2)
        keep = (rr >= 0) & (rr < canvas.shape[0]) & \
            (cc >= 0) & (cc < canvas.shape[1])
        rr, cc = rr[keep], cc[keep]
        canvas[rr, cc] = np.maximum(canvas[rr, cc], float(w))
    return canvas
