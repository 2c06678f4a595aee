"""Instance label renderings.

Counterpart of ``patchperpix_tpu/visualize/instances.py`` (reference
PatchPerPix/visualize/instances.py:17-79): a random-colour label image, the
z max-projection for 3D, optionally blended over or outlined on the raw
image.  The renders are computed with tensor operations on ``device`` and
equal the JAX package's numpy renders bit for bit; the PNG writer is the
port's own (``utils/io.write_png``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.io import write_png
from ..utils.postprocess import color_table


def _mip(t: torch.Tensor) -> torch.Tensor:
    while t.ndim > 2:
        t = t.amax(dim=0)
    return t


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """float32 -> uint8 scaled by its maximum (at least 1e-6), as the JAX
    package's ``(clip(r / max(r.max(), 1e-6), 0, 1) * 255).astype(uint8)``.
    The divisor stays a tensor on the image's device: PyTorch divides a
    CUDA tensor by a host scalar as a product with its reciprocal, which
    can differ from numpy's quotient in the last bit."""
    top = torch.clamp(img.max(), min=1e-6)
    return (torch.clamp(img / top, 0, 1) * 255).to(torch.uint8)


def render_instances(labels, raw=None, outline: bool = False, seed: int = 0,
                     device="cuda") -> np.ndarray:
    """(..., H, W) labels -> (H, W, 3) uint8 image (the z-MIP for 3D), over
    the raw image's MIP when ``raw`` is given: blended half and half inside
    the labels, or with ``outline`` the label boundaries, dilated by the
    cross, in the labels' colours."""
    dev = resolve_device(device)
    lab = np.asarray(labels)
    if lab.ndim == 3:
        lab = lab.max(axis=0)
    lut = color_table(int(lab.max()) + 1, seed)
    lab_t = torch.as_tensor(lab.astype(np.int64), device=dev)
    rgb = torch.as_tensor(lut, device=dev)[lab_t]
    if raw is None:
        return rgb.cpu().numpy()
    r = _mip(torch.as_tensor(np.asarray(raw, dtype=np.float32), device=dev))
    base = to_uint8(r)[..., None].expand(*r.shape, 3)
    if outline:
        edges = torch.zeros(lab_t.shape, dtype=torch.bool, device=dev)
        for ax in range(lab_t.ndim):
            d = torch.diff(lab_t, dim=ax) != 0
            edges.narrow(ax, 0, d.shape[ax]).logical_or_(d)
        # binary dilation by the cross (scipy's default structure), zero
        # outside the image
        grown = edges.clone()
        for ax in range(edges.ndim):
            n = edges.shape[ax] - 1
            grown.narrow(ax, 0, n).logical_or_(edges.narrow(ax, 1, n))
            grown.narrow(ax, 1, n).logical_or_(edges.narrow(ax, 0, n))
        out = torch.where(grown[..., None], rgb, base)
    else:
        # 0.5 a + 0.5 b of two uint8 values is exact in float32
        blend = (0.5 * base.float() + 0.5 * rgb.float()).to(torch.uint8)
        out = torch.where((lab_t > 0)[..., None], blend, base)
    return out.cpu().numpy()


def visualize_instances(labels, out_file: str, raw=None,
                        outline: bool = False, seed: int = 0,
                        device="cuda") -> str:
    """``render_instances`` written as an RGB PNG."""
    return write_png(out_file, render_instances(labels, raw=raw,
                                                outline=outline, seed=seed,
                                                device=device))


def save_mip(volume, out_file: str, device="cuda") -> str:
    """Max-intensity projection as a gray PNG scaled by its maximum
    (stitch_patch_graph.py:824-829)."""
    dev = resolve_device(device)
    v = _mip(torch.as_tensor(np.asarray(volume, dtype=np.float32),
                             device=dev))
    return write_png(out_file, to_uint8(v).cpu().numpy())
