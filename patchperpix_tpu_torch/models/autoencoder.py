"""Patch decoder for the ppp+dec variant.

Counterpart of ``patchperpix_tpu/models/autoencoder.py``: a flat code
vector is reshaped to a small spatial grid of ``code_fmaps`` channels,
expanded by a 1x1 conv, upsampled with resize-convs and cropped to the
patch shape, in 2D (``patchshape`` (25, 25): an s x s grid) or 3D.  The
Flax decoder reshapes codes channels-last (``(N, s, ..., s,
code_fmaps)``), so this one reshapes the same way and then permutes to
channels-first.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .unet import ConvPass, Upsample, center_crop_spatial


class PatchDecoder(nn.Module):
    def __init__(self, patchshape: Sequence[int], code_units: int = 176,
                 code_fmaps: int = 22, num_fmaps: Sequence[int] = (64, 128),
                 downsample_factors=((2, 2, 2), (2, 2, 2)),
                 kernel_size: int = 3, num_repetitions: int = 2,
                 upsampling: str = "resize_conv", activation: str = "relu"):
        super().__init__()
        self.patchshape = tuple(int(p) for p in patchshape)
        nd = self.spatial_dims = len(self.patchshape)
        if nd not in (2, 3):
            raise ValueError(f"decoder patchshape {self.patchshape}: 2 or 3 "
                             "extents (size-1 axes squeezed out)")
        self.code_units = code_units
        self.code_fmaps = code_fmaps
        s = round((code_units / code_fmaps) ** (1.0 / nd))
        if s ** nd * code_fmaps != code_units:
            raise ValueError("code_units must factor as code_fmaps * s^ndim")
        self.code_spatial = int(s)
        nf_bottom = num_fmaps[-1]
        self.ConvPass_0 = ConvPass(code_fmaps, nf_bottom, (1,) * nd, 1,
                                   "SAME", activation)
        ks = (kernel_size,) * nd
        up_features = list(reversed(num_fmaps))[1:] + [1]
        prev = nf_bottom
        self.n_up = len(up_features)
        for i, nf in enumerate(up_features):
            self.add_module(f"Upsample_{i}", Upsample(
                prev, downsample_factors[-(i + 1)], nf, upsampling,
                activation))
            self.add_module(f"ConvPass_{i + 1}", ConvPass(
                nf, nf, ks, num_repetitions, "SAME",
                activation if nf != 1 else None))
            prev = nf

    def forward(self, code: torch.Tensor) -> torch.Tensor:
        """code: (N, code_units) -> patch logits (N, *patchshape)."""
        nd = self.spatial_dims
        x = code.reshape((-1,) + (self.code_spatial,) * nd
                         + (self.code_fmaps,))
        x = x.permute(0, nd + 1, *range(1, nd + 1))
        x = self.ConvPass_0(x)
        for i in range(self.n_up):
            x = getattr(self, f"Upsample_{i}")(x)
            x = getattr(self, f"ConvPass_{i + 1}")(x)
        x = center_crop_spatial(x, self.patchshape)
        return x[:, 0]
