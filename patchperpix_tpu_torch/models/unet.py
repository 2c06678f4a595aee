"""U-Net backbone (2D or 3D), valid- or same-padding.

Counterpart of ``patchperpix_tpu/models/unet.py``.  Layout is PyTorch's
channels-first (N, C, *spatial); the number of spatial dims follows the
kernel sizes and factors given (``Conv2d`` / ``ConvTranspose2d`` /
``max_pool2d`` for two, the 3D modules for three).  Submodules carry the
Flax package's auto-generated names (``ConvPass_0``, ``Conv_1``,
``Upsample_0`` ...) so that ``weights.py`` maps a parameter tree onto
this module name for name.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def center_crop_spatial(x: torch.Tensor, target_spatial) -> torch.Tensor:
    """Center-crop (N, C, *spatial) to target spatial dims."""
    spatial = x.shape[2:]
    offs = [(s - t) // 2 for s, t in zip(spatial, target_spatial)]
    sl = (slice(None), slice(None)) + tuple(
        slice(o, o + t) for o, t in zip(offs, target_spatial))
    return x[sl]


def _padding(padding: str, kernel_size) -> tuple:
    if padding.upper() == "VALID":
        return (0,) * len(kernel_size)
    # SAME with odd kernels: k // 2 on both sides, as XLA pads them
    if not all(k % 2 == 1 for k in kernel_size):
        raise ValueError(f"same padding needs odd kernels, got {kernel_size}")
    return tuple(k // 2 for k in kernel_size)


_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_MAX_POOL = {2: nn.functional.max_pool2d, 3: nn.functional.max_pool3d}


def _act(name):
    return {"relu": torch.relu, None: None}[name]


class ConvPass(nn.Module):
    """num_repetitions convs + activation."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int], num_repetitions: int = 2,
                 padding: str = "VALID", activation: str | None = "relu"):
        super().__init__()
        self.activation = _act(activation)
        pad = _padding(padding, kernel_size)
        for i in range(num_repetitions):
            self.add_module(f"Conv_{i}", _CONV[len(kernel_size)](
                in_channels if i == 0 else features, features,
                tuple(kernel_size), padding=pad))
        self.num_repetitions = num_repetitions

    def forward(self, x):
        for i in range(self.num_repetitions):
            x = getattr(self, f"Conv_{i}")(x)
            if self.activation is not None:
                x = self.activation(x)
        return x


class Upsample(nn.Module):
    """Transposed-conv or nearest-resize + 1x1-conv upsampling.

    The transposed conv is ``nn.ConvTranspose2d`` / ``3d`` with kernel =
    stride = factors; its weight is the Flax kernel spatially flipped (Flax's
    ``ConvTranspose`` does not transpose the kernel, see weights.py)."""

    def __init__(self, in_channels: int, factors: Sequence[int],
                 features: int, mode: str = "trans_conv",
                 activation: str | None = "relu"):
        super().__init__()
        self.mode = mode
        self.factors = tuple(int(f) for f in factors)
        self.activation = _act(activation)
        if mode == "trans_conv":
            self.ConvTranspose_0 = _CONV_T[len(self.factors)](
                in_channels, features, self.factors, stride=self.factors)
        elif mode == "resize_conv":
            self.Conv_0 = _CONV[len(self.factors)](in_channels, features, 1)
        else:
            raise ValueError(f"unknown upsampling mode {mode!r}")

    def forward(self, x):
        if self.mode == "trans_conv":
            x = self.ConvTranspose_0(x)
        else:
            for ax, f in enumerate(self.factors, start=2):
                x = torch.repeat_interleave(x, f, dim=ax)
            x = self.Conv_0(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class UNet(nn.Module):
    """U-Net over (N, C_in, *spatial) -> (N, out_channels, *spatial_out)."""

    def __init__(self, in_channels: int, num_fmaps: int = 20,
                 fmap_inc_factors: Sequence[float] = (3, 3, 3),
                 fmap_dec_factors: Sequence[float] = (1.2, 1.2, 1.2),
                 downsample_factors=((2, 2, 2),) * 3, kernel_size: int = 3,
                 num_repetitions: int = 2, padding: str = "valid",
                 upsampling: str = "trans_conv", activation: str = "relu"):
        super().__init__()
        self.num_fmaps = num_fmaps
        self.fmap_inc_factors = tuple(fmap_inc_factors)
        self.fmap_dec_factors = tuple(fmap_dec_factors)
        self.downsample_factors = tuple(tuple(f) for f in downsample_factors)
        pad = "VALID" if padding == "valid" else "SAME"
        self.spatial_dims = len(self.downsample_factors[0])
        ks = (kernel_size,) * self.spatial_dims
        L = self.levels
        # creation order = Flax's auto-naming order in UNet.__call__
        n_conv = 0
        prev = in_channels
        for level in range(L):
            self.add_module(f"ConvPass_{n_conv}", ConvPass(
                prev, self.level_fmaps(level), ks, num_repetitions, pad,
                activation))
            n_conv += 1
            prev = self.level_fmaps(level)
        self.add_module(f"ConvPass_{n_conv}", ConvPass(
            prev, self.level_fmaps(L), ks, num_repetitions, pad, activation))
        n_conv += 1
        prev = self.level_fmaps(L)
        for n_up, level in enumerate(reversed(range(L))):
            self.add_module(f"Upsample_{n_up}", Upsample(
                prev, self.downsample_factors[level], self.up_fmaps(level),
                upsampling, activation))
            self.add_module(f"ConvPass_{n_conv}", ConvPass(
                self.level_fmaps(level) + self.up_fmaps(level),
                self.up_fmaps(level), ks, num_repetitions, pad, activation))
            n_conv += 1
            prev = self.up_fmaps(level)

    @property
    def levels(self) -> int:
        return len(self.downsample_factors)

    def level_fmaps(self, level: int) -> int:
        f = self.num_fmaps
        for i in range(level):
            f = int(round(f * self.fmap_inc_factors[i]))
        return f

    def up_fmaps(self, level: int) -> int:
        return int(round(self.level_fmaps(level)
                         * self.fmap_dec_factors[level]))

    @property
    def out_channels(self) -> int:
        return self.up_fmaps(0)

    def forward(self, x):
        L = self.levels
        skips = []
        for level in range(L):
            x = getattr(self, f"ConvPass_{level}")(x)
            skips.append(x)
            f = self.downsample_factors[level]
            x = _MAX_POOL[self.spatial_dims](x, f, stride=f)
        x = getattr(self, f"ConvPass_{L}")(x)
        for n_up, level in enumerate(reversed(range(L))):
            x = getattr(self, f"Upsample_{n_up}")(x)
            skip = center_crop_spatial(skips[level], x.shape[2:])
            x = torch.cat([skip, x], dim=1)
            x = getattr(self, f"ConvPass_{L + 1 + n_up}")(x)
        return x
