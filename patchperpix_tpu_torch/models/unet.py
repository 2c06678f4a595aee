"""U-Net backbone (2D or 3D), valid- or same-padding.

Counterpart of ``patchperpix_tpu/models/unet.py``.  Layout is PyTorch's
channels-first (N, C, *spatial); the number of spatial dims follows the
kernel sizes and factors given (``Conv2d`` / ``ConvTranspose2d`` /
``max_pool2d`` for two, the 3D modules for three).  Submodules carry the
Flax package's auto-generated names (``ConvPass_0``, ``Conv_1``,
``Upsample_0`` ...) so that ``weights.py`` maps a parameter tree onto
this module name for name.

``ConvPass`` builds its 3D convolutions as ``Conv3d``, an ``nn.Conv3d``
with the same parameters whose weight gradient, where the call shows an
exact-float32 training step of a valid 3x3x3 convolution on the card
(``Conv3d.routed``), comes from the hand-written kernel of
``ops/conv_kernels.py`` instead of cuDNN; the forward and the input's
gradient stay on cuDNN.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_kernels import conv3d_wgrad, serves
from ..utils import trace


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


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on a CUDA card (a seam the CPU tests replace to
    run the route on the host)."""
    return x.is_cuda


class _HandWgrad(torch.autograd.Function):
    """A valid 3x3x3 convolution whose backward takes the input's gradient
    from cuDNN (``convolution_backward`` asked for that alone) and the
    weight's and bias's from ``conv3d_wgrad``; once differentiable (a
    second derivative through it raises)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return F.conv3d(x, weight, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad
        gy = gy.contiguous()
        gx = gw = gb = None
        if want_x:
            gx = torch.ops.aten.convolution_backward(
                gy, x, weight, None, [1, 1, 1], [0, 0, 0], [1, 1, 1], False,
                [0, 0, 0], 1, [True, False, False])[0]
        if want_w or want_b:
            gw, gb = conv3d_wgrad(x.contiguous(), gy)
        return gx, gw if want_w else None, gb if want_b else None


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` (same parameters, same names) whose weight gradient
    comes from ``ops/conv_kernels.py`` where ``routed`` holds; every other
    call is ``nn.Conv3d``'s.  While a profiler runs, each call that wants
    a weight gradient counts ``conv.wgrad_hand`` or ``conv.wgrad_cudnn``
    (``utils/trace.py``)."""

    def routed(self, x: torch.Tensor) -> bool:
        """Exact-f32 training of a valid 3x3x3 convolution on the card:
        CUDA float32 tensors outside autocast with cuDNN's TF32 off, a
        3x3x3 kernel of stride 1, dilation 1, no padding and one group, a
        batched input of a shape the kernel serves (``serves``: rows that
        fit its shared memory, and fewer than 128 input or output
        channels), and a weight gradient wanted."""
        return (_on_card(x) and x.dim() == 5 and x.dtype == torch.float32
                and self.weight.dtype == torch.float32
                and not torch.backends.cudnn.allow_tf32
                and not torch.is_autocast_enabled(x.device.type)
                and self.kernel_size == (3, 3, 3)
                and self.stride == (1, 1, 1) and self.padding == (0, 0, 0)
                and self.dilation == (1, 1, 1) and self.groups == 1
                and torch.is_grad_enabled() and self.weight.requires_grad
                and serves(self.in_channels, self.out_channels,
                           x.shape[-1]))

    def forward(self, x):
        if self.routed(x):
            trace.count("conv.wgrad_hand")
            return _HandWgrad.apply(x, self.weight, self.bias)
        if torch.is_grad_enabled() and self.weight.requires_grad:
            trace.count("conv.wgrad_cudnn")
        return super().forward(x)


_PASS_CONV = {2: nn.Conv2d, 3: Conv3d}


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
            self.add_module(f"Conv_{i}", _PASS_CONV[len(kernel_size)](
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
