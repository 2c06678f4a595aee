"""U-Net backbone (2D or 3D), valid- or same-padding.

Counterpart of ``patchperpix_tpu/models/unet.py``.  Layout is PyTorch's
channels-first (N, C, *spatial); the number of spatial dims follows the
kernel sizes and factors given (``Conv2d`` / ``ConvTranspose2d`` /
``max_pool2d`` for two, the 3D modules for three).  Submodules carry the
Flax package's auto-generated names (``ConvPass_0``, ``Conv_1``,
``Upsample_0`` ...) so that ``weights.py`` maps a parameter tree onto
this module name for name.

The 3D convolutions are ``Conv3d`` and ``ConvTranspose3d``, the
``nn.Conv3d`` / ``nn.ConvTranspose3d`` with the same parameters whose
weight gradient, where the call shows an exact-float32 training step on
the card (``route`` names a kernel), comes from a hand-written kernel of
``ops/conv_kernels.py`` instead of cuDNN: a valid or SAME 3x3x3
convolution's from W1, a pointwise one's and a transposed one's with
kernel = stride from W2.  The forward and the input's gradient stay on
cuDNN.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_kernels import conv1_wgrad, conv3d_wgrad, conv_t_wgrad, serves
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


_MAX_POOL = {2: nn.functional.max_pool2d, 3: nn.functional.max_pool3d}


def _on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies on a CUDA card (a seam the CPU tests replace to
    run the route on the host)."""
    return x.is_cuda


# Counter prefixes (``utils/trace.py``): each call that wants a weight
# gradient counts ``<prefix>_hand`` or ``<prefix>_cudnn``
WGRAD_COUNTER = "conv.wgrad"            # a 3D ``ConvPass`` convolution
HEAD_UP_COUNTER = "conv.head_up_wgrad"  # a 3D head or upsampling one


def _exact_f32_grad(x: torch.Tensor, weight: torch.Tensor) -> bool:
    """An exact-f32 training call on the card: CUDA float32 tensors (a
    batched 3D input) outside autocast, cuDNN's TF32 off, and a weight
    gradient wanted."""
    return (_on_card(x) and x.dim() == 5 and x.dtype == torch.float32
            and weight.dtype == torch.float32
            and not torch.backends.cudnn.allow_tf32
            and not torch.is_autocast_enabled(x.device.type)
            and torch.is_grad_enabled() and weight.requires_grad)


def _input_grad(gy, x, weight, stride, padding, transposed):
    """cuDNN's gradient of the input alone (``convolution_backward`` asked
    for that and nothing else)."""
    return torch.ops.aten.convolution_backward(
        gy, x, weight, None, list(stride), [padding] * 3, [1, 1, 1],
        transposed, [0, 0, 0], 1, [True, False, False])[0]


class _HandWgrad(torch.autograd.Function):
    """A 3x3x3 convolution, valid (``padding`` 0) or SAME (1), whose
    backward takes the input's gradient from cuDNN and the weight's and
    bias's from ``conv3d_wgrad`` (W1) of the input zero-padded by
    ``padding``; once differentiable (a second derivative through it
    raises)."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding=0):
        ctx.save_for_backward(x, weight)
        ctx.padding = padding
        return F.conv3d(x, weight, bias, padding=padding)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        p = ctx.padding
        gy = gy.contiguous()
        gx = gw = gb = None
        if want_x:
            gx = _input_grad(gy, x, weight, (1, 1, 1), p, False)
        if want_w or want_b:
            gw, gb = conv3d_wgrad(
                (F.pad(x, (p,) * 6) if p else x).contiguous(), gy)
        return gx, gw if want_w else None, gb if want_b else None, None


class _GemmWgrad(torch.autograd.Function):
    """A pointwise 3D convolution (``stride`` (1, 1, 1)) or a transposed
    one whose kernel equals its ``stride``, whose backward takes the
    input's gradient from cuDNN and the weight's and bias's from W2
    (``conv1_wgrad`` / ``conv_t_wgrad``); once differentiable."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride):
        ctx.save_for_backward(x, weight)
        ctx.stride = stride
        if stride == (1, 1, 1):
            return F.conv3d(x, weight, bias)
        return F.conv_transpose3d(x, weight, bias, stride=stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        x, weight = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        f = ctx.stride
        transposed = f != (1, 1, 1)
        gy = gy.contiguous()
        gx = gw = gb = None
        if want_x:
            gx = _input_grad(gy, x, weight, f, 0, transposed)
        if want_w or want_b:
            xc = x.contiguous()
            gw, gb = conv_t_wgrad(xc, gy, f) if transposed else \
                conv1_wgrad(xc, gy)
        return gx, gw if want_w else None, gb if want_b else None, None


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` (same parameters, same names) whose weight gradient
    comes from ``ops/conv_kernels.py`` where ``route`` names a kernel;
    every other call is ``nn.Conv3d``'s.  While a profiler runs, each call
    that wants a weight gradient counts ``<counter>_hand`` or
    ``<counter>_cudnn`` (``utils/trace.py``): ``WGRAD_COUNTER`` for a
    ``ConvPass`` convolution, ``HEAD_UP_COUNTER`` for a head or an
    upsampling convolution."""

    def __init__(self, *args, counter: str = WGRAD_COUNTER, **kwargs):
        super().__init__(*args, **kwargs)
        self.counter = counter

    def route(self, x: torch.Tensor) -> str | None:
        """"W1", "W2" or None.  An exact-f32 training call on the card
        (``_exact_f32_grad``) of stride 1, dilation 1, one group and zero
        padding mode takes W2 for a pointwise convolution, and W1 for a
        3x3x3 one, valid or SAME, where the kernel serves its shape
        (``serves``: rows of the padded input that fit its shared memory,
        fewer than 128 input or output channels, and on rows of 5 to 8
        values fewer than 512 channel pairs)."""
        if not (_exact_f32_grad(x, self.weight)
                and self.stride == (1, 1, 1) and self.dilation == (1, 1, 1)
                and self.groups == 1 and self.padding_mode == "zeros"):
            return None
        if self.kernel_size == (1, 1, 1) and self.padding == (0, 0, 0):
            return "W2"
        if self.kernel_size == (3, 3, 3) and self.padding in (
                (0, 0, 0), (1, 1, 1)) and serves(
                    self.in_channels, self.out_channels,
                    x.shape[-1] + 2 * self.padding[0]):
            return "W1"
        return None

    def forward(self, x):
        route = self.route(x)
        if route is not None:
            trace.count(self.counter + "_hand")
            if route == "W2":
                return _GemmWgrad.apply(x, self.weight, self.bias, (1, 1, 1))
            return _HandWgrad.apply(x, self.weight, self.bias,
                                    self.padding[0])
        if torch.is_grad_enabled() and self.weight.requires_grad:
            trace.count(self.counter + "_cudnn")
        return super().forward(x)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` (same parameters, same names) whose weight
    gradient comes from W2 where ``route`` names it; every other call is
    ``nn.ConvTranspose3d``'s.  Counts ``HEAD_UP_COUNTER`` as ``Conv3d``
    counts its counter."""

    def route(self, x: torch.Tensor) -> str | None:
        """"W2" or None: "W2" for an exact-f32 training call on the card
        (``_exact_f32_grad``) of a kernel equal to its stride, no padding or
        output padding, dilation 1 and one group."""
        if (_exact_f32_grad(x, self.weight)
                and self.kernel_size == self.stride
                and self.padding == (0, 0, 0)
                and self.output_padding == (0, 0, 0)
                and self.dilation == (1, 1, 1) and self.groups == 1):
            return "W2"
        return None

    def forward(self, x, output_size=None):
        if output_size is None and self.route(x) is not None:
            trace.count(HEAD_UP_COUNTER + "_hand")
            return _GemmWgrad.apply(x, self.weight, self.bias, self.stride)
        if torch.is_grad_enabled() and self.weight.requires_grad:
            trace.count(HEAD_UP_COUNTER + "_cudnn")
        return super().forward(x, output_size)


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

    The transposed conv is ``nn.ConvTranspose2d`` / ``ConvTranspose3d``
    with kernel = stride = factors; its weight is the Flax kernel spatially
    flipped (Flax's ``ConvTranspose`` does not transpose the kernel, see
    weights.py).  The 1x1 conv is ``nn.Conv2d`` / ``Conv3d``; in 3D both
    count as ``HEAD_UP_COUNTER``."""

    def __init__(self, in_channels: int, factors: Sequence[int],
                 features: int, mode: str = "trans_conv",
                 activation: str | None = "relu"):
        super().__init__()
        self.mode = mode
        self.factors = tuple(int(f) for f in factors)
        self.activation = _act(activation)
        nd = len(self.factors)
        if mode == "trans_conv":
            self.ConvTranspose_0 = (
                nn.ConvTranspose2d if nd == 2 else ConvTranspose3d)(
                    in_channels, features, self.factors, stride=self.factors)
        elif mode == "resize_conv":
            self.Conv_0 = nn.Conv2d(in_channels, features, 1) if nd == 2 \
                else Conv3d(in_channels, features, 1,
                            counter=HEAD_UP_COUNTER)
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
