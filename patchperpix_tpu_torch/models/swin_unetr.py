"""Swin UNETR as published: ``network_style = "swinunetr_monai"``.

Hatamizadeh et al., "Swin UNETR: Swin Transformers for Semantic
Segmentation of Brain Tumors in MRI Images" (arXiv:2201.01266), in the
layout of MONAI's ``monai/networks/nets/swin_unetr.py`` (``SwinUNETR``
with ``normalize=True``, no dropout, drop-path or checkpointing), 3D
only, channels-first at the API boundary: (N, C_in, *S) -> (N,
feature_size, *S).  The final 1x1 ``out`` convolution is left to the
ppp+dec heads (``models/ppp.py``).

- Patch embed: a 2^3 stride-2 convolution with a bias, no norm (odd
  extents zero-padded at the end first).
- Stage i of ``depths[i]`` Swin blocks at ``feature_size * 2**i``
  channels and ``num_heads[i]`` heads; each block is ``x + proj(WA(LN(x)))``
  then ``x + fc2(GELU(fc1(LN(x))))`` with the exact (erf) GELU, an MLP
  ratio of 4, LayerNorm epsilon 1e-5 and biases on qkv, proj, fc1, fc2.
- Window attention over windows of ``window_size``^3 after zero-padding
  the normalised tokens to window multiples (padded tokens are not
  masked): ``softmax(q * hd**-0.5 @ k^T + B + M) @ v``.  Where a stage's
  extent is no larger than the window, the window is clipped to the
  extent and the shift is 0 (MONAI's ``get_window_size``).  ``B`` comes
  from a ((2w - 1)^3, heads) table indexed by the relative position of
  the full window, cut to the first n x n entries when the window is
  clipped to n tokens, as MONAI cuts it.  Odd blocks roll by -w // 2
  first and back after, with ``M`` the -100 / 0 region mask of the
  rolled, padded extent.
- Patch merging after every stage, the last included (MONAI's
  ``PatchMergingV2``): the 2^3 neighbours concatenated in
  ``itertools.product`` order, ``LayerNorm(8C)``, ``Linear(8C -> 2C)``
  without a bias.
- The hidden states (the patch embed's and each merge's) go to the
  decoder through a LayerNorm over channels without an affine.
- The decoder is MONAI's residual instance-norm blocks (``UnetResBlock``:
  conv3 -> IN -> LeakyReLU(0.01) -> conv3 -> IN, plus conv1 -> IN of the
  input where the channel counts differ, then LeakyReLU; no conv bias,
  IN without an affine) and up blocks (a 2^3 stride-2 transposed
  convolution without a bias, ``cat((up, skip))``, a residual block).

Every 3D convolution is ``models/unet.py``'s ``Conv3d`` /
``ConvTranspose3d``, so in exact-f32 training on the card its weight
gradient takes the routes W1 / W2 where they serve the shape.
Submodules carry Flax-style names (``Conv_0``, ``LayerNorm_0``,
``Dense_0``, ``ConvTranspose_0``), so that ``weights.py`` maps a flat
parameter tree onto this module as it does for the other backbones.

While a profiler runs (``utils/trace.py``) the forward records the spans
``swin.encoder`` (patch embed to the last merge), ``swin.attention``
(each block's attention from q, k, v to its output, before ``proj``) and
``swin.decoder`` (the residual and up blocks), and the counters
``swin.tokens`` (a stage's real tokens per block call) and
``swin.window_tokens`` (the padded tokens attended).
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils import trace
from .swin import _rel_pos_index, _shift_regions, _window_merge, \
    _window_partition
from .unet import Conv3d, ConvTranspose3d

# the published patch size and MLP ratio, the only ones MONAI's recipe uses
PATCH = 2
MLP_RATIO = 4
LN_EPS = 1e-5
MASK_VALUE = -100.0
LEAKY_SLOPE = 0.01


def window_and_shift(extent, window, shifted: bool) -> tuple:
    """(window, shift) a block attends with over a stage of ``extent``:
    the window clipped to an extent no larger than it, with no shift
    there (MONAI's ``get_window_size``); elsewhere half the window where
    the block is shifted."""
    ws, shift = [], []
    for e, w in zip(extent, window):
        if e <= w:
            ws.append(int(e))
            shift.append(0)
        else:
            ws.append(int(w))
            shift.append(int(w) // 2 if shifted else 0)
    return tuple(ws), tuple(shift)


def relative_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(heads, n, n) bias of an (n, n) index into the ((2w - 1)^3, heads)
    table."""
    n = index.shape[0]
    return table[index.reshape(-1)].reshape(n, n, -1).permute(2, 0, 1)


def region_mask(regions: torch.Tensor, dtype) -> torch.Tensor:
    """(windows, n, n) additive mask: 0 where two tokens of a window lie
    in one region of the rolled extent, ``MASK_VALUE`` elsewhere."""
    same = regions[:, :, None] == regions[:, None, :]
    return torch.where(same, 0.0, MASK_VALUE).to(dtype)


class WindowAttention(nn.Module):
    """qkv (``Dense_0``), the attention, proj (``Dense_1``)."""

    def __init__(self, dim: int, num_heads: int, window: Sequence[int]):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window = tuple(int(w) for w in window)
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros(
            int(np.prod([2 * w - 1 for w in self.window])), num_heads))
        self.Dense_1 = nn.Linear(dim, dim)
        self._index = {}

    def index(self, n: int, device) -> torch.Tensor:
        """The full window's relative-position index cut to n x n."""
        key = (n, device)
        if key not in self._index:
            self._index[key] = torch.as_tensor(
                _rel_pos_index(self.window)[:n, :n],
                device=device).long()
        return self._index[key]

    def forward(self, x: torch.Tensor, regions: torch.Tensor | None):
        """x (windows * B, n, C); regions (windows, n) or None."""
        bw, n, c = x.shape
        h = self.num_heads
        qkv = self.Dense_0(x).reshape(bw, n, 3, h, c // h).permute(
            2, 0, 3, 1, 4)
        with trace.span("swin.attention", x.device):
            q = qkv[0] * (c // h) ** -0.5
            attn = q @ qkv[1].transpose(-2, -1)
            attn = attn + relative_bias(
                self.rel_pos_bias, self.index(n, x.device))[None].to(
                    attn.dtype)
            if regions is not None:
                nw = regions.shape[0]
                attn = attn.view(-1, nw, h, n, n) \
                    + region_mask(regions, attn.dtype)[None, :, None]
                attn = attn.view(-1, h, n, n)
            attn = torch.softmax(attn, dim=-1)
            out = (attn.to(qkv.dtype) @ qkv[2]).transpose(1, 2).reshape(
                bw, n, c)
        return self.Dense_1(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: Sequence[int],
                 shifted: bool):
        super().__init__()
        self.window = tuple(int(w) for w in window)
        self.shifted = shifted
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=LN_EPS)
        self.WindowAttention_0 = WindowAttention(dim, num_heads, self.window)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.Dense_0 = nn.Linear(dim, dim * MLP_RATIO)
        self.Dense_1 = nn.Linear(dim * MLP_RATIO, dim)
        self._regions = {}

    def regions(self, padded, ws, shift, device) -> torch.Tensor:
        """The (windows, n) region map of the rolled, padded extent,
        cached per shape and device."""
        key = (padded, ws, shift, device)
        if key not in self._regions:
            self._regions[key] = torch.as_tensor(
                _shift_regions(padded, ws, shift), device=device)
        return self._regions[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, D, H, W, C), channels-last."""
        b, *s, c = x.shape
        ws, shift = window_and_shift(s, self.window, self.shifted)
        pad = [(-e) % w for e, w in zip(s, ws)]
        sp = tuple(e + p for e, p in zip(s, pad))
        trace.count("swin.tokens", b * int(np.prod(s)))
        trace.count("swin.window_tokens", b * int(np.prod(sp)))
        dims = (1, 2, 3)
        h = F.pad(self.LayerNorm_0(x),
                  [0, 0] + [v for p in reversed(pad) for v in (0, p)])
        regions = None
        if any(shift):
            h = torch.roll(h, [-v for v in shift], dims)
            regions = self.regions(sp, ws, shift, x.device)
        h = _window_merge(self.WindowAttention_0(_window_partition(h, ws),
                                                 regions), ws, sp, b)
        if any(shift):
            h = torch.roll(h, list(shift), dims)
        x = x + h[:, :s[0], :s[1], :s[2]]
        return x + self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(x))))


class PatchMerging(nn.Module):
    """MONAI's ``PatchMergingV2``: the 2^3 neighbours concatenated in
    ``itertools.product`` order -> LayerNorm -> Linear (no bias)."""

    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(8 * dim, eps=LN_EPS)
        self.Dense_0 = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, d, h, w, _ = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in
                       itertools.product(range(2), repeat=3)], dim=-1)
        return self.Dense_0(self.LayerNorm_0(x))


class ResBlock(nn.Module):
    """MONAI's ``UnetResBlock`` at kernel 3, stride 1, instance norm."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Conv_0 = Conv3d(in_ch, out_ch, 3, padding=1, bias=False)
        self.Conv_1 = Conv3d(out_ch, out_ch, 3, padding=1, bias=False)
        self.residual = in_ch != out_ch
        if self.residual:
            self.Conv_2 = Conv3d(in_ch, out_ch, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(F.instance_norm(self.Conv_0(x), eps=LN_EPS),
                         LEAKY_SLOPE)
        h = F.instance_norm(self.Conv_1(h), eps=LN_EPS)
        r = F.instance_norm(self.Conv_2(x), eps=LN_EPS) if self.residual \
            else x
        return F.leaky_relu(h + r, LEAKY_SLOPE)


class UpBlock(nn.Module):
    """MONAI's ``UnetrUpBlock``: transposed 2^3 convolution, cat with the
    skip, residual block."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose3d(in_ch, out_ch, 2, stride=2,
                                               bias=False)
        self.ResBlock_0 = ResBlock(2 * out_ch, out_ch)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.ResBlock_0(torch.cat([self.ConvTranspose_0(x), skip],
                                         dim=1))


class SwinUNETR(nn.Module):
    """(N, C_in, *S) -> (N, feature_size, *S); S divisible by 2^(stages +
    1) gives every skip its up block's extent.

    Encoder residual blocks: ``ResBlock_0`` on the input, ``ResBlock_{i +
    1}`` on hidden state i for i < stages - 1, ``ResBlock_{stages}`` on
    the last (the bottleneck); hidden state stages - 1 is a skip as it
    is.  ``UpBlock_0`` is the deepest."""

    def __init__(self, in_channels: int, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7):
        super().__init__()
        f = self.feature_size = int(feature_size)
        self.depths = tuple(int(d) for d in depths)
        n = self.n_stages = len(self.depths)
        if len(num_heads) != n:
            raise ValueError(f"{len(num_heads)} head counts for {n} stages")
        dims = [f * 2 ** i for i in range(n + 1)]
        for d, h in zip(dims, num_heads):
            if d % int(h):
                raise ValueError(f"{d} channels do not split into {h} heads")
        window = (int(window_size),) * 3
        self.Conv_0 = Conv3d(in_channels, f, PATCH, stride=PATCH)
        k = 0
        for i, depth in enumerate(self.depths):
            for blk in range(depth):
                self.add_module(f"SwinBlock_{k}", SwinBlock(
                    dims[i], int(num_heads[i]), window, bool(blk % 2)))
                k += 1
            self.add_module(f"PatchMerging_{i}", PatchMerging(dims[i]))
        self.ResBlock_0 = ResBlock(in_channels, f)
        for i in range(n - 1):
            self.add_module(f"ResBlock_{i + 1}", ResBlock(dims[i], dims[i]))
        self.add_module(f"ResBlock_{n}", ResBlock(dims[n], dims[n]))
        for j in range(n + 1):
            cin = dims[n - j]
            self.add_module(f"UpBlock_{j}", UpBlock(
                cin, dims[n - j - 1] if j < n else f))

    @property
    def out_channels(self) -> int:
        return self.feature_size

    def encode(self, x: torch.Tensor) -> list:
        """The hidden states (the patch embed's, then each stage's after
        its merge), channels-first, not yet normalised."""
        d, h, w = x.shape[2:]
        h0 = self.Conv_0(F.pad(x, (0, -w % PATCH, 0, -h % PATCH,
                                   0, -d % PATCH)))
        out = [h0]
        t = h0.movedim(1, -1)
        k = 0
        for i, depth in enumerate(self.depths):
            for _ in range(depth):
                t = getattr(self, f"SwinBlock_{k}")(t)
                k += 1
            t = getattr(self, f"PatchMerging_{i}")(t)
            out.append(t.movedim(-1, 1))
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_stages
        with trace.span("swin.encoder", x.device):
            hidden = [F.layer_norm(h.movedim(1, -1), (h.shape[1],),
                                   eps=LN_EPS).movedim(-1, 1)
                      for h in self.encode(x)]
        with trace.span("swin.decoder", x.device):
            skips = [self.ResBlock_0(x)] + [
                getattr(self, f"ResBlock_{i + 1}")(hidden[i])
                for i in range(n - 1)] + [hidden[n - 1]]
            y = getattr(self, f"ResBlock_{n}")(hidden[n])
            for j in range(n + 1):
                y = getattr(self, f"UpBlock_{j}")(y, skips[n - j])
        return y

