"""Swin-UNETR backbone: shifted-window transformer encoder + conv decoder.

Counterpart of ``patchperpix_tpu/models/swin.py`` (``network_style =
"swinunetr"``), in 2D and 3D.  The API boundary is channels-first like
the port's U-Net, (N, C, *S) -> (N, feature_size, *S) at input
resolution; inside the transformer the layout is the JAX package's
(N, *S, C), permuted at the borders, and every ``LayerNorm`` normalises
the channel axis (in ``_ConvBlock`` too).

What parity with the Flax module rests on:

- ``nn.gelu`` in Flax is the tanh approximation, ``LayerNorm``'s epsilon
  is 1e-6, and a ``Dense`` kernel is (in, out) (``weights.py`` transposes
  it into ``nn.Linear``'s (out, in));
- ``PatchMerging`` concatenates the 2^nd neighbours in
  ``_window_partition``'s order, which fixes the channel order its
  ``Dense`` reads;
- the cyclic shift is ``roll(-shift)`` before the windowed attention and
  ``roll(+shift)`` after it, with each stage padded to window multiples
  and cropped back; tokens wrapped across the volume's edge get the
  additive -1e9 mask of ``_shift_mask``;
- the stride-2 patch embed follows a pad of odd extents, and each
  decoder ``ConvTranspose`` is cropped to its skip's extent.

Flax sizes a ``WindowAttention``'s relative-position table by the window
actually used, which is clipped to a stage's extent when the stage is
smaller than the window: ``SwinUNETR(input_shape=...)`` builds the tables
for that input, and a forward whose clipped windows differ from the
built ones raises (Flax's parameter shapes would not match either).
Without ``input_shape`` every stage is taken to be at least one window
wide.

The attention is the JAX package's: two batched products and a softmax
over (windows * N, heads, W, W) scores (the JAX package runs them as XLA
einsums, not in a Pallas kernel).  The shift mask is built on the
device from a cached (windows, W) region map, so only the small map is
kept per shape.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_LN_EPS = 1e-6
_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}


def _permute(x, perm):
    return x.permute(*perm) if torch.is_tensor(x) else x.transpose(perm)


def _window_partition(x, ws):
    """(B, *S, C) -> (B*num_windows, prod(ws), C); S must divide by ws.
    Takes a tensor or a numpy array."""
    b, *s, c = x.shape
    nd = len(s)
    shape = [b]
    for d in range(nd):
        shape += [s[d] // ws[d], ws[d]]
    x = x.reshape(shape + [c])
    perm = [0] + [1 + 2 * d for d in range(nd)] \
        + [2 + 2 * d for d in range(nd)] + [1 + 2 * nd]
    return _permute(x, perm).reshape(-1, int(np.prod(ws)), c)


def _window_merge(x, ws, s, b):
    """Inverse of :func:`_window_partition`."""
    nd = len(s)
    n = [s[d] // ws[d] for d in range(nd)]
    x = x.reshape([b] + n + list(ws) + [x.shape[-1]])
    perm = [0]
    for d in range(nd):
        perm += [1 + d, 1 + nd + d]
    perm += [1 + 2 * nd]
    return _permute(x, perm).reshape([b] + list(s) + [x.shape[-1]])


@functools.lru_cache(maxsize=None)
def _rel_pos_index(ws) -> np.ndarray:
    """Static (W, W) index into the (prod(2*ws-1),) bias table."""
    coords = np.stack(np.meshgrid(*[np.arange(w) for w in ws],
                                  indexing="ij"))
    flat = coords.reshape(len(ws), -1)
    rel = flat[:, :, None] - flat[:, None, :]
    idx = np.zeros(rel.shape[1:], np.int32)
    for d, w in enumerate(ws):
        idx = idx * (2 * w - 1) + (rel[d] + w - 1)
    return idx


@functools.lru_cache(maxsize=None)
def _shift_regions(s, ws, shift) -> np.ndarray:
    """(num_windows, W) int32: the region of Swin's img_mask each token of
    each window lies in, for the padded extent ``s`` shifted by
    ``shift``.  Two tokens of a window may attend to each other iff they
    share a region."""
    img = np.zeros(s, np.int32)
    per_dim = [[slice(0, s[d] - ws[d]), slice(s[d] - ws[d], s[d] - shift[d]),
                slice(s[d] - shift[d], s[d])] if shift[d] > 0
               else [slice(0, s[d])] for d in range(len(s))]
    for cnt, combo in enumerate(itertools.product(*per_dim)):
        img[combo] = cnt
    return np.ascontiguousarray(_window_partition(img[None, ..., None],
                                                  ws)[..., 0])


def _shift_mask(s, ws, shift) -> np.ndarray:
    """Static additive attention mask (num_windows, W, W): 0 within a
    region, -1e9 across regions (Swin's img_mask)."""
    win = _shift_regions(tuple(s), tuple(ws), tuple(shift))
    return np.where(win[:, :, None] == win[:, None, :], 0.0,
                    -1e9).astype(np.float32)


def _ln_channels_first(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return ln(x.movedim(1, -1)).movedim(-1, 1)


def _crop(x: torch.Tensor, spatial, channels_last: bool) -> torch.Tensor:
    lead = (slice(None),) if channels_last else (slice(None), slice(None))
    return x[lead + tuple(slice(0, int(v)) for v in spatial)]


def stage_windows(input_shape, window: int, n_stages: int) -> list:
    """The window each stage attends over for a spatial ``input_shape``:
    ``window`` clipped to the stage's extent (the patch embed and each
    ``PatchMerging`` halve an extent, rounding up)."""
    s = [int(v) for v in input_shape]
    out = []
    for _ in range(n_stages):
        s = [(v + v % 2) // 2 for v in s]
        out.append(tuple(min(window, v) for v in s))
    return out


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.window = tuple(int(w) for w in window)
        self.Dense_0 = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros(
            int(np.prod([2 * w - 1 for w in self.window])), num_heads))
        self.Dense_1 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, regions: torch.Tensor | None):
        """x: (nW*B, W, C); regions: (nW, W) of ``_shift_regions`` or
        None."""
        bw, w, _ = x.shape
        hd = self.dim // self.num_heads
        qkv = self.Dense_0(x).reshape(bw, w, 3, self.num_heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("bwhd,bvhd->bhwv", q, k) / math.sqrt(hd)
        idx = torch.as_tensor(_rel_pos_index(self.window),
                              device=x.device).long()
        attn = attn + self.rel_pos_bias[idx].permute(2, 0, 1)[None].to(
            attn.dtype)
        if regions is not None:
            nw = regions.shape[0]
            mask = torch.where(regions[:, :, None] == regions[:, None, :],
                               0.0, -1e9).to(attn.dtype)
            attn = attn.reshape(-1, nw, self.num_heads, w, w) \
                + mask[None, :, None]
            attn = attn.reshape(-1, self.num_heads, w, w)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhwv,bvhd->bwhd", attn.to(v.dtype), v)
        return self.Dense_1(out.reshape(bw, w, self.dim))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window, shifted: bool,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window = tuple(int(w) for w in window)
        self.shifted = shifted
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.WindowAttention_0 = WindowAttention(dim, num_heads, self.window)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=_LN_EPS)
        self.Dense_0 = nn.Linear(dim, int(dim * mlp_ratio))
        self.Dense_1 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *s, c = x.shape
        nd = len(s)
        ws = self.window
        clipped = tuple(min(ws[d], s[d]) for d in range(nd))
        if clipped != ws:
            raise ValueError(
                f"stage extent {tuple(s)} clips the window to {clipped}, but "
                f"this block was built for {ws}: build the model with "
                "input_shape= for this input")
        pad = [(-s[d]) % ws[d] for d in range(nd)]
        sp = tuple(s[d] + pad[d] for d in range(nd))
        shift = tuple((ws[d] // 2 if (self.shifted and sp[d] > ws[d])
                       else 0) for d in range(nd))
        dims = tuple(range(1, 1 + nd))

        h = self.LayerNorm_0(x)
        h = F.pad(h, [0, 0] + [v for p in reversed(pad) for v in (0, p)])
        regions = None
        if any(shift):
            h = torch.roll(h, [-v for v in shift], dims)
            regions = torch.as_tensor(_shift_regions(sp, ws, shift),
                                      device=x.device)
        h = _window_partition(h, ws)
        h = self.WindowAttention_0(h, regions)
        h = _window_merge(h, ws, sp, b)
        if any(shift):
            h = torch.roll(h, list(shift), dims)
        x = x + _crop(h, s, channels_last=True)

        h = self.Dense_0(self.LayerNorm_1(x))
        h = self.Dense_1(F.gelu(h, approximate="tanh"))
        return x + h


class PatchMerging(nn.Module):
    """2x spatial downsample: concat 2^nd neighbours -> LayerNorm ->
    Dense (no bias)."""

    def __init__(self, in_dim: int, out_dim: int, nd: int):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(in_dim * 2 ** nd, eps=_LN_EPS)
        self.Dense_0 = nn.Linear(in_dim * 2 ** nd, out_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, *s, c = x.shape
        nd = len(s)
        pad = [v % 2 for v in s]
        x = F.pad(x, [0, 0] + [v for p in reversed(pad) for v in (0, p)])
        x = _window_partition(x, (2,) * nd)
        sp = tuple((s[d] + pad[d]) // 2 for d in range(nd))
        x = x.reshape((b,) + sp + (x.shape[1] * c,))
        return self.Dense_0(self.LayerNorm_0(x))


class _ConvBlock(nn.Module):
    """(3^nd conv, SAME -> LayerNorm over channels -> relu) x 2,
    channels-first."""

    def __init__(self, in_ch: int, fmaps: int, nd: int):
        super().__init__()
        self.Conv_0 = _CONV[nd](in_ch, fmaps, 3, padding=1)
        self.LayerNorm_0 = nn.LayerNorm(fmaps, eps=_LN_EPS)
        self.Conv_1 = _CONV[nd](fmaps, fmaps, 3, padding=1)
        self.LayerNorm_1 = nn.LayerNorm(fmaps, eps=_LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(_ln_channels_first(self.LayerNorm_0, self.Conv_0(x)))
        return torch.relu(_ln_channels_first(self.LayerNorm_1,
                                             self.Conv_1(x)))


class SwinUNETR(nn.Module):
    """Swin transformer encoder + UNETR-style conv decoder over (N, C_in,
    *S) -> (N, feature_size, *S).  Submodules carry the Flax module's
    auto-generated names, in its creation order."""

    def __init__(self, in_channels: int, feature_size: int = 24,
                 depths: Sequence[int] = (2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12),
                 window_size: int = 7, spatial_dims: int = 3,
                 input_shape=None):
        super().__init__()
        nd = spatial_dims
        f = feature_size
        n = len(depths)
        self.feature_size = f
        self.n_stages = n
        if input_shape is not None:
            windows = stage_windows(input_shape, window_size, n)
        else:
            windows = [(window_size,) * nd] * n
        self.dims = [f * (2 ** i) for i in range(n)]
        self.add_module("_ConvBlock_0", _ConvBlock(in_channels, f, nd))
        self.Conv_0 = _CONV[nd](in_channels, f, 2, stride=2)
        self.LayerNorm_0 = nn.LayerNorm(f, eps=_LN_EPS)
        self.depths = tuple(int(d) for d in depths)
        k = 0
        for i, depth in enumerate(self.depths):
            for blk in range(depth):
                self.add_module(f"SwinBlock_{k}", SwinBlock(
                    self.dims[i], int(num_heads[i]), windows[i],
                    shifted=bool(blk % 2)))
                k += 1
            if i < n - 1:
                self.add_module(f"PatchMerging_{i}", PatchMerging(
                    self.dims[i], self.dims[i + 1], nd))
        for j, i in enumerate(reversed(range(n - 1))):
            self.add_module(f"ConvTranspose_{j}", _CONV_T[nd](
                self.dims[i + 1], self.dims[i], 2, stride=2))
            self.add_module(f"_ConvBlock_{j + 1}", _ConvBlock(
                2 * self.dims[i], self.dims[i], nd))
        self.add_module(f"ConvTranspose_{n - 1}", _CONV_T[nd](
            self.dims[0], f, 2, stride=2))
        self.add_module(f"_ConvBlock_{n}", _ConvBlock(2 * f, f, nd))

    @property
    def out_channels(self) -> int:
        return self.feature_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = self.n_stages
        s_in = tuple(x.shape[2:])
        skip0 = getattr(self, "_ConvBlock_0")(x)
        pad = [v % 2 for v in s_in]
        h = self.Conv_0(F.pad(x, [v for p in reversed(pad)
                                  for v in (0, p)]))
        h = self.LayerNorm_0(h.movedim(1, -1))       # channels-last
        skips = []
        k = 0
        for i, depth in enumerate(self.depths):
            for _ in range(depth):
                h = getattr(self, f"SwinBlock_{k}")(h)
                k += 1
            skips.append(h)
            if i < n - 1:
                h = getattr(self, f"PatchMerging_{i}")(h)
        h = h.movedim(-1, 1)                          # channels-first
        for j, i in enumerate(reversed(range(n - 1))):
            skip = skips[i].movedim(-1, 1)
            h = _crop(getattr(self, f"ConvTranspose_{j}")(h),
                      skip.shape[2:], channels_last=False)
            h = getattr(self, f"_ConvBlock_{j + 1}")(
                torch.cat([skip, h], dim=1))
        h = _crop(getattr(self, f"ConvTranspose_{n - 1}")(h), s_in,
                  channels_last=False)
        return getattr(self, f"_ConvBlock_{n}")(torch.cat([skip0, h],
                                                          dim=1))
