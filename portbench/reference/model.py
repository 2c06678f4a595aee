"""Plain PyTorch reference of the PatchPerPix ppp+dec network.

Written from the published description (Hirsch, Mais, Kainmueller,
"PatchPerPix for Instance Segmentation", ECCV 2020, and the reference
repository's ``torch_model.py`` / ``default_train_code.toml``): a U-Net
(two 3^3 convolutions with ReLU per level, 2^3 max pooling, transposed
2^3 upsampling with ReLU, skip crops concatenated before the upsampled
features), a 1^3 code head and a 1^3 numinst head, and the code decoder
(the code reshaped channels-last to a 2^3 grid of ``code_fmaps``, a 1^3
convolution with ReLU, nearest 2x resize + 1^3 convolution with ReLU,
3^3 convolutions, cropped to the patch).

Parameters are the Flax layout the repository's checkpoints use: a flat
dict of '/'-joined names to tensors, conv kernels (kz, ky, kx, in, out).
The transposed convolution is computed as Flax defines it (the
stride-dilated input correlated with the kernel, so output offset t reads
kernel index k - 1 - t), by an einsum, not by ``ConvTranspose3d``.

Departures from the published description: none in the arithmetic; the
float32 path runs with TF32 off.  ``tf32=True`` is the lower-precision
control of the benchmark's comparison: on a card every convolution and
product runs in TF32 (``precision(True)`` turns it on); on the CPU both
operands are rounded to TF32 (10 mantissa bits, round to nearest even,
and so their gradients) and accumulate in float32, as the tensor cores
do.

This module imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32: bool = False):
    """TF32 off (or, for the control, on) for cuDNN and CUDA matmuls inside
    the block."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32)
    bias = 0xFFF + ((i >> 13) & 1)
    return ((i + bias) & ~0x1FFF).view(torch.float32)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return _round_tf32(g)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties to
    even), still stored as float32; the gradient is rounded the same way."""
    return _TF32.apply(x)


class Net:
    """The network of one configuration (a dict, the ``model`` section of a
    benchmark configuration file) over a parameter dict."""

    def __init__(self, cfg: dict, params: dict, tf32: bool = False):
        self.cfg = cfg
        self.p = params
        self.tf32 = tf32
        self.ps = tuple(int(v) for v in cfg["patchshape"])
        self.same = cfg["padding"] == "same"

    # -- primitives ------------------------------------------------------

    def _op(self, x, w):
        if self.tf32 and not x.is_cuda:
            return round_tf32(x), round_tf32(w)
        return x, w

    def conv(self, x, name, pad):
        k = self.p[name + "/kernel"]
        w = k.permute(4, 3, 0, 1, 2)
        x, w = self._op(x, w)
        return F.conv3d(x, w, self.p[name + "/bias"], padding=pad)

    def conv_pass(self, x, name, n, relu=True, k=3, same=None):
        same = self.same if same is None else same
        pad = k // 2 if same else 0
        for i in range(n):
            x = self.conv(x, f"{name}/Conv_{i}", pad)
            if relu:
                x = torch.relu(x)
        return x

    def trans_conv(self, x, name):
        """Flax ConvTranspose with kernel = stride = 2 and ReLU."""
        k = self.p[name + "/kernel"].flip(0, 1, 2)      # (tz, ty, tx, c, o)
        x, k = self._op(x, k)
        n, _, d, h, w = x.shape
        y = torch.einsum("ncijk,xyzco->noixjykz", x, k)
        y = y.reshape(n, k.shape[-1], 2 * d, 2 * h, 2 * w)
        return torch.relu(y + self.p[name + "/bias"].reshape(1, -1, 1, 1, 1))

    def resize_conv(self, x, name, relu=True):
        for ax in (2, 3, 4):
            x = torch.repeat_interleave(x, 2, dim=ax)
        x = self.conv(x, name + "/Conv_0", 0)
        return torch.relu(x) if relu else x

    @staticmethod
    def crop(x, shape):
        off = [(s - t) // 2 for s, t in zip(x.shape[2:], shape)]
        return x[(slice(None), slice(None)) + tuple(
            slice(o, o + t) for o, t in zip(off, shape))]

    # -- the network -----------------------------------------------------

    def forward(self, raw):
        """raw (N, C, *S) -> (code logits (N, code_units, *S'), numinst
        logits (N, max_num_inst + 1, *S'))."""
        levels = len(self.cfg["downsample_factors"])
        reps = int(self.cfg["num_repetitions"])
        x, skips = raw, []
        for lv in range(levels):
            x = self.conv_pass(x, f"unet/ConvPass_{lv}", reps)
            skips.append(x)
            x = F.max_pool3d(x, 2, 2)
        x = self.conv_pass(x, f"unet/ConvPass_{levels}", reps)
        for up, lv in enumerate(reversed(range(levels))):
            x = self.trans_conv(x, f"unet/Upsample_{up}/ConvTranspose_0")
            x = torch.cat([self.crop(skips[lv], x.shape[2:]), x], dim=1)
            x = self.conv_pass(x, f"unet/ConvPass_{levels + 1 + up}", reps)
        code = self.conv(x, "head_code_affs", 0)
        numinst = self.conv(x, "head_fgbg_numinst", 0)
        return code, numinst

    def decode(self, codes):
        """codes (N, code_units), activation applied -> patch logits
        (N, *patchshape)."""
        ae = self.cfg["autoencoder"]
        cf = int(ae["code_fmaps"])
        s = round((codes.shape[1] / cf) ** (1 / 3))
        x = codes.reshape(-1, s, s, s, cf).permute(0, 4, 1, 2, 3)
        x = self.conv_pass(x, "decoder/ConvPass_0", 1, k=1, same=True)
        n_up = len(ae["num_fmaps"])
        for i in range(n_up):
            x = self.resize_conv(x, f"decoder/Upsample_{i}")
            last = i == n_up - 1
            x = self.conv_pass(x, f"decoder/ConvPass_{i + 1}",
                               int(ae["num_repetitions"]), relu=not last,
                               same=True)
        return self.crop(x, self.ps)[:, 0]


def leaf_shapes(cfg: dict, in_channels: int) -> list:
    """[(Flax leaf name, shape)] of a configuration's parameters, in the
    order the U-Net, the heads and the decoder create them."""
    out = []
    nf = int(cfg["num_fmaps"])
    inc = cfg["fmap_inc_factors"]
    dec = cfg["fmap_dec_factors"]
    levels = len(cfg["downsample_factors"])
    reps = int(cfg["num_repetitions"])

    def level_fmaps(lv):
        f = nf
        for i in range(lv):
            f = int(round(f * inc[i]))
        return f

    def up_fmaps(lv):
        return int(round(level_fmaps(lv) * dec[lv]))

    def conv_pass(name, cin, cout, n, k=3):
        for i in range(n):
            out.append((f"{name}/Conv_{i}/kernel",
                        (k, k, k, cin if i == 0 else cout, cout)))
            out.append((f"{name}/Conv_{i}/bias", (cout,)))

    prev = in_channels
    for lv in range(levels + 1):
        conv_pass(f"params/unet/ConvPass_{lv}", prev, level_fmaps(lv), reps)
        prev = level_fmaps(lv)
    for up, lv in enumerate(reversed(range(levels))):
        name = f"params/unet/Upsample_{up}/ConvTranspose_0"
        out.append((name + "/kernel", (2, 2, 2, prev, up_fmaps(lv))))
        out.append((name + "/bias", (up_fmaps(lv),)))
        conv_pass(f"params/unet/ConvPass_{levels + 1 + up}",
                  level_fmaps(lv) + up_fmaps(lv), up_fmaps(lv), reps)
        prev = up_fmaps(lv)
    heads = (("head_code_affs", int(cfg["code_units"])),
             ("head_fgbg_numinst", int(cfg["max_num_inst"]) + 1))
    for name, cout in heads:
        out.append((f"params/{name}/kernel", (1, 1, 1, prev, cout)))
        out.append((f"params/{name}/bias", (cout,)))
    ae = cfg["autoencoder"]
    fm = list(ae["num_fmaps"])
    conv_pass("params/decoder/ConvPass_0", int(ae["code_fmaps"]), fm[-1], 1,
              k=1)
    prev = fm[-1]
    for i, f in enumerate(list(reversed(fm))[1:] + [1]):
        out.append((f"params/decoder/Upsample_{i}/Conv_0/kernel",
                    (1, 1, 1, prev, f)))
        out.append((f"params/decoder/Upsample_{i}/Conv_0/bias", (f,)))
        conv_pass(f"params/decoder/ConvPass_{i + 1}", f, f,
                  int(ae["num_repetitions"]))
        prev = f
    return out


def net_config(cfg: dict) -> dict:
    """The training network's settings from a benchmark configuration
    file."""
    return dict(cfg["model"], padding=cfg["model"]["train_padding"])


def output_shape(cfg: dict, in_channels: int, input_shape) -> tuple:
    """The network's output extent for an input extent (a forward pass on
    the meta device: shapes only)."""
    params = {n: torch.empty(s, device="meta")
              for n, s in leaf_shapes(cfg, in_channels)}
    code, _ = Net(cfg, strip(params)).forward(
        torch.empty((1, in_channels) + tuple(input_shape), device="meta"))
    return tuple(int(s) for s in code.shape[2:])


def strip(params: dict) -> dict:
    """The Flax tree without its leading 'params/'."""
    return {k[len("params/"):] if k.startswith("params/") else k: v
            for k, v in params.items()}
