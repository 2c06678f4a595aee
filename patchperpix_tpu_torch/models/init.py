"""Parameter initialisation as Flax does it.

The JAX package starts a training run from ``PPPModel.init(...,
method=full_init)``: every ``ConvPass`` conv (the U-Net's and the
decoder's), every transposed conv and ``head_fgbg_numinst`` draw
``kaiming_normal``, ``head_code_affs`` draws ``xavier_uniform``, the
resize-conv's 1x1 conv (the decoder's ``Upsample`` with ``upsampling =
"resize_conv"``) keeps Flax's default ``lecun_normal``, and every bias is
zero.  The Swin backbone's: the attention's qkv and output ``Dense``
draw ``xavier_uniform``, its ``rel_pos_bias`` ``truncated_normal(0.02)``
(cut at +-2, not rescaled), the ``_ConvBlock`` convs ``kaiming_normal``;
the MLP and ``PatchMerging`` ``Dense``, the patch embed and the decoder's
transposed convs keep ``lecun_normal``; ``LayerNorm`` scales are one and
its biases zero.

The published Swin UNETR (``network_style = "swinunetr_monai"``, which
the JAX package does not have) starts as MONAI's does: every ``Dense``
kernel and relative-position table draws ``trunc_normal_`` with
deviation 0.02 cut at +-2 (absolute, so hardly cut), its convolutions
``kaiming_normal``; the heads and the code decoder draw as above.

Flax's normal initialisers are *truncated*: cut at +-2 standard deviations
of a unit normal and rescaled by 1 / 0.87962566 so that the variance is
the one asked for.  Their fan-in comes from the Flax kernel layout ``(*k,
in, out)``: all axes but the last.  Torch's ``kaiming_normal_`` is
untruncated and reads the fan-in of a ``ConvTranspose`` weight ``(in,
out, *k)`` from the wrong axis for this, so the draws here are made on the
Flax-layout tensor and converted with ``weights.to_state_dict``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ppp import PPPConfig, PPPModel

# std of a unit normal truncated to [-2, 2] (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def flax_leaves(cfg: PPPConfig, input_shape=None) -> list[tuple[str, tuple]]:
    """('params/...' Flax leaf name, Flax-layout shape) of every parameter
    of the model, in module order (``input_shape``: see ``PPPModel``)."""
    from ..weights import from_state_dict

    with torch.device("meta"):
        sd = PPPModel(cfg, input_shape).state_dict()
    return [(k, tuple(v.shape)) for k, v in from_state_dict(sd).items()]


def initializer(name: str, style: str = "unet") -> str:
    """The initialiser of one leaf of a model of network ``style``:
    'zeros', 'ones', 'kaiming_normal', 'lecun_normal', 'xavier_uniform',
    'truncated_normal' (Flax's, stddev 0.02) or 'monai_normal' (MONAI's
    ``trunc_normal_(std=0.02)``)."""
    parts = name.split("/")
    if parts[-1] == "bias":
        return "zeros"
    if parts[-1] == "scale":
        return "ones"
    if style == "swinunetr_monai" and parts[1] == "unet":
        if parts[-1] == "rel_pos_bias" or parts[-2].startswith("Dense"):
            return "monai_normal"
        return "kaiming_normal"
    if parts[-1] == "rel_pos_bias":
        return "truncated_normal"
    if parts[-2] == "head_code_affs" \
            or parts[-3].startswith("WindowAttention"):
        return "xavier_uniform"
    if parts[-2].startswith("Dense") or parts[-3] == "unet":
        # Swin: the MLP / PatchMerging Dense, the patch embed and the
        # decoder's transposed convs (the U-Net's convs sit one level
        # deeper, under ConvPass_* / Upsample_*)
        return "lecun_normal"
    if parts[-2] == "Conv_0" and parts[-3].startswith("Upsample"):
        return "lecun_normal"   # the resize-conv's 1x1 conv: Flax's default
    return "kaiming_normal"


def _fans(shape) -> tuple[int, int]:
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def draw(name: str, shape, generator: torch.Generator,
         style: str = "unet") -> torch.Tensor:
    """One leaf in the Flax layout, float32 on the generator's device."""
    kind = initializer(name, style)
    dev = generator.device
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if kind == "zeros":
        return out.zero_()
    if kind == "ones":
        return out.fill_(1.0)
    if kind == "truncated_normal":
        torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
        return out.mul_(0.02)
    if kind == "monai_normal":
        return torch.nn.init.trunc_normal_(out, 0.0, 0.02, -2.0, 2.0,
                                           generator=generator)
    fan_in, fan_out = _fans(shape)
    if kind == "xavier_uniform":
        limit = math.sqrt(3.0 * 1.0 / ((fan_in + fan_out) / 2.0))
        return out.uniform_(-limit, limit, generator=generator)
    scale = 2.0 if kind == "kaiming_normal" else 1.0
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0,
                                generator=generator)
    return out.mul_(std)


def init_tree(cfg: PPPConfig, generator: torch.Generator,
              input_shape=None) -> dict:
    """A fresh parameter tree for ``cfg``: flat {'params/...': float32
    numpy array} in the Flax layout, with the leaf names and shapes of the
    JAX package's ``full_init`` (the decoder included when ``train_code``),
    drawn from ``generator`` leaf by leaf in module order."""
    return {name: draw(name, shape, generator,
                       cfg.network_style).cpu().numpy()
            for name, shape in flax_leaves(cfg, input_shape)}
