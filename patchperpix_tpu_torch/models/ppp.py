"""PatchPerPix model: backbone + code head + numinst head + decoder.

Counterpart of ``patchperpix_tpu/models/ppp.py``: the ``unet`` network
style (``models/unet.py``) and the ``swinunetr`` style
(``models/swin.py``: ``feature_size = num_fmaps``, two blocks per stage,
one stage per downsample factor, ``max(1, num_fmaps * 2**i // 8)`` heads
at stage i; same-size output, the heads on ``feature_size`` channels),
in 3D and in 2D (``patchshape`` (1, p, p): ``spatial_dims`` 2, the
leading size-1 axis squeezed out of the per-level factors, ``Conv2d``
modules, raw (N, C, H, W)).  The API boundary is channels-first
(C, *spatial), like the JAX package's.  A third style, in 3D only and
not in the JAX package: the published Swin UNETR, ``swinunetr_monai``
(``models/swin_unetr.py``: ``feature_size = num_fmaps``, the stages'
depths and heads and the window from ``swin_depths``, ``swin_heads``
and ``swin_window``).

``dtype="bfloat16"`` in the JAX package computes every conv in bf16 from
float32 parameters that Flax casts on each call.  Here the module is cast
to bf16 once (``PPPModel.to(model.compute_dtype)``, done by
``weights.build_model``), which rounds the parameters exactly as that cast
does, and ``forward`` / ``decode`` cast their input to the same type.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .autoencoder import PatchDecoder
from .unet import HEAD_UP_COUNTER, Conv3d, UNet


@dataclass(frozen=True)
class PPPConfig:
    patchshape: tuple = (7, 7, 7)
    num_channels: int = 1
    # "unet" | "swinunetr" | "swinunetr_monai"
    network_style: str = "unet"
    num_fmaps: int = 20
    fmap_inc_factors: tuple = (3, 3, 3)
    fmap_dec_factors: tuple = (1.2, 1.2, 1.2)
    downsample_factors: tuple = ((2, 2, 2), (2, 2, 2), (2, 2, 2))
    kernel_size: int = 3
    num_repetitions: int = 2
    padding: str = "valid"
    upsampling: str = "trans_conv"
    activation: str = "relu"
    train_code: bool = False
    code_units: int = 176
    overlapping_inst: bool = False
    max_num_inst: int = 2
    patch_activation: str = "sigmoid"
    code_activation: str = "sigmoid"
    # autoencoder (decoder) section
    ae_code_fmaps: int = 22
    ae_num_fmaps: tuple = (64, 128)
    ae_downsample_factors: tuple = ((2, 2, 2), (2, 2, 2))
    ae_kernel_size: int = 3
    ae_num_repetitions: int = 2
    ae_upsampling: str = "resize_conv"
    num_code_samples: int = 1024
    dtype: str = "float32"
    # the swinunetr_monai style's stages and window
    swin_depths: tuple = (2, 2, 2, 2)
    swin_heads: tuple = (3, 6, 12, 24)
    swin_window: int = 7

    @classmethod
    def from_config(cls, cfg: dict) -> "PPPConfig":
        """The [model] section (with [model.autoencoder] and the data's
        ``num_channels``), read as the JAX package's ``from_config``."""
        ae = cfg.get("autoencoder", {})

        def tup(x):
            return tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                         for v in x)
        return cls(
            patchshape=tuple(cfg.get("patchshape", (7, 7, 7))),
            num_channels=cfg.get("num_channels", 1),
            network_style=cfg.get("network_style", "unet").lower(),
            num_fmaps=cfg.get("num_fmaps", 20),
            fmap_inc_factors=tuple(cfg.get("fmap_inc_factors", (3, 3, 3))),
            fmap_dec_factors=tuple(cfg.get("fmap_dec_factors", (1.2,) * 3)),
            downsample_factors=tup(cfg.get("downsample_factors",
                                           ((2, 2, 2),) * 3)),
            kernel_size=cfg.get("kernel_size", 3),
            num_repetitions=cfg.get("num_repetitions", 2),
            padding=cfg.get("train_padding", cfg.get("padding", "valid")),
            upsampling=cfg.get("upsampling", "trans_conv"),
            activation=cfg.get("activation", "relu"),
            train_code=cfg.get("train_code", False),
            code_units=cfg.get("code_units", 176),
            overlapping_inst=cfg.get("overlapping_inst", False),
            max_num_inst=cfg.get("max_num_inst", 2),
            patch_activation=cfg.get("patch_activation", "sigmoid"),
            code_activation=ae.get("code_activation", "sigmoid"),
            ae_code_fmaps=ae.get("code_fmaps", 22),
            ae_num_fmaps=tuple(ae.get("num_fmaps", (64, 128))),
            ae_downsample_factors=tup(ae.get("downsample_factors",
                                             ((2, 2, 2), (2, 2, 2)))),
            ae_kernel_size=ae.get("kernel_size", 3),
            ae_num_repetitions=ae.get("num_repetitions", 2),
            ae_upsampling=ae.get("upsampling", "resize_conv"),
            num_code_samples=ae.get("num_code_samples", 1024),
            dtype=cfg.get("dtype", "float32"),
            swin_depths=tuple(cfg.get("swin_depths", (2, 2, 2, 2))),
            swin_heads=tuple(cfg.get("swin_heads", (3, 6, 12, 24))),
            swin_window=cfg.get("swin_window", 7))

    @property
    def patchshape_squeezed(self) -> tuple:
        return tuple(p for p in self.patchshape if p > 1)

    @property
    def patchsize(self) -> int:
        return int(np.prod(self.patchshape_squeezed))

    @property
    def spatial_dims(self) -> int:
        return len(self.patchshape_squeezed)

    @property
    def out_channels_head1(self) -> int:
        return self.code_units if self.train_code else self.patchsize

    @property
    def out_channels_head2(self) -> int:
        return self.max_num_inst + 1 if self.overlapping_inst else 1


class PPPModel(nn.Module):
    """``input_shape`` (spatial) matters to the swinunetr style only, and
    only for inputs whose later stages are narrower than the window: the
    relative-position tables are then built for the clipped windows, as
    Flax builds them at ``init`` (``models/swin.py``)."""

    def __init__(self, cfg: PPPConfig, input_shape=None):
        super().__init__()
        nd = cfg.spatial_dims
        if nd not in (2, 3):
            raise ValueError(f"patchshape {cfg.patchshape}: 2 or 3 extents "
                             "above 1")
        self.cfg = cfg
        # squeeze leading size-1 patch axes out of the per-level factors
        ds = tuple(tuple(f[-nd:]) for f in cfg.downsample_factors)
        ae_ds = tuple(tuple(f[-nd:]) for f in cfg.ae_downsample_factors)
        if cfg.network_style == "swinunetr":
            from .swin import SwinUNETR

            n_stages = len(ds)
            self.unet = SwinUNETR(
                cfg.num_channels, feature_size=cfg.num_fmaps,
                depths=(2,) * n_stages,
                num_heads=tuple(max(1, cfg.num_fmaps * (2 ** i) // 8)
                                for i in range(n_stages)),
                spatial_dims=nd,
                input_shape=(None if input_shape is None
                             else tuple(input_shape)[-nd:]))
        elif cfg.network_style == "swinunetr_monai":
            from .swin_unetr import SwinUNETR

            if nd != 3:
                raise ValueError("the swinunetr_monai style is 3D only")
            self.unet = SwinUNETR(
                cfg.num_channels, feature_size=cfg.num_fmaps,
                depths=cfg.swin_depths, num_heads=cfg.swin_heads,
                window_size=cfg.swin_window)
        elif cfg.network_style == "unet":
            self.unet = UNet(
                cfg.num_channels, num_fmaps=cfg.num_fmaps,
                fmap_inc_factors=cfg.fmap_inc_factors,
                fmap_dec_factors=cfg.fmap_dec_factors,
                downsample_factors=ds,
                kernel_size=cfg.kernel_size,
                num_repetitions=cfg.num_repetitions, padding=cfg.padding,
                upsampling=cfg.upsampling, activation=cfg.activation)
        else:
            raise ValueError(
                f"invalid network style: {cfg.network_style!r} "
                "(expected 'unet', 'swinunetr' or 'swinunetr_monai')")
        feats = self.unet.out_channels
        # 3D heads: unet.Conv3d, whose weight gradient in exact-f32
        # training on the card comes from W2 (ops/conv_kernels.py)
        head = nn.Conv2d if nd == 2 else functools.partial(
            Conv3d, counter=HEAD_UP_COUNTER)
        self.head_code_affs = head(feats, cfg.out_channels_head1, 1)
        self.head_fgbg_numinst = head(feats, cfg.out_channels_head2, 1)
        if cfg.train_code:
            self.decoder = PatchDecoder(
                cfg.patchshape_squeezed, code_units=cfg.code_units,
                code_fmaps=cfg.ae_code_fmaps, num_fmaps=cfg.ae_num_fmaps,
                downsample_factors=ae_ds,
                kernel_size=cfg.ae_kernel_size,
                num_repetitions=cfg.ae_num_repetitions,
                upsampling=cfg.ae_upsampling)

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.cfg.dtype]

    def forward(self, raw: torch.Tensor):
        """raw: (N, C, *spatial) -> (code_affs_logits, fgbg_numinst_logits),
        both channels-first, in the compute dtype."""
        feats = self.unet(raw.to(self.compute_dtype))
        return self.head_code_affs(feats), self.head_fgbg_numinst(feats)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (N, code_units) -> patch logits (N, *patchshape)."""
        return self.decoder(codes.to(self.compute_dtype))


def apply_activations(cfg: PPPConfig, head1_logits, head2_logits):
    """Inference-time activations, in the logits' dtype (the JAX package
    applies them before its bf16 -> f32 cast as well)."""
    act = {"sigmoid": torch.sigmoid, "relu": torch.relu,
           "identity": lambda v: v}
    a1 = act[(cfg.code_activation if cfg.train_code
              else cfg.patch_activation).lower()]
    head1 = a1(head1_logits)
    if cfg.overlapping_inst:
        head2 = torch.softmax(head2_logits, dim=1)
    else:
        head2 = torch.sigmoid(head2_logits)
    return head1, head2
