"""Model FLOPs, counted on the benchmark's plain reference network.

``torch.utils.flop_counter.FlopCounterMode`` over the reference network
(``reference/model.py``) on the meta device: no memory, no compute, the
same count on every machine.  A convolution or product counts two FLOPs
per multiply-add; elementwise work is not counted.  The counts are the
model's: the program's own padding or batching is not in them.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.model import Net, leaf_shapes, strip


def _meta_net(model_cfg: dict, in_channels: int) -> Net:
    params = {n: torch.empty(s, device="meta", requires_grad=True)
              for n, s in leaf_shapes(model_cfg, in_channels)}
    return Net(model_cfg, strip(params))


def unet_flops(model_cfg: dict, in_channels: int, spatial, batch: int = 1,
               backward: bool = False) -> int:
    """FLOPs of the U-Net and both heads on (batch, C, *spatial), with the
    backward pass when asked."""
    net = _meta_net(model_cfg, in_channels)
    x = torch.empty((batch, in_channels) + tuple(spatial), device="meta")
    with FlopCounterMode(display=False) as fc:
        code, numinst = net.forward(x)
        if backward:
            (code.sum() + numinst.sum()).backward()
    return int(fc.get_total_flops())


def decoder_flops(model_cfg: dict, n_codes: int,
                  backward: bool = False) -> int:
    """FLOPs of the code decoder on ``n_codes`` codes."""
    net = _meta_net(model_cfg, 1)
    codes = torch.empty((n_codes, int(model_cfg["code_units"])),
                        device="meta", requires_grad=backward)
    with FlopCounterMode(display=False) as fc:
        out = net.decode(codes)
        if backward:
            out.sum().backward()
    return int(fc.get_total_flops())
