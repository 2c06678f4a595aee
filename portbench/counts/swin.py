"""FLOPs and bytes of the Swin UNETR cell, counted on the benchmark's
plain reference network (``reference/swin_unetr.py``).

- ``step_flops``: ``FlopCounterMode`` over the reference on the meta
  device (no memory, no compute, the same count on every machine): the
  backbone and both heads on the batch, the code decoder on the sampled
  codes, forward and backward.  A convolution or product counts two
  FLOPs per multiply-add; elementwise work is not counted.
- ``attention``: the forward window attention of one step, the work
  whatever implements it: operations ``4 * n^2 * head_dim`` per window
  and head (the two products), and its least bytes in float32: q, k and
  v read once, the output written once, the bias table and, in a shifted
  block, the (windows, n) region map read once.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference.swin_unetr import SwinUNETRNet, leaf_shapes, window_size
from ..reference.model import strip

F32 = 4


def step_flops(model_cfg: dict, in_channels: int, spatial, batch: int,
               n_codes: int) -> int:
    """FLOPs of one training step's forward and backward (``model_cfg``:
    a ``model`` section with ``padding``, as ``model.net_config`` gives
    it)."""
    params = {n: torch.empty(s, device="meta", requires_grad=True)
              for n, s in leaf_shapes(model_cfg, in_channels)}
    net = SwinUNETRNet(model_cfg, strip(params))
    x = torch.empty((batch, in_channels) + tuple(spatial), device="meta")
    codes = torch.empty((n_codes, int(model_cfg["code_units"])),
                        device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        code, numinst = net.forward(x)
        out = net.decode(codes)
        (code.sum() + numinst.sum() + out.sum()).backward()
    return int(fc.get_total_flops())


def stages(model_cfg: dict, spatial) -> list:
    """(extent, channels, heads, depth) of each stage for an input
    extent: the patch embed and each merge halve it, rounding up."""
    s = [(int(v) + 1) // 2 for v in spatial]
    out = []
    f = int(model_cfg["num_fmaps"])
    for i, (depth, heads) in enumerate(zip(model_cfg["swin_depths"],
                                           model_cfg["swin_heads"])):
        out.append((tuple(s), f * 2 ** i, int(heads), int(depth)))
        s = [(v + 1) // 2 for v in s]
    return out


def attention(model_cfg: dict, spatial, batch: int) -> dict:
    """The forward window attention of one step on (batch, C, *spatial):
    ``flops``, ``bytes``, ``blocks`` (attention calls), ``tokens`` (the
    stages' real tokens) and ``window_tokens`` (the padded tokens
    attended), each summed over every block."""
    w = int(model_cfg["swin_window"])
    half = (w // 2,) * 3
    out = dict(flops=0, bytes=0, blocks=0, tokens=0, window_tokens=0)
    for extent, c, heads, depth in stages(model_cfg, spatial):
        ws, shift = window_size(extent, (w,) * 3, half)
        n = int(np.prod(ws))
        padded = int(np.prod([-(-e // v) * v for e, v in zip(extent, ws)]))
        windows = padded // n
        table = (2 * w - 1) ** 3 * heads * F32
        for blk in range(depth):
            shifted = blk % 2 == 1 and any(shift)
            out["flops"] += batch * windows * heads * 4 * n * n * (c // heads)
            out["bytes"] += batch * padded * c * 4 * F32 + table \
                + (windows * n * F32 if shifted else 0)
            out["blocks"] += 1
            out["tokens"] += batch * int(np.prod(extent))
            out["window_tokens"] += batch * padded
    return out
