"""Device-resident predict -> decode.

Counterpart of ``patchperpix_tpu/infer/fused.py``: window predictions are
written into device tensors and the decoded dense (P, *vol) affinity
stack is scattered on the device; nothing volume-sized crosses to the
host.

The JAX package edge-pads the last decode chunk with a real index
(``_dec_scatter``) because XLA keeps an arbitrary winner among duplicate
scatter targets.  Here decoding is ``infer.decode.CodeDecoder``'s: every
batch scatters only its own unique foreground indices (``index_copy_``),
and a short last batch is zero-padded, its padding rows dropped.

A 2D model (``PPPConfig.spatial_dims`` 2) predicts and decodes (H, W)
windows; ``lift_2d`` turns the decoded stack and its volumes into the
flat-z volume (1, H, W) that ``to_instance_seg`` assembles with
patchshape (1, p, p).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.ppp import PPPConfig, PPPModel, apply_activations
from ..utils.device import resolve_device
from .decode import CodeDecoder
from .predict import _precision, enumerate_shifts, pad_to_grid


@torch.no_grad()
def predict_volume_device(model: PPPModel, raw: np.ndarray, cfg: PPPConfig,
                          input_shape, output_shape, device="cuda"):
    """Sliding-window prediction.  raw: (C, *spatial) float32 numpy.

    Returns (head1 (C1, *spatial), head2 (C2, *spatial)) float32 tensors on
    ``device``, activations applied (in the compute dtype, then cast)."""
    dev = resolve_device(device)
    spatial = np.array(raw.shape[1:])
    input_shape = np.array(input_shape)
    output_shape = np.array(output_shape)
    raw_padded, shape_padded, context = pad_to_grid(
        raw, spatial, input_shape, output_shape)
    raw_dev = torch.as_tensor(raw_padded, dtype=torch.float32, device=dev)
    shifts = enumerate_shifts(shape_padded, input_shape, output_shape)
    out_sp = tuple(int(s) for s in shape_padded - 2 * context)
    out1 = torch.zeros((cfg.out_channels_head1,) + out_sp,
                       dtype=torch.float32, device=dev)
    out2 = torch.zeros((cfg.out_channels_head2,) + out_sp,
                       dtype=torch.float32, device=dev)
    with _precision(cfg):
        for sh in shifts:
            sl = (slice(None),) + tuple(
                slice(int(s), int(s) + int(n))
                for s, n in zip(sh, input_shape))
            h1, h2 = model(raw_dev[sl][None])
            h1, h2 = apply_activations(cfg, h1, h2)
            osl = (slice(None),) + tuple(
                slice(int(s), int(s) + int(n))
                for s, n in zip(sh, h1.shape[2:]))
            out1[osl] = h1[0].float()
            out2[osl] = h2[0].float()
    crop = (slice(None),) + tuple(slice(0, int(s)) for s in spatial)
    return out1[crop], out2[crop]


def decode_volume_device(model: PPPModel, code: torch.Tensor,
                         fg_mask: np.ndarray, cfg: PPPConfig,
                         batch_size: int = 4096, device="cuda"):
    """code (code_units, *vol) tensor (code activation applied) + host fg
    mask -> dense affinities (P, *vol) float32 on ``device`` (sigmoid
    applied), zero outside the foreground."""
    return CodeDecoder(model, cfg, batch_size, device).decode_dense(
        code, fg_mask)


def lift_2d(dec: torch.Tensor, *volumes):
    """A 2D window's decoded stack (P, H, W) and its (H, W) volumes
    (foreground, numinst, ...) as (P, 1, H, W) and (1, H, W): the flat-z
    layout in which 2D data is assembled.  Stacks and volumes that already
    carry the z axis pass through."""
    if dec.ndim == 3:
        dec = dec[:, None]
    return (dec,) + tuple(v if v.ndim == 3 else v[None] for v in volumes)
