"""Device-resident predict -> decode.

Counterpart of ``patchperpix_tpu/infer/fused.py``: window predictions are
written into device tensors and the decoded dense (P, *vol) affinity
stack is scattered on the device; nothing volume-sized crosses to the
host.

The JAX package edge-pads the last decode chunk with a real index
(``_dec_scatter``) because XLA keeps an arbitrary winner among duplicate
scatter targets.  Here every chunk scatters only its own unique
foreground indices (``index_copy_``), so no padding is needed.

A 2D model (``PPPConfig.spatial_dims`` 2) predicts and decodes (H, W)
windows; ``lift_2d`` turns the decoded stack and its volumes into the
flat-z volume (1, H, W) that ``to_instance_seg`` assembles with
patchshape (1, p, p).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.ppp import PPPConfig, PPPModel, apply_activations
from ..utils.device import exact_f32, resolve_device
from .predict import enumerate_shifts, pad_to_grid


def _precision(cfg: PPPConfig):
    return exact_f32() if cfg.dtype == "float32" \
        else contextlib.nullcontext()


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


@torch.no_grad()
def decode_volume_device(model: PPPModel, code: torch.Tensor,
                         fg_mask: np.ndarray, cfg: PPPConfig,
                         batch_size: int = 4096, device="cuda"):
    """code (code_units, *vol) tensor (code activation applied) + host fg
    mask -> dense affinities (P, *vol) float32 on ``device`` (sigmoid
    applied), zero outside the foreground."""
    dev = resolve_device(device)
    code = code.to(dev)
    P = cfg.patchsize
    vol_shape = tuple(code.shape[1:])
    flat_code = code.reshape(code.shape[0], -1)
    out = torch.zeros((P, int(np.prod(vol_shape))), dtype=torch.float32,
                      device=dev)
    flat_idx = np.flatnonzero(np.asarray(fg_mask).reshape(-1))
    idx_all = torch.as_tensor(flat_idx, dtype=torch.int64, device=dev)
    with _precision(cfg):
        for i in range(0, len(flat_idx), int(batch_size)):
            idx = idx_all[i:i + int(batch_size)]
            logits = model.decode(flat_code[:, idx].T)
            patches = torch.sigmoid(logits).reshape(len(idx), P)
            out.index_copy_(1, idx, patches.T.float())
    return out.reshape((P,) + vol_shape)


def lift_2d(dec: torch.Tensor, *volumes):
    """A 2D window's decoded stack (P, H, W) and its (H, W) volumes
    (foreground, numinst, ...) as (P, 1, H, W) and (1, H, W): the flat-z
    layout in which 2D data is assembled.  Stacks and volumes that already
    carry the z axis pass through."""
    if dec.ndim == 3:
        dec = dec[:, None]
    return (dec,) + tuple(v if v.ndim == 3 else v[None] for v in volumes)
