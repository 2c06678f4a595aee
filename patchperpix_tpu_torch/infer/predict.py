"""Sliding-window prediction to host arrays and to a zarr store.

Counterpart of ``patchperpix_tpu/infer/predict.py``: pad the volume to
the output-shape grid with the context margins, enumerate the window
origins at output-shape stride, run the windows through the model in
batches on the device (the last batch zero-padded to ``batch_size``),
and bring each window's valid crop back to the host in ``out_dtype``.
``predict_sample_to_zarr`` writes both heads as chunked float16 zarr
arrays under the JAX package's keys and attributes.  The device-resident
path (``infer/fused.py``) shares ``pad_to_grid`` / ``enumerate_shifts``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..models.ppp import apply_activations
from ..utils import io as vio
from ..utils.device import exact_f32, resolve_device


def _precision(cfg):
    """TF32 off for a float32 model (``exact_f32``), nothing for bf16."""
    return exact_f32() if cfg.dtype == "float32" \
        else contextlib.nullcontext()


def enumerate_shifts(shape_padded, input_shape, stride):
    """Grid of window origins, snapped so the last window ends exactly at
    the padded boundary."""
    max_shift = [max(0, s - i) for s, i in zip(shape_padded, input_shape)]
    axes = []
    for ms, st in zip(max_shift, stride):
        vals = list(range(0, ms + 1, st))
        if vals[-1] != ms:
            vals.append(ms)
        axes.append(vals)
    shifts = [[]]
    for vals in reversed(axes):
        shifts = [[v] + s for v in vals for s in shifts]
    return [tuple(s) for s in shifts]


def pad_to_grid(raw: np.ndarray, spatial, input_shape, output_shape):
    """Context margins + snap to the output-shape grid.  Returns
    (raw_padded, shape_padded, context)."""
    context = (input_shape - output_shape) // 2
    shape_padded = np.array(
        [(int(s) // int(o) + 1) * int(o) + 2 * int(c)
         for s, o, c in zip(spatial, output_shape, context)])
    raw_padded = np.pad(
        raw, [(0, 0)] + [(int(c), int(sp - s - c))
                         for c, s, sp in zip(context, spatial,
                                             shape_padded)],
        mode="constant")
    return raw_padded, shape_padded, context


@torch.no_grad()
def predict_volume(model, raw: np.ndarray, cfg, input_shape, output_shape,
                   batch_size: int = 2, out_dtype=np.float16,
                   device="cuda"):
    """Full-volume sliding-window prediction.  raw: (C, *spatial) float32.

    Returns (head1 (C1, *spatial), head2 (C2, *spatial)) numpy arrays in
    ``out_dtype``, activations applied."""
    dev = resolve_device(device)
    spatial = np.array(raw.shape[1:])
    input_shape = np.array(input_shape)
    output_shape = np.array(output_shape)
    raw_padded, shape_padded, _ = pad_to_grid(
        raw, spatial, input_shape, output_shape)
    raw_dev = torch.as_tensor(raw_padded, dtype=torch.float32, device=dev)
    shifts = enumerate_shifts(shape_padded, input_shape, output_shape)
    out1 = np.zeros((cfg.out_channels_head1,) + tuple(spatial), out_dtype)
    out2 = np.zeros((cfg.out_channels_head2,) + tuple(spatial), out_dtype)
    t_dtype = torch.from_numpy(np.zeros(0, out_dtype)).dtype
    with _precision(cfg):
        for i in range(0, len(shifts), batch_size):
            group = shifts[i:i + batch_size]
            tiles = [raw_dev[(slice(None),) + tuple(
                slice(int(s), int(s + n)) for s, n in zip(sh, input_shape))]
                for sh in group]
            # the last batch is zero-padded: one batch shape for every call
            tiles += [torch.zeros_like(tiles[0])] * (batch_size - len(tiles))
            h1, h2 = apply_activations(cfg, *model(torch.stack(tiles)))
            for b, sh in enumerate(group):
                # valid output region of this tile, in unpadded coordinates
                g_start = np.array(sh)
                g_stop = np.minimum(g_start + output_shape, spatial)
                ln = g_stop - g_start
                if np.any(ln <= 0):
                    continue
                dst = (slice(None),) + tuple(
                    slice(int(s), int(e)) for s, e in zip(g_start, g_stop))
                src = (b, slice(None)) + tuple(slice(0, int(n)) for n in ln)
                out1[dst] = h1[src].float().to(t_dtype).cpu().numpy()
                out2[dst] = h2[src].float().to(t_dtype).cpu().numpy()
    return out1, out2


def predict_sample_to_zarr(model, raw: np.ndarray, cfg, input_shape,
                           output_shape, out_path: str, batch_size: int = 2,
                           aff_or_code_key: str | None = None,
                           fgbg_numinst_key: str | None = None,
                           device="cuda") -> str:
    """Predict one sample and persist both heads as chunked float16 zarr
    arrays (chunks: all channels x half the output shape), with the
    ``offset`` / ``resolution`` attributes of the JAX package."""
    if aff_or_code_key is None:
        aff_or_code_key = ("volumes/pred_code" if cfg.train_code
                           else "volumes/pred_affs")
    if fgbg_numinst_key is None:
        fgbg_numinst_key = ("volumes/pred_numinst" if cfg.overlapping_inst
                            else "volumes/pred_fgbg")
    h1, h2 = predict_volume(model, raw, cfg, input_shape, output_shape,
                            batch_size, device=device)
    ndim_sp = raw.ndim - 1
    chunk_sp = [max(1, int(o) // 2) for o in output_shape]
    io = vio.IoZarr(out_path, mode="w")
    for key, arr in ((aff_or_code_key, h1), (fgbg_numinst_key, h2)):
        io.create(key, arr.shape, np.float16,
                  chunks=[arr.shape[0]] + chunk_sp)
        io.write(arr.astype(np.float16), key=key)
        io.set_attrs(key, {"offset": [0] * ndim_sp,
                           "resolution": [1] * ndim_sp})
    io.close()
    return out_path
