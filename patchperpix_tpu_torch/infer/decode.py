"""Code -> patch-affinity decoding (ppp+dec), out of core.

Counterpart of ``patchperpix_tpu/infer/decode.py``: the foreground comes
from numinst (P(background) < 0.1) or a foreground threshold; foreground
codes go through the decoder on the device in fixed-size batches (a short
last batch is zero-padded, its padding rows dropped) and the decoded
patches are scattered into a dense (P, *vol) stack.

- ``decode_sample`` decodes a prediction store in z-slabs sized to a
  host-memory budget and writes each slab into the chunk-aligned
  ``pred_affs`` array, so host memory stays O(P * slab), never O(P * vol).
- ``CodeAffReader`` decodes windows of a code store on demand for the
  blockwise assembly, so ``label --blockwise`` on a ppp+dec prediction
  never needs a dense affinity store.  It hands each window to the
  assembly as a tensor on the decoder's device (the window does not cross
  the bus twice); its float16 round trip (``.half().float()``) rounds as
  numpy's ``astype`` does, so the result equals the staged path bit for
  bit.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import io as vio
from ..utils.device import resolve_device
from .predict import _precision

logger = logging.getLogger(__name__)


def derive_fg_mask(numinst_or_fg: np.ndarray, overlapping_inst: bool,
                   fg_thresh: float = 0.5) -> np.ndarray:
    """numinst: P(background) < 0.1; else the fg probability >= the
    threshold."""
    if overlapping_inst:
        return numinst_or_fg[0] < 0.1
    return numinst_or_fg[0] >= fg_thresh


class CodeDecoder:
    """Reusable decode handle: (N, code_units) codes -> (N, P) patch
    probabilities, on ``device`` in batches of ``batch_size`` (one batch
    shape for every call)."""

    def __init__(self, model, cfg, batch_size: int = 1024, device="cuda"):
        self.model = model
        self.mcfg = cfg
        self.P = cfg.patchsize
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)

    def _decode_batch(self, batch: torch.Tensor) -> torch.Tensor:
        """(m <= batch_size, code_units) -> (m, P) float32; the batch is
        zero-padded to ``batch_size`` rows, so every call has one shape."""
        m, B = len(batch), self.batch_size
        if m < B:
            batch = F.pad(batch, (0, 0, 0, B - m))
        logits = self.model.decode(batch)
        return torch.sigmoid(logits).float().reshape(B, self.P)[:m]

    @torch.no_grad()
    def decode_tensor(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (N, code_units) float tensor -> (N, P) float32 on the
        device."""
        codes = codes.to(device=self.device, dtype=torch.float32)
        out = torch.empty((len(codes), self.P), dtype=torch.float32,
                          device=self.device)
        with _precision(self.mcfg):
            for i in range(0, len(codes), self.batch_size):
                out[i:i + self.batch_size] = self._decode_batch(
                    codes[i:i + self.batch_size])
        return out

    def decode_flat(self, codes) -> np.ndarray:
        """codes (N, code_units) -> (N, P) float32 numpy probabilities."""
        return self.decode_tensor(torch.as_tensor(np.asarray(
            codes, dtype=np.float32))).cpu().numpy()

    @torch.no_grad()
    def decode_dense(self, code, fg_mask: np.ndarray) -> torch.Tensor:
        """code (code_units, *sp), numpy or a tensor, + host fg mask (*sp)
        -> dense (P, *sp) float32 tensor on the device, zero outside the
        foreground.  The codes cross to the device in their own dtype
        (float16 from a store) and widen there; each batch scatters its
        own unique foreground indices."""
        if not torch.is_tensor(code):
            code = torch.from_numpy(np.ascontiguousarray(code))
        sp = tuple(int(s) for s in code.shape[1:])
        flat_code = code.to(device=self.device, dtype=torch.float32) \
            .reshape(code.shape[0], -1)
        out = torch.zeros((self.P, flat_code.shape[1]), dtype=torch.float32,
                          device=self.device)
        idx_all = torch.as_tensor(
            np.flatnonzero(np.asarray(fg_mask).reshape(-1)),
            device=self.device)
        with _precision(self.mcfg):
            for i in range(0, len(idx_all), self.batch_size):
                idx = idx_all[i:i + self.batch_size]
                out.index_copy_(1, idx,
                                self._decode_batch(flat_code[:, idx].T).T)
        return out.reshape((self.P,) + sp)

    def decode_into(self, code, fg_mask: np.ndarray,
                    out_dtype=np.float32) -> np.ndarray:
        """code (code_units, *sp) + fg mask (*sp) -> dense (P, *sp) numpy
        array in ``out_dtype``."""
        t_dtype = torch.from_numpy(np.zeros(0, out_dtype)).dtype
        return self.decode_dense(code, fg_mask).to(t_dtype).cpu().numpy()


def decode_volume(model, code: np.ndarray, fg_mask: np.ndarray, cfg,
                  batch_size: int = 1024, out_dtype=np.float32,
                  device="cuda") -> np.ndarray:
    """code (code_units, *vol) + fg mask -> dense affs (P, *vol), in
    memory (small volumes); large ones stream through ``decode_sample``."""
    return CodeDecoder(model, cfg, batch_size, device).decode_into(
        code, fg_mask, out_dtype)


def _slab_height(vol_shape, P: int, code_units: int,
                 max_ram_mb: float) -> int:
    """z-slab height fitting the host budget: per-z cost = the f32 decode
    slab + the f16 write copy + the f32 code slab."""
    per_z = float(np.prod(vol_shape[1:])) * (P * 4 + P * 2 + code_units * 4)
    sz = int(max(1, (max_ram_mb * 2 ** 20) // max(per_z, 1)))
    return min(sz, int(vol_shape[0]))


def decode_sample(model, pred_path: str, cfg, fg_thresh: float = 0.5,
                  batch_size: int = 1024,
                  code_key: str = "volumes/pred_code",
                  numinst_key: str | None = None,
                  fg_key: str | None = None,
                  aff_key: str = "volumes/pred_affs",
                  max_ram_mb: float = 2048.0, device="cuda") -> str:
    """Stream the codes of a prediction store through the decoder and
    write the dense float16 ``aff_key`` array back, in z-slabs sized to
    ``max_ram_mb``; each slab is one z-chunk, so every write is
    chunk-aligned."""
    if numinst_key is None and fg_key is None:
        numinst_key = ("volumes/pred_numinst" if cfg.overlapping_inst
                       else None)
        fg_key = None if cfg.overlapping_inst else "volumes/pred_fgbg"
    mask_key = numinst_key or fg_key
    io = vio.IoZarr(pred_path, mode="r+")
    P = cfg.patchsize
    code_shape = io.shape(code_key)
    vol_shape = tuple(int(s) for s in code_shape[1:])
    sz = _slab_height(vol_shape, P, int(code_shape[0]), max_ram_mb)
    chunks = [P, sz] + [max(1, s // 2) for s in vol_shape[1:]]
    io.create(aff_key, (P,) + vol_shape, np.float16, chunks=chunks)
    dec = CodeDecoder(model, cfg, batch_size, device)
    n_fg = 0
    for z0 in range(0, vol_shape[0], sz):
        zsl = slice(z0, min(z0 + sz, vol_shape[0]))
        code = io.read(bb=(slice(None), zsl), key=code_key) \
            .astype(np.float32)
        mask_src = io.read(bb=(slice(None), zsl), key=mask_key) \
            .astype(np.float32)
        fg_mask = derive_fg_mask(mask_src, cfg.overlapping_inst, fg_thresh)
        n_fg += int(fg_mask.sum())
        io.write(dec.decode_into(code, fg_mask, out_dtype=np.float16),
                 bb=(slice(None), zsl), key=aff_key)
    logger.info("decoded %d fg voxels in %d z-slabs of %d",
                n_fg, -(-vol_shape[0] // sz), sz)
    io.set_attrs(aff_key, {"offset": [0] * len(vol_shape),
                           "resolution": [1] * len(vol_shape)})
    io.close()
    return pred_path


class CodeAffReader:
    """Blockwise affinity reader that decodes codes on demand.

    Drop-in for ``assembly.blockwise.ZarrAffReader`` over a ppp+dec store
    that holds ``pred_code`` (+ numinst / fg) and no dense ``pred_affs``.
    Decoded probabilities round-trip through float16, so every window
    equals the staged decode-to-store path's.  ``read_window`` returns a
    float32 tensor on the decoder's device.
    """

    def __init__(self, path: str, decoder: CodeDecoder,
                 code_key: str = "volumes/pred_code",
                 numinst_key: str | None = None,
                 fg_key: str | None = None, fg_thresh: float = 0.5):
        self.io = vio.open_volume(path, mode="r")
        self.decoder = decoder
        self.code_key = code_key
        self.P = decoder.P
        sp = self.io.shape(code_key)[1:]
        self.lift_2d = len(sp) == 2
        self.spatial_shape = (1,) + sp if self.lift_2d else sp
        mcfg = decoder.mcfg
        if numinst_key is None and fg_key is None:
            numinst_key = ("volumes/pred_numinst" if mcfg.overlapping_inst
                           else None)
            fg_key = None if mcfg.overlapping_inst else "volumes/pred_fgbg"
        mask_key = numinst_key or fg_key
        if mask_key is None:
            raise ValueError(
                "CodeAffReader needs a numinst or fg key to bound decoding")
        # decode-gating mask, derived slab-wise (1 byte/voxel resident)
        self.fg_mask = np.zeros(sp, dtype=bool)
        sz = max(1, int(2 ** 27 // max(np.prod(sp[1:]), 1)))
        for z0 in range(0, sp[0], sz):
            zsl = slice(z0, min(z0 + sz, sp[0]))
            src = self.io.read(bb=(slice(None), zsl), key=mask_key) \
                .astype(np.float32)
            self.fg_mask[zsl] = derive_fg_mask(
                src, mcfg.overlapping_inst, fg_thresh)

    def read_window(self, start, stop):
        """(P, *(stop-start)) decoded window in GLOBAL (possibly
        2D-lifted) coords, zero-padded outside the volume."""
        start = np.asarray(start)
        stop = np.asarray(stop)
        start2, stop2 = (start[1:], stop[1:]) if self.lift_2d \
            else (start, stop)
        sp = np.array(self.io.shape(self.code_key)[1:])
        rs = np.maximum(start2, 0)
        re = np.minimum(stop2, sp)
        box = tuple(slice(int(a), int(b)) for a, b in zip(rs, re))
        code = self.io.read(bb=(slice(None),) + box, key=self.code_key)
        data = self.decoder.decode_dense(code, self.fg_mask[box]) \
            .half().float()
        pad = [(int(a - b), int(c - d))
               for a, b, c, d in zip(rs, start2, stop2, re)]
        if self.lift_2d:
            data = data[:, None]
            pad = [(int(0 - start[0]), int(stop[0] - 1))] + pad
        if any(p != (0, 0) for p in pad):
            data = F.pad(data, [v for p in reversed(pad) for v in p])
        return data

    def read_columns(self, coords) -> dict:
        """Decoded patch columns at the given centers: only the codes at
        the centers are read (each store chunk decoded once) and
        decoded."""
        coords = [tuple(int(x) for x in c) for c in coords]
        if not coords:
            return {}
        pts = np.array(coords, dtype=np.int64)
        upts = pts[:, 1:] if self.lift_2d else pts
        codes = self.io.read_points(upts, key=self.code_key)
        cols = self.decoder.decode_tensor(torch.from_numpy(codes)) \
            .half().float().cpu().numpy()
        cols[~self.fg_mask[tuple(upts.T)]] = 0.0
        return {c: cols[i] for i, c in enumerate(coords)}

    def read_channel(self, chan: int) -> np.ndarray:
        """One decoded affinity channel over the full volume, streamed in
        z-slabs (the center-channel foreground fallback)."""
        sp = tuple(int(s) for s in self.io.shape(self.code_key)[1:])
        out = np.zeros(sp, dtype=np.float32)
        sz = max(1, int(2 ** 26 // max(np.prod(sp[1:]) * self.P, 1)))
        for z0 in range(0, sp[0], sz):
            zsl = slice(z0, min(z0 + sz, sp[0]))
            code = self.io.read(bb=(slice(None), zsl), key=self.code_key)
            slab = self.decoder.decode_dense(code, self.fg_mask[zsl])
            out[zsl] = slab[chan].half().float().cpu().numpy()
        if self.lift_2d:
            out = out[None]
        return out

    def close(self):
        self.io.close()
