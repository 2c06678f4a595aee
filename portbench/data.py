"""Inputs the benchmark makes or loads itself and hands to both sides.

- ``read_zarr``: one array of a zarr (v2) store whose chunks are raw or
  gzip / zlib compressed, in C order, numpy and the standard library only.
- ``reflect_to``: a volume reflected past its borders to a larger extent,
  at a phase drawn from the seed.
- ``seeds``: independent 32-bit seeds derived from a run's ``--seed``.
"""

from __future__ import annotations

import gzip
import itertools
import json
import os
import zlib

import numpy as np


def read_zarr(store: str, key: str) -> np.ndarray:
    """The array ``key`` of the zarr store ``store``."""
    path = os.path.join(store, key)
    with open(os.path.join(path, ".zarray")) as f:
        meta = json.load(f)
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{path}: only C-order arrays without filters")
    comp = (meta.get("compressor") or {}).get("id")
    if comp not in (None, "gzip", "zlib"):
        raise ValueError(f"{path}: compressor {comp!r} not read here")
    dtype = np.dtype(meta["dtype"])
    shape, chunks = meta["shape"], meta["chunks"]
    out = np.full(shape, meta.get("fill_value") or 0, dtype=dtype)
    grid = [range((s + c - 1) // c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        name = os.path.join(path, ".".join(map(str, idx)))
        if not os.path.exists(name):
            continue
        with open(name, "rb") as f:
            buf = f.read()
        if comp == "gzip":
            buf = gzip.decompress(buf)
        elif comp == "zlib":
            buf = zlib.decompress(buf)
        block = np.frombuffer(buf, dtype=dtype).reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def load_sample(data: dict, root: str):
    """(raw (C, *S) float32 clipped to ``clipmax`` and scaled to [0, 1],
    labels (C_gt, *S) int32) of a configuration's ``data`` section."""
    store = os.path.join(root, data["store"])
    raw = read_zarr(store, data["raw_key"]).astype(np.float32)
    labels = read_zarr(store, data["gt_key"]).astype(np.int32)
    clipmax = float(data["clipmax"])
    return np.clip(raw, 0, clipmax) / clipmax, labels


def reflect_to(vol: np.ndarray, extent, phase) -> np.ndarray:
    """``vol`` (C, *S) reflected (numpy's "reflect": about the edge
    voxels, period 2 (S - 1)) past every spatial side and cut to
    ``extent``, starting ``phase`` voxels into the volume padded by 2 S
    on each side (0 <= phase < 2 S per axis).  Gathered by index, one
    axis at a time, so that nothing larger than the result is made."""
    out = vol
    for ax, (s, e, p) in enumerate(zip(vol.shape[1:], extent, phase)):
        period = 2 * (int(s) - 1)
        x = (np.arange(int(e)) + int(p) - 2 * int(s)) % period
        out = np.take(out, np.where(x < s, x, period - x), axis=ax + 1)
    return out


def seeds(seed: int, n: int) -> list:
    """n independent 32-bit seeds from a run's seed (any whole number)."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint32)]
