"""Zarr v2 reader written with numpy and zlib.

Counterpart of ``patchperpix_tpu/utils/io.py::IoZarr`` (which goes through
tensorstore), trimmed to what the port reads: whole arrays of a zarr v2
store whose chunks are gzip- or zlib-compressed or stored raw, C order,
no filters.  Missing chunks read as the array's fill value.
"""

from __future__ import annotations

import itertools
import json
import os
import zlib

import numpy as np


class ZarrV2Reader:
    """``read(key)`` -> the whole array ``key`` of the store at ``path``."""

    def __init__(self, path: str):
        self.path = path

    def meta(self, key: str) -> dict:
        with open(os.path.join(self.path, key, ".zarray")) as f:
            return json.load(f)

    def read(self, key: str) -> np.ndarray:
        meta = self.meta(key)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{key}: not a zarr v2 array")
        if meta.get("filters"):
            raise ValueError(f"{key}: zarr filters are not supported")
        if meta.get("order", "C") != "C":
            raise ValueError(f"{key}: only C-order chunks are supported")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") not in ("gzip", "zlib"):
            raise ValueError(f"{key}: unsupported compressor {comp}")
        shape = tuple(meta["shape"])
        chunks = tuple(meta["chunks"])
        dtype = np.dtype(meta["dtype"])
        sep = meta.get("dimension_separator", ".")
        fill = meta.get("fill_value") or 0
        out = np.full(shape, fill, dtype=dtype)
        grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
        for cidx in itertools.product(*grid):
            name = sep.join(str(i) for i in cidx)
            fn = os.path.join(self.path, key, name)
            if not os.path.exists(fn):
                continue
            with open(fn, "rb") as f:
                data = f.read()
            if comp is not None:
                # wbits 47 accepts both the gzip and the zlib container
                data = zlib.decompress(data, 47)
            block = np.frombuffer(data, dtype=dtype).reshape(chunks)
            dst = tuple(slice(i * c, min((i + 1) * c, s))
                        for i, c, s in zip(cidx, chunks, shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out
