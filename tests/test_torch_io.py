"""Port's numpy/zlib zarr v2 store vs the JAX package's tensorstore IoZarr."""

import json
import os
import zlib

import numpy as np
import pytest
import torch

from patchperpix_tpu.utils.io import IoZarr
from patchperpix_tpu_torch.utils import io as tio

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data",
    "JRC_SS05008-20160318_24_B2_crop.zarr")


@pytest.mark.parametrize("key", ["volumes/raw", "volumes/gt_instances"])
def test_reader_equals_iozarr_on_fixture(key):
    want = IoZarr(FIXTURE).read(key=key)
    got = tio.IoZarr(FIXTURE).read(key=key)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 50,
                                                                   50, 50)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compressor", [None, {"id": "zlib", "level": 1}])
def test_reader_edge_and_missing_chunks(tmp_path, compressor):
    """Ragged edge chunks are cropped; an absent chunk reads as the fill
    value; raw and zlib chunks decode."""
    rng = np.random.RandomState(0)
    arr = rng.randint(0, 1000, size=(5, 7)).astype("<i4")
    chunks = (2, 4)
    d = tmp_path / "s.zarr" / "a"
    d.mkdir(parents=True)
    (d / ".zarray").write_text(json.dumps({
        "zarr_format": 2, "shape": list(arr.shape), "chunks": list(chunks),
        "dtype": "<i4", "compressor": compressor, "fill_value": 7,
        "filters": None, "order": "C"}))
    want = arr.copy()
    for i in range(3):
        for j in range(2):
            if (i, j) == (1, 1):
                want[2:4, 4:7] = 7          # this chunk is never written
                continue
            block = np.zeros(chunks, "<i4")
            src = arr[i * 2:(i + 1) * 2, j * 4:(j + 1) * 4]
            block[:src.shape[0], :src.shape[1]] = src
            data = block.tobytes()
            if compressor is not None:
                data = zlib.compress(data)
            (d / f"{i}.{j}").write_bytes(data)
    got = tio.IoZarr(str(tmp_path / "s.zarr")).read(key="a")
    np.testing.assert_array_equal(got, want)
