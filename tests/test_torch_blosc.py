"""The port's blosc decoder (``utils/blosc.py``) through its zarr store vs
the JAX package's ``IoZarr.read`` (tensorstore), on the CPU.

Tensorstore writes the stores inside the tests: cname zstd / lz4 / zlib x
shuffle none / byte / bit x typesize 1 / 2 / 4 / 8, arrays whose last
chunks are ragged and whose chunks hold 37 x 41 = 1,517 elements (not a
multiple of 8, the case bitshuffle leaves unshuffled in blosc format 2),
a 128-byte blocksize (many blocks, and a shorter last one of 2 n + 1
bytes) on chunks of 37 x 83 = 3,071 elements, and
incompressible data (chunks stored as they are).  Every read must be bit
for bit the JAX package's.  Also: every array of ``data/synth_isbi``,
blosclz refused by name, a hidden library refused by name, and
bitshuffle's later format (leftover elements after the bit planes) on a
chunk assembled here.
"""

import glob
import itertools
import json
import os
import struct
import zlib

import numpy as np
import pytest
import tensorstore as ts

from patchperpix_tpu.utils import io as jio
from patchperpix_tpu_torch.utils import blosc
from patchperpix_tpu_torch.utils import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ISBI = os.path.join(REPO, "data", "synth_isbi")
SHAPE, CHUNKS = (80, 90), (37, 41)
DTYPES = ["|u1", "<u2", "<i4", "<f8"]
WINDOWS = [(slice(None), slice(None)), (slice(3, 77), slice(40, 83)),
           (slice(36, 38), slice(0, 90)), (79, slice(5, 6))]


def _write(path, arr, cname, shuffle, blocksize=0, chunks=CHUNKS):
    spec = jio._zarr_spec(os.path.dirname(path), os.path.basename(path),
                          create=True, shape=list(arr.shape),
                          chunks=list(chunks), dtype=arr.dtype.str,
                          compressor={"id": "blosc", "cname": cname,
                                      "clevel": 5, "shuffle": shuffle,
                                      "blocksize": blocksize})
    ts.open(spec, create=True, delete_existing=True).result()[...] = arr


def _headers(path):
    """(version, flags, nbytes, blocksize) of every chunk file."""
    out = []
    for f in sorted(os.listdir(path)):
        if not f.startswith("."):
            with open(os.path.join(path, f), "rb") as fh:
                d = fh.read(16)
            out.append((d[0], d[2]) + struct.unpack("<2I", d[4:12]))
    return out


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _data(dtype, seed, random=False):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if random:
        return np.frombuffer(rng.bytes(int(np.prod(SHAPE)) * dt.itemsize),
                             dt).reshape(SHAPE).copy()
    if dt.kind == "f":
        return np.round(rng.normal(size=SHAPE), 2).astype(dt)
    return rng.integers(0, 60, SHAPE).astype(dt)


@pytest.mark.parametrize("cname,shuffle,dtype", list(itertools.product(
    ["zstd", "lz4", "zlib"], [0, 1, 2], DTYPES)))
def test_blosc_store_equals_jax(tmp_path, cname, shuffle, dtype):
    arr = _data(dtype, 7 * shuffle + len(cname))
    store = str(tmp_path / "s.zarr")
    _write(os.path.join(store, "a"), arr, cname, shuffle)
    _write(os.path.join(store, "small"), arr, cname, shuffle, blocksize=128,
           chunks=(37, 83))
    if arr.itemsize > 1 or cname == "zstd":
        # (c-blosc keeps whole one-byte chunks in one block for lz4, zlib)
        heads = _headers(os.path.join(store, "small"))
        assert all(nb > bs and nb % bs for _v, _f, nb, bs in heads)
    want = jio.IoZarr(store)
    got = tio.IoZarr(store)
    for key in ("a", "small"):
        ref = want.read(key=key)
        _same_bits(ref, arr)
        for bb in WINDOWS:
            _same_bits(got.read(bb=bb, key=key), ref[bb])


@pytest.mark.parametrize("cname", ["zstd", "lz4", "zlib"])
def test_incompressible_chunks_stored_as_they_are(tmp_path, cname):
    arr = _data("<u2", 3, random=True)
    path = str(tmp_path / "s.zarr")
    _write(os.path.join(path, "a"), arr, cname, 0)
    # the full chunks are stored as they are; the ragged ones, padded with
    # zeros, compress
    flags = [f for _v, f, _n, _b in _headers(os.path.join(path, "a"))]
    assert sum(f & 0x02 > 0 for f in flags) == 4
    _same_bits(tio.IoZarr(path).read(key="a"),
               jio.IoZarr(path).read(key="a"))


def test_blosclz_raises_naming_it(tmp_path):
    path = str(tmp_path / "s.zarr")
    _write(os.path.join(path, "a"), _data("<i4", 1), "blosclz", 1)
    with pytest.raises(blosc.Undecodable, match="blosclz"):
        tio.IoZarr(path).read(key="a")


@pytest.mark.parametrize("cname,lib", [("zstd", "libzstd"),
                                       ("lz4", "liblz4")])
def test_missing_library_raises_naming_it(tmp_path, monkeypatch, cname, lib):
    path = str(tmp_path / "s.zarr")
    _write(os.path.join(path, "a"), _data("<i4", 2), cname, 2)
    monkeypatch.setattr(blosc, "_bound", {})
    monkeypatch.setattr(blosc, "_load_library", lambda soname: None)
    with pytest.raises(blosc.Undecodable, match=f"{cname}.*{lib}"):
        tio.IoZarr(path).read(key="a")
    # a missing library is no fault of the store: check_file raises, and
    # does not delete it
    with pytest.raises(blosc.Undecodable):
        tio.check_file(path, ["a"], remove_on_error=True)
    assert os.path.isdir(os.path.join(path, "a"))


def test_library_versions():
    v = blosc.library_versions()
    assert set(v) == {"libzstd.so.1", "liblz4.so.1"}
    assert all(isinstance(n, int) and n > 10000 for n in v.values())


def _bitshuffle(x: np.ndarray) -> bytes:
    """Bitshuffle of blosc format 3: bit planes over the first n - n % 8
    elements, the rest after them as they are."""
    t = x.dtype.itemsize
    m = len(x) - len(x) % 8
    b = x[:m].view(np.uint8).reshape(m, t)
    bits = np.unpackbits(b, axis=1, bitorder="little").reshape(m, t, 8)
    planes = np.packbits(bits.transpose(1, 2, 0).reshape(8 * t, m), axis=1,
                         bitorder="little")
    return planes.tobytes() + x[m:].tobytes()


@pytest.mark.parametrize("n", [37, 40, 5])
def test_bitshuffle_leftovers_in_later_format(n):
    x = np.arange(n, dtype="<u4") * 2654435761 % 1000
    body = zlib.compress(_bitshuffle(x))
    head = struct.pack("<BBBBIII", 3, 1, 0x04 | 0x10 | (3 << 5), 4, 4 * n,
                       4 * n, 16 + 4 + 4 + len(body))
    chunk = head + struct.pack("<i", 20) + struct.pack("<i", len(body)) + body
    assert np.array_equal(np.frombuffer(blosc.decompress(chunk), "<u4"), x)


@pytest.mark.parametrize("flags,name", [(0x05 | (4 << 5), "blosc2"),
                                        (0x08 | (4 << 5), "delta"),
                                        (0x01 | (2 << 5), "snappy")])
def test_undecoded_headers_raise_naming_them(flags, name):
    chunk = struct.pack("<BBBBIII", 2, 1, flags, 4, 64, 64, 100) + bytes(84)
    with pytest.raises(blosc.Undecodable, match=name):
        blosc.decompress(chunk)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    ISBI, "*", "*.zarr"))), ids=os.path.basename)
def test_synth_isbi_equals_jax(path):
    """Every array of the committed blosc data (zstd, bitshuffle, 1 MiB
    chunks in 8 blocks) read by the port is the JAX package's read."""
    keys = jio.IoZarr(path).list_keys()
    assert keys == ["volumes/gt_instances", "volumes/raw"]
    for key in keys:
        with open(os.path.join(path, key, ".zarray")) as f:
            assert json.load(f)["compressor"]["id"] == "blosc"
        _same_bits(tio.IoZarr(path).read(key=key),
                   jio.IoZarr(path).read(key=key))
