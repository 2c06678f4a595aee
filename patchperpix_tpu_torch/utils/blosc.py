"""Decoder of blosc1 chunks, the zarr compressor the JAX package writes.

The JAX package writes every zarr array it creates through tensorstore as
blosc (zstd, clevel 3, bitshuffle); zarr-python's default is blosc-lz4
with byte shuffle.  ``decompress`` reads such a chunk with numpy, struct,
zlib and the system's ``libzstd.so.1`` / ``liblz4.so.1`` through ctypes.

A blosc1 chunk is a 16-byte header (version, versionlz, flags, typesize,
then uint32 nbytes, blocksize, cbytes), then, unless the chunk was stored
as it is (flag 0x02, "memcpyed"), one int32 start offset per block and the
blocks.  A block holds ``typesize`` streams when the chunk was split (flag
0x10 clear; never the last, shorter block), else one; each stream is an
int32 compressed size and the bytes, stored raw when that size equals the
stream's raw size.  The codec is the flags' top three bits.  After
decompression a block is unshuffled: byte shuffle (0x01) groups the k-th
byte of every element, bitshuffle (0x04) the k-th bit.  Bitshuffle covers
whole groups of 8 elements: in chunks of blosc format 2 (c-blosc 1.x) a
block whose element count is not a multiple of 8 is stored unshuffled; in
later formats the first ``n - n % 8`` elements are bitshuffled and the
rest follow as they are.

What this module cannot decode (blosclz, snappy, a missing library, the
delta filter, blosc2 extended headers) raises ``Undecodable``, a
``ValueError``, naming it.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

_HEADER = 16
_SHUFFLE, _MEMCPYED, _BITSHUFFLE, _DELTA, _NOSPLIT = 1, 2, 4, 8, 16
_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}
_SONAMES = {"zstd": "libzstd.so.1", "lz4": "liblz4.so.1"}

_bound: dict = {}
_bind_lock = threading.Lock()


class Undecodable(ValueError):
    """A chunk this machine cannot decode: its codec or filter is not
    implemented here, or the library it needs is missing.  The chunk
    itself may be sound."""


def _load_library(soname: str):
    """The shared library ``soname`` through ctypes, or None if the
    dynamic loader does not find it."""
    try:
        return ctypes.CDLL(soname)
    except OSError:
        return None


def _bind(codec: str):
    """The decompression function of ``codec``'s library, bound (looked
    up, ``argtypes`` / ``restype`` set) once per process."""
    with _bind_lock:
        fn = _bound.get(codec)
        if fn is not None:
            return fn
        soname = _SONAMES[codec]
        lib = _load_library(soname)
        if lib is None:
            raise Undecodable(f"blosc compressor {codec!r} needs {soname}, "
                              "which the dynamic loader does not find")
        if codec == "zstd":
            fn = lib.ZSTD_decompress
            fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                           ctypes.c_void_p, ctypes.c_size_t]
            fn.restype = ctypes.c_size_t
            is_error = lib.ZSTD_isError
            is_error.argtypes = [ctypes.c_size_t]
            is_error.restype = ctypes.c_uint
            fn.is_error = is_error
        else:
            fn = lib.LZ4_decompress_safe
            fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int]
            fn.restype = ctypes.c_int
        _bound[codec] = fn
        return fn


def library_versions() -> dict:
    """{soname: version number or None when the library is missing}, as
    ``ZSTD_versionNumber`` / ``LZ4_versionNumber`` report it."""
    out = {}
    for codec, soname in _SONAMES.items():
        lib = _load_library(soname)
        out[soname] = None if lib is None else int(getattr(
            lib, "ZSTD_versionNumber" if codec == "zstd"
            else "LZ4_versionNumber")())
    return out


def _inflate(codec: str, src: bytes, size: int) -> bytes:
    """One stream of ``src`` decompressed to exactly ``size`` bytes."""
    if codec == "zlib":
        out = zlib.decompress(src)
    else:
        fn = _bind(codec)
        buf = ctypes.create_string_buffer(size)
        if codec == "zstd":
            n = fn(buf, size, src, len(src))
            if fn.is_error(n):
                raise ValueError(f"blosc: zstd stream failed to decode "
                                 f"(code {n})")
        else:
            n = fn(src, buf, len(src), size)
            if n < 0:
                raise ValueError("blosc: lz4 stream failed to decode")
        out = buf.raw[:n]
    if len(out) != size:
        raise ValueError(f"blosc: a {codec} stream gave {len(out)} bytes, "
                         f"expected {size}")
    return out


def unshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """Byte shuffle undone (blosc's, and HDF5's shuffle filter): the first
    ``n * typesize`` bytes of the uint8 ``block`` hold byte k of every
    element in turn, the rest are as they were."""
    n = len(block) // typesize
    out = block.copy()
    out[:n * typesize] = block[:n * typesize].reshape(typesize, n).T.ravel()
    return out


def _bitunshuffle(block: np.ndarray, typesize: int, version: int
                  ) -> np.ndarray:
    """Bitshuffle undone: row ``8 j + k`` of the bit matrix holds bit k of
    byte j of each of the ``m`` shuffled elements (bits little-endian)."""
    n = len(block) // typesize
    if version <= 2 and n % 8:
        return block
    m = n - n % 8
    out = block.copy()
    if m:
        nb = m * typesize
        bits = np.unpackbits(block[:nb].reshape(8 * typesize, m // 8),
                             axis=1, bitorder="little")
        bits = bits.reshape(typesize, 8, m).transpose(2, 0, 1)
        out[:nb] = np.packbits(bits, axis=2, bitorder="little").ravel()
    return out


def decompress(data: bytes) -> bytes:
    """One blosc1 chunk decoded to its ``nbytes`` bytes."""
    if len(data) < _HEADER:
        raise ValueError("blosc: chunk shorter than its header")
    version, _vlz, flags, typesize = data[:4]
    nbytes, blocksize, cbytes = struct.unpack("<3I", data[4:16])
    if cbytes > len(data):
        raise ValueError(f"blosc: chunk of {len(data)} bytes, header says "
                         f"{cbytes}")
    if flags & _MEMCPYED:
        return bytes(data[_HEADER:_HEADER + nbytes])
    if flags & _SHUFFLE and flags & _BITSHUFFLE:
        raise Undecodable("blosc: both shuffles set (a blosc2 extended "
                          "header), not decoded here")
    if flags & _DELTA:
        raise Undecodable("blosc: the delta filter is not decoded here")
    codec = _CODECS.get(flags >> 5, f"code {flags >> 5}")
    if codec not in ("zstd", "lz4", "zlib"):
        raise Undecodable(f"blosc compressor {codec!r} is not decoded here "
                          "(zstd, lz4 and zlib are)")
    if nbytes == 0:
        return b""
    nblocks = -(-nbytes // blocksize)
    starts = struct.unpack(f"<{nblocks}i",
                           data[_HEADER:_HEADER + 4 * nblocks])
    out = np.empty(nbytes, np.uint8)
    for b, pos in enumerate(starts):
        bsize = min(blocksize, nbytes - b * blocksize)
        nsplits = (typesize if not flags & _NOSPLIT and bsize == blocksize
                   else 1)
        neblock = bsize // nsplits
        parts = []
        for _ in range(nsplits):
            (csize,) = struct.unpack("<i", data[pos:pos + 4])
            pos += 4
            src = data[pos:pos + csize]
            pos += csize
            parts.append(bytes(src) if csize == neblock
                         else _inflate(codec, bytes(src), neblock))
        block = np.frombuffer(b"".join(parts), np.uint8)
        if len(block) != bsize:
            raise ValueError(f"blosc: block {b} gave {len(block)} bytes, "
                             f"expected {bsize}")
        if flags & _SHUFFLE and typesize > 1:
            block = unshuffle(block, typesize)
        elif flags & _BITSHUFFLE and bsize >= typesize:
            block = _bitunshuffle(block, typesize, version)
        out[b * blocksize:b * blocksize + bsize] = block
    return out.tobytes()
