"""HDF5 files read and written with numpy, struct and zlib.

The JAX package keeps its results, training snapshots and some inputs in
HDF5 files through h5py, which the GPU machine does not have.  This module
reads what h5py writes at its default (libver ``earliest``) and writes
files that h5py, and so the JAX package's ``IoHDF5``, reads and appends
to.

``File`` reads:

- superblock version 0 or 1 (8-byte offsets and lengths), at byte 0 or
  behind a user block;
- version 1 object headers, continuation blocks included;
- symbol-table groups (a version 1 B-tree of type 0, a local heap and
  symbol-table nodes), nested to any depth;
- datasets of fixed-point or IEEE float type in either byte order (read
  into native order) and fixed-length strings, with a scalar or simple
  dataspace;
- the old and the new fill value message; data layout version 3:
  compact, contiguous (never written reads as the fill value) and chunked,
  indexed by a version 1 B-tree of type 1 of any depth (its keys hold
  rank + 1 offsets).  A chunk absent from the tree reads as the fill
  value; only the chunks that meet the window read are inflated;
- filter pipeline message versions 1 and 2 with deflate (1), shuffle (2)
  and fletcher32 (3, checked, then stripped); a chunk's filter mask skips
  filters;
- attributes (message versions 1 to 3) of those types.

It raises ``ValueError`` naming what it does not read: superblock 2 / 3,
version 2 object headers, new-style groups (link messages and their
fractal heap), data layout version 4 (the extensible-array, fixed-array
and version 2 B-tree chunk indexes of libver ``latest``), dense attribute
storage, shared messages, other filters, and variable-length, compound,
enum (h5py's bool), reference, opaque, array, bitfield and time types.

``write_file`` writes a superblock version 0 file: groups as symbol
tables (one local heap, at most 32 symbol-table nodes of 8 entries, so
256 members a group), datasets of unsigned, signed or float type, and
numeric attributes (Python ints as int64 and floats as float64, as h5py
stores the JAX package's tuples).  A dataset is chunked, as h5py chunks a
dataset created with ``compression="gzip"`` (its ``guess_chunk`` unless
chunks are given), every chunk written and deflated at level 4; chunks are
indexed by a version 1 B-tree of as many levels as needed (64 entries a
node), so a dataset of more than 64 chunks gets a multi-level tree.  A
scalar or empty dataset is contiguous.  Every node is allocated at its
full size and the heap carries no free list, so h5py can insert into them
in place.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib

import numpy as np

from .blosc import unshuffle

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
DEFLATE_LEVEL = 4

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _LAYOUT, _FILTERS, _ATTRIBUTE = 6, 8, 11, 12
_CONTINUATION, _SYMBOL_TABLE, _ATTRIBUTE_INFO = 16, 17, 21
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc",
                 32004: "lz4", 32008: "bitshuffle", 32015: "zstd"}
_TYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                 6: "compound", 7: "reference", 8: "enum (h5py's bool)",
                 9: "variable-length", 10: "array"}
_GROUP_LEAF_K, _GROUP_NODE_K, _CHUNK_K = 4, 16, 32


def _pad8(n: int) -> int:
    return -(-n // 8) * 8


def _u(buf, pos: int, n: int) -> int:
    return int.from_bytes(buf[pos:pos + n], "little")


# -- reading ------------------------------------------------------------------

def _parse_datatype(d) -> np.dtype:
    cls, version = d[0] & 0x0F, d[0] >> 4
    bits = d[1] | d[2] << 8
    size = _u(d, 4, 4)
    if cls in (0, 1):
        if cls == 1 and bits & 0x40:
            raise ValueError("HDF5: VAX float types are not read")
        order = ">" if bits & 1 else "<"
        kind = "f" if cls == 1 else ("i" if bits & 0x08 else "u")
        if (kind == "f" and size not in (2, 4, 8)) or size not in (1, 2, 4,
                                                                   8):
            raise ValueError(f"HDF5: a {size}-byte {kind} type is not read")
        return np.dtype(f"{order}{kind}{size}")
    if cls == 3:
        return np.dtype(f"S{size}")
    raise ValueError(f"HDF5: {_TYPE_CLASSES.get(cls, f'class {cls}')} "
                     f"datatypes (version {version}) are not read")


def _parse_dataspace(d):
    version, rank = d[0], d[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if d[3] == 2:
            raise ValueError("HDF5: null dataspaces are not read")
        pos = 4
    else:
        raise ValueError(f"HDF5: dataspace version {version} is not read")
    return tuple(_u(d, pos + 8 * i, 8) for i in range(rank))


def _parse_fill(msg_type, d, dtype):
    if msg_type == _FILL_OLD:
        size, pos = _u(d, 0, 4), 4
    else:
        version = d[0]
        if version in (1, 2):
            if version == 2 and not d[3]:
                return None
            size, pos = _u(d, 4, 4), 8
        elif version == 3:
            if not d[1] & 0x20:
                return None
            size, pos = _u(d, 2, 4), 6
        else:
            raise ValueError(f"HDF5: fill value message version {version} "
                             "is not read")
    if size == 0:
        return None
    if size != dtype.itemsize:
        raise ValueError(f"HDF5: a fill value of {size} bytes for a "
                         f"{dtype} dataset")
    return np.frombuffer(bytes(d[pos:pos + size]), dtype)[0]


def _parse_filters(d):
    version, n = d[0], d[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _u(d, pos, 2)
        pos += 2
        if version == 1 or fid >= 256:
            name_len = _u(d, pos, 2)
            pos += 2
        else:
            name_len = 0
        ncd = _u(d, pos + 2, 2)
        pos += 4
        pos += _pad8(name_len) if version == 1 else name_len
        cd = [_u(d, pos + 4 * i, 4) for i in range(ncd)]
        pos += 4 * ncd + (4 if version == 1 and ncd % 2 else 0)
        out.append((fid, cd))
    return out


def _fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 (H5_checksum_fletcher32): big-endian 16-bit
    words, both sums folded every 360 words."""
    n = len(data)
    words = np.frombuffer(data[:n - n % 2], ">u2").astype(np.uint64)
    s1 = s2 = 0
    blocks = [words[a:a + 360] for a in range(0, len(words), 360)]
    if n % 2:
        blocks.append(np.array([data[-1] << 8], np.uint64))
    for w in blocks:
        c = np.cumsum(w)
        s2 += len(w) * s1 + int(c.sum())
        s1 += int(c[-1])
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


class Dataset:
    """One dataset's header: ``shape``, ``dtype`` (as stored), ``fill``,
    the layout and the filters."""

    def __init__(self, f: "File", name: str, msgs):
        self.name = name
        self._f = f
        self._attr_msgs = []
        layout = filters = fill = fill_old = None
        for t, _flags, d in msgs:
            if t == _DATASPACE:
                self.shape = _parse_dataspace(d)
            elif t == _DATATYPE:
                self.dtype = _parse_datatype(d)
            elif t == _LAYOUT:
                layout = d
            elif t == _FILTERS:
                filters = _parse_filters(d)
            elif t == _FILL:
                fill = d
            elif t == _FILL_OLD:
                fill_old = d
            elif t == _ATTRIBUTE:
                self._attr_msgs.append(d)
            elif t == _ATTRIBUTE_INFO:
                self._attr_msgs.append(None)
        value = None
        if fill is not None:
            value = _parse_fill(_FILL, fill, self.dtype)
        elif fill_old is not None:
            value = _parse_fill(_FILL_OLD, fill_old, self.dtype)
        if value is None:
            value = np.zeros((), self.dtype)[()]
        self.fill = value
        self.filters = filters or []
        version = layout[0]
        if version != 3:
            raise ValueError(
                f"HDF5: {name}: data layout version {version} is not read"
                + (" (extensible-array, fixed-array or v2 B-tree chunk "
                   "indexes: libver 'latest')" if version == 4 else ""))
        self.layout = layout[1]
        if self.layout == 0:
            size = _u(layout, 2, 2)
            self._compact = bytes(layout[4:4 + size])
        elif self.layout == 1:
            self._addr = f._addr(_u(layout, 2, 8))
        elif self.layout == 2:
            ndims = layout[2]
            self._btree = f._addr(_u(layout, 3, 8))
            self.chunks = tuple(_u(layout, 11 + 4 * i, 4)
                                for i in range(ndims - 1))
            self._index = None
        else:
            raise ValueError(f"HDF5: {name}: layout class {self.layout} "
                             "is not read")

    # -- chunks ----------------------------------------------------------
    def _chunk_index(self) -> dict:
        """{chunk offset (elements): (address, size, filter mask)} from the
        B-tree, read once."""
        if self._index is None:
            index = {}
            if self._btree != UNDEF:
                rank = len(self.shape)
                for key, child in self._f._btree_leaves(self._btree, 1,
                                                        rank + 1):
                    size, mask = _u(key, 0, 4), _u(key, 4, 4)
                    off = tuple(_u(key, 8 + 8 * i, 8) for i in range(rank))
                    index[off] = (child, size, mask)
            self._index = index
        return self._index

    def _decode_chunk(self, addr, size, mask) -> np.ndarray:
        data = bytes(self._f._buf[addr:addr + size])
        for i in reversed(range(len(self.filters))):
            if mask >> i & 1:
                continue
            fid, cd = self.filters[i]
            if fid == 1:
                data = zlib.decompress(data)
            elif fid == 2:
                data = unshuffle(np.frombuffer(data, np.uint8), cd[0] if cd
                                 else self.dtype.itemsize).tobytes()
            elif fid == 3:
                body, stored = data[:-4], _u(data, len(data) - 4, 4)
                got = _fletcher32(body)
                # older HDF5 versions stored the checksum byte-reversed
                swapped = int.from_bytes(got.to_bytes(4, "little"), "big")
                if stored not in (got, swapped):
                    raise ValueError(f"HDF5: {self.name}: fletcher32 "
                                     "checksum mismatch")
                data = body
            else:
                raise ValueError(
                    f"HDF5: {self.name}: filter "
                    f"{_FILTER_NAMES.get(fid, fid)!r} (id {fid}) is not "
                    "decoded here (deflate, shuffle and fletcher32 are)")
        n = int(np.prod(self.chunks)) * self.dtype.itemsize
        if len(data) != n:
            raise ValueError(f"HDF5: {self.name}: a chunk of {len(data)} "
                             f"bytes, expected {n}")
        return np.frombuffer(data, self.dtype).reshape(self.chunks)

    # -- data ------------------------------------------------------------
    def read(self, box=None) -> np.ndarray:
        """The window ``box`` (per axis (start, stop); default: all) in
        native byte order."""
        shape = self.shape
        box = [(0, s) for s in shape] if box is None else list(box)
        out_dtype = self.dtype.newbyteorder("=") \
            if self.dtype.kind != "S" else self.dtype
        sel = tuple(slice(a, b) for a, b in box)
        if self.layout == 0:
            full = np.frombuffer(self._compact, self.dtype,
                                 count=int(np.prod(shape))).reshape(shape)
            return full[sel].astype(out_dtype)
        if self.layout == 1:
            want = tuple(b - a for a, b in box)
            if self._addr == UNDEF:
                return np.full(want, self.fill, out_dtype)
            full = np.frombuffer(self._f._buf, self.dtype,
                                 count=int(np.prod(shape)),
                                 offset=self._addr).reshape(shape)
            return full[sel].astype(out_dtype)
        out = np.empty(tuple(b - a for a, b in box), out_dtype)
        index = self._chunk_index()
        ranges = [range(a // c, -(-b // c)) if b > a else range(0)
                  for (a, b), c in zip(box, self.chunks)]
        for cidx in np.ndindex(*[len(r) for r in ranges]):
            cidx = tuple(r[i] for r, i in zip(ranges, cidx))
            dst, src = [], []
            for (a, b), i, c in zip(box, cidx, self.chunks):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                dst.append(slice(lo - a, hi - a))
                src.append(slice(lo - i * c, hi - i * c))
            hit = index.get(tuple(i * c for i, c in zip(cidx, self.chunks)))
            if hit is None:
                out[tuple(dst)] = self.fill
            else:
                out[tuple(dst)] = self._decode_chunk(*hit)[tuple(src)]
        return out

    def attrs(self) -> dict:
        out = {}
        for d in self._attr_msgs:
            if d is None:
                raise ValueError(f"HDF5: {self.name}: dense attribute "
                                 "storage (libver 'latest') is not read")
            name, value = _parse_attribute(d)
            out[name] = value
        return out


def _parse_attribute(d):
    version = d[0]
    name_size, dt_size, ds_size = _u(d, 2, 2), _u(d, 4, 2), _u(d, 6, 2)
    if version == 1:
        pos, pad = 8, _pad8
    elif version in (2, 3):
        pos, pad = 8 if version == 2 else 9, (lambda n: n)
    else:
        raise ValueError(f"HDF5: attribute message version {version} is not "
                         "read")
    name = bytes(d[pos:pos + name_size]).split(b"\0")[0].decode()
    pos += pad(name_size)
    dtype = _parse_datatype(d[pos:pos + dt_size])
    pos += pad(dt_size)
    shape = _parse_dataspace(d[pos:pos + ds_size])
    pos += pad(ds_size)
    n = int(np.prod(shape))
    arr = np.frombuffer(bytes(d[pos:pos + n * dtype.itemsize]), dtype,
                        count=n).reshape(shape)
    if dtype.kind != "S":
        arr = arr.astype(dtype.newbyteorder("="))
    return name, (arr if arr.ndim else arr[()])


class File:
    """A read-only HDF5 file: ``keys()`` lists its datasets by path
    (``volumes/raw``), ``dataset(path)`` gives one."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            if os.fstat(fh.fileno()).st_size == 0:
                raise ValueError(f"{path}: empty file, not HDF5")
            self._buf = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._datasets: dict = {}
        try:
            self._base = self._find_superblock()
            self._tree = self._group(self._root_header, "")
        except BaseException:
            self._buf.close()
            raise

    def close(self):
        self._datasets.clear()
        self._buf.close()

    def _find_superblock(self) -> int:
        pos = 0
        while pos + 8 <= len(self._buf):
            if self._buf[pos:pos + 8] == SIGNATURE:
                break
            pos = 512 if pos == 0 else 2 * pos
        else:
            raise ValueError(f"{self.path}: no HDF5 signature")
        b = self._buf
        version = b[pos + 8]
        if version not in (0, 1):
            raise ValueError(
                f"{self.path}: HDF5 superblock version {version} (libver "
                "'v108' / 'latest') is not read; superblocks 0 and 1 are")
        if b[pos + 13] != 8 or b[pos + 14] != 8:
            raise ValueError(f"{self.path}: HDF5 offsets of {b[pos + 13]} / "
                             f"lengths of {b[pos + 14]} bytes are not read")
        # addresses count from the superblock, wherever the stored base
        # address says it was (the HDF5 library does the same)
        entry = pos + (24 if version == 0 else 28) + 32
        self._root_header = pos + _u(b, entry + 8, 8)
        return pos

    def _addr(self, a: int) -> int:
        return a if a == UNDEF else self._base + a

    def _messages(self, addr: int, name: str):
        b = self._buf
        if b[addr:addr + 4] == b"OHDR":
            raise ValueError(f"{self.path}: {name or '/'}: version 2 object "
                             "headers (libver 'latest') are not read")
        if b[addr] != 1:
            raise ValueError(f"{self.path}: {name or '/'}: object header "
                             f"version {b[addr]} is not read")
        size = _u(b, addr + 8, 4)
        blocks = [(addr + 16, size)]
        out = []
        while blocks:
            pos, n = blocks.pop(0)
            end = pos + n
            while pos + 8 <= end:
                t, sz, flags = _u(b, pos, 2), _u(b, pos + 2, 2), b[pos + 4]
                d = b[pos + 8:pos + 8 + sz]
                pos += 8 + sz
                if t == _CONTINUATION:
                    blocks.append((self._addr(_u(d, 0, 8)), _u(d, 8, 8)))
                elif t != _NIL:
                    if flags & 0x02:
                        raise ValueError(
                            f"{self.path}: {name or '/'}: shared header "
                            f"messages (type {t}) are not read")
                    out.append((t, flags, d))
        return out

    def _btree_leaves(self, addr: int, node_type: int, ndims: int = 0):
        """(key bytes, child address) of every entry of the version 1
        B-tree at ``addr``, leaves in order; keys are the entries' left
        keys."""
        b = self._buf
        if b[addr:addr + 4] != b"TREE":
            raise ValueError(f"{self.path}: no B-tree node at {addr}")
        if b[addr + 4] != node_type:
            raise ValueError(f"{self.path}: B-tree node of type "
                             f"{b[addr + 4]}, expected {node_type}")
        level, n = b[addr + 5], _u(b, addr + 6, 2)
        ksize = 8 if node_type == 0 else 8 + 8 * ndims
        pos = addr + 24
        for _ in range(n):
            key = bytes(b[pos:pos + ksize])
            child = self._addr(_u(b, pos + ksize, 8))
            pos += ksize + 8
            if level:
                yield from self._btree_leaves(child, node_type, ndims)
            else:
                yield key, child

    def _group(self, header: int, name: str) -> dict:
        """{member name: subtree dict (group) or object header address
        (dataset)} of the group whose object header is at ``header``."""
        stab = None
        for t, _f, d in self._messages(header, name):
            if t == _SYMBOL_TABLE:
                stab = (self._addr(_u(d, 0, 8)), self._addr(_u(d, 8, 8)))
            elif t in (_LINK, _LINK_INFO):
                raise ValueError(
                    f"{self.path}: {name or '/'}: new-style groups (link "
                    "messages, fractal-heap links: libver 'latest' or "
                    "track_order) are not read; symbol-table groups are")
        if stab is None:
            return None
        btree, heap = stab
        b = self._buf
        if b[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap}")
        names_at = self._addr(_u(b, heap + 24, 8))
        members = {}
        for _key, snod in self._btree_leaves(btree, 0):
            if b[snod:snod + 4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol-table node at "
                                 f"{snod}")
            for i in range(_u(b, snod + 6, 2)):
                e = snod + 8 + 40 * i
                off = names_at + _u(b, e, 8)
                member = bytes(b[off:b.find(b"\0", off)]).decode()
                child = self._addr(_u(b, e + 8, 8))
                path = f"{name}/{member}" if name else member
                sub = self._group(child, path)
                members[member] = child if sub is None else sub
        return members

    def _lookup(self, path: str):
        node = self._tree
        for part in [p for p in path.strip("/").split("/") if p]:
            if not isinstance(node, dict) or part not in node:
                raise KeyError(path)
            node = node[part]
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self._lookup(path)
        except KeyError:
            return False
        return True

    def keys(self) -> list[str]:
        """The paths of every dataset in the file."""
        out = []

        def walk(node, at):
            for k, v in node.items():
                p = f"{at}/{k}" if at else k
                if isinstance(v, dict):
                    walk(v, p)
                else:
                    out.append(p)

        walk(self._tree, "")
        return sorted(out)

    def dataset(self, path: str) -> Dataset:
        path = path.strip("/")
        if path not in self._datasets:
            node = self._lookup(path)
            if isinstance(node, dict):
                raise KeyError(f"{path} is a group")
            self._datasets[path] = Dataset(self, path,
                                           self._messages(node, path))
        return self._datasets[path]


# -- writing ------------------------------------------------------------------

def guess_chunk(shape, itemsize: int) -> tuple:
    """h5py's chunk shape for a dataset created with compression
    (``h5py._hl.filters.guess_chunk``): halve the axes in turn until the
    chunk is under, or within half of, a target size that grows with the
    dataset (8 KiB to 1 MiB)."""
    chunks = np.array([s if s else 1024 for s in shape], dtype="=f8")
    dset_size = float(np.prod(chunks)) * itemsize
    target = 16 * 1024 * 2 ** np.log10(dset_size / (1024.0 * 1024))
    target = min(max(target, 8 * 1024), 1024 * 1024)
    idx = 0
    while True:
        chunk_bytes = float(np.prod(chunks)) * itemsize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target
                < 0.5) and chunk_bytes < 1024 * 1024:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(chunks)] = np.ceil(chunks[idx % len(chunks)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "ui":
        head = bytes([0x10, 0x08 if dtype.kind == "i" else 0, 0, 0])
        return head + struct.pack("<IHH", size, 0, 8 * size)
    if dtype.kind == "f":
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127),
                           8: (11, 52, 1023)}[size]
        head = bytes([0x11, 0x20, 8 * size - 1, 0])
        return head + struct.pack("<IHHBBBBI", size, 0, 8 * size, mant, exp,
                                  0, mant, bias)
    raise ValueError(f"HDF5: a {dtype} dataset is not written here "
                     "(unsigned, signed and float types are)")


def _dataspace_message(shape) -> bytes:
    head = bytes([1, len(shape), 1 if shape else 0, 0, 0, 0, 0, 0])
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return head + dims + (dims if shape else b"")


def _little(arr) -> np.ndarray:
    arr = np.asarray(arr)
    if arr.dtype.kind not in "uif":
        raise ValueError(f"HDF5: a {arr.dtype} array is not written here "
                         "(unsigned, signed and float types are)")
    return np.asarray(arr, arr.dtype.newbyteorder("<"), order="C")


def _attribute_message(name: str, value) -> bytes:
    arr = _little(np.asarray(value))
    nm = name.encode() + b"\0"
    dt, ds = _datatype_message(arr.dtype), _dataspace_message(arr.shape)
    return (struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(ds))
            + nm.ljust(_pad8(len(nm)), b"\0") + dt.ljust(_pad8(len(dt)),
                                                         b"\0")
            + ds.ljust(_pad8(len(ds)), b"\0") + arr.tobytes())


class _Writer:
    """A file image grown by ``alloc`` (8-byte aligned) and ``put``."""

    def __init__(self):
        self.buf = bytearray(96)   # the superblock, written last

    def alloc(self, n: int) -> int:
        addr = len(self.buf)
        self.buf += bytes(_pad8(n))
        return addr

    def put(self, addr: int, data: bytes):
        self.buf[addr:addr + len(data)] = data

    def blob(self, data: bytes) -> int:
        addr = self.alloc(len(data))
        self.put(addr, data)
        return addr

    def object_header(self, messages) -> int:
        body = b"".join(struct.pack("<HHB3x", t, _pad8(len(d)), 0)
                        + d.ljust(_pad8(len(d)), b"\0")
                        for t, d in messages)
        return self.blob(struct.pack("<BBHII4x", 1, 0, len(messages), 1,
                                     len(body)) + body)

    def btree(self, node_type: int, entries, key_size: int, k: int,
              last_key: bytes) -> int:
        """A version 1 B-tree over ``entries`` [(left key, child)], as
        many levels as nodes of ``2 k`` entries need; returns the root's
        address."""
        level = 0
        while True:
            groups = [entries[i:i + 2 * k]
                      for i in range(0, len(entries), 2 * k)] or [[]]
            size = 24 + (2 * k + 1) * key_size + 2 * k * 8
            addrs = [self.alloc(size) for _ in groups]
            for j, (g, addr) in enumerate(zip(groups, addrs)):
                right_key = (groups[j + 1][0][0] if j + 1 < len(groups)
                             else last_key)
                node = bytearray(struct.pack(
                    "<4sBBHQQ", b"TREE", node_type, level, len(g),
                    addrs[j - 1] if j else UNDEF,
                    addrs[j + 1] if j + 1 < len(groups) else UNDEF))
                for key, child in g:
                    node += key + struct.pack("<Q", child)
                node += right_key
                self.put(addr, bytes(node))
            if len(groups) == 1:
                return addrs[0]
            entries = [(g[0][0], a) for g, a in zip(groups, addrs)]
            level += 1

    def dataset(self, arr: np.ndarray, attrs: dict, chunks=None) -> int:
        arr = _little(arr)
        shape, item = arr.shape, arr.dtype.itemsize
        msgs = [(_DATASPACE, _dataspace_message(shape)),
                (_DATATYPE, _datatype_message(arr.dtype))]
        if arr.ndim == 0 or arr.size == 0:
            addr = self.blob(arr.tobytes()) if arr.size else UNDEF
            msgs.append((_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, item)
                         + bytes(item)))
            msgs.append((_LAYOUT, struct.pack("<BBQQ", 3, 1, addr,
                                              arr.nbytes)))
        else:
            chunks = tuple(int(c) for c in (chunks or guess_chunk(shape,
                                                                  item)))
            chunks = tuple(max(1, min(c, s)) for c, s in zip(chunks, shape))
            grid = [range(0, s, c) for s, c in zip(shape, chunks)]
            entries = []
            ksize = 8 + 8 * (arr.ndim + 1)
            for off in np.ndindex(*[len(g) for g in grid]):
                off = tuple(g[i] for g, i in zip(grid, off))
                block = np.zeros(chunks, arr.dtype)
                part = arr[tuple(slice(o, o + c) for o, c in zip(off,
                                                                   chunks))]
                block[tuple(slice(0, n) for n in part.shape)] = part
                data = zlib.compress(block.tobytes(), DEFLATE_LEVEL)
                key = struct.pack(f"<II{arr.ndim + 1}Q", len(data), 0,
                                  *off, 0)
                entries.append((key, self.blob(data)))
            last = struct.pack(f"<II{arr.ndim + 1}Q", 0, 0,
                               *[o + c for o, c in zip(
                                   [g[-1] for g in grid], chunks)], 0)
            root = self.btree(1, entries, ksize, _CHUNK_K, last)
            msgs.append((_FILL, struct.pack("<BBBBI", 2, 3, 2, 1, item)
                         + bytes(item)))
            msgs.append((_LAYOUT, struct.pack(
                f"<BBBQ{arr.ndim + 1}I", 3, 2, arr.ndim + 1, root, *chunks,
                item)))
            msgs.append((_FILTERS, struct.pack("<BB6xHHHH", 1, 1, 1, 8, 1, 1)
                         + b"deflate\0" + struct.pack("<I4x",
                                                      DEFLATE_LEVEL)))
        for name, value in (attrs or {}).items():
            msgs.append((_ATTRIBUTE, _attribute_message(name, value)))
        return self.object_header(msgs)

    def group(self, members: dict) -> tuple:
        """(object header, B-tree, heap) of a symbol-table group whose
        ``members`` are {name: (header, (btree, heap) or None)}."""
        names = sorted(members, key=str.encode)
        if len(names) > 2 * _GROUP_LEAF_K * 2 * _GROUP_NODE_K:
            raise ValueError(f"HDF5: a group of {len(names)} members is not "
                             "written here (256 at most)")
        heap, offsets = bytearray(8), {}
        for n in names:
            offsets[n] = len(heap)
            raw = n.encode() + b"\0"
            heap += raw.ljust(_pad8(len(raw)), b"\0")
        data_addr = self.blob(bytes(heap))
        heap_addr = self.blob(struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap),
                                          1, data_addr))
        addrs, cap = [], 2 * _GROUP_LEAF_K
        for i in range(0, len(names), cap):
            part = names[i:i + cap]
            node = bytearray(struct.pack("<4sBBH", b"SNOD", 1, 0, len(part)))
            for n in part:
                header, stab = members[n]
                node += struct.pack("<QQI4x", offsets[n], header,
                                    0 if stab is None else 1)
                node += struct.pack("<QQ", *(stab or (0, 0)))
            addrs.append(self.alloc(8 + cap * 40))
            self.put(addrs[-1], bytes(node))
        # a node's left key is the last name of the node before it ("" for
        # the first), its right key its own last name
        keyed = [(struct.pack("<Q", offsets[names[i * cap - 1]] if i else 0),
                  a) for i, a in enumerate(addrs)]
        last = struct.pack("<Q", offsets[names[-1]] if names else 0)
        btree = self.btree(0, keyed, 8, _GROUP_NODE_K, last)
        header = self.object_header(
            [(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))])
        return header, (btree, heap_addr)

    def finish(self, root) -> bytes:
        header, (btree, heap) = root
        sb = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
              + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
              + struct.pack("<QQQQ", 0, UNDEF, len(self.buf), UNDEF)
              + struct.pack("<QQI4xQQ", 0, header, 1, btree, heap))
        self.put(0, sb)
        return bytes(self.buf)


def write_file(path: str, datasets: dict):
    """Write ``datasets`` {path: (array, attrs dict, chunks or None)} as a
    new HDF5 file at ``path`` (replaced whole: written to a temporary file
    that is then renamed)."""
    tree: dict = {}
    for key, value in datasets.items():
        parts = [p for p in key.strip("/").split("/") if p]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise ValueError(f"HDF5: {key}: {p} is a dataset")
        if parts[-1] in node:
            raise ValueError(f"HDF5: {key} given twice")
        node[parts[-1]] = value
    w = _Writer()

    def emit(node):
        members = {}
        for name, v in node.items():
            if isinstance(v, dict):
                header, stab = emit(v)
                members[name] = (header, stab)
            else:
                arr, attrs, chunks = v
                members[name] = (w.dataset(arr, attrs, chunks), None)
        return w.group(members)

    image = w.finish(emit(tree))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(image)
    os.replace(tmp, path)
