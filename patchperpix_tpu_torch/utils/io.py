"""Zarr v2 stores and HDF5 files; TIFF and PNG files.

Counterpart of ``patchperpix_tpu/utils/io.py`` (``IoZarr``, which goes
through tensorstore, ``IoHDF5``, which goes through h5py, ``open_volume``,
``check_file``, the raw NRRD writer and reader, ``save_tif`` /
``read_tif``) for a machine that has neither zarr, tensorstore, h5py nor
PIL.  TIFF and PNG are written and read with numpy, zlib and struct
(``save_tif`` / ``read_tif``, ``write_png`` / ``read_png``); the readers
also take the files PIL writes for the JAX package.  HDF5 files go through
``utils/hdf5.py`` (numpy, struct and zlib) behind ``IoHDF5``.

Zarr arrays are C-order zarr v2 arrays without filters.  Chunks are
written zlib-compressed (or raw with ``compressor=None``), which the JAX
package reads through tensorstore, and read when they are zlib-, gzip- or
blosc-compressed or raw: blosc (the JAX package's default, zstd with
bitshuffle, and zarr-python's, lz4 with byte shuffle) is decoded by
``utils/blosc.py``.  A chunk that was never written reads as the array's
fill value.  A blosc array is read-only here.

Reads and writes take any bounding box.  A write that covers only part of
a chunk reads the chunk, updates it and writes it back.  Decoded chunks
are kept in a least-recently-used cache of ``_CACHE_BYTES`` per store, so
the blockwise windows that overlap (block halos, stitch windows) decompress
a chunk once.  The chunks of one read or write are (de)compressed on a
thread pool (zlib releases the GIL): on one core, writing a 100^3 sample's
codes took 12.0 s against 2.2-2.5 s on the pool (an H100 machine's
host, ``PERF.md``).
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import shutil
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import blosc, hdf5

_ZLIB_LEVEL = 1
_CACHE_BYTES = 2 ** 30
_pool = None
_pool_lock = threading.Lock()


def _map(fn, items):
    """``fn`` over ``items`` on the module's thread pool."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))
    list(_pool.map(fn, items))


def _box(bb, shape):
    """Normalise ``bb`` to per-axis (start, stop) and the axes that an
    integer index drops."""
    if bb is None:
        bb = ()
    bb = tuple(bb) if isinstance(bb, (tuple, list)) else (bb,)
    if any(b is Ellipsis for b in bb):
        i = [j for j, b in enumerate(bb) if b is Ellipsis][0]
        fill = (slice(None),) * (len(shape) - len(bb) + 1)
        bb = bb[:i] + fill + bb[i + 1:]
    bb = bb + (slice(None),) * (len(shape) - len(bb))
    if len(bb) != len(shape):
        raise IndexError(f"box {bb} for an array of shape {shape}")
    box, drop = [], []
    for ax, (b, s) in enumerate(zip(bb, shape)):
        if isinstance(b, slice):
            start, stop, step = b.indices(s)
            if step != 1:
                raise IndexError("strided boxes are not supported")
            box.append((start, max(start, stop)))
        else:
            i = int(b) + (s if int(b) < 0 else 0)
            if not 0 <= i < s:
                raise IndexError(f"index {b} out of range {s}")
            box.append((i, i + 1))
            drop.append(ax)
    return box, tuple(drop)


class IoZarr:
    """``read(bb, key)`` / ``write(arr, bb, key)`` on a zarr v2 store.

    ``bb`` is a tuple of slices (step 1), integers and at most one
    Ellipsis, as numpy indexing takes it; a missing array raises KeyError
    in read mode."""

    def __init__(self, path: str, mode: str = "r"):
        self.path = path
        self.mode = mode
        self._meta: dict = {}
        self._cache: collections.OrderedDict = collections.OrderedDict()
        self._cache_bytes = 0
        self._lock = threading.RLock()

    # -- metadata -------------------------------------------------------
    def meta(self, key: str) -> dict:
        with self._lock:
            if key not in self._meta:
                fn = os.path.join(self.path, key, ".zarray")
                if not os.path.exists(fn):
                    raise KeyError(key)
                with open(fn) as f:
                    meta = json.load(f)
                if meta.get("zarr_format") != 2:
                    raise ValueError(f"{key}: not a zarr v2 array")
                if meta.get("filters"):
                    raise ValueError(f"{key}: zarr filters are not supported")
                if meta.get("order", "C") != "C":
                    raise ValueError(f"{key}: only C-order chunks are "
                                     "supported")
                if meta.get("dimension_separator", ".") != ".":
                    raise ValueError(f"{key}: only '.'-separated chunk keys "
                                     "are supported")
                comp = meta.get("compressor")
                if comp is not None and comp.get("id") not in ("gzip",
                                                               "zlib",
                                                               "blosc"):
                    raise ValueError(
                        f"{key}: compressor {comp.get('id')!r} ({comp}) "
                        "cannot be decoded here; only blosc, zlib, gzip "
                        "and raw chunks are read")
                self._meta[key] = meta
            return self._meta[key]

    def shape(self, key: str) -> tuple:
        return tuple(int(s) for s in self.meta(key)["shape"])

    def dtype(self, key: str) -> np.dtype:
        return np.dtype(self.meta(key)["dtype"])

    def create(self, key: str, shape, dtype, chunks=None, fill_value=0,
               compressor="zlib"):
        """A new array ``key`` (an existing one is deleted), chunked as
        ``chunks`` (default: one chunk), zlib-compressed or, with
        ``compressor=None``, raw."""
        if self.mode == "r":
            raise ValueError(f"{self.path}: opened read-only")
        if compressor == "zlib":
            comp = {"id": "zlib", "level": _ZLIB_LEVEL}
        elif compressor is None:
            comp = None
        else:
            raise ValueError(f"compressor {compressor!r}: only 'zlib' or "
                             "None can be written")
        shape = [int(s) for s in shape]
        chunks = [int(c) for c in (chunks if chunks is not None else shape)]
        d = os.path.join(self.path, key)
        with self._lock:
            if os.path.isdir(d):
                shutil.rmtree(d)
            os.makedirs(d)
            meta = {"zarr_format": 2, "shape": shape,
                    "chunks": [max(1, c) for c in chunks],
                    "dtype": np.dtype(dtype).str, "compressor": comp,
                    "fill_value": fill_value, "filters": None, "order": "C"}
            with open(os.path.join(d, ".zarray"), "w") as f:
                json.dump(meta, f)
            self._meta[key] = meta
            self._drop_cached(key)

    def set_attrs(self, key: str, attrs: dict):
        p = os.path.join(self.path, key, ".zattrs")
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w") as f:
            json.dump(attrs, f)

    def close(self):
        with self._lock:
            self._cache.clear()
            self._cache_bytes = 0

    def list_keys(self, prefix: str = "") -> list[str]:
        """Keys (arrays) under a group prefix, by .zarray presence."""
        root = os.path.join(self.path, prefix)
        out = []
        for dirpath, _dirnames, filenames in os.walk(root):
            if ".zarray" in filenames:
                out.append(os.path.relpath(dirpath, self.path))
        return sorted(out)

    # -- chunks ---------------------------------------------------------
    def _chunk_file(self, key, cidx) -> str:
        return os.path.join(self.path, key, ".".join(str(i) for i in cidx))

    def _drop_cached(self, key, cidx=None):
        for k in [k for k in self._cache
                  if k[0] == key and (cidx is None or k[1] == cidx)]:
            self._cache_bytes -= self._cache.pop(k).nbytes

    def _load_chunk(self, key, cidx) -> np.ndarray:
        """The decoded chunk ``cidx`` of ``key`` (read-only array)."""
        ck = (key, tuple(cidx))
        with self._lock:
            hit = self._cache.get(ck)
            if hit is not None:
                self._cache.move_to_end(ck)
                return hit
        meta = self.meta(key)
        dtype = np.dtype(meta["dtype"])
        chunks = tuple(meta["chunks"])
        fn = self._chunk_file(key, cidx)
        if os.path.exists(fn):
            with open(fn, "rb") as f:
                data = f.read()
            comp = meta.get("compressor")
            if comp is not None and comp["id"] == "blosc":
                data = blosc.decompress(data)
            elif comp is not None:
                # wbits 47 accepts both the gzip and the zlib container
                data = zlib.decompress(data, 47)
            block = np.frombuffer(data, dtype=dtype).reshape(chunks)
        else:
            block = np.full(chunks, meta.get("fill_value") or 0, dtype=dtype)
            block.setflags(write=False)
        if block.nbytes <= _CACHE_BYTES // 4:
            with self._lock:
                if ck not in self._cache:
                    self._cache[ck] = block
                    self._cache_bytes += block.nbytes
                while self._cache_bytes > _CACHE_BYTES:
                    _, old = self._cache.popitem(last=False)
                    self._cache_bytes -= old.nbytes
        return block

    def _store_chunk(self, key, cidx, block: np.ndarray):
        meta = self.meta(key)
        comp = meta.get("compressor")
        if comp is not None and comp["id"] != "zlib":
            raise ValueError(f"{key}: a {comp['id']} array is read-only "
                             "here; chunks are written zlib or raw")
        data = np.ascontiguousarray(block).tobytes()
        if comp is not None:
            data = zlib.compress(data, _ZLIB_LEVEL)
        fn = self._chunk_file(key, cidx)
        tmp = f"{fn}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, fn)
        with self._lock:
            self._drop_cached(key, tuple(cidx))

    @staticmethod
    def _chunks_of(box, chunks):
        return itertools.product(*[
            range(a // c, -(-b // c)) if b > a else range(0)
            for (a, b), c in zip(box, chunks)])

    # -- reads and writes -----------------------------------------------
    def read(self, bb=None, *, key: str) -> np.ndarray:
        meta = self.meta(key)
        shape = self.shape(key)
        chunks = tuple(meta["chunks"])
        box, drop = _box(bb, shape)
        out = np.empty(tuple(b - a for a, b in box), dtype=self.dtype(key))

        def fill(cidx):
            block = self._load_chunk(key, cidx)
            dst, src = [], []
            for (a, b), i, c in zip(box, cidx, chunks):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                dst.append(slice(lo - a, hi - a))
                src.append(slice(lo - i * c, hi - i * c))
            out[tuple(dst)] = block[tuple(src)]

        _map(fill, self._chunks_of(box, chunks))
        return out.reshape(tuple(n for ax, n in enumerate(out.shape)
                                 if ax not in drop))

    def read_points(self, points, *, key: str) -> np.ndarray:
        """Values at integer points: ``points`` (N, ndim - 1) indexes the
        spatial axes, the leading (channel) axis is read whole.  Returns
        (N, shape[0]).  Each chunk holding a point is decoded once."""
        meta = self.meta(key)
        shape = self.shape(key)
        chunks = np.array(meta["chunks"][1:])
        pts = np.asarray(points, dtype=np.int64).reshape(-1, len(shape) - 1)
        out = np.empty((len(pts), shape[0]), dtype=self.dtype(key))
        if np.any(pts < 0) or np.any(pts >= np.array(shape[1:])):
            raise IndexError("a point lies outside the array")
        if meta["chunks"][0] != shape[0]:
            raise ValueError("read_points needs whole chunks along the "
                             "channel axis")
        groups: dict = {}
        for i, c in enumerate(map(tuple, (pts // chunks).tolist())):
            groups.setdefault(c, []).append(i)

        def fill(item):
            c, rows = item
            block = self._load_chunk(key, (0,) + c)
            rel = pts[rows] - np.array(c) * chunks
            out[rows] = block[(slice(None),) + tuple(rel.T)].T

        _map(fill, groups.items())
        return out

    def write(self, out: np.ndarray, bb=None, *, key: str):
        if self.mode == "r":
            raise ValueError(f"{self.path}: opened read-only")
        meta = self.meta(key)
        shape = self.shape(key)
        chunks = tuple(meta["chunks"])
        dtype = self.dtype(key)
        box, drop = _box(bb, shape)
        want = tuple(b - a for a, b in box)
        out = np.asarray(out)
        if drop:
            out = np.expand_dims(out, drop)
        out = np.broadcast_to(out, want).astype(dtype, copy=False)

        def put(cidx):
            dst, src, full = [], [], True
            for (a, b), i, c, s in zip(box, cidx, chunks, shape):
                lo, hi = max(a, i * c), min(b, (i + 1) * c)
                dst.append(slice(lo - i * c, hi - i * c))
                src.append(slice(lo - a, hi - a))
                full &= lo == i * c and hi == min((i + 1) * c, s)
            if full:
                block = np.full(chunks, meta.get("fill_value") or 0, dtype)
                block[tuple(dst)] = out[tuple(src)]
                self._store_chunk(key, cidx, block)
                return
            with self._lock:   # read-modify-write of a partial chunk
                block = np.array(self._load_chunk(key, cidx))
                block[tuple(dst)] = out[tuple(src)]
                self._store_chunk(key, cidx, block)

        _map(put, self._chunks_of(box, chunks))


class IoHDF5:
    """``IoZarr``'s interface on an HDF5 file (``utils/hdf5.py``), as the
    JAX package's ``IoHDF5`` keeps results and snapshots.

    ``mode`` is ``"r"`` (the file must exist), ``"r+"`` (likewise,
    writable), ``"a"`` (created when missing) or ``"w"`` (truncated).
    Reads take any box, as ``IoZarr.read``, and inflate only the chunks it
    meets.  Writes are held in memory and reach the file at ``close()``,
    which rewrites it whole (a temporary file renamed over it): every
    dataset not written keeps its data and attributes, and one written
    whole replaces the old one, so a key whose shape changed is replaced
    as ``IoHDF5.write`` of the JAX package does (it keeps the dtype of a
    key written at the same shape, as h5py's ``ds[...] = out``).  Results
    and snapshots are small; a dataset is held whole once written."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "r+", "a", "w"):
            raise ValueError(f"mode {mode!r}: one of r, r+, a, w")
        exists = os.path.exists(path)
        if not exists and mode in ("r", "r+"):
            raise FileNotFoundError(path)
        self.path = path
        self.mode = mode
        self._file = hdf5.File(path) if exists and mode != "w" else None
        self._pending: dict = {}     # key -> [array, attrs, chunks]
        self._dirty = mode == "w" or not exists
        self._lock = threading.RLock()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _stored(self, key: str):
        if self._file is None or key not in self._file:
            raise KeyError(key)
        return self._file.dataset(key)

    def __contains__(self, key: str) -> bool:
        return key.strip("/") in self._pending or (
            self._file is not None and key in self._file)

    def shape(self, key: str) -> tuple:
        key = key.strip("/")
        if key in self._pending:
            return self._pending[key][0].shape
        return tuple(self._stored(key).shape)

    def dtype(self, key: str) -> np.dtype:
        key = key.strip("/")
        if key in self._pending:
            return self._pending[key][0].dtype
        return self._stored(key).dtype.newbyteorder("=")

    def attrs(self, key: str) -> dict:
        key = key.strip("/")
        if key in self._pending:
            return dict(self._pending[key][1])
        return self._stored(key).attrs()

    def list_keys(self, prefix: str = "") -> list[str]:
        prefix = prefix.strip("/")
        keys = set(self._file.keys() if self._file is not None else ())
        keys |= set(self._pending)
        return sorted(k for k in keys
                      if not prefix or k == prefix
                      or k.startswith(prefix + "/"))

    def read(self, bb=None, *, key: str) -> np.ndarray:
        key = key.strip("/")
        shape = self.shape(key)
        box, drop = _box(bb, shape)
        with self._lock:
            if key in self._pending:
                out = self._pending[key][0][tuple(slice(a, b)
                                                  for a, b in box)].copy()
            else:
                out = self._stored(key).read(box)
        return out.reshape(tuple(n for ax, n in enumerate(out.shape)
                                 if ax not in drop))

    def _held(self, key: str) -> list:
        """The pending entry of ``key``, loaded whole from the file when
        it has none yet."""
        if key not in self._pending:
            ds = self._stored(key)
            self._pending[key] = [ds.read(), ds.attrs(),
                                  getattr(ds, "chunks", None)]
        return self._pending[key]

    def _writable(self):
        if self.mode == "r":
            raise ValueError(f"{self.path}: opened read-only")

    def create(self, key: str, shape, dtype, chunks=None, fill_value=0,
               **_):
        """A new dataset ``key`` (an existing one is replaced) of
        ``fill_value``, chunked as ``chunks`` (default: h5py's guess)."""
        self._writable()
        with self._lock:
            self._pending[key.strip("/")] = [
                np.full(tuple(int(s) for s in shape), fill_value, dtype), {},
                chunks]
            self._dirty = True

    def write(self, out, bb=None, *, key: str, attrs=None):
        """``out`` into ``key``: whole (``bb`` None; a new key, or one of
        another shape, takes ``out``'s dtype) or into the window ``bb`` of
        an existing key; ``attrs`` are added to the key's attributes."""
        self._writable()
        key = key.strip("/")
        out = np.asarray(out)
        with self._lock:
            if bb is None:
                old = key in self
                if old and self.shape(key) == out.shape:
                    entry = self._held(key)
                    entry[0] = out.astype(entry[0].dtype)
                else:
                    self._pending[key] = [out.copy(), {}, None]
            else:
                if key not in self:
                    raise ValueError(f"{key}: create the dataset before "
                                     "writing a window of it")
                arr = self._held(key)[0]
                box, drop = _box(bb, arr.shape)
                sel = tuple(slice(a, b) for a, b in box)
                arr[sel] = np.expand_dims(out, drop) if drop else out
            if attrs:
                self._pending[key][1].update(attrs)
            self._dirty = True

    def set_attrs(self, key: str, attrs: dict):
        self._writable()
        with self._lock:
            self._held(key.strip("/"))[1].update(attrs)
            self._dirty = True

    def close(self):
        """Write the file if anything was written, then release it."""
        with self._lock:
            if self._dirty and self.mode != "r":
                for key in self.list_keys():
                    self._held(key)
                hdf5.write_file(self.path, {k: tuple(v) for k, v in
                                            self._pending.items()})
            if self._file is not None:
                self._file.close()
                self._file = None
            self._pending.clear()
            self._dirty = False


HDF5_SUFFIXES = (".hdf", ".h5", ".hdf5")


def open_volume(path: str, mode: str = "r"):
    """A store for ``path``: a zarr v2 directory (``.zarr``) or an HDF5
    file (``.hdf``, ``.h5``, ``.hdf5``), as the JAX package dispatches."""
    path = str(path)
    if path.rstrip("/").endswith(".zarr"):
        return IoZarr(path, mode)
    if path.endswith(HDF5_SUFFIXES):
        return IoHDF5(path, mode)
    raise ValueError(f"unsupported volume format: {path} (zarr v2 "
                     "directories and HDF5 files are read)")


def check_file(path: str, keys=None, remove_on_error: bool = False) -> bool:
    """Integrity probe: the store exists, opens, and one element of each
    of the given keys reads; a readable store that lacks a key is simply
    incomplete.  With ``remove_on_error`` a store that fails to read is
    deleted, so the stage that writes it runs again.  A store whose
    compressor this machine cannot decode raises (``blosc.Undecodable``):
    it is not broken."""
    if not os.path.exists(path):
        return False
    io = None
    try:
        io = open_volume(path, mode="r")
        for k in ([keys] if isinstance(keys, str) else (keys or [])):
            try:
                shape = io.shape(k)
            except KeyError:
                return False
            io.read(bb=tuple(slice(0, 1) for _ in shape), key=k)
        return True
    except blosc.Undecodable:
        raise
    except (ValueError, OSError, IndexError, zlib.error):
        if remove_on_error:
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                os.remove(path)
        return False
    finally:
        if io is not None:
            io.close()


def write_nrrd(path: str, arr: np.ndarray):
    """Minimal NRRD writer (raw encoding) for skeleton exports
    (util/postprocess.py:110-119 uses the external nrrd package; the
    format is a text header + raw little-endian data)."""
    arr = np.ascontiguousarray(arr)
    type_map = {np.dtype(np.uint8): "uint8", np.dtype(np.uint16): "uint16",
                np.dtype(np.int32): "int32", np.dtype(np.uint32): "uint32",
                np.dtype(np.int64): "int64", np.dtype(np.uint64): "uint64",
                np.dtype(np.float32): "float",
                np.dtype(np.float64): "double"}
    t = type_map.get(arr.dtype)
    if t is None:
        if np.issubdtype(arr.dtype, np.integer):
            # never round integer labels through float
            arr = arr.astype(np.int64)
            t = "int64"
        else:
            arr = arr.astype(np.float32)
            t = "float"
    # nrrd sizes are fastest-first (Fortran); a C-contiguous array's axes
    # are slowest-first, so list them reversed
    sizes = " ".join(str(s) for s in reversed(arr.shape))
    header = (f"NRRD0004\ntype: {t}\ndimension: {arr.ndim}\n"
              f"sizes: {sizes}\nencoding: raw\nendian: little\n\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(arr.tobytes())


def read_nrrd(path: str) -> np.ndarray:
    """Reader for the minimal raw-encoded NRRD files write_nrrd emits."""
    with open(path, "rb") as f:
        data = f.read()
    head, _, body = data.partition(b"\n\n")
    fields = dict(line.split(": ", 1) for line in
                  head.decode().splitlines()[1:] if ": " in line)
    dt = {"uint8": np.uint8, "uint16": np.uint16, "int32": np.int32,
          "uint32": np.uint32, "int64": np.int64, "uint64": np.uint64,
          "float": np.float32, "double": np.float64}[fields["type"]]
    sizes = [int(s) for s in fields["sizes"].split()]
    return np.frombuffer(body, dtype=dt).reshape(tuple(reversed(sizes)))



# -- TIFF and PNG --------------------------------------------------------------

# TIFF field types the reader decodes: BYTE, SHORT, LONG
_TIFF_TYPES = {1: "B", 3: "H", 4: "I"}
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def save_tif(path: str, arr: np.ndarray) -> str:
    """Baseline TIFF, uncompressed, little-endian, one strip per page.
    Integer or bool input is written as uint16, anything else as float32
    (SampleFormat 3), after a squeeze; one page in 2D, one page per z in
    3D.  The JAX package writes the same with PIL (utils/io.py:280-301:
    the cleaned uint16 label volume, stitch_patch_graph.py:836-841, and
    float32 patch mosaics, visualize/patches.py:196-198)."""
    arr = np.squeeze(np.asarray(arr))
    if np.issubdtype(arr.dtype, np.integer) or arr.dtype == bool:
        arr, sample_format = arr.astype("<u2"), 1
    else:
        arr, sample_format = arr.astype("<f4"), 3
    if arr.ndim not in (2, 3):
        raise ValueError(f"save_tif: unsupported ndim {arr.ndim}")
    pages = arr.reshape((-1,) + arr.shape[-2:])
    n, H, W = pages.shape
    page_bytes = H * W * arr.itemsize
    n_tags = 10
    ifd_bytes = 2 + 12 * n_tags + 4
    out = bytearray(b"II*\x00" + struct.pack("<I", 8))
    for i in range(n):
        data = len(out) + ifd_bytes
        tags = ((256, 4, W), (257, 4, H), (258, 3, 8 * arr.itemsize),
                (259, 3, 1),                  # no compression
                (262, 3, 1),                  # BlackIsZero
                (273, 4, data), (277, 3, 1), (278, 4, H),
                (279, 4, page_bytes), (339, 3, sample_format))
        out += struct.pack("<H", n_tags)
        for tag, typ, value in tags:
            out += struct.pack("<HHI" + ("H2x" if typ == 3 else "I"), tag,
                               typ, 1, value)
        out += struct.pack("<I", data + page_bytes if i + 1 < n else 0)
        out += pages[i].tobytes()
    with open(path, "wb") as f:
        f.write(out)
    return path


def read_tif(path: str) -> np.ndarray:
    """The pages of an uncompressed TIFF (either byte order, any strips,
    8-, 16-, 32- or 64-bit unsigned, signed or float samples): a 2D array
    for one page, else the pages stacked."""
    with open(path, "rb") as f:
        data = f.read()
    end = {b"II": "<", b"MM": ">"}.get(data[:2])
    if end is None or struct.unpack(end + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path}: not a classic TIFF file")
    frames = []
    off = struct.unpack(end + "I", data[4:8])[0]
    while off:
        (n,) = struct.unpack(end + "H", data[off:off + 2])
        tags = {}
        for k in range(n):
            e = off + 2 + 12 * k
            tag, typ, cnt = struct.unpack(end + "HHI", data[e:e + 8])
            if typ not in _TIFF_TYPES:
                continue
            fmt = end + _TIFF_TYPES[typ] * cnt
            size = struct.calcsize(fmt)
            at = e + 8 if size <= 4 else struct.unpack(
                end + "I", data[e + 8:e + 12])[0]
            tags[tag] = struct.unpack(fmt, data[at:at + size])
        off = struct.unpack(end + "I", data[off + 2 + 12 * n:
                                            off + 6 + 12 * n])[0]
        W, H = tags[256][0], tags[257][0]
        bits, spp = tags.get(258, (1,))[0], tags.get(277, (1,))[0]
        if tags.get(259, (1,))[0] != 1:
            raise ValueError(f"{path}: compressed TIFF (compression "
                             f"{tags[259][0]}) is not read")
        kind = {1: "u", 2: "i", 3: "f"}[tags.get(339, (1,))[0]]
        dt = np.dtype(f"{end}{kind}{bits // 8}")
        buf = b"".join(data[o:o + c] for o, c in zip(tags[273], tags[279]))
        page = np.frombuffer(buf, dtype=dt, count=H * W * spp)
        page = page.reshape((H, W, spp) if spp > 1 else (H, W))
        frames.append(page.astype(dt.newbyteorder("=")))
    return frames[0] if len(frames) == 1 else np.stack(frames)


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> str:
    """An 8-bit gray (H, W) or RGB (H, W, 3) uint8 image as PNG: one IDAT
    chunk, zlib at ``level``, filter type 0 on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png: expected uint8 (H, W) or (H, W, 3), "
                         f"got {img.dtype} {img.shape}")
    H, W = img.shape[:2]
    rows = np.zeros((H, 1 + img[0].size), np.uint8)
    rows[:, 1:] = img.reshape(H, -1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, 0 if img.ndim == 2 else 2,
                       0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", ihdr)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + _png_chunk(b"IEND", b""))
    return path


def _png_unfilter_row(kind: int, line: np.ndarray, prev: np.ndarray,
                      bpp: int) -> np.ndarray:
    """One row of PNG filter types 0-4 undone (uint8 arithmetic wraps)."""
    if kind == 0:
        return line.copy()
    if kind == 1:       # Sub: a running sum per byte of the pixel
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if kind == 2:       # Up
        return line + prev
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind}")
    cur = np.zeros_like(line)
    left = np.zeros(bpp, np.int64)
    up_left = np.zeros(bpp, np.int64)
    x = line.astype(np.int64)
    up = prev.astype(np.int64)
    for i in range(0, len(line), bpp):
        b = up[i:i + bpp]
        if kind == 3:   # Average
            v = x[i:i + bpp] + (left + b) // 2
        else:           # Paeth
            p = left + b - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - b), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, b, up_left))
            v = x[i:i + bpp] + pred
        left, up_left = v & 255, b
        cur[i:i + bpp] = left
    return cur


def read_png(path: str) -> np.ndarray:
    """A non-interlaced 8-bit gray or RGB PNG as (H, W) or (H, W, 3)
    uint8; every filter type is undone, so PIL's files read too."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    W, H, depth, ctype, _, _, interlace = head
    bpp = {0: 1, 2: 3}.get(ctype)
    if bpp is None or depth != 8 or interlace:
        raise ValueError(f"{path}: PNG colour type {ctype}, depth {depth}, "
                         f"interlace {interlace} is not read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(H, 1 + W * bpp)
    out = np.empty((H, W * bpp), np.uint8)
    prev = np.zeros(W * bpp, np.uint8)
    for y in range(H):
        prev = out[y] = _png_unfilter_row(int(raw[y, 0]), raw[y, 1:], prev,
                                          bpp)
    return out.reshape(H, W) if bpp == 1 else out.reshape(H, W, 3)
