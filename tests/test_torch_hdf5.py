"""The port's HDF5 reader and writer (``utils/hdf5.py``, ``IoHDF5`` in
``utils/io.py``) vs h5py and the JAX package's ``IoHDF5``, on the CPU.

Files written by h5py (directly and through the JAX package's
``IoHDF5.write`` / ``create``) are read by the port whole and over ragged
windows: contiguous, compact, chunked gzip, gzip + shuffle, fletcher32,
more than 64 chunks (a B-tree of two and three levels), chunks never
written (the fill value), nested groups, a user block, both byte orders,
u8 / u16 / i32 / i64 / f16 / f32 / f64, 2D / 3D / 4D, numeric
attributes.  Files written by the port are read by h5py and by the JAX
package's ``IoHDF5`` (data and attributes equal), and h5py appends to
them.  Append mode keeps the other keys and replaces a reshaped one.
What the reader does not read (libver 'latest', variable-length and enum
types) raises and names it.  Every comparison is exact.
"""

import itertools
import os

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from patchperpix_tpu.utils import io as jio
from patchperpix_tpu_torch.utils import hdf5
from patchperpix_tpu_torch.utils import io as tio

DTYPES = ["u1", "u2", "i4", "i8", "f2", "f4", "f8"]
SHAPES = [(23, 31), (9, 14, 17), (3, 7, 10, 6)]
LAYOUTS = ["contiguous", "compact", "gzip", "gzip_shuffle"]


def _array(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return rng.normal(scale=100, size=shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=shape,
                        dtype=dt.newbyteorder("="), endpoint=True).astype(dt)


def _windows(shape):
    """The whole array, a ragged interior window, one plane and one
    element."""
    yield [(0, s) for s in shape]
    yield [(s // 3, s - s // 4) for s in shape]
    yield [(1, 2)] + [(0, s) for s in shape[1:]]
    yield [(s - 1, s) for s in shape]


def _h5_write(path, key, arr, layout):
    with h5py.File(path, "w") as f:
        if layout == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            grp = f.require_group(os.path.dirname(key)) \
                if "/" in key else f
            sid = h5py.h5s.create_simple(arr.shape)
            tid = h5py.h5t.py_create(arr.dtype)
            h5py.h5d.create(grp.id, os.path.basename(key).encode(), tid,
                            sid, dcpl=dcpl)
            f[key][...] = arr
        else:
            kw = {} if layout == "contiguous" else dict(
                compression="gzip", shuffle=layout == "gzip_shuffle")
            f.create_dataset(key, data=arr, **kw)


@pytest.mark.parametrize("dtype,layout", list(itertools.product(DTYPES,
                                                                LAYOUTS)))
def test_h5py_files_read_by_port(tmp_path, dtype, layout):
    i = DTYPES.index(dtype) + LAYOUTS.index(layout)
    shape = SHAPES[i % len(SHAPES)]
    arr = _array(shape, dtype, i)
    path = str(tmp_path / "a.hdf")
    _h5_write(path, "volumes/raw", arr, layout)
    f = hdf5.File(path)
    ds = f.dataset("volumes/raw")
    assert ds.layout == {"compact": 0, "contiguous": 1}.get(layout, 2)
    assert f.keys() == ["volumes/raw"] and ds.shape == shape
    for box in _windows(shape):
        sel = tuple(slice(a, b) for a, b in box)
        got = ds.read(box)
        assert got.dtype == arr.dtype and np.array_equal(got, arr[sel])
    f.close()


@pytest.mark.parametrize("dtype", [">i2", ">u4", ">f4", ">f8", "<i8"])
def test_byte_orders_read_native(tmp_path, dtype):
    arr = _array((12, 13), dtype, 3)
    path = str(tmp_path / "b.hdf")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=arr, compression="gzip", chunks=(5, 6))
        f["x"].attrs["v"] = arr[0]
    io = tio.IoHDF5(path)
    got = io.read(key="x")
    assert got.dtype == np.dtype(dtype).newbyteorder("=")
    assert np.array_equal(got, arr) and np.array_equal(io.attrs("x")["v"],
                                                       arr[0])
    io.close()


@pytest.mark.parametrize("shape,chunks", [((300, 300), (10, 10)),
                                          ((68, 64, 64), (4, 4, 4))])
def test_multi_level_btree_and_fill(tmp_path, shape, chunks):
    """900 chunks (a root over 15 leaves) and 4,352 (three levels), a
    third of them never written: they read as the fill value."""
    arr = _array(shape, "f4", 5)
    path = str(tmp_path / "m.hdf")
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("x", shape=shape, dtype="f4", chunks=chunks,
                              compression="gzip", fillvalue=-7.5)
        cut = (slice(0, shape[0] * 2 // 3),) + (slice(None),) * (
            len(shape) - 1)
        ds[cut] = arr[cut]
    want = arr.copy()
    want[shape[0] * 2 // 3:] = -7.5
    io = tio.IoHDF5(path)
    np.testing.assert_array_equal(io.read(key="x"), want)
    for box in _windows(shape):
        sel = tuple(slice(a, b) for a, b in box)
        np.testing.assert_array_equal(io.read(sel, key="x"), want[sel])
    io.close()


def test_jax_iohdf5_files_read_by_port(tmp_path):
    """The JAX package's result writer (append, gzip, offset / resolution
    attributes, a reshaped key replaced) and ``create``."""
    path = str(tmp_path / "r.hdf")
    inst = _array((50, 50, 50), "i4", 1) % 20
    fg = (inst > 3).astype(np.uint8)
    out = jio.IoHDF5(path, mode="a")
    out.write(inst[:10], key="vote_instances")
    out.write(inst, key="vote_instances",
              attrs={"offset": (0, 0, 0), "resolution": (1, 1, 1)})
    out.write(fg, key="vote_foreground",
              attrs={"offset": (0, 0, 0), "resolution": (1, 1, 1)})
    out.create("volumes/made", (20, 30), np.float32, chunks=(7, 9))
    out.write(np.ones((5, 30), np.float32), bb=(slice(2, 7),),
              key="volumes/made")
    out.close()
    with h5py.File(path, "r") as f:
        assert f["vote_instances"].chunks == hdf5.guess_chunk(inst.shape, 4)
    io = tio.IoHDF5(path)
    assert io.list_keys() == ["volumes/made", "vote_foreground",
                              "vote_instances"]
    assert np.array_equal(io.read(key="vote_instances"), inst)
    assert np.array_equal(io.read(key="vote_foreground"), fg)
    for key in ("vote_instances", "vote_foreground"):
        attrs = io.attrs(key)
        assert set(attrs) == {"offset", "resolution"}
        assert attrs["offset"].dtype == np.int64
        assert attrs["resolution"].tolist() == [1, 1, 1]
    made = io.read(key="volumes/made")
    assert made.dtype == np.float32 and made[2:7].all() and \
        not made[:2].any() and not made[7:].any()
    # integer indices drop axes, an Ellipsis fills, as in IoZarr.read
    assert np.array_equal(io.read((4, Ellipsis, 7), key="vote_instances"),
                          inst[4, :, 7])
    io.close()


def test_nested_groups_userblock_fletcher_attrs(tmp_path):
    path = str(tmp_path / "n.h5")
    a = _array((6, 40, 41), "u2", 2)
    with h5py.File(path, "w", userblock_size=512) as f:
        f.create_dataset("volumes/raw", data=a, compression="gzip",
                         shuffle=True, fletcher32=True, chunks=(2, 9, 11))
        f.create_dataset("volumes/labels/gt", data=a.astype("i8") - 9)
        for i in range(20):   # a group of 20 members: 3 symbol-table nodes
            f.create_dataset(f"many/k{i:02d}", data=np.arange(i + 1))
        f["volumes/raw"].attrs.update({"resolution": (40, 4, 4),
                                       "scale": 0.5, "n": np.int16(-3)})
        keys = []
        f.visititems(lambda k, v: keys.append(k)
                     if isinstance(v, h5py.Dataset) else None)
    io = tio.open_volume(path)
    assert io.list_keys() == sorted(keys)
    assert io.list_keys("volumes") == ["volumes/labels/gt", "volumes/raw"]
    assert np.array_equal(io.read(key="volumes/raw"), a)
    assert np.array_equal(io.read((slice(1, 4), slice(3, 30)),
                                  key="volumes/raw"), a[1:4, 3:30])
    assert np.array_equal(io.read(key="volumes/labels/gt"), a.astype("i8") - 9)
    assert np.array_equal(io.read(key="many/k13"), np.arange(14))
    attrs = io.attrs("volumes/raw")
    assert attrs["resolution"].tolist() == [40, 4, 4]
    assert attrs["scale"] == 0.5 and attrs["n"] == -3
    assert attrs["n"].dtype == np.int16
    with pytest.raises(KeyError):
        io.read(key="volumes/missing")
    io.close()


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_random_shapes_chunks_windows(tmp_path, data):
    """Hypothesis: random shape, chunk shape, dtype and window; h5py
    writes, the port reads; the port writes, h5py reads."""
    nd = data.draw(st.integers(1, 4))
    shape = tuple(data.draw(st.lists(st.integers(1, 13), min_size=nd,
                                     max_size=nd)))
    chunks = tuple(data.draw(st.integers(1, s)) for s in shape)
    dtype = data.draw(st.sampled_from(DTYPES))
    arr = _array(shape, dtype, data.draw(st.integers(0, 99)))
    box = [tuple(sorted(data.draw(st.lists(st.integers(0, s), min_size=2,
                                           max_size=2)))) for s in shape]
    sel = tuple(slice(a, b) for a, b in box)
    path = str(tmp_path / "h.hdf")
    with h5py.File(path, "w") as f:
        f.create_dataset("d", data=arr, chunks=chunks, compression="gzip")
    f = hdf5.File(path)
    assert np.array_equal(f.dataset("d").read(box), arr[sel])
    f.close()
    mine = str(tmp_path / "p.hdf")
    hdf5.write_file(mine, {"g/d": (arr, {"shape": shape}, chunks)})
    with h5py.File(mine, "r") as f:
        assert f["g/d"].chunks == chunks
        assert np.array_equal(f["g/d"][sel], arr[sel])
        assert f["g/d"].attrs["shape"].tolist() == list(shape)


@pytest.mark.parametrize("dtype", DTYPES)
def test_port_files_read_by_h5py_and_jax(tmp_path, dtype):
    """Port-written datasets of every type, 0D to 4D, more than 64
    chunks, nested groups and numeric attributes read equal through h5py
    and the JAX package's ``IoHDF5``."""
    path = str(tmp_path / "p.hdf")
    arrays = {"vote_instances": _array((50, 50, 50), dtype, 1),
              "volumes/raw": _array((3, 20, 21, 22), dtype, 2),
              "volumes/deep/x": _array((130, 140), dtype, 3),
              "scalar": _array((), dtype, 4),
              "empty": np.zeros((0, 4), dtype)}
    attrs = {"vote_instances": {"offset": (0, 0, 0),
                                "resolution": (1, 1, 1)},
             "volumes/raw": {"scale": 0.25, "n": np.uint8(7),
                             "v": np.arange(5, dtype=np.float32)}}
    with tio.IoHDF5(path, mode="w") as io:
        for key, arr in arrays.items():
            io.write(arr, key=key, attrs=attrs.get(key))
        io.create("volumes/deep/many", (100, 100), dtype, chunks=(10, 10))
        io.write(arrays["volumes/deep/x"][:50, :60], bb=(slice(20, 70),
                                                         slice(0, 60)),
                 key="volumes/deep/many")
    many = np.zeros((100, 100), dtype)
    many[20:70, :60] = arrays["volumes/deep/x"][:50, :60]
    arrays["volumes/deep/many"] = many
    jax_io = jio.IoHDF5(path, mode="r")
    with h5py.File(path, "r") as f:
        assert f["volumes/deep/many"].chunks == (10, 10)
        assert f["vote_instances"].chunks == hdf5.guess_chunk(
            (50, 50, 50), np.dtype(dtype).itemsize)
        for key, arr in arrays.items():
            for got in (f[key][()], np.asarray(jax_io.read(key=key))):
                assert got.dtype == arr.dtype and got.shape == arr.shape
                assert np.array_equal(got, arr), key
            want = attrs.get(key, {})
            assert set(f[key].attrs) == set(want)
            for name, value in want.items():
                got = f[key].attrs[name]
                assert np.array_equal(got, value), name
                if isinstance(value, tuple):
                    assert got.dtype == np.int64
    jax_io.close()


def test_append_keeps_keys_and_replaces_reshaped(tmp_path):
    """Append mode as the JAX package's ``IoHDF5.write``: other keys
    stay, a key written at its shape keeps its dtype and attributes, a
    reshaped key is replaced; h5py appends to a port-written file and the
    port reads what it added."""
    path = str(tmp_path / "a.hdf")
    a = _array((10, 11, 12), "i4", 1)
    with tio.IoHDF5(path, mode="a") as io:
        io.write(a, key="vote_instances", attrs={"offset": (0, 0, 0)})
        io.write((a > 0).astype(np.uint8), key="vote_foreground")
    with tio.IoHDF5(path, mode="a") as io:
        io.write(a.astype(np.int64) * 2, key="vote_instances")
        io.write(a[:5].astype(np.uint8), key="vote_foreground")
        io.write(a[0], key="vote_instances_ps1")
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["vote_foreground", "vote_instances",
                                    "vote_instances_ps1"]
        assert f["vote_instances"].dtype == np.int32
        assert np.array_equal(f["vote_instances"][()], a * 2)
        assert f["vote_instances"].attrs["offset"].tolist() == [0, 0, 0]
        assert f["vote_foreground"].shape == (5, 11, 12)
        assert f["vote_foreground"].dtype == np.uint8
    with h5py.File(path, "a") as f:
        del f["vote_foreground"]
        f.create_dataset("vote_instances_rm_5", data=a[1:].astype("u2"),
                         compression="gzip")
        f["vote_instances"][...] = 3
        for i in range(12):
            f.create_dataset(f"extra/k{i}", data=np.full(3, i))
    io = tio.IoHDF5(path)
    assert io.list_keys() == sorted(
        ["vote_instances", "vote_instances_ps1", "vote_instances_rm_5"]
        + [f"extra/k{i}" for i in range(12)])
    assert (io.read(key="vote_instances") == 3).all()
    assert np.array_equal(io.read(key="vote_instances_rm_5"),
                          a[1:].astype("u2"))
    assert io.read(key="extra/k11").tolist() == [11, 11, 11]
    io.close()
    with pytest.raises(ValueError, match="read-only"):
        tio.IoHDF5(path).write(a, key="x")
    with pytest.raises(ValueError, match="create the dataset"):
        tio.IoHDF5(path, mode="r+").write(a[0], bb=(0,), key="missing")


def test_check_file_and_open_volume(tmp_path):
    path = str(tmp_path / "c.hdf")
    with tio.IoHDF5(path, mode="w") as io:
        io.write(np.arange(6), key="vote_instances")
    assert tio.check_file(path, ["vote_instances"])
    assert not tio.check_file(path, ["vote_instances_ps0"])
    assert os.path.exists(path)
    with open(path, "r+b") as f:
        f.write(b"\0" * 16)
    assert not tio.check_file(path, ["vote_instances"],
                              remove_on_error=True)
    assert not os.path.exists(path)
    for suffix in (".hdf", ".h5", ".hdf5"):
        assert isinstance(tio.open_volume(str(tmp_path / ("x" + suffix)),
                                          mode="w"), tio.IoHDF5)
    with pytest.raises(ValueError, match="unsupported"):
        tio.open_volume(str(tmp_path / "x.n5"))


@pytest.mark.parametrize("libver,match", [
    ("latest", "superblock version 3"), ("v108", "superblock version 2")])
def test_latest_formats_raise_naming_them(tmp_path, libver, match):
    path = str(tmp_path / "l.hdf")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=np.arange(10), chunks=(4,),
                         maxshape=(None,))
    with pytest.raises(ValueError, match=match):
        hdf5.File(path)


def test_unread_features_raise_naming_them(tmp_path):
    path = str(tmp_path / "u.hdf")
    with h5py.File(path, "w") as f:
        f.create_dataset("vlen", data=np.arange(3))
        f["vlen"].attrs["name"] = "a string"
        f.create_dataset("bool", data=np.array([True, False]))
    with h5py.File(str(tmp_path / "t.hdf"), "w", track_order=True) as f:
        f.create_dataset("x", data=np.arange(3))
    io = tio.IoHDF5(path)
    with pytest.raises(ValueError, match="variable-length"):
        io.attrs("vlen")
    assert io.read(key="vlen").tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="enum"):
        io.read(key="bool")
    io.close()
    with pytest.raises(ValueError, match="version 2 object headers"):
        hdf5.File(str(tmp_path / "t.hdf"))


def test_guess_chunk_is_h5pys():
    from h5py._hl.filters import guess_chunk

    for shape, item in (((50, 50, 50), 4), ((1, 512, 512), 8),
                        ((3, 50, 50, 50), 2), ((7,), 1), ((1000, 1000), 1),
                        ((0, 5), 4)):
        assert hdf5.guess_chunk(shape, item) == guess_chunk(shape, None,
                                                            item)
