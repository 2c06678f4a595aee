"""The port's visualization against the JAX package's, on the CPU.

Renders, mosaics and debug canvases must equal the JAX package's bit for
bit on the same seeded inputs; the port writes its PNG and TIFF files
without PIL (``utils/io.py``), so its files are read here with PIL and
compared with the JAX package's PIL-written files, and the port's readers
read the JAX package's files.  ``vote_debug``, ``save_mip`` and
``save_tif`` run through ``do_all`` / ``finalize_and_write`` of both
packages on ideal affinities on a dyadic grid (every consensus and graph
sum exact in float32, so the pairs and weights are equal and so are the
canvases drawn from them), the JAX package on its host engine
(``engine="numpy"``, ``removeIntersection`` off, as in
``tests/test_torch_vote_options.py``).  The ``visualize`` task runs
through both CLIs on the same results.
"""

import os
import struct
import zlib

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from patchperpix_tpu import cli as jcli
from patchperpix_tpu.assembly import debug_viz as jdv
from patchperpix_tpu.assembly import vote_instances as jvi
from patchperpix_tpu.utils import io as jio
from patchperpix_tpu.visualize import instances as jinst
from patchperpix_tpu.visualize import patches as jpat
from patchperpix_tpu_torch import cli as tcli
from patchperpix_tpu_torch.assembly import debug_viz as tdv
from patchperpix_tpu_torch.assembly import vote_instances as tvi
from patchperpix_tpu_torch.ops import synthetic
from patchperpix_tpu_torch.utils import io as tio
from patchperpix_tpu_torch.visualize import instances as tinst
from patchperpix_tpu_torch.visualize import patches as tpat

torch.set_num_threads(1)


def _pil(path):
    with Image.open(path) as img:
        return np.asarray(img)


def _labels(shape, n, seed):
    rng = np.random.RandomState(seed)
    lab = rng.randint(0, n + 1, shape).astype(np.uint16)
    lab[rng.rand(*shape) < 0.4] = 0
    return lab


# -- PNG and TIFF -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(13, 17), (9, 21, 3), (1, 1)])
def test_png_against_pil(shape, tmp_path):
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    tio.write_png(str(tmp_path / "t.png"), img)
    Image.fromarray(img).save(tmp_path / "j.png")
    assert np.array_equal(_pil(tmp_path / "t.png"), img)
    got = tio.read_png(str(tmp_path / "j.png"))
    assert got.dtype == np.uint8 and np.array_equal(got, img)


def _filtered_png(img, kinds):
    """A PNG of ``img`` whose rows carry the given filter types (encoded
    here from the PNG specification's predictors)."""
    H = img.shape[0]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(H, -1).astype(np.int64)
    out = []
    for y in range(H):
        kind = kinds[y % len(kinds)]
        cur = rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        out.append(bytes([kind]) + ((cur - pred) & 255).astype(
            np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    head = struct.pack(">IIBBBBB", img.shape[1], H, 8,
                       0 if img.ndim == 2 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", head)
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(11, 14), (7, 9, 3)])
def test_png_reader_undoes_every_filter(shape, tmp_path):
    img = np.random.RandomState(1).randint(0, 256, shape).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(img, [0, 1, 2, 3, 4]))
    assert np.array_equal(_pil(path), img)
    assert np.array_equal(tio.read_png(str(path)), img)
    # what the port never writes is refused, not misread
    Image.fromarray(np.zeros((3, 4, 4), np.uint8)).save(tmp_path / "a.png")
    with pytest.raises(ValueError, match="colour type 6"):
        tio.read_png(str(tmp_path / "a.png"))


@pytest.mark.parametrize("arr", [
    np.random.RandomState(2).randint(0, 70000, (6, 7)),          # int64
    np.random.RandomState(3).randint(0, 900, (3, 6, 9)).astype(np.uint16),
    np.random.RandomState(4).rand(1, 8, 9),                       # float64
    np.random.RandomState(5).rand(4, 5, 6).astype(np.float32),
    np.random.RandomState(6).rand(5, 6) > 0.5,                    # bool
], ids=["int64_2d", "uint16_3d", "float_2d", "float32_3d", "bool_2d"])
def test_tif_against_jax(arr, tmp_path):
    """The port's TIFF read by PIL (the JAX package's reader) equals the
    JAX package's file; the port's reader reads the JAX file."""
    tio.save_tif(str(tmp_path / "t.tif"), arr)
    jio.save_tif(str(tmp_path / "j.tif"), arr)
    want = jio.read_tif(str(tmp_path / "j.tif"))
    got_pil = jio.read_tif(str(tmp_path / "t.tif"))
    assert got_pil.dtype == want.dtype and np.array_equal(got_pil, want)
    for path in ("t.tif", "j.tif"):
        got = tio.read_tif(str(tmp_path / path))
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError, match="ndim"):
        tio.save_tif(str(tmp_path / "x.tif"), np.zeros((2, 3, 4, 5)))


# -- renders -------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "raw", "outline"])
@pytest.mark.parametrize("shape", [(6, 20, 23), (18, 25)])
def test_render_instances_matches_jax(mode, shape, tmp_path):
    lab = _labels(shape, 7, 7)
    raw = None if mode == "plain" else \
        np.random.RandomState(8).rand(3, *shape).astype(np.float32) * 900
    kw = dict(raw=raw, outline=mode == "outline", seed=3)
    got = tinst.render_instances(lab, device="cpu", **kw)
    want = jinst.render_instances(lab, **kw)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    tinst.visualize_instances(lab, str(tmp_path / "t.png"), device="cpu",
                              **kw)
    jinst.visualize_instances(lab, str(tmp_path / "j.png"), **kw)
    assert np.array_equal(_pil(tmp_path / "t.png"), _pil(tmp_path / "j.png"))
    assert np.array_equal(tio.read_png(str(tmp_path / "j.png")), want)


@pytest.mark.parametrize("scale", [900.0, 1e-7])
def test_save_mip_matches_jax(scale, tmp_path):
    vol = np.random.RandomState(9).rand(5, 14, 16).astype(np.float32) * scale
    tinst.save_mip(vol, str(tmp_path / "t.png"), device="cpu")
    jinst.save_mip(vol, str(tmp_path / "j.png"))
    assert np.array_equal(_pil(tmp_path / "t.png"), _pil(tmp_path / "j.png"))


@pytest.mark.parametrize("ps,vol,z,selected", [
    ((3, 3, 3), (5, 8, 9), None, None),
    ((3, 5, 3), (5, 8, 9), 2, [(2, 1, 3), (0, 7, 8)]),
    ((1, 5, 5), (1, 9, 7), None, [(0, 4, 4)]),
    ((5, 5), (9, 7), None, None),
])
def test_patch_mosaic_matches_jax(ps, vol, z, selected, tmp_path):
    affs = np.random.RandomState(10).rand(int(np.prod(ps)), *vol).astype(
        np.float32) * 1.2 - 0.1
    got = tpat.patch_mosaic(affs, ps, z=z, selected=selected, device="cpu")
    want = jpat.patch_mosaic(affs, ps, z=z, selected=selected)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for ext, read in ((".png", _pil), (".tif", jio.read_tif)):
        tpat.visualize_patches(affs, ps, str(tmp_path / ("t" + ext)), z=z,
                               selected=selected, device="cpu")
        jpat.visualize_patches(affs, ps, str(tmp_path / ("j" + ext)), z=z,
                               selected=selected)
        assert np.array_equal(read(str(tmp_path / ("t" + ext))),
                              read(str(tmp_path / ("j" + ext))))


@pytest.mark.parametrize("ps,vol,z", [
    ((3, 3, 3), (6, 8, 9), None), ((3, 5, 3), (6, 8, 9), 1),
    ((1, 5, 5), (1, 9, 11), None)])
def test_render_patch_tiles_matches_jax(ps, vol, z):
    rng = np.random.RandomState(11)
    affs = rng.rand(int(np.prod(ps)), *vol).astype(np.float32)
    fg = rng.rand(*vol) > 0.5
    got = tdv.render_patch_tiles(affs, fg, ps, z=z, device="cpu")
    want = jdv.render_patch_tiles(affs, fg, ps, z=z)
    assert got.shape == (ps[1] * vol[1], ps[2] * vol[2])
    assert np.array_equal(got, want)
    # a tensor input renders the same
    assert np.array_equal(tdv.render_patch_tiles(torch.from_numpy(affs), fg,
                                                 ps, z=z, device="cpu"), want)


@pytest.mark.parametrize("n", [0, 1, 40])
def test_render_graph_edges_matches_jax(n):
    rng = np.random.RandomState(12)
    vol, ps = (4, 9, 11), (3, 3, 3)
    a = np.stack([rng.randint(0, s, n) for s in vol], 1)
    b = np.clip(a + rng.randint(-3, 4, a.shape), 0, np.array(vol) - 1)
    pairs = np.concatenate([a, b], 1).astype(np.uint32)
    w = (rng.rand(n) * 0.9 + 0.1).astype(np.float32)
    got = tdv.render_graph_edges(pairs, w, vol, ps)
    want = jdv.render_graph_edges(pairs, w, vol, ps)
    assert np.array_equal(got, want)
    assert (got != 0).any() == (n > 0)


# -- vote_debug, save_mip, save_tif through the assembly ---------------------

BASE = dict(patch_threshold=0.5, fc_threshold=0.5, mws=True,
            removeIntersection=False, select_patches_for_sparse_data=False,
            includeSinglePatchCCS=True, fg_key="volumes/pred_fgbg")


def _ideal(kind):
    """Ideal affinities on a dyadic grid (1/8 steps, a seeded fifth moved
    to 3/8 or 5/8) of seeded labels: three worms at 72x144 with 5x5
    patches, or tubes at 24^3 with 3^3 patches.  (affs, fg, ps)."""
    if kind == "2d":
        ps = (1, 5, 5)
        labels = synthetic.worm_labels(72, 144, n_worms=3, seed=4)
    else:
        ps = (3, 3, 3)
        labels = synthetic.synth_labels(24, seed=1)
    affs = synthetic.labels_to_affinities(labels, np.array(ps), hi=0.875,
                                          lo=0.125)
    rng = np.random.RandomState(13)
    moved = rng.rand(*affs.shape) < 0.2
    affs = np.where(moved, rng.choice([0.375, 0.625], affs.shape),
                    affs).astype(np.float32)
    return affs, labels > 0, ps


def _stores(tmp_path, affs, fg):
    paths = {}
    for name, io_cls in (("t", tio.IoZarr), ("j", jio.IoZarr)):
        path = str(tmp_path / name / "s.zarr")
        os.makedirs(os.path.dirname(path))
        io = io_cls(path, mode="w")
        for key, arr in (("volumes/pred_affs", affs),
                         ("volumes/pred_fgbg", fg.astype(np.float32)[None])):
            io.create(key, arr.shape, np.float32, chunks=arr.shape)
            io.write(arr, key=key)
        io.close()
        paths[name] = path
    return paths


def _read(path, key):
    if path.endswith(".hdf"):
        with h5py.File(path, "r") as f:
            return f[key][()]
    return tio.IoZarr(path).read(key=key)


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_vote_debug_save_mip_save_tif_match_jax(kind, tmp_path):
    """do_all with vote_debug, save_mip and save_tif in both packages: the
    two canvases equal bit for bit, the map equal to the run without
    vote_debug and to the JAX map, the MIPs and the TIF equal.  The
    consensus and graph normalisations are off: their quotients round
    differently in the two packages (one float32 step), and the edge
    canvas holds the weights themselves."""
    affs, fg, ps = _ideal(kind)
    paths = _stores(tmp_path, affs, fg)
    kw = dict(BASE, patchshape=ps, vote_debug=True, save_mip=True,
              save_tif=True, remove_small_comps=3, consensus_norm_aff=False,
              consensus_norm_prob_product=False, patch_graph_norm_aff=False)
    out = {}
    for name, mod, extra in (("t", tvi, {}), ("j", jvi, {"engine": "numpy"})):
        folder = str(tmp_path / name / "inst")
        p = mod.VoteInstancesParams(**kw, **extra)
        res = (mod.do_all(paths[name], p, folder, device="cpu")
               if mod is tvi else mod.do_all(paths[name], p, folder))
        out[name] = {k: _read(res, k) for k in
                     ("vote_instances", "vote_debug", "vote_debug2")}
        out[name]["files"] = {f: (jio.read_tif if f.endswith(".tif")
                                  else _pil)(os.path.join(folder, f))
                              for f in ("s.png", "s_cleaned.png", "s.tif")}
    t, j = out["t"], out["j"]
    vol = fg.shape
    assert t["vote_debug"].shape == (ps[1] * vol[1], ps[2] * vol[2])
    assert t["vote_debug"].dtype == np.float32
    for key in ("vote_instances", "vote_debug", "vote_debug2"):
        assert np.array_equal(t[key], j[key]), key
    assert (t["vote_debug2"] != 0).any() and len(np.unique(t[
        "vote_instances"])) > 2
    for f in t["files"]:
        assert np.array_equal(t["files"][f], j["files"][f]), f
    assert np.array_equal(tio.read_tif(str(tmp_path / "t" / "inst" /
                                           "s.tif")), t["files"]["s.tif"])
    # the labelling from the debug pass's graph is the plain run's map
    plain = tvi.do_all(paths["t"], tvi.VoteInstancesParams(
        **dict(kw, vote_debug=False, res_key="plain")),
        str(tmp_path / "t" / "inst"), device="cpu")
    assert np.array_equal(_read(plain, "plain"), t["vote_instances"])


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_vote_debug_default_normalisations_match_jax(kind, tmp_path):
    """do_all with vote_debug at the default normalisations: the map and
    the affinity canvas equal the JAX package's bit for bit; the edge
    canvas has the same drawn pixels and values within 1e-6 relative.
    Its weights sum normalised consensus values in another order in each
    package (6 float32 steps at most on these inputs, 3.6e-7 at 0.5)."""
    affs, fg, ps = _ideal(kind)
    paths = _stores(tmp_path, affs, fg)
    kw = dict(BASE, patchshape=ps, vote_debug=True)
    out = {}
    for name, mod, extra in (("t", tvi, {}), ("j", jvi, {"engine": "numpy"})):
        folder = str(tmp_path / name / "inst")
        p = mod.VoteInstancesParams(**kw, **extra)
        assert p.consensus_norm_aff and p.patch_graph_norm_aff
        res = (mod.do_all(paths[name], p, folder, device="cpu")
               if mod is tvi else mod.do_all(paths[name], p, folder))
        out[name] = {k: _read(res, k) for k in
                     ("vote_instances", "vote_debug", "vote_debug2")}
    t, j = out["t"], out["j"]
    assert len(np.unique(t["vote_instances"])) > 2
    assert np.array_equal(t["vote_instances"], j["vote_instances"])
    assert np.array_equal(t["vote_debug"], j["vote_debug"])
    assert t["vote_debug2"].dtype == j["vote_debug2"].dtype == np.float32
    assert np.array_equal(t["vote_debug2"] != 0, j["vote_debug2"] != 0)
    assert (t["vote_debug2"] != 0).any()
    np.testing.assert_allclose(t["vote_debug2"], j["vote_debug2"],
                               rtol=1e-6, atol=0)


def test_vote_debug_blockwise_renders_nothing(tmp_path):
    """As in the JAX package, vote_debug is a whole-volume option: the
    blockwise branch writes no canvas."""
    affs, fg, ps = _ideal("3d")
    paths = _stores(tmp_path, affs, fg)
    p = tvi.VoteInstancesParams(**BASE, patchshape=ps, vote_debug=True,
                                blockwise=True, chunksize=(12, 12, 12))
    res = tvi.do_all(paths["t"], p, str(tmp_path / "inst"), device="cpu")
    assert tio.check_file(res, keys=["vote_instances"])
    assert not tio.check_file(res, keys=["vote_debug"])


# -- the visualize task -------------------------------------------------------

@pytest.mark.parametrize("z", [None, 3])
def test_visualize_task_matches_jax(z, tmp_path):
    """``-d visualize`` with show_patches through both CLIs on the same
    results (``.hdf``, each package's own writer) and predictions: the
    instance PNG and the patch mosaic equal."""
    affs, fg, ps = _ideal("3d")
    inst = _labels(fg.shape, 5, 14)
    cfg = tmp_path / "viz.toml"
    cfg.write_text("[model]\npatchshape = [3, 3, 3]\n[visualize]\n"
                   "show_patches = true\n"
                   + ("" if z is None else f"patch_mosaic_z = {z}\n"))
    written = {}
    for name, mod in (("port", tcli), ("jax", jcli)):
        base = tmp_path / "exps" / name / "test"
        proc, res = base / "processed" / "1", base / "instanced" / "1"
        os.makedirs(proc)
        os.makedirs(res)
        io = tio.IoZarr(str(proc / "s.zarr"), mode="w")
        io.create("volumes/pred_affs", affs.shape, np.float16,
                  chunks=affs.shape)
        io.write(affs.astype(np.float16), key="volumes/pred_affs")
        io.close()
        # a prediction store without affinities is passed over
        os.makedirs(proc / "empty.zarr")
        if mod is tcli:
            with tio.IoHDF5(str(res / "s.hdf"), mode="w") as io:
                io.write(inst, key="vote_instances")
        else:
            with h5py.File(res / "s.hdf", "w") as f:
                f["vote_instances"] = inst
        argv = ["-c", str(cfg), "--root", str(tmp_path / "exps"), "-id",
                name, "--checkpoint", "1", "-d", "visualize"]
        mod.main(argv + (["--device", "cpu"] if mod is tcli else []))
        written[name] = {f: _pil(p) for f, p in (
            ("inst", res / "s.png"), ("patches", proc / "s_patches.png"))}
    assert written["port"]["patches"].shape == (3 * 24, 3 * 24)
    for f in ("inst", "patches"):
        assert np.array_equal(written["port"][f], written["jax"][f]), f
    assert np.array_equal(written["port"]["inst"],
                          tinst.render_instances(inst, device="cpu"))
