"""Port's zarr store, streaming prediction, decoding and flip TTA vs the
JAX package's, on the CPU, with small seeded models (Flax parameters
carried across by ``weights.py``) and 3^3 patches.

Tolerances: store round trips exact; float32 model outputs 1e-4 absolute
(convolution sums in another order); outputs stored as float16 1e-3
absolute (one float16 rounding step near 1 after float32 outputs that
differ by ~1e-6); the port's own staged and on-demand decodes equal bit
for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from patchperpix_tpu.infer import decode as JD
from patchperpix_tpu.infer import predict as JPr
from patchperpix_tpu.infer import tta as JT
from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.ops.synthetic import labels_to_affinities_multi
from patchperpix_tpu.utils import io as jio
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.assembly import VoteInstancesParams
from patchperpix_tpu_torch.assembly.blockwise import (
    ZarrAffReader, blockwise_vote_instances_zarr)
from patchperpix_tpu_torch.infer import decode as TD
from patchperpix_tpu_torch.infer import predict as TPr
from patchperpix_tpu_torch.infer import tta as TT
from patchperpix_tpu_torch.models import PPPConfig
from patchperpix_tpu_torch.utils import blosc as tblosc
from patchperpix_tpu_torch.utils import io as tio
from patchperpix_tpu_torch.utils.postprocess import relabel

torch.set_num_threads(1)


# -- the store --------------------------------------------------------------

RAGGED = [(slice(None), slice(3, 17), slice(0, 1), slice(5, 13)),
          (slice(1, 2), slice(None), slice(2, 9), slice(11, 12)),
          (slice(0, 3), slice(16, 17), slice(None), slice(None))]


def _volume(seed=0, shape=(3, 17, 9, 13)):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float16)


def test_port_zlib_store_read_by_jax(tmp_path):
    """Port-written zlib chunks (ragged edges, partial-chunk writes) read
    by the JAX package's tensorstore IoZarr."""
    arr = _volume()
    path = str(tmp_path / "p.zarr")
    io = tio.IoZarr(path, mode="w")
    io.create("volumes/a", arr.shape, np.float16, chunks=(3, 5, 4, 6))
    io.write(arr[:, :10], bb=(slice(None), slice(0, 10)), key="volumes/a")
    io.write(arr[:, 10:], bb=(slice(None), slice(10, 17)), key="volumes/a")
    io.write(arr[1, 4:7, 2:5, 3:11], bb=(1, slice(4, 7), slice(2, 5),
                                           slice(3, 11)), key="volumes/a")
    io.create("volumes/i", (6, 7), np.int32, chunks=(4, 4), fill_value=5)
    io.write(np.arange(6, dtype=np.int32), bb=(slice(None), 2),
             key="volumes/i")
    io.set_attrs("volumes/a", {"offset": [0, 0, 0]})
    io.close()
    meta = json.load(open(os.path.join(path, "volumes/a/.zarray")))
    assert meta["compressor"]["id"] == "zlib"
    j = jio.IoZarr(path)
    np.testing.assert_array_equal(j.read(key="volumes/a"), arr)
    for bb in RAGGED:
        np.testing.assert_array_equal(j.read(bb=bb, key="volumes/a"),
                                      arr[bb])
    want = np.full((6, 7), 5, np.int32)
    want[:, 2] = np.arange(6)
    np.testing.assert_array_equal(j.read(key="volumes/i"), want)
    assert tio.IoZarr(path).list_keys("volumes") == j.list_keys("volumes")
    assert tio.check_file(path, ["volumes/a"]) and \
        not tio.check_file(path, ["volumes/b"])


def test_jax_raw_and_blosc_stores_read_by_port(tmp_path, monkeypatch):
    """JAX-written raw chunks and the JAX package's default blosc chunks
    (zstd, bitshuffle) read by the port over ragged boxes and points equal
    the JAX package's reads; with libzstd hidden the blosc array raises,
    naming the library, and a write into it raises."""
    arr = _volume(1)
    path = str(tmp_path / "j.zarr")
    j = jio.IoZarr(path, mode="w")
    j.create("volumes/raw", arr.shape, np.float16, chunks=(3, 5, 4, 6),
             compressor=None)
    j.write(arr, key="volumes/raw")
    j.create("volumes/blosc", arr.shape, np.float16, chunks=(3, 5, 4, 6))
    j.write(arr, key="volumes/blosc")
    j.close()
    io = tio.open_volume(path)
    assert io.shape("volumes/raw") == arr.shape
    assert io.dtype("volumes/raw") == np.float16
    np.testing.assert_array_equal(io.read(key="volumes/raw"), arr)
    for bb in RAGGED:
        np.testing.assert_array_equal(io.read(bb=bb, key="volumes/raw"),
                                      arr[bb])
    np.testing.assert_array_equal(
        io.read(bb=(Ellipsis, slice(4, 5)), key="volumes/raw"),
        arr[..., 4:5])
    pts = np.array([[0, 0, 0], [16, 8, 12], [7, 3, 6], [7, 3, 7]])
    np.testing.assert_array_equal(io.read_points(pts, key="volumes/raw"),
                                  arr[(slice(None),) + tuple(pts.T)].T)
    want = jio.IoZarr(path).read(key="volumes/blosc")
    np.testing.assert_array_equal(want, arr)
    np.testing.assert_array_equal(io.read(key="volumes/blosc"), want)
    for bb in RAGGED:
        np.testing.assert_array_equal(io.read(bb=bb, key="volumes/blosc"),
                                      want[bb])
    np.testing.assert_array_equal(io.read_points(pts, key="volumes/blosc"),
                                  want[(slice(None),) + tuple(pts.T)].T)
    with pytest.raises(ValueError, match="blosc.*read-only"):
        tio.IoZarr(path, mode="r+").write(arr, key="volumes/blosc")
    monkeypatch.setattr(tblosc, "_bound", {})
    monkeypatch.setattr(tblosc, "_load_library", lambda soname: None)
    with pytest.raises(tblosc.Undecodable, match="libzstd"):
        tio.open_volume(path).read(key="volumes/blosc")
    with pytest.raises(KeyError):
        io.read(key="volumes/missing")


# -- models ------------------------------------------------------------------

def _seeded(jm, size, seed, nd=3):
    """Flax parameters of ``jm`` with every leaf perturbed (Flax zeroes
    biases), as a numpy tree."""
    params = jm.init(jax.random.PRNGKey(seed),
                     np.zeros((1, jm.cfg.num_channels) + (size,) * nd,
                              np.float32), method=jm.full_init)
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.randn(
        *x.shape).astype(np.float32), params)


CODE_KW = dict(patchshape=(3, 3, 3), num_channels=1, num_fmaps=2,
               fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
               downsample_factors=((2, 2, 2),), train_code=True,
               code_units=8, ae_code_fmaps=1, ae_num_fmaps=(2, 4),
               num_code_samples=8, overlapping_inst=True, max_num_inst=2,
               padding="same")
AFF_KW = dict(CODE_KW, train_code=False, overlapping_inst=False)


@pytest.fixture(scope="module")
def code_model():
    jm = JModel(JConfig(**CODE_KW))
    params = _seeded(jm, 8, 0)
    cfg = PPPConfig(**CODE_KW)
    return jm, params, cfg, weights.build_model(cfg, params, device="cpu")


def test_predict_volume_and_store_match_jax(code_model, tmp_path):
    """8 windows in batches of 3 (the last one padded), f16 heads."""
    jm, params, cfg, model = code_model
    raw = np.random.RandomState(2).rand(1, 20, 18, 21).astype(np.float32)
    win = (12, 12, 12)
    j1, j2 = JPr.predict_volume(jm, params, raw, jm.cfg, win, win,
                                batch_size=3)
    t1, t2 = TPr.predict_volume(model, raw, cfg, win, win, batch_size=3,
                                device="cpu")
    assert len(TPr.enumerate_shifts(np.array([24, 24, 24]), win, win)) == 8
    for t, j in ((t1, j1), (t2, j2)):
        assert t.dtype == j.dtype == np.float16 and t.shape == j.shape
        np.testing.assert_allclose(t.astype(np.float32),
                                   j.astype(np.float32), atol=1e-3)
    path = str(tmp_path / "s.zarr")
    TPr.predict_sample_to_zarr(model, raw, cfg, win, win, path,
                               batch_size=3, device="cpu")
    j = jio.IoZarr(path)
    np.testing.assert_array_equal(j.read(key="volumes/pred_code"), t1)
    np.testing.assert_array_equal(j.read(key="volumes/pred_numinst"), t2)
    meta = json.load(open(os.path.join(path, "volumes/pred_code/.zarray")))
    assert meta["chunks"] == [8, 6, 6, 6] and meta["dtype"] == "<f2"
    assert json.load(open(os.path.join(
        path, "volumes/pred_numinst/.zattrs"))) == {
            "offset": [0, 0, 0], "resolution": [1, 1, 1]}


def _code_pred(vol=(24, 20, 20), seed=0):
    """Seeded codes and two foreground blobs of numinst probabilities."""
    rng = np.random.RandomState(seed)
    code = rng.randn(8, *vol).astype(np.float32)
    v = np.asarray(vol)

    def blob(f0, f1):
        return tuple(slice(int(s * f0), int(s * f1)) for s in v)

    pbg = np.full(vol, 0.98, np.float32)
    pbg[blob(0.15, 0.45)] = 0.02
    pbg[blob(0.55, 0.9)] = 0.02
    return code, np.stack([pbg, 1 - pbg, np.zeros(vol, np.float32)])


def _write_code_store(path, code, numinst):
    io = tio.IoZarr(path, mode="w")
    for key, arr in (("volumes/pred_code", code),
                     ("volumes/pred_numinst", numinst)):
        io.create(key, arr.shape, np.float32, chunks=(arr.shape[0], 8, 8, 8))
        io.write(arr, key=key)
    io.close()


def test_decoder_and_decode_sample_match_jax(code_model, tmp_path):
    jm, params, cfg, model = code_model
    code, numinst = _code_pred()
    fg = TD.derive_fg_mask(numinst, True)
    np.testing.assert_array_equal(fg, JD.derive_fg_mask(numinst, True))
    flat = code.reshape(8, -1)[:, :300].T
    np.testing.assert_allclose(
        TD.CodeDecoder(model, cfg, 64, "cpu").decode_flat(flat),
        JD.CodeDecoder(jm, params, jm.cfg, 64).decode_flat(flat), atol=1e-4)
    for sp, mb in ((24, 0.6), (2, 4.0)):
        assert TD._slab_height((24, 20, 20), 27, 8, mb) == \
            JD._slab_height((24, 20, 20), 27, 8, mb)
    port, jax_ = str(tmp_path / "t.zarr"), str(tmp_path / "j.zarr")
    _write_code_store(port, code, numinst)
    j = jio.IoZarr(jax_, mode="w")
    for key, arr in (("volumes/pred_code", code),
                     ("volumes/pred_numinst", numinst)):
        j.create(key, arr.shape, np.float32, chunks=(arr.shape[0], 8, 8, 8),
                 compressor=None)
        j.write(arr, key=key)
    j.close()
    # a budget of 0.6 MB: three z-slabs of 8
    TD.decode_sample(model, port, cfg, batch_size=64, max_ram_mb=0.6,
                     device="cpu")
    JD.decode_sample(jm, params, jax_, jm.cfg, batch_size=64, max_ram_mb=0.6)
    got = tio.IoZarr(port).read(key="volumes/pred_affs")
    want = jio.IoZarr(jax_).read(key="volumes/pred_affs")
    meta = json.load(open(os.path.join(port, "volumes/pred_affs/.zarray")))
    assert got.dtype == np.float16 and meta["chunks"][:2] == [27, 8]
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=1e-3)
    dense = TD.decode_volume(model, code, fg, cfg, batch_size=64,
                             device="cpu")
    np.testing.assert_array_equal(got, dense.astype(np.float16))
    assert not got[:, ~fg].any() and got[:, fg].all()


def test_code_reader_matches_staged_store_and_jax(code_model, tmp_path):
    """Windows (inside and past the border), columns and a channel: the
    port's reader equals the port's staged store bit for bit, and the JAX
    reader within one f16 step."""
    jm, params, cfg, model = code_model
    code, numinst = _code_pred()
    path = str(tmp_path / "c.zarr")
    _write_code_store(path, code, numinst)
    TD.decode_sample(model, path, cfg, batch_size=64, device="cpu")
    dec = TD.CodeDecoder(model, cfg, 64, "cpu")
    cr = TD.CodeAffReader(path, dec)
    zr = ZarrAffReader(path, "volumes/pred_affs", 27, device="cpu")
    jr = JD.CodeAffReader(path, JD.CodeDecoder(jm, params, jm.cfg, 64))
    for start, stop in [((4, 4, 4), (12, 12, 12)),
                        ((-2, 14, 12), (6, 26, 24))]:
        start, stop = np.array(start), np.array(stop)
        got = cr.read_window(start, stop)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      zr.read_window(start, stop).numpy())
        np.testing.assert_allclose(got.numpy(), jr.read_window(start, stop),
                                   atol=1e-3)
    fg = TD.derive_fg_mask(numinst, True)
    coords = [tuple(int(x) for x in c) for c in np.argwhere(fg)[::50]]
    coords.append(tuple(int(x) for x in np.argwhere(~fg)[0]))
    cc, zc, jc = (r.read_columns(coords) for r in (cr, zr, jr))
    for c in coords:
        np.testing.assert_array_equal(cc[c], zc[c])
        np.testing.assert_allclose(cc[c], jc[c], atol=1e-3)
    np.testing.assert_array_equal(cr.read_channel(13), zr.read_channel(13))
    np.testing.assert_allclose(cr.read_channel(13), jr.read_channel(13),
                               atol=1e-3)
    for r in (cr, zr, jr):
        r.close()


def test_blockwise_from_codes_equals_staged(code_model, tmp_path):
    """(24, 20, 20) codes, chunksize 14: assembled straight from the codes
    equals decode-to-store then assemble, after relabel.  (The untrained
    decoder's patches are all alike, so nearly every candidate score ties
    and the map is not compared with the JAX package's, whose float32
    sums break the ties in another order; ``test_torch_blockwise.py``
    compares the two packages on ideal affinities.)"""
    _, _, cfg, model = code_model
    code, numinst = _code_pred()
    paths = [str(tmp_path / f"{n}.zarr") for n in ("codes", "staged")]
    for p in paths:
        _write_code_store(p, code, numinst)
    kw = dict(patchshape=(3, 3, 3), removeIntersection=False,
              overlapping_inst=True, numinst_key="volumes/pred_numinst",
              patch_threshold=0.45, fc_threshold=0.45, blockwise=True)
    vi = VoteInstancesParams(**kw)
    dec = TD.CodeDecoder(model, cfg, 64, "cpu")
    a, fg_a = blockwise_vote_instances_zarr(
        paths[0], vi, chunksize=(14, 14, 14),
        result_folder=str(tmp_path / "ra"), decoder=dec, device="cpu")
    TD.decode_sample(model, paths[1], cfg, batch_size=64, max_ram_mb=4.0,
                     device="cpu")
    b, fg_b = blockwise_vote_instances_zarr(
        paths[1], vi, chunksize=(14, 14, 14),
        result_folder=str(tmp_path / "rb"), decoder=dec, device="cpu")
    np.testing.assert_array_equal(fg_a, fg_b)
    np.testing.assert_array_equal(relabel(a), relabel(b))
    assert a.max() > 0


# -- flip TTA ----------------------------------------------------------------

def test_flip_perm_and_unflip_match_jax():
    for ps in ((3, 3, 3), (5, 3, 7), (9, 9)):
        for axes in TT.all_flips(len(ps)):
            np.testing.assert_array_equal(TT.flip_channel_perm(ps, axes),
                                          JT.flip_channel_perm(ps, axes))
    assert TT.all_flips(3) == JT.all_flips(3)
    with pytest.raises(ValueError, match="odd"):
        TT.flip_channel_perm((4, 3, 3), (0,))
    rng = np.random.default_rng(7)
    labels = np.zeros((2, 12, 13, 14), np.int32)
    labels[0, 2:7, 3:9, 4:11] = 1
    labels[1, 5:11, 1:6, 2:8] = 2
    labels[:, rng.random(labels.shape[1:]) < 0.2] = 0
    ps = (5, 5, 5)
    affs = labels_to_affinities_multi(labels, ps)
    for axes in TT.all_flips(3)[1:]:
        flipped = labels_to_affinities_multi(
            np.flip(labels, tuple(a + 1 for a in axes)), ps)
        np.testing.assert_array_equal(TT.unflip_affs(flipped, axes, ps), affs)
        np.testing.assert_array_equal(
            TT.unflip_affs(torch.from_numpy(flipped.copy()), axes,
                           ps).numpy(), affs)
        np.testing.assert_array_equal(
            TT.unflip_volume(torch.from_numpy(flipped.copy()), axes).numpy(),
            np.asarray(JT.unflip_volume(flipped, axes)))


def test_predict_and_decode_tta_match_jax(code_model):
    jm, params, cfg, model = code_model
    raw = np.random.RandomState(3).rand(1, 10, 9, 11).astype(np.float32)
    win = (10, 9, 11)
    flips = [(), (0,), (1, 2)]
    jh, jp = JT.predict_tta(jm, params, raw, jm.cfg, win, win, flips=flips)
    th, tp = TT.predict_tta(model, raw, cfg, win, win, flips=flips,
                            device="cpu")
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    assert [a for a, _ in th] == [a for a, _ in jh] == flips
    fg = np.asarray(jp)[0] < np.median(np.asarray(jp)[0])
    assert 0 < fg.sum() < fg.size
    want = JT.decode_tta(jm, params, jh, fg, jm.cfg, batch_size=64)
    got = TT.decode_tta(model, th, fg, cfg, batch_size=64, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_direct_affinity_tta_sums_in_the_loop():
    """A direct-affinity model's flips are summed in the loop: one
    canonical mean, equal to the JAX package's average of all flips."""
    jm = JModel(JConfig(**AFF_KW))
    params = _seeded(jm, 8, 1)
    cfg = PPPConfig(**AFF_KW)
    model = weights.build_model(cfg, params, device="cpu")
    raw = np.random.RandomState(4).rand(1, 9, 10, 8).astype(np.float32)
    win = (9, 10, 8)
    jh, jp = JT.predict_tta(jm, params, raw, jm.cfg, win, win)
    th, tp = TT.predict_tta(model, raw, cfg, win, win, device="cpu")
    assert len(jh) == 8 and len(th) == 1 and th[0][0] == ()
    np.testing.assert_allclose(
        TT.average_affs(th, (3, 3, 3)).numpy(),
        np.asarray(JT.average_affs(jh, (3, 3, 3))), atol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
