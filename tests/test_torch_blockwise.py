"""Port's blockwise assembly and 3D ``center_valid`` vs the JAX package's,
on the CPU.

The cases of ``tests/test_blockwise.py`` and ``tests/test_decode_streaming
.py`` run through both packages on the same inputs; the instance maps must
be equal after ``relabel`` (ideal affinities, or a seeded untrained
decoder whose f16-rounded patches both packages read alike).  The 3D
``center_valid`` gate: masks equal exactly, consensus 1e-4 and rank 1e-3
absolute (the JAX package's own kernel tolerances), pairs equal and graph
weights within 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from patchperpix_tpu.assembly import VoteInstancesParams as JParams
from patchperpix_tpu.assembly import blockwise as JB
from patchperpix_tpu.assembly import to_instance_seg as jax_assemble
from patchperpix_tpu.ops import consensus_jax as CJ
from patchperpix_tpu.ops import synthetic
from patchperpix_tpu.utils import io as jio
from patchperpix_tpu.utils.postprocess import relabel as jax_relabel
from patchperpix_tpu_torch.assembly import VoteInstancesParams, blockwise
from patchperpix_tpu_torch.assembly import to_instance_seg
from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
from patchperpix_tpu_torch.utils import io as tio
from patchperpix_tpu_torch.utils.postprocess import relabel

torch.set_num_threads(1)

KW = dict(patchshape=(3, 3, 3), removeIntersection=False)


def _case_3d():
    labels = np.zeros((20, 28, 28), dtype=np.int32)
    labels[4:10, 4:12, 4:12] = 1
    labels[10:16, 14:24, 14:24] = 2
    labels[4:9, 16:24, 4:10] = 3
    affs = synthetic.labels_to_affinities(labels, np.array([3, 3, 3]))
    return affs, affs[13] > 0.5


def _border_case():
    labels = np.zeros((16, 20, 20), dtype=np.int32)
    labels[0:6, 0:8, 0:8] = 1
    labels[10:16, 12:20, 12:20] = 2
    affs = synthetic.labels_to_affinities(labels, np.array([3, 3, 3]))
    return affs, affs[13] > 0.5


def _both(affs, fg, chunksize, **kw):
    """(port map, JAX map) of the in-memory blockwise assembly."""
    want, _ = JB.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), JParams(engine="jax", **KW, **kw),
        chunksize=chunksize)
    got, fg_out = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), VoteInstancesParams(**KW, **kw),
        chunksize=chunksize, device="cpu")
    assert got.dtype == np.uint16 and np.array_equal(fg_out, fg)
    return got, np.asarray(want)


def test_geometry_helpers_match_jax():
    for shape, cs in [((10, 20, 5), (8, 8, 8)), ((33, 7, 64), (16, 7, 32))]:
        np.testing.assert_array_equal(blockwise.get_offsets(shape, cs),
                                      JB.get_offsets(shape, cs))
        np.testing.assert_array_equal(
            blockwise.get_chessboard_offsets(shape, cs),
            JB.get_chessboard_offsets(shape, cs))
    for w_start, w_shape in [((1, 1, 1), (5, 5, 5)), ((-1, 3, 4), (6, 7, 8)),
                             ((2, 2, 2), (4, 4, 4))]:
        a = blockwise._global_center_valid(w_start, w_shape, (9, 10, 11),
                                           (1, 1, 1))
        b = JB._global_center_valid(w_start, w_shape, (9, 10, 11), (1, 1, 1))
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    arr = np.arange(2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    for start, stop in [((-2, 1), (3, 8)), ((1, 1), (4, 4))]:
        want = JB._crop(arr, start, stop, channel_dim=True)
        np.testing.assert_array_equal(
            blockwise._crop(arr, start, stop, channel_dim=True), want)
        np.testing.assert_array_equal(blockwise._crop(
            torch.from_numpy(arr), start, stop, channel_dim=True).numpy(),
            want)


@pytest.mark.parametrize("chunksize,mws", [((14, 14, 14), False),
                                           ((64, 64, 64), False),
                                           ((14, 14, 14), True)])
def test_blockwise_matches_jax(chunksize, mws):
    """Equal after ``relabel``; under the mutex watershed, whose cluster
    ids follow the order of near-tied edge weights (float32 sums in
    another order), the same partition."""
    affs, fg = _case_3d()
    got, want = _both(affs, fg, chunksize, mws=mws)
    assert len(np.unique(want[want > 0])) == 3
    if mws:
        pairs = np.unique(np.stack([got.ravel(), want.ravel()], 1), axis=0)
        assert len(pairs) == 4 and np.array_equal(got > 0, want > 0)
    else:
        np.testing.assert_array_equal(relabel(got), jax_relabel(want))


def test_blockwise_border_foreground_matches_jax():
    """Foreground on the volume border: ``center_valid`` gates the border
    windows in both packages."""
    affs, fg = _border_case()
    got, want = _both(affs, fg, (10, 10, 10))
    assert len(np.unique(want[want > 0])) == 2
    np.testing.assert_array_equal(relabel(got), jax_relabel(want))


def _count_skeletonize(monkeypatch):
    """Shapes of the volumes the port skeletonizes, wherever it calls."""
    from patchperpix_tpu_torch.assembly import vote_instances as TV

    shapes = []
    real = blockwise.skeletonize

    def counted(volume, *a, **kw):
        shapes.append(np.shape(volume))
        return real(volume, *a, **kw)

    monkeypatch.setattr(blockwise, "skeletonize", counted)
    monkeypatch.setattr(TV, "skeletonize", counted)
    return shapes


@pytest.mark.parametrize("store", [False, True])
def test_blockwise_skeletonize_foreground_once_per_sample(
        store, monkeypatch, tmp_path):
    """skeletonize_foreground thins the whole sample's mask once, never a
    block or a stitch window; the map equals the JAX package's."""
    affs, fg = _case_3d()
    kw = dict(KW, skeletonize_foreground=True)
    shapes = _count_skeletonize(monkeypatch)
    if store:
        path = str(tmp_path / "sample.zarr")
        _write_jax_store(path, affs)
        want, _ = JB.blockwise_vote_instances_zarr(
            path, JParams(engine="jax", **kw), chunksize=(14, 14, 14))
        got, _ = blockwise.blockwise_vote_instances_zarr(
            path, VoteInstancesParams(**kw), chunksize=(14, 14, 14),
            device="cpu")
    else:
        got, want = _both(affs, fg, (14, 14, 14),
                          skeletonize_foreground=True)
    assert shapes == [fg.shape]
    assert len(np.unique(want[want > 0])) >= 3
    np.testing.assert_array_equal(relabel(got), jax_relabel(np.asarray(want)))


def test_blockwise_tensor_input_and_parallel_blocks_equal_serial():
    affs, fg = _case_3d()
    p = VoteInstancesParams(**KW)
    serial, _ = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), p, chunksize=(14, 14, 14),
        device="cpu")
    for params, a in [
            (dataclasses.replace(p, num_parallel_blocks=4), affs),
            (dataclasses.replace(p, num_parallel_blocks=3, chessboard=True),
             affs),
            (p, torch.from_numpy(affs))]:
        got, _ = blockwise.blockwise_vote_instances(
            a, fg, fg.astype(np.uint8), params, chunksize=(14, 14, 14),
            device="cpu")
        np.testing.assert_array_equal(relabel(got), relabel(serial))


def test_blockwise_resume_empty_and_block_devices():
    affs, fg = _case_3d()
    p = VoteInstancesParams(**KW)
    cache: dict = {}
    b1, _ = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), p, chunksize=(14, 14, 14),
        block_results=cache, device="cpu")
    assert len(cache) == 4
    stats = blockwise.BlockStats()
    b2, _ = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), p, chunksize=(14, 14, 14),
        block_results=dict(cache), device="cpu", stats=stats)
    np.testing.assert_array_equal(b1, b2)
    assert stats.blocks_consensus == 0 and stats.stitch_windows > 0
    empty = np.zeros((10, 10, 10), bool)
    inst, _ = blockwise.blockwise_vote_instances(
        np.full((27, 10, 10, 10), 0.05, np.float32), empty,
        empty.astype(np.uint8), p, chunksize=(8, 8, 8), device="cpu")
    assert inst.shape == (10, 10, 10) and inst.sum() == 0
    # blocks over two devices (two CPU devices through the mesh hook):
    # the same map as one device
    from patchperpix_tpu_torch.parallel import sharded

    mp = pytest.MonkeyPatch()
    mp.setattr(sharded, "local_devices",
               lambda kind="cuda": [torch.device("cpu")] * 2)
    try:
        b3, _ = blockwise.blockwise_vote_instances(
            affs, fg, fg.astype(np.uint8),
            dataclasses.replace(p, block_devices=2), chunksize=(14,) * 3,
            device="cpu")
    finally:
        mp.undo()
    np.testing.assert_array_equal(b3, b1)


def _write_jax_store(path, affs):
    io = jio.IoZarr(path, mode="w")
    io.create("volumes/pred_affs", affs.shape, np.float16,
              chunks=(affs.shape[0], 8, 8, 8), compressor=None)
    io.write(affs.astype(np.float16), key="volumes/pred_affs")
    io.close()


def test_blockwise_zarr_out_of_core_matches_jax_and_resumes(tmp_path):
    """A JAX-written raw store read by the port: the out-of-core map
    equals the JAX package's; the per-block files resume a rerun."""
    affs, fg = _case_3d()
    path = str(tmp_path / "sample.zarr")
    _write_jax_store(path, affs)
    want, fg_want = JB.blockwise_vote_instances_zarr(
        path, JParams(engine="jax", **KW), chunksize=(14, 14, 14),
        result_folder=str(tmp_path / "jax"))
    got, fg_out = blockwise.blockwise_vote_instances_zarr(
        path, VoteInstancesParams(**KW), chunksize=(14, 14, 14),
        result_folder=str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(fg_out, fg_want)
    np.testing.assert_array_equal(fg_out, fg)
    np.testing.assert_array_equal(relabel(got), jax_relabel(np.asarray(want)))
    stores = os.listdir(tmp_path / "port")
    assert len(stores) == 1 and stores[0].startswith("sample_blocks_")
    store = tmp_path / "port" / stores[0]
    files = sorted(os.listdir(store))
    assert len(files) == 4 and all(f.endswith(".npz") for f in files)
    mtimes = {f: os.path.getmtime(store / f) for f in files}
    os.remove(store / files[0])
    again, _ = blockwise.blockwise_vote_instances_zarr(
        path, VoteInstancesParams(**KW), chunksize=(14, 14, 14),
        result_folder=str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again, got)
    assert all(os.path.getmtime(store / f) == mtimes[f] for f in files[1:])


def _gated_affs(seed, shape=(9, 10, 11), P=27):
    rng = np.random.RandomState(seed)
    a = rng.rand(P, *shape).astype(np.float32)
    return np.where(a > 0.45, 0.6 + 0.4 * a, 0.4 * a).astype(np.float32)


@pytest.mark.parametrize("overlapping", [False, True])
def test_center_valid_3d_masks_consensus_and_rank_match_jax(overlapping):
    import jax.numpy as jnp

    affs = _gated_affs(1)
    vol = affs.shape[1:]
    cv = blockwise._global_center_valid((-1, 0, 2), vol, (12, 14, 12),
                                        (1, 1, 1))
    assert cv is not None and 0 < cv.sum() < cv.size
    ov = np.zeros(vol, bool)
    ov[3:5, 2:6, 4:8] = True
    jc = CJ.ConsensusConfig(patchshape=(3, 3, 3),
                            overlapping_inst=overlapping)
    tc = C.ConsensusConfig(patchshape=(3, 3, 3),
                           overlapping_inst=overlapping)
    want = CJ._masks(jnp.asarray(affs), jc, jnp.asarray(ov),
                     jnp.asarray(cv))
    t_affs, t_ov, t_cv = (torch.from_numpy(x) for x in (affs, ov, cv))
    ops = K.consensus_operands(t_affs, tc, t_ov, t_cv)
    for g, w in zip(ops, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cons_j = CJ.consensus_array(jnp.asarray(affs), jc, overlap=jnp.asarray(
        ov), center_valid=jnp.asarray(cv))
    half = K.consensus_half(t_affs, ops, tc)
    np.testing.assert_allclose(C.embed_half(half, tc).numpy(),
                               np.asarray(cons_j), atol=1e-4)
    scores_j = CJ.rank_scores(jnp.asarray(affs), cons_j, jc,
                              overlap=jnp.asarray(ov),
                              center_valid=jnp.asarray(cv))
    scores = K.rank_scores(t_affs, half, ops, tc, t_cv)
    np.testing.assert_allclose(scores.numpy(), np.asarray(scores_j),
                               atol=1e-3)
    assert np.all(scores.numpy()[~cv] == -1.0)


def _window_params(**kw):
    base = dict(patchshape=(3, 3, 3), patch_threshold=0.5, mws=True,
                return_intermediates=True, blockwise=True)
    base.update(kw)
    return JParams(engine="jax", **base), VoteInstancesParams(**base)


def _window_case():
    """A border window of noisy affinities (no exact score ties, so both
    packages rank the candidates alike)."""
    affs, fg = _border_case()
    win = (slice(None), slice(0, 12), slice(0, 14), slice(0, 14))
    affs, fg = affs[win], fg[win[1:]]
    rng = np.random.RandomState(0)
    affs = np.clip(affs * 0.85 + 0.15 * rng.rand(*affs.shape), 0, 1
                   ).astype(np.float32)
    cv = blockwise._global_center_valid((-1, -1, -1), fg.shape,
                                        (16, 20, 20), (1, 1, 1))
    return affs, fg, cv


def test_return_intermediates_with_center_valid_match_jax():
    affs, fg, cv = _window_case()
    jp, tp = _window_params(center_valid=cv)
    ni = fg.astype(np.uint8)
    pj, wj = jax_assemble(affs, fg, fg.copy(), ni, jp)
    inter: dict = {}
    pt, wt = to_instance_seg(affs, fg, fg.copy(), ni, tp, device="cpu",
                             intermediates=inter)
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_allclose(wt, np.asarray(wj), atol=1e-4)
    assert len(pt) > 0 and inter["consensus"]
    # the gate: no candidate outside the whole volume's interior
    assert cv[tuple(inter["ranked_centers"].T)].all()
    # nothing to assemble: (None, None)
    z = np.zeros_like(fg)
    assert to_instance_seg(affs, z, z, z.astype(np.uint8), tp,
                           device="cpu") == (None, None)


def test_injected_pairs_with_skip_ranking_match_jax():
    """Stitch-window contract: the given pairs' weights from the
    consensus; neither rank nor cover runs."""
    affs, fg, cv = _window_case()
    ni = fg.astype(np.uint8)
    centers = np.argwhere(fg & cv)[::7]
    pairs = np.concatenate([centers[:-3], centers[3:]], 1).astype(np.uint32)
    jp, tp = _window_params(center_valid=cv, skipRanking=True,
                            selected_patch_pairs=pairs)
    pj, wj = jax_assemble(affs, fg, fg.copy(), ni, jp)
    n0 = K.RANK.launches
    inter: dict = {}
    pt, wt = to_instance_seg(affs, fg, fg.copy(), ni, tp, device="cpu",
                             intermediates=inter)
    assert "ranked_centers" not in inter and "cover_centers" not in inter
    assert K.RANK.launches == n0
    np.testing.assert_array_equal(pt, pairs)
    np.testing.assert_array_equal(pt, np.asarray(pj))
    np.testing.assert_allclose(wt, np.asarray(wj), atol=1e-4)
    assert np.abs(wt).max() > 0.1
    # without skipRanking the rank still runs, and the weights agree
    jp, tp = _window_params(center_valid=cv, selected_patch_pairs=pairs)
    inter = {}
    pt, wt = to_instance_seg(affs, fg, fg.copy(), ni, tp, device="cpu",
                             intermediates=inter)
    assert "ranked_centers" in inter
    np.testing.assert_allclose(wt, np.asarray(jax_assemble(
        affs, fg, fg.copy(), ni, jp)[1]), atol=1e-4)


@pytest.mark.parametrize("layout", ["channels_last_logits", "lift_2d"])
def test_zarr_reader_layouts_match_jax(tmp_path, layout):
    """The dense-store reader's conventions against the JAX package's on a
    port-written store: channels-last logits (rotated, sigmoid) and a 2D
    store lifted to (P, 1, H, W)."""
    rng = np.random.RandomState(3)
    path = str(tmp_path / "s.zarr")
    io = tio.IoZarr(path, mode="w")
    if layout == "lift_2d":
        arr = rng.rand(9, 13, 11).astype(np.float16)
        starts = [((0, -1, 2), (1, 7, 12)), ((0, 5, -2), (1, 15, 6))]
        coords = [(0, 0, 0), (0, 12, 10), (0, 4, 7)]
    else:
        arr = (rng.randn(6, 7, 5, 27) * 3).astype(np.float16)
        starts = [((-1, 2, 0), (4, 9, 5)), ((1, 0, 1), (7, 7, 4))]
        coords = [(0, 0, 0), (5, 6, 4), (3, 2, 1)]
    io.create("volumes/pred_affs", arr.shape, np.float16, chunks=(
        (9, 5, 4) if layout == "lift_2d" else (3, 4, 5, 27)))
    io.write(arr, key="volumes/pred_affs")
    io.close()
    P = 9 if layout == "lift_2d" else 27
    got = blockwise.ZarrAffReader(path, "volumes/pred_affs", P, device="cpu")
    want = JB.ZarrAffReader(path, "volumes/pred_affs", P)
    assert got.is_logits == want.is_logits == (layout != "lift_2d")
    assert tuple(got.spatial_shape) == tuple(want.spatial_shape)
    for start, stop in starts:
        np.testing.assert_allclose(
            got.read_window(np.array(start), np.array(stop)).numpy(),
            want.read_window(np.array(start), np.array(stop)), atol=1e-6)
    gc, wc = got.read_columns(coords), want.read_columns(coords)
    for c in coords:
        np.testing.assert_allclose(gc[c], wc[c], atol=1e-6)
    np.testing.assert_allclose(got.read_channel(P // 2),
                               want.read_channel(P // 2), atol=1e-6)
