"""The port's [vote_instances] options vs the JAX package, on the CPU.

Each option of ``to_instance_seg`` / ``do_all`` / ``finalize_and_write``
runs in both packages on the same seeded input: three worms (two
crossings) at 72x144, 7x7 patches, affinities on a dyadic grid (1/8
steps; a seeded fifth of them moved to 3/8 or 5/8), so every consensus,
rank and graph sum is exact in float32 in any order and the two packages
see the same ties.  The JAX package runs ``engine="numpy"`` (its host
golden path) with ``removeIntersection`` off (its host graph samples the
intersection with an LCG, the device forms take its expectation); the
port runs on the CPU, where the kernels' plain versions stand in.

Maps must be equal up to relabelling, and equal bit for bit (same ids)
where both packages label with the same host mutex watershed (every
case); ``sample < 1`` in particular, whose keep mask the port draws with
the JAX package's host ``RandomState(seed)`` stream.  Score volumes:
1e-6 absolute and relative (the rank's plain version against the numpy
reference; one float32 step at the +100 candidate marks is 7.6e-6).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from patchperpix_tpu.assembly import vote_instances as jvi
from patchperpix_tpu.utils import io as jio
from patchperpix_tpu_torch.assembly import vote_instances as tvi
from patchperpix_tpu.ops import np_reference as jref
from patchperpix_tpu_torch.ops import np_reference as tref
from patchperpix_tpu_torch.ops import synthetic
from patchperpix_tpu_torch.utils import io as tio

torch.set_num_threads(1)

PS = (1, 7, 7)
BASE = dict(patchshape=PS, patch_threshold=0.5, fc_threshold=0.5, mws=True,
            removeIntersection=False, select_patches_for_sparse_data=False,
            includeSinglePatchCCS=True)


def dyadic_input(seed=0):
    """(affs (P, 1, 72, 144) float32 on a 1/8 grid, fg, numinst (2 on the
    worms' crossings), labels)."""
    labels, crossing = synthetic.worm_labels(72, 144, n_worms=3, seed=4,
                                             with_crossings=True)
    affs = synthetic.labels_to_affinities(labels, np.array(PS), hi=0.875,
                                          lo=0.125)
    rng = np.random.RandomState(seed)
    moved = rng.rand(*affs.shape) < 0.2
    affs = np.where(moved, rng.choice([0.375, 0.625], affs.shape),
                    affs).astype(np.float32)
    fg = labels > 0
    numinst = fg.astype(np.uint8)
    numinst[crossing] = 2
    return affs, fg, numinst, labels


def _run_both(opts, inp=None, overlap=False):
    affs, fg, numinst, _ = inp or dyadic_input()
    kw = {**BASE, "overlapping_inst": overlap, **opts}
    want = jvi.to_instance_seg(affs, fg, fg.copy(), numinst,
                               jvi.VoteInstancesParams(engine="numpy", **kw))
    got = tvi.to_instance_seg(affs, fg, fg.copy(), numinst,
                              tvi.VoteInstancesParams(**kw), device="cpu")
    return got, want


def same_up_to_relabelling(a, b) -> bool:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not np.array_equal(a == 0, b == 0):
        return False
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return len(np.unique(pairs[:, 0])) == len(pairs) == \
        len(np.unique(pairs[:, 1]))


def _jax_selection():
    """Centers JAX's numpy path keeps after its thin cover, and its pairs
    and weights (the inputs of the injected-selection cases)."""
    affs, fg, numinst, _ = dyadic_input()
    pairs, weights = jvi.to_instance_seg(
        affs, fg, fg.copy(), numinst, jvi.VoteInstancesParams(
            engine="numpy", return_intermediates=True, **BASE))
    centers = np.unique(pairs[:, :3], axis=0)
    return [tuple(int(v) for v in c) for c in centers[::2]], pairs, weights


CASES = {
    "pad_with_ps": dict(pad_with_ps=True),
    "isbi_hack": dict(isbi_hack=True, isbi_sparsify_stride=4),
    "isbi_hack_sample": dict(isbi_hack=True, isbi_sparsify_stride=3,
                             sample=0.5, seed=5),
    "sample": dict(sample=0.6, seed=3),
    "sample_sparse": dict(sample=0.7, seed=1,
                          select_patches_for_sparse_data=True),
    "shuffle_patches": dict(shuffle_patches=True, seed=2),
    "score_threshold": dict(score_threshold=0.45),
    "overlap_neighborhood": dict(select_patches_overlap_neighborhood=True),
    "mark_close": dict(mark_close_neighboorhood=True),
    "skipThinCover": dict(skipThinCover=True),
    # every candidate is selected: on the ISBI grid, or the numpy graph
    # takes minutes
    "skipSelection": dict(skipSelection=True, isbi_hack=True,
                          isbi_sparsify_stride=3),
    "selected_patches": "selected_patches",
    "selected_patches_skipRanking": "selected_patches_skipRanking",
    "aff_graph": "aff_graph",
    "oracle": "oracle",
    "one_instance_per_channel": dict(one_instance_per_channel=True),
    "no_overlap_per_channel": dict(no_overlap_per_channel=True),
    "vi_bg_use_inv_th_only_bb": dict(vi_bg_use_less_than_th=False,
                                     vi_bg_use_inv_th=True, only_bb=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_option_equals_jax_numpy_engine(case):
    opts = CASES[case]
    if opts in ("selected_patches", "selected_patches_skipRanking"):
        centers, _, _ = _jax_selection()
        opts = dict(selected_patches=centers,
                    skipRanking=opts.endswith("skipRanking"))
    elif opts == "aff_graph":
        _, pairs, weights = _jax_selection()
        opts = dict(selected_patch_pairs=pairs, aff_graph=weights)
    elif opts == "oracle":
        _, _, _, labels = dyadic_input()
        oracle = np.where(labels == 2, 1.0, 0.25).astype(np.float32)
        opts = dict(use_score_oracle=True, oracle_scores=oracle,
                    score_threshold=0.5)
    (got, got_fg), (want, want_fg) = _run_both(
        opts, overlap=case == "overlap_neighborhood")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got_fg, want_fg)
    assert len(np.unique(want)) > 2, "the case assembles nothing"
    assert same_up_to_relabelling(got, want)
    assert np.array_equal(got, want)


def test_sample_changes_the_selection():
    """sample < 1 is not the identity: the thinned cover keeps other
    patches than the full one."""
    affs, fg, numinst, _ = dyadic_input()
    thin = []
    for kw in ({}, {"sample": 0.6, "seed": 3}):
        inter = {}
        inst, _ = tvi.to_instance_seg(
            affs, fg, fg.copy(), numinst,
            tvi.VoteInstancesParams(**BASE, **kw), device="cpu",
            intermediates=inter)
        assert inst.max() > 0
        thin.append(inter["thin_centers"])
    assert not np.array_equal(*thin)


def test_skip_consensus_raises_in_both():
    affs, fg, numinst, _ = dyadic_input()
    for mod, extra in ((jvi, {"engine": "numpy"}), (tvi, {})):
        p = mod.VoteInstancesParams(skipConsensus=True, **BASE, **extra)
        with pytest.raises(ValueError, match="skipConsensus"):
            if mod is tvi:
                mod.to_instance_seg(affs, fg, fg.copy(), numinst, p,
                                    device="cpu")
            else:
                mod.to_instance_seg(affs, fg, fg.copy(), numinst, p)


def test_pad_with_ps_refuses_blockwise():
    affs, fg, numinst, _ = dyadic_input()
    with pytest.raises(ValueError, match="pad_with_ps"):
        tvi.to_instance_seg(affs, fg, fg.copy(), numinst,
                            tvi.VoteInstancesParams(pad_with_ps=True,
                                                    blockwise=True, **BASE),
                            device="cpu")


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("crop", [True, False])
def test_finalize_and_write_equals_jax(multi, crop, tmp_path):
    """crop_to_foreground and the multi-channel output of
    finalize_and_write: the stored keys equal the JAX package's."""
    rng = np.random.RandomState(0)
    shape = (4, 1, 20, 24) if multi else (1, 20, 24)
    inst = rng.randint(0, 5, shape).astype(np.uint16)
    fg = (rng.rand(1, 20, 24) > 0.3).astype(np.uint8)
    kw = dict(crop_to_foreground=crop, remove_small_comps=3,
              dilate_instances=True, one_instance_per_channel=multi)
    os.makedirs(tmp_path / "j")
    tpath = tvi.finalize_and_write(inst.copy(), fg, tvi.VoteInstancesParams(
        **kw), "s", str(tmp_path / "t"))
    jpath = jvi.finalize_and_write(inst.copy(), fg, jvi.VoteInstancesParams(
        **kw), "s", str(tmp_path / "j"))
    tout, jout = tio.IoHDF5(tpath), jio.open_volume(jpath, mode="r")
    assert tout.list_keys() == sorted(jout._f.keys())
    for key in ("vote_instances", "vote_foreground", "vote_instances_masked",
                "vote_instances_dil_1", "vote_instances_masked_dil_1"):
        assert np.array_equal(tout.read(key=key),
                              np.asarray(jout.read(key=key))), key
    jout.close()


def _prediction_stores(tmp_path, affs, fg):
    """The same prediction in a store of each package (the port's zlib
    store, the JAX package's blosc default)."""
    paths = {}
    for name, io_mod in (("t", tio), ("j", jio)):
        path = str(tmp_path / name / "s.zarr")
        os.makedirs(os.path.dirname(path))
        io = (tio.IoZarr(path, mode="w") if name == "t"
              else jio.IoZarr(path, mode="w"))
        for key, arr in (("volumes/pred_affs", affs),
                         ("volumes/pred_fgbg",
                          fg.astype(np.float32)[None])):
            io.create(key, arr.shape, np.float32, chunks=arr.shape)
            io.write(arr, key=key)
        io.close()
        paths[name] = path
    return paths


def test_store_scores_equals_jax(tmp_path):
    affs, fg, numinst, _ = dyadic_input()
    paths = _prediction_stores(tmp_path, affs, fg)
    kw = dict(BASE, store_scores=True, pad_with_ps=True)
    tvi.to_instance_seg(affs, fg, fg.copy(), numinst, tvi.VoteInstancesParams(
        aff_file=paths["t"], **kw), device="cpu")
    jvi.to_instance_seg(affs, fg, fg.copy(), numinst, jvi.VoteInstancesParams(
        engine="numpy", aff_file=paths["j"], **kw))
    key = "volumes/0_5/scores"
    got = tio.IoZarr(paths["t"]).read(key=key)
    jio_ = jio.open_volume(paths["j"], mode="r")
    want = np.asarray(jio_.read(key=key))
    jio_.close()
    assert got.shape == want.shape == fg.shape[1:]
    assert np.array_equal(got >= 50, want >= 50)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_do_all_store_intermediates_and_oracle_equal_jax(tmp_path):
    """do_all with store_intermediates (pairs and weights saved once, the
    labelling rerun from them) and use_score_oracle (the IoU volume read
    from the prediction store), against the JAX package's do_all."""
    affs, fg, numinst, labels = dyadic_input()
    paths = _prediction_stores(tmp_path, affs, fg)
    oracle = np.where(labels == 1, 1.0, 0.5).astype(np.float32)
    for path, io_mod in ((paths["t"], tio.IoZarr), (paths["j"], jio.IoZarr)):
        io = io_mod(path, mode="r+")
        io.create("volumes/patch_iou", oracle.shape, np.float32,
                  chunks=oracle.shape)
        io.write(oracle, key="volumes/patch_iou")
        io.close()
    kw = dict(BASE, fg_key="volumes/pred_fgbg", store_intermediates=True,
              use_score_oracle=True)
    out = {}
    for name, mod, extra in (("t", tvi, {}), ("j", jvi, {"engine": "numpy"})):
        folder = str(tmp_path / name / "inst")
        p = mod.VoteInstancesParams(**kw, **extra)
        run = (lambda: mod.do_all(paths[name], p, folder, device="cpu")) \
            if mod is tvi else (lambda: mod.do_all(paths[name], p, folder))
        first = run()
        pp = np.load(os.path.join(folder, "s_selected_patch_pairs.npy"))
        ag = np.load(os.path.join(folder, "s_aff_graph.npy"))
        io = tio.open_volume(first) if mod is tvi else jio.open_volume(
            first, mode="r")
        out[name] = (np.asarray(io.read(key="vote_instances")), pp, ag)
        io.close()
        # the rerun labels from the stored graph: a changed graph shows
        np.save(os.path.join(folder, "s_aff_graph.npy"), -np.abs(ag))
        os.rename(first, first + ".old")
        again = run()
        io = tio.open_volume(again) if mod is tvi else jio.open_volume(
            again, mode="r")
        rerun = np.asarray(io.read(key="vote_instances"))
        io.close()
        assert not np.array_equal(rerun, out[name][0])
    (gi, gp, ga), (wi, wp, wa) = out["t"], out["j"]
    assert np.array_equal(gp, wp)
    np.testing.assert_allclose(ga, wa, rtol=0, atol=1e-6)
    assert len(np.unique(wi)) > 2 and np.array_equal(gi, wi)


def test_profile_dir_writes_a_trace(tmp_path):
    affs, fg, _, _ = dyadic_input()
    paths = _prediction_stores(tmp_path, affs, fg)
    p = tvi.VoteInstancesParams(**BASE, fg_key="volumes/pred_fgbg",
                                profile_dir=str(tmp_path / "prof"))
    tvi.do_all(paths["t"], p, str(tmp_path / "inst"), device="cpu")
    trace = json.load(open(tmp_path / "prof" / "s.trace.json"))
    assert trace["traceEvents"]


@pytest.mark.parametrize("multi", ["one_instance_per_channel",
                                   "no_overlap_per_channel"])
def test_components_to_instances_multichannel(multi):
    """The painter's multi-channel modes against the JAX package's, on
    seeded components with sparse patch columns (the port's form) and the
    dense stack (the JAX package's), min_pack_size small enough that
    no_overlap_per_channel opens channels."""
    rng = np.random.RandomState(1)
    ps = np.array([1, 5, 5])
    affs = (rng.rand(25, 1, 30, 34) > 0.4).astype(np.float32)
    centers = [tuple(int(v) for v in c) for c in
               np.argwhere(np.ones((1, 30, 34), bool))]
    rng.shuffle(centers)
    comps = [sorted(centers[i:i + 4]) for i in range(0, 40, 4)]
    cols = {c: affs[(slice(None),) + c] for comp in comps for c in comp}
    kw = {multi: True, "min_pack_size": 12}
    got = tref.components_to_instances(comps, cols, ps, (1, 30, 34), **kw)
    want = jref.components_to_instances(comps, affs, ps, (1, 30, 34), **kw)
    assert got.ndim == 4 and got.shape[0] > 1
    assert np.array_equal(got, want)


def test_from_config_refuses_only_what_waits():
    """Nothing waits any more: every [vote_instances] key of the JAX
    package but ``engine`` is a parameter of the port, read as the JAX
    package reads it; only a host engine raises."""
    assert not hasattr(tvi, "_NOT_PORTED")
    cfg = {"save_mip": True, "save_tif": True, "vote_debug": True,
           "sharded_devices": 2, "remove_small_comps": 5}
    got = tvi.VoteInstancesParams.from_config(cfg)
    want = jvi.VoteInstancesParams.from_config(cfg)
    for key in cfg:
        assert getattr(got, key) == getattr(want, key) == cfg[key], key
    with pytest.raises(NotImplementedError, match="one engine"):
        tvi.VoteInstancesParams.from_config({"engine": "numpy"})
    jf = {f.name for f in dataclasses.fields(jvi.VoteInstancesParams)}
    tf = {f.name for f in dataclasses.fields(tvi.VoteInstancesParams)}
    assert jf - tf == {"engine"}
