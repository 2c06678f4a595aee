"""The port's ISBI 2012 slice vs the JAX package, on the CPU.

``assembly/isbi_hacks.py`` function by function (bit for bit); the
rehearsal config's assembly (``configs/isbi_rehearsal.toml``: 25x25
patches, the ISBI hacks, dense-data cover, mws) on the ideal affinities
of a 128^2 crop of the stand-in test sample, maps equal up to
relabelling and rand_fscore to 1e-9; ``postprocess_fg`` /
``color_labels`` / ``crop_to_shape``; ``cross_validate`` and ``cleanup``
through both CLIs (the JAX CLI test's tiny config, the port's checkpoints
written from the JAX CLI's trained parameters, so both score the same
model); ``[evaluation] num_workers = 2`` equal to 1; the zlib copy of
data/synth_isbi equal to its blosc original, array by array.
"""

import glob
import json
import os
import shutil
import textwrap

import h5py
import numpy as np
import pytest
import torch
from PIL import Image

from patchperpix_tpu import cli as jcli
from patchperpix_tpu.assembly import isbi_hacks as jh
from patchperpix_tpu.assembly import vote_instances as jvi
from patchperpix_tpu.evaluate import evaluate_labels as jeval
from patchperpix_tpu.ops import synthetic as jsynthetic
from patchperpix_tpu.train import trainer as jtrainer
from patchperpix_tpu.utils import io as jio
from patchperpix_tpu.utils import postprocess as jpost
from patchperpix_tpu_torch import cli, config
from patchperpix_tpu_torch.assembly import isbi_hacks as th
from patchperpix_tpu_torch.assembly import vote_instances as tvi
from patchperpix_tpu_torch.evaluate import evaluate_labels as teval
from patchperpix_tpu_torch.ops import synthetic
from patchperpix_tpu_torch.utils import io as tio
from patchperpix_tpu_torch.utils import postprocess as tpost
from patchperpix_tpu_torch.weights import write_checkpoint

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REHEARSAL = os.path.join(REPO, "configs", "isbi_rehearsal.toml")
ISBI = os.path.join(REPO, "data", "synth_isbi")
ISBI_ZLIB = os.path.join(REPO, "data", "synth_isbi_zlib")
CROP = 128


# -- isbi_hacks -------------------------------------------------------------

@pytest.mark.parametrize("vol_shape,stride", [
    ((1, 64, 80), 20), ((3, 40, 44), 4), ((5, 30, 30), 7), (None, 5)])
def test_sparsify_patches_equals_jax(vol_shape, stride):
    """The fixed grid, flat axes passing (a (1, H, W) volume's z = 0)."""
    rng = np.random.RandomState(stride)
    shape = vol_shape or (6, 50, 50)
    pts = [tuple(int(v) for v in p) for p in
           np.argwhere(rng.rand(*shape) < 0.4)]
    got = th.sparsify_patches(pts, stride, vol_shape=vol_shape)
    want = jh.sparsify_patches(pts, stride, vol_shape=vol_shape)
    assert got == want and len(got) > 0
    assert th.sparsify_patches([], stride) == []


def _three_slice_stack(seed=0):
    """Three shifted 48^2 crops of a stand-in training sample's cells,
    touching (membranes filled by the nearest cell, so the filter's rings
    reach neighbours), noisy ideal 9x9 affinities."""
    from scipy import ndimage

    sl = tio.IoZarr(os.path.join(ISBI_ZLIB, "train", "isbi_train_03.zarr")
                    ).read(key="volumes/gt_instances")[0, :48, :48]
    labels = np.stack([sl, np.roll(sl, 5, axis=1), np.roll(sl, -6, axis=0)])
    idx = ndimage.distance_transform_edt(labels == 0, return_distances=False,
                                         return_indices=True)
    labels = labels[tuple(idx)]
    affs = synthetic.labels_to_affinities(labels, (1, 9, 9))
    rng = np.random.RandomState(seed)
    affs = np.clip(affs + rng.normal(0, 0.25, affs.shape), 0,
                   1).astype(np.float32)
    return affs, labels > 0


def test_keep_single_slice_and_boundary_filter_equal_jax_bit_for_bit():
    """On a three-slice stack (the reference's ISBI layout, where the 2D
    path never runs the filter): keep_single_slice, and the filter over
    every interior candidate of the kept slice and over the stride-3
    grid; the first must drop pixels."""
    affs, fg = _three_slice_stack()
    ps = np.array([1, 9, 9])
    keep_t, keep_j = th.keep_single_slice(fg), jh.keep_single_slice(fg)
    assert np.array_equal(keep_t, keep_j) and keep_t[1].all()
    assert not keep_t[0].any() and not keep_t[2].any()
    inner = np.zeros(fg.shape, bool)
    inner[:, 4:-4, 4:-4] = True
    cand = [tuple(int(v) for v in c) for c in np.argwhere(keep_t & inner)]
    for centers in (cand, th.sparsify_patches(cand, 3, fg.shape)):
        got = th.filter_instance_boundaries_from_fg(affs, fg, centers, ps,
                                                    keep_t.copy())
        want = jh.filter_instance_boundaries_from_fg(affs, fg, centers, ps,
                                                     keep_j.copy())
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.sum() <= keep_t.sum()
    full = th.filter_instance_boundaries_from_fg(affs, fg, cand, ps,
                                                 keep_t.copy())
    assert 0 < full.sum() < keep_t.sum()
    # no candidate inside the borders: the mask comes back unchanged
    assert np.array_equal(th.filter_instance_boundaries_from_fg(
        affs, fg, [(1, 0, 0)], ps, keep_t), keep_t)


def test_isbi_hack_on_a_three_slice_stack_equals_jax():
    """to_instance_seg with isbi_hack on the three-slice stack: one slice
    kept, the boundary filter on, against the JAX package's numpy path."""
    affs, fg = _three_slice_stack(1)
    kw = dict(patchshape=(1, 9, 9), isbi_hack=True, isbi_sparsify_stride=3,
              mws=True, removeIntersection=False,
              select_patches_for_sparse_data=False)
    got, _ = tvi.to_instance_seg(affs, fg, fg.copy(), fg.astype(np.uint8),
                                 tvi.VoteInstancesParams(**kw), device="cpu")
    want, _ = jvi.to_instance_seg(affs, fg, fg.copy(), fg.astype(np.uint8),
                                  jvi.VoteInstancesParams(engine="numpy",
                                                          **kw))
    assert len(np.unique(want)) > 2 and not want[0].any()
    assert np.array_equal(got, want)


# -- the rehearsal's assembly on the stand-in --------------------------------

def _rehearsal_vote_kwargs():
    cfg = config.load_config(REHEARSAL)
    return dict(cfg["vote_instances"], patchshape=cfg["model"]["patchshape"],
                overlapping_inst=cfg["model"]["overlapping_inst"])


def same_up_to_relabelling(a, b) -> bool:
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not np.array_equal(a == 0, b == 0):
        return False
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return len(np.unique(pairs[:, 0])) == len(pairs) == \
        len(np.unique(pairs[:, 1]))


def test_rehearsal_assembly_128_crop_equals_jax():
    """isbi_rehearsal.toml's [vote_instances] (from_config of both
    packages) on the ideal affinities of isbi_test_00's top-left 128^2:
    the JAX package on its device path (XLA on the CPU), the port on its
    plain versions.  Maps equal up to relabelling, every metric equal,
    rand_fscore to 1e-9."""
    gt = tio.IoZarr(os.path.join(ISBI_ZLIB, "test", "isbi_test_00.zarr")
                    ).read(key="volumes/gt_instances")[:, :CROP, :CROP]
    kw = _rehearsal_vote_kwargs()
    affs = synthetic.labels_to_affinities(gt, kw["patchshape"])
    assert np.array_equal(affs, jsynthetic.labels_to_affinities(
        gt, np.array(kw["patchshape"])))
    fg = gt > 0
    inter = {}
    got, got_fg = tvi.to_instance_seg(
        affs, fg, fg.copy(), fg.astype(np.uint8),
        tvi.VoteInstancesParams.from_config(kw), device="cpu",
        intermediates=inter)
    want, want_fg = jvi.to_instance_seg(
        affs, fg, fg.copy(), fg.astype(np.uint8),
        jvi.VoteInstancesParams.from_config(kw))
    # the ISBI grid: every candidate at coordinates = 1 (mod 20)
    assert len(inter["ranked_centers"]) > 0
    assert np.all(inter["ranked_centers"][:, 1:] % 20 == 1)
    assert np.array_equal(got_fg, want_fg)
    assert len(np.unique(want)) > 2
    assert same_up_to_relabelling(got, want)
    ev = config.load_config(REHEARSAL)["evaluation"]
    ekw = dict(localization_criterion=ev["localization_criterion"],
               assignment_strategy=ev["assignment_strategy"],
               add_general_metrics=ev["add_general_metrics"])
    got_m = teval(np.where(fg, got, 0), gt, **ekw)
    want_m = jeval(np.where(fg, want, 0), gt, **ekw)
    assert abs(got_m["general"]["rand_fscore"]
               - want_m["general"]["rand_fscore"]) <= 1e-9
    assert got_m == want_m


@pytest.mark.parametrize("name", ["isbi2012.toml", "isbi_rehearsal.toml"])
def test_isbi_configs_equal_jax_from_config(name):
    cfg = config.load_config(os.path.join(REPO, "configs", name))
    vi = dict(cfg["vote_instances"], patchshape=cfg["model"]["patchshape"])
    got = tvi.VoteInstancesParams.from_config(vi)
    want = jvi.VoteInstancesParams.from_config(vi)
    assert got.isbi_hack and got.isbi_sparsify_stride == 20 and got.mws
    for f in ("isbi_hack", "isbi_sparsify_stride", "patch_threshold",
              "fc_threshold", "select_patches_for_sparse_data",
              "includeSinglePatchCCS", "removeIntersection", "mws",
              "fg_thresh_vi", "patchshape"):
        assert getattr(got, f) == getattr(want, f), f


# -- postprocess ------------------------------------------------------------

@pytest.mark.parametrize("min_size,dist", [(0, None), (6, None), (6, 3.0)])
def test_postprocess_fg_equals_jax(min_size, dist):
    fg = np.random.RandomState(2).rand(2, 30, 34) > 0.6
    got = tpost.postprocess_fg(fg, min_size, dist)
    want = jpost.postprocess_fg(fg, min_size, dist)
    assert got.dtype == want.dtype == np.uint16
    assert np.array_equal(got, want) and got.max() > 0


def test_color_labels_and_crop_to_shape_equal_jax():
    labels = np.random.RandomState(3).randint(0, 9, (2, 20, 24))
    assert np.array_equal(tpost.color_labels(labels, seed=4),
                          jpost.color_labels(labels, seed=4))
    assert tpost.color_labels(labels)[labels == 0].max() == 0
    for shape in ((10, 12), (1, 19, 13), (20, 24)):
        assert np.array_equal(tpost.crop_to_shape(labels, shape),
                              jpost.crop_to_shape(labels, shape))


# -- the zlib copy of the stand-in data --------------------------------------

def test_zlib_copy_equals_blosc_original():
    """Every array of data/synth_isbi, read by the JAX package's
    tensorstore reader, equals the port's read of the zlib copy (same
    keys, shapes, types and chunks; zlib chunks only)."""
    srcs = sorted(glob.glob(os.path.join(ISBI, "*", "*.zarr")))
    assert len(srcs) == 10
    for src in srcs:
        dst = os.path.join(ISBI_ZLIB, os.path.relpath(src, ISBI))
        jin, tin = jio.IoZarr(src, mode="r"), tio.IoZarr(dst)
        for key in ("volumes/raw", "volumes/gt_instances"):
            want = np.asarray(jin.read(key=key))
            got = tin.read(key=key)
            assert got.dtype == want.dtype and np.array_equal(got, want)
            with open(os.path.join(dst, key, ".zarray")) as f:
                meta = json.load(f)
            with open(os.path.join(src, key, ".zarray")) as f:
                assert meta["chunks"] == json.load(f)["chunks"]
            assert meta["compressor"]["id"] == "zlib"
        jin.close()


# -- cross_validate, cleanup, parallel evaluation through both CLIs ---------

def _write_sample(path, seed):
    """The JAX CLI test's toy sample (tests/test_cli.py)."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, 48, 48), dtype=np.uint8)
    y1, x1 = rng.randint(6, 12, 2)
    y2, x2 = rng.randint(26, 32, 2)
    labels[0, y1:y1 + 10, x1:x1 + 10] = 1
    labels[1, y2:y2 + 10, x2:x2 + 10] = 2
    raw = (labels.sum(0) > 0).astype(np.float32)[None]
    raw = np.clip(raw + 0.05 * rng.randn(1, 48, 48), 0, 1)
    io = tio.IoZarr(str(path), mode="w")
    io.create("volumes/raw", raw.shape, np.float32)
    io.write(raw.astype(np.float32), key="volumes/raw")
    io.create("volumes/gt_instances", labels.shape, np.uint8)
    io.write(labels, key="volumes/gt_instances")
    io.close()


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The JAX CLI test's config and data (tests/test_cli.py), trained by
    the JAX CLI (checkpoints 15 and 30); the port's checkpoints are the
    same parameters."""
    root = tmp_path_factory.mktemp("isbi_cli")
    for split in ("train", "val", "test"):
        (root / split).mkdir()
        for i in range(2):
            _write_sample(root / split / f"sample_{split}{i}.zarr",
                          seed=len(split) * 100 + i)
    cfg = root / "test.toml"
    cfg.write_text(textwrap.dedent(f"""
        [data]
        train_data = "{root}/train"
        val_data = "{root}/val"
        test_data = "{root}/test"
        num_channels = 1
        [model]
        patchshape = [1, 5, 5]
        num_fmaps = 8
        fmap_inc_factors = [2]
        fmap_dec_factors = [1.0]
        downsample_factors = [[1, 2, 2]]
        train_padding = "same"
        val_padding = "same"
        train_input_shape_same = [32, 32]
        test_input_shape_same = [48, 48]
        overlapping_inst = false
        train_code = false
        dtype = "float32"
        [training]
        max_iterations = 30
        checkpoints = 15
        batch_size = 4
        cache_size = 4
        [training.sampling]
        probability_fg = 0.9
        probability_overlap = 0.0
        probability_random = 0.1
        [optimizer.optimizer]
        optimizer = "Adam"
        lr = 0.003
        [prediction]
        fg_thresh = 0.5
        batch_size = 2
        [vote_instances]
        patch_threshold = 0.5
        fc_threshold = 0.5
        select_patches_for_sparse_data = true
        mws = true
        [evaluation]
        res_key = "vote_instances"
        metric = "confusion_matrix.avFscore"
        localization_criterion = "iou"
        assignment_strategy = "hungarian"
        summary = [ "general.Num GT", "general.Num Pred",
                    "confusion_matrix.avFscore",]
        [validation]
        params_zip = ["patch_threshold"]
        patch_threshold = [0.5]
    """))
    exps = str(root / "exps")
    toy = dict(config=str(cfg), exps=exps)
    paths = jcli.main(["--config", str(cfg), "--root", exps, "-id", "jax",
                       "-d", "mknet", "train"])
    for step in jcli.get_checkpoint_list(paths["train"]):
        state = jtrainer.load_checkpoint(
            jtrainer.checkpoint_path(paths["train"], step))
        write_checkpoint(jax_tree_to_numpy(state["params"]),
                         os.path.join(exps, "port", "train"), step)
        # both CLIs label the port's prediction stores (zlib, which the
        # JAX package reads), so they score the same float16 affinities
        for mode in ("val", "test"):
            tpaths = cli.main(_base(toy, "port") + [
                "--checkpoint", str(step), "--mode", mode, "-d", "predict",
                "--device", "cpu"])
            shutil.copytree(
                os.path.join(tpaths[f"{mode}_processed"], str(step)),
                os.path.join(paths[f"{mode}_processed"], str(step)))
    return toy


def jax_tree_to_numpy(tree):
    return {k: (jax_tree_to_numpy(v) if isinstance(v, dict)
                else np.asarray(v, np.float32)) for k, v in tree.items()}


def _base(toy, expid):
    return ["--config", toy["config"], "--root", toy["exps"], "-id", expid]


@pytest.fixture(scope="module")
def cross_runs(toy):
    """``cross_validate`` with average_over_instances through both CLIs."""
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        paths = main(_base(toy, name) + [
            "--set", "evaluation.average_over_instances=true",
            "-d", "cross_validate"] + extra)
        with open(os.path.join(paths["base"],
                               "cross_val_results.json")) as f:
            out[name] = dict(paths=paths, res=json.load(f))
    return out


def test_cross_validate_equals_jax(cross_runs):
    """tests/test_cli.py::test_cross_validate's checks on the port, and
    the port's results against the JAX CLI's on the same model: the
    folds, each fold's best (checkpoint and parameters), the applied
    scores (1e-9), the instance-weighted averages."""
    got, want = cross_runs["port"]["res"], cross_runs["jax"]["res"]
    for k in ("val_data->test_data", "test_data->val_data"):
        assert k in got, got.keys()
        assert got[k]["best"]["checkpoint"] in (15, 30)
        assert isinstance(got[k]["applied_score"], float)
        assert "applied_score_over_instances" in got[k]
        assert got[k]["best"]["checkpoint"] == want[k]["best"]["checkpoint"]
        assert got[k]["best"]["params"] == want[k]["best"]["params"]
        assert abs(got[k]["applied_score"] - want[k]["applied_score"]) \
            <= 1e-9
        assert got[k]["applied_score_over_instances"] == pytest.approx(
            want[k]["applied_score_over_instances"], abs=1e-9)
    assert got["mean_score"] == pytest.approx(want["mean_score"], abs=1e-9)
    assert got["instance_weighted"] == pytest.approx(
        want["instance_weighted"], abs=1e-9)
    for fold in ("val", "test"):
        with open(os.path.join(cross_runs["port"]["paths"]["base"],
                               f"results_{fold}.json")) as f:
            grid = json.load(f)
        assert grid["best"] is not None
        assert [r["checkpoint"] for r in grid["results"]] == [15, 30]


def test_cleanup_through_both_clis(toy, cross_runs):
    """cleanup deletes the predictions whose instances exist, in both
    CLIs alike, and keeps one whose result (``.hdf`` in both) is
    missing."""
    removed = {}
    for name, main, extra, ext in (("jax", jcli.main, [], ".hdf"),
                                   ("port", cli.main, ["--device", "cpu"],
                                    ".hdf")):
        paths = cross_runs[name]["paths"]
        cp = cross_runs[name]["res"]["val_data->test_data"]["best"][
            "checkpoint"]
        inst = os.path.join(paths["test_instanced"], str(cp))
        victim = sorted(glob.glob(os.path.join(inst, "*" + ext)))[0]
        if os.path.isdir(victim):
            shutil.rmtree(victim)
        else:
            os.remove(victim)
        keep = os.path.join(paths["test_processed"], str(cp),
                            os.path.basename(victim)[:-len(ext)] + ".zarr")
        assert os.path.isdir(keep)
        main(_base(toy, name) + ["--checkpoint", str(cp), "-d", "cleanup"]
             + extra)
        left = sorted(os.path.basename(p) for mode in ("val", "test")
                      for p in glob.glob(os.path.join(
                          paths[f"{mode}_processed"], str(cp), "*.zarr")))
        assert os.path.isdir(keep)
        removed[name] = left
    assert removed["port"] == removed["jax"] == [os.path.basename(keep)]


def test_evaluate_num_workers_2_equals_1(toy, cross_runs):
    """[evaluation] num_workers = 2 (spawned processes) gives the metric
    dicts and the summary of one worker, on the val split's two
    samples."""
    cp = cross_runs["port"]["res"]["test_data->val_data"]["best"][
        "checkpoint"]
    out = {}
    for n in (1, 2):
        paths = cli.main(_base(toy, "port") + [
            "--checkpoint", str(cp), "--mode", "val",
            "--set", f"evaluation.num_workers={n}",
            "-d", "evaluate", "--device", "cpu"])
        ev = os.path.join(paths["val_evaluated"], str(cp))
        out[n] = {p: open(os.path.join(ev, p)).read()
                  for p in sorted(os.listdir(ev))}
    assert len(out[1]) >= 3 and out[1] == out[2]


def test_only_visualize_is_refused(toy, cross_runs):
    """Nothing is refused any more: ``visualize`` with show_patches through
    both CLIs on the test split of the applied checkpoint writes the same
    PNGs bit for bit (the two CLIs' maps are equal, and the mosaics come
    from the shared prediction stores), each instance image the port's
    render of its map."""
    from patchperpix_tpu_torch.visualize.instances import render_instances

    assert not hasattr(cli, "NOT_PORTED")
    pngs = {}
    for name, main, extra, ext in (("jax", jcli.main, [], ".hdf"),
                                   ("port", cli.main, ["--device", "cpu"],
                                    ".hdf")):
        paths = cross_runs[name]["paths"]
        cp = cross_runs[name]["res"]["val_data->test_data"]["best"][
            "checkpoint"]
        main(_base(toy, name) + ["--checkpoint", str(cp), "--set",
                                 "visualize.show_patches=true",
                                 "-d", "visualize"] + extra)
        out = {}
        for folder in (paths["test_instanced"], paths["test_processed"]):
            for png in glob.glob(os.path.join(folder, str(cp), "*.png")):
                out[os.path.basename(png)] = np.asarray(Image.open(png))
        maps = {}
        for res in glob.glob(os.path.join(paths["test_instanced"], str(cp),
                                          "*" + ext)):
            if name == "jax":
                with h5py.File(res, "r") as f:
                    maps[os.path.basename(res)[:-4]] = f["vote_instances"][()]
            else:
                maps[os.path.basename(res)[:-4]] = tio.IoHDF5(res).read(
                    key="vote_instances")
        pngs[name] = (out, maps)
    (got, tmaps), (want, jmaps) = pngs["port"], pngs["jax"]
    assert sorted(got) == sorted(want) and tmaps.keys() == jmaps.keys()
    assert any(f.endswith("_patches.png") for f in got) and tmaps
    for s in tmaps:
        assert np.array_equal(tmaps[s], jmaps[s]), s
    for f in got:
        s = f[:-4]
        assert np.array_equal(got[f], want[f]), f
        if s in tmaps:
            assert np.array_equal(got[f], render_instances(tmaps[s],
                                                           device="cpu"))


def test_device_sampler_2d_equals_host_sampler():
    """The rehearsal's 2D sampler: device batches (here on the CPU)
    against the host sampler's numpy on the same decisions (raw 1e-6,
    labels equal), flips and transposes seen."""
    from parity import cases as cs
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    samples = [td.load_sample(os.path.join(
        ISBI_ZLIB, "train", f"isbi_train_0{i}.zarr"), "volumes/raw",
        "volumes/gt_instances") for i in range(2)]
    ds = DeviceSampler(samples, cs.isbi_sampler_config(td),
                       max_gt_channels=1, device="cpu")
    seen = cs.check_sampler_alignment(ds, samples, td, draws=6)
    assert seen["flip"] and seen["transpose"]


@pytest.mark.parametrize("channels", [1, 2])
def test_gt_affinities_dense_2d_equal_jax(channels):
    """The dense 25x25 targets of the ISBI branch (the training step's
    patch loss) against the JAX package's, on stand-in labels."""
    from patchperpix_tpu.ops.affinities import gt_affinities_dense as jgt
    from patchperpix_tpu_torch.ops.affinities import gt_affinities_dense

    gt = tio.IoZarr(os.path.join(ISBI_ZLIB, "train", "isbi_train_01.zarr")
                    ).read(key="volumes/gt_instances")[:, :60, :70]
    labels = np.concatenate([gt, np.roll(gt, 9, axis=2)][:channels])
    got = gt_affinities_dense(labels[None], (25, 25), device="cpu")
    want = np.asarray(jgt(labels[None], (25, 25)))
    assert got.shape == (1, 625, 36, 46) and got.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)
