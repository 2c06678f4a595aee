"""Port's config reader, ``VoteInstancesParams.from_config`` and CLI vs the
JAX package's, on the CPU.

End to end at a small size: a narrow ppp+dec model (4 feature maps, one
level, 5^3 patches, a 16-unit code) with seeded weights, written as the
port's checkpoint, over a 24^3 sub-crop of the FlyLight crop.  The port's
CLI runs ``mknet predict decode label evaluate evaluate_prediction
postprocess`` with ``--device cpu``; the JAX package's CLI then runs
``label evaluate evaluate_prediction postprocess`` on a copy of the port's
prediction store (zlib chunks, which the JAX package's tensorstore reader
reads).  The instance maps and their attributes in both packages'
``<sample>.hdf`` results, metric dicts, summary CSVs, oracle IoU volumes
and skeleton NRRDs must be equal.

The seeded weights are shifted so that an untrained model gives a
usable foreground (numinst head scaled and its classes 1 / 2 swapped, the
decoder's last biases raised): the point is the same arithmetic in both
packages, not a segmentation.
"""

import dataclasses
import glob
import json
import os
import shutil
import textwrap

import h5py
import jax
import numpy as np
import pytest
import torch

from patchperpix_tpu import cli as jcli
from patchperpix_tpu import config as jconfig
from patchperpix_tpu.assembly import VoteInstancesParams as JParams
from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.utils import io as jio
from patchperpix_tpu_torch import cli, config
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.assembly import VoteInstancesParams
from patchperpix_tpu_torch.utils import io as tio

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = os.path.join(REPO, "data", "JRC_SS05008-20160318_24_B2_crop.zarr")
CONFIGS = ["flylight_crop_dec.toml", "bbbc010.toml"]
S = 24
STEP = 3
SAMPLE = "crop24"
MODEL_KW = dict(patchshape=(5, 5, 5), num_channels=3, num_fmaps=4,
                fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                downsample_factors=((2, 2, 2),), train_code=True,
                code_units=16, ae_code_fmaps=2, ae_num_fmaps=(4, 8),
                num_code_samples=8, overlapping_inst=True, max_num_inst=2,
                padding="same")


# -- config and from_config --------------------------------------------------

@pytest.mark.parametrize("name", CONFIGS)
def test_config_loads_equal(name, tmp_path):
    path = os.path.join(REPO, "configs", name)
    got = config.load_config(path)
    assert got == jconfig.load_config(path)
    config.dump_config(got, tmp_path / "a.toml")
    jconfig.dump_config(got, tmp_path / "b.toml")
    assert (tmp_path / "a.toml").read_text() == \
        (tmp_path / "b.toml").read_text()
    assert config.load_config(tmp_path / "a.toml") == got
    assert config.get_by_path(got, "model.patchshape") == \
        jconfig.get_by_path(got, "model.patchshape")


def test_config_merges_later_files(tmp_path):
    over = tmp_path / "over.toml"
    over.write_text('[model]\ndtype = "float32"\n[data]\ntest_data = "x"\n')
    base = os.path.join(REPO, "configs", "flylight_crop_dec.toml")
    got = config.load_config(base, over)
    assert got == jconfig.load_config(base, over)
    assert got["model"]["dtype"] == "float32" and \
        got["model"]["num_fmaps"] == 20


@pytest.mark.parametrize("name", CONFIGS)
def test_from_config_equals_jax(name):
    cfg = config.load_config(os.path.join(REPO, "configs", name))
    vi = dict(cfg["vote_instances"], patchshape=cfg["model"]["patchshape"])
    got = VoteInstancesParams.from_config(vi, result_folder="r")
    want = JParams.from_config(vi, result_folder="r")
    shared = ({f.name for f in dataclasses.fields(got)}
              & {f.name for f in dataclasses.fields(want)})
    assert {"skeletonize_foreground", "remove_small_comps", "res_key",
            "result_folder", "numinst_threshs"} <= shared
    for key in sorted(shared):
        assert getattr(got, key) == getattr(want, key), key


@pytest.mark.parametrize("key,value,refusal", [
    ("vote_debug", True, None), ("save_mip", True, None),
    ("save_tif", True, None), ("sharded_devices", 2, None),
    ("engine", "numpy", "one engine")], ids=[
    "vote_debug-True-item 5", "save_mip-True-item 5",
    "save_tif-True-item 5", "sharded_devices-2-None",
    "engine-numpy-one engine"])
def test_from_config_raises_on_what_is_not_ported(key, value, refusal):
    """Every [vote_instances] key of the JAX package is accepted as given,
    as the JAX package's ``from_config`` takes it; only an engine other
    than the device engines raises (the JAX package's host engine is the
    port's CPU run)."""
    if refusal is None:
        got = VoteInstancesParams.from_config({key: value})
        assert getattr(got, key) == value == getattr(
            JParams.from_config({key: value}), key)
    else:
        with pytest.raises(NotImplementedError, match=refusal):
            VoteInstancesParams.from_config({key: value})
    VoteInstancesParams.from_config({"isbi_hack": True, "engine": "pallas",
                                     "only_bb": True, "sharded_devices": 0})


def test_isbi_config_raises():
    """The ISBI configs are accepted, with sharded_devices or the
    visualization keys set on top too, each as the JAX package reads it."""
    cfg = config.load_config(os.path.join(REPO, "configs", "isbi2012.toml"))
    assert VoteInstancesParams.from_config(cfg["vote_instances"]).isbi_hack
    assert VoteInstancesParams.from_config(
        {**cfg["vote_instances"], "sharded_devices": -1}).sharded_devices \
        == -1
    vi = {**cfg["vote_instances"], "save_mip": True, "save_tif": True,
          "vote_debug": True}
    got, want = VoteInstancesParams.from_config(vi), JParams.from_config(vi)
    assert got.save_mip and got.save_tif and got.vote_debug
    for key in ("save_mip", "save_tif", "vote_debug", "isbi_hack",
                "remove_small_comps"):
        assert getattr(got, key) == getattr(want, key), key


# -- the CLI end to end ------------------------------------------------------

def _seeded_tree():
    jm = JModel(JConfig(**MODEL_KW))
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 3, 8, 8, 8),
                                                     np.float32),
                     method=jm.full_init)
    rng = np.random.RandomState(0)
    tree = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.randn(
        *x.shape).astype(np.float32), params)["params"]
    head = tree["head_fgbg_numinst"]
    head["kernel"] = 20 * head["kernel"][..., [0, 2, 1]]
    head["bias"] = 20 * head["bias"][[0, 2, 1]]
    tree["head_code_affs"] = jax.tree.map(lambda x: 10 * x,
                                          tree["head_code_affs"])
    dec = tree["decoder"]
    dec["Upsample_1"]["Conv_0"]["bias"] = dec["Upsample_1"]["Conv_0"][
        "bias"] + 1.0
    dec["ConvPass_2"]["Conv_1"]["bias"] = dec["ConvPass_2"]["Conv_1"][
        "bias"] + 2.0
    return {"params": tree}


CONFIG = """
[data]
test_data = "{data}"
input_format = "zarr"
num_channels = 3
raw_key = "volumes/raw"
gt_key = "volumes/gt_instances"

[model]
patchshape = [5, 5, 5]
num_fmaps = 4
fmap_inc_factors = [2]
fmap_dec_factors = [1.0]
downsample_factors = [[2, 2, 2]]
train_padding = "same"
val_padding = "same"
train_input_shape_same = [16, 16, 16]
test_input_shape_same = [16, 16, 16]
overlapping_inst = true
train_code = true
code_units = 16
max_num_inst = 2
dtype = "float32"

[model.autoencoder]
code_fmaps = 2
num_fmaps = [4, 8]
num_code_samples = 8

[preprocessing]
clipmax = 1500

[prediction]
fg_thresh = 0.5
batch_size = 2

[vote_instances]
patch_threshold = 0.5
fc_threshold = 0.5
engine = "jax"
mws = true
select_patches_for_sparse_data = true
skeletonize_foreground = true
remove_small_comps = 5
numinst_threshs = [0.9, 0.1]
dilate_instances = true

[evaluation]
res_key = "vote_instances"
localization_criterion = "cldice"
assignment_strategy = "greedy"
keep_gt_shape = true
remove_small_components = 5
add_general_metrics = ["avg_gt_skel_coverage", "avg_f1_cov_score"]
summary = ["general.Num GT", "general.Num Pred",
           "confusion_matrix.avFscore", "general.avg_gt_skel_coverage",
           "general.avg_f1_cov_score"]

[evaluation.prediction]
eval_patch_prediction = true
eval_numinst_prediction = true
eval_fg_prediction = true

[postprocessing]
remove_small_comps = 20
export_skeleton_nrrds = true
"""


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    data.mkdir()
    src = tio.IoZarr(CROP)
    io = tio.IoZarr(str(data / f"{SAMPLE}.zarr"), mode="w")
    for key in ("volumes/raw", "volumes/gt_instances"):
        arr = src.read(key=key)[:, :S, :S, :S]
        io.create(key, arr.shape, arr.dtype)
        io.write(arr, key=key)
    cfg = root / "c.toml"
    cfg.write_text(textwrap.dedent(CONFIG.format(data=data)))
    exps = str(root / "exps")
    weights.write_checkpoint(_seeded_tree(),
                             os.path.join(exps, "port", "train"), STEP)
    argv = ["-c", str(cfg), "--root", exps, "--checkpoint", str(STEP)]
    port = cli.main(argv + ["-id", "port", "--device", "cpu", "-d",
                            "mknet", "predict", "decode", "label",
                            "evaluate", "evaluate_prediction",
                            "postprocess"])
    jpaths = jcli.create_folders(exps, "jax")
    shutil.copytree(os.path.join(port["test_processed"], str(STEP)),
                    os.path.join(jpaths["test_processed"], str(STEP)))
    os.remove(os.path.join(jpaths["test_processed"], str(STEP),
                           f"{SAMPLE}_pred_metrics.json"))
    jcli.main(argv + ["-id", "jax", "-d", "label", "evaluate",
                      "evaluate_prediction", "postprocess"])
    return dict(port=port, jax=jpaths, cfg=str(cfg), argv=argv)


def _stage(paths, stage):
    return os.path.join(paths[f"test_{stage}"], str(STEP))


def test_cli_maps_equal_jax(experiment):
    port = tio.IoHDF5(os.path.join(_stage(experiment["port"], "instanced"),
                                   SAMPLE + ".hdf"))
    jax_res = jio.open_volume(os.path.join(
        _stage(experiment["jax"], "instanced"), SAMPLE + ".hdf"), "r")
    for key in ("vote_instances", "vote_foreground", "vote_instances_masked",
                "vote_instances_dil_1", "vote_instances_masked_dil_1"):
        got, want = port.read(key=key), np.asarray(jax_res.read(key=key))
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
        want_attrs = dict(jax_res._f[key].attrs)
        got_attrs = port.attrs(key)
        assert set(got_attrs) == set(want_attrs), key
        for name, value in want_attrs.items():
            assert got_attrs[name].dtype == value.dtype
            np.testing.assert_array_equal(got_attrs[name], value)
    inst = port.read(key="vote_instances")
    assert len(np.unique(inst[inst > 0])) >= 3
    assert port.read(key="vote_foreground").sum() > 1000


def test_cli_metrics_and_summary_equal_jax(experiment):
    name = SAMPLE + ".json"
    got = json.load(open(os.path.join(_stage(experiment["port"],
                                             "evaluated"), name)))
    want = json.load(open(os.path.join(_stage(experiment["jax"],
                                              "evaluated"), name)))
    assert got == want and got["general"]["Num Pred"] >= 3
    assert got["general"]["avg_f1_cov_score"] > 0
    csv = [open(os.path.join(_stage(p, "evaluated"), "summary.csv")).read()
           for p in (experiment["port"], experiment["jax"])]
    assert csv[0] == csv[1] and csv[0].count("\n") == 2


def test_cli_prediction_metrics_equal_jax(experiment):
    name = SAMPLE + "_pred_metrics.json"
    got, want = (json.load(open(os.path.join(_stage(p, "processed"), name)))
                 for p in (experiment["port"], experiment["jax"]))
    assert got == want and set(got) == {"patch", "numinst", "fg"}
    a, b = (os.path.join(_stage(p, "processed"), SAMPLE + ".zarr")
            for p in (experiment["port"], experiment["jax"]))
    np.testing.assert_array_equal(tio.IoZarr(a).read(key="volumes/patch_iou"),
                                  jio.IoZarr(b).read(key="volumes/patch_iou"))


def test_cli_postprocess_equal_jax(experiment):
    port_dir = _stage(experiment["port"], "instanced")
    jax_dir = _stage(experiment["jax"], "instanced")
    got = tio.IoHDF5(os.path.join(port_dir, SAMPLE + ".hdf")).read(
        key="vote_instances_rm_20")
    want = np.asarray(jio.open_volume(os.path.join(
        jax_dir, SAMPLE + ".hdf"), "r").read(key="vote_instances_rm_20"))
    assert got.dtype == want.dtype == np.uint16
    np.testing.assert_array_equal(got, want)
    nrrds = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(port_dir, "*.nrrd")))
    assert nrrds and nrrds == sorted(
        os.path.basename(p) for p in glob.glob(os.path.join(jax_dir,
                                                            "*.nrrd")))
    for n in nrrds:
        assert open(os.path.join(port_dir, n), "rb").read() == \
            open(os.path.join(jax_dir, n), "rb").read()
    np.testing.assert_array_equal(
        tio.read_nrrd(os.path.join(port_dir, nrrds[0])),
        jio.read_nrrd(os.path.join(jax_dir, nrrds[0])))


def test_cli_skips_done_samples_and_infer_fused_writes_label_keys(
        experiment, tmp_path):
    argv = experiment["argv"] + ["-id", "port", "--device", "cpu"]
    paths = experiment["port"]
    assert cli.label(cli.get_arguments(argv), config.load_config(
        experiment["cfg"]), paths) == []
    fused = dict(paths, test_instanced=str(tmp_path))
    args = cli.get_arguments(argv)
    assert cli.infer_fused(args, config.load_config(experiment["cfg"]),
                           fused) == [SAMPLE]
    keys = [tio.IoHDF5(os.path.join(d, str(STEP), SAMPLE + ".hdf"))
            .list_keys() for d in (paths["test_instanced"], str(tmp_path))]
    # the labelled store also holds postprocess's vote_instances_rm_20
    assert keys[1] == [k for k in keys[0] if "_rm_" not in k]
    assert "vote_instances" in keys[1]


def test_label_runs_samples_on_threads(experiment):
    """num_parallel_samples = 2 over two copies of the prediction store:
    each result equals the serial run's."""
    paths = cli.create_folders(os.path.dirname(experiment["port"]["base"]),
                               "threads")
    src = os.path.join(_stage(experiment["port"], "processed"),
                       SAMPLE + ".zarr")
    for name in ("a", "b"):
        shutil.copytree(src, os.path.join(_stage(paths, "processed"),
                                          name + ".zarr"))
    cli.main(experiment["argv"] + [
        "-id", "threads", "--device", "cpu", "-d", "label",
        "--set", "vote_instances.num_parallel_samples=2"])
    want = tio.IoHDF5(os.path.join(_stage(experiment["port"], "instanced"),
                                   SAMPLE + ".hdf")).read(
                                       key="vote_instances")
    for name in ("a", "b"):
        got = tio.IoHDF5(os.path.join(_stage(paths, "instanced"),
                                      name + ".hdf")).read(
                                          key="vote_instances")
        np.testing.assert_array_equal(got, want)


# -- the two packages' experiment folders ------------------------------------

def _copy_results(src_paths, dst_paths):
    """The instanced folder of one experiment into another's."""
    shutil.copytree(_stage(src_paths, "instanced"),
                    _stage(dst_paths, "instanced"), dirs_exist_ok=True)


def test_jax_results_through_port_evaluate_postprocess_visualize(
        experiment):
    """The JAX CLI's ``<sample>.hdf`` through the port's ``evaluate``,
    ``postprocess`` and ``visualize``: the JAX package's metric dict, its
    ``vote_instances_rm_20`` and its instance PNG (pixels)."""
    exps = os.path.dirname(experiment["port"]["base"])
    paths = cli.create_folders(exps, "jax_in_port")
    _copy_results(experiment["jax"], paths)
    res = os.path.join(_stage(paths, "instanced"), SAMPLE + ".hdf")
    with h5py.File(res, "a") as f:
        del f["vote_instances_rm_20"]
    for nrrd in glob.glob(os.path.join(_stage(paths, "instanced"),
                                       "*.nrrd")):
        os.remove(nrrd)
    cli.main(experiment["argv"] + ["-id", "jax_in_port", "--device", "cpu",
                                   "-d", "evaluate", "postprocess",
                                   "visualize"])
    jcli.main(experiment["argv"] + ["-id", "jax", "-d", "visualize"])
    name = SAMPLE + ".json"
    got, want = (json.load(open(os.path.join(_stage(p, "evaluated"), name)))
                 for p in (paths, experiment["jax"]))
    assert got == want and got["general"]["Num Pred"] >= 3
    with h5py.File(os.path.join(_stage(experiment["jax"], "instanced"),
                                SAMPLE + ".hdf"), "r") as f:
        want_rm = f["vote_instances_rm_20"][()]
    got_rm = tio.IoHDF5(res).read(key="vote_instances_rm_20")
    assert got_rm.dtype == want_rm.dtype
    np.testing.assert_array_equal(got_rm, want_rm)
    png = [tio.read_png(os.path.join(_stage(p, "instanced"), SAMPLE + ".png"))
           for p in (paths, experiment["jax"])]
    assert png[0].shape[:2] == (S, S)
    np.testing.assert_array_equal(png[0], png[1])


def test_port_results_through_jax_evaluate(experiment):
    """The port's ``<sample>.hdf`` through the JAX CLI's ``evaluate``: the
    port's metric dict."""
    exps = os.path.dirname(experiment["port"]["base"])
    paths = jcli.create_folders(exps, "port_in_jax")
    _copy_results(experiment["port"], paths)
    jcli.main(experiment["argv"] + ["-id", "port_in_jax", "-d", "evaluate"])
    name = SAMPLE + ".json"
    got, want = (json.load(open(os.path.join(_stage(p, "evaluated"), name)))
                 for p in (paths, experiment["port"]))
    assert got == want and got["general"]["Num Pred"] >= 3


@pytest.mark.parametrize("kind", ["blosc_zarr", "hdf"])
def test_jax_written_predictions_through_port_label(experiment, kind):
    """The port's prediction written again by the JAX package, as its
    default blosc zarr store or as an ``.hdf`` file (which the JAX CLI's
    ``label`` also takes), labelled by the port's ``label``: the map of the
    port's own zlib store."""
    exps = os.path.dirname(experiment["port"]["base"])
    expid = "pred_" + kind
    paths = cli.create_folders(exps, expid)
    src_path = os.path.join(_stage(experiment["port"], "processed"),
                            SAMPLE + ".zarr")
    src = tio.IoZarr(src_path)
    keys = [k for k in src.list_keys() if k != "volumes/patch_iou"]
    os.makedirs(_stage(paths, "processed"))
    if kind == "hdf":
        out = jio.IoHDF5(os.path.join(_stage(paths, "processed"),
                                      SAMPLE + ".hdf"), mode="w")
    else:
        out = jio.IoZarr(os.path.join(_stage(paths, "processed"),
                                      SAMPLE + ".zarr"), mode="w")
    for key in keys:
        arr = src.read(key=key)
        if kind == "blosc_zarr":
            out.create(key, arr.shape, arr.dtype, chunks=src.meta(
                key)["chunks"])
        out.write(arr, key=key)
    out.close()
    if kind == "blosc_zarr":
        with open(os.path.join(_stage(paths, "processed"), SAMPLE + ".zarr",
                               keys[0], ".zarray")) as f:
            assert json.load(f)["compressor"]["id"] == "blosc"
    assert cli.main(experiment["argv"] + [
        "-id", expid, "--device", "cpu", "-d", "label"])
    got, want = (tio.IoHDF5(os.path.join(_stage(p, "instanced"),
                                         SAMPLE + ".hdf"))
                 .read(key="vote_instances")
                 for p in (paths, experiment["port"]))
    np.testing.assert_array_equal(got, want)


def test_hdf_inputs(experiment, tmp_path):
    """``input_format = "hdf"``: the sample written as ``.hdf`` by the JAX
    package's ``IoHDF5`` runs through the port's ``predict decode label
    evaluate`` to the results and metrics of the zarr sample."""
    data = tmp_path / "hdf_data"
    data.mkdir()
    src = tio.IoZarr(os.path.join(os.path.dirname(experiment["cfg"]),
                                  "data", SAMPLE + ".zarr"))
    out = jio.IoHDF5(str(data / (SAMPLE + ".hdf")), mode="w")
    for key in ("volumes/raw", "volumes/gt_instances"):
        out.write(src.read(key=key), key=key)
    out.close()
    exps = os.path.dirname(experiment["port"]["base"])
    weights.write_checkpoint(_seeded_tree(),
                             os.path.join(exps, "hdf_in", "train"), STEP)
    paths = cli.main(experiment["argv"] + [
        "-id", "hdf_in", "--device", "cpu", "--set",
        "data.input_format=hdf", "--set", f"data.test_data={data}",
        "-d", "predict", "decode", "label", "evaluate"])
    got, want = (tio.IoHDF5(os.path.join(_stage(p, "instanced"),
                                         SAMPLE + ".hdf"))
                 .read(key="vote_instances")
                 for p in (paths, experiment["port"]))
    np.testing.assert_array_equal(got, want)
    name = SAMPLE + ".json"
    got, want = (json.load(open(os.path.join(_stage(p, "evaluated"), name)))
                 for p in (paths, experiment["port"]))
    assert got == want


def test_checkpoint_swa_params(tmp_path):
    """write_checkpoint / load_checkpoint round trip; the CLI's model reads
    swa_params with prediction.use_swa and params without."""
    tree = _seeded_tree()
    swa = jax.tree.map(lambda x: x + 1.0, tree)
    weights.write_checkpoint(tree, str(tmp_path / "train"), 9,
                             swa_tree=swa)
    state = weights.load_checkpoint(weights.checkpoint_path(
        str(tmp_path / "train"), 9))
    assert state["step"] == 9 and set(state) == {"step", "params",
                                                 "swa_params"}
    for k, v in weights.flatten_tree(swa).items():
        np.testing.assert_array_equal(state["swa_params"][k], v)
    conf = {"model": dict(MODEL_KW, patchshape=[5, 5, 5],
                          autoencoder={"code_fmaps": 2, "num_fmaps": [4, 8],
                                       "num_code_samples": 8}),
            "data": {"num_channels": 3}}
    conf["model"]["train_padding"] = "same"
    paths = {"train": str(tmp_path / "train")}
    bias = "head_code_affs.bias"
    for use_swa, src in ((False, tree), (True, swa)):
        model, _ = cli._build_model(conf, paths, 9, "cpu", use_swa=use_swa)
        np.testing.assert_array_equal(
            model.state_dict()[bias].numpy(),
            src["params"]["head_code_affs"]["bias"])


def test_mknet_valid_padding_equals_jax(tmp_path):
    cfg = tmp_path / "v.toml"
    cfg.write_text(textwrap.dedent("""
        [data]
        num_channels = 3
        [model]
        patchshape = [7, 7, 7]
        num_fmaps = 4
        fmap_inc_factors = [2, 2]
        downsample_factors = [[2, 2, 2], [2, 2, 2]]
        train_padding = "valid"
        val_padding = "valid"
        train_input_shape_valid = [60, 60, 60]
        test_input_shape_valid = [76, 76, 76]
        """))
    out = []
    for mod, expid in ((cli, "port"), (jcli, "jax")):
        paths = mod.main(["-c", str(cfg), "--root", str(tmp_path),
                          "-id", expid, "-d", "mknet"]
                         + (["--device", "cpu"] if mod is cli else []))
        out.append([json.load(open(os.path.join(paths["base"], n)))
                    for n in ("train_net_config.json",
                              "test_net_config.json")])
    assert out[0] == out[1]
    assert out[0][1]["output_shape"] != out[0][1]["input_shape"]


# the tasks that raised before the training slice
LATER_TASKS = ["all", "cleanup", "cross_validate", "train", "validate",
               "validate_checkpoints", "visualize"]


@pytest.mark.parametrize("task", LATER_TASKS)
def test_later_tasks_raise(task, tmp_path):
    """The later slices' tasks on an experiment without checkpoints:
    validation and cross validation score none, cleanup and visualize find
    no checkpoint (as the JAX CLI's visualize does; with ``--checkpoint``
    both write nothing for an experiment without results), and
    ``--debug_args``' 10 steps under the config's 1,000-step warmup are
    refused, as optax's schedule refuses them."""
    cfg = os.path.join(REPO, "configs", "flylight_crop_dec.toml")
    argv = ["-c", cfg, "--root", str(tmp_path), "--device", "cpu",
            "-d", task]
    if task == "visualize":
        jargv = ["-c", cfg, "--root", str(tmp_path / "jax"), "-d", task]
        for main, args in ((cli.main, argv), (jcli.main, jargv)):
            with pytest.raises(RuntimeError, match="no checkpoints"):
                main(args)
            paths = main(args + ["-id", "cp", "--checkpoint", "1"])
            assert not glob.glob(os.path.join(paths["base"], "**", "*.png"),
                                 recursive=True)
    elif task.startswith("validate"):
        paths = cli.main(argv)
        with open(os.path.join(paths["base"], "results.json")) as f:
            assert json.load(f) == {"results": [], "best": None}
    elif task == "cross_validate":
        paths = cli.main(argv)
        with open(os.path.join(paths["base"], "cross_val_results.json")) as f:
            assert json.load(f) == {"mean_score": None}
        for fold in ("val", "test"):
            with open(os.path.join(paths["base"],
                                   f"results_{fold}.json")) as f:
                assert json.load(f) == {"results": [], "best": None}
    elif task == "cleanup":
        with pytest.raises(RuntimeError, match="no checkpoints"):
            cli.main(argv)
    else:
        with pytest.raises(ValueError, match="decay_steps"):
            cli.main(argv + ["--debug_args"])


def test_cli_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    cfg = os.path.join(REPO, "configs", "flylight_crop_dec.toml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-c", cfg, "-d", "mknet"])
