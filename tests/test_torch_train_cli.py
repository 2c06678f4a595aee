"""The port's CLI training tasks vs the JAX package's CLI, on the CPU.

The JAX package's ``tests/test_cli.py`` tiny config (2D, 5x5 patches, 8
feature maps, direct affinities) on a tiny synthetic dataset written as
zlib zarr stores (which both packages read), through both CLIs:

- ``-d all`` (mknet train validate_checkpoints predict decode label
  evaluate): the same checkpoint list, the same ``results.json``
  structure, the same instanced / evaluated files, and the loss falls in
  both runs;
- ``validate_checkpoints`` with two parameter sets: the same per-set
  ``res_key``s and results;
- ``mknet train validate_checkpoints`` in the port, resumed from the
  latest checkpoint by a second ``train``;
- a config the device sampler cannot reproduce goes to the host sampler
  with a warning; ``num_devices = 2`` trains data-parallel over two CPU
  devices (``parallel/sharded.py``'s mesh hook); without ``--device cpu``
  and without a card the CLI raises.
"""

import json
import os
import textwrap

import numpy as np
import pytest
import torch

from patchperpix_tpu import cli as jcli
from patchperpix_tpu_torch import cli
from patchperpix_tpu_torch.utils import io as tio

torch.set_num_threads(1)


def _write_sample(path, seed):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, 48, 48), dtype=np.uint8)
    y1, x1 = rng.randint(6, 12, 2)
    y2, x2 = rng.randint(26, 32, 2)
    labels[0, y1:y1 + 10, x1:x1 + 10] = 1
    labels[1, y2:y2 + 10, x2:x2 + 10] = 2
    raw = (labels.sum(0) > 0).astype(np.float32)[None]
    raw = np.clip(raw + 0.05 * rng.randn(1, 48, 48), 0, 1).astype(np.float32)
    io = tio.IoZarr(str(path), mode="w")
    for key, arr in (("volumes/raw", raw), ("volumes/gt_instances", labels)):
        io.create(key, arr.shape, arr.dtype)
        io.write(arr, key=key)
    io.close()


@pytest.fixture(scope="module")
def config_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    for split in ("train", "val", "test"):
        d = root / split
        d.mkdir()
        for i in range(2):
            _write_sample(d / f"sample_{split}{i}.zarr",
                          seed={"train": 11, "val": 22, "test": 33}[split]
                          + i)
    cfg = tmp_path_factory.mktemp("cfg") / "test.toml"
    cfg.write_text(textwrap.dedent(f"""
        [general]
        logging = "INFO"

        [data]
        train_data = "{root}/train"
        val_data = "{root}/val"
        test_data = "{root}/test"
        input_format = "zarr"
        num_channels = 1
        raw_key = "volumes/raw"
        gt_key = "volumes/gt_instances"

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

        [training]
        max_iterations = 120
        checkpoints = 60
        batch_size = 4
        cache_size = 4
        snapshots = 0

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
        engine = "jax"
        select_patches_for_sparse_data = true
        mws = false

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
    return str(cfg)


@pytest.fixture(scope="module")
def runs(config_file, tmp_path_factory):
    """``-d all`` through both CLIs, then a two-set validation in each."""
    root = str(tmp_path_factory.mktemp("exps"))
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        base = ["--config", config_file, "--root", root, "-id", name]
        paths = main(base + ["-d", "all"] + extra)
        with open(os.path.join(paths["base"], "results.json")) as f:
            single = json.load(f)
        main(base + ["--set", "validation.patch_threshold=[0.5,0.7]",
                     "-d", "validate_checkpoints"] + extra)
        with open(os.path.join(paths["base"], "results.json")) as f:
            multi = json.load(f)
        out[name] = dict(paths=paths, single=single, multi=multi)
    return out


def _rows(paths):
    with open(os.path.join(paths["train"], "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_all_gives_jax_checkpoints_and_results(runs):
    j, t = runs["jax"], runs["port"]
    assert cli.get_checkpoint_list(t["paths"]["train"]) == \
        jcli.get_checkpoint_list(j["paths"]["train"]) == [60, 120]
    for key in ("single", "multi"):
        a, b = j[key], t[key]
        assert set(a) == set(b) == {"results", "best"}
        assert [sorted(r) for r in a["results"]] == \
            [sorted(r) for r in b["results"]]
        strip = lambda rs: [{k: v for k, v in r.items() if k != "score"}
                            for r in rs]
        assert strip(a["results"]) == strip(b["results"])
        assert sorted(a["best"]) == sorted(b["best"])
        assert all(np.isfinite(r["score"]) for r in b["results"])
    assert {r["res_key"] for r in t["multi"]["results"]} == \
        {"vote_instances_ps0", "vote_instances_ps1"}
    assert [r["checkpoint"] for r in t["single"]["results"]] == [60, 120]
    # the final test-split stages after validation, on the latest
    for mode in ("val", "test"):
        for stage in ("processed", "instanced", "evaluated"):
            d = os.path.join(t["paths"][f"{mode}_{stage}"], "120")
            assert os.path.isdir(d), d
    ev = os.path.join(t["paths"]["test_evaluated"], "120")
    assert sorted(p for p in os.listdir(ev) if p.endswith(".json")) == \
        ["sample_test0.json", "sample_test1.json"]
    with open(os.path.join(ev, "sample_test0.json")) as f:
        assert json.load(f)["general"]["Num GT"] == 2
    # both result keys of the two-set validation live in one file
    io = tio.IoHDF5(os.path.join(t["paths"]["val_instanced"], "120",
                                 "sample_val0.hdf"))
    assert io.read(key="vote_instances_ps0").shape == \
        io.read(key="vote_instances_ps1").shape


def test_loss_falls_in_both(runs):
    for name in ("jax", "port"):
        rows = [r for r in _rows(runs[name]["paths"]) if "loss" in r]
        assert [r["step"] for r in rows] == [1, 100]
        assert rows[-1]["loss"] < rows[0]["loss"], name
        assert sorted(rows[0]) == sorted(_rows(runs["jax"]["paths"])[0])


def test_train_resumes_and_validates(config_file, tmp_path):
    """From a seeded params-only train_net_checkpoint_0 (which validation
    scores as its own checkpoint, not as the latest), train 0 -> 4,
    validate, resume 4 -> 6."""
    from patchperpix_tpu_torch import config as tconfig
    from patchperpix_tpu_torch.models.init import init_tree
    from patchperpix_tpu_torch.weights import write_checkpoint

    root = str(tmp_path)
    mcfg = cli._model_config(tconfig.load_config(config_file))
    write_checkpoint(init_tree(mcfg, torch.Generator().manual_seed(0)),
                     os.path.join(root, "r", "train"), 0)
    base = ["--config", config_file, "--root", root, "-id", "r",
            "--device", "cpu"]
    paths = cli.main(base + ["--set", "training.max_iterations=4",
                             "--set", "training.checkpoints=2",
                             "-d", "mknet", "train", "validate_checkpoints"])
    assert cli.get_checkpoint_list(paths["train"]) == [0, 2, 4]
    with open(os.path.join(paths["base"], "results.json")) as f:
        assert [r["checkpoint"] for r in json.load(f)["results"]] == \
            [0, 2, 4]
    for cp in (0, 2, 4):
        assert os.listdir(os.path.join(paths["val_processed"], str(cp)))
    cli.main(base + ["--set", "training.max_iterations=6",
                     "--set", "training.checkpoints=2", "-d", "train"])
    assert cli.get_checkpoint_list(paths["train"]) == [0, 2, 4, 6]
    from patchperpix_tpu_torch.weights import load_checkpoint
    st = load_checkpoint(os.path.join(paths["train"],
                                      "train_net_checkpoint_6"))
    assert st["opt_state"]["count"] == 6
    with open(os.path.join(paths["base"], "run.log")) as f:
        assert "resuming from" in f.read()


def test_unsupported_config_goes_to_host_sampler(config_file, tmp_path):
    paths = cli.main([
        "--config", config_file, "--root", str(tmp_path), "-id", "e",
        "--device", "cpu", "--set", "training.device_sampler=true",
        "--set", "training.max_iterations=2",
        "--set", "training.checkpoints=2",
        "--set", "training.augmentation.elastic.jitter_sigma=[1,1]",
        "--set", "training.augmentation.elastic.control_point_spacing=[8,8]",
        "-d", "train"])
    with open(os.path.join(paths["base"], "run.log")) as f:
        log = f.read()
    assert "config needs elastic augmentation" in log
    assert "falling back to the host prefetcher" in log
    assert cli.get_checkpoint_list(paths["train"]) == [2]
    paths = cli.main([
        "--config", config_file, "--root", str(tmp_path), "-id", "d",
        "--device", "cpu", "--set", "training.device_sampler=true",
        "--set", "training.max_iterations=2",
        "--set", "training.checkpoints=2", "-d", "train"])
    with open(os.path.join(paths["base"], "run.log")) as f:
        assert "device-resident sampler" in f.read()


def test_refusals(config_file, tmp_path, monkeypatch):
    """``num_devices = 2`` is accepted (two CPU shards); a card asked for
    without one still raises.  ``visualize`` (with show_patches) runs on
    the trained checkpoint's test predictions and labels: each PNG is
    the JAX package's render of the stored arrays."""
    from patchperpix_tpu_torch.parallel import sharded

    monkeypatch.setattr(sharded, "local_devices",
                        lambda kind="cuda": [torch.device("cpu")] * 2)
    paths = cli.main(["--config", config_file, "--root", str(tmp_path),
                      "-id", "dp", "--device", "cpu",
                      "--set", "training.num_devices=2",
                      "--set", "training.max_iterations=2",
                      "--set", "training.checkpoints=2", "-d", "train"])
    assert cli.get_checkpoint_list(paths["train"]) == [2]
    with open(os.path.join(paths["train"], "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows and all(np.isfinite(r["loss"]) for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--config", config_file, "--root", str(tmp_path),
                      "-d", "all"])
    from PIL import Image

    from patchperpix_tpu.visualize.instances import render_instances
    from patchperpix_tpu.visualize.patches import patch_mosaic

    cli.main(["--config", config_file, "--root", str(tmp_path), "-id", "dp",
              "--device", "cpu", "--checkpoint", "2",
              "--set", "visualize.show_patches=true",
              "-d", "predict", "label", "visualize"])
    checked = 0
    for res in sorted(os.listdir(os.path.join(paths["test_instanced"],
                                              "2"))):
        if not res.endswith(".hdf"):
            continue
        s = res[:-4]
        inst = tio.IoHDF5(os.path.join(paths["test_instanced"], "2",
                                       res)).read(key="vote_instances")
        affs = tio.IoZarr(os.path.join(paths["test_processed"], "2",
                                       s + ".zarr")).read(
                                           key="volumes/pred_affs")
        mosaic = patch_mosaic(affs.astype(np.float32), (1, 5, 5))
        for png, want in (
                (os.path.join(paths["test_instanced"], "2", s + ".png"),
                 render_instances(inst)),
                (os.path.join(paths["test_processed"], "2",
                              s + "_patches.png"),
                 (np.clip(mosaic, 0, 1) * 255).astype(np.uint8))):
            assert np.array_equal(np.asarray(Image.open(png)), want), png
            checked += 1
    assert checked == 4
