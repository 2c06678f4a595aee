"""Experiment orchestrator CLI.

Counterpart of ``patchperpix_tpu/cli.py`` (reference experiments/run_ppp.py):
``mknet``, ``train``, ``validate_checkpoints`` / ``validate``, ``predict``,
``decode``, ``label``, ``infer_fused``, ``evaluate``,
``evaluate_prediction``, ``postprocess``, ``cross_validate``,
``visualize``, ``cleanup`` and ``all`` (``mknet train validate_checkpoints predict decode label
evaluate``), with the JAX CLI's
experiment folders, layered TOML config with ``--set`` overrides, the
merged config written back into the run directory, per-stage wall-time
logging and skip-if-exists resume.

What differs from the JAX CLI:

- ``--device`` (default ``cuda``) picks the device; without a card the
  CLI raises unless ``--device cpu`` is given.  Training runs there too;
  ``training.device_sampler`` only decides whether the batches are drawn
  on that device or by the host sampler.
- Checkpoints are the port's torch files ``train/train_net_checkpoint_<step>``
  (``weights.write_checkpoint``), not orbax directories.
- ``[evaluation] num_workers > 1`` evaluates samples in processes started
  with ``spawn`` (a forked child of a process that has used CUDA breaks).
- ``predict``, ``label``, ``infer_fused`` and ``evaluate`` handle the
  samples this process owns (``parallel/multihost.py``: round-robin over
  the ``torch.distributed`` world or ``PPP_PROCESS_INDEX`` /
  ``PPP_PROCESS_COUNT``); ``training.num_devices > 1`` trains
  data-parallel over that many devices of ``--device``'s kind, with the
  host sampler (``device_sampler`` falls back to it with a warning, as in
  the JAX CLI).  No git diff of the source is stored with the config.
- ``visualize`` writes the PNGs with the port's own writer (the GPU
  machine has no PIL).

Experiment folders are the JAX CLI's: prediction stores are zarr, results
``<sample>.hdf`` and training snapshots ``.hdf`` (``utils/io.py``'s
``IoHDF5``), so either package's tasks read the other's files.

Usage:
  python -m patchperpix_tpu_torch.cli -c configs/flylight_crop_dec.toml \\
      --root exps -id run1 -d all
  python -m patchperpix_tpu_torch.cli -c configs/flylight_crop_dec.toml \\
      --root exps -id run1 -d predict decode label evaluate --checkpoint 1
"""

from __future__ import annotations

import argparse
import ast
import copy
import dataclasses
import functools
import glob
import json
import logging
import multiprocessing
import os
import re
import shutil
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from datetime import datetime

import numpy as np

from . import config as cfglib
from .assembly.vote_instances import (VoteInstancesParams, do_all,
                                      finalize_and_write,
                                      numinst_from_probs, to_instance_seg)
from .models import PPPConfig, PPPModel
from .parallel.multihost import shard_samples
from .utils import io as vio
from .utils.device import resolve_device
from .weights import build_model, checkpoint_path, load_checkpoint

logger = logging.getLogger(__name__)

TASKS = ["all", "mknet", "train", "validate_checkpoints", "validate",
         "predict", "decode", "label", "infer_fused", "postprocess",
         "evaluate", "evaluate_prediction", "cross_validate", "visualize",
         "cleanup"]


def time_func(fn):
    """Per-stage wall-time logging (run_ppp.py:94-102)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.time()
        out = fn(*args, **kwargs)
        logger.info("TIME %s: %.1f s", fn.__name__, time.time() - t0)
        return out

    return wrapper


def get_arguments(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-c", "--config", action="append", default=None,
                   help="TOML config file(s), later override earlier; "
                        "optional with --run_from_exp")
    p.add_argument("-d", "--do", nargs="+", default=[], choices=TASKS)
    p.add_argument("--root", default="experiments_out")
    p.add_argument("-id", "--expid", default=None,
                   help="existing experiment id to continue")
    p.add_argument("--checkpoint", type=int, default=None)
    p.add_argument("--test-checkpoint", type=int, default=None)
    p.add_argument("--sample", default=None, help="restrict to one sample")
    p.add_argument("--mode", default="test", choices=["train", "val", "test"])
    p.add_argument("--train-data", default=None)
    p.add_argument("--val-data", default=None)
    p.add_argument("--test-data", default=None)
    p.add_argument("--debug_args", action="store_true",
                   help="clamp iterations/workers for smoke runs")
    p.add_argument("--run_from_exp", action="store_true",
                   help="reuse the stored merged config of the experiment "
                        "given by --expid")
    p.add_argument("--validate_on_train", action="store_true",
                   help="validate_checkpoints scores on the train split")
    p.add_argument("--param_set", type=int, default=None)
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   dest="overrides",
                   help="generic config override, dotted path: "
                        "--set vote_instances.patch_threshold=0.9")
    p.add_argument("--predict_single", action="store_true",
                   help="predict only the first sample (smoke runs)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tasks (cuda, cuda:N or cpu); "
                        "default cuda, which raises without a card")
    args = p.parse_args(argv)
    if not args.config and not (args.run_from_exp and args.expid):
        p.error("--config is required unless --run_from_exp with --expid")
    return args


def backup_and_copy_file(src, dst_dir):
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, os.path.basename(src))
    if os.path.exists(dst):
        ts = datetime.now().strftime("%y%m%d_%H%M%S")
        shutil.copy2(dst, dst + "_backup" + ts)
    shutil.copy2(src, dst)


def create_folders(root: str, expid: str | None) -> dict:
    """Timestamped run dir + per-stage subdirs (run_ppp.py:270-330)."""
    if expid is None:
        expid = datetime.now().strftime("%y%m%d_%H%M%S")
    base = os.path.join(root, expid)
    paths = {"base": base, "expid": expid,
             "train": os.path.join(base, "train"),
             "backups": os.path.join(base, "backups")}
    for mode in ("train", "val", "test"):
        for stage in ("processed", "instanced", "evaluated"):
            paths[f"{mode}_{stage}"] = os.path.join(base, mode, stage)
    for key, p in paths.items():
        if key != "expid":
            os.makedirs(p, exist_ok=True)
    return paths


def setup_logging(base: str, level: str = "INFO"):
    logging.basicConfig(
        level=getattr(logging, level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        handlers=[logging.StreamHandler(),
                  logging.FileHandler(os.path.join(base, "run.log"))],
        force=True)


def list_samples(data_dir: str, input_format: str = "zarr") -> list[str]:
    files = sorted(glob.glob(os.path.join(data_dir, f"*.{input_format}")))
    return [os.path.splitext(os.path.basename(f))[0] for f in files]


def get_checkpoint_list(train_folder: str) -> list[int]:
    out = []
    for p in glob.glob(os.path.join(train_folder, "train_net_checkpoint_*")):
        m = re.search(r"checkpoint_(\d+)$", p)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _resolve_checkpoint(args, config, paths) -> int:
    # --test-checkpoint pins the checkpoint for test-split stages;
    # --checkpoint applies everywhere (step 0, a seeded starting point, is
    # a checkpoint like any other)
    if getattr(args, "mode", None) == "test" \
            and getattr(args, "test_checkpoint", None) is not None:
        return args.test_checkpoint
    if args.checkpoint is not None:
        return args.checkpoint
    cps = get_checkpoint_list(paths["train"])
    if not cps:
        raise RuntimeError("no checkpoints found; run train first")
    return cps[-1]


def _model_config(config) -> PPPConfig:
    return PPPConfig.from_config({**config.get("model", {}),
                                  "num_channels":
                                  config.get("data", {}).get(
                                      "num_channels", 1)})


def _build_model(config, paths, step, device, use_swa=False):
    """(model with the checkpoint's weights on ``device``, its config)."""
    mcfg = _model_config(config)
    state = load_checkpoint(checkpoint_path(paths["train"], step))
    tree = state["params"]
    if use_swa:
        # stochastic weight averaging weights (ref predict_no_gp.py:67-72);
        # the raw params when the checkpoint predates SWA
        if "swa_params" in state:
            tree = state["swa_params"]
        else:
            logger.warning("prediction.use_swa set but checkpoint %s has "
                           "no swa_params; using raw params", step)
    return build_model(mcfg, tree, device=device), mcfg


def _test_shapes(config):
    m = config.get("model", {})
    pad = m.get("val_padding", "valid")
    if pad == "valid":
        return tuple(m.get("test_input_shape_valid", (156, 156, 156))), pad
    return tuple(m.get("test_input_shape_same", (104, 104, 104))), pad


def _train_shapes(config):
    m = config.get("model", {})
    pad = m.get("train_padding", "valid")
    if pad == "valid":
        return tuple(m.get("train_input_shape_valid", (140, 140, 140))), pad
    return tuple(m.get("train_input_shape_same", (104, 104, 104))), pad


@time_func
def mknet(args, config, paths):
    """Net input / output shapes, persisted as ``<net>_config.json``: the
    input for same padding, else a zero probe of the port's model on the
    meta device (shapes only, no compute)."""
    import torch

    mcfg = _model_config(config)
    for name, (in_sp, pad) in (("train_net", _train_shapes(config)),
                               ("test_net", _test_shapes(config))):
        if pad == "valid":
            with torch.device("meta"):
                probe = PPPModel(mcfg)
                h1, _ = probe(torch.zeros((1, mcfg.num_channels) + in_sp))
            out_sp = tuple(int(s) for s in h1.shape[2:])
        else:
            out_sp = in_sp
        with open(os.path.join(paths["base"], name + "_config.json"),
                  "w") as f:
            json.dump({"input_shape": list(in_sp),
                       "output_shape": list(out_sp)}, f)
        logger.info("%s: input %s output %s", name, in_sp, out_sp)
    return paths["base"]


def _net_config(args, config, paths, name="test_net"):
    path = os.path.join(paths["base"], name + "_config.json")
    if not os.path.exists(path):
        mknet(args, config, paths)
    with open(path) as f:
        return json.load(f)


def _data_dir_for_mode(args, config, mode):
    data = config.get("data", {})
    return {"train": args.train_data or data.get("train_data"),
            "val": args.val_data or data.get("val_data"),
            "test": args.test_data or data.get("test_data")}[mode]


def _load(config, data_dir, s, clipmax=True):
    from .train.data import load_sample

    data = config.get("data", {})
    return load_sample(
        os.path.join(data_dir, s + "." + data.get("input_format", "zarr")),
        data.get("raw_key", "volumes/raw"),
        data.get("gt_key", "volumes/gt_instances"),
        clipmax=(config.get("preprocessing", {}).get("clipmax")
                 if clipmax else None))


def _samples(args, config, data_dir):
    samples = list_samples(data_dir, config.get("data", {}).get(
        "input_format", "zarr"))
    if args.sample:
        samples = [s for s in samples if s == args.sample]
    if getattr(args, "predict_single", False):
        samples = samples[:1]
    return samples


def _vote_params(config, out_dir, param_overrides=None, label=True):
    vi_cfg = dict(config.get("vote_instances", {}))
    vi_cfg["patchshape"] = config["model"]["patchshape"]
    vi_cfg["overlapping_inst"] = config["model"].get("overlapping_inst",
                                                     False)
    if label and vi_cfg.get("overlapping_inst"):
        vi_cfg.setdefault("numinst_key", "volumes/pred_numinst")
    if param_overrides:
        vi_cfg.update(param_overrides)
    return VoteInstancesParams.from_config(vi_cfg, result_folder=out_dir)


@time_func
def train(args, config, paths):
    """Train from the config's [training] / [optimizer] sections
    (run_ppp.py train, the JAX CLI's whole config mapping) on
    ``args.device``, resuming from the latest checkpoint."""
    from .train.data import (AugmentConfig, CropSampler, Prefetcher,
                             SamplerConfig, load_sample)
    from .train.device_data import DeviceSampler, device_sampler_supported
    from .train.trainer import TrainConfig, train_until

    data = config.get("data", {})
    tr = config.get("training", {})
    num_devices = int(tr.get("num_devices", 1))
    train_dir = args.train_data or data.get("train_data")
    fmt = data.get("input_format", "zarr")
    clipmax = config.get("preprocessing", {}).get("clipmax")
    ov_folder = tr.get("sampling", {}).get("overlap_csv_folder")

    def _load_dir(d, partly=None):
        out = []
        for s in list_samples(d, fmt):
            csv = (os.path.join(ov_folder, s + ".csv")
                   if ov_folder else None)
            out.append(load_sample(
                os.path.join(d, s + "." + fmt),
                data.get("raw_key", "volumes/raw"),
                data.get("gt_key", "volumes/gt_instances"),
                clipmax=clipmax, partly=partly, overlap_csv=csv))
        return out

    samples = _load_dir(train_dir, partly=False)
    add_partly = bool(tr.get("add_partly", False))
    if add_partly:
        # partly-labeled mixing + complete oversampling (train.py:612-633)
        samples = samples * int(tr.get("oversample_complete", 1))
        partly_dir = data.get("train_data_partly") or \
            train_dir.replace("complete", "partly")
        if os.path.isdir(partly_dir) and partly_dir != train_dir:
            samples += _load_dir(partly_dir, partly=True)
        else:
            logger.warning("add_partly set but no partly data dir at %s",
                           partly_dir)

    mcfg = _model_config(config)
    nc = _net_config(args, config, paths, "train_net")
    aug = tr.get("augmentation", {})
    # SimpleAugment toggles (ref augmentation.simple, train.py:270-274)
    simple = aug.get("simple", {})
    elastic = aug.get("elastic", {})
    acfg = AugmentConfig(
        mirror=bool(simple.get("mirror", True)),
        transpose=bool(simple.get("transpose", True)),
        elastic="elastic" in aug,
        control_point_spacing=tuple(elastic.get("control_point_spacing",
                                                (20, 20, 20))),
        jitter_sigma=tuple(elastic.get("jitter_sigma", (1, 1, 1))),
        rotation_min=elastic.get("rotation_min", -45),
        rotation_max=elastic.get("rotation_max", 45),
        intensity_scale=tuple(aug.get("intensity", {}).get(
            "scale", (0.9, 1.1))),
        intensity_shift=tuple(aug.get("intensity", {}).get(
            "shift", (-0.1, 0.1))),
        probability_permute=tr.get("probability_permute", 0.0),
        probability_hue=tr.get("probability_hue", 0.0),
        hue_max_change=tr.get("hue_max_change", 0.5),
        probability_overlay=aug.get("overlay", {}).get(
            "probability_overlay", 0.0))
    sampling = tr.get("sampling", {})
    scfg = SamplerConfig(
        input_shape=tuple(nc["input_shape"]),
        output_shape=tuple(nc["output_shape"]),
        patchshape=tuple(p for p in config["model"]["patchshape"] if p > 1),
        batch_size=tr.get("batch_size", 2),
        probability_fg=sampling.get("probability_fg", 0.7),
        probability_overlap=sampling.get("probability_overlap", 0.25),
        probability_random=sampling.get("probability_random", 0.05),
        min_masked=sampling.get("min_masked", 0.0),
        point_balance_radius=sampling.get("point_balance_radius", 0.0),
        augment=acfg)
    # fixed gt channel count: the samples' own maximum; the overlay
    # augmentation concatenates a second crop's labels, so it needs double
    # headroom or the overlaid instances would be truncated
    base_gt = max(s.labels.shape[0] for s in samples)
    if acfg.probability_overlay > 0:
        base_gt *= 2
    max_gt = int(tr.get("max_gt_channels", base_gt))
    pf = None
    if tr.get("device_sampler", False):
        # where the batches are drawn; training runs on args.device
        reason = device_sampler_supported(scfg)
        if num_devices > 1:
            # the device loop is single-device; data-parallel runs keep
            # the host prefetcher (train_until raises otherwise)
            reason = reason or "num_devices > 1 (data-parallel mesh)"
        if reason is None:
            pf = DeviceSampler(samples, scfg, max_gt_channels=max_gt,
                               device=args.device)
            logger.info("training with the device-resident sampler")
        else:
            logger.warning("device_sampler requested but config needs %s; "
                           "falling back to the host prefetcher", reason)
    if pf is None:
        pf = Prefetcher(CropSampler(samples, scfg),
                        cache_size=tr.get("cache_size", 8),
                        max_gt_channels=max_gt, with_partly=add_partly)

    opt = config.get("optimizer", {}).get("optimizer", {})
    tcfg = TrainConfig(
        max_iterations=10 if args.debug_args else tr.get("max_iterations",
                                                         400002),
        checkpoints=tr.get("checkpoints", 5000),
        snapshots=tr.get("snapshots", 10000),
        val_log_step=tr.get("val_log_step", 0),
        lr=opt.get("lr", 1e-4),
        lr_schedule=opt.get("lr_schedule", ""),
        warmup_steps=opt.get("warmup_steps", 0),
        optimizer=opt.get("optimizer", "Adam"),
        output_folder=paths["train"],
        use_swa=bool(tr.get("use_swa", False)),
        swa_start=int(tr.get("swa_start", 0)),
        swa_freq=int(tr.get("swa_freq", 1)),
        use_gt_extra=tr.get("use_gt_extra", False),
        add_partly=add_partly,
        mask_bg_weight=tr.get("mask_bg_weight", 0.01))

    # interleaved validation (ref TrainValProvider train.py:338-374):
    # no-augment batches from val_data every val_log_step iterations
    val_batch_fn = val_pf = None
    if tcfg.val_log_step > 0:
        val_dir = args.val_data or data.get("val_data")
        if val_dir and os.path.isdir(val_dir):
            vcfg = dataclasses.replace(
                scfg, augment=AugmentConfig(
                    elastic=False, mirror=False, transpose=False,
                    intensity_scale=(1.0, 1.0),
                    intensity_shift=(0.0, 0.0)))
            val_pf = Prefetcher(CropSampler(_load_dir(val_dir), vcfg),
                                cache_size=2, max_gt_channels=max_gt,
                                with_partly=add_partly)
            val_batch_fn = val_pf.next
        else:
            logger.warning("val_log_step=%d but no val_data dir (%s); "
                           "interleaved validation disabled",
                           tcfg.val_log_step, val_dir)
    mesh = None
    if num_devices > 1:
        from .train.trainer import make_data_mesh

        mesh = make_data_mesh(num_devices,
                              kind=resolve_device(args.device).type)
    try:
        state = train_until(PPPModel(mcfg), mcfg, tcfg, pf,
                            val_batch_fn=val_batch_fn, device=args.device,
                            mesh=mesh)
    finally:
        pf.stop()
        if val_pf is not None:
            val_pf.stop()
    return state["step"]


@time_func
def predict(args, config, paths, mode=None, checkpoint=None):
    """Per-sample sliding-window prediction to a float16 zarr store with
    skip-if-exists (run_ppp.py:625-679)."""
    from .infer.predict import predict_sample_to_zarr

    mode = mode or args.mode
    if checkpoint is None:
        checkpoint = _resolve_checkpoint(args, config, paths)
    data_dir = _data_dir_for_mode(args, config, mode)
    out_dir = os.path.join(paths[f"{mode}_processed"], str(checkpoint))
    os.makedirs(out_dir, exist_ok=True)
    nc = _net_config(args, config, paths)
    model, mcfg = _build_model(config, paths, checkpoint, args.device,
                               use_swa=config.get("prediction", {}).get(
                                   "use_swa", False))
    key = "volumes/pred_code" if mcfg.train_code else "volumes/pred_affs"
    done = []
    for s in shard_samples(_samples(args, config, data_dir)):
        out_path = os.path.join(out_dir, s + ".zarr")
        if vio.check_file(out_path, keys=[key], remove_on_error=True):
            logger.info("skipping %s (exists)", s)
            continue
        predict_sample_to_zarr(
            model, _load(config, data_dir, s).raw, mcfg,
            nc["input_shape"], nc["output_shape"], out_path,
            batch_size=config.get("prediction", {}).get("batch_size", 1),
            device=args.device)
        done.append(s)
    return done


@time_func
def decode(args, config, paths, mode=None, checkpoint=None):
    """Codes -> dense float16 affinities in each prediction store
    (run_ppp.py:682-746)."""
    from .infer.decode import decode_sample

    mode = mode or args.mode
    if checkpoint is None:
        checkpoint = _resolve_checkpoint(args, config, paths)
    out_dir = os.path.join(paths[f"{mode}_processed"], str(checkpoint))
    if not _model_config(config).train_code:
        logger.info("direct-affinity model; decode is a no-op")
        return []
    model, mcfg = _build_model(config, paths, checkpoint, args.device)
    done = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.zarr"))):
        if vio.check_file(path, keys=["volumes/pred_affs"]):
            logger.info("skipping %s (decoded)", path)
            continue
        decode_sample(model, path, mcfg,
                      fg_thresh=config.get("prediction", {}).get(
                          "fg_thresh", 0.5),
                      batch_size=config.get("model", {}).get(
                          "decode_batch_size", 1024),
                      device=args.device)
        done.append(path)
    return done


@time_func
def label(args, config, paths, mode=None, checkpoint=None,
          param_overrides=None):
    """vote_instances per prediction store (run_ppp.py:1054-1190)."""
    mode = mode or args.mode
    if checkpoint is None:
        checkpoint = _resolve_checkpoint(args, config, paths)
    in_dir = os.path.join(paths[f"{mode}_processed"], str(checkpoint))
    out_dir = os.path.join(paths[f"{mode}_instanced"], str(checkpoint))
    os.makedirs(out_dir, exist_ok=True)
    params = _vote_params(config, out_dir, param_overrides)
    if params.blockwise and config["model"].get("train_code", False):
        # ppp+dec blockwise: code windows decode on demand inside the
        # assembly when a store has no dense pred_affs
        from .infer.decode import CodeDecoder

        model, mcfg = _build_model(config, paths, checkpoint, args.device)
        params.code_decoder = CodeDecoder(
            model, mcfg, batch_size=config.get("model", {}).get(
                "decode_batch_size", 1024), device=args.device)
    todo = []
    # zarr and hdf predictions, as the JAX CLI labels both
    pred_paths = sorted(glob.glob(os.path.join(in_dir, "*.zarr"))
                        + glob.glob(os.path.join(in_dir, "*.hdf")))
    for path in pred_paths:
        s = os.path.splitext(os.path.basename(path))[0]
        if args.sample and s != args.sample:
            continue
        out_path = os.path.join(out_dir, s + ".hdf")
        if os.path.abspath(out_path) == os.path.abspath(path):
            continue
        if vio.check_file(out_path, keys=[params.res_key],
                          remove_on_error=True):
            logger.info("skipping %s (labelled)", s)
            continue
        todo.append((s, path))
    todo = shard_samples(todo)  # multi-process fan-out (no-op alone)

    def one(item):
        return do_all(item[1], params, result_folder=out_dir,
                      device=args.device)

    # sample parallelism: host stages of one sample overlap the device
    # stages of another
    n_par = int(params.num_parallel_samples)
    if n_par > 1 and len(todo) > 1:
        with ThreadPoolExecutor(max_workers=n_par) as ex:
            list(ex.map(one, todo))
    else:
        for item in todo:
            one(item)
    return [s for s, _ in todo]


@time_func
def infer_fused(args, config, paths, mode=None, checkpoint=None,
                param_overrides=None):
    """predict -> decode -> assemble on the device per sample, with no
    store between the stages; writes the result file ``label`` writes."""
    from .infer.fused import (decode_volume_device, lift_2d,
                              predict_volume_device)

    mode = mode or args.mode
    if checkpoint is None:
        checkpoint = _resolve_checkpoint(args, config, paths)
    data_dir = _data_dir_for_mode(args, config, mode)
    out_dir = os.path.join(paths[f"{mode}_instanced"], str(checkpoint))
    os.makedirs(out_dir, exist_ok=True)
    nc = _net_config(args, config, paths)
    model, mcfg = _build_model(config, paths, checkpoint, args.device,
                               use_swa=config.get("prediction", {}).get(
                                   "use_swa", False))
    vparams = _vote_params(config, out_dir, param_overrides, label=False)
    fg_thresh = config.get("prediction", {}).get("fg_thresh", 0.5)
    done = []
    for s in shard_samples(_samples(args, config, data_dir)):
        if vio.check_file(os.path.join(out_dir, s + ".hdf"),
                          keys=[vparams.res_key], remove_on_error=True):
            logger.info("skipping %s (labelled)", s)
            continue
        h1, h2 = predict_volume_device(
            model, _load(config, data_dir, s).raw, mcfg,
            nc["input_shape"], nc["output_shape"], device=args.device)
        prob = h2.cpu().numpy()
        if mcfg.overlapping_inst:
            numinst = numinst_from_probs(prob, vparams)
            fg = numinst > 0
        else:
            fg = prob[0] > fg_thresh  # the comparison load_affinities makes
            numinst = fg.astype(np.uint8)
        affs = (decode_volume_device(model, h1, fg, mcfg, device=args.device)
                if mcfg.train_code else h1)
        del h1, h2
        affs, fg, numinst = lift_2d(affs, fg, numinst)
        inst, fg_out = to_instance_seg(affs, fg, fg.copy(), numinst,
                                       vparams, device=args.device)
        del affs
        finalize_and_write(inst, fg_out, vparams, s, out_dir)
        done.append(s)
    return done


@time_func
def evaluate(args, config, paths, mode=None, checkpoint=None,
             res_key=None) -> dict:
    """Instance metrics per result file (``<sample>.hdf``) + CSV
    summaries (run_ppp.py:1446-1536)."""
    from .evaluate import evaluate_file, summarize_metric_dict

    mode = mode or args.mode
    if checkpoint is None:
        checkpoint = _resolve_checkpoint(args, config, paths)
    inst_dir = os.path.join(paths[f"{mode}_instanced"], str(checkpoint))
    eval_dir = os.path.join(paths[f"{mode}_evaluated"], str(checkpoint))
    os.makedirs(eval_dir, exist_ok=True)
    data = config.get("data", {})
    data_dir = _data_dir_for_mode(args, config, mode)
    ev = config.get("evaluation", {})
    kwargs = dict(
        res_key=res_key or ev.get("res_key", "vote_instances"),
        gt_key=data.get("gt_key", "volumes/gt_instances"),
        localization_criterion=ev.get("localization_criterion", "iou"),
        assignment_strategy=ev.get("assignment_strategy", "hungarian"),
        remove_small_components=ev.get("remove_small_components", 0),
        keep_gt_shape=ev.get("keep_gt_shape", False),
        add_general_metrics=ev.get("add_general_metrics", ()),
        add_multi_thresh_metrics=ev.get("add_multi_thresh_metrics", ()))
    # partly-labeled split (run_ppp.py:1206-1212): with add_partly_val and
    # a partly-annotated GT variant (complete -> partly path swap), score
    # against it with partly=True
    add_partly_val = bool(data.get("add_partly_val", False))
    jobs = []
    for path in sorted(glob.glob(os.path.join(inst_dir, "*.hdf"))):
        s = os.path.splitext(os.path.basename(path))[0]
        if args.sample and s != args.sample:
            continue
        gt_file = os.path.join(data_dir,
                               s + "." + data.get("input_format", "zarr"))
        partly = ("partly" in os.path.basename(os.path.normpath(data_dir))
                  or "partly" in os.path.basename(gt_file))
        if add_partly_val and not partly:
            partly_gt = gt_file.replace("complete", "partly")
            if partly_gt != gt_file and os.path.exists(partly_gt):
                gt_file, partly = partly_gt, True
        jobs.append((s, path, gt_file, partly))
    jobs = shard_samples(jobs)  # multi-process fan-out (no-op alone)

    complete = {s: not partly for s, _p, _g, partly in jobs}
    n_workers = int(ev.get("num_workers", 1))
    if n_workers > 1 and len(jobs) > 1:
        # host numpy per sample (ref joblib, run_ppp.py:1469-1475)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=n_workers,
                                 mp_context=ctx) as ex:
            futs = {s: ex.submit(evaluate_file, p, g, partly=partly,
                                 **kwargs)
                    for s, p, g, partly in jobs}
            metric_dicts = {s: f.result() for s, f in futs.items()}
    else:
        metric_dicts = {s: evaluate_file(p, g, partly=partly, **kwargs)
                        for s, p, g, partly in jobs}
    for s, res in metric_dicts.items():
        with open(os.path.join(eval_dir, s + ".json"), "w") as f:
            json.dump(res, f, indent=2, default=float)

    # complete samples -> summary.csv, partly samples ->
    # summary_partly.csv, all -> summary_combined.csv (run_ppp.py:1488-1529)
    if metric_dicts and ev.get("summary"):
        full = {s: m for s, m in metric_dicts.items() if complete[s]}
        part = {s: m for s, m in metric_dicts.items() if not complete[s]}
        name = "summary.csv" if full or not part else "summary_partly.csv"
        summarize_metric_dict(full or part, ev["summary"],
                              os.path.join(eval_dir, name))
        if full and part:
            summarize_metric_dict(
                part, ev.get("summary_partly", ev["summary"]),
                os.path.join(eval_dir, "summary_partly.csv"))
            summarize_metric_dict(metric_dicts, ev["summary"],
                                  os.path.join(eval_dir,
                                               "summary_combined.csv"))
    return metric_dicts


@time_func
def evaluate_prediction(args, config, paths, mode=None, checkpoint=None):
    """Prediction-only metrics: numinst / fg / patch-IoU, with the oracle
    IoU volume written back into the prediction store
    (run_ppp.py:1300-1443)."""
    from .evaluate import evaluate_fg, evaluate_numinst, evaluate_patch

    mode = mode or args.mode
    if checkpoint is None:
        checkpoint = _resolve_checkpoint(args, config, paths)
    proc = os.path.join(paths[f"{mode}_processed"], str(checkpoint))
    data_dir = _data_dir_for_mode(args, config, mode)
    evp = config.get("evaluation", {}).get("prediction", {})
    pred_cfg = config.get("prediction", {})
    model_cfg = config.get("model", {})
    ps = tuple(model_cfg.get("patchshape", (7, 7, 7)))
    out = {}
    for path in sorted(glob.glob(os.path.join(proc, "*.zarr"))):
        s = os.path.splitext(os.path.basename(path))[0]
        if args.sample and s != args.sample:
            continue
        io = vio.open_volume(path, mode="r")
        sd = _load(config, data_dir, s, clipmax=False)
        res: dict = {}
        if evp.get("eval_patch_prediction"):
            affs = io.read(key=pred_cfg.get(
                "aff_key", "volumes/pred_affs")).astype(np.float32)
            patch_res = evaluate_patch(affs, sd.labels, ps,
                                       device=args.device)
            if evp.get("store_iou", True):
                # the oracle IoU volume, which use_score_oracle reads
                oth = evp.get("oracle_threshold", 0.5)
                iou = patch_res["th_" + str(round(oth, 2)).replace(
                    ".", "_")]["iou_volume"]
                wio = vio.IoZarr(path, mode="r+")
                wio.create("volumes/patch_iou", iou.shape, np.float32)
                wio.write(iou.astype(np.float32), key="volumes/patch_iou")
                wio.close()
            res["patch"] = {
                k: {kk: vv for kk, vv in v.items() if kk != "iou_volume"}
                for k, v in patch_res.items()}
        numinst_key = pred_cfg.get("numinst_key", "volumes/pred_numinst")
        if evp.get("eval_numinst_prediction") and \
                model_cfg.get("overlapping_inst"):
            ni = io.read(key=numinst_key).astype(np.float32)
            res["numinst"] = evaluate_numinst(
                ni, sd.labels, evp.get("max_numinst", 2))
        if evp.get("eval_fg_prediction"):
            try:
                fg_prob = io.read(key=pred_cfg.get(
                    "fg_key", "volumes/pred_fgbg")).astype(np.float32)[0]
            except KeyError:
                fg_prob = 1.0 - io.read(key=numinst_key).astype(
                    np.float32)[0]
            res["fg"] = evaluate_fg(fg_prob, sd.fg_mask)
        io.close()
        out[s] = res
        with open(os.path.join(proc, s + "_pred_metrics.json"), "w") as f:
            json.dump(res, f, indent=2, default=float)
    return out


@time_func
def postprocess(args, config, paths):
    """Instance cleanup + optional per-instance skeleton NRRD export
    (run_ppp.py:2230-2259, util/postprocess.py:76-119)."""
    from .utils.postprocess import postprocess_instances

    checkpoint = _resolve_checkpoint(args, config, paths)
    inst_dir = os.path.join(paths[f"{args.mode}_instanced"], str(checkpoint))
    pp = config.get("postprocessing", {})
    rm = pp.get("remove_small_comps",
                config.get("vote_instances", {}).get(
                    "remove_small_comps", 0))
    for path in sorted(glob.glob(os.path.join(inst_dir, "*.hdf"))):
        postprocess_instances(
            path, res_key=config.get("evaluation", {}).get(
                "res_key", "vote_instances"),
            remove_small_comps=rm,
            export_skeleton_nrrds=pp.get("export_skeleton_nrrds", False))
    return inst_dir


def _metric_of(metric_dicts: dict, metric_key: str) -> float:
    vals = [cfglib.get_by_path(md, metric_key) for md in
            metric_dicts.values()]
    vals = [v for v in vals if v is not None]
    return float(np.mean(vals)) if vals else float("-inf")


@time_func
def validate_checkpoints(args, config, paths, mode=None,
                         results_name="results.json"):
    """Grid search: checkpoints x parameter sets; selects the best by the
    configured metric and writes results.json (run_ppp.py:919-1051)."""
    val = config.get("validation", {})
    metric_key = config.get("evaluation", {}).get(
        "metric", "confusion_matrix.avFscore")
    checkpoints = val.get("checkpoints") or get_checkpoint_list(
        paths["train"])
    param_sets = cfglib.named_params(val) or [{}]
    if args.param_set is not None:
        param_sets = [param_sets[args.param_set]]
    # selection split: val, or train with --validate_on_train
    vmode = "train" if getattr(args, "validate_on_train", False) \
        else mode or "val"
    base_res_key = config.get("evaluation", {}).get("res_key",
                                                    "vote_instances")
    results = []
    for cp in checkpoints:
        predict(args, config, paths, mode=vmode, checkpoint=cp)
        decode(args, config, paths, mode=vmode, checkpoint=cp)
        for pi, pset in enumerate(param_sets):
            # per-parameter result keys (run_ppp.py:969-988): each set's
            # labels live under their own res_key in the same store
            res_key = (base_res_key if len(param_sets) == 1
                       else f"{base_res_key}_ps{pi}")
            label(args, config, paths, mode=vmode, checkpoint=cp,
                  param_overrides={**pset, "res_key": res_key})
            mdicts = evaluate(args, config, paths, mode=vmode,
                              checkpoint=cp, res_key=res_key)
            score = _metric_of(mdicts, metric_key)
            results.append({"checkpoint": cp, "params": pset,
                            "res_key": res_key,
                            "metric": metric_key, "score": score})
            logger.info("checkpoint %s params %s -> %s = %.5f",
                        cp, pset, metric_key, score)

    best = max(results, key=lambda r: r["score"]) if results else None
    out = {"results": results, "best": best}
    with open(os.path.join(paths["base"], results_name), "w") as f:
        json.dump(out, f, indent=2, default=float)
    return out


@time_func
def cross_validate(args, config, paths):
    """Two-fold cross validation over the configured folds
    (run_ppp.py:1674-1971): the best checkpoint and parameters selected on
    one fold are applied to the other and back; ``results_<mode>.json``
    per selection, ``cross_val_results.json`` with each fold's applied
    score, their mean and, with ``[evaluation] average_over_instances``,
    the scores accumulated over instances."""
    from .evaluate import (average_score_over_instances,
                           average_score_with_instance_counts)

    metric_key = config.get("evaluation", {}).get(
        "metric", "confusion_matrix.avFscore")
    folds = config.get("data", {}).get("cross_val_folders",
                                       ["val_data", "test_data"])
    fold_modes = {"val_data": "val", "test_data": "test"}
    over_instances = config.get("evaluation", {}).get(
        "average_over_instances", False)
    fold_counts = []
    results = {}
    for select_fold, apply_fold in (tuple(folds), tuple(reversed(folds))):
        sel_mode = fold_modes.get(select_fold, "val")
        app_mode = fold_modes.get(apply_fold, "test")
        args_sel = copy.copy(args)
        args_sel.mode = sel_mode
        r = validate_checkpoints(args_sel, config, paths, mode=sel_mode,
                                 results_name=f"results_{sel_mode}.json")
        best = r["best"]
        if best is None:
            continue
        cp = best["checkpoint"]
        predict(args, config, paths, mode=app_mode, checkpoint=cp)
        decode(args, config, paths, mode=app_mode, checkpoint=cp)
        label(args, config, paths, mode=app_mode, checkpoint=cp,
              param_overrides=best["params"])
        mdicts = evaluate(args, config, paths, mode=app_mode, checkpoint=cp)
        entry = {"best": best,
                 "applied_score": _metric_of(mdicts, metric_key)}
        if over_instances:
            avs, counts = average_score_over_instances(mdicts)
            entry["applied_score_over_instances"] = avs
            fold_counts.append(counts)
        results[f"{select_fold}->{apply_fold}"] = entry
    scores = [v["applied_score"] for v in results.values()]
    results["mean_score"] = float(np.mean(scores)) if scores else None
    if over_instances and len(fold_counts) == 2:
        _, acc = average_score_with_instance_counts(*fold_counts)
        results["instance_weighted"] = acc
    with open(os.path.join(paths["base"], "cross_val_results.json"),
              "w") as f:
        json.dump(results, f, indent=2, default=float)
    return results


@time_func
def cleanup(args, config, paths):
    """Delete the prediction stores of the val and test splits whose
    result ``<sample>.hdf`` exists (run_ppp.py:1092-1107).  A result
    counts once it holds ``vote_instances_masked``, which
    ``finalize_and_write`` writes under every ``res_key``, so a prediction
    without its instances stays."""
    checkpoint = _resolve_checkpoint(args, config, paths)
    removed = []
    for mode in ("val", "test"):
        proc = os.path.join(paths[f"{mode}_processed"], str(checkpoint))
        inst = os.path.join(paths[f"{mode}_instanced"], str(checkpoint))
        for path in sorted(glob.glob(os.path.join(proc, "*.zarr"))):
            s = os.path.splitext(os.path.basename(path))[0]
            if vio.check_file(os.path.join(inst, s + ".hdf"),
                              keys=["vote_instances_masked"]):
                shutil.rmtree(path, ignore_errors=True)
                removed.append(path)
    return removed


@time_func
def visualize(args, config, paths):
    """Instance PNGs of the results (``<sample>.hdf``) and, with
    ``[visualize] show_patches``, patch mosaics of the predictions'
    affinities (``aff_key`` of ``[prediction]``; the volume plane
    ``patch_mosaic_z``, else the z-MIP) beside the prediction stores
    (run_ppp.py:1539-1606).  A prediction store without the affinities
    is passed over.  Returns the paths written."""
    from .visualize import visualize_instances, visualize_patches

    checkpoint = _resolve_checkpoint(args, config, paths)
    inst_dir = os.path.join(paths[f"{args.mode}_instanced"], str(checkpoint))
    viz = config.get("visualize", {})
    out = []
    for path in sorted(glob.glob(os.path.join(inst_dir, "*.hdf"))):
        s = os.path.splitext(os.path.basename(path))[0]
        io = vio.open_volume(path, mode="r")
        inst = io.read(key="vote_instances")
        io.close()
        png = os.path.join(inst_dir, s + ".png")
        visualize_instances(inst, png, device=args.device)
        out.append(png)
    if viz.get("show_patches"):
        proc = os.path.join(paths[f"{args.mode}_processed"],
                            str(checkpoint))
        ps = tuple(config["model"]["patchshape"])
        aff_key = config.get("prediction", {}).get("aff_key",
                                                   "volumes/pred_affs")
        for path in sorted(glob.glob(os.path.join(proc, "*.zarr"))):
            if not vio.check_file(path, keys=[aff_key]):
                continue
            s = os.path.splitext(os.path.basename(path))[0]
            io = vio.open_volume(path, mode="r")
            affs = io.read(key=aff_key).astype(np.float32)
            io.close()
            png = os.path.join(proc, s + "_patches.png")
            visualize_patches(affs, ps, png, z=viz.get("patch_mosaic_z"),
                              device=args.device)
            out.append(png)
    return out


def main(argv=None):
    args = get_arguments(argv)
    resolve_device(args.device)
    tasks = args.do or ["all"]
    if "all" in tasks:
        tasks = ["mknet", "train", "validate_checkpoints", "predict",
                 "decode", "label", "evaluate"]
    cfg_files = list(args.config or [])
    if args.run_from_exp and args.expid:
        stored = os.path.join(args.root, args.expid, "config.toml")
        if not os.path.exists(stored):
            raise FileNotFoundError(f"--run_from_exp: {stored} not found")
        cfg_files = [stored] + cfg_files
        args.config = cfg_files
    config = cfglib.load_config(*cfg_files)
    for ov in args.overrides:
        key, _, val = ov.partition("=")
        try:
            parsed = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            parsed = val
        cfglib.set_by_path(config, key.strip(), parsed)
    if args.debug_args:
        cfglib.set_by_path(config, "training.max_iterations", 10)
        cfglib.set_by_path(config, "training.cache_size", 2)

    paths = create_folders(args.root, args.expid)
    setup_logging(paths["base"],
                  config.get("general", {}).get("logging", "INFO"))
    # provenance: the merged config and the original files
    cfglib.dump_config(config, os.path.join(paths["base"], "config.toml"))
    for c in args.config:
        backup_and_copy_file(c, paths["backups"])

    dispatch = {
        "mknet": mknet, "train": train, "predict": predict, "decode": decode,
        "validate_checkpoints": validate_checkpoints,
        "validate": validate_checkpoints,
        "label": label, "infer_fused": infer_fused, "evaluate": evaluate,
        "evaluate_prediction": evaluate_prediction,
        "postprocess": postprocess, "cross_validate": cross_validate,
        "visualize": visualize, "cleanup": cleanup,
    }
    for task in tasks:
        logger.info("=== task %s ===", task)
        dispatch[task](args, config, paths)
    return paths


if __name__ == "__main__":
    main()
