"""Training loop: torch.optim, the port's checkpoints, SWA, val interleave.

Counterpart of ``patchperpix_tpu/train/trainer.py`` (reference
experiments/.../train.py train_until, the gp.TorchTrainExt loop with
AMP / SWA / checkpointing, train.py:498-572):

- ``make_optimizer``: ``torch.optim.Adam`` / ``SGD`` at optax's defaults
  (betas 0.9 / 0.999, eps 1e-8 outside the square root) and, for
  ``lr_schedule = "cosine"``, a ``LambdaLR`` equal to
  ``optax.warmup_cosine_decay_schedule`` step for step: optax evaluates
  its schedule at the update count *before* incrementing it, so the first
  update of a warmup has lr 0;
- ``compute_losses`` / ``make_train_step``: the code branch (foreground
  corners -> codes -> decoder -> sampled BCE) or the dense branch
  (dense GT affinities -> masked BCE), masked CE on numinst (or BCE on
  fgbg), the partly-labeled loss mask, losses in float32;
- ``dtype = "bfloat16"`` keeps float32 master parameters and runs the
  forward and the decode under ``torch.autocast`` (Flax casts the
  parameters on each call the same way); inference casts the module
  once (``weights.build_model``), training never does;
- checkpoints through ``weights.write_checkpoint``, with the optimizer
  state (Adam's moments and update count in the Flax layout), the SWA
  average and its count; resume from the latest, natural-sorted;
- ``train_until``: the host loop over a ``Prefetcher`` and the device loop
  over a ``DeviceSampler``, which runs chunks of K = gcd(intervals) steps
  with no host synchronisation inside a chunk;
- data-parallel training over a mesh (``make_data_mesh``, a list of
  devices; the CLI's ``training.num_devices``): the parameters and the
  optimizer state stay on the first device, the batch is split over the
  mesh and each share's forward runs on its device with copies of the
  parameters (``torch.func.functional_call``); the heads are gathered on
  the first device and the losses computed there once, so they are the
  masked means over the whole batch, as the JAX package's GSPMD step
  computes them (the mean of per-device means would be another number),
  and the gradients flow back through the copies and add up on the
  parameters.  DDP, which averages per-process losses, does not fit.
  The device sampler runs on one device: with a mesh it raises, as in
  the JAX package.
"""

from __future__ import annotations

import contextlib
import glob
import json
import logging
import math
import os
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.init import init_tree
from ..models.losses import (masked_bce_logits, masked_ce, sampled_bce,
                             summaries)
from ..models.ppp import PPPConfig, PPPModel
from ..ops.affinities import (gather_at, gt_affinities_dense,
                              gt_affinities_sampled, sample_fg_corners)
from ..parallel import sharded
from ..utils import trace
from ..utils.device import resolve_device
from .. import weights

logger = logging.getLogger(__name__)


@dataclass
class TrainConfig:
    max_iterations: int = 400002
    checkpoints: int = 5000          # checkpoint interval
    snapshots: int = 10000
    val_log_step: int = 0
    lr: float = 1e-4
    lr_schedule: str = ""    # "" (constant, ref train.py:498 Adam 1e-4),
                             # "cosine" (linear warmup + cosine decay to
                             # lr/10 over max_iterations)
    warmup_steps: int = 0
    optimizer: str = "Adam"
    use_swa: bool = False
    swa_start: int = 0
    swa_freq: int = 1
    output_folder: str = "."
    log_every: int = 100
    tensorboard: bool = True   # scalar summaries to <output>/tb when
                               # torch.utils.tensorboard is available
    mask_bg_weight: float = 0.01
    use_gt_extra: bool = False
    add_partly: bool = False   # partly-labeled data: per-pixel loss mask
                               # from labels (1 at labeled px, bg_weight
                               # elsewhere; ref CreateMask train.py:735-741)


def checkpoint_path(folder: str, step: int, name: str = "train_net") -> str:
    return os.path.join(folder, f"{name}_checkpoint_{step}")


def get_latest_checkpoint(folder: str, name: str = "train_net"):
    """Natural-sorted latest checkpoint (train_util.py:19-52): (path,
    step), or (None, -1)."""
    best, best_step = None, -1
    for p in glob.glob(os.path.join(folder, f"{name}_checkpoint_*")):
        m = re.search(r"checkpoint_(\d+)$", p)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best, best_step


# ---- optimizer ---------------------------------------------------------------

def lr_schedule(cfg: TrainConfig):
    """count -> lr, as optax evaluates it (the count of updates before the
    current one); constant unless ``lr_schedule == "cosine"``."""
    lr = float(cfg.lr)
    if not cfg.lr_schedule:
        return lambda count: lr
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule}")
    init = 0.0 if cfg.warmup_steps else lr
    warm = max(cfg.warmup_steps, 1)
    decay = cfg.max_iterations - warm
    if not decay > 0:
        raise ValueError("The cosine_decay_schedule requires positive "
                         f"decay_steps, got decay_steps={decay}.")
    alpha = 0.0 if lr == 0.0 else (lr / 10.0) / lr

    def sched(count):
        if count < warm:
            frac = 1.0 - min(max(count, 0), warm) / warm
            return (init - lr) * frac + lr
        c = min(count - warm, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return sched


def make_optimizer(cfg: TrainConfig, params):
    """(optimizer, scheduler) over the tensors ``params``; the
    scheduler's count starts at 0."""
    params = list(params)
    name = cfg.optimizer.lower()
    if name == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    sched = lr_schedule(cfg)
    base = float(cfg.lr)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: sched(c) / base if base else 0.0)
    return opt, scheduler


def _set_count(scheduler, count: int):
    """Put the schedule at update ``count`` (after a resume)."""
    scheduler.last_epoch = int(count)
    for g, base, lam in zip(scheduler.optimizer.param_groups,
                            scheduler.base_lrs, scheduler.lr_lambdas):
        g["lr"] = base * lam(int(count))


def opt_state_tree(cfg: TrainConfig, model: PPPModel, optimizer,
                   scheduler) -> dict:
    """The optimizer state in the checkpoint's layout: name, whether a
    schedule runs, the update count and, for Adam, the moments as flat
    Flax-layout trees of host arrays (zeros before the first update)."""
    out = {"name": cfg.optimizer.lower(), "schedule": bool(cfg.lr_schedule),
           "count": int(scheduler.last_epoch)}
    if out["name"] == "adam":
        mu, nu = {}, {}
        for n, p in model.named_parameters():
            st = optimizer.state.get(p, {})
            mu[n] = st.get("exp_avg", torch.zeros_like(p))
            nu[n] = st.get("exp_avg_sq", torch.zeros_like(p))
        for key, tree in (("mu", mu), ("nu", nu)):
            out[key] = {k: v.detach().cpu().numpy() for k, v in
                        weights.from_state_dict(tree).items()}
    return out


def restore_opt_state(cfg: TrainConfig, model: PPPModel, optimizer,
                      scheduler, saved: dict | None):
    """Load a checkpoint's optimizer state; a checkpoint without one, or
    with another structure (optimizer, schedule or leaves), leaves the
    moments and the count at their initial values with a warning, as the
    JAX package's ``resume_state`` does."""
    want = opt_state_tree(cfg, model, optimizer, scheduler)

    def structure(t):
        return (t.get("name"), t.get("schedule"), {
            k: {kk: tuple(np.shape(vv)) for kk, vv in t[k].items()}
            for k in ("mu", "nu") if k in t})
    if saved is None or structure(saved) != structure(want):
        logger.warning("optimizer state %s since the checkpoint; "
                       "reinitializing optimizer moments",
                       "missing" if saved is None else "structure changed")
        return
    count = int(saved["count"])
    if want["name"] == "adam" and count > 0:
        mu = weights.to_state_dict(saved["mu"])
        nu = weights.to_state_dict(saved["nu"])
        for n, p in model.named_parameters():
            optimizer.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": mu[n].to(p.device).clone(),
                "exp_avg_sq": nu[n].to(p.device).clone()}
    _set_count(scheduler, count)


# ---- the train step ----------------------------------------------------------

def _autocast(mcfg: PPPConfig, device: torch.device):
    if mcfg.dtype == "bfloat16":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def make_data_mesh(num_devices: int | None = None,
                   kind: str = "cuda") -> list:
    """Data-parallel mesh: the first ``num_devices`` devices of ``kind``
    (``parallel/sharded.py``'s ``local_devices``)."""
    return sharded.make_spatial_mesh(num_devices, kind)


def forward_heads(model: PPPModel, mcfg: PPPConfig, raw: torch.Tensor,
                  mesh=None):
    """Both heads of ``model`` on raw (B, C, *S), under the config's
    autocast.  With a mesh of n > 1 devices, B must divide by n: share k
    of the batch runs on mesh[k] with copies of the parameters, and the
    heads are gathered onto ``raw.device`` (the parameters' device)."""
    if mesh is None or len(mesh) <= 1:
        with _autocast(mcfg, raw.device):
            return model(raw)
    n = len(mesh)
    if raw.shape[0] % n:
        raise ValueError(f"batch {raw.shape[0]} does not split over a "
                         f"mesh of {n} devices")
    home = raw.device
    tensors = {**dict(model.named_parameters()),
               **dict(model.named_buffers())}
    h1, h2 = [], []
    for dev, x in zip(mesh, torch.chunk(raw, n)):
        local = {k: v.to(dev) for k, v in tensors.items()}
        with _autocast(mcfg, dev):
            a, b = torch.func.functional_call(model, local, (x.to(dev),))
        h1.append(a.to(home))
        h2.append(b.to(home))
    return torch.cat(h1), torch.cat(h2)


def compute_losses(model: PPPModel, mcfg: PPPConfig, tcfg: TrainConfig,
                   raw, labels, generator=None, partly=None, corners=None,
                   mesh=None):
    """(loss, metrics) of one batch: raw (B, C, *S) float32, labels (B, G,
    *S_out + 2 * (ps // 2)) integers, both on the model's device.
    ``corners`` (the code branch's sampled windows, (N, 1 + ndim)) are
    drawn from ``generator`` unless given.  ``mesh``: see
    ``forward_heads``; the losses are computed once, on the model's
    device."""
    ps = tuple(mcfg.patchshape_squeezed)
    max_ni = mcfg.max_num_inst
    h1, h2 = forward_heads(model, mcfg, raw, mesh)
    # convs run in the model's dtype, losses accumulate in float32
    h1, h2 = h1.float(), h2.float()
    out_sp = h1.shape[2:]
    nd = len(out_sp)
    rad = tuple(p // 2 for p in ps)

    # numinst / fgbg GT from the context-padded labels, centre-cropped
    labels_out = labels[(slice(None), slice(None)) + tuple(
        slice(r, r + o) for r, o in zip(rad, out_sp))]
    ninst = (labels_out > 0).sum(dim=1)
    gt_fg = ninst == 1 if mcfg.overlapping_inst else ninst > 0

    # partly-labeled loss mask (CreateMask, train.py:735-741): for partly
    # items labeled px weigh 1 and unlabeled px bg_weight; complete items
    # weigh 1 everywhere
    loss_mask = None
    if partly is not None:
        labeled = (ninst > 0).float()
        pmask = labeled + (1.0 - labeled) * tcfg.mask_bg_weight
        item = partly.reshape((-1,) + (1,) * nd).float()
        loss_mask = (item * pmask + (1.0 - item))[:, None]

    if mcfg.train_code:
        if corners is None:
            corners, valid = sample_fg_corners(gt_fg, mcfg.num_code_samples,
                                               generator)
        else:
            corners = (corners if torch.is_tensor(corners) else
                       torch.from_numpy(np.array(corners))).to(raw.device)
            valid = gt_fg.flatten(1).any(dim=1)[corners[:, 0].long()]
        codes = gather_at(h1.movedim(1, -1), corners)
        act = {"sigmoid": torch.sigmoid, "relu": torch.relu,
               "identity": lambda v: v}[mcfg.code_activation.lower()]
        with _autocast(mcfg, raw.device):
            logits = model.decode(act(codes))
        logits = logits.float()
        gt_affs = gt_affinities_sampled(labels, corners, ps).reshape(
            (-1,) + ps).float()
        loss_patch = sampled_bce(logits, gt_affs, valid)
        pred_affs_prob = torch.sigmoid(logits)
    else:
        gt_affs = gt_affinities_dense(labels, ps,
                                      device=labels.device).float()
        loss_patch = masked_bce_logits(h1, gt_affs, loss_mask,
                                       num_channels=float(mcfg.patchsize))
        pred_affs_prob = torch.sigmoid(h1)

    if mcfg.overlapping_inst:
        loss_fg = masked_ce(h2, ninst.clamp(0, max_ni), loss_mask,
                            use_gt_extra=tcfg.use_gt_extra)
        pred_fg_prob = 1.0 - torch.softmax(h2, dim=1)[:, 0]
        gt_fg_metric = (ninst > 0).float()
    else:
        gt_fgbg = (ninst > 0).float()[:, None]
        loss_fg = masked_bce_logits(h2, gt_fgbg, loss_mask)
        pred_fg_prob = torch.sigmoid(h2[:, 0])
        gt_fg_metric = gt_fgbg[:, 0]

    loss = loss_patch + loss_fg
    mets = {"loss": loss, "loss_patch": loss_patch, "loss_fg": loss_fg}
    with torch.no_grad():
        mets.update(summaries(pred_affs_prob.detach(), gt_affs,
                              pred_fg_prob.detach(), gt_fg_metric))
    return loss, {k: v.detach() for k, v in mets.items()}


def make_train_step(model: PPPModel, mcfg: PPPConfig, tcfg: TrainConfig,
                    optimizer, scheduler=None, mesh=None):
    """(step, eval_step), each ``(raw, labels, generator=None,
    partly=None, corners=None) -> metrics`` (0-dim tensors on the
    device).  ``step`` updates the model's parameters in place and
    advances the schedule; neither synchronises with the host.  With a
    ``mesh`` both run data-parallel (``forward_heads``).

    While a profiler runs, ``step`` records the spans (``utils/trace.py``)
    ``train.step`` (the whole step; its step id is the count of calls,
    and the device time between two steps, its ``gap_s``, holds the
    batch's copy to the device and the host's gaps), and inside it
    ``train.forward`` (the gradients dropped, heads, codes, decoder,
    losses, summaries), ``train.backward`` (autograd's kernels run on the
    caller's stream, so the events there bound them) and
    ``train.optimizer`` (the update and the schedule).  They are timed on the parameters' device; with a
    mesh, the other devices' work shows only where that device waits
    for it."""
    dev = next(model.parameters()).device
    calls = 0

    def step(raw, labels, generator=None, partly=None, corners=None):
        nonlocal calls
        calls += 1
        with trace.span("train.step", dev, step=calls):
            with trace.span("train.forward", dev):
                optimizer.zero_grad(set_to_none=True)
                loss, mets = compute_losses(model, mcfg, tcfg, raw, labels,
                                            generator, partly, corners,
                                            mesh)
            with trace.span("train.backward", dev):
                loss.backward()
            with trace.span("train.optimizer", dev):
                optimizer.step()
                if scheduler is not None:
                    scheduler.step()
        return mets

    @torch.no_grad()
    def eval_step(raw, labels, generator=None, partly=None, corners=None):
        return compute_losses(model, mcfg, tcfg, raw, labels, generator,
                              partly, corners, mesh)[1]

    return step, eval_step


# ---- the loops -----------------------------------------------------------------

def _chunk_size(tcfg: TrainConfig) -> int:
    """Largest K that hits every host-side interval boundary exactly."""
    K = math.gcd(max(tcfg.log_every, 1), max(tcfg.checkpoints, 1))
    if tcfg.snapshots:
        K = math.gcd(K, tcfg.snapshots)
    if tcfg.val_log_step:
        K = math.gcd(K, tcfg.val_log_step)
    return max(K, 1)


class _Run:
    """State and host-side bookkeeping shared by both loops: the model,
    optimizer, SWA average, log file and TensorBoard writer."""

    def __init__(self, model, mcfg, tcfg, rng_seed, device, mesh=None):
        self.dev = resolve_device(device)
        self.mcfg, self.tcfg = mcfg, tcfg
        os.makedirs(tcfg.output_folder, exist_ok=True)
        init = init_tree(mcfg, torch.Generator().manual_seed(rng_seed))
        model.load_state_dict(weights.to_state_dict(init), strict=True)
        self.model = model.to(device=self.dev, dtype=torch.float32).train()
        self.opt, self.sched = make_optimizer(tcfg, model.parameters())
        self.step = 0
        self.swa = None
        self.swa_n = 0

        latest, latest_step = get_latest_checkpoint(tcfg.output_folder)
        saved = None
        if latest is not None:
            logger.info("resuming from %s", latest)
            saved = weights.load_checkpoint(latest)
            model.load_state_dict(weights.to_state_dict(saved["params"]),
                                  strict=True)
            restore_opt_state(tcfg, model, self.opt, self.sched,
                              saved.get("opt_state"))
            self.step = latest_step
        if tcfg.use_swa:
            if saved is not None and "swa_params" in saved:
                self.swa = {k: v.to(self.dev) for k, v in
                            weights.to_state_dict(
                                saved["swa_params"]).items()}
                self.swa_n = int(saved.get("swa_n", 0))
            else:
                self.swa = {k: p.detach().clone()
                            for k, p in model.named_parameters()}
        # the random stream restarts from rng_seed on every call, resumed
        # or not, as in the JAX package
        self.gen = torch.Generator(device=self.dev).manual_seed(rng_seed)
        self.step_fn, self.eval_fn = make_train_step(
            model, mcfg, tcfg, self.opt, self.sched, mesh)

        self.log_f = open(os.path.join(tcfg.output_folder,
                                       "train_log.jsonl"), "a")
        self.tb = None
        if tcfg.tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(os.path.join(tcfg.output_folder,
                                                     "tb"))
            except ImportError as e:  # tensorboard is optional
                logger.warning("tensorboard unavailable (%s); logging to "
                               "train_log.jsonl only", e)
        self.t0 = time.time()

    def to_dev(self, x):
        return torch.as_tensor(np.asarray(x)).to(self.dev, non_blocking=True)

    def swa_update(self, at_step: int):
        t = self.tcfg
        if t.use_swa and at_step >= t.swa_start \
                and (at_step - t.swa_start) % max(t.swa_freq, 1) == 0:
            n = self.swa_n
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    a = self.swa[k]
                    a.add_((p.detach() - a) / (n + 1))
            self.swa_n = n + 1

    def log(self, row: dict, at_step: int, prefix: str = ""):
        row = {f"{prefix}{k}": float(v) for k, v in row.items()}
        if not prefix:
            row["wall"] = time.time() - self.t0
        row["step"] = at_step
        self.log_f.write(json.dumps(row) + "\n")
        self.log_f.flush()
        if self.tb is not None:
            for k, v in row.items():
                if k not in ("step", "wall"):
                    tag = f"val/{k[4:]}" if prefix else f"train/{k}"
                    self.tb.add_scalar(tag, v, at_step)
        if not prefix:
            logger.info("step %d loss %.5f (patch %.5f fg %.5f)", at_step,
                        row["loss"], row["loss_patch"], row["loss_fg"])

    def validate(self, batch):
        raw, labels = self.to_dev(batch[0]), self.to_dev(batch[1])
        partly = None
        if self.tcfg.add_partly:
            partly = (self.to_dev(batch[2]) if len(batch) > 2 else
                      torch.zeros(raw.shape[0], dtype=torch.bool,
                                  device=self.dev))
        mets = self.eval_fn(raw.float(), labels, self.gen, partly)
        self.log(mets, self.step, prefix="val_")

    def snapshot(self, raw, labels):
        """Raw, labels and both heads (float16) as the HDF5 file
        ``snapshots/snapshot_<step>.hdf`` under the JAX package's keys
        (gp.Snapshot, train.py:539-547)."""
        from ..utils.io import IoHDF5

        with torch.no_grad(), _autocast(self.mcfg, self.dev):
            h1, h2 = self.model(raw)
        snap_dir = os.path.join(self.tcfg.output_folder, "snapshots")
        os.makedirs(snap_dir, exist_ok=True)
        with IoHDF5(os.path.join(snap_dir, f"snapshot_{self.step}.hdf"),
                    mode="w") as io:
            for key, arr in (("volumes/raw", raw.float()),
                             ("volumes/gt_labels", labels),
                             ("volumes/pred_head1", h1.to(torch.float16)),
                             ("volumes/pred_head2", h2.to(torch.float16))):
                io.write(arr.cpu().numpy(), key=key)

    def state(self) -> dict:
        out = {"params": {k: v.detach().cpu().numpy() for k, v in
                          weights.from_state_dict(
                              self.model.state_dict()).items()},
               "opt_state": opt_state_tree(self.tcfg, self.model, self.opt,
                                           self.sched),
               "step": self.step}
        if self.tcfg.use_swa:
            out["swa_params"] = {k: v.cpu().numpy() for k, v in
                                 weights.from_state_dict(self.swa).items()}
            out["swa_n"] = self.swa_n
        return out

    def checkpoint(self):
        st = self.state()
        path = weights.write_checkpoint(
            st["params"], self.tcfg.output_folder, self.step,
            swa_tree=st.get("swa_params"), opt_state=st["opt_state"],
            swa_n=st.get("swa_n"))
        logger.info("saved checkpoint %s", path)

    def close(self):
        self.log_f.close()
        if self.tb is not None:
            self.tb.close()


def train_until(model: PPPModel, mcfg: PPPConfig, tcfg: TrainConfig,
                prefetcher, val_batch_fn=None, rng_seed: int = 42,
                device="cuda", mesh=None) -> dict:
    """Train ``model`` to ``max_iterations`` on ``device``, resuming from
    the latest checkpoint in ``tcfg.output_folder``.  The parameters start
    from ``init_tree(mcfg, Generator().manual_seed(rng_seed))`` (Flax's
    initialisers) unless a checkpoint exists; the random stream of the
    batches and code corners restarts from ``rng_seed`` on every call,
    resumed or not, as in the JAX package.  Returns the final state
    (params / opt_state / step, plus swa_params / swa_n with SWA), the
    trees as the checkpoint holds them.

    ``prefetcher`` is a host ``Prefetcher`` (the host loop) or a
    ``DeviceSampler`` (the device loop).  ``mesh`` (``make_data_mesh``)
    trains data-parallel over its devices, the parameters on ``device``;
    the device loop has no mesh path and raises."""
    from .device_data import DeviceSampler

    if isinstance(prefetcher, DeviceSampler) and mesh is not None:
        raise ValueError(
            "device_sampler does not support a data-parallel mesh yet "
            "(the fused loop is single-device); set "
            "training.num_devices=1 or use the host prefetcher")
    run = _Run(model, mcfg, tcfg, rng_seed, device, mesh)
    try:
        if isinstance(prefetcher, DeviceSampler):
            _device_loop(run, prefetcher, val_batch_fn)
        else:
            _host_loop(run, prefetcher, val_batch_fn)
    finally:
        run.close()
    return run.state()


def _host_loop(run: _Run, prefetcher, val_batch_fn):
    """One step per host batch (trainer.py:332-513)."""
    t = run.tcfg
    while run.step < t.max_iterations:
        b = prefetcher.next()
        raw, labels = run.to_dev(b[0]).float(), run.to_dev(b[1])
        partly = None
        if t.add_partly:
            partly = (run.to_dev(b[2]) if len(b) > 2 else
                      torch.zeros(raw.shape[0], dtype=torch.bool,
                                  device=run.dev))
        mets = run.step_fn(raw, labels, run.gen, partly)
        run.step += 1
        if run.step % t.log_every == 0 or run.step == 1:
            run.log(mets, run.step)
        if t.val_log_step and run.step % t.val_log_step == 0 \
                and val_batch_fn is not None:
            run.validate(val_batch_fn())
        if t.snapshots and run.step % t.snapshots == 0:
            run.snapshot(raw, labels)
        run.swa_update(run.step)
        if run.step % t.checkpoints == 0 or run.step == t.max_iterations:
            run.checkpoint()


def _device_loop(run: _Run, dsampler, val_batch_fn):
    """Chunks of K = gcd(log_every, checkpoints, snapshots, val_log_step)
    steps with the batches drawn on the card and no host synchronisation
    inside a chunk; the metrics are read once per chunk
    (_train_until_device, trainer.py:516-667).  Log rows: step 1 (when the
    run starts at 0), then every ``log_every``."""
    t = run.tcfg
    K = _chunk_size(t)
    first = run.step == 0
    while run.step < t.max_iterations:
        k = min(K, t.max_iterations - run.step)
        rows = []
        for _ in range(k):
            raw, labels, partly = dsampler.sample_batch(run.gen)
            mets = run.step_fn(raw, labels, run.gen,
                               partly if t.add_partly else None)
            run.step += 1
            run.swa_update(run.step)
            rows.append(torch.stack(list(mets.values())))
        keys = list(mets.keys())
        vals = torch.stack(rows).cpu().numpy()    # one read per chunk
        if first:
            run.log(dict(zip(keys, vals[0])), run.step - k + 1)
            first = False
        if run.step % t.log_every == 0:
            run.log(dict(zip(keys, vals[-1])), run.step)
        if t.val_log_step and run.step % t.val_log_step == 0 \
                and val_batch_fn is not None:
            run.validate(val_batch_fn())
        if t.snapshots and run.step % t.snapshots == 0:
            raw, labels, _ = dsampler.sample_batch(run.gen)
            run.snapshot(raw, labels)
        if run.step % t.checkpoints == 0 or run.step == t.max_iterations:
            run.checkpoint()
