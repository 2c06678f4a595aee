"""Training steps fed by the host data layer, as the program's host loop
runs them.

The timed path is the body of the program's ``train/trainer.py``
``_host_loop``: ``Prefetcher.next()`` (the host ``CropSampler`` in its
background thread, with the configuration's sampling and augmentation),
the batch to the device, and the step of ``make_train_step`` (forward,
losses, backward, Adam).  As ``_device_loop`` does, the metrics are read
once per chunk of ``CHUNK_STEPS`` steps, with no synchronise per step.
The run is float32 with TF32 off (the program's ``exact_f32``), as the
configuration states.

Set-up reflects the volume to the configuration's extent at a phase
drawn from the seed, makes the weights on the device from the seed,
builds the model on the device (its own initialisation, which the
weights replace, runs there), starts the sampler's thread last, and
drives the step from the seed through its first ``CHECK_STEPS`` steps
(the check follows them; the limits were set on these) and
``WARM_STEPS`` more.  The window opens at the next step and ends at the
synchronise after the chunk that passes ``--seconds``:
``train_crops_per_s`` is the crops of every step in the window over the
whole window.

The check (``reference/train.py``): the batches of the first steps
against the reference sampler's, element for element; each step's
losses; each leaf's first gradient, as Adam's first moment after one
step gives it; each leaf's change after the checked steps.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench import data
from portbench.counts import flops
from portbench.reference import model as ref_model, sampler
from portbench.reference import train as ref_train

# the steps the check follows (the limits of ``correct`` were set on
# three), the warm steps after them, and the steps between two host
# reads of the metrics in the window
CHECK_STEPS = 3
WARM_STEPS = 2
CHUNK_STEPS = 10


def _flax_name(torch_name: str) -> str:
    """A state_dict name as the Flax leaf it holds (norms do not depend
    on the layout)."""
    parts = torch_name.split(".")
    leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
    return "params/" + "/".join(parts[:-1] + [leaf])


def make_weights(model_cfg: dict, in_channels: int, seed: int, dev) -> dict:
    """He-normal kernels and zero biases, drawn on the device in one call,
    as a flat Flax-layout tree."""
    import torch

    leaves = ref_model.leaf_shapes(model_cfg, in_channels)
    sizes = [int(np.prod(s)) for _, s in leaves]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=dev)
    tree = {}
    for (name, shape), chunk in zip(leaves, flat.split(sizes)):
        if name.endswith("/bias"):
            tree[name] = torch.zeros(shape, device=dev)
        else:
            fan_in = int(np.prod(shape[:-1]))
            tree[name] = chunk.reshape(shape) * float(np.sqrt(2.0 / fan_in))
    return tree


def sampler_settings(cfg: dict, input_shape, output_shape, seed: int):
    """The sampling and augmentation keywords of a configuration's
    ``training`` section (the names both samplers share)."""
    tr = cfg["training"]
    aug = tr.get("augmentation", {})
    smp = tr.get("sampling", {})
    augment = dict(
        mirror=True, transpose=True, elastic="elastic" in aug,
        intensity_scale=tuple(aug.get("intensity", {}).get(
            "scale", (0.9, 1.1))),
        intensity_shift=tuple(aug.get("intensity", {}).get(
            "shift", (-0.1, 0.1))),
        probability_permute=tr.get("probability_permute", 0.0),
        probability_hue=tr.get("probability_hue", 0.0),
        hue_max_change=tr.get("hue_max_change", 0.5),
        probability_overlay=aug.get("overlay", {}).get(
            "probability_overlay", 0.0))
    sampling = dict(
        input_shape=tuple(input_shape), output_shape=tuple(output_shape),
        patchshape=tuple(p for p in cfg["model"]["patchshape"] if p > 1),
        batch_size=int(tr["batch_size"]),
        probability_fg=smp.get("probability_fg", 0.7),
        probability_overlap=smp.get("probability_overlap", 0.25),
        probability_random=smp.get("probability_random", 0.05),
        min_masked=smp.get("min_masked", 0.0), seed=seed)
    return augment, sampling


class Session:
    """The program's training set-up for one seed: the volume reflected at
    a seeded phase, the host sampler and its prefetch thread, the model
    with weights made on the device, Adam and the step.  ``close`` stops
    the thread and waits for it."""

    def __init__(self, cfg: dict, checkout: str, dev, seed: int, spans):
        import torch

        from patchperpix_tpu_torch import weights
        from patchperpix_tpu_torch.models import PPPConfig, PPPModel
        from patchperpix_tpu_torch.train.data import (AugmentConfig,
                                                      CropSampler,
                                                      Prefetcher, SampleData,
                                                      SamplerConfig)
        from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                         make_optimizer,
                                                         make_train_step)

        self.cfg, self.dev, self.spans = cfg, dev, spans
        self.marks = {}
        t = time.perf_counter()
        tr = cfg["training"]
        s_phase, s_sampler, s_weights, s_gen = data.seeds(seed, 4)
        self.net_cfg = ref_model.net_config(cfg)
        self.in_ch = int(cfg["model"]["num_channels"])
        self.in_shape = tuple(int(v) for v in cfg["train_input_shape"])
        self.batch = int(tr["batch_size"])
        raw0, lab0 = data.load_sample(cfg["data"], checkout)
        phase = np.random.RandomState(s_phase).randint(
            0, 2 * np.asarray(raw0.shape[1:]))
        self.raw = data.reflect_to(raw0, cfg["data"]["reflect_to"], phase)
        self.labels = data.reflect_to(lab0, cfg["data"]["reflect_to"],
                                      phase)
        self.augment, self.sampling = sampler_settings(
            cfg, self.in_shape, cfg["train_output_shape"], s_sampler)
        self.max_gt = self.labels.shape[0] * (
            2 if self.augment["probability_overlay"] > 0 else 1)
        inst = self.labels > 0
        sample = SampleData(raw=self.raw, labels=self.labels,
                            fg_mask=inst.any(axis=0),
                            overlap_mask=inst.sum(axis=0, dtype=np.uint8) > 1)
        self._mark("data", t)
        t = time.perf_counter()
        tree = make_weights(self.net_cfg, self.in_ch, s_weights, dev)
        self.tree = {k: v.cpu().numpy() for k, v in tree.items()}
        self._mark("weights", t)
        t = time.perf_counter()
        pc = PPPConfig.from_config(dict(cfg["model"]))
        with torch.device(dev):
            self.model = PPPModel(pc)
        self.model.load_state_dict(weights.to_state_dict(tree), strict=True)
        del tree
        self.model.train()
        tcfg = TrainConfig(lr=float(tr["lr"]), optimizer=tr["optimizer"],
                           use_gt_extra=bool(tr.get("use_gt_extra", False)))
        self.opt, sched = make_optimizer(tcfg, self.model.parameters())
        self.step_fn, _ = make_train_step(self.model, pc, tcfg, self.opt,
                                          sched)
        self.gen = torch.Generator(device=dev).manual_seed(s_gen)
        self._mark("model", t)
        # the sampler's thread starts last, so that no set-up step above
        # shares the host with it
        t = time.perf_counter()
        self.pf = Prefetcher(
            CropSampler([sample], SamplerConfig(
                augment=AugmentConfig(**self.augment), **self.sampling)),
            cache_size=int(tr.get("cache_size", 8)),
            max_gt_channels=self.max_gt)
        self._mark("sampler", t)

    def _mark(self, name: str, t: float):
        self.marks[name] = time.perf_counter() - t

    def one(self):
        """One step of the host loop: (metrics, host batch)."""
        import torch

        with self.spans.span("data_wait"):
            b = self.pf.next()
        raw = torch.as_tensor(np.asarray(b[0])).to(self.dev,
                                                   non_blocking=True)
        labels = torch.as_tensor(np.asarray(b[1])).to(self.dev,
                                                      non_blocking=True)
        return self.step_fn(raw.float(), labels, self.gen, None), b

    def first_steps(self, n: int) -> dict:
        """The checked steps: their batches, generator states and losses,
        each leaf's first gradient (Adam's first moment after one step)
        and each leaf's change after the n steps."""
        import torch

        named = dict(self.model.named_parameters())
        start = {k: p.detach().clone() for k, p in named.items()}
        rec = {"batches": [], "gen_states": [], "tree": self.tree}
        rows = []
        for t in range(n):
            rec["gen_states"].append(self.gen.get_state())
            mets, b = self.one()
            rec["batches"].append((np.asarray(b[0]), np.asarray(b[1])))
            rows.append(torch.stack([mets["loss"], mets["loss_patch"],
                                     mets["loss_fg"]]))
            if t == 0:
                rec["grad1"] = {
                    _flax_name(k): self.opt.state.get(p, {}).get(
                        "exp_avg", torch.zeros_like(p)).detach() / (1 - 0.9)
                    for k, p in named.items()}
        rec["change"] = {_flax_name(k): p.detach() - start[k]
                         for k, p in named.items()}
        rec["losses"] = [tuple(float(v) for v in row)
                         for row in torch.stack(rows).cpu().numpy()]
        return rec

    def reference_batches(self, n: int) -> list:
        """The reference sampler's first n batches for this seed."""
        ref = sampler.CropSampler(
            [sampler.Sample.of(self.raw, self.labels)],
            sampler.SamplerConfig(
                augment=sampler.AugmentConfig(**self.augment),
                **self.sampling))
        return [ref.batch(self.max_gt) for _ in range(n)]

    def free_program(self):
        del self.model, self.opt, self.step_fn

    def close(self):
        self.pf.stop()
        self.pf._thread.join(timeout=60)
        if self.pf._thread.is_alive():
            raise RuntimeError("the prefetch thread did not stop")


def compare(rec: dict, ref_batches: list, net_cfg: dict, lr: float,
            dev) -> dict:
    """The four numbers of the checked steps (``reference/train.py``)."""
    data_err = sum(int(np.count_nonzero(a[i] != b[i]))
                   for a, b in zip(rec["batches"], ref_batches)
                   for i in (0, 1))
    ref = ref_train.reference_steps(net_cfg, rec["tree"], ref_batches,
                                    rec["gen_states"], dev, lr=lr)
    loss_err = max(abs(a - b) / max(abs(b), 1e-30)
                   for pa, pb in zip(rec["losses"], ref["losses"])
                   for a, b in zip(pa, pb))
    kept = ref_train.moved_leaves(ref["grad1"])
    print(f"portbench: {len(ref['grad1']) - len(kept)} of "
          f"{len(ref['grad1'])} leaves left out of change_err",
          file=sys.stderr)
    return {"data_err": float(data_err), "loss_err": loss_err,
            "grad_err": ref_train.leaf_gaps(rec["grad1"], ref["grad1"]),
            "change_err": ref_train.leaf_gaps(rec["change"], ref["change"],
                                              kept)}


def run(ctx) -> dict:
    import torch

    from patchperpix_tpu_torch.utils.device import exact_f32

    cfg, dev = ctx.config, ctx.device
    marks = {"imports": time.perf_counter() - ctx.t0}
    ses = Session(cfg, ctx.checkout, dev, ctx.seed, ctx.spans)
    marks.update(ses.marks)
    try:
        with exact_f32():
            t = time.perf_counter()
            rec = ses.first_steps(CHECK_STEPS)
            marks["checked_steps"] = time.perf_counter() - t
            t = time.perf_counter()
            for _ in range(WARM_STEPS):
                ses.one()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            marks["warm_steps"] = time.perf_counter() - t
            ctx.spans.seconds.clear()
            steps = failed = 0
            with ctx.timeline:
                t_open = ctx.open_window()
                while True:
                    rows = [torch.stack(list(ses.one()[0].values()))
                            for _ in range(CHUNK_STEPS)]
                    vals = torch.stack(rows).cpu().numpy()  # one read
                    steps += CHUNK_STEPS
                    failed += int(np.count_nonzero(
                        ~np.isfinite(vals[:, 0])))
                    done = time.perf_counter() - t_open >= ctx.seconds
                    ctx.timeline.tick(steps, last=done)
                    if done:
                        break
                window_s = time.perf_counter() - t_open
        ctx.read_device()
        ses.free_program()
    finally:
        ses.close()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if ctx.traced:
        t = ctx.trace
        ctx.timeline.read(t)
        n_codes = ses.batch * int(cfg["model"]["autoencoder"]
                                  ["num_code_samples"])
        t.counts.update(
            steps=steps, profiled_steps=ctx.timeline.items,
            window_s=window_s,
            step_flops=flops.unet_flops(ses.net_cfg, ses.in_ch,
                                        ses.in_shape, ses.batch,
                                        backward=True)
            + flops.decoder_flops(ses.net_cfg, n_codes, backward=True))

    t_check = time.perf_counter()
    numbers = compare(rec, ses.reference_batches(len(rec["batches"])),
                      ses.net_cfg, float(cfg["training"]["lr"]), dev)
    print("portbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in marks.items())
        + f"; {steps} steps in {window_s:.3f} s, check in "
        f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    limits = cfg["limits"]
    return {"e2e": {"train_crops_per_s": steps * ses.batch / window_s},
            "attempted": steps, "failed": failed,
            "checks": [(k, v, float(limits[k]))
                       for k, v in sorted(numbers.items())]}
