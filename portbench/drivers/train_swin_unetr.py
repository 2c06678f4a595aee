"""Training steps of the Swin UNETR ppp+dec model fed by the host data
layer, as the program's host loop runs them.

The loop, the check and the window are ``train_host_sampler.py``'s (its
``CHECK_STEPS``, ``WARM_STEPS``, ``CHUNK_STEPS`` and ``Session`` methods):
``Prefetcher.next()`` (the host ``CropSampler`` in its background thread),
the batch to the device, the step of ``make_train_step``; the metrics
read once per chunk; float32 with TF32 off (``exact_f32``).  What differs
is the model: ``network_style = "swinunetr_monai"`` (the program's
``models/swin_unetr.py``), its weights, and the reference it is checked
against (``reference/swin_unetr.py``).

Set-up reflects the volume at a seeded phase, makes the weights on the
device from the seed, builds the model on the device (a program without
the style fails here, before the sampler's thread starts), starts the
sampler's thread last, and runs the checked and warm steps.

A traced run adds, to the counts the readers take: ``step_flops`` (the
step's FLOPs on the reference, ``counts/swin.py``) and the forward
window attention's ``swin_attn_flops``, ``swin_attn_bytes`` and
``swin_blocks`` of one step.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from portbench.counts import swin as counts
from portbench.drivers import train_host_sampler as base
from portbench.reference import swin_unetr as ref_swin
from portbench.reference import train as ref_train

CHECK_STEPS = base.CHECK_STEPS
WARM_STEPS = base.WARM_STEPS
CHUNK_STEPS = base.CHUNK_STEPS


def make_weights(model_cfg: dict, in_channels: int, seed: int, dev) -> dict:
    """Seeded weights drawn on the device in one call, as a flat
    Flax-layout tree: normal 0.02 for the Dense kernels and the
    relative-position tables, He-normal convolution kernels, LayerNorm
    scales one, biases zero."""
    import torch

    leaves = ref_swin.leaf_shapes(model_cfg, in_channels)
    sizes = [int(np.prod(s)) for _, s in leaves]
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=dev)
    tree = {}
    for (name, shape), chunk in zip(leaves, flat.split(sizes)):
        leaf = name.rsplit("/", 1)[1]
        if leaf == "bias":
            tree[name] = torch.zeros(shape, device=dev)
        elif leaf == "scale":
            tree[name] = torch.ones(shape, device=dev)
        elif leaf == "rel_pos_bias" or len(shape) == 2:
            tree[name] = chunk.reshape(shape) * 0.02
        else:
            fan_in = int(np.prod(shape[:-1]))
            tree[name] = chunk.reshape(shape) * float(np.sqrt(2.0 / fan_in))
    return tree


class Session(base.Session):
    """``train_host_sampler.Session`` (the volume, the sampler and its
    thread, the model built from the configuration on the device, Adam
    and the step) with this model's weights: its set-up runs with
    ``make_weights`` above in place of the U-Net's."""

    def __init__(self, cfg: dict, checkout: str, dev, seed: int, spans):
        unet_weights = base.make_weights
        base.make_weights = make_weights
        try:
            super().__init__(cfg, checkout, dev, seed, spans)
        finally:
            base.make_weights = unet_weights


def _leaf_names(tree: dict) -> dict:
    """The record's leaves under the reference's names: a LayerNorm's
    weight is its ``scale`` (``train_host_sampler._flax_name`` calls every
    weight a kernel; the norms compared do not depend on the layout)."""
    return {k[:-len("kernel")] + "scale"
            if k.endswith("/kernel") and k.split("/")[-2].startswith(
                "LayerNorm") else k: v for k, v in tree.items()}


def compare(rec: dict, ref_batches: list, net_cfg: dict, lr: float, dev,
            tf32: bool = False) -> dict:
    """The four numbers of the checked steps, against
    ``reference/swin_unetr.py`` (computed in TF32 for the control)."""
    rec = dict(rec, grad1=_leaf_names(rec["grad1"]),
               change=_leaf_names(rec["change"]))
    data_err = sum(int(np.count_nonzero(a[i] != b[i]))
                   for a, b in zip(rec["batches"], ref_batches)
                   for i in (0, 1))
    ref = ref_swin.reference_steps(net_cfg, rec["tree"], ref_batches,
                                   rec["gen_states"], dev, lr=lr)
    if tf32:
        ctl = ref_swin.reference_steps(net_cfg, rec["tree"], ref_batches,
                                       rec["gen_states"], dev, lr=lr,
                                       tf32=True)
        rec = dict(rec, losses=ctl["losses"], grad1=ctl["grad1"],
                   change=ctl["change"])
    loss_err = max(abs(a - b) / max(abs(b), 1e-30)
                   for pa, pb in zip(rec["losses"], ref["losses"])
                   for a, b in zip(pa, pb))
    kept = ref_train.moved_leaves(ref["grad1"])
    print(f"portbench: {len(ref['grad1']) - len(kept)} of "
          f"{len(ref['grad1'])} leaves left out of change_err: "
          + ", ".join(sorted(set(ref["grad1"]) - set(kept))),
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
        attn = counts.attention(ses.net_cfg, ses.in_shape, ses.batch)
        t.counts.update(
            steps=steps, profiled_steps=ctx.timeline.items,
            window_s=window_s,
            step_flops=counts.step_flops(ses.net_cfg, ses.in_ch,
                                         ses.in_shape, ses.batch, n_codes),
            swin_attn_flops=attn["flops"], swin_attn_bytes=attn["bytes"],
            swin_blocks=attn["blocks"])

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
