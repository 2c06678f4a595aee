"""Plain reference of the ppp+dec training step with Adam.

Written from the published setup (the reference repository's
``torch_model.py`` / ``torch_loss.py`` and ``default_train_code.toml``):

- the numinst target is the count of ground-truth instances at each
  output voxel (capped at ``max_num_inst``), its loss the mean
  cross-entropy over the output voxels;
- ``num_code_samples`` foreground voxels per batch item (exactly one
  instance there) are drawn with replacement; the code at each goes
  through the code activation and the decoder, and the patch loss is the
  mean binary cross-entropy with logits against the sampled ground-truth
  patch (1 where a patch pixel shares a non-zero label with the centre
  and both are foreground), over the items with foreground;
- Adam (Kingma and Ba) with beta 0.9 / 0.999 and epsilon 1e-8 added to
  the bias-corrected root, a constant learning rate.

The code locations come from ``torch.multinomial`` on the device with a
generator in the state the benchmark recorded before the program's step,
so both sides sample the same voxels; this function and the sampled
ground truth are frozen copies of the program's.  Gradients come from
autograd over the reference network (``model.py``).

Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .model import Net, precision, strip


def _unravel(idx: torch.Tensor, shape) -> torch.Tensor:
    out = []
    for s in reversed(tuple(int(s) for s in shape)):
        out.append(idx % s)
        idx = idx // s
    return torch.stack(out[::-1], dim=-1)


@torch.no_grad()
def sample_fg_corners(gt_fg: torch.Tensor, sample_cnt: int, generator):
    """``sample_cnt`` foreground voxels per batch item, with replacement;
    items without foreground draw uniformly and are marked invalid.
    Returns (corners (B * n, 1 + ndim), valid (B * n,))."""
    B, spatial = gt_fg.shape[0], tuple(gt_fg.shape[1:])
    flat = gt_fg.reshape(B, -1)
    has_fg = flat.any(dim=1)
    w = torch.where(has_fg[:, None], flat, True).float()
    idx = torch.multinomial(w, sample_cnt, replacement=True,
                            generator=generator)
    coords = _unravel(idx, spatial)
    b_col = torch.arange(B, device=gt_fg.device)[:, None, None].expand(
        B, sample_cnt, 1)
    corners = torch.cat([b_col, coords], dim=-1)
    valid = has_fg[:, None].expand(B, sample_cnt)
    return corners.reshape(-1, 1 + len(spatial)), valid.reshape(-1)


@torch.no_grad()
def sampled_gt_patches(labels: torch.Tensor, corners: torch.Tensor,
                       patchshape) -> torch.Tensor:
    """(N, P) ground-truth patches whose top-left corners (batch first)
    are ``corners`` in the context-padded labels (B, C, *S)."""
    ps = tuple(int(p) for p in patchshape)
    offs = _unravel(torch.arange(int(np.prod(ps)), device=labels.device),
                    ps)
    idx = corners[:, None, 1:] + offs[None]
    b = corners[:, :1].expand(-1, offs.shape[0])
    win = labels[(b, slice(None)) + tuple(idx.unbind(-1))]
    mid = int(np.ravel_multi_index(tuple(p // 2 for p in ps), ps))
    center = win[:, mid:mid + 1]
    same = ((win == center) & (center != 0)).any(dim=-1)
    fg = (win != 0).any(dim=-1)
    return (same & fg[:, mid:mid + 1] & fg).float()


def losses(net: Net, cfg: dict, raw, labels, generator):
    """(loss, loss_patch, loss_fg) of one batch."""
    ps = tuple(int(p) for p in cfg["patchshape"])
    code, ni = net.forward(raw)
    out_sp = code.shape[2:]
    rad = [p // 2 for p in ps]
    labels_out = labels[(slice(None), slice(None)) + tuple(
        slice(r, r + o) for r, o in zip(rad, out_sp))]
    ninst = (labels_out > 0).sum(dim=1)
    corners, valid = sample_fg_corners(
        ninst == 1, int(cfg["autoencoder"]["num_code_samples"]), generator)
    codes = code.movedim(1, -1)[tuple(corners.unbind(-1))]
    logits = net.decode(torch.sigmoid(codes)).reshape(len(codes), -1)
    gt = sampled_gt_patches(labels, corners, ps)
    bce = F.binary_cross_entropy_with_logits(logits, gt, reduction="none")
    v = valid.float()[:, None]
    cnt = v.sum() * bce.shape[1]
    loss_patch = (bce * v).sum() / cnt.clamp(min=1e-30) if cnt > 0 \
        else bce.sum() * 0.0
    target = ninst.clamp(0, int(cfg["max_num_inst"])).long()
    loss_fg = F.cross_entropy(ni, target)
    return loss_patch + loss_fg, loss_patch, loss_fg


def reference_steps(cfg: dict, tree: dict, batches, gen_states, dev,
                    lr: float, tf32: bool = False) -> dict:
    """The first steps of training from the parameters ``tree`` (flat,
    Flax layout) on ``batches`` [(raw, labels)], the code locations drawn
    from generator states ``gen_states``.  Returns the losses of each step
    [(loss, patch, fg)], each leaf's first gradient and each leaf's change
    after the last step, as {leaf: tensor}."""
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              .clone().requires_grad_(True) for k, v in tree.items()}
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    s = {k: torch.zeros_like(p) for k, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"losses": [], "grad1": None}
    gen = torch.Generator(device=dev)
    with precision(tf32):
        for t, ((raw, labels), state) in enumerate(zip(batches, gen_states),
                                                   start=1):
            net = Net(cfg, strip(params), tf32=tf32)
            gen.set_state(state)
            loss, lp, lf = losses(
                net, cfg, torch.as_tensor(raw, device=dev).float(),
                torch.as_tensor(labels, device=dev), gen)
            grads = torch.autograd.grad(loss, list(params.values()))
            out["losses"].append(tuple(float(v.detach())
                                       for v in (loss, lp, lf)))
            with torch.no_grad():
                g = dict(zip(params, grads))
                if out["grad1"] is None:
                    out["grad1"] = {k: v.clone() for k, v in g.items()}
                for k, p in params.items():
                    m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                    s[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                    mh = m[k] / (1 - b1 ** t)
                    vh = s[k] / (1 - b2 ** t)
                    p.sub_(lr * mh / (vh.sqrt() + eps))
    out["change"] = {k: (p.detach() - start[k]) for k, p in params.items()}
    return out


def moved_leaves(ref_grad: dict, keep_frac: float = 1e-3) -> list:
    """The leaves whose reference gradient norm is at least ``keep_frac``
    of the median leaf's: below it Adam moves a leaf by round-off alone
    (a key's bias under the softmax)."""
    gn = {k: float(v.norm()) for k, v in ref_grad.items()}
    gmed = float(np.median(list(gn.values())))
    return [k for k in ref_grad if gn[k] >= keep_frac * gmed]


def leaf_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference leaf's norm and the
    median leaf's, over the leaves ``keep`` (default: all)."""
    rn = {k: float(v.norm()) for k, v in ref.items()}
    med = float(np.median(list(rn.values())))
    keep = list(ref) if keep is None else keep
    worst = 0.0
    for k in keep:
        pn = float(prog[k].norm())
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst
