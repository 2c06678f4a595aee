"""One train step of the port vs the JAX package's, on the CPU, in float32.

The same seeded Flax parameters (``full_init``) go into both models, the
same batch into both steps, and the code branch's sampled windows are the
JAX step's own: ``sample_fg_corners`` under the key the JAX step received,
fed to the port through ``corners=``.  The JAX step runs with an optax
transformation that returns the gradients as its state, so they are read
exactly.  Code and dense branches, ``overlapping_inst`` true and false, the
partly-labeled mask on and off, same and valid padding; every 3D
convolution takes the port's exact-f32 route on the card
(``unet.Conv3d.route``, ``unet.ConvTranspose3d.route``: the weight
gradient of the 3x3x3 ones from ``conv3d_wgrad``, of the pointwise and
transposed ones from ``conv1_wgrad`` / ``conv_t_wgrad``, here their plain
versions), with the card's test replaced by the seam ``unet._on_card``
and TF32 off.  Limits: loss parts rtol 1e-5, per-leaf
relative L2 error of the gradients <= 1e-5 (XLA-CPU's and torch's float32
sums run in other orders).  Every metric of the dict within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.ops.affinities import sample_fg_corners as j_corners
from patchperpix_tpu.train.trainer import TrainConfig as JTrainConfig
from patchperpix_tpu.train.trainer import make_train_step as j_make_step
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.models import PPPConfig, PPPModel, unet
from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                 compute_losses,
                                                 make_optimizer,
                                                 make_train_step)
from patchperpix_tpu_torch.utils.device import exact_f32

torch.set_num_threads(1)

B, PS = 2, 5
# input and output extents: same padding keeps 8; the valid U-Net (one
# level of 2, two convolutions a level) takes 20 to 16, 8, 4, 8 and 4
EXTENT = {"same": (8, 8), "valid": (20, 4)}
# to W1: the U-Net's six 3x3x3 convolutions, valid or SAME (narrow: fewer
# than 512 channel pairs, so rows of 6 route too), and the
# decoder's SAME 4 -> 4 pair on 4^3 and 1 -> 1 pair on 8^3
N_ROUTED, N_ROUTED_DECODER = 6, 4
# to W2: the two heads and the transposed convolution, and the decoder's
# pointwise ConvPass_0 and its two upsampling convolutions
N_GEMM, N_GEMM_DECODER = 3, 3


def _kw(code, ov, padding="same"):
    return dict(patchshape=(PS,) * 3, num_channels=2, num_fmaps=4,
                fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                downsample_factors=((2, 2, 2),), train_code=code,
                code_units=16, ae_code_fmaps=2, ae_num_fmaps=(4, 8),
                num_code_samples=16, overlapping_inst=ov, max_num_inst=2,
                padding=padding)


def _batch(padding="same"):
    """Raw (B, 2, S_in^3) and labels (B, 2, (S_out + 2 r)^3): two
    overlapping boxes, the second item's first rows unlabeled."""
    s_in, s_out = EXTENT[padding]
    rng = np.random.RandomState(0)
    raw = rng.rand(B, 2, s_in, s_in, s_in).astype(np.float32)
    r = PS // 2
    n = s_out + 2 * r
    labels = np.zeros((B, 2) + (n,) * 3, np.int32)
    box = lambda a, b: slice(a * n // 12, b * n // 12)
    labels[:, 0, box(2, 8), box(3, 9), box(2, 10)] = 1
    labels[:, 1, box(5, 11), box(4, 10), box(5, 9)] = 2
    labels[1, :, :, :n // 2] = 0
    return raw, labels


def _grads_as_state():
    return optax.GradientTransformation(
        lambda p: p,
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_step(kw, partly, raw, labels, key):
    cfg = JConfig(**kw)
    model = JModel(cfg)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(raw),
                        method=JModel.full_init)
    tcfg = JTrainConfig(add_partly=partly is not None, mask_bg_weight=0.1)
    step, _ = j_make_step(model, cfg, tcfg, _grads_as_state())
    args = (params, params, jnp.asarray(raw), jnp.asarray(labels), key)
    if partly is not None:
        args += (jnp.asarray(partly),)
    _, grads, mets = step(*args)
    corners = None
    if cfg.train_code:
        r = PS // 2
        ninst = (labels[:, :, r:-r, r:-r, r:-r] > 0).sum(1)
        gt_fg = ninst == 1 if cfg.overlapping_inst else ninst > 0
        corners = np.asarray(j_corners(key, jnp.asarray(gt_fg),
                                       cfg.num_code_samples)[0])
    flat = lambda t: weights.flatten_tree(jax.tree.map(np.asarray, t))
    return flat(params), flat(grads), \
        {k: float(v) for k, v in mets.items()}, corners


@pytest.mark.parametrize("padding", ["same", "valid"])
@pytest.mark.parametrize("partly", [False, True])
@pytest.mark.parametrize("ov", [True, False])
@pytest.mark.parametrize("code", [True, False])
def test_train_step_equals_jax(code, ov, partly, padding, monkeypatch):
    kw = _kw(code, ov, padding)
    raw, labels = _batch(padding)
    pmask = np.array([True, False]) if partly else None
    params, jgrads, jmets, corners = _jax_step(
        kw, pmask, raw, labels, jax.random.PRNGKey(5))

    model = PPPModel(PPPConfig(**kw))
    model.load_state_dict(weights.to_state_dict(params), strict=True)
    calls = {"conv3d_wgrad": [], "conv1_wgrad": [], "conv_t_wgrad": []}

    def counted(name):
        real = getattr(unet, name)
        return lambda x, *a: calls[name].append(tuple(x.shape)) or \
            real(x, *a)
    monkeypatch.setattr(unet, "_on_card", lambda x: True)
    for name in calls:
        monkeypatch.setattr(unet, name, counted(name))
    with exact_f32():
        loss, mets = compute_losses(
            model, model.cfg,
            TrainConfig(add_partly=partly, mask_bg_weight=0.1),
            torch.from_numpy(raw), torch.from_numpy(labels),
            partly=None if pmask is None else torch.from_numpy(pmask),
            corners=corners)
        loss.backward()
    assert len(calls["conv3d_wgrad"]) == N_ROUTED + code * N_ROUTED_DECODER
    assert len(calls["conv1_wgrad"]) + len(calls["conv_t_wgrad"]) == \
        N_GEMM + code * N_GEMM_DECODER
    assert len(calls["conv_t_wgrad"]) == 1
    grads = {k: v.numpy() for k, v in weights.from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}).items()}

    assert set(mets) == set(jmets)
    for k in ("loss", "loss_patch", "loss_fg"):
        np.testing.assert_allclose(float(mets[k]), jmets[k], rtol=1e-5)
    for k in jmets:
        assert abs(float(mets[k]) - jmets[k]) <= 1e-5 * max(1, abs(jmets[k]))
    assert set(grads) == set(jgrads)
    for k, want in jgrads.items():
        err = np.linalg.norm(grads[k] - want) / max(np.linalg.norm(want),
                                                    1e-30)
        assert err <= 1e-5, (k, err)


def test_step_updates_and_bf16_keeps_f32_state():
    """make_train_step's step: parameters move, the schedule advances, and
    under bf16 autocast the parameters, their gradients and Adam's moments
    stay float32 (the module is never cast)."""
    kw = dict(_kw(True, True), dtype="bfloat16")
    raw, labels = _batch()
    model = PPPModel(PPPConfig(**kw))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg = TrainConfig(lr=1e-3)
    opt, sched = make_optimizer(tcfg, model.parameters())
    step, eval_step = make_train_step(model, model.cfg, tcfg, opt, sched)
    g = torch.Generator().manual_seed(0)
    mets = step(torch.from_numpy(raw), torch.from_numpy(labels), g)
    assert np.isfinite(float(mets["loss"])) and sched.last_epoch == 1
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert any(not torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    after = {k: v.clone() for k, v in model.state_dict().items()}
    emets = eval_step(torch.from_numpy(raw), torch.from_numpy(labels), g)
    assert set(emets) == set(mets)
    assert all(torch.equal(after[k], v) for k, v in model.state_dict().items())
