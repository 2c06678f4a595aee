"""The port's SwinUNETR backbone vs the JAX package's, on the CPU, float32.

The same numpy inputs (seeded) and the same seeded parameters
(``weights.seeded_tree`` over the Flax module's own leaves, so that no
bias or scale sits at its zero / one initial value) go through the Flax
module and the port's.  Small sizes: feature size 8, window 4, odd
extents, so that every per-stage pad and crop, the clipped window and the
shifted branch run, in 2D and 3D.

- window partition / merge, ``_rel_pos_index`` and ``_shift_mask``:
  equal bit for bit;
- ``WindowAttention``, ``SwinBlock``, ``PatchMerging``, ``SwinUNETR`` and
  ``PPPModel(network_style="swinunetr")`` (the JAX test's 24x26 (1, 9, 9)
  case among them): within 1e-4 + 1e-4 |x|;
- one train step (``compute_losses``, both branches) against the JAX
  package's ``make_train_step``: loss parts rtol 1e-5, per-leaf relative
  L2 error of the gradients <= 1e-5, as ``test_torch_train_step.py``; a
  leaf past that is held against the JAX package's float64 step: within
  1e-5 of it, or within twice the JAX f32 step's own distance from it;
- ``init_tree`` / ``flax_leaves``: the names and shapes of Flax's
  ``init``, the initialisers' ranges; a ``to_state_dict`` /
  ``from_state_dict`` round trip.
"""

import jax
import jax.numpy as jnp
import os
import sys

import numpy as np
import optax
import pytest
import torch

from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.models import swin as jswin
from patchperpix_tpu.ops.affinities import sample_fg_corners as j_corners
from patchperpix_tpu.train.trainer import TrainConfig as JTrainConfig
from patchperpix_tpu.train.trainer import make_train_step as j_make_step
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.models import PPPConfig, PPPModel
from patchperpix_tpu_torch.models import swin as tswin
from patchperpix_tpu_torch.models.init import (_TRUNC_STD, flax_leaves,
                                               initializer, init_tree)
from patchperpix_tpu_torch.train.trainer import TrainConfig, compute_losses

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import export_torch_fixtures  # noqa: E402  (the float64 step)

torch.set_num_threads(2)


def _close(got, want, atol=1e-4, rtol=1e-4):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def _seeded(jparams, seed=0):
    """Seeded values for every leaf of a Flax params dict: (flat tree
    for the port, nested dict for Flax)."""
    flat = weights.flatten_tree(jax.tree.map(np.asarray, jparams))
    tree = weights.seeded_tree([(k, v.shape) for k, v in flat.items()], seed)
    nested: dict = {}
    for k, v in tree.items():
        d = nested
        parts = k.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = jnp.asarray(v)
    return tree, nested


def _load(module, tree):
    module.load_state_dict(weights.to_state_dict(tree), strict=True)
    return module


# -- static helpers ----------------------------------------------------------

@pytest.mark.parametrize("shape,ws", [((2, 4, 6, 8, 3), (2, 3, 4)),
                                      ((3, 6, 9, 5), (3, 3)),
                                      ((1, 8, 8, 8, 2), (4, 4, 4))])
def test_window_partition_and_merge_equal_jax(shape, ws):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = np.asarray(jswin._window_partition(jnp.asarray(x), ws))
    got = tswin._window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tswin._window_partition(x, ws), want)
    back = tswin._window_merge(got, ws, shape[1:-1], shape[0])
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jswin._window_merge(
        jnp.asarray(want), ws, shape[1:-1], shape[0])), back.numpy())


@pytest.mark.parametrize("ws", [(3, 3), (4, 4, 4), (7, 7, 7), (2, 3, 4),
                                (6, 7)])
def test_rel_pos_index_equals_jax(ws):
    np.testing.assert_array_equal(tswin._rel_pos_index(ws),
                                  jswin._rel_pos_index(ws))


@pytest.mark.parametrize("s,ws,shift", [
    ((8, 4), (4, 4), (2, 0)), ((8, 8, 8), (4, 4, 4), (2, 2, 2)),
    ((12, 8), (4, 4), (2, 2)), ((84, 84, 84), (7, 7, 7), (3, 3, 3)),
    ((6, 9, 12), (3, 3, 4), (1, 0, 2))])
def test_shift_mask_equals_jax(s, ws, shift):
    np.testing.assert_array_equal(tswin._shift_mask(s, ws, shift),
                                  jswin._shift_mask(s, ws, shift))


# -- modules -----------------------------------------------------------------

@pytest.mark.parametrize("nd,masked", [(2, False), (2, True), (3, True)])
def test_window_attention_equals_jax(nd, masked):
    ws = (4,) * nd
    sp = (8,) * nd
    shift = (2,) * nd
    W = 4 ** nd
    nw = 2 ** nd
    b = 2
    x = np.random.RandomState(1).rand(b * nw, W, 8).astype(np.float32)
    mask = jnp.asarray(jswin._shift_mask(sp, ws, shift)) if masked else None
    jm = jswin.WindowAttention(8, 2, ws)
    tree, params = _seeded(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   mask)["params"])
    want = jm.apply({"params": params}, jnp.asarray(x), mask)
    tm = _load(tswin.WindowAttention(8, 2, ws), tree)
    regions = (torch.as_tensor(tswin._shift_regions(sp, ws, shift))
               if masked else None)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), regions)
    _close(got, want)


@pytest.mark.parametrize("shape,shifted", [
    ((2, 9, 10, 8), False), ((2, 9, 10, 8), True),
    ((1, 7, 9, 5, 8), True), ((1, 3, 9, 10, 8), True)])
def test_swin_block_equals_jax(shape, shifted):
    """Odd extents pad to window multiples; the (1, 3, ...) block has a
    window clipped to 3 on its first axis and no shift there."""
    x = np.random.RandomState(2).rand(*shape).astype(np.float32)
    nd = len(shape) - 2
    window = (4,) * nd
    jm = jswin.SwinBlock(8, 2, window, shifted=shifted)
    tree, params = _seeded(jm.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x))
    clipped = tuple(min(w, s) for w, s in zip(window, shape[1:-1]))
    tm = _load(tswin.SwinBlock(8, 2, clipped, shifted), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 9, 10, 8), (1, 5, 6, 7, 8)])
def test_patch_merging_equals_jax(shape):
    x = np.random.RandomState(3).rand(*shape).astype(np.float32)
    nd = len(shape) - 2
    jm = jswin.PatchMerging(16)
    tree, params = _seeded(jm.init(jax.random.PRNGKey(0),
                                   jnp.asarray(x))["params"])
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = _load(tswin.PatchMerging(8, 16, nd), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 1, 19, 21), (1, 2, 15, 17, 16),
                                   (1, 1, 9, 11, 10)])
def test_swin_unetr_equals_jax(shape):
    """(1, 1, 9, 11, 10): the second stage is 3^3, narrower than the
    window, so its tables are built for the clipped window."""
    x = np.random.RandomState(4).rand(*shape).astype(np.float32)
    xl = jnp.asarray(np.moveaxis(x, 1, -1))
    jm = jswin.SwinUNETR(feature_size=8, depths=(2, 2), num_heads=(2, 4),
                         window_size=4)
    tree, params = _seeded(jm.init(jax.random.PRNGKey(0), xl)["params"])
    want = np.moveaxis(np.asarray(jm.apply({"params": params}, xl)), -1, 1)
    tm = _load(tswin.SwinUNETR(shape[1], 8, (2, 2), (2, 4), 4,
                               spatial_dims=len(shape) - 2,
                               input_shape=shape[2:]), tree)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == shape[:1] + (8,) + shape[2:]
    _close(got, want)


def test_clipped_window_needs_input_shape():
    tm = tswin.SwinUNETR(1, 8, (2, 2), (2, 4), 4, spatial_dims=3)
    with pytest.raises(ValueError, match="input_shape"):
        tm(torch.zeros(1, 1, 9, 11, 10))


def _ppp_pair(kw, x, input_shape=None, seed=0, flax_init=False):
    """(Flax model, its params, the port's model, the flat tree): seeded
    parameters, or with ``flax_init`` Flax's own ``full_init`` draw."""
    jm = JModel(JConfig(**kw))
    jparams = jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                      method=jm.full_init)["params"]
    if flax_init:
        params = jparams
        tree = weights.flatten_tree(jax.tree.map(np.asarray, jparams))
    else:
        tree, params = _seeded(jparams, seed)
    tm = _load(PPPModel(PPPConfig(**kw), input_shape=input_shape), tree)
    return jm, {"params": params}, tm, tree


@pytest.mark.parametrize("case", ["jax_2d_24x26", "3d_overlap"])
def test_ppp_swin_equals_jax(case):
    if case == "jax_2d_24x26":
        kw = dict(patchshape=(1, 9, 9), num_channels=1, num_fmaps=8,
                  network_style="swinunetr",
                  downsample_factors=((1, 2, 2),) * 2)
        x = np.random.RandomState(3).rand(1, 1, 24, 26).astype(np.float32)
    else:
        kw = dict(patchshape=(3, 3, 3), num_channels=2, num_fmaps=8,
                  network_style="swinunetr", overlapping_inst=True,
                  downsample_factors=((2, 2, 2),) * 2, padding="same")
        x = np.random.RandomState(5).rand(1, 2, 15, 16, 17).astype(
            np.float32)
    jm, params, tm, _ = _ppp_pair(kw, x, input_shape=x.shape[2:])
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert tm.unet.out_channels == kw["num_fmaps"]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_invalid_network_style_raises():
    with pytest.raises(ValueError, match="network style"):
        PPPModel(PPPConfig(network_style="resnet"))


# -- one train step ----------------------------------------------------------

def _grads_as_state():
    return optax.GradientTransformation(
        lambda p: p,
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("code", [False, True])
def test_train_step_equals_jax(code):
    ps = 5 if code else 3        # the code branch: test_torch_train_step's
    r = ps // 2
    kw = dict(patchshape=(ps,) * 3, num_channels=1, num_fmaps=8,
              network_style="swinunetr", overlapping_inst=True,
              downsample_factors=((2, 2, 2),) * 2, padding="same",
              train_code=code, code_units=16, ae_code_fmaps=2,
              ae_num_fmaps=(4, 8), num_code_samples=16)
    rng = np.random.RandomState(6)
    raw = rng.rand(2, 1, 9, 10, 9).astype(np.float32)
    labels = np.zeros((2, 2, 9 + 2 * r, 10 + 2 * r, 9 + 2 * r), np.int32)
    labels[:, 0, 1:7, 2:9, 1:8] = 1
    labels[:, 1, 4:10, 3:8, 3:10] = 2
    labels[1, :, :, :5] = 0
    # Flax's own initial parameters, as test_torch_train_step.py: with the
    # seeded ones (LayerNorm scales of deviation 1.4) float32 rounding
    # alone puts leaves at 1.3e-5, while the same step in float64 agrees
    # to 1.3e-7
    jm, params, tm, tree = _ppp_pair(kw, raw, input_shape=raw.shape[2:],
                                     flax_init=True)
    key = jax.random.PRNGKey(5)
    jcfg = JConfig(**kw)
    step, _ = j_make_step(jm, jcfg, JTrainConfig(), _grads_as_state())
    _, jgrads, jmets = step(params, params, jnp.asarray(raw),
                            jnp.asarray(labels), key)
    corners = None
    if code:
        ninst = (labels[:, :, r:-r, r:-r, r:-r] > 0).sum(1)
        corners = np.asarray(j_corners(key, jnp.asarray(ninst == 1),
                                       jcfg.num_code_samples)[0])
    loss, mets = compute_losses(tm, tm.cfg, TrainConfig(),
                                torch.from_numpy(raw),
                                torch.from_numpy(labels), corners=corners)
    loss.backward()
    grads = {k: v.numpy() for k, v in weights.from_state_dict(
        {n: p.grad for n, p in tm.named_parameters()}).items()}
    jgrads = weights.flatten_tree(jax.tree.map(np.asarray, jgrads))
    for k in ("loss", "loss_patch", "loss_fg"):
        np.testing.assert_allclose(float(mets[k]), float(jmets[k]),
                                   rtol=1e-5)
    assert set(grads) == set(jgrads)
    assert any("rel_pos_bias" in k for k in grads)
    # a leaf past 1e-5 of the JAX f32 step is held against the same step
    # in float64: the port's f32 step within 1e-5 of it, or within twice
    # the JAX f32 step's own distance from it (the code branch's decoder
    # bias sums thousands of positions: both f32 steps sit 4e-6 / 8e-6
    # from the float64 one, on opposite sides)
    with jax.enable_x64(True):
        g64, _ = export_torch_fixtures._step_f64(
            jcfg, {"params/" + k: v for k, v in tree.items()}, raw, labels,
            key, corners=corners)
    g64 = weights.flatten_tree(jax.tree.map(np.asarray, g64))
    for k, want in jgrads.items():
        rel = lambda a, b: np.linalg.norm(a - b) / max(np.linalg.norm(b),
                                                       1e-30)
        err = rel(grads[k], want)
        if err > 1e-5:
            assert rel(grads[k], g64[k]) <= max(1e-5, 2 * rel(want, g64[k])), \
                (k, err, rel(grads[k], g64[k]), rel(want, g64[k]))


# -- initialisation and the state dict --------------------------------------

@pytest.mark.parametrize("nd", [2, 3])
def test_init_tree_matches_flax_init(nd):
    kw = dict(patchshape=(1, 5, 5) if nd == 2 else (3, 3, 3),
              num_channels=2, num_fmaps=16, network_style="swinunetr",
              downsample_factors=((2, 2, 2),) * 2, padding="same")
    x = np.zeros((1, 2) + (28,) * nd, np.float32)
    jparams = JModel(JConfig(**kw)).init(jax.random.PRNGKey(0), x,
                                         method=JModel.full_init)
    want = weights.flatten_tree(jax.tree.map(np.asarray, jparams))
    cfg = PPPConfig(**kw)
    assert dict(flax_leaves(cfg)) == {k: v.shape for k, v in want.items()}
    got = init_tree(cfg, torch.Generator().manual_seed(0))
    assert set(got) == set(want)
    assert {k: v.shape for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    kinds = {initializer(k) for k in got}
    assert kinds == {"zeros", "ones", "truncated_normal", "xavier_uniform",
                     "lecun_normal", "kaiming_normal"}
    for k, w in want.items():
        g = got[k]
        kind = initializer(k)
        if kind in ("zeros", "ones"):
            assert np.all(g == (kind == "ones")) and np.all(w == g), k
            continue
        fan_in = int(np.prod(w.shape[:-1]))
        fan_out = int(np.prod(w.shape[:-2])) * w.shape[-1]
        cut = {"truncated_normal": 0.04,
               "xavier_uniform": np.sqrt(6.0 / (fan_in + fan_out)),
               "lecun_normal": 2 * np.sqrt(1 / fan_in) / _TRUNC_STD,
               "kaiming_normal": 2 * np.sqrt(2 / fan_in) / _TRUNC_STD}[kind]
        assert np.abs(g).max() <= cut * (1 + 1e-6), k
        assert np.abs(w).max() <= cut * (1 + 1e-6), k
        if g.size >= 4096:
            assert abs(g.std() / w.std() - 1) < 0.05, (k, g.std(), w.std())


def test_state_dict_round_trip():
    cfg = PPPConfig(patchshape=(3, 3, 3), num_channels=1, num_fmaps=8,
                    network_style="swinunetr",
                    downsample_factors=((2, 2, 2),) * 2, train_code=True,
                    code_units=16, ae_code_fmaps=2, ae_num_fmaps=(4, 8))
    tree = init_tree(cfg, torch.Generator().manual_seed(1))
    sd = weights.to_state_dict(tree)
    PPPModel(cfg).load_state_dict(sd, strict=True)
    assert sd["unet.SwinBlock_0.WindowAttention_0.Dense_0.weight"].shape \
        == (24, 8)
    back = weights.from_state_dict(sd)
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])
