"""The port's training pieces vs the JAX package's, on the CPU.

Same numpy inputs through both packages:

- every loss and summary, with and without masks, empty masks included
  (rtol 1e-6);
- the sampled GT affinities and ``gather_at`` (exactly), and
  ``sample_fg_corners`` by its properties;
- ``init_tree`` against Flax's ``full_init``: leaf names and shapes, the
  per-leaf standard deviation within 5 % on leaves of >= 4k entries, no
  entry beyond the 2-sigma cut; ``from_state_dict`` inverts
  ``to_state_dict``;
- Adam / SGD under the constant and the warmup-cosine schedules against
  optax on the same gradients for 5 steps (1e-6), and the SWA average
  against the JAX formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.models import losses as JL
from patchperpix_tpu.ops import affinities as JA
from patchperpix_tpu.train.trainer import TrainConfig as JTrainConfig
from patchperpix_tpu.train.trainer import make_optimizer as j_make_optimizer
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.models import PPPConfig, PPPModel
from patchperpix_tpu_torch.models import losses as TL
from patchperpix_tpu_torch.models.init import _TRUNC_STD, _fans, init_tree
from patchperpix_tpu_torch.models.init import initializer
from patchperpix_tpu_torch.ops import affinities as TA
from patchperpix_tpu_torch.train.trainer import (TrainConfig, lr_schedule,
                                                 make_optimizer)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# -- losses --------------------------------------------------------------------

def _loss_inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = (3 * rng.randn(2, 4, 6, 7)).astype(np.float32)
    targets = (rng.rand(2, 4, 6, 7) > 0.5).astype(np.float32)
    ce_logits = (2 * rng.randn(2, 3, 6, 7)).astype(np.float32)
    ce_t = rng.randint(0, 3, (2, 6, 7)).astype(np.int32)
    masks = {
        "none": None,
        "one_channel": (rng.rand(2, 1, 6, 7) > 0.3).astype(np.float32),
        "three_channel": (rng.rand(2, 3, 6, 7) > 0.3).astype(np.float32),
        "weighted": np.where(rng.rand(2, 1, 6, 7) > 0.5, 1.0,
                             0.01).astype(np.float32),
        "empty": np.zeros((2, 1, 6, 7), np.float32),
    }
    return logits, targets, ce_logits, ce_t, masks


@pytest.mark.parametrize("mask", ["none", "one_channel", "three_channel",
                                  "weighted", "empty"])
def test_masked_bce_equals_jax(mask):
    logits, targets, _, _, masks = _loss_inputs()
    m = masks[mask]
    want = JL.masked_bce_logits(jnp.asarray(logits), jnp.asarray(targets),
                                None if m is None else jnp.asarray(m),
                                num_channels=4.0)
    got = TL.masked_bce_logits(_t(logits), _t(targets),
                               None if m is None else _t(m),
                               num_channels=4.0)
    _close(got, want)
    if mask == "empty":
        assert float(got) == 0.0


@pytest.mark.parametrize("mask", ["none", "one_channel", "weighted",
                                  "empty"])
@pytest.mark.parametrize("use_gt_extra", [False, True])
def test_masked_ce_equals_jax(mask, use_gt_extra):
    _, _, logits, t, masks = _loss_inputs(1)
    m = masks[mask]
    want = JL.masked_ce(jnp.asarray(logits), jnp.asarray(t),
                        None if m is None else jnp.asarray(m),
                        use_gt_extra=use_gt_extra)
    got = TL.masked_ce(_t(logits), _t(t), None if m is None else _t(m),
                       use_gt_extra=use_gt_extra)
    _close(got, want)


@pytest.mark.parametrize("valid", ["none", "some", "empty"])
def test_sampled_bce_equals_jax(valid):
    rng = np.random.RandomState(2)
    logits = (2 * rng.randn(6, 5, 5, 5)).astype(np.float32)
    targets = (rng.rand(6, 5, 5, 5) > 0.5).astype(np.float32)
    v = {"none": None, "some": np.array([1, 0, 1, 1, 0, 1], bool),
         "empty": np.zeros(6, bool)}[valid]
    want = JL.sampled_bce(jnp.asarray(logits), jnp.asarray(targets),
                          None if v is None else jnp.asarray(v))
    got = TL.sampled_bce(_t(logits), _t(targets),
                         None if v is None else _t(v))
    _close(got, want)


def test_empty_inputs_give_jax_values():
    e = np.zeros((0, 4, 3, 3), np.float32)
    _close(TL.masked_bce_logits(_t(e), _t(e)),
           JL.masked_bce_logits(jnp.asarray(e), jnp.asarray(e)))
    ce = np.zeros((0, 3, 3, 3), np.float32)
    ti = np.zeros((0, 3, 3), np.int32)
    _close(TL.masked_ce(_t(ce), _t(ti)),
           JL.masked_ce(jnp.asarray(ce), jnp.asarray(ti)))


@pytest.mark.parametrize("case", ["random", "all_bg"])
def test_summaries_equal_jax(case):
    rng = np.random.RandomState(3)
    pa = rng.rand(4, 5, 5, 5).astype(np.float32)
    ga = (rng.rand(4, 5, 5, 5) > 0.6).astype(np.float32)
    pf = rng.rand(2, 8, 8).astype(np.float32)
    gf = (rng.rand(2, 8, 8) > 0.5).astype(np.float32)
    if case == "all_bg":
        pa[:] = 0.1
        ga[:] = 0.0
        gf[:] = 0.0
    want = JL.summaries(*map(jnp.asarray, (pa, ga, pf, gf)))
    got = TL.summaries(*map(_t, (pa, ga, pf, gf)))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol=1e-7)


def test_masked_loss_zero_gradient_at_masked_pixels():
    logits, targets, ce_logits, ce_t, _ = _loss_inputs()
    mask = np.ones((2, 1, 6, 7), np.float32)
    mask[..., 4:] = 0.0
    lg = _t(logits).requires_grad_()
    TL.masked_bce_logits(lg, _t(targets), _t(mask), 4.0).backward()
    assert lg.grad[..., 4:].abs().max() == 0 and lg.grad[..., :4].abs().max() > 0
    lc = _t(ce_logits).requires_grad_()
    TL.masked_ce(lc, _t(ce_t), _t(mask)).backward()
    assert lc.grad[..., 4:].abs().max() == 0 and lc.grad[..., :4].abs().max() > 0


# -- GT affinities -------------------------------------------------------------

def _labels(seed, B=2, C=2, S=(12, 11, 10)):
    rng = np.random.RandomState(seed)
    lab = np.zeros((B, C) + S, np.int32)
    for b in range(B):
        for c in range(C):
            lo = rng.randint(0, 4, 3)
            hi = lo + rng.randint(3, 7, 3)
            lab[b, c, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = 1 + c + 2 * b
    return lab


@pytest.mark.parametrize("ps", [(3, 3, 3), (5, 5, 5), (1, 5, 3)])
def test_gt_affinities_sampled_equals_jax(ps):
    lab = _labels(4)
    ps_sq = tuple(p for p in ps if p > 1) if len(ps) == 3 and ps[0] == 1 \
        else ps
    if len(ps_sq) == 2:
        lab = lab[:, :, 0]
    sp = lab.shape[2:]
    rng = np.random.RandomState(5)
    n = 40
    corners = np.concatenate(
        [rng.randint(0, lab.shape[0], (n, 1))]
        + [rng.randint(0, s - p + 1, (n, 1)) for s, p in zip(sp, ps_sq)],
        axis=1).astype(np.int32)
    want = np.asarray(JA.gt_affinities_sampled(jnp.asarray(lab),
                                               jnp.asarray(corners), ps_sq))
    got = TA.gt_affinities_sampled(_t(lab), _t(corners), ps_sq).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 0


def test_gather_at_equals_jax():
    rng = np.random.RandomState(6)
    vol = rng.randn(2, 5, 6, 7, 4).astype(np.float32)
    corners = np.stack([rng.randint(0, d, 30) for d in vol.shape[:4]],
                       axis=1).astype(np.int32)
    np.testing.assert_array_equal(
        TA.gather_at(_t(vol), _t(corners)).numpy(),
        np.asarray(JA.gather_at(jnp.asarray(vol), jnp.asarray(corners))))


def test_sample_fg_corners_properties():
    rng = np.random.RandomState(7)
    fg = rng.rand(3, 6, 7, 8) > 0.97
    fg[1] = False                       # an item without foreground
    fg[2] = False
    fg[2, 3, 4, 5] = True               # one voxel: drawn with replacement
    g = torch.Generator().manual_seed(0)
    corners, valid = TA.sample_fg_corners(_t(fg), 50, g)
    corners, valid = corners.numpy(), valid.numpy()
    assert corners.shape == (150, 4) and valid.shape == (150,)
    np.testing.assert_array_equal(corners[:, 0], np.repeat([0, 1, 2], 50))
    np.testing.assert_array_equal(valid, np.repeat([True, False, True], 50))
    # every valid corner is foreground; invalid rows stay in range
    assert fg[tuple(corners[valid].T)].all()
    assert (corners[:, 1:] >= 0).all() and \
        (corners[:, 1:] < np.array(fg.shape[1:])).all()
    assert (corners[100:] == [2, 3, 4, 5]).all()
    # with replacement: item 0 has fewer fg voxels than draws
    assert fg[0].sum() < 50
    assert len({tuple(c) for c in corners[:50]}) <= fg[0].sum()


# -- initialisation ------------------------------------------------------------

INIT_CASES = {
    "code3d": dict(patchshape=(5, 5, 5), num_channels=3, num_fmaps=8,
                   fmap_inc_factors=(3,), fmap_dec_factors=(1.0,),
                   downsample_factors=((2, 2, 2),), padding="same",
                   train_code=True, code_units=16, ae_code_fmaps=2,
                   ae_num_fmaps=(16, 32), overlapping_inst=True),
    "dense3d": dict(patchshape=(5, 5, 5), num_channels=1, num_fmaps=8,
                    fmap_inc_factors=(3,), fmap_dec_factors=(1.2,),
                    downsample_factors=((2, 2, 2),), padding="valid"),
    "code2d": dict(patchshape=(1, 5, 5), num_channels=1, num_fmaps=16,
                   fmap_inc_factors=(2, 2), fmap_dec_factors=(1.0, 1.0),
                   downsample_factors=((1, 2, 2),) * 2, padding="same",
                   train_code=True, code_units=8, ae_code_fmaps=2,
                   ae_num_fmaps=(16, 32),
                   ae_downsample_factors=((2, 2), (2, 2)),
                   overlapping_inst=True),
    "dense2d": dict(patchshape=(1, 5, 5), num_channels=1, num_fmaps=16,
                    fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                    downsample_factors=((1, 2, 2),), padding="same"),
}


def _flax_init(kw, seed=0):
    cfg = JConfig(**kw)
    nd = cfg.spatial_dims
    raw = np.zeros((1, kw["num_channels"]) + (8,) * nd, np.float32)
    params = JModel(cfg).init(jax.random.PRNGKey(seed), raw,
                              method=JModel.full_init)
    return weights.flatten_tree(jax.tree.map(np.asarray, params))


def _want_std(name, shape):
    fan_in, fan_out = _fans(shape)
    kind = initializer(name)
    if kind == "xavier_uniform":
        return np.sqrt(1.0 / ((fan_in + fan_out) / 2))
    return np.sqrt((2.0 if kind == "kaiming_normal" else 1.0) / fan_in)


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_tree_matches_flax_full_init(case):
    kw = INIT_CASES[case]
    want = _flax_init(kw)
    got = init_tree(PPPConfig(**kw), torch.Generator().manual_seed(0))
    assert list(got) == sorted(got) or set(got) == set(want)
    assert set(got) == set(want)
    n_big = 0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == np.float32, k
        if k.endswith("/bias"):
            assert not g.any() and not w.any(), k
            continue
        kind = initializer(k)
        cut = (2.0 * _want_std(k, w.shape) / _TRUNC_STD
               if kind != "xavier_uniform"
               else np.sqrt(3.0) * _want_std(k, w.shape))
        assert np.abs(g).max() <= cut * (1 + 1e-6), k
        assert np.abs(w).max() <= cut * (1 + 1e-6), k
        if g.size >= 4096:
            n_big += 1
            assert abs(g.std() / w.std() - 1) < 0.05, (k, g.std(), w.std())
            assert abs(g.std() / _want_std(k, g.shape) - 1) < 0.05, k
    assert n_big >= 2
    # the same generator seed gives the same tree
    again = init_tree(PPPConfig(**kw), torch.Generator().manual_seed(0))
    assert all(np.array_equal(again[k], got[k]) for k in got)


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_from_state_dict_inverts_to_state_dict(case):
    kw = INIT_CASES[case]
    tree = init_tree(PPPConfig(**kw), torch.Generator().manual_seed(1))
    sd = weights.to_state_dict(tree)
    PPPModel(PPPConfig(**kw)).load_state_dict(sd, strict=True)
    back = weights.from_state_dict(sd)
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), tree[k])
    sd2 = weights.to_state_dict({k: v.numpy() for k, v in back.items()})
    assert all(torch.equal(sd2[k], sd[k]) for k in sd)


# -- optimizer and schedules ---------------------------------------------------

OPT_CASES = [("Adam", ""), ("Adam", "cosine"), ("sgd", ""), ("sgd", "cosine")]


@pytest.mark.parametrize("name,schedule", OPT_CASES)
def test_optimizer_equals_optax(name, schedule):
    kw = dict(lr=1e-2, optimizer=name, lr_schedule=schedule,
              warmup_steps=2 if schedule else 0, max_iterations=6)
    rng = np.random.RandomState(8)
    p0 = {"a": rng.randn(4, 3).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in
              p0.items()} for _ in range(5)]
    jopt = j_make_optimizer(JTrainConfig(**kw))
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt, sched = make_optimizer(TrainConfig(**kw), tp.values())
    for i, g in enumerate(grads):
        upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        sched.step()
        for k in p0:
            _close(tp[k].detach().numpy(), jp[k], rtol=0, atol=1e-6)
        if i == 0 and schedule:
            # optax's schedule at count 0: lr 0 on the first warmup update
            for k in p0:
                np.testing.assert_array_equal(tp[k].detach().numpy(), p0[k])
    # the schedule itself, count by count
    if schedule:
        jsched = optax.warmup_cosine_decay_schedule(
            0.0, 1e-2, 2, 6, 1e-3)
        for c in range(9):
            _close(lr_schedule(TrainConfig(**kw))(c), jsched(c), rtol=1e-6,
                   atol=1e-12)


def test_cosine_schedule_refuses_short_runs_like_optax():
    kw = dict(lr=1e-3, lr_schedule="cosine", warmup_steps=1000,
              max_iterations=400)
    with pytest.raises(ValueError, match="decay_steps"):
        j_make_optimizer(JTrainConfig(**kw))
    with pytest.raises(ValueError, match="decay_steps"):
        lr_schedule(TrainConfig(**kw))


def test_swa_average_equals_jax_formula():
    """The host loop's a + (p - a) / (n + 1) from swa_start every swa_freq
    steps (trainer.py), on a stream of parameter values."""
    from patchperpix_tpu_torch.train.trainer import _Run

    class Fake:
        tcfg = TrainConfig(use_swa=True, swa_start=2, swa_freq=3)

    rng = np.random.RandomState(9)
    params = [rng.randn(3, 4).astype(np.float32) for _ in range(12)]
    p = torch.nn.Parameter(torch.from_numpy(params[0].copy()))
    run = Fake()
    run.model = torch.nn.Module()
    run.model.w = p
    run.swa = {"w": p.detach().clone()}
    run.swa_n = 0
    a, n = jnp.asarray(params[0]), 0
    for step, v in enumerate(params[1:], start=1):
        with torch.no_grad():
            p.copy_(torch.from_numpy(v))
        _Run.swa_update(run, step)
        if step >= 2 and (step - 2) % 3 == 0:
            a = a + (jnp.asarray(v) - a) / (n + 1)
            n += 1
    assert run.swa_n == n == 4
    _close(run.swa["w"].numpy(), a, rtol=0, atol=1e-7)
