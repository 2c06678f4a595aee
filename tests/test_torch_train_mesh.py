"""Data-parallel training over a mesh: the port's step vs one device and vs
the JAX package's ``make_data_mesh`` step, on the CPU, float32.

The port's mesh is n CPU devices (``parallel/sharded.py``'s
``local_devices`` hook replaced), the JAX package's its virtual CPU
devices (``tests/conftest.py``).  The same seeded Flax parameters and the
same batch of 6 (which splits over 2 and 3 devices) go into the JAX
package's GSPMD step, the port's one-device step and the port's mesh
step; the code branch reads the JAX step's own corners.  Limits: the
mesh step within 1e-6 relative of the port's one-device step (loss parts
and per-leaf relative L2 of the gradients: the forward of each share is
the same arithmetic, only the gradient sums over shares run in another
order), and within ``test_torch_train_step.py``'s limits (1e-5) of the
JAX step.  Also: ``train_until`` over a mesh equals one device after two
Adam steps; the device sampler with a mesh raises, as in the JAX
package.
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
from patchperpix_tpu.train.trainer import make_data_mesh as j_data_mesh
from patchperpix_tpu.train.trainer import make_train_step as j_make_step
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.models import PPPConfig, PPPModel
from patchperpix_tpu_torch.parallel import sharded
from patchperpix_tpu_torch.train import trainer as T

torch.set_num_threads(1)
CPU = torch.device("cpu")
B, S, PS = 6, 8, 5


def _kw(code):
    return dict(patchshape=(PS,) * 3, num_channels=2, num_fmaps=4,
                fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                downsample_factors=((2, 2, 2),), train_code=code,
                code_units=16, ae_code_fmaps=2, ae_num_fmaps=(4, 8),
                num_code_samples=16, overlapping_inst=True, max_num_inst=2,
                padding="same")


def _batch():
    rng = np.random.RandomState(0)
    raw = rng.rand(B, 2, S, S, S).astype(np.float32)
    r = PS // 2
    labels = np.zeros((B, 2) + (S + 2 * r,) * 3, np.int32)
    labels[:, 0, 2:8, 3:9, 2:10] = 1
    labels[:, 1, 5:11, 4:10, 5:9] = 2
    labels[1, :, :, :6] = 0
    labels[4, :, 6:] = 0
    return raw, labels


def _grads_as_state():
    return optax.GradientTransformation(
        lambda p: p,
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_mesh_step(kw, n, raw, labels, key):
    cfg = JConfig(**kw)
    model = JModel(cfg)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(raw),
                        method=JModel.full_init)
    step, _ = j_make_step(model, cfg, JTrainConfig(), _grads_as_state(),
                          mesh=j_data_mesh(n, backend="cpu"))
    _, grads, mets = step(params, params, jnp.asarray(raw),
                          jnp.asarray(labels), key)
    corners = None
    if cfg.train_code:
        r = PS // 2
        ninst = (labels[:, :, r:-r, r:-r, r:-r] > 0).sum(1)
        corners = np.asarray(j_corners(key, jnp.asarray(ninst == 1),
                                       cfg.num_code_samples)[0])
    flat = lambda t: weights.flatten_tree(jax.tree.map(np.asarray, t))
    return flat(params), flat(grads), \
        {k: float(v) for k, v in mets.items()}, corners


def _port_step(kw, params, raw, labels, corners, mesh):
    model = PPPModel(PPPConfig(**kw))
    model.load_state_dict(weights.to_state_dict(params), strict=True)
    loss, mets = T.compute_losses(model, model.cfg, T.TrainConfig(),
                                  torch.from_numpy(raw),
                                  torch.from_numpy(labels), corners=corners,
                                  mesh=mesh)
    loss.backward()
    grads = {k: v.numpy() for k, v in weights.from_state_dict(
        {n: p.grad for n, p in model.named_parameters()}).items()}
    return {k: float(v) for k, v in mets.items()}, grads


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("n,code", [(2, False), (3, False), (2, True),
                                    (3, True)])
def test_mesh_step_equals_one_device_and_jax(n, code):
    kw = _kw(code)
    raw, labels = _batch()
    params, jgrads, jmets, corners = _jax_mesh_step(
        kw, n, raw, labels, jax.random.PRNGKey(5))
    mets1, grads1 = _port_step(kw, params, raw, labels, corners, None)
    mets, grads = _port_step(kw, params, raw, labels, corners, [CPU] * n)
    for k in ("loss", "loss_patch", "loss_fg"):
        np.testing.assert_allclose(mets[k], mets1[k], rtol=1e-6)
        np.testing.assert_allclose(mets[k], jmets[k], rtol=1e-5)
    assert set(grads) == set(grads1) == set(jgrads)
    for k in grads:
        assert _rel(grads[k], grads1[k]) <= 1e-6, k
        assert _rel(grads[k], jgrads[k]) <= 1e-5, k


def test_mesh_needs_a_batch_that_splits():
    model = PPPModel(PPPConfig(**_kw(False)))
    with pytest.raises(ValueError, match="does not split"):
        T.forward_heads(model, model.cfg, torch.zeros(5, 2, S, S, S),
                        [CPU] * 2)


class _Fixed:
    """A prefetcher that hands out the same batch."""

    def __init__(self, raw, labels):
        self.b = (raw, labels)

    def next(self):
        return self.b


def test_train_until_over_a_mesh_equals_one_device(tmp_path, monkeypatch):
    monkeypatch.setattr(sharded, "local_devices",
                        lambda kind="cuda": [CPU] * 3)
    mesh = T.make_data_mesh(3, kind="cpu")
    assert mesh == [CPU] * 3
    raw, labels = _batch()
    cfg = PPPConfig(**_kw(False))
    states = []
    for name, m in (("one", None), ("mesh", mesh)):
        tcfg = T.TrainConfig(max_iterations=2, checkpoints=2, snapshots=0,
                             lr=1e-3, tensorboard=False,
                             output_folder=str(tmp_path / name))
        states.append(T.train_until(PPPModel(cfg), cfg, tcfg,
                                    _Fixed(raw, labels), device="cpu",
                                    mesh=m))
    one, dp = states
    assert dp["step"] == one["step"] == 2
    for k, v in one["params"].items():
        np.testing.assert_allclose(dp["params"][k], v, rtol=1e-5,
                                   atol=1e-7)


def test_device_sampler_with_a_mesh_raises(tmp_path):
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    cfg = PPPConfig(**_kw(False))
    sampler = DeviceSampler.__new__(DeviceSampler)
    with pytest.raises(ValueError, match="data-parallel mesh"):
        T.train_until(PPPModel(cfg), cfg,
                      T.TrainConfig(output_folder=str(tmp_path)), sampler,
                      device="cpu", mesh=[CPU] * 2)
