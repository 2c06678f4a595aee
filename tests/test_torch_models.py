"""Port's models + weights.py vs the Flax models, float32 on the CPU.

Tolerance 1e-4 (absolute and relative): both sides compute in float32
with different convolution algorithms, so sums round in another order.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.models import PPPConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrow(padding, upsampling="trans_conv"):
    return dict(patchshape=(7, 7, 7), num_channels=3, num_fmaps=4,
                fmap_inc_factors=(2, 3), fmap_dec_factors=(1.0, 1.5),
                downsample_factors=((2, 2, 2), (2, 2, 2)), kernel_size=3,
                num_repetitions=2, padding=padding, upsampling=upsampling,
                overlapping_inst=True, max_num_inst=2, train_code=True,
                code_units=176, ae_code_fmaps=22, ae_num_fmaps=(6, 8))


def _random_params(jm, size, seed):
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 3) + (size,) * 3), method=jm.full_init)
    rng = np.random.RandomState(seed)
    # perturb every leaf (Flax zero-initializes biases)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
            np.float32), params)


@pytest.mark.parametrize("padding,size,upsampling", [
    ("same", 16, "trans_conv"), ("valid", 44, "trans_conv"),
    ("same", 16, "resize_conv")])
def test_forward_and_decoder_match_flax(padding, size, upsampling):
    kw = _narrow(padding, upsampling)
    jm = JModel(JConfig(**kw))
    params = _random_params(jm, size, seed=3)
    model = weights.build_model(PPPConfig(**kw), params, device="cpu")
    raw = np.random.RandomState(4).rand(2, 3, size, size, size).astype(
        np.float32)
    j1, j2 = jm.apply(params, raw)
    with torch.no_grad():
        t1, t2 = model(torch.from_numpy(raw))
    assert t1.shape == j1.shape and t2.shape == j2.shape
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), atol=1e-4,
                               rtol=1e-4)
    codes = np.random.RandomState(5).rand(6, 176).astype(np.float32)
    jd = jm.apply(params, codes, method=JModel.decode)
    with torch.no_grad():
        td = model.decode(torch.from_numpy(codes))
    assert td.shape == jd.shape == (6, 7, 7, 7)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-4,
                               rtol=1e-4)


def test_conv_transpose_needs_the_flip():
    """Without the spatial flip the transposed conv disagrees: the test
    above would catch a converter that skipped it."""
    from flax import linen as nn

    rng = np.random.RandomState(0)
    x = rng.rand(1, 3, 3, 3, 2).astype(np.float32)
    layer = nn.ConvTranspose(4, (2, 2, 2), strides=(2, 2, 2),
                             padding="VALID")
    p = layer.init(jax.random.PRNGKey(0), x)
    p = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), p)
    want = np.asarray(layer.apply(p, x))
    sd = weights.to_state_dict({"ConvTranspose_0": p["params"]})
    conv = torch.nn.ConvTranspose3d(2, 4, 2, stride=2)
    conv.weight.data = sd["ConvTranspose_0.weight"]
    conv.bias.data = sd["ConvTranspose_0.bias"]
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    conv.weight.data = sd["ConvTranspose_0.weight"].flip((2, 3, 4))
    with torch.no_grad():
        bad = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert np.abs(bad.permute(0, 2, 3, 4, 1).numpy() - want).max() > 1e-2


def test_committed_npz_equals_orbax_checkpoint():
    import bench

    jm, jcfg = bench.crop_model()
    want = weights.flatten_tree(bench.load_trained_params(jm, jcfg))
    got = weights.load_npz(os.path.join(REPO, "parity",
                                        "bench_ckpt_params.npz"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert sum(v.size for v in got.values()) == 1965572


def test_trained_state_dict_loads_strict():
    cfg = PPPConfig(**{**_narrow("same"), "num_fmaps": 20,
                       "fmap_inc_factors": (3, 3),
                       "fmap_dec_factors": (1.0, 1.0),
                       "ae_num_fmaps": (64, 128)})
    model = weights.build_model(cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == 1965572
