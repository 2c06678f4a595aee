"""The weight gradient of the U-Net's valid 3x3x3 convolutions
(``ops/conv_kernels.py``) and its route (``models/unet.py`` ``Conv3d``),
on the CPU.

The plain version against PyTorch's own weight gradient; the autograd
Function against ``nn.Conv3d``'s autograd (float64 ``gradcheck``, and
float32 at 1e-5 relative, both sides summing in float32 in another
order); which convolutions of a ``PPPModel`` take the route, with the
card's test replaced by a seam (``unet._on_card``) so that the route
runs on the host; the parameter names and the JAX weight tree; the
wrapper's checks and the launch plan.  The kernel itself runs in
``tests/test_torch_kernel_mock.py`` (host mock) and
``tests/test_torch_cuda.py`` (the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from parity.cases import WGRAD_SHAPES as SHAPES
from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.models import PPPConfig, PPPModel, unet
from patchperpix_tpu_torch.ops import conv_kernels as CK
from patchperpix_tpu_torch.utils import trace
from patchperpix_tpu_torch.utils.device import exact_f32

torch.set_num_threads(1)

# the published U-Net's convolutions with 128 or more channels on both
# sides, which stay on cuDNN
WIDE = {(180, 180), (180, 540), (540, 540), (396, 216), (216, 216)}


def _pair(N, Ci, Co, D, H, W, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, Ci, D, H, W), generator=g, dtype=dtype)
    dy = torch.randn((N, Co, D - 2, H - 2, W - 2), generator=g, dtype=dtype)
    return x, dy


@pytest.mark.parametrize("shape", [(1, 1, 1, 3, 3, 3), (2, 3, 5, 6, 5, 7),
                                   (1, 4, 2, 9, 4, 5)])
def test_plain_equals_torch_weight_gradient(shape):
    N, Ci, Co, D, H, W = shape
    x, dy = _pair(*shape)
    dw, db = CK.conv3d_wgrad_plain(x, dy)
    want = torch.nn.grad.conv3d_weight(x, (Co, Ci, 3, 3, 3), dy)
    torch.testing.assert_close(dw, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, dy.sum((0, 2, 3, 4)), rtol=1e-12,
                               atol=1e-12)
    assert CK.conv3d_wgrad(x, dy)[0].equal(dw)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("input_grad", [True, False])
def test_function_passes_gradcheck(bias, input_grad):
    x, _ = _pair(2, 2, 3, 4, 5, 4, seed=1)
    g = torch.Generator().manual_seed(2)
    w = torch.randn((3, 2, 3, 3, 3), generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(3, generator=g, dtype=torch.float64,
                    requires_grad=True) if bias else None
    x.requires_grad_(input_grad)
    assert torch.autograd.gradcheck(unet._HandWgrad.apply, (x, w, b))


def test_function_refuses_a_second_derivative():
    x, _ = _pair(1, 2, 2, 4, 4, 4)
    w = torch.randn((2, 2, 3, 3, 3), dtype=torch.float64,
                    requires_grad=True)
    x.requires_grad_(True)
    y = unet._HandWgrad.apply(x, w, None)
    gw, = torch.autograd.grad(y.square().sum(), w, create_graph=True)
    with pytest.raises(RuntimeError):
        gw.sum().backward()


@pytest.mark.parametrize("input_grad", [True, False])
def test_function_equals_conv3d_autograd(input_grad):
    """The same weights and input through nn.Conv3d's autograd and
    through the Function: the forward equal, each gradient within 1e-5
    of its largest value (float32 sums in another order)."""
    torch.manual_seed(3)
    ref = torch.nn.Conv3d(5, 7, 3)
    hand = unet.Conv3d(5, 7, 3)
    hand.load_state_dict(ref.state_dict())
    x0 = torch.randn(2, 5, 9, 8, 10)
    outs = []
    for mod, fn in ((ref, ref), (hand, lambda v: unet._HandWgrad.apply(
            v, hand.weight, hand.bias))):
        x = x0.clone().requires_grad_(input_grad)
        y = fn(x)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum() \
            .backward()
        outs.append((y.detach(), mod.weight.grad, mod.bias.grad,
                     x.grad if input_grad else None))
    (y0, w0, b0, g0), (y1, w1, b1, g1) = outs
    assert torch.equal(y0, y1)
    for a, b in ((w0, w1), (b0, b1), (g0, g1)):
        if a is None:
            assert b is None
            continue
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


# -- the route ------------------------------------------------------------------

def _small_cfg(**kw):
    """A 4-level valid 3D U-Net (14 valid 3x3x3 convolutions) of narrow
    widths, with the code decoder (five ConvPass convolutions)."""
    base = dict(patchshape=(5, 5, 5), num_channels=3, num_fmaps=2,
                fmap_inc_factors=(2, 2, 2), fmap_dec_factors=(1.0, 1.0, 1.0),
                downsample_factors=((2, 2, 2),) * 3, train_code=True,
                code_units=16, ae_code_fmaps=2, ae_num_fmaps=(4, 4),
                overlapping_inst=True, padding="valid")
    base.update(kw)
    return PPPConfig(**base)


SMALL_IN = 92     # the least input of that U-Net: its output is 4^3


def _counted_step(model, grad=True):
    """One forward of the U-Net, heads and decoder and, with ``grad``,
    its backward, inside a span under a profiler (the span opens a new
    session of counters), under bf16 autocast for a bf16 model as the
    trainer runs it: the route's counters."""
    gen = torch.Generator().manual_seed(0)
    raw = torch.rand(1, 3, SMALL_IN, SMALL_IN, SMALL_IN, generator=gen)
    codes = torch.rand(4, model.cfg.code_units, generator=gen)
    trace.summary()     # closes a session an earlier test left open
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("test.step"), torch.set_grad_enabled(grad), \
                torch.autocast("cpu", torch.bfloat16,
                               enabled=model.cfg.dtype == "bfloat16"):
            h1, h2 = model(raw)
            out = h1.float().sum() + h2.float().sum() \
                + model.decode(codes).float().sum()
            if grad:
                out.backward()
    return trace.summary()["counts"]


@pytest.fixture
def on_card(monkeypatch):
    """The route's device test answers yes for host tensors."""
    monkeypatch.setattr(unet, "_on_card", lambda x: True)


@pytest.mark.parametrize("case,hand,cudnn", [
    ("exact_f32", 14, 5), ("tf32_allowed", 0, 19), ("no_grad", 0, 0),
    ("bfloat16", 0, 19), ("host", 0, 19)])
def test_route_takes_the_unets_convolutions_only(monkeypatch, case, hand,
                                                 cudnn):
    """Of a code model's 3D ConvPass convolutions, the U-Net's 14 take the
    Function in exact-f32 training on the card; the decoder's five
    (1x1 and SAME) never do; TF32 allowed, no gradient, bfloat16 or a
    host tensor send all of them to nn.Conv3d."""
    if case != "host":
        monkeypatch.setattr(unet, "_on_card", lambda x: True)
    cfg = _small_cfg(dtype="bfloat16" if case == "bfloat16" else "float32")
    model = PPPModel(cfg)
    calls = []
    real = unet._HandWgrad.apply
    monkeypatch.setattr(unet._HandWgrad, "apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = case == "tf32_allowed"
        counts = _counted_step(model, grad=case != "no_grad")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert len(calls) == hand
    assert counts.get("conv.wgrad_hand", 0) == hand
    assert counts.get("conv.wgrad_cudnn", 0) == cudnn


def test_routed_step_equals_the_unrouted_step(on_card):
    """The same step with and without the route: every gradient leaf of
    the model within 1e-5 of its largest value."""
    torch.manual_seed(0)
    model = PPPModel(_small_cfg())
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    grads = []
    for allow in (False, True):     # TF32 allowed: nn.Conv3d throughout
        model.load_state_dict(sd)
        model.zero_grad(set_to_none=True)
        tf32 = torch.backends.cudnn.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = allow
            _counted_step(model)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for n, g in grads[1].items():
        err = float((grads[0][n] - g).abs().max())
        assert err <= 1e-5 * max(float(g.abs().max()), 1e-30), n


def test_route_at_published_widths_leaves_the_wide_convolutions(on_card):
    """The published FlyLight U-Net (20 / 60 / 180 / 540 maps, up factors
    1.2): nine of its 14 convolutions take the kernel; the five with both
    channel counts of 128 or more stay on cuDNN, and so do the decoder's
    convolutions, the heads and the transposed convolutions (not
    ``Conv3d``)."""
    cfg = PPPConfig(patchshape=(7, 7, 7), num_channels=3, num_fmaps=20,
                    fmap_inc_factors=(3, 3, 3),
                    fmap_dec_factors=(1.2, 1.2, 1.2),
                    downsample_factors=((2, 2, 2),) * 3, train_code=True,
                    code_units=176, ae_code_fmaps=22, ae_num_fmaps=(64, 128),
                    overlapping_inst=True, padding="valid")
    model = PPPModel(cfg)
    routed, kept = [], []
    with exact_f32():
        for name, m in model.named_modules():
            if isinstance(m, unet.Conv3d):
                x = torch.zeros(2, m.in_channels, 16, 16, 16)
                (routed if m.routed(x) else kept).append(
                    (name.split(".")[0], m.in_channels, m.out_channels))
            elif isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
                assert not name.startswith(("unet.ConvPass",
                                            "decoder.ConvPass")), name
    assert {n for n, _, _ in routed} == {"unet"}
    assert sorted((i, o) for _, i, o in routed) == sorted(
        (i, o) for i, o, _ in SHAPES if (i, o) not in WIDE)
    assert len(routed) == 9
    assert sorted((i, o) for n, i, o in kept if n == "unet") == sorted(WIDE)
    assert sum(n == "decoder" for n, _, _ in kept) == 5   # 1x1, 4 SAME
    assert CK.serves(20, 20, 138) and not CK.serves(180, 180, 30)


def test_2d_unet_keeps_nn_conv2d():
    cfg = PPPConfig(patchshape=(1, 7, 7), num_channels=1, num_fmaps=4,
                    fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                    downsample_factors=((1, 2, 2),))
    model = PPPModel(cfg)
    assert not any(isinstance(m, unet.Conv3d) for m in model.modules())
    assert isinstance(model.unet.ConvPass_0.Conv_0, torch.nn.Conv2d)


def test_state_dict_keys_and_the_jax_tree_are_unchanged():
    """The route's Conv3d keeps nn.Conv3d's parameter names: the Flax
    model's parameter tree loads strict, and gives the same forward."""
    kw = dict(patchshape=(5, 5, 5), num_channels=3, num_fmaps=2,
              fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
              downsample_factors=((2, 2, 2),), train_code=True,
              code_units=16, ae_code_fmaps=2, ae_num_fmaps=(4, 4),
              overlapping_inst=True, padding="valid")
    jm = JModel(JConfig(**kw))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 20, 20, 20)),
                     method=jm.full_init)
    model = weights.build_model(PPPConfig(**kw), params, device="cpu")
    assert isinstance(model.unet.ConvPass_0.Conv_0, unet.Conv3d)
    keys = set(model.state_dict())
    assert {"unet.ConvPass_0.Conv_0.weight", "unet.ConvPass_0.Conv_0.bias",
            "decoder.ConvPass_1.Conv_1.weight"} <= keys
    assert set(weights.to_state_dict(weights.from_state_dict(
        model.state_dict()))) == keys
    raw = np.random.RandomState(1).rand(1, 3, 20, 20, 20).astype(np.float32)
    with torch.no_grad():
        t1, _ = model(torch.from_numpy(raw))
    j1, _ = jm.apply(params, raw)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=1e-4,
                               rtol=1e-4)


# -- the wrapper ----------------------------------------------------------------

def test_wrapper_raises_on_what_the_kernel_does_not_take():
    x, dy = _pair(1, 2, 3, 5, 5, 5, dtype=torch.float32)
    with pytest.raises(ValueError, match="not CUDA"):
        CK.conv3d_wgrad_cuda(x, dy)
    with pytest.raises(ValueError, match="valid 3x3x3 output"):
        CK.conv3d_wgrad(x, dy[:, :, 1:])
    with pytest.raises(ValueError, match="5D"):
        CK.conv3d_wgrad(x[0], dy[0])
    with pytest.raises(ValueError):
        CK.conv3d_wgrad(x, dy.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        CK.conv3d_wgrad(x.to("meta"), dy.to("meta"))


@pytest.mark.parametrize("ci,co,e", SHAPES)
def test_plan_fits_and_covers_each_shape(ci, co, e):
    p = CK.make_plan(2, ci, co, e, e, e, 132)
    assert p is not None
    assert p.smem <= CK.SMEM_OPTIN and p.smem == CK._smem(p.config, p.P, e)
    assert p.P % 4 == 0 and p.xstr % 2 == 1 and p.dstr % 8 == 4
    assert p.xstr >= p.P + 2 * e + 2 and p.dstr >= p.P
    assert p.P * p.nchunk >= (e - 2) * e > p.P * (p.nchunk - 1)
    assert 1 <= p.splits <= 2 * p.nchunk * (e - 2)
    bm, bc = CK.tile(p.config)
    # the instance with the least padded work per issued FMA share
    padded = [-(-co // CK.tile(c)[0]) * CK.tile(c)[0]
              * -(-ci // CK.tile(c)[1]) * CK.tile(c)[1] / CK._ISSUE[c]
              for c in range(len(CK.CONFIGS))]
    assert padded[p.config] == min(padded)


def test_plan_refuses_rows_too_wide_for_shared_memory():
    assert CK.make_plan(1, 4, 4, 5, 5, 40000, 132) is None
    assert not CK.serves(4, 4, 40000)
    assert CK.serves(4, 4, 140)
