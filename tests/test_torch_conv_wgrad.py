"""The weight gradients of the training step's 3D convolutions
(``ops/conv_kernels.py``: W1 for the valid and SAME 3x3x3 ones, W2 for
the pointwise ones and the transposed ones with kernel = stride) and
their routes (``models/unet.py`` ``Conv3d``, ``ConvTranspose3d``), on the
CPU.

The plain versions against PyTorch's own weight gradient; the autograd
Functions against ``nn.Conv3d`` / ``nn.ConvTranspose3d``'s autograd
(float64 ``gradcheck``, and float32 at 1e-5 relative, both sides summing
in float32 in another order); which convolutions of a ``PPPModel`` take
which route, with the card's test replaced by a seam (``unet._on_card``)
so that the routes run on the host; the parameter names and the JAX
weight tree; the wrappers' checks and the launch plans.  The kernels
themselves run in ``tests/test_torch_kernel_mock.py`` (host mock) and
``tests/test_torch_cuda.py`` (the card).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchperpix_tpu.models import PPPConfig as JConfig
from patchperpix_tpu.models import PPPModel as JModel
from parity.cases import GEMM_SHAPES
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


@pytest.mark.parametrize("case,hand,cudnn,up_hand,up_cudnn", [
    ("exact_f32", 19, 0, 7, 0), ("tf32_allowed", 0, 19, 0, 7),
    ("no_grad", 0, 0, 0, 0), ("bfloat16", 0, 19, 0, 7),
    ("host", 0, 19, 0, 7)])
def test_route_takes_the_unets_convolutions_only(monkeypatch, case, hand,
                                                 cudnn, up_hand, up_cudnn):
    """Of a code model's 19 3D ConvPass convolutions, in exact-f32
    training on the card, the 18 3x3x3 ones take W1 (the U-Net's 14 valid
    ones, the decoder's SAME 4 -> 4 and 1 -> 1 pairs: narrow enough for
    W1 on rows of 6 too) and the decoder's pointwise ConvPass_0
    takes W2.  All 7 head and upsampling convolutions (2 heads, 3
    transposed, the decoder's 2 pointwise) take W2.  TF32 allowed, no gradient, bfloat16
    or a host tensor send every one of them to PyTorch's convolution."""
    if case != "host":
        monkeypatch.setattr(unet, "_on_card", lambda x: True)
    cfg = _small_cfg(dtype="bfloat16" if case == "bfloat16" else "float32")
    model = PPPModel(cfg)
    calls = {"W1": 0, "W2": 0}
    for fn, key in ((unet._HandWgrad, "W1"), (unet._GemmWgrad, "W2")):
        monkeypatch.setattr(fn, "apply", functools.partial(
            lambda real, key, *a: calls.__setitem__(key, calls[key] + 1)
            or real(*a), fn.apply, key))
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = case == "tf32_allowed"
        counts = _counted_step(model, grad=case != "no_grad")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert calls == ({"W1": 18, "W2": 8} if hand else {"W1": 0, "W2": 0})
    assert counts.get("conv.wgrad_hand", 0) == hand
    assert counts.get("conv.wgrad_cudnn", 0) == cudnn
    assert counts.get("conv.head_up_wgrad_hand", 0) == up_hand
    assert counts.get("conv.head_up_wgrad_cudnn", 0) == up_cudnn


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
    """The published FlyLight ppp+dec model (20 / 60 / 180 / 540 maps, up
    factors 1.2, decoder 64 / 128) at the cell's extents: nine of the
    U-Net's 14 convolutions take W1, the five with both channel counts of
    128 or more stay on cuDNN; of the decoder's ConvPass convolutions the
    pointwise ConvPass_0 takes W2, the SAME 1 -> 1 pair on 8^3 W1, and the
    SAME 64 -> 64 pair on 4^3 stays on cuDNN (12 of 19 routed); the two
    heads, the decoder's two pointwise upsampling convolutions and the
    U-Net's three transposed convolutions take W2 (7 of 7)."""
    cfg = PPPConfig(patchshape=(7, 7, 7), num_channels=3, num_fmaps=20,
                    fmap_inc_factors=(3, 3, 3),
                    fmap_dec_factors=(1.2, 1.2, 1.2),
                    downsample_factors=((2, 2, 2),) * 3, train_code=True,
                    code_units=176, ae_code_fmaps=22, ae_num_fmaps=(64, 128),
                    overlapping_inst=True, padding="valid")
    model = PPPModel(cfg)
    # input extent and batch of each convolution in the cell's step
    extent = {(ci, co): (e, 2) for ci, co, e in SHAPES}
    extent.update({(ci, co): (e, n) for ci, co, e, n, _ in GEMM_SHAPES})
    extent.update({(64, 64): (4, 2048), (1, 1): (8, 2048)})
    routes = {"W1": [], "W2": [], None: []}
    with exact_f32():
        for name, m in model.named_modules():
            if isinstance(m, (unet.Conv3d, unet.ConvTranspose3d)):
                e, n = extent[(m.in_channels, m.out_channels)]
                x = torch.zeros(1).expand(n, m.in_channels, e, e, e)
                routes[m.route(x)].append((
                    name, m.in_channels, m.out_channels,
                    getattr(m, "counter", unet.HEAD_UP_COUNTER)))
            elif isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
                raise AssertionError(f"{name} is not a routed class")
    unet_w1 = [(i, o) for n, i, o, _ in routes["W1"]
               if n.startswith("unet.")]
    assert sorted(unet_w1) == sorted(
        (i, o) for i, o, _ in SHAPES if (i, o) not in WIDE)
    assert sorted((n, i, o) for n, i, o, _ in routes["W1"]
                  if not n.startswith("unet.")) == [
        ("decoder.ConvPass_2.Conv_0", 1, 1),
        ("decoder.ConvPass_2.Conv_1", 1, 1)]
    assert sorted((n, i, o) for n, i, o, _ in routes[None]) == sorted(
        [(n, i, o) for n, i, o, _ in routes[None] if n.startswith("unet.")]
        + [("decoder.ConvPass_1.Conv_0", 64, 64),
           ("decoder.ConvPass_1.Conv_1", 64, 64)])
    assert sorted((i, o) for n, i, o, _ in routes[None]
                  if n.startswith("unet.")) == sorted(WIDE)
    assert sorted(n for n, _, _, _ in routes["W2"]) == [
        "decoder.ConvPass_0.Conv_0", "decoder.Upsample_0.Conv_0",
        "decoder.Upsample_1.Conv_0", "head_code_affs", "head_fgbg_numinst",
        "unet.Upsample_0.ConvTranspose_0", "unet.Upsample_1.ConvTranspose_0",
        "unet.Upsample_2.ConvTranspose_0"]
    counters = [c for r in routes.values() for _, _, _, c in r]
    assert counters.count("conv.wgrad") == 19
    assert counters.count("conv.head_up_wgrad") == 7
    assert sum(c == "conv.wgrad" for _, _, _, c in routes["W1"]
               + routes["W2"]) == 12
    assert CK.serves(20, 20, 138) and not CK.serves(180, 180, 30)
    assert CK.serves(1, 1, 10) and not CK.serves(64, 64, 6)
    # rows of 5 to 8 values: W1 below 512 channel pairs only
    assert CK.serves(16, 16, 6) and CK.serves(4, 4, 6) \
        and CK.serves(16, 16, 8)
    assert not CK.serves(16, 32, 8) and not CK.serves(16, 64, 6) \
        and not CK.serves(32, 32, 5)
    assert CK.serves(64, 64, 4) and CK.serves(32, 32, 10) \
        and CK.serves(64, 64, 12)


def test_2d_unet_keeps_nn_conv2d():
    cfg = PPPConfig(patchshape=(1, 7, 7), num_channels=1, num_fmaps=4,
                    fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                    downsample_factors=((1, 2, 2),))
    model = PPPModel(cfg)
    assert not any(isinstance(m, unet.Conv3d) for m in model.modules())
    assert isinstance(model.unet.ConvPass_0.Conv_0, torch.nn.Conv2d)
    assert type(model.head_code_affs) is torch.nn.Conv2d
    assert type(model.head_fgbg_numinst) is torch.nn.Conv2d
    assert type(model.unet.Upsample_0.ConvTranspose_0) is \
        torch.nn.ConvTranspose2d


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
    assert isinstance(model.head_code_affs, unet.Conv3d)
    assert isinstance(model.decoder.Upsample_0.Conv_0, unet.Conv3d)
    assert isinstance(model.unet.Upsample_0.ConvTranspose_0,
                      unet.ConvTranspose3d)
    keys = set(model.state_dict())
    assert {"unet.ConvPass_0.Conv_0.weight", "unet.ConvPass_0.Conv_0.bias",
            "decoder.ConvPass_1.Conv_1.weight", "head_code_affs.weight",
            "head_fgbg_numinst.bias", "decoder.Upsample_1.Conv_0.weight",
            "unet.Upsample_0.ConvTranspose_0.weight"} <= keys
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


# -- W2: pointwise and kernel = stride convolutions --------------------------

def _gemm_pair(N, Ci, Co, e, f, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((N, Ci, e, e, e), generator=g, dtype=dtype)
    dy = torch.randn((N, Co) + (f * e,) * 3, generator=g, dtype=dtype)
    return x, dy


@pytest.mark.parametrize("N,Ci,Co,e,f", [
    (1, 3, 5, 4, 1), (2, 24, 7, 3, 1), (64, 6, 2, 2, 1), (2, 5, 3, 3, 2),
    (1, 4, 6, 2, 2), (64, 3, 2, 1, 2)])
def test_gemm_plain_equals_torch_weight_gradient(N, Ci, Co, e, f):
    """W2's plain version through the pointwise and transposed helpers
    against PyTorch: ``conv3d_weight`` for a 1x1x1 convolution, the
    autograd of ``nn.ConvTranspose3d`` with kernel = stride = 2 (positions
    S down to 8, or 1 for the transposed one's input)."""
    x, dy = _gemm_pair(N, Ci, Co, e, f)
    if f == 1:
        dw, db = CK.conv1_wgrad(x, dy)
        want = torch.nn.grad.conv3d_weight(x, (Co, Ci, 1, 1, 1), dy)
        want_b = dy.sum((0, 2, 3, 4))
    else:
        dw, db = CK.conv_t_wgrad(x, dy, (f,) * 3)
        ref = torch.nn.ConvTranspose3d(Ci, Co, f, stride=f).double()
        (ref(x) * dy).sum().backward()
        want, want_b = ref.weight.grad, ref.bias.grad
    torch.testing.assert_close(dw, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, want_b, rtol=1e-12, atol=1e-12)
    a = dy.reshape(N, Co, -1) if f == 1 else CK.tap_rows(dy, (f,) * 3)
    assert CK.conv_wgrad_gemm(a, x.reshape(N, Ci, -1))[0].equal(
        CK.conv_wgrad_gemm_plain(a, x.reshape(N, Ci, -1))[0])


def _gemm_weight(Ci, Co, f, seed=2):
    g = torch.Generator().manual_seed(seed)
    shape = (Co, Ci, 1, 1, 1) if f == 1 else (Ci, Co, f, f, f)
    return torch.randn(shape, generator=g, dtype=torch.float64,
                       requires_grad=True)


@pytest.mark.parametrize("f", [1, 2])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("input_grad", [True, False])
def test_gemm_function_passes_gradcheck(f, bias, input_grad):
    x, _ = _gemm_pair(2, 3, 4, 3, f, seed=1)
    w = _gemm_weight(3, 4, f)
    b = torch.randn(4, dtype=torch.float64, requires_grad=True) \
        if bias else None
    x.requires_grad_(input_grad)
    assert torch.autograd.gradcheck(
        lambda x, w, b: unet._GemmWgrad.apply(x, w, b, (f,) * 3),
        (x, w, b))


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("input_grad", [True, False])
def test_same_function_passes_gradcheck(bias, input_grad):
    x, _ = _pair(2, 2, 3, 4, 5, 4, seed=1)
    g = torch.Generator().manual_seed(2)
    w = torch.randn((3, 2, 3, 3, 3), generator=g, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(3, generator=g, dtype=torch.float64,
                    requires_grad=True) if bias else None
    x.requires_grad_(input_grad)
    assert torch.autograd.gradcheck(
        lambda x, w, b: unet._HandWgrad.apply(x, w, b, 1), (x, w, b))


@pytest.mark.parametrize("route", ["same", "pointwise", "transposed"])
def test_new_functions_refuse_a_second_derivative(route):
    x, _ = _gemm_pair(1, 2, 2, 4, 1)
    x.requires_grad_(True)
    if route == "same":
        w = torch.randn((2, 2, 3, 3, 3), dtype=torch.float64,
                        requires_grad=True)
        y = unet._HandWgrad.apply(x, w, None, 1)
    else:
        f = 1 if route == "pointwise" else 2
        w = _gemm_weight(2, 2, f)
        y = unet._GemmWgrad.apply(x, w, None, (f,) * 3)
    gw, = torch.autograd.grad(y.square().sum(), w, create_graph=True)
    with pytest.raises(RuntimeError):
        gw.sum().backward()


def _against_autograd(ref, hand, x0):
    """The same module weights and input through ``ref``'s autograd and
    through ``hand`` routed (the seam on, TF32 off): the forward equal,
    each gradient within 1e-5 of its largest value."""
    hand.load_state_dict(ref.state_dict())
    outs = []
    for mod in (ref, hand):
        x = x0.clone().requires_grad_(True)
        with exact_f32():
            y = mod(x)
            (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum() \
                .backward()
        outs.append((y.detach(), mod.weight.grad, mod.bias.grad, x.grad))
    (y0, *g0), (y1, *g1) = outs
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


@pytest.mark.parametrize("kind", ["same", "pointwise", "transposed"])
def test_routes_equal_torch_autograd(on_card, monkeypatch, kind):
    """A SAME 3x3x3, a pointwise and a kernel = stride transposed
    convolution, each routed (counted by the kernels' helpers), against
    ``nn.Conv3d`` / ``nn.ConvTranspose3d`` autograd in float32."""
    torch.manual_seed(3)
    calls = []
    for name in ("conv3d_wgrad", "conv1_wgrad", "conv_t_wgrad"):
        monkeypatch.setattr(unet, name, functools.partial(
            lambda real, name, *a: calls.append(name) or real(*a),
            getattr(unet, name), name))
    if kind == "same":
        ref, hand = torch.nn.Conv3d(5, 7, 3, padding=1), \
            unet.Conv3d(5, 7, 3, padding=1)
        x0, want = torch.randn(2, 5, 9, 8, 10), "conv3d_wgrad"
    elif kind == "pointwise":
        ref, hand = torch.nn.Conv3d(6, 4, 1), unet.Conv3d(6, 4, 1)
        x0, want = torch.randn(3, 6, 5, 4, 7), "conv1_wgrad"
    else:
        ref = torch.nn.ConvTranspose3d(6, 4, 2, stride=2)
        hand = unet.ConvTranspose3d(6, 4, 2, stride=2)
        x0, want = torch.randn(2, 6, 3, 4, 5), "conv_t_wgrad"
    _against_autograd(ref, hand, x0)
    assert calls == [want]


def test_swin_model_routes_its_heads_only():
    """A Swin model keeps its own nn.Conv3d / nn.ConvTranspose3d; only its
    two heads are the routed class."""
    cfg = PPPConfig(patchshape=(3, 3, 3), num_channels=1, num_fmaps=8,
                    network_style="swinunetr",
                    downsample_factors=((2, 2, 2),) * 2)
    model = PPPModel(cfg, input_shape=(16, 16, 16))
    routed = [n for n, m in model.named_modules()
              if isinstance(m, (unet.Conv3d, unet.ConvTranspose3d))]
    assert routed == ["head_code_affs", "head_fgbg_numinst"]
    assert any(type(m) is torch.nn.ConvTranspose3d
               for m in model.unet.modules())


def test_gemm_wrapper_raises_on_what_the_kernel_does_not_take():
    a, b = torch.zeros(2, 3, 8), torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        CK.conv_wgrad_gemm_cuda(a, b)
    with pytest.raises(ValueError, match="batch or positions"):
        CK.conv_wgrad_gemm(a, b[:, :, 1:])
    with pytest.raises(ValueError, match="batch or positions"):
        CK.conv_wgrad_gemm(a, b[:1])
    with pytest.raises(ValueError, match="3D"):
        CK.conv_wgrad_gemm(a[0], b[0])
    with pytest.raises(ValueError):
        CK.conv_wgrad_gemm(a, b.double())
    with pytest.raises(ValueError, match="no kernel for device"):
        CK.conv_wgrad_gemm(a.to("meta"), b.to("meta"))


@pytest.mark.parametrize("ci,co,e,n,f", GEMM_SHAPES)
def test_gemm_plan_fits_each_shape(ci, co, e, n, f):
    """The plan at each W2 shape of the cell on 132 SMs: an instance whose
    MINB CTAs fit in the opt-in shared memory, and shares that each hold a
    chunk."""
    M, K, S = co * f ** 3, ci, e ** 3
    p = CK.gemm_plan(n, M, K, S, 132)
    chunks = -(-n * S // CK.GEMM_KC)
    assert 1 <= p.splits <= chunks
    minb = CK.GEMM_CONFIGS[p.config][4]
    assert minb * (CK.gemm_smem(p.config) + 1024) <= CK.SMEM_OPTIN
    for c in range(len(CK.GEMM_CONFIGS)):
        assert CK.gemm_smem(c) * CK.GEMM_CONFIGS[c][4] <= CK.SMEM_OPTIN
    assert p.seconds > 0


@pytest.mark.parametrize("counts,want", [
    ({"conv.head_up_wgrad_hand": 7}, 1.0),
    ({"conv.head_up_wgrad_hand": 3, "conv.head_up_wgrad_cudnn": 1}, 0.75),
    ({"conv.head_up_wgrad_cudnn": 7, "conv.wgrad_hand": 9}, 0.0),
    ({"conv.wgrad_hand": 9}, None), ({}, None)])
def test_head_up_metric_reads_the_counters(monkeypatch, counts, want):
    """The benchmark's ``head_up_wgrad_hand_ratio.train`` reader: the
    hand-routed share of the head and upsampling convolutions' counts,
    nothing where the program counted none."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "portbench", "metrics",
        "head_up_wgrad_hand_ratio.train.py")
    spec = importlib.util.spec_from_file_location("head_up_metric", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    monkeypatch.setattr(trace, "summary", lambda: {"counts": counts})
    assert reader.read(None) == want
