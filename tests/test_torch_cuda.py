"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
on the GPU machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: consensus 1e-4 absolute and relative, rank 1e-3 absolute /
1e-4 relative (the JAX package's own kernel tolerances, 3D and 2D); a bf16
half within one rounding step of the stored type (2^-7 relative); the
row-window probe 1e-4 absolute.
"""

import numpy as np
import pytest
import torch

from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
from patchperpix_tpu_torch.ops import probe as PR

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _affs(shape, P, seed, dev):
    rng = np.random.RandomState(seed)
    a = rng.rand(P, *shape).astype(np.float32)
    a = np.where(a > 0.5, 0.6 + 0.4 * a, 0.4 * a).astype(np.float32)
    return torch.from_numpy(a).to(dev)


@pytest.mark.parametrize("ps,shape,kw", [
    ((3, 3, 3), (8, 9, 10), {}),
    ((3, 3, 3), (8, 9, 10), {"overlapping_inst": True,
                             "rank_int_counter": True}),
    ((1, 5, 3), (7, 11, 9), {}),
    ((3, 3, 3), (8, 9, 10), {"weight_mode": "count", "norm_aff": False}),
    ((3, 3, 3), (8, 9, 10), {"weight_mode": "prob_product"}),
    ((3, 3, 3), (8, 9, 10), {"cons_bf16": True}),
    ((7, 7, 7), (16, 18, 20), {"patch_threshold": 0.6}),
])
def test_kernels_match_plain(dev, ps, shape, kw):
    cfg = C.ConsensusConfig(patchshape=ps, **kw)
    affs = _affs(shape, cfg.P, 3, dev)
    ov = torch.zeros(shape, dtype=torch.bool, device=dev)
    ov[3:5, 3:6, 2:5] = True
    hi, lo, tgt = C._masks(affs, cfg, ov)
    n0 = K.CONSENSUS.launches
    half = K.consensus_half(affs, (hi, lo, tgt), cfg)
    assert K.CONSENSUS.launches == n0 + 1
    want = C.consensus_half_plain(affs, hi, lo, cfg)
    assert half.dtype == want.dtype and half.shape == want.shape
    torch.testing.assert_close(half.float(), want.float(), atol=1e-4,
                               rtol=1e-4)
    n0 = K.RANK.launches
    acc = K.rank_acc_cuda(hi, lo, half, cfg)
    assert K.RANK.launches == n0 + 1
    torch.testing.assert_close(acc, C.rank_acc_plain(hi, lo, half, cfg),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("int_counter", [False, True])
def test_rank_kernel_matches_plain_on_border_centers(dev, int_counter):
    """Masks that are nonzero at border centers, whose patch pixels read
    the consensus outside the volume (zero there, which the int_counter
    variant still counts)."""
    rng = np.random.RandomState(0)
    ps, shape = (3, 3, 3), (6, 7, 8)
    cfg = C.ConsensusConfig(patchshape=ps, rank_int_counter=int_counter)
    hi = torch.from_numpy((rng.rand(27, *shape) > 0.6).astype(np.float32))
    lo = torch.from_numpy((rng.rand(27, *shape) > 0.7).astype(np.float32))
    lo = lo * (1 - hi)
    half = torch.from_numpy(rng.randn(3, 5, 5, *shape).astype(np.float32))
    half[:, :, :, 2] = 0
    hi, lo, half = hi.to(dev), lo.to(dev), half.to(dev)
    torch.testing.assert_close(K.rank_acc_cuda(hi, lo, half, cfg),
                               C.rank_acc_plain(hi, lo, half, cfg),
                               atol=1e-3, rtol=1e-4)


def test_wrappers_check_inputs(dev):
    cfg = C.ConsensusConfig(patchshape=(3, 3, 3))
    affs = _affs((6, 6, 6), 27, 0, dev)
    hi, lo, _ = C._masks(affs, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        K.consensus_half_cuda(affs, affs, hi.transpose(1, 2), lo, cfg)
    with pytest.raises(ValueError, match="float32"):
        K.consensus_half_cuda(affs.double(), affs, hi, lo, cfg)
    with pytest.raises(ValueError, match="consensus half"):
        K.rank_acc_cuda(hi, lo, torch.zeros(2, 5, 5, 6, 6, 6, device=dev),
                        cfg)


@pytest.mark.parametrize("p,shape,kw", [
    (5, (1, 11, 15), {}),
    (5, (1, 13, 40), {"overlapping_inst": True, "rank_int_counter": True}),
    (3, (1, 9, 35), {"weight_mode": "count", "norm_aff": False}),
    (5, (1, 11, 15), {"weight_mode": "prob_product"}),
    (5, (1, 21, 70), {"cons_bf16": True}),
    (7, (1, 26, 17), {"bg_mode": "half", "patch_threshold": 0.6}),
    (25, (1, 40, 56), {"patch_threshold": 0.6}),
    (25, (1, 64, 133), {"overlapping_inst": True, "cons_bf16": True}),
])
def test_kernels_2d_match_plain(dev, p, shape, kw):
    cfg = C.ConsensusConfig(patchshape=(1, p, p), **kw)
    affs = _affs(shape, cfg.P, 3, dev)
    ov = torch.zeros(shape, dtype=torch.bool, device=dev)
    ov[0, 5:9, 3:7] = True
    cv = torch.ones(shape, dtype=torch.bool, device=dev)
    cv[0, :, :3] = False
    ops = K.consensus_operands(affs, cfg, ov, cv)
    ag, tgt = ops
    n0 = K.CONSENSUS2D.launches
    half = K.consensus_half(affs, ops, cfg)
    assert K.CONSENSUS2D.launches == n0 + 1
    want = C.consensus_half_2d_plain(ag, tgt, cfg)
    assert half.dtype == want.dtype and half.shape == want.shape
    assert float(want.float().abs().max()) > 0.1
    torch.testing.assert_close(half.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -7 if cfg.cons_bf16 else 1e-4)
    assert not half[0, :p].any()        # canonical gate at d == 0
    for s_half in (half, torch.randn(half.shape, device=dev).to(half.dtype)):
        n0 = K.RANK2D.launches
        acc = K.rank_acc_2d_cuda(ag, tgt, s_half, cfg)
        assert K.RANK2D.launches == n0 + 1
        torch.testing.assert_close(
            acc, C.rank_acc_2d_plain(ag, tgt, s_half, cfg), atol=1e-3,
            rtol=1e-4)
    n0 = K.RANK2D.launches
    scores = K.rank_scores(affs, half, ops, cfg)
    assert K.RANK2D.launches == n0 + 1 and tuple(scores.shape) == shape


def test_wrappers_2d_check_inputs(dev):
    cfg = C.ConsensusConfig(patchshape=(1, 5, 5))
    affs = _affs((1, 12, 14), 25, 0, dev)
    ag, tgt = C.gated_stack_2d(affs, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        K.consensus_half_2d_cuda(ag.transpose(1, 2), tgt.T, cfg)
    with pytest.raises(ValueError, match="target plane"):
        K.consensus_half_2d_cuda(ag, tgt[None], cfg)
    with pytest.raises(ValueError, match="consensus half"):
        K.rank_acc_2d_cuda(ag, tgt, torch.zeros(5, 9, 12, 15, device=dev),
                           cfg)
    with pytest.raises(ValueError, match="square odd 2D"):
        K.consensus_half_2d_cuda(ag, tgt,
                                 C.ConsensusConfig(patchshape=(3, 3, 3)))


@pytest.mark.parametrize("mode,n_slab,W", PR.CASES)
def test_probe_kernel_matches_plain(dev, mode, n_slab, W):
    x = torch.from_numpy(np.random.RandomState(0).rand(
        8, PR.V, W).astype(np.float32)).to(dev)
    n0 = PR.PROBE.launches
    got = PR.probe_window(x, n_slab, mode)
    assert PR.PROBE.launches == n0 + 1
    assert tuple(got.shape) == (8 - n_slab + 1, PR.V, W)
    assert float((got - PR.probe_window_plain(x, n_slab)).abs().max()) < 1e-4
