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


def _sparse_affs(shape, ps, seed, dev):
    """Noisy affinities of a few box instances filling about 15 % of the
    volume: the sparse foreground the 3D main path sees."""
    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities

    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int32)
    for i in range(1, 7):
        lo = [rng.randint(0, s - 4) for s in shape]
        hi = [min(s, a + rng.randint(5, max(6, s // 2))) for a, s in
              zip(lo, shape)]
        lab[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = i
    affs = labels_to_affinities(lab, np.array(ps))
    affs = np.clip(0.8 * affs + 0.2 * rng.rand(*affs.shape), 0, 1)
    return torch.from_numpy(affs.astype(np.float32)).to(dev), lab > 0


@pytest.mark.parametrize("shape", [(20, 24, 40), (9, 10, 37)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_plain_on_sparse_foreground(dev, shape, bf16):
    """The main path's shape class (7^3 patch, sparse foreground), also
    with an X that is no multiple of 32; the pack pass's scratch against
    its plain version; two launches give equal bits."""
    cfg = C.ConsensusConfig(patchshape=(7, 7, 7), patch_threshold=0.6,
                            cons_bf16=bf16)
    affs, fg = _sparse_affs(shape, (7, 7, 7), 5, dev)
    assert 0.05 < fg.mean() < 0.4
    hi, lo, _ = C._masks(affs, cfg)
    a, b = affs * hi, (1.0 - affs) * lo
    half, codes, targets, vals = K._consensus_launch(a, b, hi, lo, cfg)
    assert torch.equal(codes, K.pack_target_codes(hi, lo, cfg))
    assert torch.equal(targets, K.pack_codes(hi, lo, cfg)[2])
    any_bit = ((hi != 0) | (lo != 0)).movedim(0, -1)
    assert torch.equal(vals[0][any_bit], (a - b).movedim(0, -1)[any_bit])
    lo_bit = (lo != 0).movedim(0, -1)
    assert torch.equal(vals[1][lo_bit], b.movedim(0, -1)[lo_bit])
    want = C.consensus_half_plain(affs, hi, lo, cfg)
    assert float(want.float().abs().max()) > 0.1
    torch.testing.assert_close(half.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -7 if bf16 else 1e-4)
    assert torch.equal(half, K.consensus_half_cuda(a, b, hi, lo, cfg))
    acc = K.rank_acc_cuda(hi, lo, half, cfg)
    want = C.rank_acc_plain(hi, lo, half, cfg)
    assert float(want.abs().max()) > 1.0
    torch.testing.assert_close(acc, want, atol=1e-3, rtol=1e-4)
    assert torch.equal(acc, K.rank_acc_cuda(hi, lo, half, cfg))


@pytest.mark.parametrize("int_counter", [False, True])
def test_kernels_on_all_zero_masks(dev, int_counter):
    cfg = C.ConsensusConfig(patchshape=(3, 3, 3),
                            rank_int_counter=int_counter)
    shape = (6, 7, 40)
    z = torch.zeros((27,) + shape, device=dev)
    half = K.consensus_half_cuda(z, z, z, z, cfg)
    assert half.shape == (3, 5, 5) + shape and not half.any()
    acc = K.rank_acc_cuda(z, z, torch.randn(half.shape, device=dev), cfg)
    assert acc.shape == shape and not acc.any()


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


def _worm_operands(n_worms, seed, cfg, dev, W=201):
    """The 2D kernels' operands on a 120 x W worm image (5-pixel-wide
    worms, ideal affinities blended with noise): sparse foreground with a
    few worms, dense with many; overlaps on the crossings."""
    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     worm_labels)

    lab, cross = worm_labels(120, W, n_worms=n_worms, seed=seed,
                             with_crossings=True)
    affs = labels_to_affinities(lab, np.array(cfg.ps))
    rng = np.random.RandomState(seed)
    affs = np.clip(0.85 * affs + 0.15 * rng.rand(*affs.shape), 0, 1)
    ag, tgt = C.gated_stack_2d(
        torch.from_numpy(affs.astype(np.float32)).to(dev), cfg,
        torch.from_numpy(cross).to(dev))
    return ag, tgt, float((lab > 0).mean())


@pytest.mark.parametrize("n_worms,fg_range", [(3, (0.01, 0.1)),
                                              (40, (0.25, 0.7))])
@pytest.mark.parametrize("bf16,int_counter", [(False, False), (True, True)])
def test_kernels_2d_on_worm_images(dev, n_worms, fg_range, bf16,
                                   int_counter):
    """25x25 patches on sparse and dense worm foreground, W no multiple of
    32; the consensus kernel's scratch against its plain version; two
    launches of each kernel give equal bits."""
    cfg = C.ConsensusConfig(patchshape=(1, 25, 25), patch_threshold=0.5,
                            overlapping_inst=True, cons_bf16=bf16,
                            rank_int_counter=int_counter)
    ag, tgt, fg = _worm_operands(n_worms, 2, cfg, dev)
    assert fg_range[0] < fg < fg_range[1]
    half, idx, pix, G = K._consensus2d_launch(ag, tgt, cfg)
    want_idx, want_pix, want_G = K.pack_target_codes_2d(ag, tgt, cfg)
    assert torch.equal(idx, want_idx) and torch.equal(pix, want_pix)
    assert torch.equal(G, want_G)
    want = C.consensus_half_2d_plain(ag, tgt, cfg)
    assert float(want.float().abs().max()) > 0.1
    torch.testing.assert_close(half.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -7 if bf16 else 1e-4)
    assert torch.equal(half, K.consensus_half_2d_cuda(ag, tgt, cfg))
    acc = K.rank_acc_2d_cuda(ag, tgt, half, cfg)
    want = C.rank_acc_2d_plain(ag, tgt, half, cfg)
    assert float(want.abs().max()) > 1.0
    torch.testing.assert_close(acc, want, atol=1e-3, rtol=1e-4)
    assert torch.equal(acc, K.rank_acc_2d_cuda(ag, tgt, half, cfg))


@pytest.mark.parametrize("int_counter", [False, True])
def test_kernels_2d_on_empty_inputs(dev, int_counter):
    """All-sentinel stack (no eligible center) on a set target plane, and a
    gated stack on an empty target plane: zero half, zero sum."""
    cfg = C.ConsensusConfig(patchshape=(1, 25, 25),
                            rank_int_counter=int_counter)
    ag, tgt, _ = _worm_operands(3, 2, cfg, dev, W=150)
    sentinel = torch.full_like(ag, -1.0)
    no_target = torch.zeros_like(tgt)
    for a, t in ((sentinel, tgt), (ag, no_target)):
        half = K.consensus_half_2d_cuda(a, t, cfg)
        assert half.shape == (25, 49) + tuple(tgt.shape) and not half.any()
        acc = K.rank_acc_2d_cuda(a, t, torch.randn_like(half), cfg)
        assert acc.shape == tgt.shape and not acc.any()


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
