"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
on the GPU machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: consensus 1e-4 absolute and relative, rank 1e-3 absolute /
1e-4 relative (the JAX package's own kernel tolerances).
"""

import numpy as np
import pytest
import torch

from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K

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
    hi, lo, _ = C._masks(affs, cfg, ov)
    n0 = K.CONSENSUS.launches
    half = K.consensus_half(affs, hi, lo, cfg)
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
