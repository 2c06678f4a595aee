"""Plain versions of the port's 2D consensus, rank and probe kernels vs the
JAX package (XLA scan, and the 2D Pallas kernels in interpret mode).

The same seeded numpy affinities go through both.  Tolerances are the JAX
package's own for its 2D kernels (tests/test_pallas_2d.py): consensus 1e-4
absolute and relative, rank 1e-3 absolute / 1e-4 relative (float32 sums in
another order); with a bf16 half 5e-3 / 2e-2 and 5e-2 / 2e-2 (bf16 keeps
eight bits of mantissa).  The Pallas interpreter is slow, so it runs at
p = 5 only; p = 7 and the real patch size p = 25 are held against the XLA
scan.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from patchperpix_tpu.ops import consensus_jax as J
from patchperpix_tpu.ops.pallas_consensus_2d import (
    consensus_fold_pallas_2d, pallas2d_supported,
    rank_scores_fold_pallas_2d, unfold_consensus)
from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
from patchperpix_tpu_torch.ops import probe as PR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_affs(shape, P, seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(P, *shape).astype(np.float32)
    return np.where(a > 0.5, 0.6 + 0.4 * a, 0.4 * a).astype(np.float32)


def _overlap(shape):
    ov = np.zeros(shape, bool)
    ov[0, 5:9, 3:7] = True
    return ov


def _center_valid(shape):
    cv = np.ones(shape, bool)
    cv[0, :, :shape[2] // 2] = False
    return cv


def _port(affs, tc, ov, cv):
    """(half, symmetrized, scores) through the port's CPU dispatch."""
    a = torch.from_numpy(affs)
    ops = K.consensus_operands(
        a, tc, None if ov is None else torch.from_numpy(ov),
        None if cv is None else torch.from_numpy(cv))
    half = K.consensus_half(a, ops, tc)
    return half, C.symmetrize_half(half, tc), K.rank_scores(a, half, ops, tc)


CASES = [  # (p, shape, seed, overlap, center_valid, config, interpret too)
    (5, (1, 11, 15), 1, False, False, {}, True),
    (5, (1, 13, 12), 3, True, False, {"overlapping_inst": True}, True),
    (5, (1, 11, 15), 4, False, False, {"weight_mode": "prob_product"}, True),
    (5, (1, 11, 15), 5, False, False, {"weight_mode": "count",
                                       "norm_aff": False}, True),
    (5, (1, 11, 15), 6, False, False, {"rank_int_counter": True}, True),
    (5, (1, 11, 15), 7, False, True, {}, True),
    (5, (1, 13, 12), 8, True, True, {"overlapping_inst": True,
                                     "norm_rank": False,
                                     "bg_mode": "half"}, False),
    (7, (1, 26, 17), 2, False, False, {}, False),
    (25, (1, 40, 56), 9, False, False, {"patch_threshold": 0.6}, False),
]


@pytest.mark.parametrize("p,shape,seed,use_ov,use_cv,kw,interpret", CASES)
def test_consensus_and_rank_2d_match_jax(p, shape, seed, use_ov, use_cv, kw,
                                         interpret):
    jc = J.ConsensusConfig(patchshape=(1, p, p), **kw)
    tc = C.ConsensusConfig(patchshape=(1, p, p), **kw)
    assert C.is_2d(tc, shape) and pallas2d_supported(jc, shape)
    affs = _random_affs(shape, p * p, seed)
    ov = _overlap(shape) if use_ov else None
    cv = _center_valid(shape) if use_cv else None
    half, sym, scores = _port(affs, tc, ov, cv)
    assert tuple(half.shape) == (p, 2 * p - 1) + shape[1:]
    assert tuple(sym.shape) == (1, 2 * p - 1, 2 * p - 1) + shape

    cons = J.consensus_array(affs, jc, overlap=ov, center_valid=cv)
    want_sym = np.asarray(J.symmetrize_consensus(cons, jc))
    assert np.abs(want_sym).max() > 0.1
    np.testing.assert_allclose(sym.numpy(), want_sym, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(C.embed_half(half, tc).numpy(),
                               np.asarray(cons), atol=1e-4, rtol=1e-4)
    # canonical gate: nothing at d == 0, dx <= 0
    np.testing.assert_array_equal(half[0, :p].numpy(), 0)
    want_r = np.asarray(J.rank_scores(affs, cons, jc, overlap=ov,
                                      center_valid=cv))
    assert tuple(scores.shape) == shape
    np.testing.assert_allclose(scores.numpy(), want_r, atol=1e-3, rtol=1e-4)
    if interpret:
        fold = consensus_fold_pallas_2d(affs, jc, overlap=ov,
                                        center_valid=cv, interpret=True)
        np.testing.assert_allclose(
            sym.numpy(), np.asarray(unfold_consensus(fold, jc, shape)),
            atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(
            scores.numpy(), np.asarray(rank_scores_fold_pallas_2d(
                affs, fold, jc, overlap=ov, center_valid=cv,
                interpret=True)), atol=1e-3, rtol=1e-4)


def test_bf16_half_matches_jax():
    p, shape = 5, (1, 11, 15)
    affs = _random_affs(shape, p * p, 7)
    jc32 = J.ConsensusConfig(patchshape=(1, p, p))
    jc = J.ConsensusConfig(patchshape=(1, p, p), cons_bf16=True)
    tc = C.ConsensusConfig(patchshape=(1, p, p), cons_bf16=True)
    half, sym, scores = _port(affs, tc, None, None)
    assert half.dtype == sym.dtype == torch.bfloat16
    cons32 = J.consensus_array(affs, jc32)
    np.testing.assert_allclose(
        sym.float().numpy(), np.asarray(J.symmetrize_consensus(cons32, jc32)),
        atol=5e-3, rtol=2e-2)
    np.testing.assert_allclose(
        scores.numpy(), np.asarray(J.rank_scores(affs, cons32, jc32)),
        atol=5e-2, rtol=2e-2)
    fold = consensus_fold_pallas_2d(affs, jc, interpret=True)
    # both sides round the same float32 sums to bf16: at most one step apart
    np.testing.assert_allclose(
        sym.float().numpy(),
        np.asarray(unfold_consensus(fold, jc, shape), np.float32),
        atol=1e-4, rtol=2.0 ** -7)


def test_gated_stack_and_derive_are_the_masks():
    """derive_2d of the gated stack gives the (hi, lo) stacks of _masks,
    and the epilogue's counts are their sums."""
    p, shape = 5, (1, 13, 12)
    tc = C.ConsensusConfig(patchshape=(1, p, p), overlapping_inst=True)
    affs = torch.from_numpy(_random_affs(shape, p * p, 3))
    ov = torch.from_numpy(_overlap(shape))
    hi, lo, tgt = C._masks(affs, tc, ov)
    ag, tplane = C.gated_stack_2d(affs, tc, ov)
    assert tuple(ag.shape) == (25,) + shape[1:] and ag.is_contiguous()
    hi2, lo2 = C.derive_2d(ag, tplane, tc)
    np.testing.assert_array_equal(hi2.numpy(), hi[:, 0].numpy())
    np.testing.assert_array_equal(lo2.numpy(), lo[:, 0].numpy())
    acc = torch.from_numpy(np.random.RandomState(0).randn(
        *shape[1:]).astype(np.float32))
    np.testing.assert_array_equal(
        C.rank_epilogue_2d(acc, ag, tplane, tc).numpy(),
        C.rank_epilogue(acc[None], affs, hi, tgt, tc).numpy())


def test_2d_dispatch():
    assert C.is_2d(C.ConsensusConfig(patchshape=(1, 5, 5)), (1, 30, 40))
    assert not C.is_2d(C.ConsensusConfig(patchshape=(1, 5, 5)), (4, 30, 40))
    assert not C.is_2d(C.ConsensusConfig(patchshape=(3, 3, 3)), (8, 9, 10))
    assert not C.is_2d(C.ConsensusConfig(patchshape=(1, 4, 4)), (1, 30, 40))
    assert not C.is_2d(C.ConsensusConfig(patchshape=(1, 5, 3)), (1, 30, 40))
    # a non-square flat patch takes the 3D operands and kernels
    tc = C.ConsensusConfig(patchshape=(1, 5, 3))
    ops = K.consensus_operands(torch.zeros(15, 1, 9, 9), tc)
    assert len(ops) == 3 and tuple(ops[0].shape) == (15, 1, 9, 9)
    with pytest.raises(ValueError, match="square odd 2D"):
        C.gated_stack_2d(torch.zeros(15, 1, 9, 9), tc)


@pytest.mark.parametrize("mode,n_slab,W", PR.CASES)
def test_probe_plain_is_the_reference_formula(mode, n_slab, W):
    """The plain probe against the `want` loop of scripts/probe_dynslice.py
    (probe_dynslice.py:81-85), on that script's own input."""
    ZS, V = 8, PR.V
    x = np.random.RandomState(0).rand(ZS, V, W).astype(np.float32)
    flat = x.reshape(ZS * V, W)
    want = np.zeros((ZS - n_slab + 1, V, W), np.float32)
    for z in range(want.shape[0]):
        for s in range((n_slab - 1) * V):
            want[z] += flat[z * V + s:z * V + s + V] * (s + 1)
    got = PR.probe_window(torch.from_numpy(x), n_slab, mode)
    assert np.abs(got.numpy() - want).max() < 1e-4
    with pytest.raises(ValueError, match="not CUDA"):
        PR.probe_window_cuda(torch.from_numpy(x), n_slab, mode)


def test_probe_script_dry_run():
    spec = importlib.util.spec_from_file_location(
        "probe_window_cuda", os.path.join(REPO, "scripts",
                                          "probe_window_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert [r["ok"] for r in PR.run_cases("cpu")] == [True] * (
        len(PR.CASES) + 1)
    assert callable(mod.main) and PR.PROBE.launches == 0
