"""Plain versions of the port's consensus and rank kernels, and the graph
weights, vs the JAX package (XLA scan and Pallas in interpret mode).

Tolerances are the JAX package's own kernel tolerances
(tests/test_pallas_interpret.py): consensus 1e-4 (absolute and
relative), rank 1e-3 absolute / 1e-4 relative (the unnormalized rank sums
hundreds of float32 terms in another order).  Graph weights 1e-5
absolute and relative: normalized weights lie in [-1, 1]; unnormalized
ones reach ~1e4, where float32 sums in another order differ by ~1e-3.
"""

import numpy as np
import pytest
import torch

from patchperpix_tpu.ops import consensus_jax as J
from patchperpix_tpu.ops import np_reference as R
from patchperpix_tpu.ops import synthetic
from patchperpix_tpu.ops.pallas_consensus import (consensus_array_pallas,
                                                  rank_scores_pallas)
from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K

torch.set_num_threads(1)


def _random_affs(shape, P, seed):
    rng = np.random.RandomState(seed)
    a = rng.rand(P, *shape).astype(np.float32)
    return np.where(a > 0.5, 0.6 + 0.4 * a, 0.4 * a).astype(np.float32)


def _overlap(shape):
    ov = np.zeros(shape, bool)
    ov[3:5, 3:6, 2:5] = True
    return ov


def _cfgs(ps, **kw):
    return J.ConsensusConfig(patchshape=ps, **kw), \
        C.ConsensusConfig(patchshape=ps, **kw)


def _port_half(affs, cfg, ov=None):
    a = torch.from_numpy(affs)
    ops = K.consensus_operands(a, cfg, None if ov is None
                               else torch.from_numpy(ov))
    return a, ops, K.consensus_half(a, ops, cfg)


CASES = [  # (ps, shape, seed, overlap, config, also vs Pallas interpret)
    ((3, 3, 3), (8, 9, 10), 1, False, {}, True),
    ((3, 3, 3), (8, 9, 10), 2, True, {"overlapping_inst": True}, True),
    ((1, 5, 3), (7, 11, 9), 3, False, {}, True),
    ((3, 3, 3), (8, 9, 10), 4, False, {"weight_mode": "count",
                                       "norm_aff": False}, False),
    ((3, 3, 3), (8, 9, 10), 5, False, {"weight_mode": "prob_product"},
     False),
]


@pytest.mark.parametrize("ps,shape,seed,use_ov,kw,pallas", CASES)
def test_consensus_half_matches_pallas_and_xla(ps, shape, seed, use_ov, kw,
                                               pallas):
    jc, tc = _cfgs(ps, **kw)
    affs = _random_affs(shape, jc.P, seed)
    ov = _overlap(shape) if use_ov else None
    _, _, half = _port_half(affs, tc, ov)
    psz = ps[0]
    canon = np.asarray(J.consensus_array(affs, jc, overlap=ov))
    np.testing.assert_allclose(half.numpy(), canon[psz - 1:], atol=1e-4,
                               rtol=1e-4)
    if pallas:
        pal = np.asarray(consensus_array_pallas(affs, jc, overlap=ov,
                                                interpret=True))
        np.testing.assert_allclose(half.numpy(), pal, atol=1e-4, rtol=1e-4)
    sym = np.asarray(J.symmetrize_consensus(canon, jc))
    np.testing.assert_allclose(C.symmetrize_half(half, tc).numpy(), sym,
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(C.embed_half(half, tc).numpy()[:psz - 1],
                                  0)


def test_consensus_half_7cubed_on_12cubed():
    jc, tc = _cfgs((7, 7, 7), patch_threshold=0.6)
    affs = _random_affs((12, 12, 12), 343, 7)
    _, _, half = _port_half(affs, tc)
    canon = np.asarray(J.consensus_array(affs, jc))
    np.testing.assert_allclose(half.numpy(), canon[6:], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(
        C.symmetrize_half(half, tc).numpy(),
        np.asarray(J.symmetrize_consensus(canon, jc)), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_ov,kw", [
    (False, {}),
    (True, {"overlapping_inst": True, "rank_int_counter": True}),
    (False, {"norm_rank": False}),
])
def test_rank_matches_pallas(use_ov, kw):
    jc, tc = _cfgs((3, 3, 3), **kw)
    shape = (8, 9, 10)
    affs = _random_affs(shape, 27, 11)
    ov = _overlap(shape) if use_ov else None
    a, ops, half = _port_half(affs, tc, ov)
    got = K.rank_scores(a, half, ops, tc).numpy()
    # the Pallas rank kernel on the same canonical half
    want = np.asarray(rank_scores_pallas(affs, half.numpy(), jc, overlap=ov,
                                         interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-4)
    xla = np.asarray(J.rank_scores(affs, J.consensus_array(
        affs, jc, overlap=ov), jc, overlap=ov))
    np.testing.assert_allclose(got, xla, atol=1e-3, rtol=1e-4)


def test_masks_match_jax():
    jc, tc = _cfgs((3, 3, 3), overlapping_inst=True)
    affs = _random_affs((8, 9, 10), 27, 12)
    ov = _overlap((8, 9, 10))
    want = J._masks(affs, jc, ov)
    got = C._masks(torch.from_numpy(affs), tc, torch.from_numpy(ov))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def blob_graph():
    """Noisy two-blob affinities, their symmetrized consensus and the JAX
    pair list of 40 random interior fg patches (+ one pair too far)."""
    rng = np.random.RandomState(0)
    lab = np.zeros((18, 18, 18), np.int32)
    lab[3:15, 3:9, 3:15] = 1
    lab[3:15, 9:15, 3:15] = 2
    affs = synthetic.labels_to_affinities(lab, np.array((7, 7, 7)))
    affs = np.clip(affs * 0.8 + 0.2 * rng.rand(*affs.shape), 0, 1).astype(
        np.float32)
    jc = J.ConsensusConfig(patchshape=(7, 7, 7), patch_threshold=0.6)
    sym = np.array(J.symmetrize_consensus(J.consensus_array(affs, jc), jc))
    cand = np.argwhere(affs[171, 3:-3, 3:-3, 3:-3] > 0.6) + 3
    sel = [(c, 1.0) for c in cand[rng.choice(len(cand), 40,
                                             replace=False)]]
    pairs, _ = R.patch_pairs_reference(sel, (7, 7, 7), 2.0, True)
    far = np.array([[3, 3, 3, 3, 3, 17]], np.uint32)   # |dc| > 2(ps-1)
    return affs, sym, np.concatenate([pairs, far])


@pytest.mark.parametrize("drop,norm", [(True, True), (False, True),
                                       (True, False)])
def test_graph_weights_match_jax(blob_graph, drop, norm):
    affs, sym, pairs = blob_graph
    jc, tc = _cfgs((7, 7, 7), patch_threshold=0.6, norm_graph=norm)
    want = np.asarray(J.patch_graph_weights(affs, sym, pairs, jc,
                                            drop_intersection=drop))
    got = C.patch_graph_weights(torch.from_numpy(affs),
                                torch.from_numpy(sym), pairs, tc,
                                drop_intersection=drop, budget=1 << 20)
    assert got.dtype == np.float32 and got[-1] == 0.0
    assert np.count_nonzero(want) > len(pairs) // 2
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_other_devices():
    tc = C.ConsensusConfig(patchshape=(3, 3, 3))
    meta = torch.zeros((27, 5, 5, 5), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.consensus_half(meta, (meta, meta, meta), tc)
    with pytest.raises(ValueError, match="not CUDA"):
        K.consensus_half_cuda(*(torch.zeros(27, 5, 5, 5),) * 4, tc)
    with pytest.raises(ValueError, match="not CUDA"):
        K.rank_acc_cuda(torch.zeros(27, 5, 5, 5), torch.zeros(27, 5, 5, 5),
                        torch.zeros(3, 5, 5, 5, 5, 5), tc)
    flat = torch.zeros(25, 6, 7)
    tc2 = C.ConsensusConfig(patchshape=(1, 5, 5))
    with pytest.raises(ValueError, match="not CUDA"):
        K.consensus_half_2d_cuda(flat, flat[0], tc2)
    with pytest.raises(ValueError, match="not CUDA"):
        K.rank_acc_2d_cuda(flat, flat[0], torch.zeros(5, 9, 6, 7), tc2)
    assert all(k.launches == 0 for k in K.KERNELS)
