"""The port's multi-device assembly vs one device and vs the JAX package.

The counterparts of ``tests/test_sharded.py``, each with 2 and 4 shards:
the port's mesh is n CPU devices (``parallel/sharded.py``'s
``local_devices`` hook replaced), the JAX package's its 8 virtual CPU
devices (``tests/conftest.py``).  Every sharded result is held against
the port's one-device result (equal, the consensus half bit for bit,
rank 1e-5) and against the JAX package's sharded run under the JAX
test's own limits (consensus 1e-5, rank 1e-4, graph weights 1e-5, the
cover and the maps exactly).  Also: ``block_devices = 2`` against
``block_devices = 0`` and the JAX run, and the sample fan-out of
``parallel/multihost.py`` against the JAX package's.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from patchperpix_tpu.assembly import VoteInstancesParams as JParams
from patchperpix_tpu.assembly import blockwise as JB
from patchperpix_tpu.assembly import to_instance_seg as jax_assemble
from patchperpix_tpu.assembly import vote_instances as jvi
from patchperpix_tpu.ops import consensus_jax as J
from patchperpix_tpu.ops import np_reference as R
from patchperpix_tpu.ops import synthetic
from patchperpix_tpu.ops.cover import greedy_cover_device as j_cover
from patchperpix_tpu.parallel import multihost as jmh
from patchperpix_tpu.parallel import (make_spatial_mesh as j_mesh,
                                      sharded_consensus_and_rank as j_shard)
from patchperpix_tpu_torch.assembly import VoteInstancesParams, blockwise
from patchperpix_tpu_torch.assembly import to_instance_seg
from patchperpix_tpu_torch.assembly import vote_instances as tvi
from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
from patchperpix_tpu_torch.ops.cover import greedy_cover_device
from patchperpix_tpu_torch.parallel import multihost as tmh
from patchperpix_tpu_torch.parallel import sharded
from patchperpix_tpu_torch.utils.postprocess import relabel

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def cpu_devices(monkeypatch):
    """Make ``local_devices`` list n CPU devices; returns a setter."""
    def use(n):
        monkeypatch.setattr(sharded, "local_devices",
                            lambda kind="cuda": [CPU] * n)
        return sharded.make_spatial_mesh(n, "cpu")
    return use


def _random_affs(shape, P, seed=0):
    rng = np.random.RandomState(seed)
    affs = rng.rand(P, *shape).astype(np.float32)
    return np.where(affs > 0.5, 0.6 + 0.4 * affs, 0.4 * affs).astype(
        np.float32)


def _one_device(affs, cfg, overlap=None, cv=None):
    a = torch.from_numpy(affs)
    ops = K.consensus_operands(a, cfg, overlap, cv)
    half = K.consensus_half(a, ops, cfg)
    return half, K.rank_scores(a, half, ops, cfg, cv)


def _same_up_to_relabel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert ((a > 0) == (b > 0)).all()
    for i in np.unique(a[a > 0]):
        assert len(np.unique(b[a == i])) == 1


def _check_sharded(affs, cfg, jcfg, n, overlap=None, cv=None,
                   jax_rank=True):
    mesh = [CPU] * n
    ov_t = None if overlap is None else torch.from_numpy(overlap)
    cv_t = None if cv is None else torch.from_numpy(cv)
    half, scores = sharded.sharded_consensus_and_rank(
        torch.from_numpy(affs), cfg, mesh, overlap=ov_t, center_valid=cv_t)
    half1, scores1 = _one_device(affs, cfg, ov_t, cv_t)
    assert torch.equal(half, half1)
    np.testing.assert_allclose(scores.numpy(), scores1.numpy(), atol=1e-5,
                               rtol=1e-5)
    jc, js = j_shard(jnp.asarray(affs), jcfg, j_mesh(n, backend="cpu"),
                     overlap=None if overlap is None
                     else jnp.asarray(overlap),
                     center_valid=None if cv is None else jnp.asarray(cv))
    psz = int(cfg.ps[0])
    np.testing.assert_allclose(half.numpy(), np.asarray(jc)[psz - 1:],
                               atol=1e-5, rtol=1e-5)
    if jax_rank:
        np.testing.assert_allclose(scores.numpy(), np.asarray(js),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_matches_single_device(n):
    cfg = C.ConsensusConfig(patchshape=(3, 3, 3))
    jcfg = J.ConsensusConfig(patchshape=(3, 3, 3))
    _check_sharded(_random_affs((24, 7, 8), 27, seed=3), cfg, jcfg, n)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_with_overlap_mask(n):
    kw = dict(patchshape=(3, 3, 3), overlapping_inst=True)
    overlap = np.zeros((12, 6, 7), dtype=bool)
    overlap[3:7, 2:4, 2:5] = True
    _check_sharded(_random_affs((12, 6, 7), 27, seed=5),
                   C.ConsensusConfig(**kw), J.ConsensusConfig(**kw), n,
                   overlap=overlap)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_center_valid_composes(n):
    cv = np.zeros((16, 6, 7), dtype=bool)
    cv[2:13, 1:5, 1:6] = True
    cv[5:8, :, :] = False           # a hole crossing a shard boundary
    _check_sharded(_random_affs((16, 6, 7), 27, seed=7),
                   C.ConsensusConfig(patchshape=(3, 3, 3)),
                   J.ConsensusConfig(patchshape=(3, 3, 3)), n, cv=cv)


def test_sharded_mesh_size_constraints(cpu_devices, caplog):
    """The JAX package's rule on its 8 devices, on the port's 8."""
    cpu_devices(8)
    ccfg = C.ConsensusConfig(patchshape=(3, 3, 3))
    jcfg = J.ConsensusConfig(patchshape=(3, 3, 3))
    for want in (0, 1, 2, 3, 4, 8, -1):
        for shape in ((24, 7, 8), (10, 7, 8), (12, 5, 5), (1, 30, 30),
                      (7, 9, 9), (9, 9, 9)):
            got = tvi._sharded_mesh_size(
                VoteInstancesParams(sharded_devices=want), shape, ccfg, "cpu")
            assert got == jvi._sharded_mesh_size(
                JParams(sharded_devices=want), shape, jcfg), (want, shape)
    with caplog.at_level(logging.INFO, logger=tvi.__name__):
        assert tvi._sharded_mesh_size(VoteInstancesParams(sharded_devices=8),
                                      (10, 7, 8), ccfg, "cpu") == 2
    assert "2 shards" in caplog.text


def _two_blob_case():
    labels = synthetic.two_blob_labels_3d()
    affs = synthetic.labels_to_affinities(labels, np.array([3, 3, 3]))
    return affs, affs[13] > 0.5


@pytest.mark.parametrize("n", [2, 4])
def test_to_instance_seg_sharded_param_matches_single_device(n,
                                                             cpu_devices):
    cpu_devices(n)
    affs, fg = _two_blob_case()
    numinst = fg.astype(np.uint8)
    base = dict(patchshape=(3, 3, 3), patch_threshold=0.5, fc_threshold=0.5,
                mws=False)
    inter1, inter = {}, {}
    inst1, _ = to_instance_seg(affs, fg, fg.copy(), numinst,
                               VoteInstancesParams(**base), device="cpu",
                               intermediates=inter1)
    inst, _ = to_instance_seg(affs, fg, fg.copy(), numinst,
                              VoteInstancesParams(sharded_devices=n, **base),
                              device="cpu", intermediates=inter)
    # Z = 14: four shards fall back to two under the JAX package's rule
    used = tvi._sharded_mesh_size(VoteInstancesParams(sharded_devices=n),
                                  fg.shape, C.ConsensusConfig(
                                      patchshape=(3, 3, 3)), "cpu")
    assert used == jvi._sharded_mesh_size(
        JParams(sharded_devices=n), fg.shape,
        J.ConsensusConfig(patchshape=(3, 3, 3))) == 2
    np.testing.assert_array_equal(inst, inst1)
    np.testing.assert_array_equal(inter["cover_centers"],
                                  inter1["cover_centers"])
    np.testing.assert_allclose(inter["weights"], inter1["weights"],
                               atol=1e-5, rtol=1e-5)
    jinst, _ = jax_assemble(affs, fg, fg.copy(), numinst,
                            JParams(engine="jax", sharded_devices=n, **base))
    _same_up_to_relabel(jinst, inst)
    np.testing.assert_array_equal(relabel(inst), relabel(np.asarray(jinst)))


def test_blockwise_composes_with_sharded_devices(cpu_devices):
    cpu_devices(4)
    labels = np.zeros((20, 16, 16), dtype=np.int32)
    labels[2:9, 2:9, 2:9] = 1
    labels[11:18, 8:15, 8:15] = 2
    affs = synthetic.labels_to_affinities(labels, np.array([3, 3, 3]))
    fg = affs[13] > 0.5
    base = dict(patchshape=(3, 3, 3), removeIntersection=False)
    ref_out, _ = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), VoteInstancesParams(**base),
        chunksize=(10, 16, 16), device="cpu")
    out, _ = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8),
        VoteInstancesParams(sharded_devices=4, **base),
        chunksize=(10, 16, 16), device="cpu")
    np.testing.assert_array_equal(out, ref_out)
    jout, _ = JB.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8),
        JParams(engine="jax", sharded_devices=4, **base),
        chunksize=(10, 16, 16))
    np.testing.assert_array_equal(relabel(out), relabel(np.asarray(jout)))


def test_block_devices_equal_one_device_and_jax(cpu_devices):
    cpu_devices(2)
    labels = np.zeros((20, 28, 28), dtype=np.int32)
    labels[4:10, 4:12, 4:12] = 1
    labels[10:16, 14:24, 14:24] = 2
    labels[4:9, 16:24, 4:10] = 3
    affs = synthetic.labels_to_affinities(labels, np.array([3, 3, 3]))
    fg = affs[13] > 0.5
    base = dict(patchshape=(3, 3, 3), removeIntersection=False)
    stats = blockwise.BlockStats()
    one, _ = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8), VoteInstancesParams(**base),
        chunksize=(14, 14, 14), device="cpu")
    two, _ = blockwise.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8),
        VoteInstancesParams(block_devices=2, sharded_devices=2, **base),
        chunksize=(14, 14, 14), device="cpu", stats=stats)
    assert stats.blocks_consensus >= 2
    np.testing.assert_array_equal(two, one)
    jout, _ = JB.blockwise_vote_instances(
        affs, fg, fg.astype(np.uint8),
        JParams(engine="jax", block_devices=2, **base),
        chunksize=(14, 14, 14))
    np.testing.assert_array_equal(relabel(two), relabel(np.asarray(jout)))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_patch_graph_weights_match(n):
    labels = synthetic.two_blob_labels_3d()
    affs = synthetic.labels_to_affinities(labels, np.array([3, 3, 3]))
    cfg = C.ConsensusConfig(patchshape=(3, 3, 3))
    half, _ = _one_device(affs, cfg)
    sym = C.symmetrize_half(half, cfg)
    fg = affs[13] > 0.5
    centers = np.argwhere(fg)[::3]
    pairs, _ = R.patch_pairs_reference(
        [(tuple(c), 0.0) for c in centers], np.array([3, 3, 3]))
    assert len(pairs) > 8
    a = torch.from_numpy(affs)
    w1 = C.patch_graph_weights(a, sym, pairs, cfg)
    w = C.patch_graph_weights(a, sym, pairs, cfg, mesh=[CPU] * n)
    np.testing.assert_allclose(w, w1, atol=1e-5, rtol=1e-5)
    jcfg = J.ConsensusConfig(patchshape=(3, 3, 3))
    jsym = J.symmetrize_consensus(J.consensus_array(affs, jcfg), jcfg)
    jw = np.asarray(J.patch_graph_weights(affs, jsym, pairs, jcfg,
                                          mesh=j_mesh(n, backend="cpu")))
    np.testing.assert_allclose(w, jw, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_cover_min_scatter_matches(n):
    labels = np.zeros((16, 10, 12), dtype=np.int32)
    labels[1:8, 1:8, 1:9] = 1
    labels[9:15, 3:9, 4:11] = 2
    ps = np.array([3, 3, 3])
    affs = synthetic.labels_to_affinities(labels, ps)
    fg = affs[13] > 0.5
    interior = np.zeros_like(fg)
    interior[1:-1, 1:-1, 1:-1] = True
    centers = np.argwhere(fg & interior)
    rng = np.random.RandomState(0)
    order = rng.permutation(len(centers))
    ranked = [(tuple(centers[i]), float(len(centers) - k))
              for k, i in enumerate(order)]
    overlap = np.zeros_like(fg)
    overlap[7:9, 4:7, 4:7] = True
    a = torch.from_numpy(affs)
    sel1, run1 = greedy_cover_device(a, fg, ranked, ps, sparse_data=True,
                                     overlap=overlap)
    sel, run = greedy_cover_device(a, fg, ranked, ps, sparse_data=True,
                                   overlap=overlap, mesh=[CPU] * n)
    key = lambda s: [tuple(map(int, c)) for c, _ in s]
    assert key(sel) == key(sel1) and len(sel) > 4
    np.testing.assert_array_equal(run, run1)
    jsel, jrun = j_cover(jnp.asarray(affs), fg.astype(np.float32), ranked,
                         ps, sparse_data=True, overlap=overlap,
                         mesh=j_mesh(n, backend="cpu"))
    assert key(sel) == key(jsel)
    np.testing.assert_array_equal(run, np.asarray(jrun) > 0.5)


def test_sharding_refuses_what_does_not_split():
    cfg = C.ConsensusConfig(patchshape=(3, 3, 3))
    a = torch.from_numpy(_random_affs((10, 5, 5), 27))
    with pytest.raises(ValueError, match="not divisible"):
        sharded.sharded_consensus_and_rank(a, cfg, [CPU] * 3)
    with pytest.raises(ValueError, match="must cover"):
        sharded.sharded_consensus_and_rank(a, cfg, [CPU] * 5)


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_sample_fan_out_equals_jax(count, monkeypatch):
    samples = [f"s{i}" for i in range(11)]
    for index in range(count):
        assert tmh.shard_samples(samples, index, count) \
            == jmh.shard_samples(samples, index, count)
        assert [tmh.owns_sample(i, index, count) for i in range(11)] \
            == [jmh.owns_sample(i, index, count) for i in range(11)]
        monkeypatch.setenv("PPP_PROCESS_INDEX", str(index))
        monkeypatch.setenv("PPP_PROCESS_COUNT", str(count))
        assert tmh.process_identity() == jmh.process_identity() \
            == (index, count)
        assert tmh.shard_samples(samples) == jmh.shard_samples(samples)
    got = [s for i in range(count) for s in tmh.shard_samples(samples, i,
                                                              count)]
    assert sorted(got) == sorted(samples)
