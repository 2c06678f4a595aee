"""The port on the card: its CUDA kernels against their plain PyTorch
versions, and the parity cases (``parity/cases.py``) against the JAX
package's stored runs of them.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
on the GPU machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py tests/test_torch_trace.py

Tolerances: consensus 1e-4 absolute and relative, rank 1e-3 absolute /
1e-4 relative (the JAX package's own kernel tolerances, 3D and 2D); a bf16
half within one rounding step of the stored type (2^-7 relative); the
row-window probe 1e-4 absolute; the cover kernels K5 / K6 equal to their
host loops bit for bit (integer counts); the weight gradient within 1e-5
of its largest value against float64 (W1 and W2).  An instance map is held to a
stored one by ``cases.gate_agreement`` (foreground agreement >= 99.9 %,
the same instance count, >= 99 % of foreground voxels agreeing after
best-IoU matching), a training step by ``cases.gate_step`` and scores to
0.01 (``cases.SCORE_TOL``).
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from parity import cases as cs
from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
from patchperpix_tpu_torch.ops import cover_kernels as CK
from patchperpix_tpu_torch.ops import probe as PR

pytestmark = pytest.mark.cuda


class counted:
    """The launches of ``kernels`` while the block runs, by name (``.n``
    once it has run)."""

    def __init__(self, *kernels):
        self.kernels = kernels

    def __enter__(self):
        self.n0 = [k.launches for k in self.kernels]
        return self

    def __exit__(self, *exc):
        self.n = {k.name: k.launches - n0
                  for k, n0 in zip(self.kernels, self.n0)}


class on_mesh:
    """Within the block, ``parallel/sharded.py``'s ``local_devices`` lists
    ``devices`` (n shards of one card, or several cards)."""

    def __init__(self, devices):
        self.devices = list(devices)

    def __enter__(self):
        from patchperpix_tpu_torch.parallel import sharded

        self.saved = sharded.local_devices
        sharded.local_devices = lambda kind="cuda": list(self.devices)
        return self.devices

    def __exit__(self, *exc):
        from patchperpix_tpu_torch.parallel import sharded

        sharded.local_devices = self.saved


def _json(path):
    with open(path) as f:
        return json.load(f)


def _log_rows(train_dir):
    with open(os.path.join(train_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f if '"loss"' in line]


def _crop_override(work, name, extra=""):
    """An override TOML under ``work`` pointing every data folder at a
    folder holding only the crop, after ``extra`` (TOML text)."""
    data = os.path.join(work, "data")
    if not os.path.isdir(data):
        os.makedirs(data)
        os.symlink(cs.FIXTURE, os.path.join(data, os.path.basename(
            cs.FIXTURE)))
    override = os.path.join(work, name)
    with open(override, "w") as f:
        f.write(extra + "[data]\n" + "".join(
            f'{k}_data = "{data}"\n' for k in ("train", "val", "test")))
    return override


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


@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_plain_on_a_gated_border_window(dev, bf16):
    """A blockwise border window: ``center_valid`` gates the 3D operands
    (K1 / K2 read only the gated stacks); two launches give equal bits."""
    from patchperpix_tpu_torch.assembly.blockwise import _global_center_valid

    cfg = C.ConsensusConfig(patchshape=(7, 7, 7), patch_threshold=0.6,
                            cons_bf16=bf16)
    affs, _ = _sparse_affs((20, 24, 40), (7, 7, 7), 6, dev)
    cv = _global_center_valid((-3, 5, -3), (20, 24, 40), (60, 60, 60),
                              (3, 3, 3))
    assert 0 < cv.sum() < cv.size
    cv_t = torch.as_tensor(cv, device=dev)
    hi, lo, tgt = K.consensus_operands(affs, cfg, None, cv_t)
    assert hi.any() and not hi[:, ~cv_t].any() and not lo[:, ~cv_t].any()
    half = K.consensus_half(affs, (hi, lo, tgt), cfg)
    torch.testing.assert_close(
        half.float(), C.consensus_half_plain(affs, hi, lo, cfg).float(),
        atol=1e-4, rtol=2.0 ** -7 if bf16 else 1e-4)
    assert torch.equal(half, K.consensus_half(affs, (hi, lo, tgt), cfg))
    acc = K.rank_acc_cuda(hi, lo, half, cfg)
    torch.testing.assert_close(acc, C.rank_acc_plain(hi, lo, half, cfg),
                               atol=1e-3, rtol=1e-4)
    assert torch.equal(acc, K.rank_acc_cuda(hi, lo, half, cfg))
    scores = K.rank_scores(affs, half, (hi, lo, tgt), cfg, cv_t)
    assert torch.all(scores[~cv_t] == -1.0)


def test_blockwise_on_the_card_equals_the_cpu_run(dev):
    """A small blockwise run (border foreground, 2 x 2 x 2 blocks, stitch
    windows) on the card and on the CPU: the same map; K1 runs in every
    block and stitch window that reaches the consensus, K2 in every such
    block."""
    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.assembly.blockwise import (
        BlockStats, blockwise_vote_instances)

    affs, fg = _sparse_affs((24, 26, 28), (3, 3, 3), 7, "cpu")
    affs = affs.numpy()
    fg = affs[13] > 0.5
    p = VoteInstancesParams(patchshape=(3, 3, 3), mws=True)
    want, _ = blockwise_vote_instances(affs, fg, fg.astype(np.uint8), p,
                                       chunksize=(14, 14, 14), device="cpu")
    stats = BlockStats()
    n1, n2 = K.CONSENSUS.launches, K.RANK.launches
    got, _ = blockwise_vote_instances(affs, fg, fg.astype(np.uint8), p,
                                      chunksize=(14, 14, 14), device=dev,
                                      stats=stats)
    assert len(np.unique(want)) > 3
    np.testing.assert_array_equal(got, want)
    assert stats.blocks_consensus > 0 and stats.stitch_consensus > 0
    assert K.RANK.launches - n2 == stats.blocks_consensus
    assert K.CONSENSUS.launches - n1 == \
        stats.blocks_consensus + stats.stitch_consensus


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


@pytest.mark.parametrize("mode,n_slab,W", PR.CASES + (PR.OPT_IN_CASE,))
def test_probe_kernel_matches_plain(dev, mode, n_slab, W):
    """The probe's twelve cases and the one staging past 48 KB: within
    1e-4 of the plain version (equal bits: the kernel sums in its order),
    two launches equal."""
    x = torch.from_numpy(np.random.RandomState(0).rand(
        max(8, n_slab + 1), PR.V, W).astype(np.float32)).to(dev)
    n0 = PR.PROBE.launches
    got = PR.probe_window(x, n_slab, mode)
    assert PR.PROBE.launches == n0 + 1
    assert tuple(got.shape) == (x.shape[0] - n_slab + 1, PR.V, W)
    want = PR.probe_window_plain(x, n_slab)
    assert float((got - want).abs().max()) < 1e-4
    assert torch.equal(got, want)
    assert torch.equal(got, PR.probe_window(x, n_slab, mode))


def test_probe_library_yardstick_matches_plain(dev):
    """The one PyTorch call the probe is timed against
    (``scripts/probe_window_cuda.py``: a convolution along the rows with
    the weights s + 1) gives the plain version's sums within 1e-3."""
    import runpy

    case = runpy.run_path(os.path.join(cs.REPO, "scripts",
                                       "probe_window_cuda.py"))
    _, want, fns = case["probe_timed_case"](PR, dev)
    assert float((fns["library"]() - want).abs().max()) < 1e-3


# -- the 3D main path ---------------------------------------------------------

@pytest.fixture(scope="module")
def main_path(dev):
    """The f32 main path on the crop (``cases.run_path``): a warm-up whose
    cover inputs ``CoverCapture`` keeps, then the run whose launches of
    K1, K2 and K6 are counted."""
    from patchperpix_tpu_torch.weights import build_model

    cfg = cs.crop_config("float32")
    model = build_model(cfg, device=dev)
    raw = cs.crop_raw()
    with cs.CoverCapture() as cap:
        cs.run_path(model, cfg, raw, dev)
    with counted(K.CONSENSUS, K.RANK, CK.THIN_COVER) as c:
        run = cs.run_path(model, cfg, raw, dev)
    return {"model": model, "cfg": cfg, "raw": raw, "cap": cap, "run": run,
            "launches": c.n}


def test_main_path_matches_the_jax_f32_run(main_path):
    """The f32 main path launches K1, K2 and K6, and its map agrees with
    the JAX package's f32 CPU run (parity/torch_port_ref_f32.npz)."""
    run = main_path["run"]
    assert all(n >= 1 for n in main_path["launches"].values()), \
        main_path["launches"]
    ref, meta = np.load(cs.REF_NPZ), _json(cs.REF_JSON)
    cs.gate_agreement(cs.map_agreement(run["inst"], ref["inst"], run["fg"],
                                       ref["fg"], meta["n_instances"]),
                      "the f32 main path vs the JAX run")


def test_kernels_match_plain_on_the_main_path(dev, main_path):
    """K1 and K2 against their plain versions on the f32 main path's own
    decoded affinities (the crop, 7^3 patches, 343 channels, overlaps
    where numinst > 1); a second launch of each gives the same bits."""
    run = main_path["run"]
    cfg = cs.vote_params().consensus_config()
    dec = run["dec"]
    hi, lo, _ = C._masks(dec, cfg, torch.as_tensor(run["numinst"] > 1,
                                                   device=dev))
    a, b = dec * hi, (1.0 - dec) * lo
    half = K.consensus_half_cuda(a, b, hi, lo, cfg)
    torch.testing.assert_close(half, C.consensus_half_plain(dec, hi, lo, cfg),
                               atol=1e-4, rtol=1e-4)
    assert torch.equal(half, K.consensus_half_cuda(a, b, hi, lo, cfg))
    acc = K.rank_acc_cuda(hi, lo, half, cfg)
    torch.testing.assert_close(acc, C.rank_acc_plain(hi, lo, half, cfg),
                               atol=1e-3, rtol=1e-4)
    assert torch.equal(acc, K.rank_acc_cuda(hi, lo, half, cfg))


# -- the CLI on the card -----------------------------------------------------

@pytest.fixture(scope="module")
def crop_cli(dev, cli_chain, tmp_path_factory):
    """The port's CLI on the FlyLight crop on the card, f32, at
    ``cases.run_path``'s assembly settings (pt 0.6, no skeleton, rm 400),
    which differ from the config's that ``cli_chain`` runs and the JAX
    CLI run is stored under: ``label`` on a copy of the chain's
    prediction stores (its ``predict decode``, whose settings are the
    same) and, in a second experiment, ``infer_fused``; returns the
    experiments' paths and ``label``'s launches of K1 and K2."""
    from patchperpix_tpu_torch import cli, weights

    root = tmp_path_factory.mktemp("cli")
    over = _crop_override(str(root), "over.toml",
                          '[model]\ndtype = "float32"\n')
    argv = ["-c", cs.CLI_CONFIG, "-c", over, "--root",
            str(root), "--checkpoint", str(cs.CLI_STEP),
            "--set", "vote_instances.patch_threshold=0.6",
            "--set", "vote_instances.skeletonize_foreground=False",
            "--set", "vote_instances.remove_small_comps=400"]
    step = str(cs.CLI_STEP)
    shutil.copytree(os.path.join(cli_chain["paths"]["test_processed"], step),
                    os.path.join(cli.create_folders(str(root), "label")[
                        "test_processed"], step))
    weights.write_checkpoint(weights.load_npz(), str(root / "fused" /
                                                     "train"), cs.CLI_STEP)
    with counted(K.CONSENSUS, K.RANK) as c:
        label = cli.main(argv + ["-id", "label", "-d", "label"])
    fused = cli.main(argv + ["-id", "fused", "-d", "infer_fused"])
    return label, fused, c.n


SAMPLE = os.path.splitext(os.path.basename(cs.FIXTURE))[0]


def _result(paths, mode="test_instanced"):
    from patchperpix_tpu_torch.utils.io import IoHDF5

    return IoHDF5(os.path.join(paths[mode], str(cs.CLI_STEP),
                               SAMPLE + ".hdf"))


def _metrics(paths):
    return _json(os.path.join(paths["test_evaluated"], str(cs.CLI_STEP),
                              SAMPLE + ".json"))


def test_cli_on_the_card_agrees_with_run_path(dev, crop_cli, main_path):
    """The CLI's staged path (f16 stores between the tasks) against
    ``cases.run_path``'s device-resident f32 run, under the map limits;
    K1 and K2 run inside the CLI."""
    label, _, launches = crop_cli
    assert all(n >= 1 for n in launches.values()), launches
    res = _result(label)
    run = main_path["run"]
    cs.gate_agreement(cs.map_agreement(
        res.read(key="vote_instances"), run["inst"],
        res.read(key="vote_foreground") > 0, run["fg"]),
        "the CLI vs run_path")


def test_infer_fused_writes_the_label_keys(dev, crop_cli):
    label, fused, _ = crop_cli
    keys = [_result(p).list_keys() for p in (label, fused)]
    assert keys[0] == keys[1] and "vote_instances" in keys[0]
    assert _result(fused).read(key="vote_instances").max() > 0


def test_visualize_on_the_card(dev, crop_cli):
    """``-d visualize`` with show_patches on the CLI's results, rendered on
    the card: the PNGs read back equal the port's renders of the stored
    map and of the stored affinities."""
    from patchperpix_tpu_torch import cli
    from patchperpix_tpu_torch.utils.io import IoZarr, read_png
    from patchperpix_tpu_torch.visualize.instances import render_instances
    from patchperpix_tpu_torch.visualize.patches import (mosaic_png,
                                                         patch_mosaic)

    label, _, _ = crop_cli
    written = cli.main(["--root", os.path.dirname(label["base"]), "-id",
                        label["expid"], "--run_from_exp", "--checkpoint",
                        "1", "--set", "visualize.show_patches=true", "-d",
                        "visualize"])
    res = _result(label)
    png = res.path[:-len(".hdf")] + ".png"
    assert np.array_equal(read_png(png), render_instances(
        res.read(key="vote_instances"), device=dev))
    sample = os.path.basename(res.path)[:-len(".hdf")]
    store = os.path.join(written["test_processed"], "1", sample + ".zarr")
    affs = IoZarr(store).read(key="volumes/pred_affs").astype(np.float32)
    mosaic = patch_mosaic(affs, (7, 7, 7), device=dev)
    assert mosaic.shape == (350, 350)
    assert np.array_equal(read_png(store[:-len(".zarr")] + "_patches.png"),
                          mosaic_png(mosaic))


class HdfWrites:
    """While entered, keeps the last array ``IoHDF5`` was given for each
    (file, key), whole as it will be written; ``check()`` reads each back
    from its file: {"<file>:<key>": equal}."""

    def __init__(self):
        from patchperpix_tpu_torch.utils.io import IoHDF5

        self.cls, self.real, self.arrays = IoHDF5, IoHDF5.write, {}

    def __enter__(self):
        real = self.real

        def write(io, out, bb=None, *, key, attrs=None):
            real(io, out, bb, key=key, attrs=attrs)
            self.arrays[(os.path.abspath(io.path), key.strip("/"))] = \
                io.read(key=key)

        self.cls.write = write
        return self

    def __exit__(self, *exc):
        self.cls.write = self.real

    def check(self) -> dict:
        equal = {}
        for (path, key), want in self.arrays.items():
            io = self.cls(path)
            got = io.read(key=key)
            io.close()
            equal[f"{os.path.basename(path)}:{key}"] = bool(
                got.dtype == want.dtype and np.array_equal(got, want))
        return equal


@pytest.fixture(scope="module")
def cli_chain(dev, tmp_path_factory):
    """The reference CLI's chain through the port's CLI in-process, as
    users run it: configs/flylight_crop_dec.toml in float32 (pt 0.5, mws,
    skeletonize_foreground, rm 60; evaluation under clDice, greedy,
    keep_gt_shape, rm 60) on the crop from the trained checkpoint,
    ``mknet predict decode label evaluate postprocess``.  Keeps the
    launches of K1, K2 and K6, every array given to ``IoHDF5``
    (``HdfWrites``) and each skeleton ``label`` made."""
    from patchperpix_tpu_torch import cli, weights
    from patchperpix_tpu_torch.assembly import vote_instances as TV

    work = str(tmp_path_factory.mktemp("cli_chain"))
    override = _crop_override(work, "override.toml",
                              '[model]\ndtype = "float32"\n')
    exps = os.path.join(work, "exps")
    weights.write_checkpoint(weights.load_npz(),
                             os.path.join(exps, "f32", "train"), cs.CLI_STEP)
    argv = ["-c", cs.CLI_CONFIG, "-c", override, "--root", exps,
            "--checkpoint", str(cs.CLI_STEP)]
    skeletons, real = [], TV.skeletonize

    def record(volume, *a, **kw):
        skeletons.append(real(volume, *a, **kw))
        return skeletons[-1]

    TV.skeletonize = record
    try:
        with counted(K.CONSENSUS, K.RANK, CK.THIN_COVER) as c, \
                HdfWrites() as writes:
            paths = cli.main(argv + ["-id", "f32", "-d", "mknet", "predict",
                                     "decode", "label", "evaluate",
                                     "postprocess"])
    finally:
        TV.skeletonize = real
    return {"argv": argv, "exps": exps, "work": work, "paths": paths,
            "launches": c.n, "writes": writes, "skeletons": skeletons}


def test_cli_chain_matches_the_jax_cli_run(cli_chain):
    """Against the JAX package's CPU run of the same chain
    (parity/torch_port_cli_ref_f32.npz): K1, K2 and K6 launched; the map
    under the map limits; label skeletonizes the mask to cover once, and
    the port's thinning of the stored foreground equals the stored
    skeleton bit for bit (the run's own too where its foreground equals
    the stored one); avg_f1_cov within 0.01 of the JAX run's."""
    from patchperpix_tpu_torch.utils.skeleton import skeletonize

    assert all(n >= 1 for n in cli_chain["launches"].values()), \
        cli_chain["launches"]
    res = _result(cli_chain["paths"])
    inst = res.read(key="vote_instances")
    fg = res.read(key="vote_foreground") > 0
    ref, meta = np.load(cs.CLI_REF_NPZ), _json(cs.CLI_REF_JSON)
    shape = tuple(int(s) for s in ref["shape"])

    def unpack(key):
        n = int(np.prod(shape))
        return np.unpackbits(ref[key])[:n].reshape(shape).astype(bool)

    ref_fg, ref_skel = unpack("fg"), unpack("skel")
    cs.gate_agreement(cs.map_agreement(inst, ref["inst"], fg, ref_fg,
                                       meta["n_instances"]),
                      "the CLI chain vs the JAX run")
    assert len(cli_chain["skeletons"]) == 1
    assert np.array_equal(skeletonize(ref_fg) > 0, ref_skel)
    if np.array_equal(fg, ref_fg):
        assert np.array_equal(cli_chain["skeletons"][0] > 0, ref_skel)
    score = _metrics(cli_chain["paths"])["general"]["avg_f1_cov_score"]
    assert abs(score - meta["avg_f1_cov_score"]) <= cs.SCORE_TOL, score


def test_cli_chain_hdf_results_read_back(cli_chain):
    """Every array the chain gave ``IoHDF5`` reads back from its
    ``<sample>.hdf`` equal bit for bit; postprocess's
    ``vote_instances_rm_60`` and the JAX package's attributes."""
    from patchperpix_tpu_torch.utils.postprocess import (
        relabel, remove_small_components)

    back = cli_chain["writes"].check()
    assert back and all(back.values()), back
    res = _result(cli_chain["paths"])
    inst = res.read(key="vote_instances")
    rm = res.read(key="vote_instances_rm_60")
    assert rm.dtype == np.uint16
    assert np.array_equal(rm, relabel(remove_small_components(inst, 60)))
    assert {k: np.asarray(v).tolist() for k, v in res.attrs(
        "vote_instances").items()} == {"offset": [0, 0, 0],
                                        "resolution": [1, 1, 1]}


def test_jax_result_file_through_the_ports_evaluate(cli_chain):
    """The JAX package's own result file of the chain (h5py,
    parity/torch_port_jax_result.hdf) through the port's ``evaluate``:
    avg_f1_cov within 0.01 of JAX's, the same prediction and instance
    counts."""
    from patchperpix_tpu_torch import cli
    from patchperpix_tpu_torch.utils.io import IoHDF5

    jax_meta = _json(cs.JAX_RESULT_JSON)
    inst_dir = os.path.join(cli.create_folders(cli_chain["exps"],
                                               "jax_result")[
        "test_instanced"], str(cs.CLI_STEP))
    os.makedirs(inst_dir, exist_ok=True)
    shutil.copyfile(cs.JAX_RESULT, os.path.join(inst_dir, SAMPLE + ".hdf"))
    got = _metrics(cli.main(cli_chain["argv"] + ["-id", "jax_result", "-d",
                                                 "evaluate"]))["general"]
    want = jax_meta["metrics"]["general"]
    assert abs(got["avg_f1_cov_score"] - want["avg_f1_cov_score"]) <= \
        cs.SCORE_TOL
    assert got["Num Pred"] == want["Num Pred"]
    assert cs.n_instances(IoHDF5(cs.JAX_RESULT).read(
        key=jax_meta["res_key"])) == jax_meta["n_instances"]


def test_visualize_renders_equal_the_jax_renders(dev):
    """The port's renders on the card (``render_instances`` plain, over
    the raw, outlined; ``patch_mosaic`` twice; ``render_patch_tiles``;
    ``render_graph_edges``) of ``cases.viz_inputs()`` equal the JAX
    package's in parity/torch_port_viz_ref.npz bit for bit."""
    from patchperpix_tpu_torch.assembly import debug_viz as DV
    from patchperpix_tpu_torch.visualize import instances as VI
    from patchperpix_tpu_torch.visualize import patches as VP

    inp, ref = cs.viz_inputs(), np.load(cs.VIZ_REF_NPZ)
    got = {
        "inst_plain": VI.render_instances(inp["inst"], device=dev),
        "inst_raw": VI.render_instances(inp["inst"], raw=inp["raw"],
                                        device=dev),
        "inst_outline": VI.render_instances(inp["inst"], raw=inp["raw"],
                                            outline=True, device=dev),
        "mosaic": VP.patch_mosaic(inp["affs"], cs.VIZ_PS, device=dev),
        "mosaic_z": VP.patch_mosaic(inp["affs"], cs.VIZ_PS, z=cs.VIZ_Z,
                                    selected=inp["selected"], device=dev),
        "tiles": DV.render_patch_tiles(inp["affs"], inp["fg"], cs.VIZ_PS,
                                       device=dev),
        "edges": DV.render_graph_edges(inp["pairs"], inp["weights"],
                                       inp["fg"].shape, cs.VIZ_PS),
    }
    for k, v in got.items():
        assert v.shape == ref[k].shape and v.dtype == ref[k].dtype, k
        assert np.array_equal(v, ref[k]), k


def test_visualize_label_with_vote_debug(dev, cli_chain):
    """``label`` on the chain's experiment, plain and with vote_debug,
    save_mip and save_tif: K1 / K2 once per label (vote_debug's second
    pass labels the given graph), the vote_debug map equal to the plain
    one and to the chain's, (7 * 50)^2 finite canvases, the MIPs and the
    relabelled uint16 TIF."""
    from patchperpix_tpu_torch import cli
    from patchperpix_tpu_torch.utils.io import read_png, read_tif

    argv = cli_chain["argv"] + ["-id", "f32"]
    for key, extra in (("viz_plain", []), ("viz_debug", [
            "--set", "vote_instances.vote_debug=true",
            "--set", "vote_instances.save_mip=true",
            "--set", "vote_instances.save_tif=true"])):
        with counted(K.CONSENSUS, K.RANK) as c:
            cli.main(argv + ["--set", f"vote_instances.res_key={key}"]
                     + extra + ["-d", "label"])
        assert all(n == 1 for n in c.n.values()), (key, c.n)
    res = _result(cli_chain["paths"])
    maps = {k: res.read(key=k) for k in ("vote_instances", "viz_plain",
                                         "viz_debug")}
    assert np.array_equal(maps["viz_debug"], maps["viz_plain"])
    assert np.array_equal(maps["viz_debug"], maps["vote_instances"])
    inst = maps["vote_instances"]
    side = cs.VIZ_PS[1] * inst.shape[1]
    for k in ("vote_debug", "vote_debug2"):
        canvas = res.read(key=k)
        assert list(canvas.shape) == [side, side], k
        assert np.count_nonzero(canvas) > 0 and np.isfinite(canvas).all()
    stem = res.path[:-len(".hdf")]
    tif = read_tif(stem + ".tif")
    assert tif.shape == inst.shape and tif.dtype == np.uint16
    assert int(tif.max()) == cs.n_instances(maps["viz_debug"])
    for f in (".png", "_cleaned.png"):
        assert read_png(stem + f).shape == inst.shape[1:] + (3,), f


def test_visualize_2d_vote_debug(dev, tmp_path):
    """2D vote_debug through ``do_all`` on a 128^2 crop of the worm image,
    setting (A): K3 / K4 once each, (25 * 128)^2 canvases, the map equal
    to ``to_instance_seg``'s without vote_debug."""
    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.assembly import vote_instances as TV
    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities
    from patchperpix_tpu_torch.utils.io import IoHDF5, IoZarr

    y0, x0, n = cs.VIZ_CROP2D
    labels = cs.path2d_inputs("A")["labels"][:, y0:y0 + n, x0:x0 + n]
    fg = labels > 0
    affs = labels_to_affinities(labels, np.array(cs.PS2D))
    store = str(tmp_path / "worms.zarr")
    out = IoZarr(store, mode="w")
    for key, arr in (("volumes/pred_affs", affs),
                     ("volumes/pred_fgbg", fg.astype(np.float32))):
        out.create(key, arr.shape, np.float32)
        out.write(arr, key=key)
    out.close()
    vp = VoteInstancesParams(**cs.PATH2D["A"], fg_key="volumes/pred_fgbg",
                             vote_debug=True)
    with counted(K.CONSENSUS2D, K.RANK2D) as c:
        res = IoHDF5(TV.do_all(store, vp, str(tmp_path / "inst"),
                               device=dev))
    assert all(v == 1 for v in c.n.values()), c.n
    plain, _ = TV.to_instance_seg(affs, fg, fg.copy(), fg.astype(np.uint8),
                                  VoteInstancesParams(**cs.PATH2D["A"]),
                                  device=dev)
    plain[~fg] = 0
    inst = res.read(key="vote_instances")
    assert np.array_equal(inst, plain) and cs.n_instances(inst) >= 2
    side = cs.PS2D[1] * n
    for k in ("vote_debug", "vote_debug2"):
        canvas = res.read(key=k)
        assert list(canvas.shape) == [side, side] and np.count_nonzero(
            canvas) > 0, k


# -- the 2D path --------------------------------------------------------------

@pytest.fixture(scope="module")
def path2d(dev):
    """The 2D path on the whole worm image under both settings: warm-up
    runs ((B)'s cover inputs kept by ``CoverCapture``), then the runs whose
    launches of K3, K4, K5 and K6 are counted."""
    full = {s: cs.path2d_inputs(s) for s in cs.PATH2D}
    affs = torch.as_tensor(full["A"]["affs"], device=dev)  # same in A, B
    cs.assemble_2d("A", full["A"], affs, dev)
    with cs.CoverCapture() as cap:
        cs.assemble_2d("B", full["B"], affs, dev)
    with counted(K.CONSENSUS2D, K.RANK2D, CK.COVER_CASCADE,
                 CK.THIN_COVER) as c:
        runs = {s: cs.assemble_2d(s, full[s], affs, dev) for s in cs.PATH2D}
    return {"inputs": full, "runs": runs, "launches": c.n, "cap": cap}


def test_path2d_launches_every_2d_kernel(path2d):
    assert all(n >= 1 for n in path2d["launches"].values()), \
        path2d["launches"]


def test_path2d_a_matches_each_worm_once(path2d):
    """Setting (A): every ground-truth worm is matched by exactly one
    predicted instance with IoU >= 0.5."""
    counts = cs.gt_match_counts(path2d["runs"]["A"][0],
                                path2d["inputs"]["A"]["labels"])
    assert all(c == 1 for c in counts.values()), counts


@pytest.mark.parametrize("setting", sorted(cs.PATH2D))
def test_path2d_matches_the_jax_f32_run(dev, path2d, setting):
    """Each setting against the JAX package's f32 CPU run
    (parity/torch_port_ref2d_f32.npz, at the size stored there) under the
    map limits."""
    ref, meta = np.load(cs.REF2D_NPZ), _json(cs.REF2D_JSON)
    crop = tuple(meta["crop"])
    if crop == cs.IMG2D:
        inst = path2d["runs"][setting][0]
    else:
        inp = cs.path2d_inputs(setting, crop)
        inst, _ = cs.assemble_2d(setting, inp, torch.as_tensor(
            inp["affs"], device=dev), dev)
    want = ref[f"{setting}_inst"]
    cs.gate_agreement(cs.map_agreement(inst, want, inst > 0, want > 0,
                                       meta[setting]["n_instances"]),
                      f"2D ({setting}) vs the JAX run")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("case", ["A", "B", "dense2d"])
def test_kernels_2d_match_plain_on_the_path2d_inputs(dev, path2d, case,
                                                     bf16):
    """K3 and K4 against their plain versions on the 2D path's 520x696
    affinities under settings (A) and (B) (overlaps on the crossings under
    (B)), and on the 64-worm dense2d image under (A)'s configuration, with
    an f32 and a bf16 half; a second launch of each gives the same
    bits."""
    from patchperpix_tpu_torch.assembly import VoteInstancesParams

    setting = "A" if case == "dense2d" else case
    cfg = dataclasses.replace(VoteInstancesParams(
        **cs.PATH2D[setting]).consensus_config(), cons_bf16=bf16)
    if case == "dense2d":
        ag, tgt = C.gated_stack_2d(torch.as_tensor(cs.dense2d_affs(),
                                                   device=dev), cfg)
    else:
        inp = path2d["inputs"][case]
        ag, tgt = C.gated_stack_2d(
            torch.as_tensor(inp["affs"], device=dev), cfg,
            torch.as_tensor(inp["numinst"] > 1, device=dev))
    half = K.consensus_half_2d_cuda(ag, tgt, cfg)
    torch.testing.assert_close(
        half.float(), C.consensus_half_2d_plain(ag, tgt, cfg).float(),
        atol=1e-4, rtol=2.0 ** -7 if bf16 else 1e-4)
    assert torch.equal(half, K.consensus_half_2d_cuda(ag, tgt, cfg))
    acc = K.rank_acc_2d_cuda(ag, tgt, half, cfg)
    torch.testing.assert_close(
        acc, C.rank_acc_2d_plain(ag, tgt, half, cfg), atol=1e-3, rtol=1e-4)
    assert torch.equal(acc, K.rank_acc_2d_cuda(ag, tgt, half, cfg))


def _model2d_close(code, prob, dec, pos, n_code, ref, prefix=""):
    """Code, numinst and decoded 25x25 patches at the flat positions
    ``pos`` within 1e-4 + 1e-4 |x| of the stored JAX outputs."""
    pos_t = torch.as_tensor(pos, device=code.device)
    got = {"code": code.reshape(n_code, -1)[:, pos_t].T,
           "prob": prob.reshape(3, -1)[:, pos_t].T,
           "patches": dec.reshape(625, -1)[:, pos_t].T.reshape(-1, 25, 25)}
    for key, val in got.items():
        val, want = val.cpu().numpy(), ref[prefix + key]
        d = np.abs(val - want)
        assert np.isfinite(val).all(), key
        assert np.all(d <= 1e-4 + 1e-4 * np.abs(want)), (key, d.max())


def test_model2d_matches_the_jax_outputs(dev):
    """configs/bbbc010.toml's model (seeded weights) on one 512x512
    window, predicted and decoded at the seeded pixel positions, against
    parity/torch_port_model2d_ref.npz."""
    from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                                   lift_2d,
                                                   predict_volume_device)
    from patchperpix_tpu_torch.models import PPPConfig
    from patchperpix_tpu_torch.weights import build_model, seeded_tree

    meta, ref = _json(cs.MODEL2D_JSON), np.load(cs.MODEL2D_NPZ)
    cfg = PPPConfig(**cs.BBBC010_MODEL)
    model = build_model(cfg, seeded_tree(meta["leaves"], meta["seed"]),
                        device=dev)
    raw, pos = cs.model2d_sample(meta["n_positions"])
    win = cs.MODEL2D_WINDOW
    code, prob = predict_volume_device(model, raw, cfg, win, win,
                                       device=dev)
    fg = np.zeros(win, bool)
    fg.reshape(-1)[pos] = True
    dec = decode_volume_device(model, code, fg, cfg, device=dev)
    dec4, fg3 = lift_2d(dec, fg)
    assert tuple(dec4.shape) == (625, 1) + win and fg3.shape == (1,) + win
    _model2d_close(code, prob, dec, pos, cfg.code_units, ref)


# -- the out-of-core sample path and meshes on one card -----------------------

def _sample_params():
    """The main path's [vote_instances] for blockwise assembly from a
    prediction store."""
    return dataclasses.replace(
        cs.vote_params(), blockwise=True, numinst_key="volumes/pred_numinst",
        chunksize=cs.SAMPLE_CHUNK)


@pytest.fixture(scope="module")
def sample(dev, main_path, tmp_path_factory):
    """The stand-in sample (the crop reflected to 100^3) through the
    out-of-core path: ``predict_sample_to_zarr`` (f16, zlib), blockwise
    from the codes through ``CodeAffReader`` (launches of K1, K2 and K6
    counted), then ``decode_sample`` in z-slabs and blockwise from the
    dense store (``ZarrAffReader``)."""
    from patchperpix_tpu_torch.assembly import numinst_from_probs
    from patchperpix_tpu_torch.assembly.blockwise import (
        BlockStats, blockwise_vote_instances_zarr)
    from patchperpix_tpu_torch.infer.decode import CodeDecoder, decode_sample
    from patchperpix_tpu_torch.infer.predict import predict_sample_to_zarr
    from patchperpix_tpu_torch.utils.io import IoZarr

    model, cfg = main_path["model"], main_path["cfg"]
    work = tmp_path_factory.mktemp("sample")
    raw = np.pad(main_path["raw"], [(0, 0)] + [(cs.SAMPLE_PAD,) * 2] * 3,
                 mode="reflect")
    store = str(work / "sample.zarr")
    predict_sample_to_zarr(model, raw, cfg, cs.WIN, cs.WIN, store,
                           batch_size=cs.SAMPLE_BATCH, device=dev)
    vp = _sample_params()
    numinst = numinst_from_probs(IoZarr(store).read(
        key="volumes/pred_numinst").astype(np.float32), vp)
    codes = BlockStats()
    with counted(K.CONSENSUS, K.RANK, CK.THIN_COVER) as c:
        inst_c, fg_c = blockwise_vote_instances_zarr(
            store, vp, cs.SAMPLE_CHUNK, str(work / "codes"),
            decoder=CodeDecoder(model, cfg, cs.DECODE_BATCH, dev),
            device=dev, stats=codes)
    decode_sample(model, store, cfg, batch_size=cs.DECODE_BATCH,
                  max_ram_mb=cs.DECODE_RAM_MB, device=dev)
    staged = BlockStats()
    inst_s, fg_s = blockwise_vote_instances_zarr(
        store, vp, cs.SAMPLE_CHUNK, str(work / "staged"), device=dev,
        stats=staged)
    return {"raw": raw, "store": store, "vp": vp, "work": work,
            "numinst": numinst, "fg": numinst > 0,
            "codes": (inst_c, fg_c, codes, c.n),
            "staged": (inst_s, fg_s, staged)}


def _dense_affs(sample, dev):
    from patchperpix_tpu_torch.utils.io import IoZarr

    return torch.as_tensor(IoZarr(sample["store"]).read(
        key="volumes/pred_affs"), device=dev).float()


def test_sample_store_holds_the_device_heads(dev, main_path, sample):
    """(a) The stored f16 heads equal ``predict_volume_device``'s within
    1e-3."""
    from patchperpix_tpu_torch.infer.fused import predict_volume_device
    from patchperpix_tpu_torch.utils.io import IoZarr

    heads = predict_volume_device(main_path["model"], sample["raw"],
                                  main_path["cfg"], cs.WIN, cs.WIN,
                                  device=dev)
    io = IoZarr(sample["store"])
    for key, want in zip(("volumes/pred_code", "volumes/pred_numinst"),
                         heads):
        err = float((torch.as_tensor(io.read(key=key), device=dev).float()
                     - want).abs().max())
        assert err <= 1e-3, (key, err)


def test_blockwise_code_reader_equals_the_staged_map(sample):
    """(b) Each run reads through its own reader; the code reader's map
    equals the staged map after relabelling, with equal foreground; K2
    once per block that reached the consensus, K1 once per such block and
    stitch window, K6 launched."""
    from patchperpix_tpu_torch.utils.postprocess import relabel

    inst_c, fg_c, st, n = sample["codes"]
    inst_s, fg_s, st_s = sample["staged"]
    assert (st.reader, st_s.reader) == ("CodeAffReader", "ZarrAffReader")
    assert n[K.RANK.name] == st.blocks_consensus >= 1, (n, st.as_dict())
    assert n[K.CONSENSUS.name] == \
        st.blocks_consensus + st.stitch_consensus, (n, st.as_dict())
    assert n[CK.THIN_COVER.name] >= 1, n
    assert np.array_equal(fg_c, fg_s)
    assert np.array_equal(relabel(inst_c), relabel(inst_s))


def test_blockwise_matches_the_jax_f32_run(dev, main_path):
    """(c) The blockwise map (in memory, at the stored chunksize, two
    blocks or more per axis) of the f32 main path's decoded affinities
    against the JAX package's blockwise run
    (parity/torch_port_blockwise_ref_f32.npz) under the map limits."""
    from patchperpix_tpu_torch.assembly.blockwise import (
        BlockStats, blockwise_vote_instances)

    run = main_path["run"]
    ref, meta = np.load(cs.BW_REF_NPZ), _json(cs.BW_REF_JSON)
    sl = tuple(slice(0, int(n)) for n in meta["size"])
    stats = BlockStats()
    inst, fg = blockwise_vote_instances(
        run["dec"][(slice(None),) + sl].contiguous(), run["fg"][sl],
        run["numinst"][sl], _sample_params(),
        chunksize=tuple(meta["chunksize"]), device=dev, stats=stats)
    assert stats.blocks >= 8
    cs.gate_agreement(cs.map_agreement(inst, ref["inst"], fg > 0,
                                       ref["fg"].astype(bool)),
                      "blockwise vs the JAX run")


def test_blockwise_on_the_synthetic_tubes(dev, tmp_path):
    """(d) benchmarks/blockwise_scale.py's tube volume at 120^3, written as
    an f16 store and assembled blockwise at chunksize 64: 12 instances,
    each ground-truth tube matched by exactly one at IoU >= 0.5."""
    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.assembly.blockwise import \
        blockwise_vote_instances_zarr
    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     synth_labels)
    from patchperpix_tpu_torch.utils.io import IoZarr

    ps = (7, 7, 7)
    labels = synth_labels(cs.SYNTH_EXTENT)
    affs = labels_to_affinities(labels, np.array(ps)).astype(np.float16)
    path = str(tmp_path / "synth.zarr")
    io = IoZarr(path, mode="w")
    io.create("volumes/pred_affs", affs.shape, np.float16,
              chunks=(affs.shape[0], 32, 32, 32))
    io.write(affs, key="volumes/pred_affs")
    io.close()
    # benchmarks/blockwise_scale.py's [vote_instances]
    vp = VoteInstancesParams(
        patchshape=ps, patch_threshold=0.5, fc_threshold=0.5, mws=True,
        blockwise=True, chunksize=(64, 64, 64), consensus_bf16=True,
        select_patches_for_sparse_data=True)
    inst, _ = blockwise_vote_instances_zarr(path, vp, chunksize=(64, 64, 64),
                                            device=dev)
    counts = cs.gt_match_counts(inst, labels)
    assert cs.n_instances(labels) == cs.n_instances(inst) == 12
    assert all(c == 1 for c in counts.values()), counts


def _mesh_consensus(affs, cfg, mesh, overlap):
    """``sharded_consensus_and_rank`` over ``mesh`` against the
    whole-volume K1 + K2: the half within 1e-4 + 1e-4 |x|, the scores
    within 1e-3 + 1e-4 |x|; K1 and K2 once per shard."""
    from patchperpix_tpu_torch.parallel import sharded

    ops = K.consensus_operands(affs, cfg, overlap)
    half1 = K.consensus_half(affs, ops, cfg)
    sc1 = K.rank_scores(affs, half1, ops, cfg)
    del ops
    with counted(K.CONSENSUS, K.RANK) as c:
        half, sc = sharded.sharded_consensus_and_rank(affs, cfg, mesh,
                                                      overlap)
    assert all(n == len(mesh) for n in c.n.values()), c.n
    assert bool(((half.float() - half1.float()).abs()
                 <= 1e-4 + 1e-4 * half1.float().abs()).all())
    assert bool(((sc - sc1).abs() <= 1e-3 + 1e-4 * sc1.abs()).all())


@pytest.mark.parametrize("volume", ["main_path", "sample"])
def test_sharded_consensus_and_rank_equal_the_whole_volume(dev, main_path,
                                                           sample, volume):
    """Meshes of shards on the one card (``parallel/sharded.py``): 2
    shards of the f32 main path's 50^3 decoded affinities, 4 of the
    stand-in's 100^3 dense affinities; the first also across two cards
    where there are two."""
    ccfg = cs.vote_params().consensus_config()
    if volume == "main_path":
        affs, numinst = main_path["run"]["dec"], main_path["run"]["numinst"]
    else:
        affs, numinst = _dense_affs(sample, dev), sample["numinst"]
    overlap = torch.as_tensor(numinst > 1, device=dev)
    _mesh_consensus(affs, ccfg, [dev] * (2 if volume == "main_path" else 4),
                    overlap)
    if volume == "main_path" and torch.cuda.device_count() >= 2:
        _mesh_consensus(affs, ccfg, [torch.device("cuda", i)
                                     for i in range(2)], overlap)


def test_sharded_assembly_and_block_devices_on_the_sample(dev, sample):
    """On the stand-in: ``to_instance_seg(sharded_devices=4)`` with its
    shards on the one card gives the one-device map up to relabelling,
    the same cover and pairs and graph weights within 1e-5, K1 and K2
    once per shard; ``block_devices = 2`` gives the ``block_devices = 0``
    map."""
    from patchperpix_tpu_torch.assembly import to_instance_seg
    from patchperpix_tpu_torch.assembly.blockwise import \
        blockwise_vote_instances_zarr
    from patchperpix_tpu_torch.utils.postprocess import relabel

    affs, fg, numinst = _dense_affs(sample, dev), sample["fg"], \
        sample["numinst"]
    mask = fg & (numinst <= 1)
    one, four = {}, {}
    inst1, _ = to_instance_seg(affs, fg, mask, numinst, cs.vote_params(),
                               device=dev, intermediates=one)
    with on_mesh([dev] * 4), counted(K.CONSENSUS, K.RANK) as c:
        inst4, _ = to_instance_seg(
            affs, fg, mask, numinst, dataclasses.replace(
                cs.vote_params(), sharded_devices=4), device=dev,
            intermediates=four)
    del affs
    assert all(n == 4 for n in c.n.values()), c.n
    assert np.array_equal(relabel(inst4), relabel(inst1))
    assert np.array_equal(four["cover_centers"], one["cover_centers"])
    assert np.array_equal(four["pairs"], one["pairs"])
    assert float(np.abs(four["weights"] - one["weights"]).max()) <= 1e-5
    with on_mesh([dev] * 2):
        inst_b, _ = blockwise_vote_instances_zarr(
            sample["store"], dataclasses.replace(sample["vp"],
                                                 block_devices=2),
            cs.SAMPLE_CHUNK, str(sample["work"] / "block_devices"),
            device=dev)
    assert np.array_equal(relabel(inst_b), relabel(sample["staged"][0]))


# -- training -----------------------------------------------------------------

# the U-Net of _small_train with valid padding: its 3x3x3 convolutions,
# each of which takes the weight-gradient kernel in exact-f32 training
SMALL_VALID_CONVS = 6
# the launches of a _small_train step in exact f32, valid or same: W1 for
# the U-Net's six 3x3x3 convolutions and the decoder's SAME 8 -> 8 pair on
# 4^3 and 1 -> 1 pair on 8^3, W2 for the two heads, the transposed
# convolution and the decoder's three pointwise convolutions
SMALL_W1, SMALL_W2 = SMALL_VALID_CONVS + 4, 6


def _small_train(seed=0, padding="same"):
    """A narrow crop-like code model and a batch of 2 crops with 5^3
    patches (labels with the patch context) and 12^3 outputs: crops of
    12^3 with same padding, of 28^3 with valid padding."""
    from patchperpix_tpu_torch.models import PPPConfig

    cfg = PPPConfig(patchshape=(5, 5, 5), num_channels=3, num_fmaps=8,
                    fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                    downsample_factors=((2, 2, 2),), train_code=True,
                    code_units=16, ae_code_fmaps=2, ae_num_fmaps=(8, 16),
                    num_code_samples=64, overlapping_inst=True,
                    padding=padding)
    rng = np.random.RandomState(seed)
    size = 12 if padding == "same" else 28
    raw = rng.rand(2, 3, size, size, size).astype(np.float32)
    labels = np.zeros((2, 2, 16, 16, 16), np.int32)
    labels[:, 0, 2:12, 3:13, 2:14] = 1
    labels[:, 1, 7:15, 5:12, 6:13] = 2
    return cfg, raw, labels


def test_train_step_on_the_card_equals_the_cpu(dev):
    """One f32 step (TF32 off) with the same corners on the card and on
    the CPU: loss parts and every gradient leaf within 1e-4 relative; with
    same and with valid padding, where the card's step takes the weight
    gradients of the routed convolutions from the kernels W1 and W2
    (``ops/conv_kernels.py``) and the CPU's from nn.Conv3d."""
    from patchperpix_tpu_torch import weights
    from patchperpix_tpu_torch.models import PPPModel
    from patchperpix_tpu_torch.models.init import init_tree
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.ops.affinities import sample_fg_corners
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     compute_losses)
    from patchperpix_tpu_torch.utils.device import exact_f32

    for padding in ("same", "valid"):
        cfg, raw, labels = _small_train(padding=padding)
        tree = init_tree(cfg, torch.Generator().manual_seed(0))
        gt_fg = torch.from_numpy((labels[:, :, 2:-2, 2:-2, 2:-2] > 0)
                                 .sum(1) == 1)
        corners, _ = sample_fg_corners(gt_fg, cfg.num_code_samples,
                                       torch.Generator().manual_seed(1))
        out = {}
        for d in (torch.device("cpu"), dev):
            model = PPPModel(cfg)
            model.load_state_dict(weights.to_state_dict(tree))
            model.to(d)
            with exact_f32(), counted(CK.WGRAD, CK.GEMM) as c:
                loss, mets = compute_losses(
                    model, cfg, TrainConfig(), torch.from_numpy(raw).to(d),
                    torch.from_numpy(labels).to(d), corners=corners.to(d))
                loss.backward()
            on = d.type == "cuda"
            assert c.n == {CK.WGRAD.name: SMALL_W1 * on,
                           CK.GEMM.name: SMALL_W2 * on}, padding
            out[d.type] = ({k: float(v) for k, v in mets.items()},
                           {n: p.grad.cpu().numpy()
                            for n, p in model.named_parameters()})
        (m0, g0), (m1, g1) = out["cpu"], out["cuda"]
        for k in ("loss", "loss_patch", "loss_fg"):
            assert abs(m1[k] - m0[k]) <= 1e-4 * abs(m0[k]), (padding, k)
        for n in g0:
            err = np.linalg.norm(g1[n] - g0[n]) / max(
                np.linalg.norm(g0[n]), 1e-30)
            assert err <= 1e-4, (padding, n, err)


def test_device_sampler_on_the_card_repeats_under_a_seed(dev):
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    s = td.load_sample(cs.FIXTURE, "volumes/raw", "volumes/gt_instances",
                       clipmax=1500)
    ds = DeviceSampler([s], cs.train_sampler_config(td),
                       max_gt_channels=3, device=dev)
    a = ds.sample_batch(torch.Generator(device=dev).manual_seed(3))
    b = ds.sample_batch(torch.Generator(device=dev).manual_seed(3))
    assert a[0].is_cuda and a[0].shape == (3, 3, 40, 40, 40)
    assert a[1].shape == (3, 3, 46, 46, 46)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = ds.sample_batch(torch.Generator(device=dev).manual_seed(4))
    assert not torch.equal(a[0], c[0])


def test_bf16_step_keeps_f32_parameters_and_adam_state(dev):
    from patchperpix_tpu_torch.models import PPPModel
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     make_optimizer,
                                                     make_train_step)

    cfg, raw, labels = _small_train()
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    model = PPPModel(cfg).to(dev)
    tcfg = TrainConfig(lr=1e-3)
    opt, sched = make_optimizer(tcfg, model.parameters())
    step, _ = make_train_step(model, cfg, tcfg, opt, sched)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(2):
        mets = step(torch.from_numpy(raw).to(dev),
                    torch.from_numpy(labels).to(dev), gen)
    assert np.isfinite(float(mets["loss"]))
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
        st = opt.state[p]
        assert st["exp_avg"].dtype == torch.float32
        assert st["exp_avg_sq"].dtype == torch.float32


def test_device_loop_step_makes_no_host_sync(dev):
    """What the device loop runs per step (a batch drawn and augmented on
    the card, the step with its code corners, Adam, the schedule) under
    torch's sync debug mode set to raise on any host synchronisation; a
    valid U-Net in exact f32, so that each step's routed weight gradients
    come from the kernels W1 and W2 (``ops/conv_kernels.py``) and are held
    to it too."""
    from patchperpix_tpu_torch.models import PPPModel
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     make_optimizer,
                                                     make_train_step)
    from patchperpix_tpu_torch.utils.device import exact_f32

    cfg, _, _ = _small_train(padding="valid")
    s = td.load_sample(cs.FIXTURE, "volumes/raw", "volumes/gt_instances",
                       clipmax=1500)
    ds = DeviceSampler([s], td.SamplerConfig(
        input_shape=(28,) * 3, output_shape=(12,) * 3, patchshape=(5,) * 3,
        batch_size=2), max_gt_channels=2, device=dev)
    model = PPPModel(cfg).to(dev)
    tcfg = TrainConfig(lr=1e-3, lr_schedule="cosine", warmup_steps=2,
                       max_iterations=10)
    opt, sched = make_optimizer(tcfg, model.parameters())
    step, _ = make_train_step(model, cfg, tcfg, opt, sched)
    gen = torch.Generator(device=dev).manual_seed(0)
    with exact_f32():
        raw, labels, _ = ds.sample_batch(gen)
        step(raw, labels, gen)                 # first step: lazy state
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            with counted(CK.WGRAD, CK.GEMM) as c:
                for _ in range(3):
                    raw, labels, _ = ds.sample_batch(gen)
                    mets = step(raw, labels, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert c.n == {CK.WGRAD.name: 3 * SMALL_W1, CK.GEMM.name: 3 * SMALL_W2}
    assert np.isfinite(float(mets["loss"]))


@pytest.fixture(scope="module")
def train_ref(dev):
    """The fixed training batch (three 40^3 crops of the crop at the
    stored centres) and the JAX package's CPU step on it
    (parity/torch_port_train_ref_f32.*)."""
    from patchperpix_tpu_torch.train import data as td

    ref, meta = np.load(cs.TRAIN_REF_NPZ), _json(cs.TRAIN_REF_JSON)
    raw, labels, _, sample = cs.train_batch(td, ref["centres"])
    assert cs.batch_matches(raw, labels, meta["batch"])
    return {"ref": ref, "meta": meta, "raw": raw, "labels": labels,
            "sample": sample}


def _train_branch(branch, ref):
    """The model, parameters and code corners of a branch of the stored
    step: "code" is configs/flylight_crop_dec.toml's model with the
    trained parameters and the JAX step's corners, "dense"
    configs/flylight_crop.toml's with seeded weights."""
    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.models.init import flax_leaves

    if branch == "code":
        return (cs.train_model_config(models, cs.CLI_CONFIG),
                weights.load_npz(),
                torch.from_numpy(ref["corners"].astype(np.int64)))
    cfg = cs.train_model_config(models, cs.TRAIN_DENSE_CONFIG)
    return cfg, weights.seeded_tree(flax_leaves(cfg), cs.TRAIN_SEED), None


@pytest.mark.parametrize("branch", ["code", "dense"])
def test_train_step_equals_jax(dev, train_ref, branch):
    """One f32 step at full width on the fixed batch against the JAX
    package's, under ``cases.step_errors``' limits (on the trained model's
    cancelling leaves XLA's f32 sums are off by up to 2.5e-3, on the dense
    loss_patch, a mean of 66M terms, by 2e-5)."""
    cfg, tree, corners = _train_branch(branch, train_ref["ref"])
    cs.gate_step(cs.step_errors(
        dev, branch, cfg, tree, train_ref["raw"], train_ref["labels"],
        train_ref["meta"]["branches"][branch], train_ref["ref"],
        corners=corners), f"the {branch} step vs JAX")


def test_conv_wgrad_routed_valid_step_equals_jax(dev):
    """The trained crop code model with valid padding on 52^3 crops, one
    exact-f32 step on the card with its nine narrow valid 3x3x3
    convolutions and the decoder's SAME 1 -> 1 pair on W1, and its heads,
    transposed and pointwise convolutions on W2, against the JAX
    package's CPU step (parity/torch_port_train_valid_ref_f32.*) under
    the step limits."""
    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.train import data as td

    ref = np.load(cs.TRAIN_VALID_REF_NPZ)
    meta = _json(cs.TRAIN_VALID_REF_JSON)
    raw, labels, _, _ = cs.train_batch(td, ref["centres"],
                                       cs.TRAIN_VALID_EXTENT)
    assert cs.batch_matches(raw, labels, meta["batch"])
    with counted(CK.WGRAD, CK.GEMM) as c:
        res = cs.step_errors(
            dev, "valid", cs.train_model_config(models, cs.CLI_CONFIG,
                                                padding="valid"),
            weights.load_npz(), raw, labels, meta["branches"]["valid"], ref,
            corners=torch.from_numpy(ref["corners"].astype(np.int64)))
    assert c.n == {CK.WGRAD.name: cs.TRAIN_VALID_ROUTED,
                   CK.GEMM.name: cs.TRAIN_VALID_GEMM}
    cs.gate_step(res, "the valid step vs JAX")


def test_device_sampler_3d_on_the_card_equals_the_host(dev, train_ref):
    """Four batches of the device sampler (configs/flylight_crop_dec.toml's
    crops and augmentations) against the host sampler's numpy on the same
    decisions: raw within 1e-6, labels equal."""
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    s = train_ref["sample"]
    ds = DeviceSampler([s], cs.train_sampler_config(td),
                       max_gt_channels=train_ref["labels"].shape[1],
                       device=dev)
    cs.check_sampler_alignment(ds, [s], td)


def test_train_run_loss_within_the_jax_band(dev, train_ref, tmp_path):
    """``train_until`` with the device sampler (f32, TF32 off, constant lr
    1e-3, from init_tree under seed 0; the crop model at
    TRAIN_RUN_WIDTHS) for the JAX runs' 200 steps: the mean loss of the
    last 50 steps lies in the band the two JAX runs span, widened below
    by the larger of 15 % and their spread, above by the larger of 5 %
    and their spread."""
    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler
    from patchperpix_tpu_torch.train.trainer import TrainConfig, train_until
    from patchperpix_tpu_torch.utils.device import exact_f32

    runs = train_ref["meta"]["runs"]
    ds = DeviceSampler([train_ref["sample"]], cs.train_sampler_config(td),
                       max_gt_channels=train_ref["labels"].shape[1],
                       device=dev)
    cfg = cs.train_model_config(models, cs.CLI_CONFIG, **cs.TRAIN_RUN_WIDTHS)
    with exact_f32():
        train_until(models.PPPModel(cfg), cfg, TrainConfig(
            max_iterations=runs["steps"], checkpoints=runs["steps"],
            snapshots=0, lr=runs["lr"], output_folder=str(tmp_path),
            log_every=1, tensorboard=False), ds, rng_seed=0, device=dev)
    # by step: with log_every 1 the device loop logs step 1 twice
    by_step = {r["step"]: r["loss"] for r in _log_rows(str(tmp_path))}
    losses = [by_step[k] for k in sorted(by_step)]
    tail = float(np.mean(losses[-runs["tail"]:]))
    jax_tails = [r["tail_mean_loss"] for r in runs["runs"]]
    lo, hi = min(jax_tails), max(jax_tails)
    band = (lo - max(cs.TRAIN_RUN_BELOW * (lo + hi) / 2, hi - lo),
            hi + max(cs.TRAIN_RUN_ABOVE * (lo + hi) / 2, hi - lo))
    assert len(losses) == runs["steps"]
    assert band[0] <= tail <= band[1], (tail, band)


# ``-d all`` on the crop: configs/flylight_crop_dec.toml's run cut to 400
# steps, checkpoints every 200; the warmup scales with it, since optax's
# schedule (and the port's) refuses max_iterations <= warmup_steps
ALL_STEPS, ALL_CHECKPOINTS, ALL_WARMUP, RESUME_STEPS = 400, 200, 100, 600
LOG_EVERY = 100   # TrainConfig's default: no config key sets it
# the Swin's checkpoint 0: the seeded crop Swin with the numinst head's
# class-1 bias raised, so that it has foreground to label; the run labels
# by the numinst argmax (numinst_threshs = []): 400 steps from a seeded
# Swin leave class 1 below the config's 0.9 everywhere (on an H100: no
# foreground at checkpoints 200 and 400, so nothing to label)
SWIN_ALL_SHIFT = {"params/head_fgbg_numinst/bias": (0.0, 4.0, 0.0)}


@pytest.mark.parametrize("model", ["unet", "swin"])
def test_cli_all_on_the_crop(dev, tmp_path, model):
    """``-d all`` through the port's CLI in-process on the crop as users
    run it (bf16, Adam, warmup-cosine, device sampler), 400 steps,
    checkpoints every 200, from a checkpoint 0 without optimizer state:
    for ``unet`` configs/flylight_crop_dec.toml from the trained
    parameters, for ``swin`` configs/flylight_crop.toml as a Swin from the
    seeded tree.  Log rows at steps 1, 100, ... 400 with finite losses,
    checkpoints [0, 200, 400] all scored with a best, the final
    evaluate's avg_f1_cov, K1 and K2 once per validated checkpoint and
    the final label, the Adam state's update count 400; for ``unet``,
    ``train`` resumed to 600 with the Adam state read back."""
    from patchperpix_tpu_torch import cli, models, weights
    from patchperpix_tpu_torch.models.init import flax_leaves

    extra = (f"[training]\nmax_iterations = {ALL_STEPS}\n"
             f"checkpoints = {ALL_CHECKPOINTS}\n"
             f"[optimizer.optimizer]\nwarmup_steps = {ALL_WARMUP}\n")
    if model == "unet":
        config, tree = cs.CLI_CONFIG, weights.load_npz()
    else:
        config = cs.TRAIN_DENSE_CONFIG
        tree = weights.seeded_tree(flax_leaves(cs.swin_model_config(
            models, config)), cs.TRAIN_SEED)
        for name, shift in SWIN_ALL_SHIFT.items():
            tree[name] = tree[name] + np.asarray(shift, np.float32)
        extra = ('[model]\nnetwork_style = "swinunetr"\n'
                 "[vote_instances]\nnuminst_threshs = []\n" + extra)
    work = str(tmp_path)
    exps = os.path.join(work, "exps")
    weights.write_checkpoint(tree, os.path.join(exps, "all", "train"), 0)
    argv = ["-c", config, "-c", _crop_override(work, "all.toml", extra),
            "--root", exps, "-id", "all"]
    with counted(K.CONSENSUS, K.RANK) as c:
        paths = cli.main(argv + ["-d", "all"])
    if model == "unet":
        cli.main(argv + ["--set", f"training.max_iterations={RESUME_STEPS}",
                         "-d", "train"])

    rows = [r for r in _log_rows(paths["train"]) if r["step"] <= ALL_STEPS]
    assert [r["step"] for r in rows] == \
        [1] + list(range(LOG_EVERY, ALL_STEPS + 1, LOG_EVERY))
    assert all(np.isfinite(r["loss"]) for r in rows)
    counts = {cp: weights.load_checkpoint(weights.checkpoint_path(
        paths["train"], cp)).get("opt_state", {}).get("count")
        for cp in cli.get_checkpoint_list(paths["train"])}
    want_cps = list(range(0, ALL_STEPS + 1, ALL_CHECKPOINTS))
    assert [cp for cp in counts if cp <= ALL_STEPS] == want_cps, counts
    results = _json(os.path.join(paths["base"], "results.json"))
    assert len(results["results"]) == len(want_cps), results
    assert results["best"] is not None
    assert all(np.isfinite(r["score"]) for r in results["results"])
    final = _json(os.path.join(paths["test_evaluated"], str(ALL_STEPS),
                               SAMPLE + ".json"))
    assert final["general"].get("avg_f1_cov_score") is not None
    assert all(n == len(want_cps) + 1 for n in c.n.values()), c.n
    assert counts.get(ALL_STEPS) == ALL_STEPS, counts
    if model == "unet":
        with open(os.path.join(paths["base"], "run.log")) as f:
            log = f.read()
        resumed = log[log.rfind("=== task train ==="):]
        assert counts.get(RESUME_STEPS) == RESUME_STEPS, counts
        assert "resuming from" in resumed
        assert "reinitializing optimizer moments" not in resumed


def test_mesh_step_equals_one_device_and_jax(dev, train_ref):
    """The data-parallel f32 step with 3 shards on the one card, both
    branches: within the JAX fixture's step limits (cuDNN on), and within
    1e-6 relative of the one-device step when both run the same
    convolution algorithms (cuDNN off and the hand-written weight
    gradients' routes off through the ``unet._on_card`` seam: PyTorch's
    own convolutions take one sample at a time; cuDNN picks other
    algorithms for a shard of one crop than for the batch of three, and
    the hand-written kernels other shares); across cards where there are
    two."""
    from patchperpix_tpu_torch.models import unet

    n = torch.cuda.device_count()
    meshes = [[dev] * 3] + ([[torch.device("cuda", i % n)
                              for i in range(3)]] if n >= 2 else [])
    ref, raw, labels = train_ref["ref"], train_ref["raw"], \
        train_ref["labels"]
    for mesh in meshes:
        for branch in ("code", "dense"):
            cfg, tree, corners = _train_branch(branch, ref)
            want = train_ref["meta"]["branches"][branch]
            cs.gate_step(cs.step_errors(dev, branch, cfg, tree, raw, labels,
                                        want, ref, corners=corners,
                                        mesh=mesh),
                         f"the {branch} step over {len(mesh)} shards")
            one, dp = {}, {}
            saved = torch.backends.cudnn.enabled
            torch.backends.cudnn.enabled = False
            try:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(unet, "_on_card", lambda x: False)
                    cs.step_errors(dev, branch, cfg, tree, raw, labels,
                                   want, ref, corners=corners, grads_out=one)
                    cs.step_errors(dev, branch, cfg, tree, raw, labels,
                                   want, ref, corners=corners, mesh=mesh,
                                   grads_out=dp)
            finally:
                torch.backends.cudnn.enabled = saved
            errs = {k: (abs(dp[k] - one[k]) / max(abs(one[k]), 1e-30)
                        if np.isscalar(one[k]) else cs.rel_l2(dp[k], one[k]))
                    for k in one}
            worst = max(errs, key=errs.get)
            assert errs[worst] <= 1e-6, (branch, worst, errs[worst])


def test_mesh_cli_train(dev, tmp_path):
    """``-d train`` through the port's CLI with training.num_devices = 2,
    both on the one card (the CLI falls back to the host sampler), 20
    steps at batch 4 (a batch of 3 does not split over 2 devices): finite
    losses, the checkpoint at 20."""
    from patchperpix_tpu_torch import cli

    override = _crop_override(
        str(tmp_path), "md_train.toml",
        "[training]\nmax_iterations = 20\ncheckpoints = 20\n"
        "batch_size = 4\nnum_devices = 2\n"
        "[optimizer.optimizer]\nwarmup_steps = 10\n")
    with on_mesh([dev] * 2):
        paths = cli.main(["-c", cs.CLI_CONFIG, "-c", override, "--root",
                          str(tmp_path / "exps"), "-id", "dp", "-d",
                          "train"])
    rows = _log_rows(paths["train"])
    assert rows and all(np.isfinite(r["loss"]) for r in rows)
    with open(os.path.join(paths["base"], "run.log")) as f:
        assert "falling back to the host prefetcher" in f.read()
    assert cli.get_checkpoint_list(paths["train"]) == [20]


# -- the Swin UNETR backbone --------------------------------------------------

def test_swin_forward_equals_jax(dev):
    """configs/flylight.toml's Swin at full width (seeded weights) on the
    156^3 window in f32 (TF32 off): the JAX model's leaves, and each
    head's seeded entries within 1e-4 relative L2 of the JAX run's
    (parity/torch_port_swin_ref_f32.npz)."""
    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.utils.device import exact_f32
    from patchperpix_tpu_torch.weights import build_model, seeded_tree

    ref, fwd = np.load(cs.SWIN_REF_NPZ), _json(cs.SWIN_REF_JSON)["forward"]
    cfg = cs.swin_model_config(models)
    assert dict(flax_leaves(cfg)) == {k: tuple(v) for k, v in fwd["leaves"]}
    model = build_model(cfg, seeded_tree(fwd["leaves"], fwd["seed"]),
                        device=dev)
    x = torch.as_tensor(cs.swin_window(), device=dev)
    with exact_f32(), torch.no_grad():
        heads = model(x)
    for name, h in zip(("head_code_affs", "head_fgbg_numinst"), heads):
        ch, vox = cs.swin_positions(tuple(h.shape[1:]))
        got = h[0].reshape(h.shape[1], -1)[
            torch.as_tensor(ch, device=dev),
            torch.as_tensor(vox, device=dev)].cpu().numpy()
        assert np.isfinite(got).all(), name
        assert cs.rel_l2(got, ref[f"fwd/{name}"]) <= 1e-4, name


def test_swin_2d_forward_equals_jax(dev):
    """A 2D Swin at configs/bbbc010.toml's widths (seeded) on the model2d
    window: code, numinst and decoded patches at the seeded positions
    within 1e-4 + 1e-4 |x| of the JAX run's."""
    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                                   predict_volume_device)
    from patchperpix_tpu_torch.utils.device import exact_f32
    from patchperpix_tpu_torch.weights import build_model, seeded_tree

    ref, m2 = np.load(cs.SWIN_REF_NPZ), _json(cs.SWIN_REF_JSON)["model2d"]
    cfg = models.PPPConfig(**cs.SWIN_MODEL2D)
    model = build_model(cfg, seeded_tree(m2["leaves"], m2["seed"]),
                        device=dev)
    raw, pos = cs.model2d_sample(m2["n_positions"])
    win = cs.MODEL2D_WINDOW
    with exact_f32():
        code, prob = predict_volume_device(model, raw, cfg, win, win,
                                           device=dev)
        fg = np.zeros(win, bool)
        fg.reshape(-1)[pos] = True
        dec = decode_volume_device(model, code, fg, cfg, device=dev)
    _model2d_close(code, prob, dec, pos, cfg.code_units, ref, "model2d/")


def test_swin_step_equals_jax(dev, train_ref):
    """One f32 step of configs/flylight_crop.toml's model as a Swin
    (seeded) on the fixed batch under the step limits."""
    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.weights import seeded_tree

    ref = np.load(cs.SWIN_REF_NPZ)
    want = _json(cs.SWIN_REF_JSON)["branches"]["swin"]
    labels = train_ref["labels"]
    assert int(labels.astype(np.int64).sum()) == want["batch"]["labels_sum"]
    cfg = cs.swin_model_config(models, cs.TRAIN_DENSE_CONFIG)
    cs.gate_step(cs.step_errors(
        dev, "swin", cfg, seeded_tree(flax_leaves(cfg), cs.TRAIN_SEED),
        train_ref["raw"], labels, want, ref), "the Swin step vs JAX")


# -- the weight gradient of the U-Net's convolutions --------------------------

@pytest.mark.parametrize("ci,co,e", cs.WGRAD_SHAPES)
def test_conv_wgrad_kernel_matches_plain_at_the_cells_shapes(dev, ci, co, e):
    """The kernel against its plain version in float64 at each valid 3x3x3
    convolution of the published FlyLight U-Net at batch 2 of 140^3: dW
    and dB within 1e-5 of their largest value (float32 sums of up to 5 M
    products each in split-K order, which read 1e-6 to 5e-6 there), and
    the same bits from a second call (a fixed order of summation)."""
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    x, dy = cs.wgrad_inputs(ci, co, e, dev)
    n0 = CK.WGRAD.launches
    dw, db = CK.conv3d_wgrad(x, dy)
    assert CK.WGRAD.launches == n0 + 1
    rw, rb = CK.conv3d_wgrad_plain(x.double(), dy.double())
    for got, want in ((dw, rw), (db, rb)):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err <= cs.WGRAD_TOL, err
    dw2, db2 = CK.conv3d_wgrad(x, dy)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


def test_conv_wgrad_wrapper_checks_inputs(dev):
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    x = torch.zeros(1, 2, 5, 5, 5, device=dev)
    dy = torch.zeros(1, 3, 3, 3, 3, device=dev)
    with pytest.raises(ValueError):
        CK.conv3d_wgrad_cuda(x.double(), dy.double())
    with pytest.raises(ValueError):
        CK.conv3d_wgrad_cuda(x.transpose(2, 3), dy)
    with pytest.raises(ValueError):
        CK.conv3d_wgrad_cuda(x, dy[:, :, :2])
    with pytest.raises(ValueError):
        CK.conv3d_wgrad_cuda(torch.zeros(1, 2, 5, 5, 40000, device=dev),
                             torch.zeros(1, 3, 3, 3, 39998, device=dev))


def test_conv_wgrad_takes_each_served_convolution_of_the_published_step(dev):
    """Forward and backward of the published FlyLight model at batch 2 of
    140^3 in exact f32 under a profiler: W1 for each U-Net convolution it
    serves (9 of 14: the five with 128 or more channels on both sides stay
    on cuDNN) and the decoder's SAME 1 -> 1 pair, W2 for the two heads,
    the three transposed convolutions and the decoder's three pointwise
    ones, counted by the wrappers and by the routes' counters (the
    decoder's SAME 64 -> 64 pair on cuDNN)."""
    from patchperpix_tpu_torch.models import PPPConfig, PPPModel, unet
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.utils import trace
    from patchperpix_tpu_torch.utils.device import exact_f32

    with open(os.path.join(cs.REPO, "portbench", "configs",
                           "flylight_ppp_dec.json")) as f:
        cfg = PPPConfig.from_config(json.load(f)["model"])
    model = PPPModel(cfg).to(dev)
    served = [m for m in model.unet.modules()
              if isinstance(m, unet.Conv3d)
              and CK.serves(m.in_channels, m.out_channels, 140)]
    assert len(served) == 9
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.rand((2, 3, 140, 140, 140), generator=gen, device=dev)
    codes = torch.rand((64, cfg.code_units), generator=gen, device=dev)
    trace.summary()
    with exact_f32(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]), \
            counted(CK.WGRAD, CK.GEMM) as c:
        with trace.span("test.step"):
            h1, h2 = model(raw)
            (h1.sum() + h2.sum() + model.decode(codes).sum()).backward()
    counts = trace.summary()["counts"]
    assert c.n == {CK.WGRAD.name: 9 + 2, CK.GEMM.name: 8}
    assert counts["conv.wgrad_hand"] == 12
    assert counts["conv.wgrad_cudnn"] == 5 + 2
    assert counts["conv.head_up_wgrad_hand"] == 7
    assert "conv.head_up_wgrad_cudnn" not in counts
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_swin_unetr_takes_the_routes_of_the_published_step(dev):
    """Forward and backward of the published Swin UNETR ppp+dec model
    (``swinunetr_monai``, portbench/configs/flylight_swin_unetr.json) at
    batch 4 of 96^3 in exact f32 under a profiler: W1 for the 12 SAME
    3x3x3 convolutions it serves (below 128 channels on a side: the
    encoder's blocks on the input, h0 and h1 and the last three up
    blocks) and the decoder's 1 -> 1 pair, W2 for the six residual 1x1
    convolutions, the five transposed ones, the two heads and the
    decoder's three pointwise ones; cuDNN for the eight wide 3x3x3 ones,
    the stride-2 patch embed and the decoder's 64 -> 64 pair, counted by
    the wrappers and by the routes' counters."""
    from patchperpix_tpu_torch.models import PPPConfig, PPPModel
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.utils import trace
    from patchperpix_tpu_torch.utils.device import exact_f32

    with open(os.path.join(cs.REPO, "portbench", "configs",
                           "flylight_swin_unetr.json")) as f:
        cfg = PPPConfig.from_config(json.load(f)["model"])
    model = PPPModel(cfg).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    raw = torch.rand((4, 3, 96, 96, 96), generator=gen, device=dev)
    codes = torch.rand((64, cfg.code_units), generator=gen, device=dev)
    trace.summary()
    with exact_f32(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]), \
            counted(CK.WGRAD, CK.GEMM) as c:
        with trace.span("test.step"):
            h1, h2 = model(raw)
            (h1.sum() + h2.sum() + model.decode(codes).sum()).backward()
    counts = trace.summary()["counts"]
    assert c.n == {CK.WGRAD.name: 12 + 2, CK.GEMM.name: 6 + 5 + 2 + 3}
    assert counts["conv.wgrad_hand"] == 12 + 6 + 3
    assert counts["conv.wgrad_cudnn"] == 8 + 1 + 2
    assert counts["conv.head_up_wgrad_hand"] == 5 + 2 + 2
    assert "conv.head_up_wgrad_cudnn" not in counts
    assert counts["swin.tokens"] / counts["swin.window_tokens"] == \
        pytest.approx(126_360 / 142_561)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_swin_unetr_step_equals_the_reference(dev):
    """One exact-f32 training step (Adam) of the Swin UNETR ppp+dec model
    at a reduced size (feature 12, heads 3/6/12/24, batch 2 of 64^3, its
    convolutions on their routes) against the benchmark's plain reference
    (portbench/reference/swin_unetr.py) on the card: the loss within 1e-6
    relative (the forward alone), the first gradients and the change
    within the cell's limits of ``correct`` (its ``grad_err`` and
    ``change_err``: float32 sums in another order, PERF.md section 2)."""
    from patchperpix_tpu_torch import weights
    from patchperpix_tpu_torch.models import PPPConfig, PPPModel
    from patchperpix_tpu_torch.models.init import init_tree
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.train import trainer as T
    from patchperpix_tpu_torch.utils.device import exact_f32
    from portbench.reference import model as ref_model
    from portbench.reference import swin_unetr as R
    from portbench.reference import train as ref_train

    with open(os.path.join(cs.REPO, "portbench", "configs",
                           "flylight_swin_unetr.json")) as f:
        bench = json.load(f)
    small = dict(bench["model"], num_fmaps=12)
    small["autoencoder"] = dict(small["autoencoder"], num_fmaps=[8, 16],
                                num_code_samples=64)
    cfg = PPPConfig.from_config(small)
    tree = init_tree(cfg, torch.Generator().manual_seed(0))
    model = PPPModel(cfg).to(dev)
    model.load_state_dict(weights.to_state_dict(tree), strict=True)
    tcfg = T.TrainConfig(lr=1e-4, use_gt_extra=True)
    opt, sched = T.make_optimizer(tcfg, model.parameters())
    step, _ = T.make_train_step(model.train(), cfg, tcfg, opt, sched)
    rng = np.random.RandomState(1)
    raw = torch.from_numpy(rng.rand(2, 3, 64, 64, 64).astype(np.float32))
    labels = np.zeros((2, 2, 70, 70, 70), np.int32)
    labels[:, 0, 4:40, 6:44, 8:40] = 1
    labels[:, 1, 30:66, 20:60, 10:50] = 2
    labels = torch.from_numpy(labels)
    gen = torch.Generator(device=dev).manual_seed(5)
    state = gen.get_state()
    named = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in named.items()}
    with exact_f32(), counted(CK.WGRAD, CK.GEMM) as c:
        mets = step(raw.to(dev), labels.to(dev), gen)
    assert c.n[CK.WGRAD.name] > 0 and c.n[CK.GEMM.name] > 0
    grad1 = weights.from_state_dict({k: opt.state[p]["exp_avg"] / 0.1
                                     for k, p in named.items()})
    change = weights.from_state_dict({k: p.detach() - start[k]
                                      for k, p in named.items()})
    ref = R.reference_steps(ref_model.net_config({"model": small}), tree,
                            [(raw.numpy(), labels.numpy())], [state], dev,
                            lr=1e-4)
    lim = bench["limits"]
    assert abs(float(mets["loss"]) - ref["losses"][0][0]) <= \
        1e-6 * abs(ref["losses"][0][0])
    assert ref_train.leaf_gaps(grad1, ref["grad1"]) <= lim["grad_err"]
    kept = ref_train.moved_leaves(ref["grad1"])
    assert ref_train.leaf_gaps(change, ref["change"], kept) <= \
        lim["change_err"]


# -- W2: the weight gradient of pointwise and kernel = stride convolutions ----

@pytest.mark.parametrize("ci,co,e,n,f", cs.GEMM_SHAPES)
def test_conv_wgrad_gemm_kernel_matches_plain_at_the_cells_shapes(
        dev, ci, co, e, n, f):
    """W2 against its plain version in float64 at each of its eight
    convolutions of the published step: dW and dB within 1e-5 of their
    largest value (float32 sums of up to 2 M products in split-K order),
    one launch a call, and the same bits from a second call (a fixed
    order of summation)."""
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    a, b = cs.gemm_operands(ci, co, e, n, f, dev)
    with counted(CK.GEMM) as c:
        dw, db = CK.conv_wgrad_gemm(a, b)
    assert c.n == {CK.GEMM.name: 1}
    rw, rb = CK.conv_wgrad_gemm_plain(a.double(), b.double())
    for got, want in ((dw, rw), (db, rb)):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err <= cs.WGRAD_TOL, err
    dw2, db2 = CK.conv_wgrad_gemm(a, b)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.parametrize("ci,co,e,n", cs.SAME_SHAPES)
def test_conv_wgrad_same_route_at_the_decoders_shapes(dev, ci, co, e, n):
    """The decoder's SAME 3x3x3 convolutions as ``unet.Conv3d`` in exact
    f32: the 1 -> 1 pair's rows of 10 take W1 on the zero-padded input
    (one launch), the 64 -> 64 pair's rows of 6 cuDNN; dW, dB and the
    input's gradient within 1e-5 of their largest value against float64
    autograd of ``nn.Conv3d``."""
    from patchperpix_tpu_torch.models import unet
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.utils.device import exact_f32

    torch.manual_seed(0)
    ref = torch.nn.Conv3d(ci, co, 3, padding=1).double().to(dev)
    hand = unet.Conv3d(ci, co, 3, padding=1).to(dev)
    hand.load_state_dict(ref.state_dict())
    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((n, ci, e, e, e), generator=gen, device=dev)
    dy = torch.randn((n, co, e, e, e), generator=gen, device=dev)
    grads = []
    for mod, x in ((ref, x0.double()), (hand, x0.clone())):
        x.requires_grad_(True)
        with exact_f32(), counted(CK.WGRAD) as c:
            mod(x).backward(dy.to(x.dtype))
        grads.append((mod.weight.grad, mod.bias.grad, x.grad, c.n))
    assert grads[1][3] == {CK.WGRAD.name: int(CK.serves(ci, co, e + 2))}
    assert CK.serves(ci, co, e + 2) == (ci == 1)
    for want, got in zip(grads[0][:3], grads[1][:3]):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err <= cs.WGRAD_TOL, err


def test_conv_wgrad_gemm_wrapper_checks_inputs(dev):
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    a = torch.zeros(2, 3, 8, device=dev)
    b = torch.zeros(2, 4, 8, device=dev)
    with pytest.raises(ValueError):
        CK.conv_wgrad_gemm_cuda(a.double(), b.double())
    with pytest.raises(ValueError):
        CK.conv_wgrad_gemm_cuda(
            torch.zeros(2, 8, 3, device=dev).transpose(1, 2), b)
    with pytest.raises(ValueError):
        CK.conv_wgrad_gemm_cuda(a, b[:, :, :4])
    with pytest.raises(ValueError):
        CK.conv_wgrad_gemm_cuda(a, b.cpu())
    # positions not a multiple of 4 and an operand off 16-byte alignment
    # stage by 4-byte copies: the same result as the plain version
    a, b = (torch.randn(3, 5, 7, device=dev),
            torch.randn(3 * 6 * 7 + 1, device=dev)[1:].view(3, 6, 7))
    for got, want in zip(CK.conv_wgrad_gemm_cuda(a, b),
                         CK.conv_wgrad_gemm_plain(a.double(), b.double())):
        assert float((got.double() - want).abs().max()) <= \
            cs.WGRAD_TOL * float(want.abs().max())


# -- the ISBI 2012 protocol ---------------------------------------------------

def test_isbi_blosc_reads_equal_the_zlib_copy(dev):
    """The stand-in data as the JAX package wrote it (blosc: zstd,
    bitshuffle), read by the port (``utils/blosc.py``): each of its 20
    arrays bit for bit the zlib copy's."""
    import glob

    from patchperpix_tpu_torch.utils.io import IoZarr

    n = 0
    for path in sorted(glob.glob(os.path.join(cs.ISBI_DATA, "*", "*.zarr"))):
        rel = os.path.relpath(path, cs.ISBI_DATA)
        for key in IoZarr(path).list_keys():
            a = IoZarr(path).read(key=key)
            b = IoZarr(os.path.join(cs.ISBI_ZLIB, rel)).read(key=key)
            assert a.dtype == b.dtype and a.shape == b.shape, (rel, key)
            assert a.tobytes() == b.tobytes(), (rel, key)
            n += 1
    assert n == 20


@pytest.mark.parametrize("sample", cs.ISBI_TEST)
def test_isbi_assembly_on_the_card_equals_the_fixture(dev, sample):
    """The rehearsal's assembly on the ideal affinities of a test sample
    at 512^2 (94 % foreground) on the card: the JAX package's map
    (identical up to relabelling), candidate count and metric dict from
    parity/torch_port_isbi_ref_f32.*; K3 and K4 launched once each, K5 and
    K6 at least once."""
    from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                                to_instance_seg)
    from patchperpix_tpu_torch.evaluate import evaluate_labels

    ref = np.load(cs.ISBI_REF_NPZ)
    want = _json(cs.ISBI_REF_JSON)["assembly"][sample]
    affs, fg, gt = cs.isbi_ideal(sample)
    inter = {}
    with counted(K.CONSENSUS2D, K.RANK2D, CK.COVER_CASCADE,
                 CK.THIN_COVER) as c:
        inst, fg_out = to_instance_seg(
            torch.from_numpy(affs).to(dev), fg, fg.copy(),
            fg.astype(np.uint8),
            VoteInstancesParams.from_config(cs.isbi_vote_kwargs()),
            device=dev, intermediates=inter)
    assert (c.n[K.CONSENSUS2D.name], c.n[K.RANK2D.name]) == (1, 1), c.n
    assert c.n[CK.COVER_CASCADE.name] >= 1 and c.n[CK.THIN_COVER.name] >= 1
    inst[fg_out == 0] = 0
    assert len(inter["ranked_centers"]) == want["n_candidates"]
    agree, same = cs.match_agreement(inst, ref[f"a/{sample}/inst"])
    assert same, agree
    assert cs.same_json(evaluate_labels(inst, gt, **cs.isbi_eval_kwargs()),
                        want["metrics"])


def test_kernels_2d_on_the_isbi_input(dev):
    """K3 / K4 against their plain versions on the ISBI input (dense
    foreground, 25x25), f32 and bf16 half; two launches equal."""
    from patchperpix_tpu_torch.assembly import VoteInstancesParams

    affs, _, _ = cs.isbi_ideal(cs.ISBI_TEST[1])
    base = VoteInstancesParams.from_config(
        cs.isbi_vote_kwargs()).consensus_config()
    for bf16 in (False, True):
        cfg = dataclasses.replace(base, cons_bf16=bf16)
        ag, tgt = C.gated_stack_2d(torch.from_numpy(affs).to(dev), cfg)
        assert float((tgt != 0).float().mean()) > 0.9
        half = K.consensus_half_2d_cuda(ag, tgt, cfg)
        want = C.consensus_half_2d_plain(ag, tgt, cfg)
        rtol = 2.0 ** -7 if bf16 else 1e-4
        assert torch.all((half.float() - want.float()).abs()
                         <= 1e-4 + rtol * want.float().abs())
        del want
        acc = K.rank_acc_2d_cuda(ag, tgt, half, cfg)
        want = C.rank_acc_2d_plain(ag, tgt, half, cfg)
        assert torch.allclose(acc, want, atol=1e-3, rtol=1e-4)
        assert torch.equal(half, K.consensus_half_2d_cuda(ag, tgt, cfg))
        assert torch.equal(acc, K.rank_acc_2d_cuda(ag, tgt, half, cfg))


def test_isbi_boundary_filter_equals_jax(dev):
    """keep_single_slice, the sparse grid and the boundary filter on the
    seeded three-slice stack (``cases.isbi_stack``), bit for bit the JAX
    package's."""
    from patchperpix_tpu_torch.assembly import isbi_hacks as H
    from patchperpix_tpu_torch.ops.np_reference import interior

    ref = np.load(cs.ISBI_REF_NPZ)
    affs, fg = cs.isbi_stack()
    ps = np.array([1, 25, 25])
    keep = H.keep_single_slice(fg)
    cand = [tuple(c) for c in np.argwhere(keep & interior(fg.shape,
                                                          ps // 2))]
    grid = H.sparsify_patches(cand, 20, vol_shape=fg.shape)
    mask = H.filter_instance_boundaries_from_fg(affs, fg, cand, ps,
                                                keep.copy())
    n = int(np.prod(fg.shape))

    def bits(key):
        return np.unpackbits(ref[key])[:n].reshape(fg.shape).astype(bool)

    assert np.array_equal(keep, bits("b/keep"))
    assert np.array_equal(np.asarray(grid), ref["b/grid"])
    assert np.array_equal(mask, bits("b/mask"))


def test_isbi_cli_cross_validate_matches_jax(dev, tmp_path):
    """The port's CLI runs ``mknet predict label evaluate cross_validate``
    with the rehearsal config on the stand-in data, float32, from the
    seeded checkpoint, against the JAX CLI's run: every labelled map under
    the map limits with rand_fscore within 0.01, the same best checkpoint
    and applied scores within 0.01 per fold, K3 / K4 once per labelled
    sample."""
    from patchperpix_tpu_torch import cli, models, weights
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.utils.io import IoHDF5

    ref = np.load(cs.ISBI_REF_NPZ)
    want = _json(cs.ISBI_REF_JSON)["cli"]
    work = str(tmp_path)
    exps = os.path.join(work, "exps")
    cfg = cs.train_model_config(models, cs.ISBI_CONFIG)
    weights.write_checkpoint(cs.isbi_seeded_tree(flax_leaves(cfg)),
                             os.path.join(exps, "port", "train"),
                             cs.ISBI_CLI_STEP)
    with counted(K.CONSENSUS2D, K.RANK2D) as c:
        paths = cli.main(cs.isbi_cli_argv(
            exps, cs.isbi_cli_override(work), "port") + [
            "-d", "mknet", "predict", "label", "evaluate", "cross_validate"])
    keys = sorted(k for k in ref.files if k.startswith("c/")
                  and k.endswith("/inst"))
    for key in keys:
        _, mode, sample, _ = key.split("/")
        res = IoHDF5(os.path.join(paths[f"{mode}_instanced"],
                                  str(cs.ISBI_CLI_STEP), sample + ".hdf"))
        inst = res.read(key="vote_instances")
        fg = res.read(key="vote_foreground") > 0
        ref_fg = np.unpackbits(ref[f"c/{mode}/{sample}/fg"])[
            :fg.size].reshape(fg.shape).astype(bool)
        cs.gate_agreement(cs.map_agreement(inst, ref[key], fg, ref_fg),
                          f"isbi cli map {mode}/{sample}")
        got = _json(os.path.join(paths[f"{mode}_evaluated"],
                                 str(cs.ISBI_CLI_STEP), sample + ".json"))
        wm = want["metrics"][f"{mode}/{sample}"]
        assert abs(got["general"]["rand_fscore"]
                   - wm["general"]["rand_fscore"]) <= cs.SCORE_TOL, key
    cross = _json(os.path.join(paths["base"], "cross_val_results.json"))
    wc = want["cross_val_results"]
    for k in wc:
        if k == "mean_score":
            continue
        assert cross[k]["best"]["checkpoint"] == wc[k]["best"]["checkpoint"]
        assert abs(cross[k]["applied_score"] - wc[k]["applied_score"]) <= \
            cs.SCORE_TOL, k
    assert all(n == len(keys) for n in c.n.values()), (c.n, len(keys))


def test_isbi2012_forward_equals_jax(dev):
    """configs/isbi2012.toml's full-width model (seeded) on one 512^2
    window in f32 (TF32 off): sampled affinities and foreground, and their
    means, within 1e-4 relative L2 of the JAX run's."""
    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.infer.fused import predict_volume_device
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.utils.device import exact_f32
    from patchperpix_tpu_torch.weights import build_model

    ref = np.load(cs.ISBI_REF_NPZ)
    cfg = cs.train_model_config(models, cs.ISBI2012_CONFIG)
    model = build_model(cfg, cs.isbi_seeded_tree(flax_leaves(cfg)),
                        device=dev)
    win = tuple(cs.isbi_toml(cs.ISBI2012_CONFIG)["model"][
        "test_input_shape_same"])
    with exact_f32():
        affs, fg = predict_volume_device(model, cs.isbi_window(td), cfg,
                                         win, win, device=dev)
    ch, pix = cs.isbi_forward_positions(tuple(affs.shape))
    affs = affs.reshape(affs.shape[0], -1)
    pix_t = torch.as_tensor(pix, device=dev)
    got = {"affs": affs[torch.as_tensor(ch, device=dev), pix_t],
           "fg": fg.reshape(-1)[pix_t],
           "affs_channel_mean": affs.mean(1),
           "fg_mean": fg.mean().reshape(1)}
    for k, v in got.items():
        assert cs.rel_l2(v.cpu().numpy(), ref[f"d/{k}"]) <= 1e-4, k


def test_isbi_step_equals_jax(dev):
    """One f32 step of the rehearsal model (seeded) on the fixed batch
    against the JAX package's, under the step limits (its own float64
    witness)."""
    from patchperpix_tpu_torch import models
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch.train import data as td

    ref = np.load(cs.ISBI_REF_NPZ)
    want = _json(cs.ISBI_REF_JSON)["branches"]["isbi"]
    raw, labels = cs.isbi_train_batch(td)
    assert cs.batch_matches(raw, labels, want["batch"])
    cfg = cs.train_model_config(models, cs.ISBI_CONFIG)
    cs.gate_step(cs.step_errors(dev, "isbi", cfg,
                                cs.isbi_seeded_tree(flax_leaves(cfg)), raw,
                                labels, want, ref), "the isbi step vs JAX")


def test_device_sampler_2d_on_the_card_equals_the_host(dev):
    """The 2D device sampler's batches on the card (the rehearsal's
    sampler over the stand-in's training samples) against the host
    sampler's numpy on the same decisions: raw 1e-6, labels equal."""
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    samples = [td.load_sample(os.path.join(
        cs.ISBI_DATA, "train", f"isbi_train_0{i}.zarr"), "volumes/raw",
        "volumes/gt_instances") for i in range(3)]
    ds = DeviceSampler(samples, cs.isbi_sampler_config(td),
                       max_gt_channels=1, device=dev)
    seen = cs.check_sampler_alignment(ds, samples, td, draws=6)
    assert seen["flip"] and seen["transpose"]


def test_isbi_all_with_the_rehearsal_config(dev, tmp_path):
    """``-d all`` with the rehearsal config as users run it (bf16, 6,000
    steps, checkpoints every 2,000, device sampler) on the stand-in data:
    every checkpoint validated and scored with a best, finite test
    metrics, K3 / K4 once per labelled sample (each validated
    checkpoint's val samples and the final test label)."""
    import glob

    from patchperpix_tpu_torch import cli

    exps = str(tmp_path / "exps")
    override = str(tmp_path / "override_all.toml")
    with open(override, "w") as f:
        f.write("[data]\n" + "".join(
            f'{k}_data = "{os.path.join(cs.ISBI_DATA, k)}"\n'
            for k in ("train", "val", "test")))
    toml = cs.isbi_toml()
    steps, every = (toml["training"]["max_iterations"],
                    toml["training"]["checkpoints"])
    n_val = len(glob.glob(os.path.join(cs.ISBI_DATA, "val", "*.zarr")))
    n_test = len(glob.glob(os.path.join(cs.ISBI_DATA, "test", "*.zarr")))
    with counted(K.CONSENSUS2D, K.RANK2D) as c:
        paths = cli.main(["-c", cs.ISBI_CONFIG, "-c", override, "--root",
                          exps, "-id", "all", "-d", "all"])
    want_cps = list(range(every, steps + 1, every))
    assert cli.get_checkpoint_list(paths["train"]) == want_cps
    results = _json(os.path.join(paths["base"], "results.json"))
    assert len(results["results"]) == len(want_cps), results
    assert results["best"] is not None
    assert all(np.isfinite(r["score"]) for r in results["results"])
    keys = ("rand_fscore", "adapted_rand_error", "voi_split", "voi_merge",
            "Num GT", "Num Pred")
    for sample in cs.ISBI_TEST:
        g = _json(os.path.join(paths["test_evaluated"], str(steps),
                               sample + ".json"))["general"]
        assert all(np.isfinite(g[k]) for k in keys), (sample, g)
    predicted = (steps // every) * n_val + n_test
    assert all(n == predicted for n in c.n.values()), (c.n, predicted)


# -- several devices ---------------------------------------------------------

def test_kernels_launch_on_the_tensors_card_not_the_current_one(dev):
    """K1-K4 on cuda:1 while cuda:0 is current: each launch runs with the
    tensors' card current, and the results equal the plain versions."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    d1 = torch.device("cuda", 1)
    with torch.cuda.device(0):
        assert torch.cuda.current_device() == 0
        cfg = C.ConsensusConfig(patchshape=(3, 3, 3))
        affs = _affs((8, 9, 10), cfg.P, 3, d1)
        ops = K.consensus_operands(affs, cfg)
        half = K.consensus_half(affs, ops, cfg)
        torch.testing.assert_close(
            half, C.consensus_half_plain(affs, ops[0], ops[1], cfg),
            atol=1e-4, rtol=1e-4)
        acc = K.rank_acc_cuda(ops[0], ops[1], half, cfg)
        torch.testing.assert_close(
            acc, C.rank_acc_plain(ops[0], ops[1], half, cfg), atol=1e-3,
            rtol=1e-4)
        cfg2 = C.ConsensusConfig(patchshape=(1, 5, 5))
        a2 = _affs((1, 11, 15), cfg2.P, 3, d1)
        ag, tgt = K.consensus_operands(a2, cfg2)
        h2 = K.consensus_half(a2, (ag, tgt), cfg2)
        torch.testing.assert_close(
            h2, C.consensus_half_2d_plain(ag, tgt, cfg2), atol=1e-4,
            rtol=1e-4)
        torch.testing.assert_close(
            K.rank_acc_2d_cuda(ag, tgt, h2, cfg2),
            C.rank_acc_2d_plain(ag, tgt, h2, cfg2), atol=1e-3, rtol=1e-4)
        assert torch.cuda.current_device() == 0
        assert half.device == acc.device == h2.device == d1


def test_sharded_path_and_mesh_step_on_one_card(dev):
    """Meshes of shards all on cuda:0: the sharded consensus and rank equal
    the whole-volume K1 + K2 (phase 3's tolerances, one launch per shard),
    the sharded to_instance_seg gives the one-device map, and the
    data-parallel step over 2 shards equals the one-device step within
    1e-5 relative."""
    from patchperpix_tpu_torch import weights
    from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                                to_instance_seg)
    from patchperpix_tpu_torch.models import PPPModel
    from patchperpix_tpu_torch.models.init import init_tree
    from patchperpix_tpu_torch.ops import synthetic
    from patchperpix_tpu_torch.parallel import sharded
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     compute_losses)
    from patchperpix_tpu_torch.utils.device import exact_f32

    cfg = C.ConsensusConfig(patchshape=(3, 3, 3))
    affs = _affs((24, 9, 10), cfg.P, 3, dev)
    ops = K.consensus_operands(affs, cfg)
    half1 = K.consensus_half(affs, ops, cfg)
    sc1 = K.rank_scores(affs, half1, ops, cfg)
    n1, n2 = K.CONSENSUS.launches, K.RANK.launches
    half, sc = sharded.sharded_consensus_and_rank(affs, cfg, [dev] * 4)
    assert (K.CONSENSUS.launches - n1, K.RANK.launches - n2) == (4, 4)
    torch.testing.assert_close(half, half1, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sc, sc1, atol=1e-3, rtol=1e-4)

    labels = synthetic.synth_labels(24)
    a = synthetic.labels_to_affinities(labels, (3, 3, 3))
    fg = a[13] > 0.5
    vp = dict(patchshape=(3, 3, 3))
    one, _ = to_instance_seg(a, fg, fg.copy(), fg.astype(np.uint8),
                             VoteInstancesParams(**vp), device=dev)
    saved = sharded.local_devices
    sharded.local_devices = lambda kind="cuda": [dev] * 2
    try:
        two, _ = to_instance_seg(a, fg, fg.copy(), fg.astype(np.uint8),
                                 VoteInstancesParams(sharded_devices=2,
                                                     **vp), device=dev)
    finally:
        sharded.local_devices = saved
    np.testing.assert_array_equal(two, one)

    mcfg, raw, lab = _small_train()
    res = []
    for mesh in (None, [dev] * 2):
        model = PPPModel(mcfg)
        model.load_state_dict(weights.to_state_dict(init_tree(
            mcfg, torch.Generator().manual_seed(0))))
        model.to(dev)
        with exact_f32():
            loss, _ = compute_losses(
                model, mcfg, TrainConfig(), torch.from_numpy(raw).to(dev),
                torch.from_numpy(lab).to(dev),
                corners=torch.tensor([[0, 2, 3, 4], [1, 5, 5, 5]],
                                     device=dev), mesh=mesh)
            loss.backward()
        res.append((float(loss), {n: p.grad.double().cpu() for n, p in
                                  model.named_parameters()}))
    (l1, g1), (l2, g2) = res
    assert abs(l2 - l1) <= 1e-5 * abs(l1)
    for n in g1:
        assert float((g2[n] - g1[n]).norm()) <= 1e-5 * max(
            float(g1[n].norm()), 1e-30), n


# -- the cover loops (K5, K6) -------------------------------------------------

def _cover_equal(cap, cap_it=None):
    """K5 on ``cap``'s cascade input (where it has one) and K6 on its thin
    input against their plain versions (the host loops): selections, and
    the cascade's still-uncovered volume, equal bit for bit; everything
    staged in shared memory, nothing (``smem_cap=0``), and part of it (60
    KB: the running bits, not the masks), at several block sizes and, for
    the cascade, chunks of 40."""
    from patchperpix_tpu_torch.ops import cover as COV
    from patchperpix_tpu_torch.ops import cover_kernels as CK

    if cap.cascade is not None:
        c = cap.cascade
        ths = cs.pix_thresholds(c["ps"])
        args = (c["affs"], c["mask"], c["centers"], c["overlap_rows"],
                c["ps"], c["fc"], ths)
        want_sel, want_run = COV.cover_cascade_plain(*args)
        for kw in ({}, {"smem_cap": 0, "threads": 256},
                   {"smem_cap": 60000, "threads": 64, "chunk": 40}):
            sel, run, st = CK.cover_cascade_cuda(*args, **kw)
            assert np.array_equal(sel, want_sel), kw
            assert np.array_equal(run, want_run), kw
            assert st["takes"] == want_sel.sum() > 0
            assert st["visits"] >= st["takes"]
    t = cap.thin
    args = (t["affs"], t["mask"], t["centers"], t["ps"], t["fc"])
    want = COV.thin_cover_plain(*args, max_it=cap_it)
    for kw in ({}, {"smem_cap": 0, "threads": 128},
               {"smem_cap": 60000, "threads": 256}):
        sel, st = CK.thin_cover_cuda(*args, max_it=cap_it, **kw)
        assert np.array_equal(sel, want), kw
        assert st["capped"] == (cap_it is not None)
        assert st["rounds"] >= st["picks"]
    return int(want.sum())


def test_cover_kernels_on_the_3d_crop_input(dev, main_path):
    """K6 on the f32 main path's thin-cover input (the FlyLight crop,
    7^3 patches), uncapped and with the lazy loop capped at a quarter of
    its candidates (the full loop takes over)."""
    cap, run = main_path["cap"], main_path["run"]
    n = len(cap.thin["centers"])
    assert n == len(run["inter"]["cover_centers"]) > 1000
    kept = _cover_equal(cap)
    assert kept == len(run["inter"]["thin_centers"])
    assert _cover_equal(cap, cap_it=n // 4) == kept


def test_cover_kernels_on_the_2d_b_input(dev, path2d):
    """K5 and K6 on 2D setting (B)'s inputs (the 16-worm image at 520x696,
    25x25 patches, dense-data cover, overlaps)."""
    cap, inter = path2d["cap"], path2d["runs"]["B"][1]
    assert len(cap.cascade["centers"]) == len(inter["ranked_centers"])
    assert _cover_equal(cap) == len(inter["thin_centers"])


def test_cover_kernels_from_several_threads(dev):
    """Blockwise assembly launches from several host threads on one
    stream: each launch has its own scratch and gives the plain result."""
    from concurrent.futures import ThreadPoolExecutor

    from patchperpix_tpu_torch.ops import cover as COV
    from patchperpix_tpu_torch.ops import cover_kernels as CK
    from patchperpix_tpu_torch.ops import synthetic

    cases = []
    for seed in range(6):
        rng = np.random.RandomState(seed)
        lab = np.zeros((24, 26, 28), np.int32)
        for k in range(1, 5):
            z, y, x = rng.randint(4, 20, 3)
            lab[z - 3:z + 4, y - 4:y + 5, x - 5:x + 6] = k
        affs = synthetic.labels_to_affinities(lab, np.array((5, 5, 5)))
        affs = np.clip(affs * 0.8 + 0.2 * rng.rand(*affs.shape), 0, 1)
        mask = lab > 0
        centers = np.argwhere(mask)[rng.permutation(int(mask.sum()))]
        cases.append((torch.as_tensor(affs.astype(np.float32), device=dev),
                      mask, centers))

    def both(case):
        a, mask, centers = case
        ovl = np.zeros(len(centers), bool)
        sel, run, _ = CK.cover_cascade_cuda(a, mask, centers, ovl,
                                            (5, 5, 5), 0.5, (50, 10, 0))
        thin, _ = CK.thin_cover_cuda(a, mask, centers[sel], (5, 5, 5), 0.5)
        return sel, run, thin

    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(both, cases * 2))
    for (a, mask, centers), (sel, run, thin) in zip(cases * 2, got):
        want_sel, want_run = COV.cover_cascade_plain(
            a, mask, centers, np.zeros(len(centers), bool), (5, 5, 5), 0.5,
            (50, 10, 0))
        assert np.array_equal(sel, want_sel)
        assert np.array_equal(run, want_run)
        assert np.array_equal(thin, COV.thin_cover_plain(
            a, mask, centers[sel], (5, 5, 5), 0.5))
