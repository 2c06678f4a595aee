"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
on the GPU machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerances: consensus 1e-4 absolute and relative, rank 1e-3 absolute /
1e-4 relative (the JAX package's own kernel tolerances, 3D and 2D); a bf16
half within one rounding step of the stored type (2^-7 relative); the
row-window probe 1e-4 absolute; the cover kernels K5 / K6 equal to their
host loops bit for bit (integer counts).  The CLI on the FlyLight crop holds its
map against chip_smoke.py's f32 main path under chip_smoke.py's phase 4
limits (the CLI stages the heads and affinities through float16 stores).
"""

import os

import numpy as np
import pytest
import torch

from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
from patchperpix_tpu_torch.ops import probe as PR
from chip_smoke import REPO, WGRAD_SHAPES

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


# -- the CLI on the card -----------------------------------------------------

@pytest.fixture(scope="module")
def crop_cli(dev, tmp_path_factory):
    """The port's CLI on the FlyLight crop on the card, f32, at
    chip_smoke.run_path's assembly settings (pt 0.6, no skeleton, rm 400):
    ``predict decode label evaluate`` and, in a second experiment,
    ``infer_fused``; returns the experiments' paths."""
    import chip_smoke
    from patchperpix_tpu_torch import cli, weights

    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    data.mkdir()
    os.symlink(chip_smoke.FIXTURE,
               data / os.path.basename(chip_smoke.FIXTURE))
    over = root / "over.toml"
    over.write_text(f'[model]\ndtype = "float32"\n[data]\n'
                    f'test_data = "{data}"\n')
    argv = ["-c", chip_smoke.CLI_CONFIG, "-c", str(over), "--root",
            str(root), "--checkpoint", "1",
            "--set", "vote_instances.patch_threshold=0.6",
            "--set", "vote_instances.skeletonize_foreground=False",
            "--set", "vote_instances.remove_small_comps=400"]
    for expid in ("label", "fused"):
        weights.write_checkpoint(weights.load_npz(),
                                 str(root / expid / "train"), 1)
    n1, n2 = K.CONSENSUS.launches, K.RANK.launches
    label = cli.main(argv + ["-id", "label", "-d", "predict", "decode",
                             "label", "evaluate"])
    launches = (K.CONSENSUS.launches - n1, K.RANK.launches - n2)
    fused = cli.main(argv + ["-id", "fused", "-d", "infer_fused"])
    return label, fused, launches


def _result(paths):
    import chip_smoke
    from patchperpix_tpu_torch.utils.io import IoHDF5

    sample = os.path.splitext(os.path.basename(chip_smoke.FIXTURE))[0]
    return IoHDF5(os.path.join(paths["test_instanced"], "1",
                               sample + ".hdf"))


def test_cli_on_the_card_agrees_with_run_path(dev, crop_cli):
    """The CLI's staged path (f16 stores between the tasks) against
    chip_smoke.run_path's device-resident f32 run, under chip_smoke's
    phase 4 limits; K1 and K2 run inside the CLI."""
    import chip_smoke
    from patchperpix_tpu_torch.utils.io import IoZarr
    from patchperpix_tpu_torch.weights import build_model

    label, _, launches = crop_cli
    assert launches[0] >= 1 and launches[1] >= 1
    res = _result(label)
    inst = res.read(key="vote_instances")
    cfg = chip_smoke.crop_config("float32")
    raw = np.clip(IoZarr(chip_smoke.FIXTURE).read(key="volumes/raw")
                  .astype(np.float32), 0, 1500.0) / 1500.0
    run = chip_smoke.run_path(build_model(cfg, device=dev), cfg, raw, dev)
    fg = res.read(key="vote_foreground") > 0
    assert np.mean(fg == run["fg"]) >= 0.999
    assert chip_smoke.n_instances(inst) == chip_smoke.n_instances(
        run["inst"])
    assert chip_smoke.match_agreement(inst, run["inst"])[0] >= 0.99


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


# -- training -------------------------------------------------------------------

# the U-Net of _small_train with valid padding: its 3x3x3 convolutions,
# each of which takes the weight-gradient kernel in exact-f32 training
SMALL_VALID_CONVS = 6


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
    same padding (cuDNN throughout) and with valid padding, where the
    card's step takes each U-Net weight gradient from the kernel
    (``ops/conv_kernels.py``) and the CPU's from nn.Conv3d."""
    from patchperpix_tpu_torch import weights
    from patchperpix_tpu_torch.models import PPPModel
    from patchperpix_tpu_torch.models.init import init_tree
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.ops.affinities import sample_fg_corners
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     compute_losses)
    from patchperpix_tpu_torch.utils.device import exact_f32

    for padding, routed in (("same", 0), ("valid", SMALL_VALID_CONVS)):
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
            n0 = CK.WGRAD.launches
            with exact_f32():
                loss, mets = compute_losses(
                    model, cfg, TrainConfig(), torch.from_numpy(raw).to(d),
                    torch.from_numpy(labels).to(d), corners=corners.to(d))
                loss.backward()
            assert CK.WGRAD.launches - n0 == (routed if d.type == "cuda"
                                              else 0), padding
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
    import chip_smoke
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    s = td.load_sample(chip_smoke.FIXTURE, "volumes/raw",
                       "volumes/gt_instances", clipmax=1500)
    ds = DeviceSampler([s], chip_smoke.train_sampler_config(td),
                       max_gt_channels=3, device=dev)
    a = ds.sample_batch(torch.Generator(device=dev).manual_seed(3))
    b = ds.sample_batch(torch.Generator(device=dev).manual_seed(3))
    assert a[0].is_cuda and a[0].shape == (3, 3, 40, 40, 40)
    assert a[1].shape == (3, 3, 46, 46, 46)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = ds.sample_batch(torch.Generator(device=dev).manual_seed(4))
    assert not torch.equal(a[0], c[0])


def test_bf16_step_keeps_f32_parameters_and_adam_state(dev):
    import dataclasses

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
    valid U-Net in exact f32, so that each step's weight gradients come
    from the kernel (``ops/conv_kernels.py``) and are held to it too."""
    import chip_smoke
    from patchperpix_tpu_torch.models import PPPModel
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     make_optimizer,
                                                     make_train_step)
    from patchperpix_tpu_torch.utils.device import exact_f32

    cfg, _, _ = _small_train(padding="valid")
    s = td.load_sample(chip_smoke.FIXTURE, "volumes/raw",
                       "volumes/gt_instances", clipmax=1500)
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
        n0 = CK.WGRAD.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                raw, labels, _ = ds.sample_batch(gen)
                mets = step(raw, labels, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert CK.WGRAD.launches - n0 == 3 * SMALL_VALID_CONVS
    assert np.isfinite(float(mets["loss"]))


# -- the weight gradient of the U-Net's convolutions ----------------------------

@pytest.mark.parametrize("ci,co,e", WGRAD_SHAPES)
def test_conv_wgrad_kernel_matches_plain_at_the_cells_shapes(dev, ci, co, e):
    """The kernel against its plain version in float64 at each valid 3x3x3
    convolution of the published FlyLight U-Net at batch 2 of 140^3: dW
    and dB within 1e-5 of their largest value (float32 sums of up to 5 M
    products each in split-K order, which read 1e-6 to 5e-6 there), and
    the same bits from a second call (a fixed order of summation)."""
    import chip_smoke
    from patchperpix_tpu_torch.ops import conv_kernels as CK

    x, dy = chip_smoke.wgrad_inputs(ci, co, e, dev)
    n0 = CK.WGRAD.launches
    dw, db = CK.conv3d_wgrad(x, dy)
    assert CK.WGRAD.launches == n0 + 1
    rw, rb = CK.conv3d_wgrad_plain(x.double(), dy.double())
    for got, want in ((dw, rw), (db, rb)):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err <= chip_smoke.WGRAD_TOL, err
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
    140^3 in exact f32 under a profiler: one kernel call for each U-Net
    convolution it serves (9 of 14: the five with 128 or more channels
    on both sides stay on cuDNN), counted by the wrapper and by the
    route's counters beside the decoder's five convolutions."""
    import json

    from patchperpix_tpu_torch.models import PPPConfig, PPPModel, unet
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.utils import trace
    from patchperpix_tpu_torch.utils.device import exact_f32

    with open(os.path.join(REPO, "portbench", "configs",
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
    n0 = CK.WGRAD.launches
    with exact_f32(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("test.step"):
            h1, h2 = model(raw)
            (h1.sum() + h2.sum() + model.decode(codes).sum()).backward()
    counts = trace.summary()["counts"]
    assert CK.WGRAD.launches - n0 == 9
    assert counts["conv.wgrad_hand"] == 9
    assert counts["conv.wgrad_cudnn"] == 5 + 5
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_conv_wgrad_routed_valid_step_equals_jax(dev):
    """chip_smoke.py's valid branch of gate (a): the trained crop code
    model with valid padding on 52^3 crops, one exact-f32 step on the card
    with its nine narrow valid 3x3x3 convolutions on the kernel, against
    the JAX package's CPU step (parity/torch_port_train_valid_ref_f32.*)
    under chip_smoke's step limits."""
    import json

    import chip_smoke as cs
    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.ops import conv_kernels as CK
    from patchperpix_tpu_torch.train import data as td

    ref = np.load(cs.TRAIN_VALID_REF_NPZ)
    meta = json.load(open(cs.TRAIN_VALID_REF_JSON))
    raw, labels, _, _ = cs.train_batch(td, ref["centres"],
                                       cs.TRAIN_VALID_EXTENT)
    n0 = CK.WGRAD.launches
    res = cs.step_errors(
        dev, "valid", cs.train_model_config(models, cs.CLI_CONFIG,
                                            padding="valid"),
        weights.load_npz(), raw, labels, meta["branches"]["valid"], ref,
        corners=torch.from_numpy(ref["corners"].astype(np.int64)))
    assert CK.WGRAD.launches - n0 == cs.TRAIN_VALID_ROUTED
    cs.gate_step({"valid": res})


# -- the ISBI 2012 slice -------------------------------------------------------

def test_isbi_assembly_on_the_card_equals_the_fixture(dev):
    """The rehearsal's assembly on the ideal affinities of isbi_test_00 at
    512^2 (94 % foreground) on the card: the JAX package's map (identical
    up to relabelling) and candidate count from
    parity/torch_port_isbi_ref_f32.npz; K3 and K4 launched once each."""
    import json

    import chip_smoke as cs
    from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                                to_instance_seg)

    ref = np.load(cs.ISBI_REF_NPZ)
    meta = json.load(open(cs.ISBI_REF_JSON))["assembly"][cs.ISBI_TEST[0]]
    affs, fg, _ = cs.isbi_ideal(cs.ISBI_TEST[0])
    n0 = (K.CONSENSUS2D.launches, K.RANK2D.launches)
    inter = {}
    inst, fg_out = to_instance_seg(
        torch.from_numpy(affs).to(dev), fg, fg.copy(), fg.astype(np.uint8),
        VoteInstancesParams.from_config(cs.isbi_vote_kwargs()), device=dev,
        intermediates=inter)
    assert (K.CONSENSUS2D.launches - n0[0], K.RANK2D.launches - n0[1]) == \
        (1, 1)
    inst[fg_out == 0] = 0
    assert len(inter["ranked_centers"]) == meta["n_candidates"]
    agree, same = cs.match_agreement(inst, ref[f"a/{cs.ISBI_TEST[0]}/inst"])
    assert same, agree


def test_kernels_2d_on_the_isbi_input(dev):
    """K3 / K4 against their plain versions on the ISBI input (dense
    foreground, 25x25), f32 and bf16 half; two launches equal."""
    import dataclasses

    import chip_smoke as cs
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


def test_device_sampler_2d_on_the_card_equals_the_host(dev):
    """The 2D device sampler's batches on the card (the rehearsal's
    sampler over the stand-in's training samples) against the host
    sampler's numpy on the same decisions: raw 1e-6, labels equal."""
    import chip_smoke as cs
    from patchperpix_tpu_torch.train import data as td
    from patchperpix_tpu_torch.train.device_data import DeviceSampler

    samples = [td.load_sample(os.path.join(
        cs.ISBI_DATA, "train", f"isbi_train_0{i}.zarr"), "volumes/raw",
        "volumes/gt_instances") for i in range(3)]
    ds = DeviceSampler(samples, cs.isbi_sampler_config(td),
                       max_gt_channels=1, device=dev)
    seen = cs.check_sampler_alignment(ds, samples, td, draws=6)
    assert seen["flip"] and seen["transpose"]


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


# -- the cover loops (K5, K6) ---------------------------------------------------

def _cover_equal(cap, cap_it=None):
    """K5 on ``cap``'s cascade input (where it has one) and K6 on its thin
    input against their plain versions (the host loops): selections, and
    the cascade's still-uncovered volume, equal bit for bit; everything
    staged in shared memory, nothing (``smem_cap=0``), and part of it (60
    KB: the running bits, not the masks), at several block sizes and, for
    the cascade, chunks of 40."""
    import chip_smoke as cs
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


def test_cover_kernels_on_the_3d_crop_input(dev):
    """K6 on the f32 main path's thin-cover input (the FlyLight crop,
    7^3 patches), uncapped and with the lazy loop capped at a quarter of
    its candidates (the full loop takes over)."""
    import chip_smoke as cs
    from patchperpix_tpu_torch.utils.io import IoZarr
    from patchperpix_tpu_torch.weights import build_model

    io = IoZarr(cs.FIXTURE)
    raw = np.clip(io.read(key="volumes/raw").astype(np.float32), 0,
                  1500.0) / 1500.0
    cfg = cs.crop_config("float32")
    with cs.CoverCapture() as cap:
        run = cs.run_path(build_model(cfg, device=dev), cfg, raw, dev)
    n = len(cap.thin["centers"])
    assert n == len(run["inter"]["cover_centers"]) > 1000
    kept = _cover_equal(cap)
    assert kept == len(run["inter"]["thin_centers"])
    assert _cover_equal(cap, cap_it=n // 4) == kept


def test_cover_kernels_on_the_2d_b_input(dev):
    """K5 and K6 on 2D setting (B)'s inputs (the 16-worm image at 520x696,
    25x25 patches, dense-data cover, overlaps)."""
    import chip_smoke as cs

    full = cs.path2d_inputs("B")
    with cs.CoverCapture() as cap:
        _, inter = cs.assemble_2d("B", full, torch.as_tensor(
            full["affs"], device=dev), dev)
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
