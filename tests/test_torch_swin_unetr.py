"""The published Swin UNETR backbone (``network_style =
"swinunetr_monai"``, ``models/swin_unetr.py``) against the benchmark's
plain reference of it (``portbench/reference/swin_unetr.py``), on the CPU
with seeded random weights.

The model is the published layout cut in width: feature 12, heads
3/6/12/24 (head dimension 4), window 7, on 64^3 inputs.  64^3 and not
smaller: with four stages and the merge after the last, the bottleneck
is the input / 32, and instance norm has no statistics at 1^3 (MONAI's
``SwinUNETR`` asks for extents divisible by 32 for that reason).  The
stages then lie at 32, 16, 8 and 4: padded and shifted, and clipped.

Tolerances: the forward within 1e-6 of the largest value (float32; the
same products in the same order on both sides, so rounding alone); a
gradient leaf's norm within 1e-5 of the larger of its own and the
median leaf's (the benchmark's ``leaf_gaps``: float32 sums of up to 2^18
terms in another order); one Adam step's change within 1e-3 (Adam's
first step moves a parameter by about lr * sign(g), so an element whose
gradient lies at round-off flips; ``moved_leaves`` drops the leaves
whose gradient is under 1e-3 of the median leaf's, as the benchmark
does).  The window machinery (indices, masks, merge order) is held
exactly.  No JAX here.
"""

from __future__ import annotations

import itertools
import os

import numpy as np
import pytest
import torch

from patchperpix_tpu_torch import weights
from patchperpix_tpu_torch.config import load_config
from patchperpix_tpu_torch.models import PPPConfig, PPPModel
from patchperpix_tpu_torch.models import swin_unetr as S
from patchperpix_tpu_torch.models.init import init_tree
from patchperpix_tpu_torch.models.swin import _shift_regions
from patchperpix_tpu_torch.train import trainer as T
from patchperpix_tpu_torch.utils import trace
from portbench.counts import swin as counts
from portbench.reference import model as ref_model
from portbench.reference import swin_unetr as R
from portbench.reference import train as ref_train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (64, 64, 64)
FORWARD_TOL, GRAD_TOL, CHANGE_TOL = 1e-6, 1e-5, 1e-3
LR = 1e-4

SMALL = dict(
    network_style="swinunetr_monai", num_fmaps=12, swin_depths=[2, 2, 2, 2],
    swin_heads=[3, 6, 12, 24], swin_window=7, patchshape=[7, 7, 7],
    num_channels=3, max_num_inst=2, train_padding="same",
    overlapping_inst=True, train_code=True, code_units=176,
    autoencoder=dict(num_fmaps=[8, 16], code_fmaps=22, num_repetitions=2,
                     downsample_factors=[[2, 2, 2], [2, 2, 2]],
                     num_code_samples=64))


def _net_cfg(model: dict) -> dict:
    return ref_model.net_config({"model": model})


def _batch(seed=1, size=SIZE, n=2):
    """A raw batch and context-padded labels: two overlapping boxes per
    item and noise."""
    rng = np.random.RandomState(seed)
    raw = rng.rand(n, 3, *size).astype(np.float32)
    labels = np.zeros((n, 2) + tuple(s + 6 for s in size), np.int32)
    for b in range(n):
        lo = rng.randint(4, 20, 3)
        labels[b, 0, lo[0]:lo[0] + 30, lo[1]:lo[1] + 30, lo[2]:lo[2] + 30] = 1
        labels[b, 1, lo[0] + 20:lo[0] + 44, lo[1] + 10:lo[1] + 40,
               lo[2] + 5:lo[2] + 35] = 2
    return torch.from_numpy(raw), torch.from_numpy(labels)


@pytest.fixture(scope="module")
def pair():
    """(the port's model, its Flax-layout tree as tensors, the reference
    network over the same tree) at the small size."""
    cfg = PPPConfig.from_config(SMALL)
    tree = init_tree(cfg, torch.Generator().manual_seed(0))
    model = PPPModel(cfg)
    model.load_state_dict(weights.to_state_dict(tree), strict=True)
    params = {k: torch.as_tensor(v) for k, v in tree.items()}
    return model, tree, R.SwinUNETRNet(_net_cfg(SMALL),
                                       ref_model.strip(params))


@pytest.fixture(scope="module")
def steps(pair):
    """One training step of the ppp+dec loss on both sides: the port's
    ``make_train_step`` with Adam, the reference's ``reference_steps``,
    from one generator state."""
    model, tree, _ = pair
    model = PPPModel(PPPConfig.from_config(SMALL))
    model.load_state_dict(weights.to_state_dict(tree), strict=True)
    cfg = PPPConfig.from_config(SMALL)
    tcfg = T.TrainConfig(lr=LR, use_gt_extra=True)
    opt, sched = T.make_optimizer(tcfg, model.parameters())
    step, _ = T.make_train_step(model.train(), cfg, tcfg, opt, sched)
    raw, labels = _batch()
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    named = dict(model.named_parameters())
    start = {k: p.detach().clone() for k, p in named.items()}
    mets = step(raw, labels, gen)
    flax = weights.from_state_dict
    prog = {
        "loss": float(mets["loss"]),
        "grad1": flax({k: opt.state[p]["exp_avg"] / (1 - 0.9)
                       for k, p in named.items()}),
        "change": flax({k: p.detach() - start[k]
                        for k, p in named.items()})}
    ref = R.reference_steps(_net_cfg(SMALL), tree,
                            [(raw.numpy(), labels.numpy())], [state],
                            torch.device("cpu"), lr=LR)
    return prog, ref


def test_forward_equals_the_reference(pair):
    model, _, net = pair
    raw, _ = _batch()
    with torch.no_grad():
        got = model(raw)
        want = net.forward(raw)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, g.shape[1]) + SIZE
        assert float((g - w).abs().max() / w.abs().max()) <= FORWARD_TOL


@pytest.mark.parametrize("what", ["loss", "grad1", "change"])
def test_one_adam_step_equals_the_reference(steps, what):
    prog, ref = steps
    if what == "loss":
        assert abs(prog["loss"] - ref["losses"][0][0]) <= \
            1e-6 * abs(ref["losses"][0][0])
        return
    assert set(prog[what]) == set(ref[what])
    if what == "grad1":
        assert ref_train.leaf_gaps(prog[what], ref[what]) <= GRAD_TOL
        assert all(float(v.norm()) > 0 for v in ref[what].values())
    else:
        kept = ref_train.moved_leaves(ref["grad1"])
        assert ref_train.leaf_gaps(prog[what], ref[what], kept) <= CHANGE_TOL


# -- the window machinery ------------------------------------------------------

@pytest.mark.parametrize("extent,window,shift", [
    ((5, 5, 5), (5, 5, 5), (0, 0, 0)),      # below the window: clipped
    ((7, 7, 7), (7, 7, 7), (0, 0, 0)),      # equal: clipped, no shift
    ((9, 9, 9), (7, 7, 7), (3, 3, 3)),      # above: padded to 14, shifted
    ((9, 6, 12), (7, 6, 7), (3, 0, 3)),     # mixed
])
def test_window_clipping_and_shift(extent, window, shift):
    assert S.window_and_shift(extent, (7,) * 3, True) == (window, shift)
    assert S.window_and_shift(extent, (7,) * 3, False) == (window, (0,) * 3)
    assert R.window_size(extent, (7,) * 3, (3,) * 3) == (window, shift)


def _block_pair(dim, heads, shifted, seed=3):
    blk = S.SwinBlock(dim, heads, (7, 7, 7), shifted)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    tree = weights.from_state_dict(
        {"b." + k: v for k, v in blk.state_dict().items()})
    cfg = _net_cfg(dict(SMALL, num_fmaps=dim))
    return blk, R.SwinUNETRNet(cfg, ref_model.strip(tree))


@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("extent", [(5, 5, 5), (7, 7, 7), (9, 9, 9),
                                    (9, 6, 12)])
def test_block_equals_the_reference(extent, shifted):
    """A Swin block at extents below, at and above the window (clipped,
    clipped, padded and rolled) against the reference's block."""
    blk, net = _block_pair(8, 2, shifted)
    x = torch.randn((2,) + extent + (8,),
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = blk(x)
        want = net.block(x, "b", 2, shifted)
    assert float((got - want).abs().max() / want.abs().max()) <= FORWARD_TOL


@pytest.mark.parametrize("padded,window,shift", [
    ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
    ((14, 7, 21), (7, 7, 7), (3, 0, 3)),
    ((6, 6, 6), (6, 6, 6), (0, 0, 0)),
])
def test_shift_mask_equals_monais(padded, window, shift):
    """The port's region map of the rolled, padded extent, as its -100 / 0
    mask, against MONAI's ``compute_mask``."""
    regions = torch.as_tensor(_shift_regions(padded, window, shift))
    got = S.region_mask(regions, torch.float32)
    want = R.compute_mask(padded, window, shift, "cpu")
    assert got.shape == want.shape == (
        int(np.prod(padded)) // int(np.prod(window)),) + (
        int(np.prod(window)),) * 2
    assert torch.equal(got, want)
    if any(shift):
        assert (got == S.MASK_VALUE).any()


@pytest.mark.parametrize("n", [343, 216, 64])
def test_relative_index_is_the_full_windows_cut(n):
    """A clipped window of n tokens indexes the full 7^3 window's table
    with its first n x n relative positions, as MONAI does."""
    att = S.WindowAttention(6, 3, (7, 7, 7))
    got = att.index(n, torch.device("cpu"))
    want = R.relative_position_index((7, 7, 7))[:n, :n]
    assert torch.equal(got, want)
    assert int(got.max()) < att.rel_pos_bias.shape[0] == 13 ** 3


@pytest.mark.parametrize("extent", [(4, 4, 4), (5, 6, 3)])
def test_merge_order_is_patch_merging_v2(extent):
    """Channel block 4i + 2j + k of the merged token holds the neighbour
    x[2a + i, 2b + j, 2c + k] (``itertools.product`` order), odd extents
    zero-padded at the end; the port equals the reference's merge."""
    c = 2
    merge = S.PatchMerging(c)
    with torch.no_grad():
        merge.LayerNorm_0.weight.fill_(1.0)
        merge.LayerNorm_0.bias.zero_()
    x = torch.randn((1,) + extent + (c,),
                    generator=torch.Generator().manual_seed(6))
    cat = {}

    def keep(mod, inp, out):
        cat["in"] = inp[0]

    hook = merge.Dense_0.register_forward_hook(keep)
    with torch.no_grad():
        merge(x)
    hook.remove()
    pad = torch.nn.functional.pad(
        x, (0, 0, 0, extent[2] % 2, 0, extent[1] % 2, 0, extent[0] % 2))
    order = list(itertools.product(range(2), repeat=3))
    full = torch.cat([pad[:, i::2, j::2, k::2] for i, j, k in order], -1)
    assert full.shape[1:4] == tuple((e + 1) // 2 for e in extent)
    normed = torch.nn.functional.layer_norm(full, (8 * c,), eps=S.LN_EPS)
    assert torch.equal(cat["in"], normed)
    for q, (i, j, k) in enumerate(order):
        assert q == 4 * i + 2 * j + k
    tree = weights.from_state_dict(
        {"m." + k: v for k, v in merge.state_dict().items()})
    net = R.SwinUNETRNet(_net_cfg(SMALL), ref_model.strip(tree))
    with torch.no_grad():
        assert torch.equal(merge(x), net.merge(x, "m"))


def test_hidden_states_are_layer_normed_over_channels(pair):
    """The decoder reads each hidden state (the patch embed's, then each
    merge's) through a LayerNorm over channels without an affine; they
    equal the reference's."""
    model, _, net = pair
    raw, _ = _batch()
    with torch.no_grad():
        hs = model.unet.encode(raw)
        want = net.hidden_states(raw)
    assert [h.shape[1:] for h in hs] == [
        (12 * 2 ** i,) + tuple(s // 2 ** (i + 1) for s in SIZE)
        for i in range(5)]
    for h, w in zip(hs, want):
        normed = torch.nn.functional.layer_norm(
            h.movedim(1, -1), (h.shape[1],), eps=1e-5).movedim(-1, 1)
        assert float((normed - w).abs().max()) <= FORWARD_TOL * 10
        m = normed.mean(dim=1)
        assert float(m.abs().max()) < 1e-5


# -- from the configuration ----------------------------------------------------

def test_published_style_from_the_toml():
    """configs/flylight_swin_unetr.toml builds the published model: feature
    48, depths 2/2/2/2, heads 3/6/12/24, window 7, 62.19 M parameters in
    the backbone, the heads on 48 channels; the benchmark's configuration
    states the same model."""
    config = load_config(os.path.join(REPO, "configs",
                                      "flylight_swin_unetr.toml"))
    cfg = PPPConfig.from_config({**config["model"], "num_channels":
                                 config["data"]["num_channels"]})
    assert (cfg.network_style, cfg.num_fmaps, cfg.swin_depths,
            cfg.swin_heads, cfg.swin_window) == (
        "swinunetr_monai", 48, (2, 2, 2, 2), (3, 6, 12, 24), 7)
    with torch.device("meta"):
        model = PPPModel(cfg)
    assert sum(p.numel() for p in model.unet.parameters()) == 62_190_066
    assert model.head_code_affs.in_channels == 48
    heads = [b.WindowAttention_0.num_heads for b in model.unet.modules()
             if isinstance(b, S.SwinBlock)]
    assert heads == [3, 3, 6, 6, 12, 12, 24, 24]
    import json

    with open(os.path.join(REPO, "portbench", "configs",
                           "flylight_swin_unetr.json")) as f:
        bench = json.load(f)
    assert PPPConfig.from_config(bench["model"]) == cfg
    leaves = R.leaf_shapes(ref_model.net_config(bench), 3)
    sd = weights.from_state_dict(model.state_dict())
    assert {k: tuple(v.shape) for k, v in sd.items()} == dict(leaves)


def test_other_styles_unchanged_by_the_new_keys():
    """The new keys have defaults and the unet / swinunetr styles build
    the same modules as without them."""
    for style in ("unet", "swinunetr"):
        base = dict(patchshape=[7, 7, 7], network_style=style, num_fmaps=12,
                    train_padding="same")
        a = PPPConfig.from_config(base)
        b = PPPConfig.from_config(dict(base, swin_depths=[1, 1],
                                       swin_heads=[2, 4], swin_window=5))
        with torch.device("meta"):
            sa, sb = PPPModel(a).state_dict(), PPPModel(b).state_dict()
        assert {k: v.shape for k, v in sa.items()} == \
            {k: v.shape for k, v in sb.items()}


def test_trains_through_build_model_and_train_until(tmp_path):
    """``weights.build_model`` and ``train_until`` (init_tree's MONAI
    draws, Adam, the host ``Prefetcher``) take the style: two steps at a
    narrow size, finite losses, a checkpoint that rebuilds the model."""
    from patchperpix_tpu_torch.train import data as TD

    small = dict(SMALL, swin_depths=[2, 2, 2], swin_heads=[3, 6, 12])
    cfg = PPPConfig.from_config(small)
    tree = init_tree(cfg, torch.Generator().manual_seed(1))
    assert float(np.std(tree["params/unet/SwinBlock_0/Dense_0/kernel"])) \
        == pytest.approx(0.02, rel=0.1)
    rng = np.random.RandomState(0)
    labels = np.zeros((2, 48, 48, 48), np.int32)
    labels[0, 4:30, 4:30, 4:30] = 1
    labels[1, 20:44, 14:40, 10:36] = 2
    raw = np.clip((labels.sum(0) > 0)[None].repeat(3, 0)
                  + 0.1 * rng.randn(3, 48, 48, 48), 0, 1).astype(np.float32)
    sample = TD.SampleData(raw=raw, labels=labels,
                           fg_mask=(labels > 0).any(0),
                           overlap_mask=(labels > 0).sum(0) > 1)
    scfg = TD.SamplerConfig(
        input_shape=(32, 32, 32), output_shape=(32, 32, 32),
        patchshape=(7, 7, 7), batch_size=1,
        augment=TD.AugmentConfig(elastic=False, probability_overlay=0.0))
    pf = TD.Prefetcher(TD.CropSampler([sample], scfg), cache_size=2,
                       max_gt_channels=2)
    try:
        state = T.train_until(
            PPPModel(cfg), cfg, T.TrainConfig(
                max_iterations=2, checkpoints=2, snapshots=0,
                output_folder=str(tmp_path), log_every=1,
                tensorboard=False), pf, device="cpu")
    finally:
        pf.stop()
    assert state["step"] == 2
    ck = weights.load_checkpoint(str(tmp_path / "train_net_checkpoint_2"))
    model = weights.build_model(cfg, ck["params"], device="cpu")
    with torch.no_grad():
        h1, h2 = model(torch.from_numpy(raw[None, :, :32, :32, :32]))
    assert torch.isfinite(h1).all() and h2.shape == (1, 3, 32, 32, 32)


# -- spans and counters --------------------------------------------------------

@pytest.fixture(scope="module")
def traced(pair):
    """What a forward of the small model records under a profiler, and
    without one."""
    model, _, _ = pair
    raw, _ = _batch()
    trace.summary()   # close a session an earlier test left open
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with torch.no_grad():
            model(raw)
    on = trace.summary()
    with torch.no_grad():
        model(raw)
    return on, trace.summary()


@pytest.mark.parametrize("name,count", [("swin.encoder", 1),
                                        ("swin.attention", 8),
                                        ("swin.decoder", 1)])
def test_spans_recorded_under_a_profiler(traced, name, count):
    on, off = traced
    assert on["spans"][name]["count"] == count
    assert on["spans"][name]["host_s"] > 0
    assert off == on   # nothing more recorded once the profiler stopped


@pytest.mark.parametrize("name", ["tokens", "window_tokens"])
def test_token_counters_equal_the_benchmarks_counts(traced, name):
    """``swin.tokens`` / ``swin.window_tokens`` equal what the benchmark's
    counts expect (``counts/swin.py``): 64^3 stages of 32 (padded to 35),
    16 (21), 8 (14) and 4 (clipped)."""
    on, _ = traced
    want = counts.attention(_net_cfg(SMALL), SIZE, 2)[name]
    assert on["counts"]["swin." + name] == want
    fill = counts.attention(_net_cfg(SMALL), (96,) * 3, 4)
    assert fill["tokens"] / fill["window_tokens"] == pytest.approx(
        126_360 / 142_561)


# -- the benchmark's cell at a small size ----------------------------------------

@pytest.fixture(scope="module")
def cell_line(tmp_path_factory):
    """One traced CPU run of ``flylight_swin_unetr.train`` through the
    benchmark's runner, its configuration cut to feature 12, batch 2 of
    64^3 crops (the volume reflected to 128^3) and 64 code samples."""
    import json
    import time

    from portbench import run as runner

    root = tmp_path_factory.mktemp("swin_cell")
    pb = os.path.join(REPO, "portbench")
    for name in ("traffic", "drivers", "metrics"):
        os.symlink(os.path.join(pb, name), root / name)
    (root / "configs").mkdir()
    with open(os.path.join(pb, "configs", "flylight_swin_unetr.json")) as f:
        cfg = json.load(f)
    cfg["model"]["num_fmaps"] = 12
    cfg["model"]["autoencoder"].update(num_fmaps=[8, 16],
                                       num_code_samples=64)
    cfg["train_input_shape"] = cfg["train_output_shape"] = list(SIZE)
    cfg["data"]["reflect_to"] = [128, 128, 128]
    cfg["training"]["batch_size"] = 2
    with open(root / "configs" / "flylight_swin_unetr.json", "w") as f:
        json.dump(cfg, f)
    args = runner.parse(["--workload", "flylight_swin_unetr.train",
                         "--seed", str(2 ** 31 + 12345), "--seconds", "1",
                         "--trace", "1"])
    return runner.run(args, root=str(root),
                      bench_path=os.path.join(REPO, "BENCHMARK.json"),
                      device=torch.device("cpu"), t0=time.perf_counter())


def test_cell_runs_correct_at_a_small_size(cell_line):
    assert cell_line["correct"]
    assert set(cell_line["checks"]) == {"data_err", "loss_err", "grad_err",
                                        "change_err"}
    assert cell_line["attempted"] >= 10 and cell_line["failed"] == 0


@pytest.mark.parametrize("metric", [
    "swin_attention_share.train", "swin_decoder_share.train",
    "swin_window_fill.train", "swin_attention_roofline.train",
    "mfu.train", "crop_window_ratio.train"])
def test_cell_readers_give_a_value(cell_line, metric):
    """The cell's new readers, and accepted ones listed for it, read the
    traced run; the window fill is the counts' ratio at 64^3."""
    value = cell_line["metrics"][metric]["value"]
    assert value > 0
    if metric == "swin_window_fill.train":
        want = counts.attention(_net_cfg(SMALL), SIZE, 2)
        assert value == pytest.approx(want["tokens"]
                                      / want["window_tokens"])
