"""Port's assembly and whole slice vs the JAX package, on the CPU.

The instance maps must be identical up to relabelling.  Their inputs
agree to ~1e-6 (float32 on both sides, sums in another order), and at
these sizes no threshold, rank order or graph edge order flips on that;
the full-size run on the card is held against the stored JAX reference
by tests/test_torch_cuda.py under the limits of parity/cases.py.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from patchperpix_tpu.assembly import VoteInstancesParams as JParams
from patchperpix_tpu.assembly import to_instance_seg as jax_assemble
from patchperpix_tpu.assembly.vote_instances import \
    numinst_from_probs as jax_numinst
from patchperpix_tpu.infer.fused import decode_volume_device as jax_decode
from patchperpix_tpu.infer.fused import predict_volume_device as jax_predict
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu.ops import synthetic
from patchperpix_tpu.utils.postprocess import \
    remove_small_components as jax_rm_small
from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                            numinst_from_probs,
                                            to_instance_seg)
from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                               predict_volume_device)
from patchperpix_tpu_torch.models import PPPConfig
from patchperpix_tpu_torch.utils.postprocess import remove_small_components
from patchperpix_tpu_torch.weights import build_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_VI = dict(patchshape=(7, 7, 7), patch_threshold=0.6, fc_threshold=0.5,
                overlapping_inst=True, mws=True,
                select_patches_for_sparse_data=True,
                skeletonize_foreground=False, numinst_threshs=(0.9, 0.1))


def same_up_to_relabelling(a, b) -> bool:
    """True iff a bijection of ids maps a onto b, with 0 <-> 0."""
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    if not np.array_equal(a == 0, b == 0):
        return False
    pairs = np.unique(np.stack([a, b], 1), axis=0)
    return len(np.unique(pairs[:, 0])) == len(pairs) == \
        len(np.unique(pairs[:, 1]))


def test_relabelling_helper():
    a = np.array([0, 1, 1, 2, 2, 0])
    assert same_up_to_relabelling(a, np.array([0, 5, 5, 3, 3, 0]))
    assert not same_up_to_relabelling(a, np.array([0, 5, 5, 5, 5, 0]))
    assert not same_up_to_relabelling(a, np.array([0, 1, 1, 2, 3, 0]))
    assert not same_up_to_relabelling(a, np.array([1, 1, 1, 2, 2, 0]))


@pytest.mark.parametrize("ps,mws", [((3, 3, 3), True), ((5, 5, 5), True)])
def test_two_blob_assembly_matches_jax(ps, mws):
    rng = np.random.RandomState(0)
    labels = synthetic.two_blob_labels_3d()
    affs = synthetic.labels_to_affinities(labels, np.array(ps))
    affs = np.clip(affs * 0.85 + 0.15 * rng.rand(*affs.shape), 0, 1
                   ).astype(np.float32)
    fg = labels > 0
    numinst = fg.astype(np.uint8)
    kw = dict(patchshape=ps, mws=mws, patch_threshold=0.5)
    want, _ = jax_assemble(affs, fg, fg.copy(), numinst,
                           JParams(engine="jax", **kw))
    got, fg_out = to_instance_seg(affs, fg, fg.copy(), numinst,
                                  VoteInstancesParams(**kw), device="cpu")
    assert got.dtype == np.uint16 and np.array_equal(fg_out, fg)
    assert len(np.unique(want)) == 3
    assert same_up_to_relabelling(got, want)


def test_candidate_sort_is_rank_patch_list():
    """to_instance_seg sorts the gathered candidate scores with a stable
    descending argsort; that is the host rank_patch_list order."""
    from patchperpix_tpu_torch.ops.np_reference import rank_patch_list

    rng = np.random.RandomState(0)
    scores = rng.randint(0, 5, size=(6, 7, 8)).astype(np.float32)
    cand = np.argwhere(scores > 0)
    svals = scores[tuple(cand.T)]
    order = np.argsort(-svals, kind="stable")
    want = rank_patch_list([tuple(c) for c in cand], scores)
    np.testing.assert_array_equal(cand[order], [c for c, _ in want])
    assert [float(v) for v in svals[order]] == [v for _, v in want]


def test_mws_and_paint_match_jax_on_reference_graph():
    """Mutex watershed and painting on the stored full-size graph of the
    JAX package's float32 run: same components, same map, exactly."""
    from patchperpix_tpu.ops import np_reference as JR
    from patchperpix_tpu_torch.ops import np_reference as TR

    ref = np.load(os.path.join(REPO, "parity", "torch_port_ref_f32.npz"))
    pairs, weights = ref["pairs"], ref["weights"]
    comps = TR.graph_components(pairs, weights)
    assert comps == JR.graph_components(pairs, weights, mws=True)
    assert len(comps) == int(ref["n_components"])
    rng = np.random.RandomState(0)
    patches = {c: rng.rand(343).astype(np.float32)
               for comp in comps for c in comp}
    np.testing.assert_array_equal(
        TR.components_to_instances(comps, patches, (7, 7, 7), (50, 50, 50),
                                   patch_threshold=0.6),
        JR.components_to_instances(comps, patches, (7, 7, 7), (50, 50, 50),
                                   patch_threshold=0.6))


S = 20


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX package's float32 bench pipeline on a 20^3 subcrop."""
    jm, jcfg = bench.crop_model()
    params = bench.load_trained_params(jm, jcfg)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    jm = JModel(jcfg)
    raw = bench.load_raw_clip()[:, :S, :S, :S]
    code, prob = jax_predict(jm, params, raw, jcfg, (S,) * 3, (S,) * 3)
    numinst = jax_numinst(np.asarray(prob), JParams(**BENCH_VI))
    fg = numinst > 0
    dec = jax_decode(jm, params, code, fg, jcfg)
    inst, _ = jax_assemble(dec, fg, fg.copy(), numinst,
                           JParams(engine="jax", **BENCH_VI))
    inst = np.asarray(inst).copy()
    inst[~fg] = 0
    return dict(raw=raw, cfg=jcfg, numinst=numinst, fg=fg,
                dec=np.asarray(dec), inst=jax_rm_small(inst, 25))


def test_assembly_of_jax_decode_matches_jax(jax_slice):
    j = jax_slice
    got, _ = to_instance_seg(j["dec"], j["fg"], j["fg"].copy(), j["numinst"],
                             VoteInstancesParams(**BENCH_VI), device="cpu")
    got[~j["fg"]] = 0
    got = remove_small_components(got, 25)
    assert len(np.unique(j["inst"])) >= 3
    assert same_up_to_relabelling(got, j["inst"])


def test_whole_slice_matches_jax(jax_slice):
    """Raw -> predict -> numinst -> decode -> assemble -> fg mask -> small
    component removal, all in the port, vs the JAX package."""
    j = jax_slice
    cfg = PPPConfig(**{f.name: getattr(j["cfg"], f.name)
                       for f in dataclasses.fields(j["cfg"])})
    model = build_model(cfg, device="cpu")
    vp = VoteInstancesParams(**BENCH_VI)
    code, prob = predict_volume_device(model, j["raw"], cfg, (S,) * 3,
                                       (S,) * 3, device="cpu")
    numinst = numinst_from_probs(prob.numpy(), vp)
    np.testing.assert_array_equal(numinst, j["numinst"])
    fg = numinst > 0
    dec = decode_volume_device(model, code, fg, cfg, device="cpu")
    np.testing.assert_allclose(dec.numpy(), j["dec"], atol=1e-4)
    timings, inter = {}, {}
    inst, _ = to_instance_seg(dec, fg, fg.copy(), numinst, vp,
                              device="cpu", timings=timings,
                              intermediates=inter)
    inst[~fg] = 0
    inst = remove_small_components(inst, 25)
    assert same_up_to_relabelling(inst, j["inst"])
    assert set(timings) == {"consensus", "rank", "cover", "thin_cover",
                            "pairs", "graph", "mws_paint"}
    assert len(inter["pairs"]) == len(inter["weights"]) > 0


def test_skeletonize_foreground_matches_jax(jax_slice, monkeypatch):
    """to_instance_seg with skeletonize_foreground: the port (plain
    kernels on the CPU) against the JAX package on the same decoded
    affinities, one skeleton of the mask; not when blockwise."""
    from patchperpix_tpu_torch.assembly import vote_instances as TV

    j = jax_slice
    vi = dict(BENCH_VI, skeletonize_foreground=True)
    want, _ = jax_assemble(j["dec"], j["fg"], j["fg"].copy(), j["numinst"],
                           JParams(engine="jax", **vi))
    calls = []
    real = TV.skeletonize
    monkeypatch.setattr(TV, "skeletonize",
                        lambda v: calls.append(v.shape) or real(v))
    timings = {}
    got, _ = to_instance_seg(j["dec"], j["fg"], j["fg"].copy(), j["numinst"],
                             VoteInstancesParams(**vi), device="cpu",
                             timings=timings)
    assert calls == [j["fg"].shape] and timings["skeletonize"] >= 0
    assert len(np.unique(want)) >= 3
    assert same_up_to_relabelling(got, want)
    to_instance_seg(j["dec"], j["fg"], j["fg"].copy(), j["numinst"],
                    VoteInstancesParams(**vi, blockwise=True), device="cpu")
    assert len(calls) == 1


def test_to_instance_seg_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    labels = synthetic.two_blob_labels_3d()
    affs = synthetic.labels_to_affinities(labels, np.array((3, 3, 3)))
    fg = labels > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_instance_seg(affs, fg, fg.copy(), fg.astype(np.uint8),
                        VoteInstancesParams(patchshape=(3, 3, 3)))


NO_JAX = r"""
import importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "orbax", "patchperpix_tpu", "PIL",
                                  "h5py", "tensorstore", "zarr",
                                  "numcodecs"):
            raise ImportError("blocked import of " + name)
        return None

sys.meta_path.insert(0, Block())
import os
import numpy as np, torch
torch.set_num_threads(1)
import patchperpix_tpu_torch
for m in pkgutil.walk_packages(patchperpix_tpu_torch.__path__,
                               "patchperpix_tpu_torch."):
    __import__(m.name)
from parity import cases
from patchperpix_tpu_torch.models import PPPConfig
from patchperpix_tpu_torch.weights import build_model
from patchperpix_tpu_torch.infer.fused import predict_volume_device
cfg = PPPConfig(patchshape=(7, 7, 7), num_channels=3, num_fmaps=20,
                fmap_inc_factors=(3, 3), fmap_dec_factors=(1.0, 1.0),
                downsample_factors=((2, 2, 2), (2, 2, 2)), padding="same",
                overlapping_inst=True, train_code=True)
model = build_model(cfg, device="cpu")
code, prob = predict_volume_device(
    model, np.random.RandomState(0).rand(3, 8, 8, 8).astype(np.float32),
    cfg, (8, 8, 8), (8, 8, 8), device="cpu")
assert code.shape == (176, 8, 8, 8) and prob.shape == (3, 8, 8, 8)
# the 2D slice: model, probe script, synthetic worms, assembly
import runpy
probe = runpy.run_path("scripts/probe_window_cuda.py", run_name="probe")
sys.argv = ["probe_window_cuda.py", "cpu"]
assert probe["main"]() == 0
cfg2 = PPPConfig(**{**cases.BBBC010_MODEL, "num_fmaps": 4,
                    "downsample_factors": ((1, 2, 2),) * 2,
                    "fmap_inc_factors": (2, 2),
                    "fmap_dec_factors": (1.0, 1.0)})
from patchperpix_tpu_torch.models import PPPModel
model2 = PPPModel(cfg2).eval()
code, prob = predict_volume_device(
    model2, np.random.RandomState(0).rand(1, 16, 16).astype(np.float32),
    cfg2, (16, 16), (16, 16), device="cpu")
assert code.shape == (512, 16, 16) and prob.shape == (3, 16, 16)
from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                            to_instance_seg)
from patchperpix_tpu_torch.ops import synthetic
labels = synthetic.worm_labels(72, 176, 2, seed=1)
inst, _ = to_instance_seg(
    synthetic.labels_to_affinities(labels, (1, 9, 9)), labels > 0,
    labels > 0, (labels > 0).astype(np.uint8),
    VoteInstancesParams(**{**cases.PATH2D["B"],
                           "patchshape": (1, 9, 9)}), device="cpu")
assert len(np.unique(inst)) == 3
# the out-of-core slice: predict to a store, decode it, TTA, blockwise
import tempfile
from patchperpix_tpu_torch.assembly.blockwise import (
    blockwise_vote_instances, blockwise_vote_instances_zarr)
from patchperpix_tpu_torch.infer.decode import CodeDecoder, decode_sample
from patchperpix_tpu_torch.infer.predict import predict_sample_to_zarr
from patchperpix_tpu_torch.infer.tta import predict_tta
from patchperpix_tpu_torch.utils.io import IoZarr, check_file
from patchperpix_tpu_torch.utils.postprocess import clean_mask, relabel
cfg3 = PPPConfig(patchshape=(3, 3, 3), num_channels=1, num_fmaps=2,
                 fmap_inc_factors=(2,), fmap_dec_factors=(1.0,),
                 downsample_factors=((2, 2, 2),), train_code=True,
                 code_units=8, ae_code_fmaps=1, ae_num_fmaps=(2, 4),
                 overlapping_inst=True, padding="same")
model3 = PPPModel(cfg3).eval()
raw3 = np.random.RandomState(1).rand(1, 12, 12, 12).astype(np.float32)
path = tempfile.mkdtemp() + "/s.zarr"
predict_sample_to_zarr(model3, raw3, cfg3, (8,) * 3, (8,) * 3, path,
                       device="cpu")
decode_sample(model3, path, cfg3, max_ram_mb=0.2, device="cpu")
assert check_file(path, ["volumes/pred_code", "volumes/pred_affs"])
assert IoZarr(path).read(key="volumes/pred_affs").shape == (27, 12, 12, 12)
vp3 = VoteInstancesParams(patchshape=(3, 3, 3), overlapping_inst=True,
                          numinst_key="volumes/pred_numinst",
                          patch_threshold=0.45, fc_threshold=0.45)
inst3, fg3 = blockwise_vote_instances_zarr(
    path, vp3, (8, 8, 8), decoder=CodeDecoder(model3, cfg3, 64, "cpu"),
    device="cpu")
assert inst3.shape == (12, 12, 12) and relabel(inst3).max() == \
    len(np.unique(inst3[inst3 > 0]))
heads, prob = predict_tta(model3, raw3, cfg3, (12,) * 3, (12,) * 3,
                          flips=[(), (0,)], device="cpu")
assert len(heads) == 2 and prob.shape == (3, 12, 12, 12)
labels3 = synthetic.synth_labels(24)
affs3 = synthetic.labels_to_affinities(labels3, (3, 3, 3))
fgs = clean_mask(affs3[13] > 0.5, 2)
inst4, _ = blockwise_vote_instances(affs3, fgs, fgs.astype(np.uint8),
                                    VoteInstancesParams(patchshape=(3, 3, 3)),
                                    (12, 12, 12), device="cpu")
assert inst4.max() > 0
# the CLI slice: skeletons, evaluation, config, samples, checkpoints, CLI
from patchperpix_tpu_torch import cli, config
from patchperpix_tpu_torch.evaluate import evaluate_labels, evaluate_patch
from patchperpix_tpu_torch.ops.affinities import gt_affinities_dense
from patchperpix_tpu_torch.train.data import load_sample
from patchperpix_tpu_torch.utils.skeleton import skeletonize
from patchperpix_tpu_torch.weights import load_checkpoint, write_checkpoint
assert 0 < skeletonize(fgs).sum() < fgs.sum()
res = evaluate_labels(inst4, labels3, localization_criterion="cldice",
                      assignment_strategy="greedy")
assert 0 < res["general"]["avg_f1_cov_score"] <= 1
assert "th_0_5" in evaluate_patch(affs3, labels3[None], (3, 3, 3),
                                  device="cpu")
assert gt_affinities_dense(labels3[None, None], (3, 3, 3),
                           device="cpu").shape == (1, 27, 22, 22, 22)
fl = config.load_config("configs/flylight_crop_dec.toml")
vpf = VoteInstancesParams.from_config(fl["vote_instances"])
assert vpf.skeletonize_foreground and vpf.remove_small_comps == 60
sd = load_sample("data/JRC_SS05008-20160318_24_B2_crop.zarr",
                 "volumes/raw", "volumes/gt_instances", clipmax=1500)
assert sd.raw.shape == (3, 50, 50, 50) and sd.raw.max() <= 1
tmp = tempfile.mkdtemp()
ck = write_checkpoint({"params": {"a": {"kernel": np.ones(2)}}}, tmp, 7)
assert load_checkpoint(ck)["params"]["params/a/kernel"].shape == (2,)
paths = cli.main(["-c", "configs/flylight_crop_dec.toml", "--root", tmp,
                  "-d", "mknet", "--device", "cpu"])
assert os.path.exists(os.path.join(paths["base"], "test_net_config.json"))
# the training slice: init, losses, samplers, trainer, the CLI's train
from patchperpix_tpu_torch.models.init import init_tree
from patchperpix_tpu_torch.models.losses import summaries
from patchperpix_tpu_torch.ops.affinities import (gather_at,
                                                  gt_affinities_sampled,
                                                  sample_fg_corners)
from patchperpix_tpu_torch.train.data import (AugmentConfig, CropSampler,
                                              Prefetcher, SamplerConfig)
from patchperpix_tpu_torch.train.device_data import DeviceSampler
from patchperpix_tpu_torch.train.trainer import TrainConfig, train_until
from patchperpix_tpu_torch.weights import from_state_dict
assert set(init_tree(cfg3, torch.Generator().manual_seed(0))) == set(
    from_state_dict(model3.state_dict()))
scfg = SamplerConfig(input_shape=(8, 8, 8), output_shape=(8, 8, 8),
                     patchshape=(3, 3, 3), batch_size=2)
ds = DeviceSampler([sd], scfg, max_gt_channels=3, device="cpu")
import dataclasses
cfg3c = dataclasses.replace(cfg3, num_channels=3)
st = train_until(PPPModel(cfg3c), cfg3c, TrainConfig(
    max_iterations=2, checkpoints=2, snapshots=0,
    output_folder=tempfile.mkdtemp(),
    tensorboard=False), ds, device="cpu")
assert st["step"] == 2 and st["opt_state"]["count"] == 2
pf = Prefetcher(CropSampler([sd], scfg), cache_size=1, max_gt_channels=3)
assert pf.next()[0].shape == (2, 3, 8, 8, 8)
pf.stop()
assert config.named_params(fl["validation"]) == [
    {"patch_threshold": 0.5, "fc_threshold": 0.5}]
# the ISBI slice: the hacks, the options, the host cover, postprocess
from patchperpix_tpu_torch.assembly import isbi_hacks
from patchperpix_tpu_torch.ops import np_reference as tref
from patchperpix_tpu_torch.utils.postprocess import (color_labels,
                                                     crop_to_shape,
                                                     postprocess_fg)
isbi = config.load_config("configs/isbi_rehearsal.toml")
vpi = VoteInstancesParams.from_config(
    {**isbi["vote_instances"], "patchshape": (1, 9, 9)})
assert vpi.isbi_hack and vpi.mws
labels5 = np.stack([synthetic.worm_labels(72, 176, 2, seed=1)[0]] * 3)
affs5 = synthetic.labels_to_affinities(labels5, (1, 9, 9))
assert isbi_hacks.filter_instance_boundaries_from_fg(
    affs5, labels5 > 0, isbi_hacks.sparsify_patches(
        [tuple(c) for c in np.argwhere(labels5[1:2] > 0) + [1, 0, 0]], 3,
        labels5.shape), (1, 9, 9), labels5 > 0).sum() > 0
inst5, _ = to_instance_seg(affs5, labels5 > 0, labels5 > 0,
                           (labels5 > 0).astype(np.uint8),
                           dataclasses.replace(vpi, isbi_sparsify_stride=3,
                                               sample=0.8, pad_with_ps=True,
                                               one_instance_per_channel=True),
                           device="cpu")
assert inst5.ndim == 4 and inst5.max() > 0 and not inst5[:, 0].any()
assert postprocess_fg(labels5 > 0).max() >= 1
assert color_labels(labels5).shape == labels5.shape + (3,)
assert crop_to_shape(labels5, (5, 5)).shape == (3, 5, 5)
assert not hasattr(cli, "NOT_PORTED")
assert tref.foreground_cover_reference
# the multi-device and Swin slice: a Swin model, sharded assembly, blocks
# over devices, the data-parallel step, the sample fan-out
from patchperpix_tpu_torch.parallel import multihost, sharded
from patchperpix_tpu_torch.train.trainer import compute_losses
cfg6 = PPPConfig(patchshape=(3, 3, 3), num_channels=1, num_fmaps=8,
                 network_style="swinunetr", padding="same",
                 downsample_factors=((2, 2, 2),) * 2)
model6 = PPPModel(cfg6)
model6.load_state_dict(__import__("patchperpix_tpu_torch.weights").weights
                       .to_state_dict(init_tree(cfg6, torch.Generator())))
h6, _ = model6(torch.rand(2, 1, 27, 28, 29))
assert h6.shape == (2, 27, 27, 28, 29)
sharded.local_devices = lambda kind="cuda": [torch.device("cpu")] * 2
loss6, _ = compute_losses(model6, cfg6, TrainConfig(),
                          torch.rand(2, 1, 28, 28, 28),
                          torch.ones(2, 1, 30, 30, 30, dtype=torch.int32),
                          mesh=sharded.make_spatial_mesh(2, "cpu"))
assert torch.isfinite(loss6)
inst6, _ = to_instance_seg(affs3, fgs, fgs.copy(), fgs.astype(np.uint8),
                           VoteInstancesParams(patchshape=(3, 3, 3),
                                               sharded_devices=2),
                           device="cpu")
assert np.array_equal(inst6 > 0, inst4 > 0)
inst7, _ = blockwise_vote_instances(
    affs3, fgs, fgs.astype(np.uint8),
    VoteInstancesParams(patchshape=(3, 3, 3), block_devices=2),
    (12, 12, 12), device="cpu")
assert np.array_equal(inst7, inst4)
assert multihost.shard_samples(list("abcde"), 1, 2) == ["b", "d"]
# the visualization slice: renders, debug canvases, PNG and TIFF without
# PIL, the roofline helper
import tempfile
from patchperpix_tpu_torch.assembly.debug_viz import (render_graph_edges,
                                                      render_patch_tiles)
from patchperpix_tpu_torch.utils.io import read_png, read_tif, save_tif
from patchperpix_tpu_torch.utils.roofline import analyze, chip_peaks, \
    consensus_cost
from patchperpix_tpu_torch.visualize import (visualize_instances,
                                             visualize_patches)
viz = tempfile.mkdtemp()
assert render_patch_tiles(affs3, fgs, (3, 3, 3), device="cpu").shape == \
    (72, 72)
assert render_graph_edges(np.array([[1, 2, 3, 1, 5, 6]]), np.ones(1),
                          (24, 24, 24), (3, 3, 3)).max() == 1.0
visualize_instances(inst4, os.path.join(viz, "i.png"), device="cpu")
assert read_png(os.path.join(viz, "i.png")).shape == (24, 24, 3)
visualize_patches(affs3, (3, 3, 3), os.path.join(viz, "p.tif"), device="cpu")
assert read_tif(os.path.join(viz, "p.tif")).dtype == np.float32
save_tif(os.path.join(viz, "l.tif"), inst4)
assert read_tif(os.path.join(viz, "l.tif")).shape == inst4.shape
assert analyze(consensus_cost((8, 8, 8), (3, 3, 3)), 1.0,
               chip_peaks("cpu"))["bound"] == "compute"
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "flax", "optax", "orbax", "patchperpix_tpu",
        "PIL")]
assert not bad, bad
# the JAX package's files: a blosc store of data/synth_isbi, an HDF5
# result written and read back
from patchperpix_tpu_torch.utils.io import IoHDF5, open_volume
gt = open_volume("data/synth_isbi/test/isbi_test_00.zarr").read(
    key="volumes/gt_instances")
assert gt.shape == (1, 512, 512) and gt.max() > 0
hdf = tempfile.mkdtemp() + "/r.hdf"
with IoHDF5(hdf, mode="w") as io:
    io.write(gt, key="vote_instances", attrs={"offset": (0, 0, 0)})
assert (IoHDF5(hdf).read(key="vote_instances") == gt).all()
print("NO_JAX_OK")
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "NO_JAX_OK" in r.stdout, r.stderr[-3000:]
