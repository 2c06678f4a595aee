"""The parity cases: what the port is held to, and against which stored run.

The ``torch_port_*`` files beside this module are the JAX package's CPU
runs of these cases (``scripts/export_torch_fixtures.py`` writes them).
A case is its inputs (paths, seeds, widths, settings and the functions
below that make them), the port's run of it (``run_path``,
``assemble_2d``) and the measure that holds the run to the stored one,
with its limit (``map_agreement`` / ``gate_agreement``, ``step_errors`` /
``gate_step``, ``check_sampler_alignment``).  The exporter, the CPU
tests, the card tests (``tests/test_torch_cuda.py``) and the timing
scripts read them from here; nothing else defines a case.  Imports no
JAX and nothing of ``patchperpix_tpu`` (the card's machine has neither),
and the port's package only inside the functions that use it, so that a
script can time another checkout's package with these cases.
"""

import dataclasses
import json
import os
import tomllib
import zlib

import numpy as np
import torch

PARITY = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(PARITY)
FIXTURE = os.path.join(REPO, "data", "JRC_SS05008-20160318_24_B2_crop.zarr")


def _stored(name):
    return (os.path.join(PARITY, f"torch_port_{name}.npz"),
            os.path.join(PARITY, f"torch_port_{name}.json"))


# -- the maps' limits --------------------------------------------------------

# one instance map against another of the same inputs: the share of
# voxels whose foreground agrees, the same instance count, and the share
# of foreground voxels whose ids agree after best-IoU matching
FG_AGREEMENT = 0.999
MATCHED_AGREEMENT = 0.99
# |avg_f1_cov - JAX's| (and |rand_fscore - JAX's|) of two evaluations
SCORE_TOL = 0.01


def n_instances(inst) -> int:
    return int(len(np.unique(inst[inst > 0])))


def match_agreement(a, b):
    """(fraction of voxels in a > 0 or b > 0 whose ids agree after mapping
    a's ids onto b's by best-IoU Hungarian matching, identical up to
    relabelling)."""
    from scipy.optimize import linear_sum_assignment

    ia, ib = np.unique(a[a > 0]), np.unique(b[b > 0])
    iou = np.zeros((len(ia), len(ib)))
    for i, x in enumerate(ia):
        ma = a == x
        for j, y in enumerate(ib):
            mb = b == y
            inter = np.logical_and(ma, mb).sum()
            if inter:
                iou[i, j] = inter / np.logical_or(ma, mb).sum()
    mapped = np.zeros_like(b, dtype=np.int64)
    fresh = int(b.max()) + 1
    ri, ci = linear_sum_assignment(-iou) if iou.size else ([], [])
    matched = {ia[r]: ib[c] for r, c in zip(ri, ci) if iou[r, c] > 0}
    for x in ia:
        if x in matched:
            mapped[a == x] = matched[x]
        else:
            mapped[a == x] = fresh
            fresh += 1
    fgu = (a > 0) | (b > 0)
    agree = float(np.mean(mapped[fgu] == b[fgu])) if fgu.any() else 1.0
    pairs = np.unique(np.stack([a.ravel(), b.ravel()], 1), axis=0)
    same = (np.array_equal(a > 0, b > 0)
            and len(np.unique(pairs[:, 0])) == len(pairs)
            == len(np.unique(pairs[:, 1])))
    return agree, bool(same)


def map_agreement(got, want, fg_got, fg_want, ref_n_instances=None):
    """The three numbers ``gate_agreement`` holds for two instance maps and
    their foregrounds; the reference's instance count is ``want``'s unless
    the stored record gives it."""
    agree, same = match_agreement(got, want)
    return {"fg_agreement": float(np.mean(fg_got == fg_want)),
            "n_instances": n_instances(got),
            "ref_n_instances": (n_instances(want) if ref_n_instances is None
                                else ref_n_instances),
            "matched_agreement": agree, "identical_up_to_relabel": same}


def gate_agreement(res, what):
    """Raise where ``map_agreement``'s numbers are past their limits."""
    if res["fg_agreement"] < FG_AGREEMENT:
        raise AssertionError(f"{what}: foreground agreement "
                             f"{res['fg_agreement']} < {FG_AGREEMENT}")
    if res["n_instances"] != res["ref_n_instances"]:
        raise AssertionError(f"{what}: instance count {res['n_instances']} "
                             f"!= {res['ref_n_instances']}")
    if res["matched_agreement"] < MATCHED_AGREEMENT:
        raise AssertionError(f"{what}: instance agreement "
                             f"{res['matched_agreement']} < "
                             f"{MATCHED_AGREEMENT}")


def gt_match_counts(inst, labels, thr=0.5):
    """For each ground-truth label, the number of predicted instances with
    IoU >= thr."""
    pairs, n = np.unique(np.stack([labels.ravel(), inst.ravel()], 1), axis=0,
                         return_counts=True)
    size_gt = dict(zip(*np.unique(labels, return_counts=True)))
    size_pr = dict(zip(*np.unique(inst, return_counts=True)))
    out = {int(g): 0 for g in size_gt if g > 0}
    for (g, q), c in zip(pairs, n):
        if g > 0 and q > 0 and c / (size_gt[g] + size_pr[q] - c) >= thr:
            out[int(g)] += 1
    return out


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def same_json(a, b) -> bool:
    """Two metric dicts equal as the fixture stores them (numpy numbers as
    floats, NaN equal to NaN)."""
    def norm(d):
        return json.dumps(json.loads(json.dumps(d, default=float)),
                          sort_keys=True)
    return norm(a) == norm(b)


# -- the 3D main path: the FlyLight crop --------------------------------------

# bench.py's self-consistent FlyLight pipeline: the trained ppp+dec crop
# model (parity/bench_ckpt_params.npz) predicts codes and numinst on the
# 50^3 crop in one 52^3 window, the numinst head (0.9 / 0.1) gives the
# foreground, foreground codes decode to 7^3 patches and to_instance_seg
# assembles them (pt 0.6, fc 0.5, mws); then inst[~fg] = 0 and components
# under 400 voxels go.  The JAX package's float32 CPU run is REF_*.
REF_NPZ, REF_JSON = _stored("ref_f32")
WIN = (52, 52, 52)


def crop_config(dtype):
    from patchperpix_tpu_torch.models import PPPConfig

    return PPPConfig(
        patchshape=(7, 7, 7), num_channels=3, num_fmaps=20,
        fmap_inc_factors=(3, 3), fmap_dec_factors=(1.0, 1.0),
        downsample_factors=((2, 2, 2), (2, 2, 2)), kernel_size=3,
        num_repetitions=2, padding="same", overlapping_inst=True,
        max_num_inst=2, train_code=True, code_units=176, ae_code_fmaps=22,
        ae_num_fmaps=(64, 128), num_code_samples=1024, dtype=dtype)


def crop_raw():
    """The crop's raw as the main path reads it: (3, 50, 50, 50) float32,
    clipped at 1500 and scaled to [0, 1]."""
    from patchperpix_tpu_torch.utils.io import IoZarr

    return np.clip(IoZarr(FIXTURE).read(key="volumes/raw").astype(
        np.float32), 0, 1500.0) / 1500.0


def vote_params():
    from patchperpix_tpu_torch.assembly import VoteInstancesParams

    return VoteInstancesParams(
        patchshape=(7, 7, 7), patch_threshold=0.6, fc_threshold=0.5,
        overlapping_inst=True, mws=True, select_patches_for_sparse_data=True,
        skeletonize_foreground=False, numinst_threshs=(0.9, 0.1))


def run_path(model, cfg, raw, dev):
    """One pass of the main path through the port's entry points on the
    card ``dev``, with the wall seconds of each stage (each ends in a
    synchronise)."""
    import time

    from patchperpix_tpu_torch.assembly import (numinst_from_probs,
                                                to_instance_seg)
    from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                                   predict_volume_device)
    from patchperpix_tpu_torch.utils.postprocess import \
        remove_small_components

    vp = vote_params()
    t = {}
    torch.cuda.synchronize(dev)
    t0 = t1 = time.perf_counter()
    code, prob = predict_volume_device(model, raw, cfg, WIN, WIN, device=dev)
    torch.cuda.synchronize(dev)
    t["predict"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    prob = prob.cpu().numpy()
    numinst = numinst_from_probs(prob, vp)
    fg = numinst > 0
    dec = decode_volume_device(model, code, fg, cfg, device=dev)
    torch.cuda.synchronize(dev)
    t["decode"] = time.perf_counter() - t1
    inter = {}
    inst, _ = to_instance_seg(dec, fg, fg.copy(), numinst, vp, device=dev,
                              timings=t, intermediates=inter)
    inst[~fg] = 0
    inst = remove_small_components(inst, 400)
    t["total"] = time.perf_counter() - t0
    return dict(prob=prob, numinst=numinst, fg=fg, dec=dec, inst=inst,
                inter=inter, times=t)


# the out-of-core sample path: the crop reflected by 25 per side stands in
# for a FlyLight sample (100^3, larger than the window); predicted in
# batches of 2, assembled in 64^3 blocks; decode_sample's host budget
# forces three z-slabs.  The JAX package's blockwise run of the f32
# decoded affinities is BW_REF_*; the 120^3 tube volume is
# benchmarks/blockwise_scale.py's.
BW_REF_NPZ, BW_REF_JSON = _stored("blockwise_ref_f32")
SAMPLE_PAD = 25
SAMPLE_BATCH = 2
SAMPLE_CHUNK = (64, 64, 64)
DECODE_RAM_MB = 1024.0
DECODE_BATCH = 4096
SYNTH_EXTENT = 120

# the reference CLI's chain (predict -> decode -> label -> evaluate) on the
# crop with configs/flylight_crop_dec.toml in float32, from the trained
# checkpoint; the JAX CLI's run is CLI_REF_*, its own result file (h5py)
# JAX_RESULT
CLI_CONFIG = os.path.join(REPO, "configs", "flylight_crop_dec.toml")
CLI_REF_NPZ, CLI_REF_JSON = _stored("cli_ref_f32")
JAX_RESULT = os.path.join(PARITY, "torch_port_jax_result.hdf")
JAX_RESULT_JSON = os.path.join(PARITY, "torch_port_jax_result.json")
CLI_STEP = 1

# the renders: the JAX package's of viz_inputs() (VIZ_REF_*), the 7^3
# patches of the crop, the volume plane of the second mosaic, and the 2D
# vote_debug crop: 128^2 of the worm image at (104, 168), its four worms
VIZ_REF_NPZ, VIZ_REF_JSON = _stored("viz_ref")
VIZ_PS = (7, 7, 7)
VIZ_Z = 25
VIZ_CROP2D = (104, 168, 128)


def viz_inputs():
    """The arrays the renders take (numpy, all from the repository): the
    JAX CLI's f32 map of the crop, the crop's raw, ideal 7^3 affinities of
    the map scaled by 0.5 + 0.5 x the stored decoded center channel, the
    f32 reference run's foreground, pairs, weights and thinned cover
    centers."""
    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities
    from patchperpix_tpu_torch.utils.io import IoZarr

    ref, cli_ref = np.load(REF_NPZ), np.load(CLI_REF_NPZ)
    inst = cli_ref["inst"]
    scale = (0.5 + 0.5 * ref["dec_center"]).astype(np.float32)
    affs = labels_to_affinities(inst, VIZ_PS) * scale[None]
    return {"inst": inst,
            "raw": IoZarr(FIXTURE).read(key="volumes/raw").astype(
                np.float32),
            "affs": affs.astype(np.float32), "fg": ref["fg"],
            "pairs": ref["pairs"], "weights": ref["weights"],
            "selected": ref["thin_centers"].astype(np.int64)}


# -- the 2D path: the worm image ----------------------------------------------

# the worm image of the 2D workload at BBBC010 size (520x696, 25x25
# patches) under the two [vote_instances] settings the repo's 2D users
# run: (A) the 2D bench's (mws, sparse-data cover), (B)
# configs/bbbc010.toml's (label propagation, dense-data cover, overlaps);
# the JAX package's f32 runs are REF2D_*
REF2D_NPZ, REF2D_JSON = _stored("ref2d_f32")
IMG2D = (520, 696)
PS2D = (1, 25, 25)
PATH2D = {
    "A": dict(patchshape=PS2D, patch_threshold=0.5, fc_threshold=0.5,
              mws=True, select_patches_for_sparse_data=True),
    "B": dict(patchshape=PS2D, patch_threshold=0.9, fc_threshold=0.5,
              mws=False, select_patches_for_sparse_data=False,
              includeSinglePatchCCS=False, removeIntersection=True,
              overlapping_inst=True, skeletonize_foreground=False,
              numinst_threshs=(0.9, 0.1)),
}


def path2d_inputs(setting, crop=None):
    """Inputs of the 2D path under ``setting`` ("A" or "B"), numpy only:
    worm labels (16 worms, seed 0) cut to the top-left ``crop`` (H, W) if
    given, their ideal 25x25 affinities, the foreground, and numinst (2 on
    the worms' crossing pixels under (B), where overlaps are modelled)."""
    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     worm_labels)

    labels, crossing = worm_labels(*IMG2D, n_worms=16, seed=0,
                                   with_crossings=True)
    if crop is not None:
        labels = labels[:, :crop[0], :crop[1]]
        crossing = crossing[:, :crop[0], :crop[1]]
    fg = labels > 0
    numinst = fg.astype(np.uint8)
    if PATH2D[setting].get("overlapping_inst"):
        numinst[crossing] = 2
    return dict(labels=labels, fg=fg, numinst=numinst,
                affs=labels_to_affinities(labels, np.array(PS2D)))


def dense2d_affs():
    """Ideal 25x25 affinities of the dense2d image: 64 worms (seed 1) at
    520x696, about four times the path's foreground."""
    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     worm_labels)

    labels, _ = worm_labels(*IMG2D, n_worms=64, seed=1, with_crossings=True)
    return labels_to_affinities(labels, np.array(PS2D))


def assemble_2d(setting, inp, affs, dev, timings=None):
    """One 2D assembly through the port's entry point: (instance map,
    intermediates)."""
    from patchperpix_tpu_torch.assembly import (VoteInstancesParams,
                                                to_instance_seg)

    inter = {}
    inst, _ = to_instance_seg(
        affs, inp["fg"], inp["fg"].copy(), inp["numinst"],
        VoteInstancesParams(**PATH2D[setting]), device=dev,
        timings=timings, intermediates=inter)
    return inst, inter


# configs/bbbc010.toml [model] + [model.autoencoder] at full width, with
# seeded weights on one 512x512 window (MODEL2D_*: the JAX outputs at
# seeded pixel positions)
MODEL2D_NPZ, MODEL2D_JSON = _stored("model2d_ref")
BBBC010_MODEL = dict(
    patchshape=PS2D, num_channels=1, num_fmaps=20,
    fmap_inc_factors=(2, 2, 2, 2), fmap_dec_factors=(1.0, 1.0, 1.0, 1.0),
    downsample_factors=((1, 2, 2),) * 4, kernel_size=3, num_repetitions=2,
    padding="same", upsampling="trans_conv", overlapping_inst=True,
    max_num_inst=2, train_code=True, code_units=512, ae_code_fmaps=8,
    ae_num_fmaps=(32, 64), ae_downsample_factors=((2, 2), (2, 2)),
    ae_kernel_size=3, ae_num_repetitions=2, ae_upsampling="resize_conv",
    num_code_samples=1024, dtype="float32")
MODEL2D_WINDOW = (512, 512)
MODEL2D_SEED = 0


def model2d_sample(n=512):
    """Seeded raw 512x512 window and the flat pixel positions whose model
    outputs are compared."""
    rng = np.random.default_rng(MODEL2D_SEED)
    raw = rng.random((1,) + MODEL2D_WINDOW, dtype=np.float32)
    pos = np.sort(rng.choice(MODEL2D_WINDOW[0] * MODEL2D_WINDOW[1], n,
                             replace=False))
    return raw, pos


# -- the cover loops (K5, K6) -------------------------------------------------

class CoverCapture:
    """While entered, keeps the arguments of the assembly's last cover
    calls (``vote_instances.greedy_cover_device`` with dense data, the
    cascade's input, and ``thin_out_cover_device``, the thin cover's): the
    affinity tensor on its device, the mask to cover, the candidates'
    centers in order, the overlap rows, the patch shape and fc.  The calls
    themselves run as they are."""

    def __init__(self):
        from patchperpix_tpu_torch.assembly import vote_instances as vi

        self.vi = vi
        self.real = (vi.greedy_cover_device, vi.thin_out_cover_device)
        self.cascade = self.thin = None

    def __enter__(self):
        greedy, thin = self.real

        def case(affs, mask, patches, ps, fc, overlap=None):
            centers = np.array([c for c, _ in patches], dtype=np.int64)
            rows = np.zeros(len(centers), bool) if overlap is None \
                else np.asarray(overlap)[tuple(centers.T)] > 0
            return {"affs": affs, "mask": np.array(mask, dtype=bool),
                    "centers": centers, "overlap_rows": rows,
                    "ps": tuple(int(p) for p in ps), "fc": float(fc)}

        def rec_greedy(affs, mask, ranked, ps, fc_threshold=0.5,
                       overlap=None, sparse_data=True, mesh=None):
            if not sparse_data and ranked:
                self.cascade = case(affs, mask, ranked, ps, fc_threshold,
                                    overlap)
            return greedy(affs, mask, ranked, ps, fc_threshold=fc_threshold,
                          overlap=overlap, sparse_data=sparse_data, mesh=mesh)

        def rec_thin(affs, mask, selected, ps, fc_threshold=0.5):
            if selected:
                self.thin = case(affs, mask, selected, ps, fc_threshold)
            return thin(affs, mask, selected, ps, fc_threshold=fc_threshold)

        self.vi.greedy_cover_device = rec_greedy
        self.vi.thin_out_cover_device = rec_thin
        return self

    def __exit__(self, *exc):
        self.vi.greedy_cover_device, self.vi.thin_out_cover_device = self.real


def pix_thresholds(ps):
    """The dense-data cascade's pixel thresholds (below P // 2)."""
    mid = int(np.prod(ps)) // 2
    return tuple(t for t in (500, 100, 50, 10, 0) if t < mid)


# -- the weight gradient of the U-Net's convolutions (W1) ---------------------

# the valid 3x3x3 convolutions of the published FlyLight ppp+dec U-Net
# (portbench/configs/flylight_ppp_dec.json: 20 / 60 / 180 / 540 maps, up
# factors 1.2) at batch 2 of 140^3, as (input channels, output channels,
# input extent); the output extent is 2 less
WGRAD_SHAPES = ((3, 20, 140), (20, 20, 138), (20, 60, 68), (60, 60, 66),
                (60, 180, 32), (180, 180, 30), (180, 540, 14),
                (540, 540, 12), (396, 216, 20), (216, 216, 18),
                (132, 72, 32), (72, 72, 30), (44, 24, 56), (24, 24, 54))
WGRAD_BATCH = 2
WGRAD_TOL = 1e-5       # of the largest |dW| or |dB|: float32 sums in
                       # split-K order against float64


def wgrad_inputs(ci, co, e, dev, seed=0):
    """Seeded x (2, ci, e, e, e) and dy (2, co, e - 2, ...) on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((WGRAD_BATCH, ci, e, e, e), generator=gen, device=dev)
    dy = torch.randn((WGRAD_BATCH, co) + (e - 2,) * 3, generator=gen,
                     device=dev)
    return x, dy


# -- the weight gradient as a matrix product (W2) ----------------------------

# the convolutions of the published FlyLight ppp+dec step whose weight
# gradient W2 computes, as (input channels, output channels, input extent,
# batch, f): f = 1 a pointwise convolution, f = 2 a transposed one with
# kernel = stride = 2: the two heads on the U-Net's 52^3 output, the
# U-Net's three transposed convolutions, and the decoder's ConvPass_0,
# Upsample_0.Conv_0 and Upsample_1.Conv_0 on its 2,048 codes
GEMM_SHAPES = ((24, 176, 52, 2, 1), (24, 3, 52, 2, 1), (540, 216, 10, 2, 2),
               (216, 72, 16, 2, 2), (72, 24, 28, 2, 2), (22, 128, 2, 2048, 1),
               (128, 64, 4, 2048, 1), (64, 1, 8, 2048, 1))
# the decoder's SAME 3x3x3 convolutions, routed to W1 on the input
# zero-padded by one, as (channels in, out, extent, batch)
SAME_SHAPES = ((64, 64, 4, 2048), (1, 1, 8, 2048))


def gemm_inputs(ci, co, e, n, f, dev, seed=0):
    """Seeded x (n, ci, e, e, e) and dy (n, co, f e, f e, f e) on
    ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, ci, e, e, e), generator=gen, device=dev)
    dy = torch.randn((n, co) + (f * e,) * 3, generator=gen, device=dev)
    return x, dy


def gemm_operands(ci, co, e, n, f, dev, seed=0):
    """W2's operands (a, b) at a shape of ``GEMM_SHAPES``: dy as rows (by
    tap for a transposed convolution, ``conv_kernels.tap_rows``) and x."""
    from patchperpix_tpu_torch.ops.conv_kernels import tap_rows

    x, dy = gemm_inputs(ci, co, e, n, f, dev, seed)
    a = dy.reshape(n, co, -1) if f == 1 else tap_rows(dy, (f,) * 3)
    return a, x.reshape(n, ci, -1)


# -- training -----------------------------------------------------------------

# the JAX package's f32 CPU train step and 200-step runs (TRAIN_REF_*):
# the code branch is configs/flylight_crop_dec.toml's model with the
# trained parameters and the JAX step's own code corners, the dense
# branch configs/flylight_crop.toml's model with weights.seeded_tree
# weights, both on a fixed batch of three 40^3 crops of the crop
TRAIN_REF_NPZ, TRAIN_REF_JSON = _stored("train_ref_f32")
TRAIN_DENSE_CONFIG = os.path.join(REPO, "configs", "flylight_crop.toml")
TRAIN_SEED = 0          # batch centres, dense weights, gradient samples
TRAIN_CORNER_KEY = 7    # the JAX step's PRNGKey (its code corners)
TRAIN_GRAD_SAMPLES = 256
# the valid branch: the code branch's model and trained parameters with
# valid padding, on 52^3 crops at the same centres (output 12^3, labels
# 18^3) (TRAIN_VALID_REF_*); its U-Net's valid 3x3x3 convolutions with
# fewer than 128 channels on one side (3 -> 20, 20 -> 20, 20 -> 60, 60 ->
# 60, 60 -> 180, and the decoder's 120 -> 60, 60 -> 60, 40 -> 20, 20 ->
# 20) and the code decoder's SAME 1 -> 1 pair on 8^3 take their weight
# gradient from W1 (ops/conv_kernels.py), one launch each; its two heads,
# two transposed convolutions and the code decoder's three pointwise ones
# take theirs from W2
TRAIN_VALID_REF_NPZ, TRAIN_VALID_REF_JSON = _stored("train_valid_ref_f32")
TRAIN_VALID_EXTENT = (52, 12)
TRAIN_VALID_ROUTED = 11
TRAIN_VALID_GEMM = 7
# a step's limits widen to twice the JAX f32 step's own error against the
# JAX float64 step (on this batch up to 2.5e-3 on the trained code model's
# leaves, 2e-5 on the dense loss_patch), never past these caps
TRAIN_GRAD_CAP = 5e-3
TRAIN_LOSS_CAP = 1e-4
TRAIN_RUN_STEPS = 200   # the loss band: constant lr 1e-3, f32, device
TRAIN_RUN_TAIL = 50     # sampler; the mean loss over the last 50 steps
# the band's model: the crop model cut in width only (XLA on the CPU takes
# ~150 s per full-width step, so the JAX reference runs could not be made
# at full width); crops, batch, code, samples and sampler stay the config's
TRAIN_RUN_WIDTHS = {"num_fmaps": 4, "ae_num_fmaps": (8, 16)}
# the band's upper edge: the JAX runs' higher tail plus the larger of 5 %
# and their spread (a sampler flipping or transposing raw and not labels
# reads 1.050 / 0.983 in the CPU rehearsal, the port 0.809, JAX 0.860 /
# 0.874; 15 % above would let the transpose through); the lower edge
# keeps 15 %
TRAIN_RUN_ABOVE, TRAIN_RUN_BELOW = 0.05, 0.15


def train_model_config(mod, path, **widths):
    """The [model] of the crop config at ``path`` as ``mod.PPPConfig`` (the
    JAX package's or the port's), in float32, with ``widths`` replaced."""
    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    return dataclasses.replace(mod.PPPConfig.from_config(
        {**cfg["model"], "num_channels": cfg["data"]["num_channels"],
         "dtype": "float32"}), **widths)


def train_batch(data_mod, centres=None, extent=(40, 40)):
    """The fixed training batch through ``data_mod`` (either package's
    train/data.py, numpy in both): the crop loaded as the CLI loads it
    (clipmax 1500), then per centre the raw crop of the input extent and
    the label crop of the output extent plus the 7^3 patch context
    (``extent``: 40^3 and 46^3 by default) as CropSampler crops them, no
    augmentation.  Without ``centres``, three foreground voxels drawn with
    TRAIN_SEED.  Returns (raw (3, 3, 40^3) f32, labels (3, 3, 46^3)
    int32, centres, the sample)."""
    s = data_mod.load_sample(FIXTURE, "volumes/raw", "volumes/gt_instances",
                             clipmax=1500)
    if centres is None:
        pts = np.argwhere(s.fg_mask)
        centres = pts[np.random.RandomState(TRAIN_SEED).choice(
            len(pts), 3, replace=False)]
    crop = data_mod.CropSampler([s], data_mod.SamplerConfig(
        input_shape=(40,) * 3, output_shape=(40,) * 3, patchshape=(7,) * 3))
    raw = np.stack([crop._crop_at(s.raw, c, np.array((extent[0],) * 3))
                    for c in centres])
    labels = np.stack([crop._crop_at(s.labels, c,
                                     np.array((extent[1] + 6,) * 3))
                       for c in centres])
    return raw.astype(np.float32), labels.astype(np.int32), \
        np.asarray(centres, np.int64), s


def batch_matches(raw, labels, record) -> bool:
    """Whether a batch has the sums the stored run recorded of its own."""
    return (int(labels.astype(np.int64).sum()) == record["labels_sum"]
            and float(raw.astype(np.float64).sum()) == record["raw_sum"])


def train_sampler_config(data_mod):
    """configs/flylight_crop_dec.toml's sampler: 40^3 crops (same
    padding), 7^3 patches, batch 3, pools 0.8 / 0.15 / 0.05, the default
    augmentations (mirror, transpose, intensity)."""
    return data_mod.SamplerConfig(
        input_shape=(40,) * 3, output_shape=(40,) * 3, patchshape=(7,) * 3,
        batch_size=3, probability_fg=0.8, probability_overlap=0.15,
        probability_random=0.05)


def grad_sample_index(name, size):
    """The seeded flat entries of one gradient leaf kept in the fixture."""
    rng = np.random.default_rng([TRAIN_SEED, zlib.crc32(name.encode())])
    return np.sort(rng.choice(size, min(size, TRAIN_GRAD_SAMPLES),
                              replace=False))


def leaf_rel_err(name, g, norm, samples):
    """How far the flat gradient leaf ``g`` is from a stored one, given by
    its L2 norm and its seeded entries: the larger of the relative norm
    difference and the relative L2 error on those entries."""
    g = np.asarray(g, np.float64).reshape(-1)
    w = np.asarray(samples, np.float64)
    return max(abs(np.linalg.norm(g) - norm) / max(norm, 1e-30),
               np.linalg.norm(g[grad_sample_index(name, g.size)] - w)
               / max(np.linalg.norm(w), 1e-30))


def step_errors(dev, branch, cfg, tree, raw, labels, want, ref,
                corners=None, mesh=None, grads_out=None):
    """One f32 step (TF32 off) of the port's model ``cfg`` with the flat
    parameters ``tree`` on the batch against a stored JAX step (``want``:
    the branch's record, ``ref``: the arrays keyed ``<branch>/<leaf>`` and
    ``f64/<branch>/<leaf>``): each loss part's and each gradient leaf's
    relative error (``leaf_rel_err``) beside its limit, 1e-5 and 1e-4, or
    twice the JAX f32 step's own error against the JAX package's float64
    step where that is larger, up to TRAIN_LOSS_CAP / TRAIN_GRAD_CAP.
    ``mesh``: the step data-parallel over those devices; ``grads_out`` (a
    dict) receives the gradient leaves and loss parts as float64 numpy."""
    from patchperpix_tpu_torch import models, weights
    from patchperpix_tpu_torch.train.trainer import (TrainConfig,
                                                     compute_losses)
    from patchperpix_tpu_torch.utils.device import exact_f32

    model = models.PPPModel(cfg)
    model.load_state_dict(weights.to_state_dict(tree), strict=True)
    model.to(dev).train()
    with exact_f32():
        loss, mets = compute_losses(model, cfg, TrainConfig(),
                                    torch.as_tensor(raw, device=dev),
                                    torch.as_tensor(labels, device=dev),
                                    corners=corners, mesh=mesh)
        loss.backward()
    grads = weights.from_state_dict(
        {n: p.grad for n, p in model.named_parameters()})
    grads = {k: g.detach().double().cpu().numpy() for k, g in grads.items()}
    parts = ("loss", "loss_patch", "loss_fg")
    if grads_out is not None:
        grads_out.update(grads)
        grads_out.update({k: float(mets[k]) for k in parts})
    f64 = want["float64_err"]
    res = {"loss": {k: (abs(float(mets[k]) - want["metrics"][k])
                        / abs(want["metrics"][k]),
                        min(TRAIN_LOSS_CAP, max(1e-5, 2 * f64["loss"][k])))
                    for k in parts},
           "grads": {name: (leaf_rel_err(name, g, want["grad_norms"][name],
                                         ref[f"{branch}/{name}"]),
                            min(TRAIN_GRAD_CAP,
                                max(1e-4, 2 * f64["grads"][name])))
                     for name, g in grads.items()}}
    del model, loss
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def gate_step(res, what):
    """Raise where an error of ``step_errors`` is past its limit."""
    for kind in ("loss", "grads"):
        over = {k: v for k, v in res[kind].items() if v[0] > v[1]}
        if over:
            raise AssertionError(f"{what}: {kind} past their limits "
                                 f"(error, limit): {over}")


def check_sampler_alignment(ds, samples, data_mod, draws=4):
    """Batches that the device sampler ``ds`` (over ``samples``) draws and
    applies on its device against the host sampler's own crop, flip,
    transpose, permute, hue and intensity (``data_mod.CropSampler``,
    numpy) on the same decisions: raw within 1e-6, labels equal, flips and
    transposes among them.  A sampler whose raw and labels part ways fails
    here at once.  Returns how often each augmentation was applied."""
    host = data_mod.CropSampler(samples, ds.cfg)
    big = ds.big
    g = torch.Generator(device=ds.device)
    worst = 0.0
    seen = {"flip": 0, "transpose": 0, "permute": 0, "hue": 0}
    for k in range(draws):
        g.manual_seed(TRAIN_SEED + k)
        d = ds.draw(g)
        raw, labels, _ = ds.apply(d)
        raw, labels = raw.cpu().numpy(), labels.cpu().numpy()
        d = {key: v.cpu() for key, v in d.items()}
        for b in range(raw.shape[0]):
            s = samples[int(d["si"][b])]
            c = d["center"][b].numpy()
            r = host._crop_at(s.raw, c, big)
            lab = host._crop_at(np.pad(s.labels, [(0, labels.shape[1]
                                                   - s.labels.shape[0])]
                                       + [(0, 0)] * ds.ndim), c, big)
            for dim in range(ds.ndim):
                if d["flip"][b, dim]:
                    r, lab = np.flip(r, 1 + dim), np.flip(lab, 1 + dim)
                    seen["flip"] += 1
            if d["transpose"][b] and ds.pairs:
                i, j = ds.pairs[int(d["pair"][b])]
                order = list(range(1 + ds.ndim))
                order[i - 1], order[j - 1] = order[j - 1], order[i - 1]
                r, lab = np.transpose(r, order), np.transpose(lab, order)
                seen["transpose"] += 1
            if d["permute"][b] and r.shape[0] >= 2:
                r = r[d["perm"][b].numpy()]
                seen["permute"] += 1
            if d["hue"][b] and r.shape[0] >= 3:
                amt = float(d["hue_amount"][b])
                r = r.copy()
                r[:3] = np.clip((1 - amt) * r[:3]
                                + amt * np.roll(r[:3], 1, axis=0), 0, 1)
                seen["hue"] += 1
            r = np.clip(r * float(d["scale"][b]) + float(d["shift"][b]),
                        0, 1)
            r = host._crop_at(np.ascontiguousarray(r), big // 2,
                              np.array(ds.cfg.input_shape))
            lab = host._crop_at(np.ascontiguousarray(lab), big // 2,
                                np.array(host.label_shape))
            worst = max(worst, float(np.abs(raw[b] - r).max()))
            if not np.array_equal(labels[b], lab):
                raise AssertionError(f"device sampler labels of item {b}, "
                                     f"draw {k}, differ from the host's")
    if worst > 1e-6 or not (seen["flip"] and seen["transpose"]):
        raise AssertionError(f"device sampler vs host: {worst}, {seen}")
    return seen


# -- the Swin UNETR backbone --------------------------------------------------

# configs/flylight.toml's model with network_style "swinunetr" (3 stages,
# widths 20/40/80, heads 2/5/10, window 7, the 343-channel dense head and
# 3 numinst classes) at full width with seeded weights (weights.seeded_tree)
# on one 156^3 test window, the crop reflected to that size; the crop
# config's Swin train step on the training batch; a 2D Swin at
# configs/bbbc010.toml's widths on the model2d window; the JAX package's
# f32 CPU runs are SWIN_REF_*
SWIN_CONFIG = os.path.join(REPO, "configs", "flylight.toml")
SWIN_REF_NPZ, SWIN_REF_JSON = _stored("swin_ref_f32")
SWIN_SEED = 0
SWIN_SAMPLES = 4096   # seeded (channel, voxel) entries per head
SWIN_MODEL2D = dict(BBBC010_MODEL, network_style="swinunetr")


def swin_model_config(mod, path=SWIN_CONFIG, **kw):
    """[model] of ``path`` with network_style "swinunetr", float32, as
    ``mod.PPPConfig`` (either package's)."""
    return train_model_config(mod, path, network_style="swinunetr", **kw)


def swin_window():
    """(1, 3, 156, 156, 156) float32: the crop (clipmax 1500) reflected to
    configs/flylight.toml's test window (53 / 53 voxels per side)."""
    with open(SWIN_CONFIG, "rb") as f:
        win = tomllib.load(f)["model"]["test_input_shape_valid"]
    raw = crop_raw()
    pads = [(0, 0)] + [((w - s) // 2, w - s - (w - s) // 2)
                       for w, s in zip(win, raw.shape[1:])]
    return np.pad(raw, pads, mode="reflect")[None]


def swin_positions(shape):
    """Seeded (channel, flat voxel) entries of a (C, *S) head."""
    rng = np.random.default_rng([SWIN_SEED, zlib.crc32(repr(
        tuple(shape)).encode())])
    return (rng.integers(0, shape[0], SWIN_SAMPLES),
            rng.integers(0, int(np.prod(shape[1:])), SWIN_SAMPLES))


# -- the ISBI 2012 protocol ---------------------------------------------------

# configs/isbi_rehearsal.toml, the way users run it, on the stand-in data:
# data/synth_isbi as the JAX package wrote it (blosc: zstd, bitshuffle) and
# its zlib copy; the JAX package's CPU runs are ISBI_REF_*, its TPU
# rehearsal of `-d all` ISBI_REHEARSAL; the full-width
# configs/isbi2012.toml model beside it
ISBI_CONFIG = os.path.join(REPO, "configs", "isbi_rehearsal.toml")
ISBI2012_CONFIG = os.path.join(REPO, "configs", "isbi2012.toml")
ISBI_DATA = os.path.join(REPO, "data", "synth_isbi")
ISBI_ZLIB = os.path.join(REPO, "data", "synth_isbi_zlib")
ISBI_REF_NPZ, ISBI_REF_JSON = _stored("isbi_ref_f32")
ISBI_REHEARSAL = os.path.join(PARITY, "isbi_rehearsal")
ISBI_TEST = ("isbi_test_00", "isbi_test_01")
ISBI_SEED = 0
ISBI_CLI_STEP = 1
# the seeded models' heads are scaled by this gain: their probabilities
# then sit far from the 0.5 thresholds, where float32 sums in another
# order (cuDNN, XLA) and the float16 store could flip a decision; their
# biases are then shifted so that ~89 % of a window is foreground and
# ~73 % of the affinities high (unshifted, the seeded model's foreground
# is 5 % and its map empty)
ISBI_HEAD_GAIN = 8.0
ISBI_HEAD_SHIFT = {"params/head_code_affs/bias": 6.0,
                   "params/head_fgbg_numinst/bias": 10.0}
ISBI_FWD_SAMPLES = 4096       # the forward's sampled affinities and fg
ISBI_STACK_CROP = 256         # the three-slice stack's extent
ISBI_BATCH = (2, 160)         # the step: batch 2 of 160^2, the rehearsal's


def isbi_toml(path=ISBI_CONFIG):
    with open(path, "rb") as f:
        return tomllib.load(f)


def isbi_vote_kwargs():
    """The rehearsal's [vote_instances] as the CLI's ``label`` composes it
    (patchshape and overlapping_inst from [model])."""
    cfg = isbi_toml()
    return dict(cfg["vote_instances"], patchshape=cfg["model"]["patchshape"],
                overlapping_inst=cfg["model"]["overlapping_inst"])


def isbi_eval_kwargs():
    """The rehearsal's [evaluation] as ``evaluate_labels`` keywords."""
    ev = isbi_toml()["evaluation"]
    return dict(localization_criterion=ev["localization_criterion"],
                assignment_strategy=ev["assignment_strategy"],
                add_general_metrics=ev["add_general_metrics"])


def isbi_gt(sample, split="test"):
    """(1, 512, 512) int32 ground truth of one stand-in sample, read from
    the blosc data by the port's store (``utils/blosc.py``)."""
    from patchperpix_tpu_torch.utils.io import IoZarr

    return IoZarr(os.path.join(ISBI_DATA, split, sample + ".zarr")).read(
        key="volumes/gt_instances").astype(np.int32)


def isbi_ideal(sample):
    """Ideal 25x25 affinities of one test sample's ground truth (the
    port's labels_to_affinities, numpy), its foreground and the labels."""
    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities

    gt = isbi_gt(sample)
    ps = np.asarray(isbi_toml()["model"]["patchshape"])
    return labels_to_affinities(gt, ps), gt > 0, gt


def isbi_stack():
    """The three-slice stack of the boundary filter's case: the ground
    truths of three training samples cut to ISBI_STACK_CROP^2 with their
    membranes filled by the nearest cell (touching cells: the stand-in's
    membranes are wider than the filter's radius-2 rings, which then never
    reach a neighbour's pixels), their ideal 25x25 affinities with seeded
    noise (sd 0.25, clipped to [0, 1]), and the foreground."""
    from scipy import ndimage

    from patchperpix_tpu_torch.ops.synthetic import labels_to_affinities

    n = ISBI_STACK_CROP
    labels = np.concatenate([isbi_gt(f"isbi_train_0{i}", "train")[:, :n, :n]
                             for i in range(3)])
    idx = ndimage.distance_transform_edt(labels == 0, return_distances=False,
                                         return_indices=True)
    labels = labels[tuple(idx)]
    affs = labels_to_affinities(labels, (1, 25, 25))
    rng = np.random.RandomState(ISBI_SEED)
    affs = np.clip(affs + rng.normal(0.0, 0.25, affs.shape), 0.0,
                   1.0).astype(np.float32)
    return affs, labels > 0


def isbi_seeded_tree(leaves):
    """``weights.seeded_tree`` over ``leaves`` with both heads scaled by
    ISBI_HEAD_GAIN and their biases shifted by ISBI_HEAD_SHIFT."""
    from patchperpix_tpu_torch.weights import seeded_tree

    tree = seeded_tree(leaves, ISBI_SEED)
    for name in tree:
        if name.startswith(("params/head_code_affs/",
                            "params/head_fgbg_numinst/")):
            tree[name] = (tree[name] * np.float32(ISBI_HEAD_GAIN)
                          + np.float32(ISBI_HEAD_SHIFT.get(name, 0.0)))
    return tree


def isbi_train_batch(data_mod):
    """The step's fixed batch through ``data_mod`` (either package's
    train/data.py, numpy in both): one 160^2 raw crop and its 184^2 label
    crop (25x25 patch context) per training sample isbi_train_00 / _01,
    centred on a foreground pixel drawn with ISBI_SEED, no augmentation.
    Returns (raw (2, 1, 160, 160) f32, labels (2, 1, 184, 184) int32)."""
    n, size = ISBI_BATCH
    rng = np.random.RandomState(ISBI_SEED)
    raws, labels = [], []
    for i in range(n):
        s = data_mod.load_sample(
            os.path.join(ISBI_DATA, "train", f"isbi_train_0{i}.zarr"),
            "volumes/raw", "volumes/gt_instances")
        pts = np.argwhere(s.fg_mask)
        c = pts[rng.randint(len(pts))]
        crop = data_mod.CropSampler([s], data_mod.SamplerConfig(
            input_shape=(size,) * 2, output_shape=(size,) * 2,
            patchshape=(25, 25)))
        raws.append(crop._crop_at(s.raw, c, np.array((size,) * 2)))
        labels.append(crop._crop_at(s.labels, c,
                                    np.array((size + 24,) * 2)))
    return np.stack(raws).astype(np.float32), \
        np.stack(labels).astype(np.int32)


def isbi_sampler_config(data_mod, path=ISBI_CONFIG):
    """The sampler of the ISBI config at ``path`` (its train window, batch
    and pools; 25x25 patches; the default augmentations)."""
    toml = isbi_toml(path)
    shape = tuple(toml["model"]["train_input_shape_same"])
    smp = toml["training"]["sampling"]
    return data_mod.SamplerConfig(
        input_shape=shape, output_shape=shape, patchshape=(25, 25),
        batch_size=toml["training"]["batch_size"],
        probability_fg=smp["probability_fg"],
        probability_overlap=smp["probability_overlap"],
        probability_random=smp["probability_random"])


def isbi_cli_override(work):
    """An override of the rehearsal config, written into ``work``: the
    model in float32 and the data folders on the stand-in data."""
    path = os.path.join(work, "override.toml")
    with open(path, "w") as f:
        f.write('[model]\ndtype = "float32"\n[data]\n' + "".join(
            f'{k}_data = "{os.path.join(ISBI_DATA, k)}"\n'
            for k in ("train", "val", "test")))
    return path


def isbi_cli_argv(exps, override, expid):
    """The CLI case's arguments before the tasks (either package's CLI)."""
    return ["-c", ISBI_CONFIG, "-c", override, "--root", exps, "-id", expid,
            "--checkpoint", str(ISBI_CLI_STEP)]


def isbi_window(data_mod):
    """The forward's input: the raw of isbi_test_00 as ``data_mod`` loads
    it, (1, 512, 512) float32."""
    return data_mod.load_sample(
        os.path.join(ISBI_DATA, "test", ISBI_TEST[0] + ".zarr"),
        "volumes/raw", "volumes/gt_instances").raw


def isbi_forward_positions(shape):
    """The forward's seeded (channel, flat pixel) positions in a (C, H, W)
    head."""
    rng = np.random.RandomState(ISBI_SEED)
    return (rng.randint(0, shape[0], ISBI_FWD_SAMPLES),
            rng.randint(0, int(np.prod(shape[1:])), ISBI_FWD_SAMPLES))
