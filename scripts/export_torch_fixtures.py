"""Export the fixtures the PyTorch port reads without JAX.

Writes, from the repository's own files (nothing is downloaded):

- ``parity/bench_ckpt_params.npz``: every leaf of the orbax checkpoint
  ``parity/bench_ckpt`` as float32, keyed by its '/'-joined tree path
  (``params/unet/ConvPass_0/Conv_0/kernel``, ...).
- ``parity/torch_port_ref_f32.npz`` and ``parity/torch_port_ref_f32.json``:
  the JAX package's float32 run of bench.py's self-consistent pipeline
  (``bench.py:141-211``: trained crop model, numinst 0.9/0.1, pt 0.6,
  fc 0.5, mws, rm 400) on the CPU with ``engine="jax"``, stage by stage,
  so a port that disagrees can find the stage where the two part.  The
  staged run is checked against one ``to_instance_seg`` call on the same
  decoded affinities.

- ``parity/torch_port_ref2d_f32.npz`` / ``.json`` (``--2d [H W]``): the
  JAX package's float32 CPU run (``engine="jax"``: the XLA scan) of the 2D
  path the card tests drive, the worm image at 25x25 patches under settings
  (A) and (B) (``parity.cases.PATH2D``), staged like the 3D run: instance
  maps, ranked candidate scores, cover / thin-cover centers, pairs and
  weights.  H W is the top-left crop of the 520x696 image the run is cut
  to (multiples of 8); the JSON names it.
- ``parity/torch_port_model2d_ref.npz`` / ``.json`` (``--model2d``): the
  BBBC010 model (``configs/bbbc010.toml`` widths) with seeded weights
  (``patchperpix_tpu_torch.weights.seeded_tree`` over the leaf names and
  shapes stored in the JSON) on one seeded 512x512 window: code, numinst
  probabilities and decoded 25x25 patches at 512 seeded pixel positions.
- ``parity/torch_port_blockwise_ref_f32.npz`` / ``.json``
  (``--blockwise [S]``): the JAX package's ``blockwise_vote_instances``
  (CPU, float32, engine jax) on the JAX package's float32 decoded crop
  affinities (predicted and decoded as for the reference above) under
  bench.py's [vote_instances] settings at chunksize (32, 32, 32): the
  instance map, the foreground, numinst, each block's pair count and the
  CPU seconds.  S cuts the run to the top-left S^3 sub-crop of the
  decoded volume; the JSON names the size.  Its stitch windows are XLA
  scans of ~2 min each on the CPU, 13 at 36^3 (1788 s in all) and 26 for
  the full 50^3; ``--blockwise 36`` keeps two blocks per axis.
- ``parity/torch_port_cli_ref_f32.npz`` / ``.json`` (``--cli``): the
  reference CLI's ``predict`` -> ``decode`` -> ``label`` -> ``evaluate``
  on the crop, through the JAX package's functions on the CPU in float32:
  ``predict_sample_to_zarr`` -> ``decode_sample`` -> ``do_all``
  (``VoteInstancesParams.from_config`` of ``configs/flylight_crop_dec.toml``'s
  [vote_instances], engine jax: pt 0.5, mws, skeletonize_foreground,
  remove_small_comps 60) -> ``evaluate_file`` (its [evaluation]: clDice,
  greedy, keep_gt_shape, rm 60).  Stores the instance map, the
  foreground, the skeleton of the foreground that ``to_instance_seg``
  covered (``skeletonize``'s output, captured during ``do_all``), the
  metric dict and the CPU seconds per stage.  The same run's result file
  itself, the JAX package's ``<sample>.hdf`` (h5py, gzip), is kept as
  ``parity/torch_port_jax_result.hdf`` with its metric dict in
  ``parity/torch_port_jax_result.json``: the GPU machine, which has
  neither JAX nor h5py, reads it through the port's ``evaluate``.
- ``parity/torch_port_ref_bf16.npz`` / ``.json`` (``--bf16``): bench.py's
  pipeline (``bench.py:141-211``) with the model in bfloat16 on the CPU
  (engine jax, pt 0.6, fc 0.5, mws, rm 400): the instance map, the
  instance count, own-foreground voxels, AP@0.5 (IoU, Hungarian and
  clDice, greedy) and avg_f1_cov (clDice, greedy, keep_gt_shape).
- ``parity/torch_port_train_ref_f32.npz`` / ``.json`` (``--train``): the
  JAX package's float32 train step on the CPU (``make_train_step``, its
  gradients read through an optax transformation that keeps them as its
  state) on the parity cases' fixed batch (three crops of the FlyLight crop
  at seeded foreground centres, no augmentation): for the code branch
  (configs/flylight_crop_dec.toml's model with the trained
  ``bench_ckpt_params.npz``; the code corners the step draws under
  PRNGKey(7), stored as integers) and the dense branch
  (configs/flylight_crop.toml's model, 343-channel head, with
  ``weights.seeded_tree`` weights): the loss parts, each gradient leaf's
  L2 norm and 256 seeded entries of it.  Then two 200-step
  ``train_until`` runs of the code model cut in width to
  ``parity.cases.TRAIN_RUN_WIDTHS`` (device sampler, constant lr 1e-3,
  float32, seeds 0 and 1): every step's loss, the mean over the last 50
  steps, and the wall seconds (~45 min in all).  ``--train-step`` redoes
  the step part only and keeps the stored runs.  Both then run
  ``--train-f64``, which adds the JAX f32 step's own error against the
  same step in float64, by the JAX package under ``jax_enable_x64``
  (``parity.cases.step_errors`` allows twice that where it exceeds its
  1e-5 / 1e-4 limits, up to TRAIN_LOSS_CAP / TRAIN_GRAD_CAP), and the
  float64 step's gradient norms and entries.
- ``parity/torch_port_train_valid_ref_f32.npz`` / ``.json``
  (``--train-valid``): the code branch's step with valid padding on 52^3
  crops at the same centres (labels 18^3; the port routes its U-Net's
  narrow valid 3x3x3 convolutions to its own weight-gradient kernel on
  the card), stored as ``--train`` stores a branch, then its float64
  witness (``--train-f64 --valid``).

- ``data/synth_isbi_zlib/{train,val,test}/*.zarr`` and
  ``parity/torch_port_isbi_ref_f32.npz`` / ``.json`` (``--isbi [PART
  ...]``): first a zlib copy of every array of ``data/synth_isbi`` (its
  blosc stores, read by the JAX package's tensorstore reader) under the
  same keys, chunks and types, which the port's store reads (only
  without PART); then the JAX package's CPU float32 runs of
  the ISBI cases of ``parity/cases.py``, by part (all five without PART): ``a``
  ``to_instance_seg`` of ``configs/isbi_rehearsal.toml``'s
  [vote_instances] on the ideal 25x25 affinities of both test samples at
  512^2 (instance maps, kept candidates, metric dicts; ~10 min and ~12 GB
  per sample); ``b`` ``keep_single_slice``, the sparse grid and the ISBI
  boundary filter on the seeded three-slice stack (``isbi_stack``);
  ``c`` the JAX CLI's ``mknet predict label evaluate cross_validate``
  with the rehearsal config on the zlib copy, float32, from a seeded
  checkpoint (``parity.cases.isbi_seeded_tree``; four 512^2 labels,
  ~25-35 min); ``d`` the full-width ``configs/isbi2012.toml`` model
  (seeded) on one 512^2 test window: sampled affinities and foreground,
  per-channel means; ``e`` one float32 train step of the rehearsal model
  on the cases' fixed batch (loss parts, gradient samples), then in a
  subprocess ``--isbi-f64``, the same step in float64 by the JAX package.
  Each part is merged into the stored files, the others kept.

- ``parity/torch_port_swin_ref_f32.npz`` / ``.json`` (``--swin``): the
  SwinUNETR backbone (``network_style = "swinunetr"``) with seeded
  weights: configs/flylight.toml's model at full width on one 156^3 test
  window of the crop reflected to that size (both heads at seeded
  entries), one float32 train step of configs/flylight_crop.toml's model
  as a Swin on the train phase's batch (as ``--train`` stores a branch,
  then ``--swin-f64``, the same step in float64), and the 2D Swin at
  configs/bbbc010.toml's widths on the model2d window.
- ``parity/torch_port_viz_ref.npz`` / ``.json`` (``--viz``): the JAX
  package's renders of arrays stored in the repository (``viz_inputs``):
  the JAX CLI's f32 map (``torch_port_cli_ref_f32.npz``), the crop's raw,
  ideal 7^3 affinities of that map scaled by the stored decoded center
  channel, the f32 reference run's foreground, pairs, weights and thinned
  cover (``torch_port_ref_f32.npz``): ``render_instances`` plain, over the
  raw and outlined, ``patch_mosaic`` (z-MIP; plane 25 with the cover's
  centers selected), ``render_patch_tiles`` and ``render_graph_edges``
  (~1 min).

Usage: JAX_PLATFORMS=cpu python scripts/export_torch_fixtures.py
       [--params-only | --2d [H W] | --model2d | --blockwise [S] | --cli
        | --bf16 | --train | --train-step | --train-f64 | --train-valid
        | --isbi [a b c d e] | --isbi-f64 | --swin | --swin-f64 | --viz]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from parity import cases as cs  # noqa: E402

PARAMS_NPZ = os.path.join(ROOT, "parity", "bench_ckpt_params.npz")
REF_NPZ = os.path.join(ROOT, "parity", "torch_port_ref_f32.npz")
REF_JSON = os.path.join(ROOT, "parity", "torch_port_ref_f32.json")
REF2D_NPZ = os.path.join(ROOT, "parity", "torch_port_ref2d_f32.npz")
REF2D_JSON = os.path.join(ROOT, "parity", "torch_port_ref2d_f32.json")
MODEL2D_NPZ = os.path.join(ROOT, "parity", "torch_port_model2d_ref.npz")
MODEL2D_JSON = os.path.join(ROOT, "parity", "torch_port_model2d_ref.json")
BLOCKWISE_NPZ = os.path.join(ROOT, "parity",
                             "torch_port_blockwise_ref_f32.npz")
BLOCKWISE_JSON = os.path.join(ROOT, "parity",
                              "torch_port_blockwise_ref_f32.json")
BLOCKWISE_CHUNK = (32, 32, 32)
CLI_NPZ = os.path.join(ROOT, "parity", "torch_port_cli_ref_f32.npz")
CLI_JSON = os.path.join(ROOT, "parity", "torch_port_cli_ref_f32.json")
CLI_CONFIG = os.path.join(ROOT, "configs", "flylight_crop_dec.toml")
JAX_RESULT = os.path.join(ROOT, "parity", "torch_port_jax_result.hdf")
JAX_RESULT_JSON = os.path.join(ROOT, "parity", "torch_port_jax_result.json")
BF16_NPZ = os.path.join(ROOT, "parity", "torch_port_ref_bf16.npz")
BF16_JSON = os.path.join(ROOT, "parity", "torch_port_ref_bf16.json")
TRAIN_NPZ = os.path.join(ROOT, "parity", "torch_port_train_ref_f32.npz")
TRAIN_JSON = os.path.join(ROOT, "parity", "torch_port_train_ref_f32.json")
TRAIN_VALID_NPZ = os.path.join(ROOT, "parity",
                               "torch_port_train_valid_ref_f32.npz")
TRAIN_VALID_JSON = os.path.join(ROOT, "parity",
                                "torch_port_train_valid_ref_f32.json")
ISBI_SRC = os.path.join(ROOT, "data", "synth_isbi")


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def export_params():
    import numpy as np

    import bench

    model, cfg = bench.crop_model()
    params = bench.load_trained_params(model, cfg)
    flat = {k: np.asarray(v, np.float32) for k, v in flatten(params).items()}
    np.savez_compressed(PARAMS_NPZ, **flat)
    n = sum(v.size for v in flat.values())
    print(f"written {PARAMS_NPZ}: {len(flat)} leaves, {n} parameters")
    return params


def staged_assembly(dec, fg, numinst, params):
    """to_instance_seg's jax-engine branch on a non-TPU backend, one stage
    at a time (assembly/vote_instances.py:375-780)."""
    import jax.numpy as jnp
    import numpy as np

    from patchperpix_tpu.assembly.vote_instances import _device_paint_src
    from patchperpix_tpu.ops import np_reference as ref
    from patchperpix_tpu.ops.consensus_jax import (consensus_array,
                                                   patch_graph_weights,
                                                   rank_scores,
                                                   symmetrize_consensus)
    from patchperpix_tpu.ops.cover import (greedy_cover_device,
                                           thin_out_cover_device)

    ps = np.asarray(params.patchshape)
    rad = ps // 2
    vol_shape = fg.shape
    overlap_mask = (numinst > 1).astype(np.uint8)
    mask_to_cover = fg.copy()
    mask_to_cover[overlap_mask > 0] = False
    ccfg = params.consensus_config()
    overlap_arg = jnp.asarray(overlap_mask > 0)

    cons = consensus_array(dec, ccfg, overlap=overlap_arg)
    scores = rank_scores(dec, cons, ccfg, overlap=overlap_arg)
    interior = np.zeros(vol_shape, bool)
    interior[tuple(slice(int(r), int(s - r))
                   for r, s in zip(rad, vol_shape))] = True
    cand = np.argwhere(fg & interior)
    flat = np.ravel_multi_index(tuple(cand.T), vol_shape)
    svals = np.asarray(jnp.take(scores.reshape(-1), jnp.asarray(flat)),
                       np.float32)
    order = np.argsort(-svals, kind="stable")
    ranked = [(cand[i], float(svals[i])) for i in order]
    cover, _ = greedy_cover_device(
        dec, mask_to_cover, ranked, ps, fc_threshold=params.fc_threshold,
        overlap=overlap_mask,
        sparse_data=params.select_patches_for_sparse_data,
        want_running=False)
    thin = thin_out_cover_device(dec, mask_to_cover, cover, ps,
                                 fc_threshold=params.fc_threshold)
    pairs, _ = ref.patch_pairs_reference(
        thin, ps, max_ps_dist=params.max_total_patch_distance_in_ps_multiples,
        include_singleton=params.includeSinglePatchCCS)
    sym = symmetrize_consensus(cons, ccfg)
    del cons
    weights = np.asarray(patch_graph_weights(
        dec, sym, pairs, ccfg, drop_intersection=params.removeIntersection),
        np.float32)
    del sym
    if params.mws:
        comps = ref.graph_components(pairs, weights, mws=True)
    else:
        from patchperpix_tpu.ops.graph_device import graph_components_device

        comps = graph_components_device(pairs, weights)
    paint = _device_paint_src(dec, comps, params.patch_threshold)
    inst = ref.components_to_instances(
        comps, paint, ps, vol_shape,
        patch_threshold=params.patch_threshold).astype(np.uint16)
    return dict(
        scores=np.asarray(scores, np.float32),
        ranked_centers=cand[order].astype(np.int16),
        ranked_scores=svals[order],
        cover_centers=np.array([c for c, _ in cover], np.int16),
        thin_centers=np.array([c for c, _ in thin], np.int16),
        pairs=pairs.astype(np.uint32), weights=weights,
        n_components=np.int64(len(comps)), inst_assembled=inst)


def export_reference():
    import dataclasses

    import numpy as np

    import bench
    from patchperpix_tpu.assembly import VoteInstancesParams, to_instance_seg
    from patchperpix_tpu.assembly.vote_instances import numinst_from_probs
    from patchperpix_tpu.evaluate import evaluate_labels
    from patchperpix_tpu.infer.fused import (decode_volume_device,
                                             predict_volume_device)
    from patchperpix_tpu.models import PPPModel
    from patchperpix_tpu.utils import io as vio
    from patchperpix_tpu.utils.postprocess import remove_small_components

    model, cfg = bench.crop_model()
    params = bench.load_trained_params(model, cfg)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = PPPModel(cfg)
    raw = bench.load_raw_clip()
    gt = vio.IoZarr(bench.FIXTURE).read(
        key="volumes/gt_instances").astype(np.int32)

    t0 = time.perf_counter()
    win = (52, 52, 52)
    code, prob = predict_volume_device(model, params, raw, cfg, win, win)
    prob = np.asarray(prob, np.float32)
    vp = VoteInstancesParams(
        patchshape=bench.PS, engine="jax", patch_threshold=0.6,
        fc_threshold=0.5, overlapping_inst=True, mws=True,
        select_patches_for_sparse_data=True, skeletonize_foreground=False,
        numinst_threshs=(0.9, 0.1))
    numinst = numinst_from_probs(prob, vp)
    fg = numinst > 0
    dec = decode_volume_device(model, params, code, fg, cfg)
    dec_np = np.asarray(dec, np.float32)
    print(f"predict+decode {time.perf_counter() - t0:.1f}s, "
          f"fg {int(fg.sum())}", flush=True)

    t0 = time.perf_counter()
    stages = staged_assembly(dec, fg, numinst, vp)
    print(f"staged assembly {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    inst_call, _ = to_instance_seg(dec, fg, fg.copy(), numinst, vp)
    print(f"to_instance_seg {time.perf_counter() - t0:.1f}s", flush=True)
    assert np.array_equal(np.asarray(inst_call), stages["inst_assembled"]), \
        "staged assembly disagrees with to_instance_seg"

    inst = stages["inst_assembled"].copy()
    inst[~fg] = 0
    inst = remove_small_components(inst, 400)
    res = evaluate_labels(inst, gt, localization_criterion="iou",
                          assignment_strategy="hungarian",
                          keep_gt_shape=True)
    res_cl = evaluate_labels(inst, gt, localization_criterion="cldice",
                             assignment_strategy="greedy",
                             keep_gt_shape=True)
    mid = int(np.prod(bench.PS)) // 2
    np.savez_compressed(
        REF_NPZ, prob=prob, numinst=numinst, fg=fg,
        dec_center=dec_np[mid], dec_sum=dec_np.sum(0), inst=inst, **stages)
    meta = {
        "source": "scripts/export_torch_fixtures.py: JAX package, CPU, "
                  "float32, engine jax, bench.py:141-211 pipeline",
        "fg_vox": int(fg.sum()),
        "n_candidates": int(len(stages["ranked_centers"])),
        "n_cover": int(len(stages["cover_centers"])),
        "n_thin": int(len(stages["thin_centers"])),
        "n_pairs": int(len(stages["pairs"])),
        "n_components": int(stages["n_components"]),
        "n_instances": int(len(np.unique(inst[inst > 0]))),
        "own_fg_vox": int((inst > 0).sum()),
        "AP_0.5_iou_hungarian": res["confusion_matrix"]["th_0_5"]["AP"],
        "avg_f1_cov_score": res_cl["general"]["avg_f1_cov_score"],
        "AP_0.5_cldice_greedy":
            res_cl["confusion_matrix"]["th_0_5"]["AP"],
    }
    with open(REF_JSON, "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


def export_reference_2d(crop):
    """Settings (A) and (B) of the 2D path through the JAX package."""
    import numpy as np

    from patchperpix_tpu.assembly import VoteInstancesParams, to_instance_seg

    # the staged run equals one to_instance_seg call (checked on a small
    # crop, where both are cheap)
    for name in cs.PATH2D:
        inp = cs.path2d_inputs(name, (96, 432))
        vp = VoteInstancesParams(engine="jax", **cs.PATH2D[name])
        st = staged_assembly(inp["affs"], inp["fg"], inp["numinst"], vp)
        call, _ = to_instance_seg(inp["affs"], inp["fg"], inp["fg"].copy(),
                                  inp["numinst"], vp)
        assert st["inst_assembled"].max() > 0
        assert np.array_equal(np.asarray(call), st["inst_assembled"]), \
            f"staged 2D assembly ({name}) disagrees with to_instance_seg"
    print("staged 2D assembly equals to_instance_seg on (96, 432)",
          flush=True)

    arrays, meta = {}, {
        "source": "scripts/export_torch_fixtures.py --2d: JAX package, CPU, "
                  "float32, engine jax (XLA scan), parity.cases.PATH2D on "
                  "worm_labels(520, 696, 16, seed 0) at (1, 25, 25)",
        "crop": [int(c) for c in crop], "full": list(cs.IMG2D)}
    for name in cs.PATH2D:
        inp = cs.path2d_inputs(name, crop)
        vp = VoteInstancesParams(engine="jax", **cs.PATH2D[name])
        t0 = time.perf_counter()
        st = staged_assembly(inp["affs"], inp["fg"], inp["numinst"], vp)
        inst = st["inst_assembled"]
        meta[name] = {
            "seconds": round(time.perf_counter() - t0, 1),
            "fg_vox": int(inp["fg"].sum()),
            "gt_instances": int(len(np.unique(inp["labels"])) - 1),
            "n_candidates": int(len(st["ranked_centers"])),
            "n_cover": int(len(st["cover_centers"])),
            "n_thin": int(len(st["thin_centers"])),
            "n_pairs": int(len(st["pairs"])),
            "n_components": int(st["n_components"]),
            "n_instances": int(len(np.unique(inst[inst > 0]))),
            "own_fg_vox": int((inst > 0).sum())}
        print(name, json.dumps(meta[name]), flush=True)
        for key in ("ranked_centers", "ranked_scores", "cover_centers",
                    "thin_centers", "pairs", "weights", "n_components"):
            arrays[f"{name}_{key}"] = st[key]
        arrays[f"{name}_inst"] = inst
    np.savez_compressed(REF2D_NPZ, **arrays)
    with open(REF2D_JSON, "w") as f:
        json.dump(meta, f, indent=1)


def export_model_2d():
    """The seeded BBBC010 model's outputs at seeded pixel positions."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from patchperpix_tpu.infer.fused import predict_volume_device
    from patchperpix_tpu.models import PPPConfig, PPPModel
    from patchperpix_tpu_torch.weights import seeded_tree

    cfg = PPPConfig(**cs.BBBC010_MODEL)
    model = PPPModel(cfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 1, 32, 32), jnp.float32),
                           method=model.full_init))
    leaves = [[k, list(v.shape)] for k, v in sorted(flatten(shapes).items())]
    flat = seeded_tree(leaves, cs.MODEL2D_SEED)
    params = {}
    for key, val in flat.items():
        node = params
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(val)

    raw, pos = cs.model2d_sample()
    win = cs.MODEL2D_WINDOW
    t0 = time.perf_counter()
    code, prob = predict_volume_device(model, params, raw, cfg, win, win)
    code = np.asarray(code, np.float32).reshape(cfg.code_units, -1)[:, pos]
    prob = np.asarray(prob, np.float32).reshape(3, -1)[:, pos]
    logits = model.apply(params, jnp.asarray(code.T), method=PPPModel.decode)
    patches = np.asarray(jax.nn.sigmoid(logits), np.float32)
    print(f"model2d {time.perf_counter() - t0:.1f}s: code "
          f"[{code.min():.3f}, {code.max():.3f}] std {code.std():.3f}, "
          f"patches std {patches.std():.3f}", flush=True)
    np.savez_compressed(MODEL2D_NPZ, code=code.T, prob=prob.T,
                        patches=patches)
    with open(MODEL2D_JSON, "w") as f:
        json.dump({
            "source": "scripts/export_torch_fixtures.py --model2d: JAX "
                      "package, CPU, float32, configs/bbbc010.toml widths, "
                      "weights from weights.seeded_tree(leaves, seed)",
            "seed": cs.MODEL2D_SEED, "n_positions": int(len(pos)),
            "n_parameters": int(sum(v.size for v in flat.values())),
            "leaves": leaves}, f)


def export_blockwise(size=None):
    """bench.py's pipeline up to the decoded affinities, then the JAX
    package's blockwise assembly of them."""
    import dataclasses

    import numpy as np

    import bench
    from patchperpix_tpu.assembly import VoteInstancesParams
    from patchperpix_tpu.assembly.blockwise import blockwise_vote_instances
    from patchperpix_tpu.assembly.vote_instances import numinst_from_probs
    from patchperpix_tpu.infer.fused import (decode_volume_device,
                                             predict_volume_device)
    from patchperpix_tpu.models import PPPModel

    model, cfg = bench.crop_model()
    params = bench.load_trained_params(model, cfg)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = PPPModel(cfg)
    raw = bench.load_raw_clip()
    win = (52, 52, 52)
    code, prob = predict_volume_device(model, params, raw, cfg, win, win)
    prob = np.asarray(prob, np.float32)
    vp = VoteInstancesParams(
        patchshape=bench.PS, engine="jax", patch_threshold=0.6,
        fc_threshold=0.5, overlapping_inst=True, mws=True,
        select_patches_for_sparse_data=True, skeletonize_foreground=False,
        numinst_threshs=(0.9, 0.1))
    numinst = numinst_from_probs(prob, vp)
    fg = numinst > 0
    dec = np.asarray(decode_volume_device(model, params, code, fg, cfg),
                     np.float32)
    vol = tuple(int(s) for s in fg.shape)
    if size is not None:
        sl = tuple(slice(0, int(size)) for _ in vol)
        dec, fg, numinst = dec[(slice(None),) + sl], fg[sl], numinst[sl]
        vol = tuple(int(s) for s in fg.shape)
    import logging

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s",
                        force=True)
    blocks: dict = {}
    t0 = time.perf_counter()
    # blocks on 4 threads (the JAX package's num_parallel_blocks; the
    # result equals the serial one), stitch windows in turn
    vp.num_parallel_blocks = 4
    inst, fg_out = blockwise_vote_instances(
        dec, fg, numinst, vp, chunksize=BLOCKWISE_CHUNK, block_results=blocks)
    seconds = time.perf_counter() - t0
    keys = sorted(blocks)
    n_pairs = [0 if blocks[k] is None else int(len(blocks[k][0]))
               for k in keys]
    np.savez_compressed(BLOCKWISE_NPZ, inst=np.asarray(inst),
                        fg=np.asarray(fg_out).astype(bool), numinst=numinst,
                        block_keys=np.array(keys, np.int64).reshape(-1, 3),
                        block_pairs=np.array(n_pairs, np.int64))
    meta = {
        "source": "scripts/export_torch_fixtures.py --blockwise: JAX "
                  "package, CPU, float32, engine jax, blockwise_vote_"
                  "instances on the decoded FlyLight crop (bench.py:141-211 "
                  "predict + decode, [vote_instances] pt 0.6, fc 0.5, mws, "
                  "overlapping_inst, numinst 0.9/0.1)",
        "size": list(vol), "full": [50, 50, 50],
        "chunksize": list(BLOCKWISE_CHUNK),
        "cpu_seconds": round(seconds, 1),
        "fg_vox": int(fg.sum()), "n_blocks": len(keys),
        "n_nonempty_blocks": int(sum(blocks[k] is not None for k in keys)),
        "block_pairs": dict(zip(("_".join(str(v) for v in k) for k in keys),
                                n_pairs)),
        "n_instances": int(len(np.unique(inst[inst > 0]))),
        "own_fg_vox": int((np.asarray(inst) > 0).sum())}
    with open(BLOCKWISE_JSON, "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


def export_cli():
    """The reference CLI's inference and evaluation tasks on the crop,
    function by function, as ``patchperpix_tpu/cli.py`` chains them."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    import bench
    from patchperpix_tpu import config as cfglib
    from patchperpix_tpu.assembly import vote_instances as jvi
    from patchperpix_tpu.assembly.vote_instances import (VoteInstancesParams,
                                                         do_all)
    from patchperpix_tpu.evaluate import evaluate_file
    from patchperpix_tpu.infer import decode_sample, predict_sample_to_zarr
    from patchperpix_tpu.models import PPPModel
    from patchperpix_tpu.train.data import load_sample
    from patchperpix_tpu.utils import io as vio

    config = cfglib.load_config(CLI_CONFIG)
    data, ev = config["data"], config["evaluation"]
    model, cfg = bench.crop_model()
    params = bench.load_trained_params(model, cfg)
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = PPPModel(cfg)
    sample = os.path.splitext(os.path.basename(bench.FIXTURE))[0]
    sd = load_sample(bench.FIXTURE, data["raw_key"], data["gt_key"],
                     clipmax=config["preprocessing"]["clipmax"])
    win = tuple(config["model"]["test_input_shape_same"])
    work = tempfile.mkdtemp(prefix="ppp_cli_ref_")
    seconds = {}
    try:
        pred = os.path.join(work, "processed", sample + ".zarr")
        os.makedirs(os.path.dirname(pred))
        t0 = time.perf_counter()
        predict_sample_to_zarr(model, params, sd.raw, cfg, win, win, pred,
                               batch_size=config["prediction"]["batch_size"])
        seconds["predict"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        decode_sample(model, params, pred, cfg,
                      fg_thresh=config["prediction"]["fg_thresh"])
        seconds["decode"] = time.perf_counter() - t0

        # label, as cli.label composes the [vote_instances] section
        vi_cfg = dict(config["vote_instances"])
        vi_cfg["patchshape"] = config["model"]["patchshape"]
        vi_cfg["overlapping_inst"] = config["model"]["overlapping_inst"]
        vi_cfg.setdefault("numinst_key", "volumes/pred_numinst")
        inst_dir = os.path.join(work, "instanced")
        vp = VoteInstancesParams.from_config(vi_cfg, result_folder=inst_dir)
        skels = []
        orig = jvi.skeletonize

        def capture(volume, *a, **kw):
            out = orig(volume, *a, **kw)
            skels.append(np.asarray(out) > 0)
            return out

        jvi.skeletonize = capture
        try:
            t0 = time.perf_counter()
            res_file = do_all(pred, vp, result_folder=inst_dir)
            seconds["label"] = time.perf_counter() - t0
        finally:
            jvi.skeletonize = orig
        assert len(skels) == 1, f"{len(skels)} skeletonize calls in label"

        t0 = time.perf_counter()
        metrics = evaluate_file(
            res_file, bench.FIXTURE, res_key=ev["res_key"],
            gt_key=data["gt_key"],
            localization_criterion=ev["localization_criterion"],
            assignment_strategy=ev["assignment_strategy"],
            remove_small_components=ev["remove_small_components"],
            keep_gt_shape=ev["keep_gt_shape"],
            add_general_metrics=ev["add_general_metrics"],
            add_multi_thresh_metrics=ev.get("add_multi_thresh_metrics", ()))
        seconds["evaluate"] = time.perf_counter() - t0
        rio = vio.open_volume(res_file, mode="r")
        inst = np.asarray(rio.read(key=vp.res_key))
        fg = np.asarray(rio.read(key="vote_foreground")) > 0
        rio.close()
        shutil.copyfile(res_file, JAX_RESULT)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    np.savez_compressed(
        CLI_NPZ, inst=inst.astype(np.uint16), fg=np.packbits(fg),
        skel=np.packbits(skels[0]), shape=np.array(fg.shape, np.int64))
    meta = {
        "source": "scripts/export_torch_fixtures.py --cli: JAX package, "
                  "CPU, float32, predict_sample_to_zarr -> decode_sample -> "
                  "do_all (from_config of configs/flylight_crop_dec.toml "
                  "[vote_instances], engine jax) -> evaluate_file (its "
                  "[evaluation]) on the FlyLight crop",
        "cpu_seconds": {k: round(v, 1) for k, v in seconds.items()},
        "fg_vox": int(fg.sum()), "skel_vox": int(skels[0].sum()),
        "n_instances": int(len(np.unique(inst[inst > 0]))),
        "own_fg_vox": int((inst > 0).sum()),
        "avg_f1_cov_score": metrics["general"]["avg_f1_cov_score"],
        "AP_0.5_cldice_greedy": metrics["confusion_matrix"]["th_0_5"]["AP"],
        "metrics": metrics}
    with open(CLI_JSON, "w") as f:
        json.dump(meta, f, indent=1, default=float)
    with open(JAX_RESULT_JSON, "w") as f:
        json.dump({"source": "scripts/export_torch_fixtures.py --cli: the "
                             "JAX package's do_all result file (h5py) of "
                             "the run above and its evaluate_file dict",
                   "sample": sample, "res_key": vp.res_key,
                   "n_instances": meta["n_instances"],
                   "avg_f1_cov_score": meta["avg_f1_cov_score"],
                   "metrics": metrics}, f, indent=1, default=float)
    print(json.dumps({k: v for k, v in meta.items() if k != "metrics"}))


def export_bf16():
    """bench.py's self-consistent pipeline with the bfloat16 model, one
    pass on the CPU."""
    import numpy as np

    import bench
    from patchperpix_tpu.assembly import VoteInstancesParams, to_instance_seg
    from patchperpix_tpu.assembly.vote_instances import numinst_from_probs
    from patchperpix_tpu.evaluate import evaluate_labels
    from patchperpix_tpu.infer.fused import (decode_volume_device,
                                             predict_volume_device)
    from patchperpix_tpu.utils import io as vio
    from patchperpix_tpu.utils.postprocess import remove_small_components

    model, cfg = bench.crop_model()
    assert cfg.dtype == "bfloat16"
    params = bench.load_trained_params(model, cfg)
    raw = bench.load_raw_clip()
    gt = vio.IoZarr(bench.FIXTURE).read(
        key="volumes/gt_instances").astype(np.int32)
    t0 = time.perf_counter()
    win = (52, 52, 52)
    code, prob = predict_volume_device(model, params, raw, cfg, win, win)
    vp = VoteInstancesParams(
        patchshape=bench.PS, engine="jax", patch_threshold=0.6,
        fc_threshold=0.5, overlapping_inst=True, mws=True,
        select_patches_for_sparse_data=True, skeletonize_foreground=False,
        numinst_threshs=(0.9, 0.1))
    numinst = numinst_from_probs(np.asarray(prob, np.float32), vp)
    fg = numinst > 0
    dec = decode_volume_device(model, params, code, fg, cfg)
    inst, _ = to_instance_seg(dec, fg, fg.copy(), numinst, vp)
    seconds = time.perf_counter() - t0
    inst = np.asarray(inst).copy()
    inst[~fg] = 0
    inst = remove_small_components(inst, 400)
    res = evaluate_labels(inst, gt, localization_criterion="iou",
                          assignment_strategy="hungarian",
                          keep_gt_shape=True)
    res_cl = evaluate_labels(inst, gt, localization_criterion="cldice",
                             assignment_strategy="greedy",
                             keep_gt_shape=True)
    np.savez_compressed(BF16_NPZ, inst=inst.astype(np.uint16),
                        fg=np.packbits(fg),
                        shape=np.array(fg.shape, np.int64))
    meta = {
        "source": "scripts/export_torch_fixtures.py --bf16: JAX package, "
                  "CPU, bfloat16 model, engine jax, bench.py:141-211 "
                  "pipeline (pt 0.6, fc 0.5, mws, rm 400)",
        "cpu_seconds": round(seconds, 1),
        "fg_vox": int(fg.sum()),
        "n_instances": int(len(np.unique(inst[inst > 0]))),
        "own_fg_vox": int((inst > 0).sum()),
        "AP_0.5_iou_hungarian": res["confusion_matrix"]["th_0_5"]["AP"],
        "avg_f1_cov_score": res_cl["general"]["avg_f1_cov_score"],
        "AP_0.5_cldice_greedy": res_cl["confusion_matrix"]["th_0_5"]["AP"]}
    with open(BF16_JSON, "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


class _JnpF64:
    """``jax.numpy`` with ``float32`` read as ``float64``: put in place of
    the JAX trainer's ``jnp`` so that its step casts the heads to float64
    (and its losses accumulate in float64) instead of float32."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, "float64" if name == "float32" else name)


def _grads_as_state():
    """An optax transformation that keeps the gradients as its state, so a
    train step's gradients can be read."""
    import jax
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda p: p,
        lambda g, st, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _nest(flat, dtype=None):
    """{'a/b/c': array} -> nested dict of jax arrays (in ``dtype``)."""
    import jax.numpy as jnp
    import numpy as np

    tree = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(val if dtype is None
                                      else np.asarray(val, dtype))
    return tree


def _leaves(model, shape):
    """[name, shape] of every parameter of a Flax model, by eval_shape on
    an input of ``shape``."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros(shape), method=model.full_init))
    return [[k, list(v.shape)] for k, v in sorted(flatten(shapes).items())]


def _step_f64(cfg, flat, raw, labels, key, corners=None):
    """One ``make_train_step`` of the JAX package under jax_enable_x64
    (enabled by the caller): a float64 model, float64 parameters, its
    heads and losses in float64; ``corners`` (if given) replace the code
    corners the step draws, since x64 draws others.  Returns (grads,
    metrics)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.ops.affinities import (gt_affinities_dense,
                                                gt_affinities_sampled,
                                                sample_fg_corners)
    from patchperpix_tpu.train import trainer as jt

    cfg = dataclasses.replace(cfg, dtype="float64")
    model = jm.PPPModel(cfg)
    params = _nest(flat, np.float64)
    step, _ = jt.make_train_step(model, cfg, jt.TrainConfig(),
                                 _grads_as_state())

    def stored_corners(rng, gt_fg, n):
        _, valid = sample_fg_corners(rng, gt_fg, n)
        return jnp.asarray(corners, jnp.int32), valid

    def x32(fn):
        # the 0/1 targets: their window starts mix Python ints into
        # int32 indices, which x64 would make int64
        def run(*args):
            with jax.enable_x64(False):
                return fn(*args)
        return run

    jnp_f32, jt.jnp = jt.jnp, _JnpF64(jnp)
    if corners is not None:
        jt.sample_fg_corners = stored_corners
    jt.gt_affinities_sampled = x32(gt_affinities_sampled)
    jt.gt_affinities_dense = x32(gt_affinities_dense)
    try:
        _, grads, mets = step(params, params, jnp.asarray(raw, jnp.float64),
                              jnp.asarray(labels), key)
    finally:
        jt.jnp, jt.sample_fg_corners = jnp_f32, sample_fg_corners
        jt.gt_affinities_sampled = gt_affinities_sampled
        jt.gt_affinities_dense = gt_affinities_dense
    return grads, mets


def _f64_record(want, out, branch, grads, mets, source):
    """The f32 step's errors against the float64 one into ``want`` (the
    branch's record) and the float64 gradient samples into ``out``."""
    import numpy as np


    err = {"loss": {}, "grads": {}, "source": source}
    for k in ("loss", "loss_patch", "loss_fg"):
        err["loss"][k] = (abs(want["metrics"][k] - float(mets[k]))
                          / abs(float(mets[k])))
    norms = {}
    for name, g in sorted(flatten(grads).items()):
        g = np.asarray(g, np.float64).reshape(-1)
        assert g.dtype == np.float64
        err["grads"][name] = cs.leaf_rel_err(
            name, g, want["grad_norms"][name], out[f"{branch}/{name}"])
        norms[name] = float(np.linalg.norm(g))
        out[f"f64/{branch}/{name}"] = g[cs.grad_sample_index(name, g.size)]
    want["float64_err"] = err
    want["float64_metrics"] = {k: float(mets[k]) for k in
                               ("loss", "loss_patch", "loss_fg")}
    want["float64_grad_norms"] = norms
    print(branch, json.dumps(err["loss"]),
          max(err["grads"].items(), key=lambda kv: kv[1]), flush=True)


def export_train_f64(valid=False):
    """The JAX f32 step's own rounding error, measured by the JAX package
    alone: the stored step's batch and corners through the same
    ``make_train_step`` with ``jax_enable_x64``, a float64 model and
    float64 parameters, its heads and losses in float64.  Stores each
    branch's loss parts' and gradient leaves' relative error of the f32
    step against this one (gradients compared as cs.leaf_rel_err
    compares them) as ``float64_err``, and the float64 step's leaf norms
    and seeded entries beside the f32 ones.  ``valid``: the valid
    branch's fixture (``--train-valid``) instead of the code and dense
    branches'."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.train import data as jd
    from patchperpix_tpu_torch.weights import load_npz, seeded_tree

    npz, js = (TRAIN_VALID_NPZ, TRAIN_VALID_JSON) if valid else \
        (TRAIN_NPZ, TRAIN_JSON)
    with open(js) as f:
        meta = json.load(f)
    with np.load(npz) as z:
        out = dict(z)
    raw, labels, _, _ = cs.train_batch(
        jd, out["centres"].astype(np.int64),
        cs.TRAIN_VALID_EXTENT if valid else (40, 40))
    key = jax.random.PRNGKey(meta["corner_key"])
    for branch, path in ((("valid", cs.CLI_CONFIG),) if valid else
                         (("code", cs.CLI_CONFIG),
                          ("dense", cs.TRAIN_DENSE_CONFIG))):
        cfg = cs.train_model_config(
            jm, path, **({"padding": "valid"} if valid else {}))
        if branch != "dense":
            flat = load_npz()
        else:
            flat = seeded_tree(_leaves(jm.PPPModel(cfg), (1, 3, 8, 8, 8)),
                               cs.TRAIN_SEED)
        grads, mets = _step_f64(
            cfg, flat, raw, labels, key,
            corners=out["corners"] if branch != "dense" else None)
        _f64_record(meta["branches"][branch], out, branch, grads, mets,
                    "the JAX package in float64 on the CPU "
                    "(jax_enable_x64, scripts/export_torch_fixtures.py"
                    " --train-f64)")
    np.savez_compressed(npz, **out)
    with open(js, "w") as f:
        json.dump(meta, f, indent=1)


def export_train_valid():
    """Gate (a)'s valid branch: the code branch's model
    (configs/flylight_crop_dec.toml, the trained parameters) with valid
    padding, one JAX float32 train step on the CPU on 52^3 crops at the
    stored train batch's centres (labels 18^3): the code corners the step
    draws under PRNGKey(7), the loss parts, each gradient leaf's L2 norm
    and 256 seeded entries of it, as ``--train`` stores a branch."""
    import jax
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.train import data as jd
    from patchperpix_tpu_torch.weights import load_npz

    with np.load(TRAIN_NPZ) as z:
        centres = z["centres"].astype(np.int64)
    raw, labels, _, _ = cs.train_batch(jd, centres, cs.TRAIN_VALID_EXTENT)
    key = jax.random.PRNGKey(cs.TRAIN_CORNER_KEY)
    cfg = cs.train_model_config(jm, cs.CLI_CONFIG, padding="valid")
    out = {"centres": centres.astype(np.int16)}
    meta = {"source": "scripts/export_torch_fixtures.py --train-valid: JAX "
                      "package, CPU, float32",
            "batch": _batch_meta(raw, labels),
            "corner_key": cs.TRAIN_CORNER_KEY,
            "branches": {"valid": _export_step(
                cfg, _nest(load_npz()), raw, labels, key, out, "valid",
                config=os.path.relpath(cs.CLI_CONFIG, ROOT)
                + ", padding valid",
                weights="parity/bench_ckpt_params.npz")}}
    np.savez_compressed(TRAIN_VALID_NPZ, **out)
    with open(TRAIN_VALID_JSON, "w") as f:
        json.dump(meta, f, indent=1)


def _batch_meta(raw, labels):
    """The sums and shapes the card tests check their batch against."""
    import numpy as np

    return {"raw_sum": float(raw.astype(np.float64).sum()),
            "labels_sum": int(labels.astype(np.int64).sum()),
            "raw_shape": list(raw.shape), "labels_shape": list(labels.shape)}


def _export_step(cfg, params, raw, labels, key, out, branch, **record):
    """One JAX float32 train step of ``cfg`` on the CPU: its code corners
    (a code model's, drawn under ``key``) and each gradient leaf's seeded
    entries into ``out`` (keyed ``<branch>/<leaf>``); returns the branch's
    record, ``record`` with the metrics, the leaf norms and the seconds."""
    import jax.numpy as jnp
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.ops.affinities import sample_fg_corners
    from patchperpix_tpu.train import trainer as jt

    step, _ = jt.make_train_step(jm.PPPModel(cfg), cfg, jt.TrainConfig(),
                                 _grads_as_state())
    t0 = time.perf_counter()
    _, grads, mets = step(params, params, jnp.asarray(raw),
                          jnp.asarray(labels), key)
    grads = {k: np.asarray(v, np.float32) for k, v in flatten(grads).items()}
    sec = time.perf_counter() - t0
    if cfg.train_code:
        ninst = (labels[:, :, 3:-3, 3:-3, 3:-3] > 0).sum(1)
        corners, _ = sample_fg_corners(key, jnp.asarray(ninst == 1),
                                       cfg.num_code_samples)
        out["corners"] = np.asarray(corners).astype(np.int16)
    norms = {}
    for name, g in sorted(grads.items()):
        idx = cs.grad_sample_index(name, g.size)
        out[f"{branch}/{name}"] = g.reshape(-1)[idx]
        norms[name] = float(np.linalg.norm(g.astype(np.float64)))
    record.update(metrics={k: float(v) for k, v in mets.items()},
                  grad_norms=norms, step_s_with_compile=round(sec, 1))
    print(branch, json.dumps(record["metrics"]), flush=True)
    return record


def export_train(with_runs=True):
    """The train step's loss parts and gradient samples, both branches,
    and (``with_runs``) the loss level of two 200-step runs; without, the
    stored runs are kept."""
    import shutil
    import tempfile

    import jax
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.train import data as jd
    from patchperpix_tpu.train import trainer as jt
    from patchperpix_tpu.train.device_data import DeviceSampler
    from patchperpix_tpu_torch.weights import load_npz, seeded_tree

    raw, labels, centres, sample = cs.train_batch(jd)
    key = jax.random.PRNGKey(cs.TRAIN_CORNER_KEY)
    out = {"centres": centres.astype(np.int16)}
    meta = {"source": "scripts/export_torch_fixtures.py --train: JAX "
                      "package, CPU, float32",
            "batch": _batch_meta(raw, labels),
            "corner_key": cs.TRAIN_CORNER_KEY, "branches": {}}
    for branch, path in (("code", cs.CLI_CONFIG),
                         ("dense", cs.TRAIN_DENSE_CONFIG)):
        cfg = cs.train_model_config(jm, path)
        if branch == "code":
            params = _nest(load_npz())
        else:
            params = _nest(seeded_tree(_leaves(jm.PPPModel(cfg),
                                               (1, 3, 8, 8, 8)),
                                       cs.TRAIN_SEED))
        meta["branches"][branch] = _export_step(
            cfg, params, raw, labels, key, out, branch,
            config=os.path.relpath(path, ROOT),
            weights=("parity/bench_ckpt_params.npz" if branch == "code"
                     else f"weights.seeded_tree(leaves, {cs.TRAIN_SEED})"))

    if not with_runs and os.path.exists(TRAIN_JSON):
        with open(TRAIN_JSON) as f:
            meta["runs"] = json.load(f).get("runs")
    np.savez_compressed(TRAIN_NPZ, **out)
    with open(TRAIN_JSON, "w") as f:
        json.dump(meta, f, indent=1)
    if not with_runs:
        return

    # gate (b): the loss level of two runs from Flax's init
    cfg = cs.train_model_config(jm, cs.CLI_CONFIG, **cs.TRAIN_RUN_WIDTHS)
    runs = []
    for seed in (0, 1):
        work = tempfile.mkdtemp(prefix="ppp_train_ref_")
        try:
            ds = DeviceSampler([sample], cs.train_sampler_config(jd),
                               max_gt_channels=labels.shape[1])
            tcfg = jt.TrainConfig(
                max_iterations=cs.TRAIN_RUN_STEPS,
                checkpoints=cs.TRAIN_RUN_STEPS, snapshots=0, lr=1e-3,
                output_folder=work, log_every=1, tensorboard=False)
            t0 = time.perf_counter()
            jt.train_until(jm.PPPModel(cfg), cfg, tcfg, ds, rng_seed=seed)
            wall = time.perf_counter() - t0
            with open(os.path.join(work, "train_log.jsonl")) as f:
                rows = [json.loads(line) for line in f]
        finally:
            shutil.rmtree(work, ignore_errors=True)
        # by step: with log_every 1 the device loop logs step 1 twice
        by_step = {r["step"]: r["loss"] for r in rows if "loss" in r}
        losses = [by_step[k] for k in sorted(by_step)]
        assert len(losses) == cs.TRAIN_RUN_STEPS, len(losses)
        runs.append({"seed": seed, "wall_s": round(wall, 1),
                     "tail_mean_loss": float(np.mean(
                         losses[-cs.TRAIN_RUN_TAIL:])),
                     "losses": losses})
        print("run", seed, runs[-1]["wall_s"], runs[-1]["tail_mean_loss"],
              flush=True)
    meta["runs"] = {"steps": cs.TRAIN_RUN_STEPS, "tail": cs.TRAIN_RUN_TAIL,
                    "lr": 1e-3, "schedule": "constant",
                    "sampler": "device, configs/flylight_crop_dec.toml "
                               "sampling, default augmentations",
                    "init": "Flax full_init, PRNGKey(seed)",
                    "widths": cs.TRAIN_RUN_WIDTHS, "runs": runs}
    with open(TRAIN_JSON, "w") as f:
        json.dump(meta, f, indent=1)
    print(f"written {TRAIN_NPZ} ({os.path.getsize(TRAIN_NPZ)} bytes)")


def export_swin():
    """The Swin backbone's fixtures: (a) configs/flylight.toml's Swin at
    full width, seeded, on the 156^3 test window (the heads at seeded
    entries; the backbone's features through the 1x1 heads at those
    entries only, so that the (343, 156^3) head is never held in memory);
    (b) one f32 train step of configs/flylight_crop.toml's model with
    network_style "swinunetr", seeded, on the train phase's batch (loss
    parts, gradient norms and samples; then ``--swin-f64``, the same step
    in float64, in a subprocess); (c) the 2D Swin at configs/bbbc010.toml's
    widths, seeded, on the model2d window (code, numinst and decoded
    patches at the model2d positions)."""
    import subprocess

    import jax
    import jax.numpy as jnp
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.infer.fused import predict_volume_device
    from patchperpix_tpu.train import data as jd
    from patchperpix_tpu.train import trainer as jt
    from patchperpix_tpu_torch.weights import seeded_tree

    out, meta = {}, {"source": "scripts/export_torch_fixtures.py --swin: "
                               "JAX package, CPU, float32"}
    # (a) the full-width forward
    cfg = cs.swin_model_config(jm)
    model = jm.PPPModel(cfg)
    x = cs.swin_window()
    leaves = _leaves(model, x.shape)
    params = _nest(seeded_tree(leaves, cs.SWIN_SEED))
    t0 = time.perf_counter()
    feats = jax.jit(lambda p, r: model.apply(
        p, r, method=lambda m, v: m.unet(jnp.moveaxis(v, 1, -1))))(
            params, jnp.asarray(x))
    feats = np.asarray(feats, np.float32)[0]          # (*S, F)
    sec = time.perf_counter() - t0
    flat = feats.reshape(-1, feats.shape[-1])
    heads = {}
    for name, n_out in (("head_code_affs", cfg.out_channels_head1),
                        ("head_fgbg_numinst", cfg.out_channels_head2)):
        k = np.asarray(params["params"][name]["kernel"], np.float32)
        b = np.asarray(params["params"][name]["bias"], np.float32)
        ch, vox = cs.swin_positions((n_out,) + x.shape[2:])
        out[f"fwd/{name}"] = (np.einsum("nf,fn->n", flat[vox],
                                        k.reshape(-1, n_out)[:, ch])
                              + b[ch]).astype(np.float32)
        heads[name] = n_out
    out["fwd/feature_mean"] = feats.mean(axis=(0, 1, 2))
    meta["forward"] = {
        "config": os.path.relpath(cs.SWIN_CONFIG, ROOT),
        "window": list(x.shape), "seed": cs.SWIN_SEED, "heads": heads,
        "n_parameters": int(sum(int(np.prod(s)) for _, s in leaves)),
        "leaves": leaves, "cpu_seconds_with_compile": round(sec, 1)}
    print("swin forward", round(sec, 1), "s", flush=True)
    del feats, flat

    # (b) the crop config's train step
    with np.load(TRAIN_NPZ) as z:
        centres = z["centres"].astype(np.int64)
    raw, labels, _, _ = cs.train_batch(jd, centres)
    cfg = cs.swin_model_config(jm, cs.TRAIN_DENSE_CONFIG)
    model = jm.PPPModel(cfg)
    tree = seeded_tree(_leaves(model, raw.shape), cs.TRAIN_SEED)
    step, _ = jt.make_train_step(model, cfg, jt.TrainConfig(),
                                 _grads_as_state())
    t0 = time.perf_counter()
    _, grads, mets = step(_nest(tree), _nest(tree), jnp.asarray(raw),
                          jnp.asarray(labels),
                          jax.random.PRNGKey(cs.TRAIN_CORNER_KEY))
    sec = time.perf_counter() - t0
    norms = {}
    for name, g in sorted(flatten(grads).items()):
        g = np.asarray(g, np.float32)
        out[f"swin/{name}"] = g.reshape(-1)[cs.grad_sample_index(name,
                                                                 g.size)]
        norms[name] = float(np.linalg.norm(g.astype(np.float64)))
    meta["branches"] = {"swin": {
        "config": os.path.relpath(cs.TRAIN_DENSE_CONFIG, ROOT)
        + ' with network_style = "swinunetr"',
        "weights": f"weights.seeded_tree(leaves, {cs.TRAIN_SEED})",
        "batch": {"raw_sum": float(raw.astype(np.float64).sum()),
                  "labels_sum": int(labels.astype(np.int64).sum())},
        "metrics": {k: float(v) for k, v in mets.items()},
        "grad_norms": norms, "step_s_with_compile": round(sec, 1)}}
    print("swin step", json.dumps(meta["branches"]["swin"]["metrics"]),
          flush=True)

    # (c) the 2D Swin at the BBBC010 widths
    cfg = jm.PPPConfig(**cs.SWIN_MODEL2D)
    model = jm.PPPModel(cfg)
    raw2, pos = cs.model2d_sample()
    win = cs.MODEL2D_WINDOW
    leaves2 = _leaves(model, (1, 1) + win)
    params = _nest(seeded_tree(leaves2, cs.SWIN_SEED))
    t0 = time.perf_counter()
    code, prob = predict_volume_device(model, params, raw2, cfg, win, win)
    code = np.asarray(code, np.float32).reshape(cfg.code_units, -1)[:, pos]
    prob = np.asarray(prob, np.float32).reshape(3, -1)[:, pos]
    logits = model.apply(params, jnp.asarray(code.T),
                         method=jm.PPPModel.decode)
    out["model2d/code"] = code.T
    out["model2d/prob"] = prob.T
    out["model2d/patches"] = np.asarray(jax.nn.sigmoid(logits), np.float32)
    meta["model2d"] = {"widths": "configs/bbbc010.toml",
                       "window": list(win), "seed": cs.SWIN_SEED,
                       "n_positions": int(len(pos)), "leaves": leaves2,
                       "cpu_seconds": round(time.perf_counter() - t0, 1)}
    np.savez_compressed(cs.SWIN_REF_NPZ, **out)
    with open(cs.SWIN_REF_JSON, "w") as f:
        json.dump(meta, f, indent=1)
    # float64 is process-wide in JAX: the witness runs on its own
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--swin-f64"], check=True)


def export_swin_f64():
    """The stored Swin step in float64 by the JAX package (as
    ``--train-f64`` for the crop's branches)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.train import data as jd
    from patchperpix_tpu_torch.weights import seeded_tree

    with open(cs.SWIN_REF_JSON) as f:
        meta = json.load(f)
    with np.load(cs.SWIN_REF_NPZ) as z:
        out = dict(z)
    with np.load(TRAIN_NPZ) as z:
        centres = z["centres"].astype(np.int64)
    raw, labels, _, _ = cs.train_batch(jd, centres)
    cfg = cs.swin_model_config(jm, cs.TRAIN_DENSE_CONFIG)
    grads, mets = _step_f64(cfg, seeded_tree(
        _leaves(jm.PPPModel(cfg), raw.shape), cs.TRAIN_SEED), raw, labels,
        jax.random.PRNGKey(cs.TRAIN_CORNER_KEY))
    _f64_record(meta["branches"]["swin"], out, "swin", grads, mets,
                "the JAX package in float64 on the CPU (jax_enable_x64, "
                "scripts/export_torch_fixtures.py --swin-f64)")
    np.savez_compressed(cs.SWIN_REF_NPZ, **out)
    with open(cs.SWIN_REF_JSON, "w") as f:
        json.dump(meta, f, indent=1)


def export_isbi_zlib():
    """A zlib copy of every array of data/synth_isbi (blosc, read by the
    JAX package's tensorstore reader) under the same keys, chunks and
    types, checked by reading it back through the port's store."""
    import glob
    import shutil

    import numpy as np

    from patchperpix_tpu.utils import io as jio
    from patchperpix_tpu_torch.utils import io as tio

    n = 0
    for src in sorted(glob.glob(os.path.join(ISBI_SRC, "*", "*.zarr"))):
        dst = os.path.join(cs.ISBI_DATA, os.path.relpath(src, ISBI_SRC))
        shutil.rmtree(dst, ignore_errors=True)
        jin, tout = jio.IoZarr(src, mode="r"), tio.IoZarr(dst, mode="w")
        for key in ("volumes/raw", "volumes/gt_instances"):
            with open(os.path.join(src, key, ".zarray")) as f:
                meta = json.load(f)
            arr = np.asarray(jin.read(key=key))
            tout.create(key, arr.shape, arr.dtype, chunks=meta["chunks"])
            tout.write(arr, key=key)
            assert np.array_equal(tio.IoZarr(dst).read(key=key), arr)
            n += 1
        jin.close()
        tout.close()
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(cs.ISBI_DATA) for f in fs)
    print(f"written {cs.ISBI_DATA}: {n} arrays, {size} bytes", flush=True)


def _isbi_part_a():
    """(a) the rehearsal's assembly on the ideal affinities of both test
    samples at full size."""
    import numpy as np

    from patchperpix_tpu.assembly import isbi_hacks as jh
    from patchperpix_tpu.assembly.vote_instances import (VoteInstancesParams,
                                                         to_instance_seg)
    from patchperpix_tpu.evaluate import evaluate_labels

    params = VoteInstancesParams.from_config(cs.isbi_vote_kwargs())
    rad = np.asarray(params.patchshape) // 2
    arrays, meta = {}, {}
    for sample in cs.ISBI_TEST:
        affs, fg, gt = cs.isbi_ideal(sample)
        inner = np.zeros(fg.shape, bool)
        inner[tuple(slice(int(r), int(s - r))
                    for r, s in zip(rad, fg.shape))] = True
        kept = jh.sparsify_patches([tuple(c) for c in np.argwhere(
            fg & inner)], params.isbi_sparsify_stride, vol_shape=fg.shape)
        t0 = time.perf_counter()
        inst, fg_out = to_instance_seg(affs, fg, fg.copy(),
                                       fg.astype(np.uint8), params)
        sec = time.perf_counter() - t0
        inst = np.asarray(inst, np.uint16)
        inst[np.asarray(fg_out) == 0] = 0
        metrics = evaluate_labels(inst, gt, **cs.isbi_eval_kwargs())
        arrays[f"a/{sample}/inst"] = inst
        meta[sample] = {"cpu_seconds": round(sec, 1),
                        "n_candidates": len(kept),
                        "n_instances": int(len(np.unique(inst[inst > 0]))),
                        "metrics": metrics}
        print("a", sample, sec, meta[sample]["n_instances"],
              metrics["general"]["rand_fscore"], flush=True)
    return arrays, {"assembly": meta}


def _isbi_part_b():
    """(b) keep_single_slice, the sparse candidate grid and the boundary
    filter on the seeded three-slice stack.  The filter takes every
    interior candidate of the kept slice: on the stride-20 grid no pixel
    lies in the rings of the 0.33 * 625 patches it takes to drop it."""
    import numpy as np

    from patchperpix_tpu.assembly import isbi_hacks as jh

    affs, fg = cs.isbi_stack()
    ps = np.array([1, 25, 25])
    rad = ps // 2
    keep = jh.keep_single_slice(fg)
    inner = np.zeros(fg.shape, bool)
    inner[tuple(slice(int(r), int(s - r))
                for r, s in zip(rad, fg.shape))] = True
    cand = [tuple(c) for c in np.argwhere(keep & inner)]
    pts = jh.sparsify_patches(cand, 20, vol_shape=fg.shape)
    mask = jh.filter_instance_boundaries_from_fg(affs, fg, cand, ps,
                                                 keep.copy())
    print("b", len(pts), len(cand), int(keep.sum()), int(mask.sum()),
          flush=True)
    return ({"b/keep": np.packbits(keep), "b/mask": np.packbits(mask),
             "b/grid": np.asarray(pts, np.int16)},
            {"boundary": {"shape": list(fg.shape), "n_grid": len(pts),
                          "n_candidates": len(cand),
                          "keep_vox": int(keep.sum()),
                          "mask_vox": int(mask.sum())}})


def _isbi_part_c():
    """(c) the JAX CLI's chain and cross_validate with the rehearsal config
    on the zlib copy, float32, from a seeded checkpoint."""
    import glob
    import shutil
    import tempfile

    import numpy as np

    from patchperpix_tpu import cli as jcli
    from patchperpix_tpu import models as jm
    from patchperpix_tpu.train.trainer import checkpoint_path, save_checkpoint
    from patchperpix_tpu.utils import io as jio
    from patchperpix_tpu_torch.models.init import flax_leaves
    from patchperpix_tpu_torch import models as tm

    cfg = cs.train_model_config(jm, cs.ISBI_CONFIG)
    leaves = _leaves(jm.PPPModel(cfg), (1, 1, 64, 64))
    assert [(k, tuple(v)) for k, v in leaves] == sorted(
        flax_leaves(cs.train_model_config(tm, cs.ISBI_CONFIG)))
    work = tempfile.mkdtemp(prefix="ppp_isbi_cli_ref_")
    arrays, meta = {}, {}
    try:
        exps = os.path.join(work, "exps")
        save_checkpoint(checkpoint_path(os.path.join(exps, "jax", "train"),
                                        cs.ISBI_CLI_STEP),
                        {"params": _nest(cs.isbi_seeded_tree(leaves)),
                         "step": cs.ISBI_CLI_STEP})
        override = cs.isbi_cli_override(work)
        t0 = time.perf_counter()
        paths = jcli.main(cs.isbi_cli_argv(exps, override, "jax")
                          + ["-d", "mknet", "predict", "label", "evaluate",
                             "cross_validate"])
        sec = time.perf_counter() - t0
        for mode in ("val", "test"):
            inst_dir = os.path.join(paths[f"{mode}_instanced"],
                                    str(cs.ISBI_CLI_STEP))
            for path in sorted(glob.glob(os.path.join(inst_dir, "*.hdf"))):
                s = os.path.splitext(os.path.basename(path))[0]
                io = jio.open_volume(path, mode="r")
                arrays[f"c/{mode}/{s}/inst"] = np.asarray(
                    io.read(key="vote_instances"), np.uint16)
                arrays[f"c/{mode}/{s}/fg"] = np.packbits(np.asarray(
                    io.read(key="vote_foreground")) > 0)
                io.close()
        evals = {}
        for mode in ("val", "test"):
            ev_dir = os.path.join(paths[f"{mode}_evaluated"],
                                  str(cs.ISBI_CLI_STEP))
            for path in sorted(glob.glob(os.path.join(ev_dir, "*.json"))):
                with open(path) as f:
                    evals[f"{mode}/{os.path.basename(path)[:-5]}"] = \
                        json.load(f)
        with open(os.path.join(paths["base"], "cross_val_results.json")) as f:
            cross = json.load(f)
        meta = {"cli": {"cpu_seconds": round(sec, 1), "metrics": evals,
                        "cross_val_results": cross}}
        print("c", sec, json.dumps({k: v["general"]["rand_fscore"]
                                    for k, v in evals.items()}),
              cross["mean_score"], flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return arrays, meta


def _isbi_part_d():
    """(d) the full-width isbi2012 model, seeded, on one 512^2 window."""
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.infer.fused import predict_volume_device
    from patchperpix_tpu.train import data as jd

    cfg = cs.train_model_config(jm, cs.ISBI2012_CONFIG)
    model = jm.PPPModel(cfg)
    leaves = _leaves(model, (1, 1, 64, 64))
    raw = cs.isbi_window(jd)
    win = tuple(cs.isbi_toml(cs.ISBI2012_CONFIG)["model"][
        "test_input_shape_same"])
    t0 = time.perf_counter()
    affs, fg = predict_volume_device(model, _nest(cs.isbi_seeded_tree(
        leaves)), raw, cfg, win, win)
    affs, fg = np.asarray(affs, np.float32), np.asarray(fg, np.float32)
    sec = time.perf_counter() - t0
    ch, pix = cs.isbi_forward_positions(affs.shape)
    print("d", sec, affs.shape, float(affs.std()), float(fg.mean()),
          flush=True)
    return ({"d/affs": affs.reshape(affs.shape[0], -1)[ch, pix],
             "d/fg": fg.reshape(-1)[pix],
             "d/affs_channel_mean": affs.reshape(affs.shape[0], -1).mean(1),
             "d/fg_mean": np.array([fg.mean()], np.float32)},
            {"forward": {"cpu_seconds_with_compile": round(sec, 1),
                         "n_parameters": int(sum(np.prod(v)
                                                 for _, v in leaves)),
                         "window": list(win)}})


def _isbi_part_e():
    """(e) one float32 train step of the rehearsal model on the fixed
    batch: loss parts, gradient norms and samples."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.train import data as jd
    from patchperpix_tpu.train import trainer as jt

    cfg = cs.train_model_config(jm, cs.ISBI_CONFIG)
    model = jm.PPPModel(cfg)
    params = _nest(cs.isbi_seeded_tree(_leaves(model, (1, 1, 64, 64))))
    raw, labels = cs.isbi_train_batch(jd)
    step, _ = jt.make_train_step(model, cfg, jt.TrainConfig(),
                                 _grads_as_state())
    t0 = time.perf_counter()
    _, grads, mets = step(params, params, jnp.asarray(raw),
                          jnp.asarray(labels), jax.random.PRNGKey(0))
    sec = time.perf_counter() - t0
    arrays, norms = {}, {}
    for name, g in sorted(flatten(grads).items()):
        g = np.asarray(g, np.float32)
        arrays[f"isbi/{name}"] = g.reshape(-1)[cs.grad_sample_index(
            name, g.size)]
        norms[name] = float(np.linalg.norm(g.astype(np.float64)))
    rec = {"config": os.path.relpath(cs.ISBI_CONFIG, ROOT),
           "weights": "parity.cases.isbi_seeded_tree",
           "batch": {"raw_sum": float(raw.astype(np.float64).sum()),
                     "labels_sum": int(labels.astype(np.int64).sum())},
           "metrics": {k: float(v) for k, v in mets.items()},
           "grad_norms": norms, "step_s_with_compile": round(sec, 1)}
    print("e", json.dumps(rec["metrics"]), flush=True)
    return arrays, {"branches": {"isbi": rec}}


def _isbi_store(arrays, meta):
    """Merge one part's arrays and records into the stored fixture."""
    import numpy as np


    out, old = {}, {}
    if os.path.exists(cs.ISBI_REF_NPZ):
        with np.load(cs.ISBI_REF_NPZ) as z:
            out = dict(z)
        with open(cs.ISBI_REF_JSON) as f:
            old = json.load(f)
    out.update(arrays)
    old.update(meta)
    old["source"] = ("scripts/export_torch_fixtures.py --isbi: JAX package, "
                     "CPU, float32, on data/synth_isbi_zlib")
    np.savez_compressed(cs.ISBI_REF_NPZ, **out)
    with open(cs.ISBI_REF_JSON, "w") as f:
        json.dump(old, f, indent=1, default=float)


def export_isbi(parts):
    import subprocess

    if not parts:
        export_isbi_zlib()
    fns = {"a": _isbi_part_a, "b": _isbi_part_b, "c": _isbi_part_c,
           "d": _isbi_part_d, "e": _isbi_part_e}
    for part in parts or sorted(fns):
        _isbi_store(*fns[part]())
        if part == "e":
            # float64 is process-wide in JAX: the witness runs on its own
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--isbi-f64"], check=True)


def export_isbi_f64():
    """The stored ISBI step in float64 by the JAX package (as
    ``--train-f64`` for the crop's branches)."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from patchperpix_tpu import models as jm
    from patchperpix_tpu.train import data as jd

    with open(cs.ISBI_REF_JSON) as f:
        meta = json.load(f)
    with np.load(cs.ISBI_REF_NPZ) as z:
        out = dict(z)
    cfg = cs.train_model_config(jm, cs.ISBI_CONFIG)
    raw, labels = cs.isbi_train_batch(jd)
    grads, mets = _step_f64(cfg, cs.isbi_seeded_tree(
        _leaves(jm.PPPModel(cfg), (1, 1, 64, 64))), raw, labels,
        jax.random.PRNGKey(0))
    _f64_record(meta["branches"]["isbi"], out, "isbi", grads, mets,
                "the JAX package in float64 on the CPU (jax_enable_x64, "
                "scripts/export_torch_fixtures.py --isbi-f64)")
    np.savez_compressed(cs.ISBI_REF_NPZ, **out)
    with open(cs.ISBI_REF_JSON, "w") as f:
        json.dump(meta, f, indent=1, default=float)


def export_viz():
    """The JAX package's renders of ``parity.cases.viz_inputs()`` (the same
    numpy arrays the port renders on the card)."""
    import numpy as np

    from patchperpix_tpu.assembly.debug_viz import (render_graph_edges,
                                                    render_patch_tiles)
    from patchperpix_tpu.visualize.instances import render_instances
    from patchperpix_tpu.visualize.patches import patch_mosaic

    t0 = time.perf_counter()
    inp = cs.viz_inputs()
    ps = cs.VIZ_PS
    out = {
        "inst_plain": render_instances(inp["inst"]),
        "inst_raw": render_instances(inp["inst"], raw=inp["raw"]),
        "inst_outline": render_instances(inp["inst"], raw=inp["raw"],
                                         outline=True),
        "mosaic": patch_mosaic(inp["affs"], ps),
        "mosaic_z": patch_mosaic(inp["affs"], ps, z=cs.VIZ_Z,
                                 selected=inp["selected"]),
        "tiles": render_patch_tiles(inp["affs"], inp["fg"], ps),
        "edges": render_graph_edges(inp["pairs"], inp["weights"],
                                    inp["fg"].shape, ps),
    }
    np.savez_compressed(cs.VIZ_REF_NPZ, **out)
    meta = {"source": "scripts/export_torch_fixtures.py --viz: JAX package "
                      "renders (CPU) of parity.cases.viz_inputs()",
            "shapes": {k: list(v.shape) for k, v in out.items()},
            "dtypes": {k: str(v.dtype) for k, v in out.items()},
            "nonzero": {k: int(np.count_nonzero(v)) for k, v in out.items()},
            "seconds": time.perf_counter() - t0}
    with open(cs.VIZ_REF_JSON, "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    if "--2d" in sys.argv:
        rest = [int(a) for a in sys.argv[sys.argv.index("--2d") + 1:]
                if a.isdigit()]
        export_reference_2d(tuple(rest[:2]) if len(rest) >= 2
                            else cs.IMG2D)
        return
    if "--model2d" in sys.argv:
        export_model_2d()
        return
    if "--cli" in sys.argv:
        export_cli()
        return
    if "--viz" in sys.argv:
        export_viz()
        return
    if "--bf16" in sys.argv:
        export_bf16()
        return
    if "--isbi-f64" in sys.argv:
        export_isbi_f64()
        return
    if "--swin-f64" in sys.argv:
        export_swin_f64()
        return
    if "--swin" in sys.argv:
        export_swin()
        return
    if "--isbi" in sys.argv:
        export_isbi([a for a in sys.argv[sys.argv.index("--isbi") + 1:]
                     if a in "abcde"])
        return
    if "--train-f64" in sys.argv:
        export_train_f64(valid="--valid" in sys.argv)
        return
    if "--train-valid" in sys.argv:
        import subprocess

        export_train_valid()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--train-f64", "--valid"], check=True)
        return
    if "--train" in sys.argv or "--train-step" in sys.argv:
        import subprocess

        export_train(with_runs="--train" in sys.argv)
        # float64 is process-wide in JAX: the witness runs on its own
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--train-f64"], check=True)
        return
    if "--blockwise" in sys.argv:
        rest = [int(a) for a in sys.argv[sys.argv.index("--blockwise") + 1:]
                if a.isdigit()]
        export_blockwise(rest[0] if rest else None)
        return
    export_params()
    if "--params-only" not in sys.argv:
        export_reference()


if __name__ == "__main__":
    main()
