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

Usage: JAX_PLATFORMS=cpu python scripts/export_torch_fixtures.py
       [--params-only]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PARAMS_NPZ = os.path.join(ROOT, "parity", "bench_ckpt_params.npz")
REF_NPZ = os.path.join(ROOT, "parity", "torch_port_ref_f32.npz")
REF_JSON = os.path.join(ROOT, "parity", "torch_port_ref_f32.json")


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
        overlap=overlap_mask, sparse_data=True, want_running=False)
    thin = thin_out_cover_device(dec, mask_to_cover, cover, ps,
                                 fc_threshold=params.fc_threshold)
    pairs, _ = ref.patch_pairs_reference(thin, ps, max_ps_dist=2.0,
                                         include_singleton=True)
    sym = symmetrize_consensus(cons, ccfg)
    weights = np.asarray(patch_graph_weights(dec, sym, pairs, ccfg),
                         np.float32)
    comps = ref.graph_components(pairs, weights, mws=True)
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


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    export_params()
    if "--params-only" not in sys.argv:
        export_reference()


if __name__ == "__main__":
    main()
