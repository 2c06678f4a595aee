#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

The main path is bench.py's self-consistent FlyLight pipeline, run by the
port (``patchperpix_tpu_torch``): the trained ppp+dec crop model
(``parity/bench_ckpt_params.npz``) predicts codes and numinst on the 50^3
fixture in one 52^3 window, the numinst head (0.9 / 0.1) gives the
foreground, foreground codes decode to 7^3 patches and ``to_instance_seg``
assembles them (pt 0.6, fc 0.5, mws); then inst[~fg] = 0 and components
under 400 voxels go.  Phases, each printed as one JSON line:

1. device: the card, and nvidia-smi's name and power limit (also printed
   alone on its own line);
2. build: nvcc of every source under csrc/ (five kernels), in parallel;
3. f32 main path (TF32 off): a warm-up run, then the counted run with
   per-stage times; each CUDA kernel is held against its plain PyTorch
   version on this run's decoded affinities (consensus atol = rtol =
   1e-4, rank atol 1e-3 / rtol 1e-4: the JAX package's own kernel
   tolerances), launched a second time for equal bits, and timed against
   it (plain, kernel, kernel, plain; CUDA events; medians);
4. held against the JAX package's float32 CPU run stored in
   parity/torch_port_ref_f32.npz: foreground agreement >= 99.9 %, equal
   instance count, >= 99 % of foreground voxels agreeing after best-IoU
   matching; per-stage agreement is printed to find where two runs part;
5. bf16 main path (the configuration's own dtype; warm-up, then a timed
   run): instance count, own-fg voxels and AP@0.5 (IoU, Hungarian) beside
   the TPU's figures in BENCH_r05.json (information only: bf16 rounds
   differently there);
6. probe: the row-window probe's twelve cases (``ops/probe.py``), kernel
   against plain version, max error < 1e-4;
7. path2d: the 2D assembly at full width, the worm image (16 worms, seed
   0) at 520x696 with 25x25 patches through ``to_instance_seg`` in f32
   under settings (A) (the 2D bench's: pt 0.5, mws, sparse-data cover) and
   (B) (configs/bbbc010.toml's: pt 0.9, label propagation, dense-data
   cover, overlaps): a warm-up, then the counted run with stage times.
   Gates: in (A) every ground-truth worm is matched by exactly one
   predicted instance with IoU >= 0.5; (A) and (B) agree with the JAX
   package's f32 CPU runs in parity/torch_port_ref2d_f32.npz (at the size
   stored there) under the limits of phase 4;
8. kernels2d: the 2D consensus and rank kernels against their plain
   versions on path2d's inputs, f32 and bf16 half (consensus atol = rtol =
   1e-4 in f32, 1e-4 + 2^-7 |x| in bf16, one rounding step of the stored
   type; rank atol 1e-3 / rtol 1e-4), each launched a second time for
   equal bits, timed like phase 3; then the same checks and the kernels'
   times on dense2d, a denser worm image (64 worms, seed 1, setting (A)),
   a kernel check only (no path, no JAX reference);
9. model2d: the BBBC010 model (configs/bbbc010.toml widths, seeded
   weights) on one 512x512 window, predict and decode at seeded pixel
   positions, against parity/torch_port_model2d_ref.npz (1e-4 + 1e-4 |x|);
10. the kernels line, then the contract's last line.

Any failure raises and exits non-zero before the last line; with no CUDA
device, or without the repository beside it, it exits 2.
"""

import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "data", "JRC_SS05008-20160318_24_B2_crop.zarr")
REF_NPZ = os.path.join(REPO, "parity", "torch_port_ref_f32.npz")
REF_JSON = os.path.join(REPO, "parity", "torch_port_ref_f32.json")
BENCH_TPU = os.path.join(REPO, "BENCH_r05.json")
REF2D_NPZ = os.path.join(REPO, "parity", "torch_port_ref2d_f32.npz")
REF2D_JSON = os.path.join(REPO, "parity", "torch_port_ref2d_f32.json")
MODEL2D_NPZ = os.path.join(REPO, "parity", "torch_port_model2d_ref.npz")
MODEL2D_JSON = os.path.join(REPO, "parity", "torch_port_model2d_ref.json")
WIN = (52, 52, 52)
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
CONS_OPS_PER_TERM = 15   # pp, sc, cnt: 4 ops each + 3 accumulations
RANK_OPS_PER_TERM = 7    # w_hh, w_hl (3), difference, product, sum


# the 2D path: the worm image of the 2D workload at BBBC010 size
# (520x696, 25x25 patches) under the two [vote_instances] settings the
# repo's 2D users run: (A) the 2D bench's (mws, sparse-data cover), (B)
# configs/bbbc010.toml's (label propagation, dense-data cover, overlaps)
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
# configs/bbbc010.toml [model] + [model.autoencoder] at full width
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def path2d_inputs(setting, crop=None):
    """Inputs of the 2D path under ``setting`` ("A" or "B"), numpy only:
    worm labels (16 worms, seed 0) cut to the top-left ``crop`` (H, W) if
    given, their ideal 25x25 affinities, the foreground, and numinst (2 on
    the worms' crossing pixels under (B), where overlaps are modelled)."""
    import numpy as np

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
    520x696, about four times path2d's foreground."""
    import numpy as np

    from patchperpix_tpu_torch.ops.synthetic import (labels_to_affinities,
                                                     worm_labels)

    labels, _ = worm_labels(*IMG2D, n_worms=64, seed=1, with_crossings=True)
    return labels_to_affinities(labels, np.array(PS2D))


def model2d_sample(n=512):
    """Seeded raw 512x512 window and the flat pixel positions whose model
    outputs are compared."""
    import numpy as np

    rng = np.random.default_rng(MODEL2D_SEED)
    raw = rng.random((1,) + MODEL2D_WINDOW, dtype=np.float32)
    pos = np.sort(rng.choice(MODEL2D_WINDOW[0] * MODEL2D_WINDOW[1], n,
                             replace=False))
    return raw, pos


def crop_config(dtype):
    from patchperpix_tpu_torch.models import PPPConfig

    return PPPConfig(
        patchshape=(7, 7, 7), num_channels=3, num_fmaps=20,
        fmap_inc_factors=(3, 3), fmap_dec_factors=(1.0, 1.0),
        downsample_factors=((2, 2, 2), (2, 2, 2)), kernel_size=3,
        num_repetitions=2, padding="same", overlapping_inst=True,
        max_num_inst=2, train_code=True, code_units=176, ae_code_fmaps=22,
        ae_num_fmaps=(64, 128), num_code_samples=1024, dtype=dtype)


def vote_params():
    from patchperpix_tpu_torch.assembly import VoteInstancesParams

    return VoteInstancesParams(
        patchshape=(7, 7, 7), patch_threshold=0.6, fc_threshold=0.5,
        overlapping_inst=True, mws=True, select_patches_for_sparse_data=True,
        skeletonize_foreground=False, numinst_threshs=(0.9, 0.1))


def run_path(model, cfg, raw, dev):
    """One pass of the main path through the port's entry points."""
    import numpy as np
    import torch

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


def n_instances(inst):
    import numpy as np

    return int(len(np.unique(inst[inst > 0])))


def match_agreement(a, b):
    """(fraction of voxels in a > 0 or b > 0 whose ids agree after mapping
    a's ids onto b's by best-IoU Hungarian matching, identical up to
    relabelling)."""
    import numpy as np
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


def time_pair(plain_fn, kernel_fn, dev, rounds=2):
    """Median ms of each, timed in turns plain, kernel, kernel, plain."""
    import statistics

    import torch

    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)

    plain, kernel = [], []
    for _ in range(rounds):
        plain.append(once(plain_fn))
        kernel.append(once(kernel_fn))
        kernel.append(once(kernel_fn))
        plain.append(once(plain_fn))
    return statistics.median(kernel), statistics.median(plain)


def check_kernels(run, dev):
    """Each kernel against its plain version on this run's affinities."""
    import torch

    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    ccfg = vote_params().consensus_config()
    dec = run["dec"]
    overlap = torch.as_tensor(run["numinst"] > 1, device=dev)
    hi, lo, _ = C._masks(dec, ccfg, overlap)
    a, b = dec * hi, (1.0 - dec) * lo
    half_k = K.consensus_half_cuda(a, b, hi, lo, ccfg)
    half_p = C.consensus_half_plain(dec, hi, lo, ccfg)
    torch.cuda.synchronize(dev)
    err_c = float((half_k - half_p).abs().max())
    ok_c = bool(torch.all((half_k - half_p).abs()
                          <= 1e-4 + 1e-4 * half_p.abs()))
    acc_k = K.rank_acc_cuda(hi, lo, half_k, ccfg)
    acc_p = C.rank_acc_plain(hi, lo, half_k, ccfg)
    torch.cuda.synchronize(dev)
    err_r = float((acc_k - acc_p).abs().max())
    ok_r = bool(torch.all((acc_k - acc_p).abs()
                          <= 1e-3 + 1e-4 * acc_p.abs()))
    # a second launch of each gives the same bits (sums in a fixed order)
    same_c = bool(torch.equal(half_k,
                              K.consensus_half_cuda(a, b, hi, lo, ccfg)))
    same_r = bool(torch.equal(acc_k, K.rank_acc_cuda(hi, lo, half_k, ccfg)))
    emit({"phase": "kernel_check", "consensus_max_abs_err": err_c,
          "consensus_ok": ok_c, "consensus_max_abs": float(
              half_p.abs().max()), "rank_max_abs_err": err_r,
          "rank_ok": ok_r, "rank_max_abs": float(acc_p.abs().max()),
          "consensus_two_launches_equal": same_c,
          "rank_two_launches_equal": same_r})
    if not (ok_c and ok_r):
        raise AssertionError("a CUDA kernel disagrees with its plain version")
    if not (same_c and same_r):
        raise AssertionError("two launches of a CUDA kernel differ")

    ms_c, plain_c = time_pair(
        lambda: C.consensus_half_plain(dec, hi, lo, ccfg),
        lambda: K.consensus_half_cuda(a, b, hi, lo, ccfg), dev)
    ms_r, plain_r = time_pair(
        lambda: C.rank_acc_plain(hi, lo, half_k, ccfg),
        lambda: K.rank_acc_cuda(hi, lo, half_k, ccfg), dev)

    # bounds from this run's inputs: bytes each input read once and each
    # output written once; operations over the pixel pairs the data needs
    # (eligible centers, both pixels hi or lo, not both lo)
    elig = ((hi != 0) | (lo != 0)).sum(0).double()
    n_lo = (lo != 0).sum(0).double()
    terms = float((elig * (elig - 1) / 2 - n_lo * (n_lo - 1) / 2).sum())
    f4 = 4 * hi.numel()
    bytes_c = 4 * f4 + half_k.numel() * half_k.element_size()
    bytes_r = 2 * f4 + half_k.numel() * half_k.element_size() \
        + 4 * acc_k.numel()

    emit({"phase": "kernel_bounds", "pair_terms": terms,
          "consensus_bytes": bytes_c, "rank_bytes": bytes_r})
    return [
        kernel_row(K.CONSENSUS, err_c, ms_c, plain_c,
                   bound_ms(bytes_c, CONS_OPS_PER_TERM * terms)),
        kernel_row(K.RANK, err_r, ms_r, plain_r,
                   bound_ms(bytes_r, RANK_OPS_PER_TERM * terms)),
    ]


def kernel_row(kernel, err, ms, plain_ms, bound, library_ms=None):
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces.split(" ")[0], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def bound_ms(nbytes, ops):
    """Least time for the work: bytes over the memory rate or operations
    over the f32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def run_probe(dev):
    """Phase probe: the twelve cases through the probe's entry point, then
    the largest case timed against its plain version and against the one
    PyTorch call that computes the same sums (a convolution along the row
    axis with the weights s + 1)."""
    import torch
    import torch.nn.functional as F

    from patchperpix_tpu_torch.ops import probe as PR

    PR.PROBE.launches = 0
    cases = PR.run_cases(dev)
    launches = PR.PROBE.launches
    emit({"phase": "probe", "launches": launches, "cases": cases})
    if not all(c["ok"] for c in cases) or launches != len(PR.CASES):
        raise AssertionError("the row-window probe failed")
    n_slab, W = 3, 768
    x = torch.rand((8, PR.V, W), device=dev)
    n_out, n_start = 8 - n_slab + 1, (n_slab - 1) * PR.V
    k = torch.arange(1, n_start + 1, dtype=torch.float32,
                     device=dev).reshape(1, 1, n_start, 1)

    def library():
        return F.conv2d(x.reshape(1, 1, 8 * PR.V, W), k)[
            0, 0, :n_out * PR.V].reshape(n_out, PR.V, W)

    want = PR.probe_window_plain(x, n_slab)
    err = float((PR.probe_window_cuda(x, n_slab, "smem") - want).abs().max())
    if not float((library() - want).abs().max()) < 1e-3:
        raise AssertionError("the probe's library yardstick disagrees")
    ms, plain = time_pair(lambda: PR.probe_window_plain(x, n_slab),
                          lambda: PR.probe_window_cuda(x, n_slab, "smem"),
                          dev)
    lib_ms, _ = time_pair(lambda: None, library, dev)
    nbytes = 4 * (x.numel() + want.numel())
    row = kernel_row(PR.PROBE, err, ms, plain,
                     bound_ms(nbytes, 2 * n_start * want.numel()), lib_ms)
    row["launches"] = launches
    return row


def gt_match_counts(inst, labels, thr=0.5):
    """For each ground-truth label, the number of predicted instances with
    IoU >= thr."""
    import numpy as np

    pairs, n = np.unique(np.stack([labels.ravel(), inst.ravel()], 1), axis=0,
                         return_counts=True)
    size_gt = dict(zip(*np.unique(labels, return_counts=True)))
    size_pr = dict(zip(*np.unique(inst, return_counts=True)))
    out = {int(g): 0 for g in size_gt if g > 0}
    for (g, q), c in zip(pairs, n):
        if g > 0 and q > 0 and c / (size_gt[g] + size_pr[q] - c) >= thr:
            out[int(g)] += 1
    return out


def compare_reference_2d(setting, inst, inter, ref, meta):
    """A 2D run against the stored JAX float32 run of the same inputs."""
    import numpy as np

    want = ref[f"{setting}_inst"]
    fg_agree = float(np.mean((inst > 0) == (want > 0)))
    agree, same = match_agreement(inst, want)
    stages = {}
    for key in ("ranked_centers", "cover_centers", "thin_centers", "pairs"):
        got, exp = np.asarray(inter[key]), ref[f"{setting}_{key}"]
        stages[f"{key}_equal"] = bool(got.shape == exp.shape
                                      and np.array_equal(got, exp))
    rs, exp = np.asarray(inter["ranked_scores"]), \
        ref[f"{setting}_ranked_scores"]
    stages["sorted_scores_max_abs_err"] = float(np.abs(rs - exp).max()) \
        if rs.shape == exp.shape else None
    if stages["pairs_equal"]:
        stages["weights_max_abs_err"] = float(np.abs(
            inter["weights"] - ref[f"{setting}_weights"]).max())
    stages["n_components"] = [int(inter["n_components"]),
                              int(ref[f"{setting}_n_components"])]
    res = {"phase": "path2d_vs_jax_f32", "setting": setting,
           "size": list(inst.shape[1:]), "fg_agreement": fg_agree,
           "n_instances": n_instances(inst),
           "ref_n_instances": meta[setting]["n_instances"],
           "matched_agreement": agree, "identical_up_to_relabel": same,
           "stages": stages}
    emit(res)
    if fg_agree < 0.999:
        raise AssertionError(f"2D ({setting}) foreground agreement "
                             f"{fg_agree} < 0.999")
    if res["n_instances"] != res["ref_n_instances"]:
        raise AssertionError(f"2D ({setting}) instance count differs from "
                             "the JAX run")
    if agree < 0.99:
        raise AssertionError(f"2D ({setting}) instance agreement {agree} "
                             "< 0.99")


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


def run_path2d(dev, kernels):
    """Phase path2d.  Returns the launch counts of the counted runs and
    the device affinities of the full image (for kernels2d)."""
    import numpy as np
    import torch

    ref, meta = np.load(REF2D_NPZ), json.load(open(REF2D_JSON))
    crop = tuple(meta["crop"])

    full = {s: path2d_inputs(s) for s in PATH2D}
    affs = torch.as_tensor(full["A"]["affs"], device=dev)  # same in (A), (B)
    warm = {}
    for s in PATH2D:
        t0 = time.perf_counter()
        assemble_2d(s, full[s], affs, dev)
        torch.cuda.synchronize(dev)
        warm[s] = time.perf_counter() - t0
    for k in kernels:
        k.launches = 0
    runs = {}
    for s in PATH2D:
        torch.cuda.reset_peak_memory_stats(dev)
        t, t0 = {}, time.perf_counter()
        inst, inter = assemble_2d(s, full[s], affs, dev, t)
        t["total"] = time.perf_counter() - t0
        runs[s] = (inst, inter)
        emit({"phase": "path2d", "setting": s, "size": list(IMG2D),
              "patch": list(PS2D[1:]), "warmup_s": warm[s], "steady_s": t,
              "fg_vox": int(full[s]["fg"].sum()),
              "n_candidates": len(inter["ranked_centers"]),
              "n_cover": len(inter["cover_centers"]),
              "n_thin": len(inter["thin_centers"]),
              "n_pairs": len(inter["pairs"]),
              "n_components": inter["n_components"],
              "n_instances": n_instances(inst),
              "gt_instances": int(full[s]["labels"].max()),
              "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    launches = {k.name: k.launches for k in kernels}

    counts = gt_match_counts(runs["A"][0], full["A"]["labels"])
    emit({"phase": "path2d_gt", "setting": "A", "matches_per_gt_worm": counts})
    if not all(c == 1 for c in counts.values()):
        raise AssertionError(f"2D (A): a ground-truth worm is not matched "
                             f"by exactly one instance: {counts}")
    for s in PATH2D:
        if crop == IMG2D:
            inst, inter = runs[s]
        else:
            inp = path2d_inputs(s, crop)
            inst, inter = assemble_2d(
                s, inp, torch.as_tensor(inp["affs"], device=dev), dev)
        compare_reference_2d(s, inst, inter, ref, meta)
    return launches, affs, full


def bounds_2d(ag, tgt, cfg, half):
    """What the data needs of the 2D kernels: operations over the eligible
    pair terms, as for the 3D kernels; bytes: the mid plane (the center
    gate), the stack's columns at eligible centers (the rest holds the
    sentinel), the target plane; K3 writes the whole half (zeros
    included), K4 reads only the half's live entries (both ends
    target-eligible) and writes one plane."""
    import torch

    from patchperpix_tpu_torch.ops import consensus as C

    hi, lo = C.derive_2d(ag, tgt, cfg)
    elig = ((hi != 0) | (lo != 0)).sum(0).double()
    n_lo = (lo != 0).sum(0).double()
    terms = float((elig * (elig - 1) / 2 - n_lo * (n_lo - 1) / 2).sum())
    del hi, lo
    p = int(cfg.ps[1])
    n_centers = int((ag[cfg.mid] >= 0).sum())
    win = C._target_windows_2d(tgt, 2 * p - 1)
    live = 0
    for dy in range(p):
        n = (win[dy + p - 1] * tgt).sum(dim=(1, 2))
        live += int(n[p:].sum() if dy == 0 else n.sum())
    in_bytes = 4 * (2 * tgt.numel() + cfg.P * n_centers)
    size = half.element_size()
    return {"pair_terms": terms, "eligible_centers": n_centers,
            "target_pixels": int((tgt != 0).sum()),
            "live_half_entries": live,
            "consensus2d_bytes": in_bytes + half.numel() * size,
            "rank2d_bytes": in_bytes + live * size + 4 * tgt.numel(),
            "dense_bytes": 4 * (ag.numel() + tgt.numel())
            + half.numel() * size}


def check_kernels_2d(affs, full, dev):
    """Phase kernels2d: the 2D kernels against their plain versions on
    path2d's inputs; errors and two launches under both settings and both
    storage types, times and bounds for (A) in f32; then the same checks and
    the kernels' times on dense2d."""
    import dataclasses

    import torch

    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    def close(got, want, atol, rtol):
        d = (got.float() - want.float()).abs()
        return float(d.max()), bool(torch.all(d <= atol + rtol
                                              * want.float().abs()))

    def check(name, cfg, ag, tgt):
        """Errors of both kernels and the two-launch test under one
        configuration; also the kernel's half, for the timing."""
        half_k = K.consensus_half_2d_cuda(ag, tgt, cfg)
        half_p = C.consensus_half_2d_plain(ag, tgt, cfg)
        err_c, ok_c = close(half_k, half_p, 1e-4,
                            2.0 ** -7 if cfg.cons_bf16 else 1e-4)
        max_c = float(half_p.float().abs().max())
        del half_p
        acc_k = K.rank_acc_2d_cuda(ag, tgt, half_k, cfg)
        acc_p = C.rank_acc_2d_plain(ag, tgt, half_k, cfg)
        torch.cuda.synchronize(dev)
        err_r, ok_r = close(acc_k, acc_p, 1e-3, 1e-4)
        # a second launch of each gives the same bits (sums in a fixed order)
        same_c = bool(torch.equal(half_k,
                                  K.consensus_half_2d_cuda(ag, tgt, cfg)))
        same_r = bool(torch.equal(acc_k,
                                  K.rank_acc_2d_cuda(ag, tgt, half_k, cfg)))
        return {"case": name, "half": "bf16" if cfg.cons_bf16 else "f32",
                "consensus2d_max_abs_err": err_c, "consensus2d_ok": ok_c,
                "consensus2d_max_abs": max_c,
                "consensus2d_two_launches_equal": same_c,
                "rank2d_max_abs_err": err_r, "rank2d_ok": ok_r,
                "rank2d_max_abs": float(acc_p.abs().max()),
                "rank2d_two_launches_equal": same_r}, half_k

    def gate(checks, what):
        if not all(c["consensus2d_ok"] and c["rank2d_ok"] for c in checks):
            raise AssertionError(f"a 2D CUDA kernel disagrees with its plain "
                                 f"version ({what})")
        if not all(c["consensus2d_two_launches_equal"]
                   and c["rank2d_two_launches_equal"] for c in checks):
            raise AssertionError(f"two launches of a 2D CUDA kernel differ "
                                 f"({what})")

    def kernel_ms(cfg, ag, tgt, half):
        ms_c, _ = time_pair(lambda: None,
                            lambda: K.consensus_half_2d_cuda(ag, tgt, cfg),
                            dev)
        ms_r, _ = time_pair(lambda: None,
                            lambda: K.rank_acc_2d_cuda(ag, tgt, half, cfg),
                            dev)
        return ms_c, ms_r

    def setting(s, bf16):
        cfg = dataclasses.replace(
            VoteInstancesParams(**PATH2D[s]).consensus_config(),
            cons_bf16=bf16)
        overlap = torch.as_tensor(full[s]["numinst"] > 1, device=dev)
        return (cfg,) + C.gated_stack_2d(affs, cfg, overlap)

    cfg, ag, tgt = setting("A", False)
    first, half = check("A", cfg, ag, tgt)
    checks = [first]
    for s, bf16 in (("A", True), ("B", False), ("B", True)):
        c, h = check(s, *setting(s, bf16))
        checks.append(c)
        del h
    err_c, err_r = first["consensus2d_max_abs_err"], \
        first["rank2d_max_abs_err"]
    emit({"phase": "kernels2d_check", "checks": checks})
    gate(checks, "path2d")

    ms_c, plain_c = time_pair(
        lambda: C.consensus_half_2d_plain(ag, tgt, cfg),
        lambda: K.consensus_half_2d_cuda(ag, tgt, cfg), dev)
    ms_r, plain_r = time_pair(
        lambda: C.rank_acc_2d_plain(ag, tgt, half, cfg),
        lambda: K.rank_acc_2d_cuda(ag, tgt, half, cfg), dev)
    cfg16 = dataclasses.replace(cfg, cons_bf16=True)
    half16 = K.consensus_half_2d_cuda(ag, tgt, cfg16)
    ms_c16, ms_r16 = kernel_ms(cfg16, ag, tgt, half16)
    del half16
    b = bounds_2d(ag, tgt, cfg, half)
    emit({"phase": "kernels2d_bounds", "setting": "A", **b,
          "consensus2d_bf16_ms": ms_c16, "rank2d_bf16_ms": ms_r16})
    rows = [
        kernel_row(K.CONSENSUS2D, err_c, ms_c, plain_c,
                   bound_ms(b["consensus2d_bytes"],
                            CONS_OPS_PER_TERM * b["pair_terms"])),
        kernel_row(K.RANK2D, err_r, ms_r, plain_r,
                   bound_ms(b["rank2d_bytes"],
                            RANK_OPS_PER_TERM * b["pair_terms"])),
    ]
    del ag, tgt, half

    # dense2d: setting (A)'s configuration on the 64-worm image
    affs_d = torch.as_tensor(dense2d_affs(), device=dev)
    res = {"phase": "kernels2d_dense", "size": list(IMG2D),
           "n_worms": 64, "checks": []}
    for bf16 in (False, True):
        c = dataclasses.replace(cfg, cons_bf16=bf16)
        ag, tgt = C.gated_stack_2d(affs_d, c)
        chk, half = check("dense2d", c, ag, tgt)
        res["checks"].append(chk)
        ms_c, ms_r = kernel_ms(c, ag, tgt, half)
        res[f"consensus2d_{chk['half']}_ms"] = ms_c
        res[f"rank2d_{chk['half']}_ms"] = ms_r
        if not bf16:
            b = bounds_2d(ag, tgt, c, half)
            res.update(b)
            res["consensus2d_bound_ms"], res["consensus2d_bound_by"] = \
                bound_ms(b["consensus2d_bytes"],
                         CONS_OPS_PER_TERM * b["pair_terms"])
            res["rank2d_bound_ms"], res["rank2d_bound_by"] = bound_ms(
                b["rank2d_bytes"], RANK_OPS_PER_TERM * b["pair_terms"])
        del ag, tgt, half
    emit(res)
    gate(res["checks"], "dense2d")
    return rows


def check_model2d(dev):
    """Phase model2d: the seeded BBBC010 model against the JAX outputs."""
    import numpy as np
    import torch

    from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                                   lift_2d,
                                                   predict_volume_device)
    from patchperpix_tpu_torch.models import PPPConfig
    from patchperpix_tpu_torch.weights import build_model, seeded_tree

    meta, ref = json.load(open(MODEL2D_JSON)), np.load(MODEL2D_NPZ)
    cfg = PPPConfig(**BBBC010_MODEL)
    model = build_model(cfg, seeded_tree(meta["leaves"], meta["seed"]),
                        device=dev)
    raw, pos = model2d_sample(meta["n_positions"])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    code, prob = predict_volume_device(model, raw, cfg, MODEL2D_WINDOW,
                                       MODEL2D_WINDOW, device=dev)
    torch.cuda.synchronize(dev)
    t_predict = time.perf_counter() - t0
    fg = np.zeros(MODEL2D_WINDOW, bool)
    fg.reshape(-1)[pos] = True
    t0 = time.perf_counter()
    dec = decode_volume_device(model, code, fg, cfg, device=dev)
    torch.cuda.synchronize(dev)
    t_decode = time.perf_counter() - t0
    dec4, fg3 = lift_2d(dec, fg)
    if tuple(dec4.shape) != (625, 1) + MODEL2D_WINDOW or fg3.shape != \
            (1,) + MODEL2D_WINDOW:
        raise AssertionError(f"model2d shapes {tuple(dec4.shape)}")
    pos_t = torch.as_tensor(pos, device=dev)
    got = {"code": code.reshape(cfg.code_units, -1)[:, pos_t].T,
           "prob": prob.reshape(3, -1)[:, pos_t].T,
           "patches": dec.reshape(625, -1)[:, pos_t].T.reshape(-1, 25, 25)}
    res = {"phase": "model2d", "n_parameters": meta["n_parameters"],
           "window": list(MODEL2D_WINDOW), "n_positions": len(pos),
           "predict_s": t_predict, "decode_s": t_decode}
    ok = True
    for key, val in got.items():
        val, want = val.cpu().numpy(), ref[key]
        d = np.abs(val - want)
        res[f"{key}_max_abs_err"] = float(d.max())
        ok &= bool(np.isfinite(val).all()
                   and np.all(d <= 1e-4 + 1e-4 * np.abs(want)))
    emit(res)
    if not ok:
        raise AssertionError("the 2D model disagrees with the JAX outputs")


def compare_reference(run):
    """Gates against the stored JAX float32 run, plus per-stage agreement."""
    import numpy as np

    ref = np.load(REF_NPZ)
    meta = json.load(open(REF_JSON))
    inter = run["inter"]
    fg_agree = float(np.mean(run["fg"] == ref["fg"]))
    agree, same = match_agreement(run["inst"], ref["inst"])
    stages = {
        "prob_max_abs_err": float(np.abs(run["prob"] - ref["prob"]).max()),
        "numinst_equal": bool(np.array_equal(run["numinst"],
                                             ref["numinst"])),
        "dec_center_max_abs_err": float(np.abs(
            run["dec"][171].cpu().numpy() - ref["dec_center"]).max()),
        "dec_sum_max_abs_err": float(np.abs(
            run["dec"].sum(0).cpu().numpy() - ref["dec_sum"]).max()),
    }
    for key in ("ranked_centers", "cover_centers", "thin_centers", "pairs"):
        got, want = np.asarray(inter[key]), ref[key]
        stages[f"{key}_equal"] = bool(got.shape == want.shape
                                      and np.array_equal(got, want))
    rs = np.asarray(inter["ranked_scores"])
    stages["ranked_scores_max_abs_err"] = float(
        np.abs(rs - ref["ranked_scores"]).max()) \
        if rs.shape == ref["ranked_scores"].shape else None
    if stages["pairs_equal"]:
        stages["weights_max_abs_err"] = float(
            np.abs(inter["weights"] - ref["weights"]).max())
    stages["n_components"] = [int(inter["n_components"]),
                              int(ref["n_components"])]
    res = {"phase": "vs_jax_f32", "fg_agreement": fg_agree,
           "n_instances": n_instances(run["inst"]),
           "ref_n_instances": meta["n_instances"],
           "matched_agreement": agree, "identical_up_to_relabel": same,
           "own_fg_vox": int((run["inst"] > 0).sum()),
           "ref_own_fg_vox": meta["own_fg_vox"], "stages": stages}
    emit(res)
    if fg_agree < 0.999:
        raise AssertionError(f"foreground agreement {fg_agree} < 0.999")
    if res["n_instances"] != meta["n_instances"]:
        raise AssertionError("instance count differs from the JAX run")
    if agree < 0.99:
        raise AssertionError(f"instance agreement {agree} < 0.99")
    return res


def tpu_figures():
    """The TPU bf16 bench figures recorded in BENCH_r05.json."""
    metric = json.load(open(BENCH_TPU))["parsed"]["metric"]
    m = re.search(r"(\d+) instances, (\d+) own-fg vox, avg_f1_cov ([\d.]+), "
                  r"AP@0.5 ([\d.]+)", metric)
    return {"n_instances": int(m.group(1)), "own_fg_vox": int(m.group(2)),
            "avg_f1_cov": float(m.group(3)), "AP_0.5": float(m.group(4)),
            "source": "BENCH_r05.json (JAX package, bf16, TPU v5e)"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (os.path.isdir(os.path.join(REPO, "patchperpix_tpu_torch"))
            and all(os.path.exists(f) for f in (REF_NPZ, REF2D_NPZ,
                                                MODEL2D_NPZ))):
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from patchperpix_tpu_torch.evaluate.instance_metrics import \
        average_precision
    from patchperpix_tpu_torch.ops import _build
    from patchperpix_tpu_torch.ops import consensus_kernels as K
    from patchperpix_tpu_torch.ops.consensus_kernels import KERNELS
    from patchperpix_tpu_torch.utils.io import ZarrV2Reader
    from patchperpix_tpu_torch.weights import build_model

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    info = _build.build([k.name for k in KERNELS])
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "nvcc_s": {n: v["seconds"] for n, v in info.items()},
          "ptxas": {n: [ln for ln in v["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
                    for n, v in info.items()}})

    io = ZarrV2Reader(FIXTURE)
    raw = np.clip(io.read("volumes/raw").astype(np.float32), 0,
                  1500.0) / 1500.0
    gt = io.read("volumes/gt_instances").astype(np.int32)

    # f32 main path: warm-up, then the counted run
    cfg = crop_config("float32")
    model = build_model(cfg, device=dev)
    warm = run_path(model, cfg, raw, dev)
    for k in KERNELS:
        k.launches = 0
    run = run_path(model, cfg, raw, dev)
    launches = {k.name: k.launches for k in (K.CONSENSUS, K.RANK)}
    emit({"phase": "f32_path", "launches": launches,
          "warmup_s": warm["times"], "steady_s": run["times"],
          "fg_vox": int(run["fg"].sum()),
          "n_candidates": len(run["inter"]["ranked_centers"]),
          "n_cover": len(run["inter"]["cover_centers"]),
          "n_thin": len(run["inter"]["thin_centers"]),
          "n_pairs": len(run["inter"]["pairs"]),
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    del warm
    if not all(n >= 1 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched: {launches}")

    kernels = check_kernels(run, dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    ref = compare_reference(run)
    ap32 = average_precision(run["inst"], gt, 0.5, keep_gt_shape=True)
    del run
    torch.cuda.empty_cache()

    cfg16 = crop_config("bfloat16")
    model16 = build_model(cfg16, device=dev)
    run_path(model16, cfg16, raw, dev)       # warm-up (bf16 conv setup)
    run16 = run_path(model16, cfg16, raw, dev)
    ap16 = average_precision(run16["inst"], gt, 0.5, keep_gt_shape=True)
    emit({"phase": "bf16_path", "n_instances": n_instances(run16["inst"]),
          "own_fg_vox": int((run16["inst"] > 0).sum()),
          "AP_0.5_iou_hungarian": ap16["AP"], "steady_s": run16["times"],
          "f32": {"n_instances": ref["n_instances"],
                  "own_fg_vox": ref["own_fg_vox"],
                  "AP_0.5_iou_hungarian": ap32["AP"]},
          "tpu_bf16": tpu_figures()})
    del run16, model16, model
    torch.cuda.empty_cache()

    kernels.append(run_probe(dev))
    launches2d, affs2d, full2d = run_path2d(dev, (K.CONSENSUS2D, K.RANK2D))
    if not all(n >= 1 for n in launches2d.values()):
        raise AssertionError(f"a 2D kernel was not launched: {launches2d}")
    rows2d = check_kernels_2d(affs2d, full2d, dev)
    for k in rows2d:
        k["launches"] = launches2d[k["name"]]
    kernels[2:2] = rows2d
    del affs2d, full2d
    torch.cuda.empty_cache()
    check_model2d(dev)

    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(smi, flush=True)
    emit({"kernels": [{key: k[key] for key in order} for k in kernels]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
