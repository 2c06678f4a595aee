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
2. build: nvcc of csrc/consensus.cu and csrc/rank.cu, in parallel;
3. f32 main path (TF32 off): a warm-up run, then the counted run with
   per-stage times; each CUDA kernel is held against its plain PyTorch
   version on this run's decoded affinities (consensus atol = rtol =
   1e-4, rank atol 1e-3 / rtol 1e-4: the JAX package's own kernel
   tolerances) and timed against it (plain, kernel, kernel, plain; CUDA
   events; medians);
4. held against the JAX package's float32 CPU run stored in
   parity/torch_port_ref_f32.npz: foreground agreement >= 99.9 %, equal
   instance count, >= 99 % of foreground voxels agreeing after best-IoU
   matching; per-stage agreement is printed to find where two runs part;
5. bf16 main path (the configuration's own dtype; warm-up, then a timed
   run): instance count, own-fg voxels and AP@0.5 (IoU, Hungarian) beside
   the TPU's figures in BENCH_r05.json (information only: bf16 rounds
   differently there);
6. the kernels line, then the contract's last line.

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
WIN = (52, 52, 52)
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
CONS_OPS_PER_TERM = 15   # pp, sc, cnt: 4 ops each + 3 accumulations
RANK_OPS_PER_TERM = 7    # w_hh, w_hl (3), difference, product, sum


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    emit({"phase": "kernel_check", "consensus_max_abs_err": err_c,
          "consensus_ok": ok_c, "consensus_max_abs": float(
              half_p.abs().max()), "rank_max_abs_err": err_r,
          "rank_ok": ok_r, "rank_max_abs": float(acc_p.abs().max())})
    if not (ok_c and ok_r):
        raise AssertionError("a CUDA kernel disagrees with its plain version")

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

    def bound(nbytes, ops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        return max(tb, to), ("bytes" if tb >= to else "operations")

    b_c, by_c = bound(bytes_c, CONS_OPS_PER_TERM * terms)
    b_r, by_r = bound(bytes_r, RANK_OPS_PER_TERM * terms)
    emit({"phase": "kernel_bounds", "pair_terms": terms,
          "consensus_bytes": bytes_c, "rank_bytes": bytes_r})
    return [
        {"name": "consensus", "route": "cuda", "source": K.CONSENSUS.source,
         "replaces": K.CONSENSUS.replaces.split(" ")[0],
         "max_abs_err": err_c, "ms": ms_c, "plain_ms": plain_c,
         "bound_ms": b_c, "bound_by": by_c, "library_ms": None},
        {"name": "rank", "route": "cuda", "source": K.RANK.source,
         "replaces": K.RANK.replaces.split(" ")[0],
         "max_abs_err": err_r, "ms": ms_r, "plain_ms": plain_r,
         "bound_ms": b_r, "bound_by": by_r, "library_ms": None},
    ]


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
            and os.path.exists(REF_NPZ)):
        print("chip_smoke: the repository is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np

    from patchperpix_tpu_torch.evaluate.instance_metrics import \
        average_precision
    from patchperpix_tpu_torch.ops import _build
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
    launches = {k.name: k.launches for k in KERNELS}
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
