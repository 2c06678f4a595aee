#!/usr/bin/env python3
"""Where the 3D consensus and rank wrappers spend their device time.

    python3 scripts/time_kernels_3d.py [--rounds N]

Runs the f32 main path (``parity/cases.py``: the trained crop model on the
50^3 FlyLight fixture) once on one NVIDIA GPU to get the path's decoded
affinities and masks, then times ``consensus_half_cuda`` and
``rank_acc_cuda`` on them, with an f32 and a bf16 half:

- ``wrapper_ms``: CUDA events around the wrapper (scratch allocation, the
  pack pass and the kernel), median and minimum of ``--rounds`` launches
  after one warm-up;
- ``device_ms``: each device kernel and memset of one launch by name, from
  a ``torch.profiler`` trace (median over the rounds), which splits the
  pack pass from the kernel proper;
- ``rows``: K1's and K2's rows of the kernel table in PERF.md (f32 half):
  the largest error against the plain version, the kernel's and the plain
  version's ms (CUDA events, medians of plain, kernel, kernel, plain) and
  the bound (``kernel_timing.bound_ms``) of the bytes and pair terms
  this input needs.

Prints the card's name and power limit, then one JSON line.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import kernel_timing as kt  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("time_kernels_3d: no CUDA device", file=sys.stderr)
        return 2
    from parity import cases as cs
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K
    from patchperpix_tpu_torch.weights import build_model

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg = cs.crop_config("float32")
    run = cs.run_path(build_model(cfg, device=dev), cfg, cs.crop_raw(), dev)
    ccfg = cs.vote_params().consensus_config()
    dec = run["dec"]
    hi, lo, _ = C._masks(dec, ccfg,
                         torch.as_tensor(run["numinst"] > 1, device=dev))
    a, b = dec * hi, (1.0 - dec) * lo
    del run

    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "rounds": args.rounds, "volume": list(hi.shape[1:]),
           "eligible_centers": int(((hi != 0) | (lo != 0)).any(0).sum())}

    # the table's rows: bytes each input read once and each output written
    # once; operations over the pair terms this input needs
    half = K.consensus_half_cuda(a, b, hi, lo, ccfg)
    acc = K.rank_acc_cuda(hi, lo, half, ccfg)
    err_c = float((half - C.consensus_half_plain(dec, hi, lo, ccfg))
                  .abs().max())
    err_r = float((acc - C.rank_acc_plain(hi, lo, half, ccfg)).abs().max())
    ms_c, plain_c = kt.time_pair(
        lambda: C.consensus_half_plain(dec, hi, lo, ccfg),
        lambda: K.consensus_half_cuda(a, b, hi, lo, ccfg), dev)
    ms_r, plain_r = kt.time_pair(
        lambda: C.rank_acc_plain(hi, lo, half, ccfg),
        lambda: K.rank_acc_cuda(hi, lo, half, ccfg), dev)
    terms = kt.pair_terms(hi, lo)
    f4 = 4 * hi.numel()
    out_c = half.numel() * half.element_size()
    res["pair_terms"] = terms
    res["rows"] = [
        kt.kernel_row(K.CONSENSUS, err_c, ms_c, plain_c, kt.bound_ms(
            4 * f4 + out_c, kt.CONS_OPS_PER_TERM * terms)),
        kt.kernel_row(K.RANK, err_r, ms_r, plain_r, kt.bound_ms(
            2 * f4 + out_c + 4 * acc.numel(), kt.RANK_OPS_PER_TERM * terms))]
    del half, acc
    for name, bf16 in (("f32", False), ("bf16", True)):
        c = dataclasses.replace(ccfg, cons_bf16=bf16)
        half = K.consensus_half_cuda(a, b, hi, lo, c)

        def cons():
            return K.consensus_half_cuda(a, b, hi, lo, c)

        def rank():
            return K.rank_acc_cuda(hi, lo, half, c)

        res[name] = {
            name: {"wrapper_ms": kt.event_ms(fn, dev, args.rounds),
                   "device_ms": kt.device_ms(fn, dev, args.rounds)}
            for name, fn in (("consensus", cons), ("rank", rank))}
        del half
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
