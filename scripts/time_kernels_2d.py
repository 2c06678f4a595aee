#!/usr/bin/env python3
"""Where the 2D consensus and rank wrappers spend their device time.

    python3 scripts/time_kernels_2d.py [--rounds N] [--root DIR]

Builds three 2D inputs on one NVIDIA GPU, the gated stack and target plane
of setting (A) (pt 0.5, 25x25 patches, ``parity/cases.py``) on the
16-worm 520x696 image (``A``) and on the 64-worm image (``dense2d``), and
that of the ISBI rehearsal's settings on the ideal affinities of
isbi_test_00 at 512^2 (``isbi``, 94 % foreground), and times
``consensus_half_2d_cuda`` and ``rank_acc_2d_cuda`` on them, with an f32
and a bf16 half:

- ``wrapper_ms``: CUDA events around the wrapper (scratch, every step),
  median and minimum of ``--rounds`` launches after one warm-up;
- ``device_ms``: each device kernel and memset of one launch by name, from
  a ``torch.profiler`` trace (median over the rounds), which splits the
  steps (count, index, pack pass, zero fill, kernel proper);
- ``scratch_mb``: the wrapper's peak device memory above its inputs and
  its output;
- ``rows``: K3's and K4's rows of the kernel table in PERF.md (f32 half):
  the largest error against the plain version, the kernel's ms and, on
  ``A`` and ``isbi``, the plain version's (``kernel_timing.time_pair``;
  one round on ``isbi``, where the plain consensus takes ~5 s), and the
  bound of what the input needs (``bounds_2d``).

``--root DIR`` times the package ``patchperpix_tpu_torch`` of another
checkout (an earlier commit unpacked with ``git archive``), whose wrappers
take the same arguments, so that two versions can be timed in one call.
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

# this checkout's inputs and timers, whatever package is timed
from parity import cases as cs  # noqa: E402
import kernel_timing as kt  # noqa: E402

# rounds of (plain, kernel, kernel, plain) for the rows, by input (none:
# the kernel alone)
PLAIN_ROUNDS = {"A": 2, "dense2d": 0, "isbi": 1}


def bounds_2d(ag, tgt, cfg, half):
    """What the data needs of the 2D kernels: operations over the eligible
    pair terms, as for the 3D kernels; bytes: the mid plane (the center
    gate), the stack's columns at eligible centers (the rest holds the
    sentinel), the target plane; K3 writes the whole half (zeros
    included), K4 reads only the half's live entries (both ends
    target-eligible) and writes one plane."""
    from patchperpix_tpu_torch.ops import consensus as C

    hi, lo = C.derive_2d(ag, tgt, cfg)
    terms = kt.pair_terms(hi, lo)
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
            "rank2d_bytes": in_bytes + live * size + 4 * tgt.numel()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--root", default=REPO,
                    help="checkout whose patchperpix_tpu_torch is timed")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("time_kernels_2d: no CUDA device", file=sys.stderr)
        return 2
    from patchperpix_tpu_torch.assembly import VoteInstancesParams
    from patchperpix_tpu_torch.ops import _build
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    built = _build.build([K.CONSENSUS2D.name, K.RANK2D.name])

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi, flush=True)
    cfg_a = VoteInstancesParams(**cs.PATH2D["A"]).consensus_config()
    cfg_isbi = VoteInstancesParams.from_config(
        cs.isbi_vote_kwargs()).consensus_config()
    res = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "root": os.path.relpath(root, REPO), "rounds": args.rounds,
           "size": list(cs.IMG2D), "patch": list(cs.PS2D[1:]),
           "ptxas": {n: [ln.strip() for ln in v["log"].splitlines()
                         if "registers" in ln or "spill" in ln]
                     for n, v in built.items()}, "rows": {}}
    for case, ccfg, make in (
            ("A", cfg_a, lambda: cs.path2d_inputs("A")["affs"]),
            ("dense2d", cfg_a, cs.dense2d_affs),
            ("isbi", cfg_isbi, lambda: cs.isbi_ideal(cs.ISBI_TEST[0])[0])):
        affs = torch.as_tensor(make(), device=dev)
        ag, tgt = C.gated_stack_2d(affs, ccfg)
        del affs
        res[case] = {"eligible_centers": int((ag[ccfg.mid] >= 0).sum()),
                     "target_pixels": int((tgt != 0).sum())}
        for name, bf16 in (("f32", False), ("bf16", True)):
            c = dataclasses.replace(ccfg, cons_bf16=bf16)
            half = K.consensus_half_2d_cuda(ag, tgt, c)

            def cons():
                return K.consensus_half_2d_cuda(ag, tgt, c)

            def rank():
                return K.rank_acc_2d_cuda(ag, tgt, half, c)

            out = {}
            for kname, fn, size in (("consensus", cons, half.nbytes),
                                    ("rank", rank, 4 * tgt.numel())):
                torch.cuda.synchronize(dev)
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                fn()
                torch.cuda.synchronize(dev)
                scratch = torch.cuda.max_memory_allocated(dev) - base - size
                out[kname] = {
                    "wrapper_ms": kt.event_ms(fn, dev, args.rounds),
                    "device_ms": kt.device_ms(fn, dev, args.rounds),
                    "scratch_mb": scratch / 1e6}
            res[case][name] = out
            if not bf16:
                res["rows"][case] = rows_2d(ag, tgt, c, half, dev,
                                            PLAIN_ROUNDS[case])
            del half
        del ag, tgt
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


def rows_2d(ag, tgt, cfg, half, dev, rounds):
    """K3's and K4's rows on one input: errors against the plain versions,
    ms (beside the plain versions' where ``rounds``), bounds."""
    from patchperpix_tpu_torch.ops import consensus as C
    from patchperpix_tpu_torch.ops import consensus_kernels as K

    err_c = float((half - C.consensus_half_2d_plain(ag, tgt, cfg))
                  .abs().max())
    acc = K.rank_acc_2d_cuda(ag, tgt, half, cfg)
    err_r = float((acc - C.rank_acc_2d_plain(ag, tgt, half, cfg))
                  .abs().max())
    del acc
    times = []
    for plain, kern in (
            (lambda: C.consensus_half_2d_plain(ag, tgt, cfg),
             lambda: K.consensus_half_2d_cuda(ag, tgt, cfg)),
            (lambda: C.rank_acc_2d_plain(ag, tgt, half, cfg),
             lambda: K.rank_acc_2d_cuda(ag, tgt, half, cfg))):
        times.append(kt.time_pair(plain, kern, dev, rounds) if rounds else
                     (kt.time_pair(lambda: None, kern, dev)[0], None))
    b = bounds_2d(ag, tgt, cfg, half)
    return {"bounds": b, "kernels": [
        kt.kernel_row(K.CONSENSUS2D, err_c, *times[0], kt.bound_ms(
            b["consensus2d_bytes"], kt.CONS_OPS_PER_TERM * b["pair_terms"])),
        kt.kernel_row(K.RANK2D, err_r, *times[1], kt.bound_ms(
            b["rank2d_bytes"], kt.RANK_OPS_PER_TERM * b["pair_terms"]))]}


if __name__ == "__main__":
    sys.exit(main())
