"""Closed-form FLOP / memory-byte accounting for the assembly kernels and
the U-Net, against the card's published peaks.

Counterpart of ``patchperpix_tpu/utils/roofline.py``: the cost model comes
over with the same numbers (``KernelCost``, ``consensus_cost``,
``rank_cost``, ``graph_cost``, ``unet_cost``, ``analyze``,
``assembly_mfu_summary``); the peaks are this card's.  Per-kernel
algorithmic FLOPs and minimum memory traffic are closed-form in (volume
shape, patchshape, pair count), so achieved GFLOP/s and GB/s and the share
of the card's peak can be printed next to every wall time.

Cost conventions (the JAX package's, after its kernel formulations):

- consensus: every ordered channel pair (q, r > q) is one fused
  compare / product / select / accumulate over all V voxels (~6 flops per
  pair-voxel).  Minimum traffic = read the (P, V) affinity stack once +
  write the (N, V) consensus (N = prod(2 * ps - 1)).
- rank: the same pair structure reading the consensus (~4 flops per
  pair-voxel); traffic = affinities + consensus read + (V,) write.
- patch graph: per selected pair, P * P cross-patch terms (~3 flops
  each, matmul-shaped); traffic = the per-pair consensus windows.

These are algorithmic minima: they leave out padding, halos and
recomputation, so a share of peak is a lower bound on the hardware's
utilisation.

Units.  The JAX package charges each cost to a TPU unit: ``"mxu"`` (the
matrix unit, bf16 peak) or ``"vpu"`` (the vector unit, f32).  Here they are
this card's ``"tensor"`` (tensor cores, dense bf16 peak) and ``"fp32"``
(f32 on the CUDA cores), and ``analyze``'s key ``pct_of_<unit>_peak`` is
named after them; the values are the JAX package's for equal peaks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ChipPeaks:
    name: str
    tensor_bf16_tflops: float    # dense bf16 on the tensor cores
    fp32_tflops: float           # float32 on the CUDA cores
    hbm_gbps: float              # memory bandwidth, GB/s
    tensor_tf32_tflops: float | None = None   # dense TF32 (tensor cores)


# NVIDIA H100 SXM5 80 GB (torch.cuda.get_device_name: "NVIDIA H100 80GB
# HBM3"), NVIDIA H100 Tensor Core GPU datasheet: HBM3 3.35 TB/s, FP32 67
# TFLOP/s, BF16 tensor 989 TFLOP/s dense (1,979 with sparsity), TF32
# tensor 494.7 TFLOP/s dense (989 with sparsity).
H100_SXM5 = ChipPeaks("NVIDIA H100 SXM5 (datasheet)", 989.0, 67.0, 3350.0,
                      494.7)
# the JAX package's host estimate, for tests on the CPU (not a measured or
# published figure)
CPU_ESTIMATE = ChipPeaks("host CPU (1 core est.)", 0.1, 0.05, 20.0)

# torch.cuda.get_device_name -> peaks; a card not named here has no figures
_CARDS = {"NVIDIA H100 80GB HBM3": H100_SXM5}


def peaks_for_name(name: str) -> ChipPeaks:
    """The published peaks of the card ``torch.cuda.get_device_name``
    calls ``name``; raises KeyError for a card without figures (there is
    no default)."""
    if name not in _CARDS:
        raise KeyError(f"no published peaks for {name!r}; known cards: "
                       f"{sorted(_CARDS)}")
    return _CARDS[name]


def chip_peaks(device="cuda") -> ChipPeaks:
    """Peaks of ``device``: the card's published figures for a CUDA
    device (by ``torch.cuda.get_device_name``; raises for a card without
    figures), the JAX package's estimate for the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cpu":
        return CPU_ESTIMATE
    if dev.type != "cuda":
        raise KeyError(f"no peaks for device type {dev.type!r}")
    return peaks_for_name(torch.cuda.get_device_name(dev))


@dataclass(frozen=True)
class KernelCost:
    flops: float       # algorithmic floating-point ops
    hbm_bytes: float   # minimum memory traffic
    unit: str          # which peak applies: "fp32" | "tensor"


def _neigh_size(ps) -> int:
    ps = np.asarray(ps, dtype=np.int64)
    return int(np.prod(np.where(ps > 1, 2 * ps - 1, 1)))


def consensus_cost(vol_shape, ps, cons_bf16: bool = False) -> KernelCost:
    V = float(np.prod(vol_shape))
    P = float(np.prod(ps))
    pairs = P * (P + 1) / 2
    cons_b = 2 if cons_bf16 else 4
    return KernelCost(V * pairs * 6.0,
                      V * P * 4.0 + V * _neigh_size(ps) * cons_b, "fp32")


def rank_cost(vol_shape, ps, cons_bf16: bool = False) -> KernelCost:
    V = float(np.prod(vol_shape))
    P = float(np.prod(ps))
    pairs = P * (P + 1) / 2
    cons_b = 2 if cons_bf16 else 4
    return KernelCost(V * pairs * 4.0,
                      V * P * 4.0 + V * _neigh_size(ps) * cons_b + V * 4.0,
                      "fp32")


def graph_cost(n_pairs, ps, cons_bf16: bool = False) -> KernelCost:
    P = float(np.prod(ps))
    cons_b = 2 if cons_bf16 else 4
    # per pair: one (P,) window of each patch + one (neigh,) consensus
    # window around the center offset
    return KernelCost(float(n_pairs) * P * P * 3.0,
                      float(n_pairs) * (2 * P * 4.0
                                        + _neigh_size(ps) * cons_b),
                      "tensor")


def unet_cost(vol_shape, num_fmaps, fmap_inc, levels, in_ch,
              kernel_size: int = 3, reps: int = 2,
              ndim: int = 3) -> KernelCost:
    """Convolution FLOPs of the two-head U-Net forward (tensor-core work;
    memory = the feature maps once per convolution, in bf16)."""
    V = float(np.prod(vol_shape))
    k = float(kernel_size ** ndim)
    flops = hbm = 0.0
    cin = float(in_ch)
    v = V
    f = float(num_fmaps)
    for lvl in range(levels):
        for _ in range(reps):
            flops += 2.0 * v * cin * f * k
            hbm += v * (cin + f) * 2.0
            cin = f
        if lvl < levels - 1:
            v /= 2.0 ** ndim
            f *= float(fmap_inc)
    # the decoder about mirrors the encoder
    return KernelCost(flops * 2.0, hbm * 2.0, "tensor")


def analyze(cost: KernelCost, wall_s: float,
            peaks: ChipPeaks | None = None) -> dict:
    """Achieved rates, the share of the unit's peak and of the memory
    peak, and which ceiling the algorithm meets first at its intensity.
    ``peaks`` defaults to ``chip_peaks()`` (the card)."""
    peaks = peaks or chip_peaks()
    peak_tflops = (peaks.tensor_bf16_tflops if cost.unit == "tensor"
                   else peaks.fp32_tflops)
    gflops = cost.flops / wall_s / 1e9
    gbps = cost.hbm_bytes / wall_s / 1e9
    frac_compute = gflops / (peak_tflops * 1e3)
    frac_hbm = gbps / peaks.hbm_gbps
    balance = peak_tflops * 1e3 / peaks.hbm_gbps  # flop/byte
    intensity = cost.flops / max(cost.hbm_bytes, 1.0)
    return {
        "wall_s": wall_s,
        "gflops_per_s": round(gflops, 2),
        "gbytes_per_s": round(gbps, 2),
        "pct_of_%s_peak" % cost.unit: round(100 * frac_compute, 2),
        "pct_of_hbm_peak": round(100 * frac_hbm, 2),
        "arithmetic_intensity": round(intensity, 2),
        "bound": ("compute" if intensity > balance else "memory"),
        "chip": peaks.name,
    }


def assembly_mfu_summary(vol_shape, ps, n_pairs, stage_seconds: dict,
                         cons_bf16: bool = False,
                         peaks: ChipPeaks | None = None) -> dict:
    """Per-stage roofline of a measured assembly stage breakdown.

    ``stage_seconds`` keys: "consensus", "rank" (or one fused
    "consensus+rank"), "graph"."""
    peaks = peaks or chip_peaks()
    out = {}
    if "consensus+rank" in stage_seconds:
        c = consensus_cost(vol_shape, ps, cons_bf16)
        r = rank_cost(vol_shape, ps, cons_bf16)
        fused = KernelCost(c.flops + r.flops, c.hbm_bytes + r.hbm_bytes,
                           "fp32")
        out["consensus+rank"] = analyze(
            fused, stage_seconds["consensus+rank"], peaks)
    else:
        if "consensus" in stage_seconds:
            out["consensus"] = analyze(
                consensus_cost(vol_shape, ps, cons_bf16),
                stage_seconds["consensus"], peaks)
        if "rank" in stage_seconds:
            out["rank"] = analyze(rank_cost(vol_shape, ps, cons_bf16),
                                  stage_seconds["rank"], peaks)
    if "graph" in stage_seconds and n_pairs:
        out["graph"] = analyze(graph_cost(n_pairs, ps, cons_bf16),
                               stage_seconds["graph"], peaks)
    return out
