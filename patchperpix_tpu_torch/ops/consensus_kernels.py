"""The hand-written CUDA kernels of the consensus and rank stages.

Counterpart of ``patchperpix_tpu/ops/pallas_consensus.py`` and
``patchperpix_tpu/ops/pallas_consensus_2d.py``:

- ``CONSENSUS`` (``csrc/consensus.cu``) replaces the Pallas kernel
  ``_kernel_v5`` of ``consensus_array_pallas``: the canonical half of the
  consensus array;
- ``RANK`` (``csrc/rank.cu``) replaces ``_rank_kernel_v5`` of
  ``rank_scores_pallas``: the rank sum over that half;
- ``CONSENSUS2D`` (``csrc/consensus2d.cu``) replaces ``_cons2d_kernel`` of
  ``consensus_fold_pallas_2d``: the 2D canonical half (p, 2p-1, H, W) from
  one sentinel-gated stack and a target plane;
- ``RANK2D`` (``csrc/rank2d.cu``) replaces ``_rank2d_kernel``: the 2D rank
  sum over that half.

``KERNELS`` also lists ``ops/probe.py``'s ``PROBE`` (``csrc/
probe_window.cu``), so that one build and one table cover every kernel.

On the TPU the JAX package runs the 3D pair inside
``consensus_and_rank_pallas_fold2x``, which only packs two z-slabs into
the 128 TPU lanes and returns what the unfolded kernels return, so the
port calls the kernels unfolded.  The 2D pair's TPU fold layout (8-row
slabs, pre-padded margins) is not carried over either: the 2D kernels
read and write the standard layout.

Each wrapper allocates its output, checks device, dtype, shape and
contiguity, launches on PyTorch's current stream and raises if the launch
fails.  ``consensus_operands`` / ``consensus_half`` / ``rank_scores`` pick
the 2D kernels where ``is_2d`` holds (flat-z volume, square odd patch) and
the 3D kernels otherwise; they take the plain PyTorch version
(``ops/consensus.py``) only for tensors on the CPU; any other device
raises.  Each kernel counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from .consensus import (ConsensusConfig, _masks, consensus_half_2d_plain,
                        consensus_half_plain, gated_stack_2d, is_2d,
                        rank_acc_2d_plain, rank_acc_plain, rank_epilogue,
                        rank_epilogue_2d)
from .probe import PROBE

_P = ctypes.c_void_p
_I = ctypes.c_int
_WEIGHT_MODES = {"norm_prob_product": 0, "prob_product": 1, "count": 2}


CONSENSUS = CudaKernel(
    "consensus", "ppp_consensus_half",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
     _I, _P],
    "patchperpix_tpu/ops/pallas_consensus.py:209 _kernel_v5 "
    "(consensus_array_pallas :311, pallas_call :395)")
RANK = CudaKernel(
    "rank", "ppp_rank_half",
    [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "patchperpix_tpu/ops/pallas_consensus.py:514 _rank_kernel_v5 "
    "(rank_scores_pallas :598, pallas_call :656)")
CONSENSUS2D = CudaKernel(
    "consensus2d", "ppp_consensus2d_half",
    [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I,
     _P],
    "patchperpix_tpu/ops/pallas_consensus_2d.py:261 _cons2d_kernel "
    "(consensus_fold_pallas_2d :387, pallas_call :445)")
RANK2D = CudaKernel(
    "rank2d", "ppp_rank2d_half",
    [_P, _P, _P, _I, _P, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I,
     _P],
    "patchperpix_tpu/ops/pallas_consensus_2d.py:531 _rank2d_kernel "
    "(_rank2d_call :664, pallas_call :709)")
KERNELS = (CONSENSUS, RANK, CONSENSUS2D, RANK2D, PROBE)


def _check(name: str, t: torch.Tensor, shape, dtype, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != \
            tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on "
            f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _half_shape(cfg: ConsensusConfig, vol) -> tuple:
    return (int(cfg.ps[0]), int(cfg.neigh[1]), int(cfg.neigh[2])) + \
        tuple(int(s) for s in vol)


def _stream(device) -> _P:
    return _P(torch.cuda.current_stream(device).cuda_stream)


def consensus_half_cuda(a, b, hi, lo, cfg: ConsensusConfig) -> torch.Tensor:
    """Launch ``csrc/consensus.cu`` on the centre-aligned stacks
    a = affs*hi, b = (1-affs)*lo, hi, lo (each (P, Z, Y, X) float32)."""
    dev = hi.device
    if dev.type != "cuda":
        raise ValueError(f"consensus kernel: tensors on {dev}, not CUDA")
    if len(cfg.ps) != 3:
        raise ValueError("consensus kernel: 3D patchshapes only")
    vol = tuple(hi.shape[1:])
    for n, t in (("a", a), ("b", b), ("hi", hi), ("lo", lo)):
        _check(f"consensus kernel {n}", t, (cfg.P,) + vol, torch.float32,
               dev)
    out_dtype = torch.bfloat16 if cfg.cons_bf16 else torch.float32
    out = torch.empty(_half_shape(cfg, vol), dtype=out_dtype, device=dev)
    psz, psy, psx = (int(p) for p in cfg.ps)
    CONSENSUS.launch(
        a.data_ptr(), b.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        out.data_ptr(), int(cfg.cons_bf16), *vol, psz, psy, psx,
        _WEIGHT_MODES[cfg.weight_mode], float(cfg.patch_threshold),
        int(cfg.norm_aff), _stream(dev))
    return out


def rank_acc_cuda(hi, lo, cons_half, cfg: ConsensusConfig) -> torch.Tensor:
    """Launch ``csrc/rank.cu``: the unnormalized rank sum (Z, Y, X)."""
    dev = hi.device
    if dev.type != "cuda":
        raise ValueError(f"rank kernel: tensors on {dev}, not CUDA")
    if len(cfg.ps) != 3:
        raise ValueError("rank kernel: 3D patchshapes only")
    vol = tuple(hi.shape[1:])
    for n, t in (("hi", hi), ("lo", lo)):
        _check(f"rank kernel {n}", t, (cfg.P,) + vol, torch.float32, dev)
    s_dtype = torch.bfloat16 if cons_half.dtype == torch.bfloat16 \
        else torch.float32
    _check("rank kernel consensus half", cons_half, _half_shape(cfg, vol),
           s_dtype, dev)
    acc = torch.empty(vol, dtype=torch.float32, device=dev)
    psz, psy, psx = (int(p) for p in cfg.ps)
    RANK.launch(hi.data_ptr(), lo.data_ptr(), cons_half.data_ptr(),
                int(s_dtype == torch.bfloat16), acc.data_ptr(), *vol,
                psz, psy, psx, int(cfg.rank_int_counter), _stream(dev))
    return acc


def _check_2d_operands(name: str, ag, tgt, cfg: ConsensusConfig):
    dev = ag.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}, not CUDA")
    if not is_2d(cfg):
        raise ValueError(f"{name}: square odd 2D patchshapes (1, p, p) "
                         f"only, got {tuple(cfg.ps)}")
    if ag.ndim != 3:
        raise ValueError(f"{name}: expected a (P, H, W) gated stack, got "
                         f"{tuple(ag.shape)}")
    H, W = (int(s) for s in ag.shape[1:])
    _check(f"{name} gated stack", ag, (cfg.P, H, W), torch.float32, dev)
    _check(f"{name} target plane", tgt, (H, W), torch.float32, dev)
    return dev, H, W


def consensus_half_2d_cuda(ag, tgt, cfg: ConsensusConfig) -> torch.Tensor:
    """Launch ``csrc/consensus2d.cu`` on the gated stack ag (P, H, W) and
    the target plane tgt (H, W) of ``gated_stack_2d``: the 2D canonical
    half (p, 2p-1, H, W), float32 or bf16."""
    dev, H, W = _check_2d_operands("consensus2d kernel", ag, tgt, cfg)
    p = int(cfg.ps[1])
    out = torch.empty((p, 2 * p - 1, H, W), device=dev,
                      dtype=torch.bfloat16 if cfg.cons_bf16
                      else torch.float32)
    CONSENSUS2D.launch(
        ag.data_ptr(), tgt.data_ptr(), out.data_ptr(), int(cfg.cons_bf16),
        H, W, p, _WEIGHT_MODES[cfg.weight_mode], float(cfg.patch_threshold),
        float(cfg.bg_th), int(cfg.norm_aff), _stream(dev))
    return out


def rank_acc_2d_cuda(ag, tgt, cons_half, cfg: ConsensusConfig
                     ) -> torch.Tensor:
    """Launch ``csrc/rank2d.cu``: the unnormalized 2D rank sum (H, W)."""
    dev, H, W = _check_2d_operands("rank2d kernel", ag, tgt, cfg)
    p = int(cfg.ps[1])
    s_dtype = torch.bfloat16 if cons_half.dtype == torch.bfloat16 \
        else torch.float32
    _check("rank2d kernel consensus half", cons_half, (p, 2 * p - 1, H, W),
           s_dtype, dev)
    acc = torch.empty((H, W), dtype=torch.float32, device=dev)
    RANK2D.launch(ag.data_ptr(), tgt.data_ptr(), cons_half.data_ptr(),
                  int(s_dtype == torch.bfloat16), acc.data_ptr(), H, W, p,
                  float(cfg.patch_threshold), float(cfg.bg_th),
                  int(cfg.rank_int_counter), _stream(dev))
    return acc


def _route(t: torch.Tensor, what: str) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel for device {t.device}")


def consensus_operands(affs, cfg: ConsensusConfig, overlap=None,
                       center_valid=None) -> tuple:
    """What ``consensus_half`` and ``rank_scores`` read beside the
    affinities: in 2D (``is_2d``) the gated stack and the target plane
    (ag, tgt) of ``gated_stack_2d``, else the (hi, lo, tgt) stacks of
    ``_masks``."""
    if is_2d(cfg, affs.shape[1:]):
        return gated_stack_2d(affs, cfg, overlap, center_valid)
    if center_valid is not None:
        raise NotImplementedError("center_valid is ported for 2D only")
    return _masks(affs, cfg, overlap)


def consensus_half(affs, operands, cfg: ConsensusConfig) -> torch.Tensor:
    """Canonical-half consensus from ``consensus_operands``' result: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.  2D
    gives (p, 2p-1, H, W), 3D (psz, ndy, ndx, Z, Y, X)."""
    cuda = _route(affs, "consensus")
    if is_2d(cfg, affs.shape[1:]):
        ag, tgt = operands
        return consensus_half_2d_cuda(ag, tgt, cfg) if cuda \
            else consensus_half_2d_plain(ag, tgt, cfg)
    hi, lo, _ = operands
    if cuda:
        return consensus_half_cuda(affs * hi, (1.0 - affs) * lo, hi, lo, cfg)
    return consensus_half_plain(affs, hi, lo, cfg)


def rank_scores(affs, cons_half, operands,
                cfg: ConsensusConfig) -> torch.Tensor:
    """Per-voxel patch score (*vol), -1 sentinel off eligible centers: the
    CUDA rank kernel for CUDA tensors, the plain version for CPU tensors,
    then the epilogue in PyTorch."""
    cuda = _route(affs, "rank")
    if is_2d(cfg, affs.shape[1:]):
        ag, tgt = operands
        acc = rank_acc_2d_cuda(ag, tgt, cons_half, cfg) if cuda \
            else rank_acc_2d_plain(ag, tgt, cons_half, cfg)
        return rank_epilogue_2d(acc, ag, tgt, cfg)
    hi, lo, tgt = operands
    acc = rank_acc_cuda(hi, lo, cons_half, cfg) if cuda \
        else rank_acc_plain(hi, lo, cons_half, cfg)
    return rank_epilogue(acc, affs, hi, tgt, cfg)
