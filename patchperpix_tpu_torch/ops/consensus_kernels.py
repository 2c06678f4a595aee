"""The hand-written CUDA kernels of the consensus and rank stages.

Counterpart of ``patchperpix_tpu/ops/pallas_consensus.py``:

- ``CONSENSUS`` (``csrc/consensus.cu``) replaces the Pallas kernel
  ``_kernel_v5`` of ``consensus_array_pallas``: the canonical half of the
  consensus array;
- ``RANK`` (``csrc/rank.cu``) replaces ``_rank_kernel_v5`` of
  ``rank_scores_pallas``: the rank sum over that half.

On the TPU the JAX package runs both inside
``consensus_and_rank_pallas_fold2x``, which only packs two z-slabs into
the 128 TPU lanes and returns what the unfolded kernels return, so the
port calls the kernels unfolded.

Each wrapper allocates its output, checks device, dtype, shape and
contiguity, launches on PyTorch's current stream and raises if the launch
fails.  ``consensus_half`` / ``rank_scores`` take the plain PyTorch
version (``ops/consensus.py``) only for tensors on the CPU; any other
device raises.  Each kernel counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .consensus import (ConsensusConfig, consensus_half_plain,
                        rank_acc_plain, rank_epilogue)

_P = ctypes.c_void_p
_I = ctypes.c_int
_WEIGHT_MODES = {"norm_prob_product": 0, "prob_product": 1, "count": 2}


class CudaKernel:
    """One kernel of ``csrc/``: its C entry point and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes, replaces: str):
        self.name = name
        self.source = f"patchperpix_tpu_torch/csrc/{name}.cu"
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0

    def launch(self, *args):
        lib = _build.load(self.name)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            msg = getattr(lib, f"ppp_{self.name}_error_string")
            msg.argtypes = [ctypes.c_int]
            msg.restype = ctypes.c_char_p
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err} ({msg(err).decode()})")
        self.launches += 1


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
KERNELS = (CONSENSUS, RANK)


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


def consensus_half(affs, hi, lo, cfg: ConsensusConfig) -> torch.Tensor:
    """Canonical-half consensus: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if affs.device.type == "cuda":
        return consensus_half_cuda(affs * hi, (1.0 - affs) * lo, hi, lo, cfg)
    if affs.device.type == "cpu":
        return consensus_half_plain(affs, hi, lo, cfg)
    raise ValueError(f"consensus: no kernel for device {affs.device}")


def rank_scores(affs, cons_half, hi, lo, tgt,
                cfg: ConsensusConfig) -> torch.Tensor:
    """Per-voxel patch score (-1 sentinel off eligible centers): the CUDA
    rank kernel for CUDA tensors, the plain version for CPU tensors, then
    ``rank_epilogue``."""
    if affs.device.type == "cuda":
        acc = rank_acc_cuda(hi, lo, cons_half, cfg)
    elif affs.device.type == "cpu":
        acc = rank_acc_plain(hi, lo, cons_half, cfg)
    else:
        raise ValueError(f"rank: no kernel for device {affs.device}")
    return rank_epilogue(acc, affs, hi, tgt, cfg)
