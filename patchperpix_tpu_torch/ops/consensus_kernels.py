"""The hand-written CUDA kernels of the consensus and rank stages.

Counterpart of ``patchperpix_tpu/ops/pallas_consensus.py`` and
``patchperpix_tpu/ops/pallas_consensus_2d.py``:

- ``CONSENSUS`` (``csrc/consensus.cu``) replaces the Pallas kernel
  ``_kernel_v5`` of ``consensus_array_pallas``: the canonical half of the
  consensus array;
- ``RANK`` (``csrc/rank.cu``) replaces ``_rank_kernel_v5`` of
  ``rank_scores_pallas``: the rank sum over that half.  Both first pack
  the 0/1 mask stacks to bits (``csrc/pack_codes.cuh``, plain version
  ``pack_codes``) into scratch that the wrapper allocates;
- ``CONSENSUS2D`` (``csrc/consensus2d.cu``) replaces ``_cons2d_kernel`` of
  ``consensus_fold_pallas_2d``: the 2D canonical half (p, 2p-1, H, W) from
  one sentinel-gated stack and a target plane.  Its first step counts the
  target pixels, so that the wrapper sizes the scratch of the rest by them
  (plain version of that scratch: ``pack_target_codes_2d``);
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
import torch.nn.functional as F

from ._build import CudaKernel
from .consensus import (ConsensusConfig, _masks, consensus_half_2d_plain,
                        consensus_half_plain, derive_2d, gated_stack_2d,
                        is_2d, rank_acc_2d_plain, rank_acc_plain,
                        rank_epilogue, rank_epilogue_2d)
from .np_reference import patch_offsets
from .probe import PROBE

_P = ctypes.c_void_p
_I = ctypes.c_int
_WEIGHT_MODES = {"norm_prob_product": 0, "prob_product": 1, "count": 2}


CONSENSUS = CudaKernel(
    "consensus", "ppp_consensus_half",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
     _I, _P, _P, _P, _P],
    "patchperpix_tpu/ops/pallas_consensus.py:209 _kernel_v5 "
    "(consensus_array_pallas :311, pallas_call :395)")
RANK = CudaKernel(
    "rank", "ppp_rank_half",
    [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "patchperpix_tpu/ops/pallas_consensus.py:514 _rank_kernel_v5 "
    "(rank_scores_pallas :598, pallas_call :656)")
CONSENSUS2D = CudaKernel(
    "consensus2d", "ppp_consensus2d_half",
    [_P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I,
     _P, _I, _P, _P, _P, _P],
    "patchperpix_tpu/ops/pallas_consensus_2d.py:261 _cons2d_kernel "
    "(consensus_fold_pallas_2d :387, pallas_call :445)")
RANK2D = CudaKernel(
    "rank2d", "ppp_rank2d_half",
    [_P, _P, _P, _I, _P, _I, _I, _I, ctypes.c_float, ctypes.c_float, _I,
     _P],
    "patchperpix_tpu/ops/pallas_consensus_2d.py:531 _rank2d_kernel "
    "(_rank2d_call :664, pallas_call :709)")
KERNELS = (CONSENSUS, RANK, CONSENSUS2D, RANK2D, PROBE)
# csrc/consensus2d.cu's first step: the target pixels per row, so that the
# wrapper can size the scratch of the rest
CONSENSUS2D_COUNT = ("ppp_consensus2d_count", [_P, _I, _I, _P, _P])


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


def _n_words(cfg: ConsensusConfig) -> int:
    """32-bit words that hold one bit per patch pixel."""
    return (cfg.P + 31) // 32


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """bool (P, n) -> int32 (ceil(P / 32), n): bit q % 32 of word q // 32
    is bits[q]."""
    P, n = bits.shape
    W = (P + 31) // 32
    padded = torch.zeros((W * 32, n), dtype=torch.int64, device=bits.device)
    padded[:P] = bits
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, device=bits.device)).reshape(1, 32, 1)
    w = (padded.reshape(W, 32, n) * weights).sum(1)
    # as int32 bit patterns
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def _padded(vol, cfg: ConsensusConfig) -> tuple:
    return tuple(int(s) + 2 * int(r) for s, r in zip(vol, cfg.rad))


def pack_codes(hi: torch.Tensor, lo: torch.Tensor,
               cfg: ConsensusConfig) -> tuple:
    """Plain version of the centre-aligned pack pass (``csrc/
    pack_codes.cuh``), which the 3D rank kernel runs first: the 0/1 mask
    stacks hi, lo (P, *vol) as bits, and the planes the kernels leave
    early on.

    - codes (W, *vol, 2) int32, W = ceil(P / 32): bit q % 32 of
      codes[q // 32, c, 0] is hi[q, c] != 0, of codes[q // 32, c, 1] is
      lo[q, c] != 0;
    - E (*vol) uint8: 1 where any bit of center c is set.  The rank sum is
      exactly zero at every other center;
    - T (vol + 2 rad) uint8: 1 at the padded voxel c + q, the target voxel
      c + q - rad of every set bit (q, c).  The consensus half at (d, x)
      is exactly zero unless T holds at x + rad and at x + d + rad.
    """
    P = cfg.P
    vol = tuple(int(s) for s in hi.shape[1:])
    codes = torch.stack([_pack_words((t != 0).reshape(P, -1))
                         for t in (hi, lo)], dim=-1)
    live = (hi != 0) | (lo != 0)
    T = pack_target_codes(hi, lo, cfg).ne(0).any(dim=-1).any(dim=0)
    return (codes.reshape((-1,) + vol + (2,)),
            live.any(dim=0).to(torch.uint8), T.to(torch.uint8))


def pack_target_codes(hi: torch.Tensor, lo: torch.Tensor,
                      cfg: ConsensusConfig) -> torch.Tensor:
    """Plain version of the target-aligned pack pass, which the 3D
    consensus kernel runs first: (W, *(vol + 2 rad), 2) int32, where the
    bit of (q, c) sits at the padded voxel c + q, its target voxel
    c + q - rad.  A voxel's words say which patch pixels of which centers
    point at it; T of ``pack_codes`` is where any of them is set."""
    P = cfg.P
    vol = tuple(int(s) for s in hi.shape[1:])
    padded = _padded(vol, cfg)
    words = []
    for t in (hi, lo):
        bits = torch.zeros((P,) + padded, dtype=torch.bool, device=hi.device)
        for q, off in enumerate(patch_offsets(cfg.ps)):
            bits[(q,) + tuple(slice(int(o), int(o) + s)
                              for o, s in zip(off, vol))] = t[q] != 0
        words.append(_pack_words(bits.reshape(P, -1)))
    return torch.stack(words, dim=-1).reshape((-1,) + padded + (2,))


def unpack_codes(codes: torch.Tensor, cfg: ConsensusConfig) -> tuple:
    """(hi != 0, lo != 0), each bool (P, *vol), from ``pack_codes``'
    words."""
    shifts = torch.arange(32, device=codes.device).reshape(
        (1, 32) + (1,) * (codes.ndim - 1))
    bits = (torch.bitwise_right_shift(codes[:, None], shifts) & 1).bool()
    bits = bits.reshape((-1,) + tuple(codes.shape[1:]))[:cfg.P]
    return bits[..., 0], bits[..., 1]


def pack_target_codes_2d(ag: torch.Tensor, tgt: torch.Tensor,
                         cfg: ConsensusConfig) -> tuple:
    """Plain version of the scratch that ``csrc/consensus2d.cu`` fills from
    the gated stack and the target plane:

    - idx (H, W) int32: a target pixel's place in row-major order, -1 off
      the target (tgt == 0);
    - pix (n) int32: the flat pixel of each listed target pixel;
    - G (W, n, 2) int32, W = ceil(P / 32), target-aligned: bit q % 32 of
      G[q // 32, i, 0] / G[q // 32, i, 1] is hi / lo of patch pixel q of the
      eligible center pix[i] - (q - rad), whose pixel q points at pix[i].
    """
    P, H, W = ag.shape
    rad = int(cfg.ps[1]) // 2
    pix = torch.nonzero(tgt.reshape(-1) != 0)[:, 0]
    idx = torch.full((H * W,), -1, dtype=torch.int32, device=ag.device)
    idx[pix] = torch.arange(len(pix), dtype=torch.int32, device=ag.device)
    gate = (ag[cfg.mid] >= 0).to(torch.float32)
    words = []
    for t in derive_2d(ag, tgt, cfg):
        t = F.pad(t * gate, (rad, rad, rad, rad))
        bits = torch.stack([
            t[q, 2 * rad - int(o[1]):2 * rad - int(o[1]) + H,
              2 * rad - int(o[2]):2 * rad - int(o[2]) + W]
            for q, o in enumerate(patch_offsets(cfg.ps))]) != 0
        words.append(_pack_words(bits.reshape(P, -1)[:, pix]))
    return (idx.reshape(H, W), pix.to(torch.int32),
            torch.stack(words, dim=-1))


def _stream(device) -> _P:
    return _P(torch.cuda.current_stream(device).cuda_stream)


def _pack_scratch(cfg: ConsensusConfig, vol, dev, targets: bool):
    """Uninitialised scratch of the pack pass (``csrc/pack_codes.cuh``),
    which fills it: centre-aligned codes (W, *vol, 2) int32 and E (*vol)
    uint8 for the rank kernel, or with ``targets`` the target-aligned
    codes and T over the rad-padded volume for the consensus kernel."""
    vox = _padded(vol, cfg) if targets else tuple(int(s) for s in vol)
    return (torch.empty((_n_words(cfg),) + vox + (2,), dtype=torch.int32,
                        device=dev),
            torch.empty(vox, dtype=torch.uint8, device=dev))


def _consensus_launch(a, b, hi, lo, cfg: ConsensusConfig) -> tuple:
    """``consensus_half_cuda`` with the pack pass's scratch: (half,
    target-aligned codes, T, vals); vals (2, *vol, P), centre-major, holds
    a - b wherever a bit is set and b wherever lo is set, and nothing
    elsewhere."""
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
    codes, targets = _pack_scratch(cfg, vol, dev, targets=True)
    vals = torch.empty((2,) + vol + (cfg.P,), dtype=torch.float32,
                       device=dev)
    CONSENSUS.launch(
        a.data_ptr(), b.data_ptr(), hi.data_ptr(), lo.data_ptr(),
        out.data_ptr(), int(cfg.cons_bf16), *vol, psz, psy, psx,
        _WEIGHT_MODES[cfg.weight_mode], float(cfg.patch_threshold),
        int(cfg.norm_aff), codes.data_ptr(), targets.data_ptr(),
        vals.data_ptr(), _stream(dev))
    return out, codes, targets, vals


def consensus_half_cuda(a, b, hi, lo, cfg: ConsensusConfig) -> torch.Tensor:
    """Launch ``csrc/consensus.cu`` on the centre-aligned stacks
    a = affs*hi, b = (1-affs)*lo and the 0/1 masks hi, lo (each
    (P, Z, Y, X) float32; a is zero where hi is, b where lo is)."""
    return _consensus_launch(a, b, hi, lo, cfg)[0]


def rank_acc_cuda(hi, lo, cons_half, cfg: ConsensusConfig) -> torch.Tensor:
    """Launch ``csrc/rank.cu`` on the 0/1 masks hi, lo and the canonical
    half: the unnormalized rank sum (Z, Y, X)."""
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
    codes, elig = _pack_scratch(cfg, vol, dev, targets=False)
    RANK.launch(hi.data_ptr(), lo.data_ptr(), cons_half.data_ptr(),
                int(s_dtype == torch.bfloat16), acc.data_ptr(), *vol,
                psz, psy, psx, int(cfg.rank_int_counter), codes.data_ptr(),
                elig.data_ptr(), _stream(dev))
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


def _consensus2d_launch(ag, tgt, cfg: ConsensusConfig) -> tuple:
    """``consensus_half_2d_cuda`` with the scratch of its steps: (half,
    idx, pix, G), as ``pack_target_codes_2d`` describes them.  The scratch
    is sized by the n target pixels, which the kernel's first step counts
    and the host reads (one sync)."""
    dev, H, W = _check_2d_operands("consensus2d kernel", ag, tgt, cfg)
    p = int(cfg.ps[1])
    out = torch.empty((p, 2 * p - 1, H, W), device=dev,
                      dtype=torch.bfloat16 if cfg.cons_bf16
                      else torch.float32)
    row_off = torch.empty(H + 1, dtype=torch.int32, device=dev)
    stream = _stream(dev)
    CONSENSUS2D.call(*CONSENSUS2D_COUNT, tgt.data_ptr(), H, W,
                     row_off.data_ptr(), stream)
    n = int(row_off[H])
    idx = torch.empty((H, W), dtype=torch.int32, device=dev)
    pix = torch.empty(n, dtype=torch.int32, device=dev)
    G = torch.empty((_n_words(cfg), n, 2), dtype=torch.int32, device=dev)
    CONSENSUS2D.launch(
        ag.data_ptr(), tgt.data_ptr(), out.data_ptr(), int(cfg.cons_bf16),
        H, W, p, _WEIGHT_MODES[cfg.weight_mode], float(cfg.patch_threshold),
        float(cfg.bg_th), int(cfg.norm_aff), row_off.data_ptr(), n,
        idx.data_ptr(), pix.data_ptr(), G.data_ptr(), stream)
    return out, idx, pix, G


def consensus_half_2d_cuda(ag, tgt, cfg: ConsensusConfig) -> torch.Tensor:
    """Launch ``csrc/consensus2d.cu`` on the gated stack ag (P, H, W) and
    the target plane tgt (H, W) of ``gated_stack_2d``: the 2D canonical
    half (p, 2p-1, H, W), float32 or bf16."""
    return _consensus2d_launch(ag, tgt, cfg)[0]


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
