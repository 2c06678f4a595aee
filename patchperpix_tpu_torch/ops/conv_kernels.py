"""Weight gradients of the training step's float32 convolutions on the card.

Two hand-written kernels, each with a fixed order of summation (no
atomics: two calls give the same bits), in float32 FMA.  Neither replaces
a TPU kernel (the JAX package leaves convolutions to XLA);
``models/unet.py`` routes convolutions to them in exact-f32 training, in
place of cuDNN's weight gradient.

W1, ``WGRAD`` (``csrc/conv3d_wgrad.cu``), computes, from a convolution's
input ``x`` (N, Ci, D, H, W) and its output's gradient ``dy`` (N, Co, D -
2, H - 2, W - 2), the weight gradient dW (Co, Ci, 3, 3, 3) and the bias
gradient dB (Co,) of a valid 3x3x3 convolution with stride 1 and one
group; a SAME one is the valid one of its input zero-padded by one.
``conv3d_wgrad_plain`` is its plain PyTorch version (one product over the
positions per tap), which ``conv3d_wgrad`` takes for CPU tensors; for a
CUDA tensor it launches the kernel or raises.  ``plan`` chooses, from the
shape alone, the kernel's tile instance (``CONFIGS``), the positions a
CTA stages per plane (``P``) and the number of shares the positions are
split into (``splits``).

W2, ``GEMM`` (``csrc/conv_wgrad_gemm.cu``), computes from ``a`` (N, M, S)
and ``b`` (N, K, S) the product dW[m, k] = sum over n, s of a[n, m, s]
b[n, k, s] and dB[m] = sum of a[n, m, s]: the weight and bias gradient of
a pointwise convolution (``conv1_wgrad``: a = dy, b = x) and of a
transposed convolution whose kernel equals its stride (``conv_t_wgrad``:
dy regrouped by tap).  ``conv_wgrad_gemm_plain`` is its plain version,
which ``conv_wgrad_gemm`` takes for CPU tensors; ``gemm_plan`` chooses
the tile instance (``GEMM_CONFIGS``) and the shares.

Each kernel counts one launch per call, whatever the launches inside (the
main kernel, and the sum of the shares when there are several).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int

WGRAD = CudaKernel(
    "conv3d_wgrad", "ppp_conv3d_wgrad",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "none (the JAX package leaves convolutions to XLA)")

# The kernel's tile instances, as csrc/conv3d_wgrad.cu lists them: (TM,
# TC, GM, CTAs an SM should hold: MINB, its __launch_bounds__ minimum of
# blocks).  A CTA's tile is BM = TM * GM output channels x BC = TC * (32 /
# GM) input channels x 27 taps; a thread's is TM x TC x 3.
CONFIGS = ((5, 1, 4, 2), (5, 3, 4, 1), (6, 3, 4, 1), (4, 3, 8, 2))
# The share of the FMA pipes each instance can keep busy: its FMAs over
# the FMAs and shared-memory loads it issues for four positions (12 TM TC
# against TM + 6 TC), which weighs padded work when choosing a tile.
_ISSUE = tuple(12 * tm * tc / (12 * tm * tc + tm + 6 * tc + 6)
               for tm, tc, _, _ in CONFIGS)
SMEM_OPTIN = 232448      # bytes a CTA may opt in to on sm_90 (H100, H200)
MAX_P = 1024             # positions of a chunk at most
WIDE = 128               # channels from which cuDNN's weight gradient wins
SHORT_ROWS = (5, 8)      # input row lengths where, from NARROW channel
NARROW = 512             # pairs (Ci * Co), cuDNN's weight gradient wins
SM_FMA_PER_S = 128 * 1.7e9   # an SM's float32 FMA lanes per second
HBM_BYTES_PER_S = 2.5e12     # what the sum of the shares streams at
LAUNCH_S = 5e-6


def tile(config: int) -> tuple:
    """(BM, BC): output and input channels of a CTA's tile."""
    tm, tc, gm, _ = CONFIGS[config]
    return tm * gm, tc * (32 // gm)


class Plan(NamedTuple):
    config: int
    P: int          # positions of a chunk (multiple of 4)
    xstr: int       # input row stride in shared memory (odd)
    dstr: int       # dy row stride in shared memory (4 mod 8)
    smem: int       # bytes of shared memory a CTA takes
    splits: int     # shares of the positions
    nchunk: int     # chunks of an output plane


def _strides(P: int, W: int) -> tuple:
    xstr = (P + 2 * W + 2) | 1
    dstr = P if P % 8 == 4 else P + 4
    return xstr, dstr


def _smem(config: int, P: int, W: int) -> int:
    bm, bc = tile(config)
    xstr, dstr = _strides(P, W)
    return 4 * (4 * bc * xstr + 2 * bm * dstr)


def _chunk(config: int, H: int, W: int):
    """(P, nchunk) for an output plane of (H - 2) x W flattened positions:
    the fewest chunks whose shared memory fits, evened out; for an
    instance meant to share its SM, within half the opt-in where that
    leaves chunks of 64 positions or more.  None where no chunk fits."""
    Q = (H - 2) * W
    caps = [SMEM_OPTIN]
    if CONFIGS[config][3] > 1:
        caps.insert(0, SMEM_OPTIN // CONFIGS[config][3] - 1024)
    for cap in caps:
        top = 0
        for P in range(4, MAX_P + 1, 4):
            if _smem(config, P, W) > cap:
                break
            top = P
        if top >= 64 or (top and cap == SMEM_OPTIN):
            nchunk = -(-Q // top)
            P = -(-Q // nchunk)
            return P + (-P) % 4, nchunk
    return None


def _splits(units: int, tiles: int, slots: int, Do: int, unit_s: float,
            share_s: float) -> int:
    """Shares of the positions that minimise the modelled time: waves of
    CTAs times each CTA's chunk-planes (each restart of its walk down z
    costing about half a plane more), plus the sum of the shares."""
    cands = {1} | {max(1, k * slots // tiles) for k in range(1, 65)}
    best, best_t = 1, math.inf
    for S in sorted(c for c in cands if c <= units):
        per = -(-units // S)
        waves = -(-tiles * S // slots)
        t = waves * (per + 0.5 * (-(-per // Do) + 1)) * unit_s
        if S > 1:
            t += S * share_s + LAUNCH_S
        if t < best_t * 0.99:
            best, best_t = S, t
    return best


def occupancy(config: int, smem: int) -> int:
    """CTAs of instance ``config`` an SM holds with ``smem`` bytes of
    shared memory each: its MINB, whose registers ``__launch_bounds__``
    guarantees, where MINB such CTAs fit in the opt-in shared memory with
    the 1 KB each reserves (as ``_chunk`` sizes them), else one."""
    minb = CONFIGS[config][3]
    return minb if smem <= SMEM_OPTIN // minb - 1024 else 1


def make_plan(N: int, Ci: int, Co: int, D: int, H: int, W: int,
              sms: int) -> Plan | None:
    """The launch plan for input (N, Ci, D, H, W) and Co output channels
    on a card of ``sms`` SMs.  The instance is the one with the least
    padded work per share of its FMA pipes kept busy; None where no
    instance's chunk fits in shared memory."""
    best = None
    for config in range(len(CONFIGS)):
        ch = _chunk(config, H, W)
        if ch is None:
            continue
        bm, bc = tile(config)
        padded = -(-Co // bm) * bm * -(-Ci // bc) * bc / _ISSUE[config]
        if best is None or padded < best[0]:
            best = (padded, config, ch)
    if best is None:
        return None
    _, config, (P, nchunk) = best
    bm, bc = tile(config)
    smem = _smem(config, P, W)
    occ = occupancy(config, smem)
    tiles = -(-Co // bm) * -(-Ci // bc)
    units = N * nchunk * (D - 2)
    unit_s = bm * bc * 27 * P * occ / (SM_FMA_PER_S * _ISSUE[config])
    share_s = 4 * (Co * Ci * 27 + Co) / HBM_BYTES_PER_S
    S = _splits(units, tiles, sms * occ, D - 2, unit_s, share_s)
    xstr, dstr = _strides(P, W)
    return Plan(config, P, xstr, dstr, smem, S, nchunk)


@functools.lru_cache(maxsize=256)
def device_plan(N, Ci, Co, D, H, W, device) -> Plan | None:
    """``make_plan`` on ``device``'s SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return make_plan(N, Ci, Co, D, H, W, sms)


def _check(x: torch.Tensor, dy: torch.Tensor):
    if x.ndim != 5 or dy.ndim != 5:
        raise ValueError(f"conv3d_wgrad: expected 5D x and dy, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    N, _, D, H, W = x.shape
    if min(D, H, W) < 3 or tuple(dy.shape[:1]) + tuple(dy.shape[2:]) != (
            N, D - 2, H - 2, W - 2):
        raise ValueError(f"conv3d_wgrad: dy {tuple(dy.shape)} is not the "
                         f"valid 3x3x3 output of x {tuple(x.shape)}")
    if x.dtype != dy.dtype or x.device != dy.device:
        raise ValueError(f"conv3d_wgrad: x {x.dtype} on {x.device}, dy "
                         f"{dy.dtype} on {dy.device}")


def conv3d_wgrad_plain(x: torch.Tensor, dy: torch.Tensor) -> tuple:
    """(dW, dB) of a valid 3x3x3 convolution: for each tap, one product of
    dy with the input shifted by the tap, summed over the batch and the
    positions; dB sums dy.  Any float type, any device."""
    _check(x, dy)
    Do, Ho, Wo = dy.shape[2:]
    dw = x.new_empty((dy.shape[1], x.shape[1], 3, 3, 3))
    for kz in range(3):
        for ky in range(3):
            for kx in range(3):
                xs = x[:, :, kz:kz + Do, ky:ky + Ho, kx:kx + Wo]
                dw[:, :, kz, ky, kx] = torch.einsum("nozyx,nizyx->oi", dy,
                                                    xs)
    return dw, dy.sum(dim=(0, 2, 3, 4))


def conv3d_wgrad_cuda(x: torch.Tensor, dy: torch.Tensor) -> tuple:
    """Launch ``csrc/conv3d_wgrad.cu`` on contiguous float32 CUDA
    tensors, by ``device_plan``."""
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_wgrad kernel: tensor on {x.device}, not "
                         "CUDA")
    _check(x, dy)
    if x.dtype != torch.float32 or not (x.is_contiguous()
                                        and dy.is_contiguous()):
        raise ValueError(f"conv3d_wgrad kernel: expected contiguous float32"
                         f", got {x.dtype}")
    N, Ci, D, H, W = x.shape
    Co = dy.shape[1]
    p = device_plan(N, Ci, Co, D, H, W, x.device)
    if p is None:
        raise ValueError(f"conv3d_wgrad kernel: rows of {W} do not fit in "
                         "shared memory")
    nw = Co * Ci * 27
    out = torch.empty(nw + Co, dtype=torch.float32, device=x.device)
    ws = out if p.splits == 1 else torch.empty(
        p.splits * (nw + Co), dtype=torch.float32, device=x.device)
    WGRAD.launch(x.device, x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                 out.data_ptr(), N, Ci, Co, D, H, W, p.config, p.P, p.xstr,
                 p.dstr, p.splits,
                 ctypes.c_void_p(
                     torch.cuda.current_stream(x.device).cuda_stream))
    return out[:nw].view(Co, Ci, 3, 3, 3), out[nw:]


@functools.lru_cache(maxsize=256)
def serves(Ci: int, Co: int, W: int) -> bool:
    """Whether a training step takes its weight gradient from the kernel
    for Ci -> Co channels on input rows of W values: some instance's chunk
    fits in shared memory, at least one channel count is below ``WIDE``,
    and on rows of 5 to 8 values (``SHORT_ROWS``) Ci * Co is below
    ``NARROW``.  Where both channel counts reach ``WIDE``, cuDNN's
    exact-f32 heuristic takes its implicit-GEMM weight gradient, which
    beat this kernel at each such convolution of the published FlyLight
    U-Net (180 -> 180 to 540 -> 540 channels on 12^3 to 30^3; PERF.md
    section 6), while below it cuDNN takes a direct kernel 1.6 to 40 times
    slower than this one.  On rows of 6 and 8 at batch 2,048, cuDNN's
    implicit GEMM took 16 -> 32 to 64 -> 64 level with this kernel or up
    to 1.57 times faster (at batch 256, between 1.47 times slower and
    1.31 times faster), while at 1 -> 1 to 16 -> 16 its direct kernels
    ran 1.2 to 16 times slower; on rows of 4, and of 12 or more, this
    kernel won at every width below ``WIDE`` at batch 256 and 2,048
    (``scripts/conv_wgrad_gemm_cuda.py --short-rows``; PERF.md section
    6)."""
    short = SHORT_ROWS[0] <= W <= SHORT_ROWS[1]
    return min(Ci, Co) < WIDE and not (short and Ci * Co >= NARROW) \
        and any(_chunk(c, 3, W) is not None for c in range(len(CONFIGS)))


def conv3d_wgrad(x: torch.Tensor, dy: torch.Tensor) -> tuple:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return conv3d_wgrad_cuda(x, dy)
    if x.device.type == "cpu":
        return conv3d_wgrad_plain(x, dy)
    raise ValueError(f"conv3d_wgrad: no kernel for device {x.device}")


# -- W2: the weight gradient as a matrix product ----------------------------

GEMM = CudaKernel(
    "conv_wgrad_gemm", "ppp_conv_wgrad_gemm",
    [_P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I, _I, _I, _P],
    "none (the JAX package leaves convolutions to XLA)")

# The kernel's instances, as csrc/conv_wgrad_gemm.cu lists them: (TM, TN,
# WY, WX, MINB: its __launch_bounds__ minimum of blocks).  A CTA's tile is
# BM = TM * WY rows of a x BN = TN * WX rows of b, with WY * WX threads; a
# thread's is TM x TN.
GEMM_CONFIGS = ((8, 8, 16, 16, 2), (4, 4, 16, 16, 3), (8, 4, 16, 8, 3),
                (4, 4, 16, 8, 4), (1, 2, 8, 16, 8))
GEMM_KC = 32             # positions of a chunk
# The share of the FMA pipes each instance can keep busy: its 4 TM TN FMAs
# over those and the TM + TN shared-memory loads and loop work of four
# positions
_GEMM_ISSUE = tuple(4 * tm * tn / (4 * tm * tn + tm + tn + 2)
                    for tm, tn, _, _, _ in GEMM_CONFIGS)
HBM_READ_PER_S = 3.0e12  # what the kernel streams its operands at
CTA_FILL_S = 1.5e-6      # a CTA's start: its first chunk's copies in flight


def gemm_tile(config: int) -> tuple:
    """(BM, BN): rows of a and of b in a CTA's tile."""
    tm, tn, wy, wx, _ = GEMM_CONFIGS[config]
    return tm * wy, tn * wx


def gemm_smem(config: int) -> int:
    """Bytes of shared memory a CTA takes: two chunks of its tile, rows
    of KC + 4 floats."""
    bm, bn = gemm_tile(config)
    return 2 * (bm + bn) * (GEMM_KC + 4) * 4


class GemmPlan(NamedTuple):
    config: int
    splits: int     # shares of the chunks
    seconds: float  # the modelled time


def gemm_plan(N: int, M: int, K: int, S: int, sms: int) -> GemmPlan:
    """The launch plan for a (N, M, S) and b (N, K, S) on a card of
    ``sms`` SMs: the instance and the number of shares of least modelled
    time.  The model takes the larger of the FMA time (waves of CTAs,
    each walking its share of the chunks, padded tiles included) and the
    bytes read (a once per column of tiles, b once per row), and adds each
    wave's start and the sum of the shares."""
    chunks = -(-N * S // GEMM_KC)
    best = None
    for config, (tm, tn, wy, wx, minb) in enumerate(GEMM_CONFIGS):
        bm, bn = gemm_tile(config)
        tiles_m, tiles_n = -(-M // bm), -(-K // bn)
        tiles = tiles_m * tiles_n
        slots = sms * minb
        chunk_s = bm * bn * GEMM_KC * minb / (SM_FMA_PER_S
                                              * _GEMM_ISSUE[config])
        read_s = 4 * N * S * (M * tiles_n + K * tiles_m) / HBM_READ_PER_S
        cands = {1} | {max(1, k * slots // tiles) for k in range(1, 9)}
        for splits in sorted(c for c in cands if c <= chunks):
            waves = -(-tiles * splits // slots)
            per = -(-chunks // splits)
            t = max(waves * per * chunk_s, read_s) + waves * CTA_FILL_S
            if splits > 1:
                t += 8 * splits * (M * K + M) / HBM_BYTES_PER_S + LAUNCH_S
            if best is None or t < best.seconds * 0.99:
                best = GemmPlan(config, splits, t)
    return best


@functools.lru_cache(maxsize=256)
def device_gemm_plan(N, M, K, S, device) -> GemmPlan:
    """``gemm_plan`` on ``device``'s SMs."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return gemm_plan(N, M, K, S, sms)


def _check_gemm(a: torch.Tensor, b: torch.Tensor):
    if a.ndim != 3 or b.ndim != 3:
        raise ValueError(f"conv_wgrad_gemm: expected 3D a and b, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[0] != b.shape[0] or a.shape[2] != b.shape[2]:
        raise ValueError(f"conv_wgrad_gemm: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} differ in batch or positions")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"conv_wgrad_gemm: a {a.dtype} on {a.device}, b "
                         f"{b.dtype} on {b.device}")


def conv_wgrad_gemm_plain(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(dW (M, K), dB (M,)) for a (N, M, S) and b (N, K, S): one product
    summed over the batch and the positions, and the sum of a.  Any float
    type, any device."""
    _check_gemm(a, b)
    return torch.einsum("nms,nks->mk", a, b), a.sum(dim=(0, 2))


def conv_wgrad_gemm_cuda(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """Launch ``csrc/conv_wgrad_gemm.cu`` on contiguous float32 CUDA
    tensors, by ``device_gemm_plan``."""
    if a.device.type != "cuda":
        raise ValueError(f"conv_wgrad_gemm kernel: tensor on {a.device}, "
                         "not CUDA")
    _check_gemm(a, b)
    if a.dtype != torch.float32 or not (a.is_contiguous()
                                        and b.is_contiguous()):
        raise ValueError(f"conv_wgrad_gemm kernel: expected contiguous "
                         f"float32, got {a.dtype}")
    N, M, S = a.shape
    K = b.shape[1]
    p = device_gemm_plan(N, M, K, S, a.device)
    vec = S % 4 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    out = torch.empty(M * K + M, dtype=torch.float32, device=a.device)
    ws = out if p.splits == 1 else torch.empty(
        p.splits * (M * K + M), dtype=torch.float32, device=a.device)
    GEMM.launch(a.device, a.data_ptr(), b.data_ptr(), ws.data_ptr(),
                out.data_ptr(), N, M, K, S, p.config, p.splits, int(vec),
                ctypes.c_void_p(
                    torch.cuda.current_stream(a.device).cuda_stream))
    return out[:M * K].view(M, K), out[M * K:]


def conv_wgrad_gemm(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cuda":
        return conv_wgrad_gemm_cuda(a, b)
    if a.device.type == "cpu":
        return conv_wgrad_gemm_plain(a, b)
    raise ValueError(f"conv_wgrad_gemm: no kernel for device {a.device}")


def conv1_wgrad(x: torch.Tensor, dy: torch.Tensor) -> tuple:
    """(dW (Co, Ci, 1, 1, 1), dB (Co,)) of a pointwise 3D convolution from
    its input x (N, Ci, D, H, W) and its output's gradient dy (N, Co, D,
    H, W), both contiguous: ``conv_wgrad_gemm`` of dy and x over the
    positions."""
    N, Ci = x.shape[:2]
    Co = dy.shape[1]
    dw, db = conv_wgrad_gemm(dy.reshape(N, Co, -1), x.reshape(N, Ci, -1))
    return dw.view(Co, Ci, 1, 1, 1), db


def tap_rows(dy: torch.Tensor, f: tuple) -> torch.Tensor:
    """The gradient dy (N, Co, f D, f H, f W) of a 3D transposed
    convolution whose kernel equals its stride f, regrouped by tap into
    (N, f^3 Co, D H W) by one copy: output (f d + a, f h + b, f w + c)
    takes input (d, h, w) through tap (a, b, c) alone, so row (a, b, c,
    co) reads against the input's positions in order."""
    N, Co, Dz, Dy, Dx = dy.shape
    fz, fy, fx = f
    return dy.reshape(N, Co, Dz // fz, fz, Dy // fy, fy, Dx // fx,
                      fx).permute(0, 3, 5, 7, 1, 2, 4, 6).reshape(
                          N, fz * fy * fx * Co, -1)


def conv_t_wgrad(x: torch.Tensor, dy: torch.Tensor, f: tuple) -> tuple:
    """(dW (Ci, Co, *f), dB (Co,)) of a 3D transposed convolution whose
    kernel equals its stride f, from its input x (N, Ci, D, H, W),
    contiguous, and its output's gradient dy (N, Co, f D, f H, f W):
    ``conv_wgrad_gemm`` of ``tap_rows(dy, f)`` and x; dB sums the taps'
    rows."""
    N, Ci = x.shape[:2]
    Co = dy.shape[1]
    dw, db = conv_wgrad_gemm(tap_rows(dy, f), x.reshape(N, Ci, -1))
    dw = dw.view(*f, Co, Ci).permute(4, 3, 0, 1, 2).contiguous()
    return dw, db.view(-1, Co).sum(0)
