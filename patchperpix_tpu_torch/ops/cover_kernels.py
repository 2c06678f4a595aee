"""The hand-written CUDA kernels of the cover stages.

Counterpart of the JAX package's device loops in
``patchperpix_tpu/ops/cover.py``:

- ``COVER_CASCADE`` (``csrc/cover_cascade.cu``, K5) replaces
  ``_greedy_cover_volume``: the dense-data greedy cover, one ranked-order
  sweep per pixel threshold;
- ``THIN_COVER`` (``csrc/thin_cover.cu``, K6) replaces
  ``_thin_cover_volume_lazy`` (mode ``"lazy"``) and its exact
  full-recompute fallback ``_thin_cover_volume`` (mode ``"full"``).

Each is one thread block that holds its whole loop, after two pack passes
(the candidates' masks and the mask to cover as bits, ``csrc/
cover_window.cuh``).  ``ops/cover.py`` routes a CUDA tensor here and a CPU
tensor to its host loops, the plain versions.

The wrappers check the operands, allocate the scratch and one output
buffer (the loop's statistics, ``selected`` and, for the cascade, the
still-uncovered volume) with ``torch.empty``, launch on PyTorch's current
stream of the tensors' device and copy that buffer to the host once.
``run_cover_cascade`` / ``run_thin_cover`` take the C entry point as
``launch``, so that the same marshalling drives the library built for the
card and the host build of the same source that the CPU tests compile
(``tests/test_torch_kernel_mock.py``).  A volume of fewer than three axes
is taken as (1, ..., *vol).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._build import CudaKernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

COVER_CASCADE = CudaKernel(
    "cover_cascade", "ppp_cover_cascade",
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
     ctypes.POINTER(ctypes.c_int), _I, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "patchperpix_tpu/ops/cover.py:30 _greedy_cover_volume "
    "(a lax.scan of lax.fori_loops, not Pallas)")
THIN_COVER = CudaKernel(
    "thin_cover", "ppp_thin_cover",
    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P, _P, _P,
     _P, _P, _P, _P],
    "patchperpix_tpu/ops/cover.py:144 _thin_cover_volume_lazy "
    "(a lax.while_loop, not Pallas) and :238 _thin_cover_volume")

# block sizes and the cascade's chunk, the fastest of 64 to 1024 threads
# and of 32 to 1024 candidates on an H100 (the thin cover on the 3D main
# path's input, the cascade on 2D setting (B)'s;
# scripts/time_cover_kernels.py, PERF.md)
CASCADE_THREADS = 1024
THIN_THREADS = 1024
CHUNK = 256            # candidates the cascade bounds at once
SMEM_CAP = 1 << 30     # stage all that fits in the device's shared memory
MODES = {"lazy": 0, "full": 1}
# the statistics at the front of the output buffer: 8 int32 counts, then 8
# int64 sums of clock64() cycles (ppp_cover::kStats, csrc/cover_window.cuh):
# the loop kernel's total, then by phase (the source's kCy* slots)
STATS_BYTES = 96
CASCADE_STATS = ("to_cover", "visits", "takes", "bounded", "sweeps")
CASCADE_CYCLES = ("total", "setup", "bound", "bound_wait", "walk",
                  "walk_wait", "output")
THIN_STATS = ("to_cover", "rounds", "picks", "refreshes", "capped")
THIN_CYCLES = ("total", "setup", "argmax", "refresh", "pick", "take",
               "mark")


def default_max_it(n: int) -> int:
    """The lazy loop's cap, 64 n + 1024 (cover.py:177's iterations; the
    kernel counts rounds: a pick, or one batched refresh)."""
    return 64 * int(n) + 1024


def _geometry(vol, ps) -> tuple:
    """(words a candidate's mask takes, words of the running volume), as
    the kernels lay them out (``csrc/cover_window.cuh``)."""
    P = int(np.prod(ps))
    nbits = int(np.prod([int(v) + 2 * (int(p) // 2)
                         for v, p in zip(vol, ps)]))
    return (P + 31) // 32 + 1, (nbits + 31) // 32 + 1


def _mask_words(n: int, wp: int) -> int:
    """Words of the mask buffer: n wp rounded up to 16 bytes, so that the
    kernels' bulk copies of rows widened to 16-byte bounds stay inside."""
    return (n * wp + 3) // 4 * 4


def _operands(what, affs, mask_to_cover, centers, patchshape):
    """The kernels' operands on ``affs.device``: (vol, ps, affs, mask
    uint8, centers int32 (n, 3)), each cut to three axes; the centers'
    allocation holds whole 16-byte groups (zero rows past the n), which the
    cascade's bulk copies read."""
    ps = tuple(int(p) for p in patchshape)
    vol = tuple(int(s) for s in np.shape(mask_to_cover))
    if len(ps) != len(vol) or not 1 <= len(ps) <= 3:
        raise ValueError(f"{what}: patch {ps} and volume {vol} need the "
                         f"same number (1 to 3) of axes")
    P = int(np.prod(ps))
    if affs.dtype != torch.float32 or tuple(affs.shape) != (P,) + vol \
            or not affs.is_contiguous():
        raise ValueError(f"{what}: expected contiguous float32 "
                         f"{(P,) + vol}, got {affs.dtype} "
                         f"{tuple(affs.shape)}")
    centers = np.asarray(centers, dtype=np.int64).reshape(len(centers),
                                                          len(vol))
    if len(centers) == 0 or (centers < 0).any() \
            or (centers >= np.array(vol)).any():
        raise ValueError(f"{what}: centers must be at least one voxel "
                         f"inside the volume {vol}")
    lead = 3 - len(vol)
    vol3, ps3 = (1,) * lead + vol, (1,) * lead + ps
    cen3 = np.concatenate([np.zeros((len(centers), lead), np.int64),
                           centers], axis=1)
    dev = affs.device
    mask = np.ascontiguousarray(mask_to_cover, dtype=bool).view(np.uint8)
    n = len(cen3)
    cen_buf = np.zeros(((n + 3) // 4 * 4, 3), np.int32)
    cen_buf[:n] = cen3
    return (vol3, ps3, affs.reshape((P,) + vol3),
            torch.as_tensor(mask.reshape(vol3), device=dev),
            torch.as_tensor(cen_buf, device=dev)[:n])


def _stats(host: np.ndarray, names, cycle_names) -> dict:
    """The counts under ``names`` and the phase cycles under
    ``"cycles"``."""
    out = {k: int(v) for k, v in zip(names, host[:32].view(np.int32))}
    out["cycles"] = {k: int(v) for k, v in zip(
        cycle_names, host[32:STATS_BYTES].view(np.int64))}
    return out


def run_cover_cascade(launch, affs, mask_to_cover, centers, overlap_rows,
                      patchshape, fc_threshold: float, pix_ths, *,
                      threads: int = CASCADE_THREADS, chunk: int = CHUNK,
                      smem_cap: int = SMEM_CAP, stream=None) -> tuple:
    """One launch of the cascade through ``launch`` (the C entry point):
    (selected bool (n,), still-uncovered bool volume, statistics)."""
    vol, ps, a, mask, cen = _operands("cover cascade kernel", affs,
                                      mask_to_cover, centers, patchshape)
    n, V, dev = len(cen), int(np.prod(vol)), affs.device
    wp, nwords = _geometry(vol, ps)
    pm = torch.empty(_mask_words(n, wp), dtype=torch.int32, device=dev)
    run = torch.empty(nwords, dtype=torch.int32, device=dev)
    ovl = np.zeros((n + 15) // 16 * 16, np.uint8)
    ovl[:n] = np.asarray(overlap_rows, bool)
    ovl = torch.as_tensor(ovl, device=dev)
    out = torch.empty(STATS_BYTES + n + V, dtype=torch.uint8, device=dev)
    ths = [int(t) for t in pix_ths]
    base = out.data_ptr()
    launch(a.data_ptr(), mask.data_ptr(), cen.data_ptr(), ovl.data_ptr(), n,
           *vol, *ps, float(fc_threshold), (ctypes.c_int * max(1, len(ths)))(
               *ths), len(ths), int(chunk), int(threads), int(smem_cap),
           pm.data_ptr(), run.data_ptr(), base, base + STATS_BYTES,
           base + STATS_BYTES + n, stream)
    host = out.cpu().numpy()
    return (host[STATS_BYTES:STATS_BYTES + n].astype(bool),
            host[STATS_BYTES + n:].reshape(np.shape(mask_to_cover))
            .astype(bool), _stats(host, CASCADE_STATS, CASCADE_CYCLES))


def run_thin_cover(launch, affs, mask_to_cover, centers, patchshape,
                   fc_threshold: float, mode: str = "lazy",
                   max_it: int | None = None, *, threads: int = THIN_THREADS,
                   smem_cap: int = SMEM_CAP, stream=None) -> tuple:
    """One launch of the thin cover through ``launch`` in ``mode``
    ("lazy", stopping at ``max_it`` rounds, by default 64 n + 1024, or
    "full"): (selected bool (n,), statistics with ``capped``)."""
    vol, ps, a, mask, cen = _operands("thin cover kernel", affs,
                                      mask_to_cover, centers, patchshape)
    n, dev = len(cen), affs.device
    wp, nwords = _geometry(vol, ps)
    pm = torch.empty(_mask_words(n, wp), dtype=torch.int32, device=dev)
    run = torch.empty(nwords, dtype=torch.int32, device=dev)
    state = torch.empty(n, dtype=torch.int32, device=dev)
    cpk = torch.empty(n, dtype=torch.int64, device=dev)
    out = torch.empty(STATS_BYTES + n, dtype=torch.uint8, device=dev)
    max_it = min(default_max_it(n) if max_it is None else int(max_it),
                 2 ** 31 - 1)
    base = out.data_ptr()
    launch(a.data_ptr(), mask.data_ptr(), cen.data_ptr(), n, *vol, *ps,
           float(fc_threshold), MODES[mode], max_it, int(threads),
           int(smem_cap), pm.data_ptr(), run.data_ptr(), state.data_ptr(),
           cpk.data_ptr(), base, base + STATS_BYTES, stream)
    host = out.cpu().numpy()
    stats = _stats(host, THIN_STATS, THIN_CYCLES)
    stats["capped"] = bool(stats["capped"])
    return host[STATS_BYTES:].astype(bool), stats


def _card(kernel: CudaKernel, t: torch.Tensor):
    """(launch, stream) of ``kernel`` on ``t``'s CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{kernel.name} kernel: tensors on {t.device}, not "
                         f"CUDA")
    return (lambda *args: kernel.launch(t.device, *args),
            _P(torch.cuda.current_stream(t.device).cuda_stream))


def cover_cascade_cuda(affs, mask_to_cover, centers, overlap_rows,
                       patchshape, fc_threshold: float, pix_ths,
                       **kw) -> tuple:
    """Launch ``csrc/cover_cascade.cu`` on the CUDA tensor ``affs`` (P,
    *vol): the candidates ``centers`` in ranked order, the bool mask to
    cover and overlap rows on the host.  Returns (selected bool (n,),
    still-uncovered bool volume, statistics)."""
    launch, stream = _card(COVER_CASCADE, affs)
    return run_cover_cascade(launch, affs, mask_to_cover, centers,
                             overlap_rows, patchshape, fc_threshold, pix_ths,
                             stream=stream, **kw)


def thin_cover_cuda(affs, mask_to_cover, centers, patchshape,
                    fc_threshold: float, max_it: int | None = None,
                    **kw) -> tuple:
    """Launch ``csrc/thin_cover.cu`` on the CUDA tensor ``affs``: the lazy
    loop, and where it reached its cap (``max_it`` rounds, by default 64 n
    + 1024) the full loop, as the JAX package falls back
    (cover.py:383-389).  Returns (selected bool (n,), statistics: the lazy
    launch's, and the full launch's under ``"full"`` where it ran)."""
    launch, stream = _card(THIN_COVER, affs)
    selected, stats = run_thin_cover(launch, affs, mask_to_cover, centers,
                                     patchshape, fc_threshold, "lazy",
                                     max_it, stream=stream, **kw)
    if stats["capped"]:
        selected, stats["full"] = run_thin_cover(
            launch, affs, mask_to_cover, centers, patchshape, fc_threshold,
            "full", stream=stream, **kw)
    return selected, stats
