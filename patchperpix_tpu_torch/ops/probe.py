"""Probe of the row-window read the 2D kernels' TPU design rested on.

Counterpart of ``scripts/probe_dynslice.py`` of the JAX package, which
checked on Mosaic that an 8-row window can be read at a run-time start
out of ``n_slab`` stacked 8-row slabs.  ``PROBE`` (``csrc/
probe_window.cu``) is the same probe for an NVIDIA GPU, with the window
staged in shared memory (``mode="smem"``) or read from global memory
(``mode="gmem"``); ``probe_window_plain`` is its plain PyTorch version,
the ``want`` loop of that script on tensors.  ``CASES`` are the script's
twelve cases; ``OPT_IN_CASE`` adds one whose staged rows (52 KB) pass the
48 KB a block gets without opting in.  ``scripts/probe_window_cuda.py``
runs them.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel

V = 8  # rows per slab
MODES = {"smem": 0, "gmem": 1}
CASES = tuple((mode, n_slab, W) for mode in MODES for n_slab in (2, 3)
              for W in (696, 720, 768))
OPT_IN_CASE = ("smem", 13, 768)
COLS = 128   # columns per block of the kernel (its staged tile's width)


def staged_bytes(n_slab: int) -> int:
    """Shared memory a block of the smem mode stages."""
    return n_slab * V * COLS * 4

PROBE = CudaKernel(
    "probe_window", "ppp_probe_window",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "scripts/probe_dynslice.py:30 probe (pallas_call :69)")


def _check_input(x: torch.Tensor, n_slab: int):
    if x.ndim != 3 or x.shape[1] != V or x.dtype != torch.float32 \
            or not x.is_contiguous():
        raise ValueError(f"probe: expected contiguous float32 (ZS, {V}, W), "
                         f"got {x.dtype} {tuple(x.shape)}")
    if not 1 <= n_slab <= x.shape[0]:
        raise ValueError(f"probe: n_slab {n_slab} outside [1, {x.shape[0]}]")


def probe_window_plain(x: torch.Tensor, n_slab: int) -> torch.Tensor:
    """out[z] = sum over s in [0, (n_slab - 1) * 8) of rows
    [z * 8 + s, z * 8 + s + 8) of x, times (s + 1); x (ZS, 8, W) ->
    (ZS - n_slab + 1, 8, W)."""
    _check_input(x, n_slab)
    ZS, _, W = x.shape
    flat = x.reshape(ZS * V, W)
    out = torch.zeros((ZS - n_slab + 1, V, W), dtype=torch.float32,
                      device=x.device)
    for z in range(out.shape[0]):
        for s in range((n_slab - 1) * V):
            out[z] += flat[z * V + s:z * V + s + V] * (s + 1)
    return out


def probe_window_cuda(x: torch.Tensor, n_slab: int,
                      mode: str = "smem") -> torch.Tensor:
    """Launch ``csrc/probe_window.cu`` on a CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"probe kernel: tensor on {x.device}, not CUDA")
    _check_input(x, n_slab)
    ZS, _, W = x.shape
    out = torch.empty((ZS - n_slab + 1, V, W), dtype=torch.float32,
                      device=x.device)
    PROBE.launch(x.device, x.data_ptr(), out.data_ptr(), ZS, W, int(n_slab),
                 MODES[mode],
                 ctypes.c_void_p(
                     torch.cuda.current_stream(x.device).cuda_stream))
    return out


def probe_window(x: torch.Tensor, n_slab: int,
                 mode: str = "smem") -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return probe_window_cuda(x, n_slab, mode)
    if x.device.type == "cpu":
        if mode not in MODES:
            raise KeyError(mode)
        return probe_window_plain(x, n_slab)
    raise ValueError(f"probe: no kernel for device {x.device}")


def case_input(n_slab: int, W: int, seed: int = 0) -> torch.Tensor:
    """The seeded input of a case: (8, 8, W), or (n_slab + 1, 8, W) where
    n_slab passes 8."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((max(8, n_slab + 1), V, W), generator=gen)


def run_cases(device="cuda", seed: int = 0, tol: float = 1e-4) -> list:
    """The probe: every case of ``CASES`` and ``OPT_IN_CASE``, kernel
    against plain version.  Returns one dict per case (mode, n_slab, W,
    staged_bytes, max_err, ok); nothing is caught, so a kernel that does
    not build or launch raises."""
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    out = []
    for mode, n_slab, W in CASES + (OPT_IN_CASE,):
        x = case_input(n_slab, W, seed).to(dev)
        got = probe_window(x, n_slab, mode)
        err = float((got - probe_window_plain(x, n_slab)).abs().max())
        out.append({"mode": mode, "n_slab": n_slab, "W": W,
                    "staged_bytes": staged_bytes(n_slab) if mode == "smem"
                    else 0, "max_err": err, "ok": err < tol})
    return out
