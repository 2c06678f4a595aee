"""Device selection and float32 precision for the port's entry points."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    there is no card (the entry points default to ``"cuda"`` and never
    fall back to the CPU on their own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the host")
    return dev


@contextlib.contextmanager
def exact_f32():
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls inside the
    block, restoring the previous flags after it.

    cuDNN runs float32 convolutions in TF32 by default (about three
    decimal digits), which breaks parity with the JAX package's float32
    results; every float32 entry point of the port runs under this."""
    conv = torch.backends.cudnn.allow_tf32
    mm = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
