"""Host C++ components, built with g++ at first use and bound with ctypes.

Counterpart of ``patchperpix_tpu/native/__init__.py``.  ``thinning.cpp``
(the port's copy of the JAX package's source) is compiled as

    g++ -O3 -shared -fPIC -std=c++17 thinning.cpp -o libthinning-<hash>.so

into ``patchperpix_tpu_torch/build/`` (listed in ``.gitignore``); the name
carries a hash of the source and the flags, so an edited source is
rebuilt.  The library is loaded once per process under a lock (``label``
may assemble samples on threads).

There is no silent fallback: a failed build raises, naming the compiler
and its stderr.  The Python thinning (``utils/skeleton.py``) is reached
only by an explicit ``native=False``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(SRC_DIR), "build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: dict = {}
_lock = threading.Lock()


def lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(SRC_DIR, name + ".cpp"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless it is built; returns the
    library's path.  Raises RuntimeError naming the compiler and its
    stderr when g++ is missing or fails."""
    out = lib_path(name)
    if os.path.exists(out):
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: native/{name}.cpp "
                           "cannot be built")
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [gxx, *GXX_FLAGS, os.path.join(SRC_DIR, name + ".cpp"), "-o", tmp]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"{gxx} failed (exit {r.returncode}) on "
                           f"native/{name}.cpp:\n{r.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``native/<name>.cpp``, built first if needed."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(build(name))
        return _loaded[name]


def _thin(symbol: str, volume: np.ndarray) -> np.ndarray:
    fn = getattr(load("thinning"), symbol)
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.POINTER(ctypes.c_uint8)] + \
        [ctypes.c_longlong] * volume.ndim
    vol = np.ascontiguousarray(volume > 0, dtype=np.uint8)
    fn(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), *vol.shape)
    return vol


def skeletonize_3d_native(volume: np.ndarray) -> np.ndarray:
    """C++ 3D thinning of a (Z, Y, X) mask; uint8 0/1."""
    return _thin("ppp_skeletonize_3d", volume)


def skeletonize_2d_native(image: np.ndarray) -> np.ndarray:
    """C++ 2D thinning (8/4-connectivity) of a (Y, X) mask; uint8 0/1."""
    return _thin("ppp_skeletonize_2d", image)
