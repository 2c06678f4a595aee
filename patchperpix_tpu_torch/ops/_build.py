"""Build the CUDA sources under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C interface (pointers and the
stream as ``void*``, each entry point returning ``cudaGetLastError()``)
and is compiled at first use, one ``nvcc`` process per source, all started
together:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so <name>.cu

into ``patchperpix_tpu_torch/build/`` (listed in ``.gitignore``).  The
file name carries a hash of the source, of every header ``csrc/*.cuh``
(sources include them) and of the flags, so an edited source is rebuilt.
The library is loaded once per process.  ``CudaKernel`` is one entry
point of such a library with its launch count.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built with the CUDA toolkit on the GPU machine")


def lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names) -> dict:
    """Compile the sources not built yet, in parallel.  Returns
    {name: {"seconds": wall time of its nvcc, "log": nvcc/ptxas output}}
    (seconds 0.0 and an empty log for a library already built).  Raises
    RuntimeError with nvcc's output if a build fails."""
    os.makedirs(BUILD, exist_ok=True)
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            info[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if p.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = lib_path(name)
        if not os.path.exists(path):
            build([name])
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]


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
        """Run the kernel's entry point and count the launch."""
        self.call(self.symbol, self.argtypes, *args)
        self.launches += 1

    def call(self, symbol: str, argtypes, *args):
        """Run another entry point of the same library (a step that sizes
        the kernel's scratch), not counted as a launch; raises on a CUDA
        error."""
        lib = load(self.name)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = fn(*args)
        if err != 0:
            msg = getattr(lib, f"ppp_{self.name}_error_string")
            msg.argtypes = [ctypes.c_int]
            msg.restype = ctypes.c_char_p
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err} ({msg(err).decode()})")
