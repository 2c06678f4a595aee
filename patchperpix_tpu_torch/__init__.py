"""PatchPerPix on PyTorch and CUDA (NVIDIA Hopper).

A port of ``patchperpix_tpu`` (the JAX/Pallas reference, which stays
beside it unchanged).  It imports neither JAX nor anything of the JAX
package.  Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; the consensus and rank stages run hand-written CUDA
kernels (``csrc/``) on the card and their plain PyTorch versions on the
CPU.
"""
