"""Multi-process sample fan-out.

Counterpart of ``patchperpix_tpu/parallel/multihost.py``: inference and
assembly scale over processes (one per host, or one per card) by a
deterministic round-robin partition of the sample list; each process runs
its share against the shared experiment folder (results are
single-writer per sample, so nothing else is coordinated), with the
CLI's skip-if-exists resume.  Data-parallel training scales over the
cards of one process instead (``train/trainer.py``'s mesh).

Launch N processes with ``torch.distributed`` initialised (world size N),
or with ``PPP_PROCESS_INDEX`` / ``PPP_PROCESS_COUNT`` set, all pointing at
the same experiment folder; each CLI stage then handles the samples for
which ``owns_sample(i)`` holds.
"""

from __future__ import annotations

import os


def process_identity() -> tuple[int, int]:
    """(process index, process count): the ``torch.distributed`` rank and
    world size when it is initialised with more than one rank, else the
    PPP_PROCESS_INDEX / PPP_PROCESS_COUNT environment variables, else
    (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("PPP_PROCESS_INDEX", 0)),
            int(os.environ.get("PPP_PROCESS_COUNT", 1)))


def owns_sample(i: int, index: int | None = None,
                count: int | None = None) -> bool:
    """Round-robin ownership of sample ``i`` for this process."""
    if index is None or count is None:
        index, count = process_identity()
    return count <= 1 or i % count == index


def shard_samples(samples, index: int | None = None,
                  count: int | None = None) -> list:
    """The subset of ``samples`` this process owns (deterministic
    round-robin; stable across restarts for resume)."""
    return [s for i, s in enumerate(samples) if owns_sample(i, index, count)]
