"""The timers and the bound behind PERF.md's kernel table, shared by the
kernel scripts (``time_kernels_3d.py``, ``time_kernels_2d.py``,
``time_cover_kernels.py``, ``probe_window_cuda.py``,
``conv_wgrad_cuda.py``, ``conv_wgrad_gemm_cuda.py``); a module, not a
script.  Imports torch only
inside the timers, so ``bound_ms`` runs without it.
"""

import statistics
from collections import defaultdict

CONS_OPS_PER_TERM = 15   # pp, sc, cnt: 4 ops each + 3 accumulations
RANK_OPS_PER_TERM = 7    # w_hh, w_hl (3), difference, product, sum


def time_pair(plain_fn, kernel_fn, dev, rounds=2):
    """Median ms of each, timed in turns plain, kernel, kernel, plain."""
    import torch

    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)

    plain, kernel = [], []
    for _ in range(rounds):
        plain.append(once(plain_fn))
        kernel.append(once(kernel_fn))
        kernel.append(once(kernel_fn))
        plain.append(once(plain_fn))
    return statistics.median(kernel), statistics.median(plain)


def bound_ms(nbytes, ops):
    """Least time for the work: bytes over the memory rate or operations
    over the f32 rate (outside the tensor cores), whichever is larger, at
    the H100 SXM5's published peaks (``utils/roofline.H100_SXM5``)."""
    from patchperpix_tpu_torch.utils.roofline import H100_SXM5

    tb = nbytes / (H100_SXM5.hbm_gbps * 1e9) * 1e3
    to = ops / (H100_SXM5.fp32_tflops * 1e12) * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def kernel_row(kernel, err, ms, plain_ms, bound, library_ms=None):
    """One row of PERF.md's kernel table."""
    return {"name": kernel.name, "source": kernel.source,
            "replaces": kernel.replaces.split(" ")[0], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def pair_terms(hi, lo) -> float:
    """The pixel pairs the consensus and rank sums need: at each eligible
    center, both pixels hi or lo, not both lo."""
    elig = ((hi != 0) | (lo != 0)).sum(0).double()
    n_lo = (lo != 0).sum(0).double()
    return float((elig * (elig - 1) / 2 - n_lo * (n_lo - 1) / 2).sum())


def event_ms(fn, dev, rounds):
    """Median and minimum ms of ``rounds`` calls after one warm-up (CUDA
    events)."""
    import torch

    fn()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        out.append(start.elapsed_time(end))
    return {"median": statistics.median(out), "min": min(out)}


def device_ms(fn, dev, rounds):
    """Median device time of each kernel / memset name over ``rounds``
    profiled launches (a name launched k times in one call counts k
    times its median)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    by_name = defaultdict(list)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize(dev)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name].append(e.device_time if hasattr(e, "device_time")
                                   else e.cuda_time)
    return {n[:80]: statistics.median(v) * len(v) / rounds / 1e3
            for n, v in by_name.items()}
