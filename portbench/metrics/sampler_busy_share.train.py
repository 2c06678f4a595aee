"""Share of the profiled window in which the prefetch thread is busy
producing batches: host seconds of the program's span ``train.sample``
(``train/data.py`` ``Prefetcher._work`` around ``CropSampler.batch``),
clipped to the loop's traced interval, over the window.  Near 100 % the
host sampler sets the pace."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without spans
        return None
    span = summary()["spans"].get("train.sample")
    if not span or trace.window_s <= 0:
        return None
    return 100.0 * span["host_s"] / trace.window_s
