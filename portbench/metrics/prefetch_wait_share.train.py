"""Share of the profiled window that the training loop spends blocked on
the host data layer: host seconds of the program's span
``train.data_wait`` (``train/data.py`` ``Prefetcher.next``, around the
queue's ``get``) over the window."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without spans
        return None
    span = summary()["spans"].get("train.data_wait")
    if not span or trace.window_s <= 0:
        return None
    return 100.0 * span["host_s"] / trace.window_s
