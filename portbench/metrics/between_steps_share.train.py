"""Share of the profiled window between two training steps on the
device: the ``gap_s`` of the program's span ``train.step``, the device
time from the end of one step to the start of the next (the batch's
copy to the device and the host's gaps), over the window; on the host's
clock where the span has no device time (a CPU run)."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without spans
        return None
    span = summary()["spans"].get("train.step")
    if not span or span["count"] < 2 or trace.window_s <= 0:
        return None
    return 100.0 * span["gap_s"] / trace.window_s
