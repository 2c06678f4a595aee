"""Share of the profiled window that the device spends in the Swin
UNETR's convolutional decoder in the forward: the span ``swin.decoder``
of the program's ``models/swin_unetr.py`` (the residual instance-norm
blocks and the up blocks), its device seconds over the window; host
seconds where the span has no device time (a CPU run).  A program
without the span gives nothing."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without spans
        return None
    span = summary()["spans"].get("swin.decoder")
    if not span or trace.window_s <= 0:
        return None
    s = span["host_s"] if span["device_s"] is None else span["device_s"]
    return 100.0 * s / trace.window_s
