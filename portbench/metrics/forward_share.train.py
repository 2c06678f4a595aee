"""Share of the profiled window that the device spends in the training
step's forward: the span ``train.forward`` of the program's
``train/trainer.py`` ``make_train_step`` (the gradients dropped, heads,
codes, decoder, losses, summaries), its device seconds over the window;
host seconds where the span has no device time (a CPU run)."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without spans
        return None
    span = summary()["spans"].get("train.forward")
    if not span or trace.window_s <= 0:
        return None
    s = span["host_s"] if span["device_s"] is None else span["device_s"]
    return 100.0 * s / trace.window_s
