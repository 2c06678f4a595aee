"""Share of the window the training loop spends blocked in the host data
layer's ``Prefetcher.next()`` (the benchmark's span around it), over the
whole window of the traced run."""


def read(trace):
    s = trace.spans.seconds.get("data_wait")
    w = trace.counts.get("window_s", 0.0)
    if s is None or w <= 0:
        return None
    return 100.0 * s / w
