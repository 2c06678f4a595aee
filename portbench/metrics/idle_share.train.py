"""Share of the traced window in which no kernel ran on the device: one
minus the union of the profiler's device-kernel intervals over the
window."""


def read(trace):
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
