"""The training step's share of the chip's float32 peak: forward and
backward FLOPs of one step (the U-Net and both heads on the batch, the
code decoder on the sampled codes), counted on the benchmark's reference
network (``counts/flops.py``), times the steps of the profiled part of
the window, over its length and the 67 TFLOP/s float32 peak
(``counts/peaks.py``)."""

from portbench.counts import peaks


def read(trace):
    c = trace.counts
    if not c.get("profiled_steps") or trace.window_s <= 0:
        return None
    return 100.0 * c["profiled_steps"] * c["step_flops"] / trace.window_s \
        / peaks.FP32_FLOPS
