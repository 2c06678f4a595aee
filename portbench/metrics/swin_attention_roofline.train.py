"""The Swin UNETR's window attention against its roofline: the
attention's bound time, the larger of its operations at the float32
peak (67 TFLOP/s) and its least bytes at 3.35 TB/s (``counts/swin.py``:
the products' 4 n^2 head_dim per window and head; q, k, v, the output,
the bias table and the region map once each), times the steps the span
covers, over the device seconds of the program's span ``swin.attention``
(``models/swin_unetr.py``), in percent; host seconds where the span has
no device time (a CPU run).  A program without the span gives
nothing."""

from portbench.counts import peaks


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without spans
        return None
    c = trace.counts
    span = summary()["spans"].get("swin.attention")
    if not span or not c.get("swin_blocks"):
        return None
    s = span["host_s"] if span["device_s"] is None else span["device_s"]
    if s <= 0:
        return None
    steps = span["count"] / c["swin_blocks"]
    bound = max(c["swin_attn_flops"] / peaks.FP32_FLOPS,
                c["swin_attn_bytes"] / peaks.HBM_BYTES_PER_S)
    return 100.0 * steps * bound / s
