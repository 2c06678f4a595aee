"""Real tokens per token the Swin UNETR's window attention attends: the
program's counters ``swin.tokens`` over ``swin.window_tokens``
(``models/swin_unetr.py``: per block call, a stage's tokens and the
tokens of its extent padded to window multiples), inside the loop's
traced interval.  0.886 at 96^3 crops.  A program without the counters
gives nothing."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without counters
        return None
    counts = summary()["counts"]
    padded = counts.get("swin.window_tokens", 0)
    if "swin.tokens" not in counts or padded <= 0:
        return None
    return counts["swin.tokens"] / padded
