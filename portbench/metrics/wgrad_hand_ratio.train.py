"""Share of the training step's 3D ConvPass convolutions whose weight
gradient the program's hand-written kernel computes: the counters
``conv.wgrad_hand`` over ``conv.wgrad_hand`` plus ``conv.wgrad_cudnn``
(``models/unet.py`` ``Conv3d``: one count per call that wants a weight
gradient), inside the loop's traced interval.  A program without these
counters gives nothing."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without counters
        return None
    counts = summary()["counts"]
    hand = counts.get("conv.wgrad_hand", 0)
    total = hand + counts.get("conv.wgrad_cudnn", 0)
    if total <= 0:
        return None
    return hand / total
