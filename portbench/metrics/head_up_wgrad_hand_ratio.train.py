"""Share of the training step's head and upsampling convolutions whose
weight gradient the program's hand-written kernels compute: the counters
``conv.head_up_wgrad_hand`` over ``conv.head_up_wgrad_hand`` plus
``conv.head_up_wgrad_cudnn`` (``models/unet.py``: one count per call that
wants a weight gradient of a 3D head, a transposed convolution or an
upsampling pointwise convolution), inside the loop's traced interval.  A
program without these counters gives nothing."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without counters
        return None
    counts = summary()["counts"]
    hand = counts.get("conv.head_up_wgrad_hand", 0)
    total = hand + counts.get("conv.head_up_wgrad_cudnn", 0)
    if total <= 0:
        return None
    return hand / total
