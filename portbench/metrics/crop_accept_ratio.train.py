"""Crops the host sampler returns per crop it draws: the program's
counters ``train.crops`` over ``train.crops_drawn`` (``train/data.py``
``CropSampler.one_crop``, whose ``min_masked`` rejection loop draws
again while a crop holds too little foreground), inside the loop's
traced interval."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without counters
        return None
    counts = summary()["counts"]
    drawn = counts.get("train.crops_drawn", 0)
    if drawn <= 0:
        return None
    return counts.get("train.crops", 0) / drawn
