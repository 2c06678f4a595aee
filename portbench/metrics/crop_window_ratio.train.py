"""Crops the host sampler renders only in their output windows, per crop
it returns: the program's counters ``train.crops_windowed`` over
``train.crops`` (``train/data.py`` ``CropSampler.one_crop``; the elastic
path, which makes the crop at its whole union extent, is not counted),
inside the loop's traced interval.  A program without the counter gives
nothing."""


def read(trace):
    try:
        from patchperpix_tpu_torch.utils.trace import summary
    except ImportError:   # a program without counters
        return None
    counts = summary()["counts"]
    crops = counts.get("train.crops", 0)
    if "train.crops_windowed" not in counts or crops <= 0:
        return None
    return counts["train.crops_windowed"] / crops
