"""Sliding-window geometry; counterpart of ``enumerate_shifts`` and
``pad_to_grid`` in ``patchperpix_tpu/infer/predict.py``."""

from __future__ import annotations

import numpy as np


def enumerate_shifts(shape_padded, input_shape, stride):
    """Grid of window origins, snapped so the last window ends exactly at
    the padded boundary."""
    max_shift = [max(0, s - i) for s, i in zip(shape_padded, input_shape)]
    axes = []
    for ms, st in zip(max_shift, stride):
        vals = list(range(0, ms + 1, st))
        if vals[-1] != ms:
            vals.append(ms)
        axes.append(vals)
    shifts = [[]]
    for vals in reversed(axes):
        shifts = [[v] + s for v in vals for s in shifts]
    return [tuple(s) for s in shifts]


def pad_to_grid(raw: np.ndarray, spatial, input_shape, output_shape):
    """Context margins + snap to the output-shape grid.  Returns
    (raw_padded, shape_padded, context)."""
    context = (input_shape - output_shape) // 2
    shape_padded = np.array(
        [(int(s) // int(o) + 1) * int(o) + 2 * int(c)
         for s, o, c in zip(spatial, output_shape, context)])
    raw_padded = np.pad(
        raw, [(0, 0)] + [(int(c), int(sp - s - c))
                         for c, s, sp in zip(context, spatial,
                                             shape_padded)],
        mode="constant")
    return raw_padded, shape_padded, context
