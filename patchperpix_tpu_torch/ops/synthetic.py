"""Synthetic label volumes and their ideal affinities (numpy only).

The port's own copy of what it needs from the JAX package's numpy-only
generators: ``labels_to_affinities`` (``patchperpix_tpu/ops/synthetic.py``),
the worm image of the 2D workload (``scripts/bench_2d.py worm_labels``)
and the tube volume of the blockwise scale case
(``benchmarks/blockwise_scale.py synth_labels``), with the same seeds
giving the same arrays.
"""

from __future__ import annotations

import numpy as np

from .np_reference import patch_offsets


def labels_to_affinities(labels: np.ndarray, patchshape,
                         hi: float = 0.95, lo: float = 0.05) -> np.ndarray:
    """(P, *vol) float32 ideal affinities from an integer label volume:
    channel p at voxel c is ``hi`` iff c is foreground and voxel
    ``c + unravel(p) - rad`` carries the same label, else ``lo``."""
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    offs = patch_offsets(ps)
    vol_shape = np.array(labels.shape)
    affs = np.full((len(offs),) + tuple(vol_shape), lo, dtype=np.float32)
    coords = np.argwhere(labels > 0)
    if len(coords) == 0:
        return affs
    lab = labels[tuple(coords.T)]
    for p in range(len(offs)):
        tgt = coords + offs[p] - rad
        ok = np.all((tgt >= 0) & (tgt < vol_shape), axis=1)
        same = np.zeros(len(coords), dtype=bool)
        if ok.any():
            same[ok] = labels[tuple(tgt[ok].T)] == lab[ok]
        sel = coords[same]
        if len(sel):
            affs[(p,) + tuple(sel.T)] = hi
    return affs


def worm_labels(h: int = 520, w: int = 696, n_worms: int = 16,
                seed: int = 0, with_crossings: bool = False):
    """(1, h, w) int32 labels of ``n_worms`` sinusoidal 5-pixel-wide worms
    (a later worm paints over an earlier one).  With ``with_crossings``
    also the bool (1, h, w) mask of the pixels more than one worm painted:
    the crossing pixels, where an image of overlapping worms holds two
    instances."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((1, h, w), np.int32)
    painted = np.zeros((1, h, w), np.int32)
    lab = 0
    for _ in range(n_worms):
        lab += 1
        y0 = rng.randint(30, h - 30)
        x0 = rng.randint(20, w - 120)
        length = rng.randint(80, 140)
        amp = rng.randint(4, 10)
        phase = rng.rand() * 6.28
        xs = np.arange(x0, min(x0 + length, w - 10))
        ys = (y0 + amp * np.sin(xs / 11.0 + phase)).astype(int)
        ys = np.clip(ys, 3, h - 4)
        for dx, x in enumerate(xs):
            labels[0, ys[dx] - 2:ys[dx] + 3, x] = lab
            painted[0, ys[dx] - 2:ys[dx] + 3, x] += 1
    if with_crossings:
        return labels, painted > 1
    return labels


def synth_labels(n: int, seed: int = 0) -> np.ndarray:
    """(n, n, n) int32 labels of 12 elongated 3x3 tubes along x, wavy in z
    and y (FlyLight-like neurites); a tube step that would touch an
    earlier tube is left out."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((n, n, n), np.int32)
    lab = 0
    for _ in range(12):
        lab += 1
        z0, y0 = rng.randint(10, n - 10, 2)
        amp = rng.randint(3, 8)
        xs = np.arange(5, n - 5)
        zs = (z0 + amp * np.sin(xs / 11.0)).astype(int)
        ys = (y0 + amp * np.cos(xs / 13.0)).astype(int)
        for x, z, y in zip(xs, zs, ys):
            if 2 <= z < n - 2 and 2 <= y < n - 2:
                if labels[z - 1:z + 2, y - 1:y + 2, x].max() == 0:
                    labels[z - 1:z + 2, y - 1:y + 2, x] = lab
    return labels
