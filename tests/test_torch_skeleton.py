"""Port's skeletonization (``utils/skeleton.py`` + ``native/thinning.cpp``)
vs the JAX package's, on the CPU.

The thinning is integer code with a fixed deletion order, so every
skeleton must be equal bit for bit: the port's C++ and Python thinning
against the JAX package's C++ and Python thinning, on the FlyLight crop's
ground-truth channels, seeded random blobs, a tube and the 2D worm image.
"""

import os

import numpy as np
import pytest
from scipy import ndimage

from patchperpix_tpu.utils.skeleton import skeletonize as jax_skeletonize
from patchperpix_tpu_torch import native
from patchperpix_tpu_torch.ops import synthetic
from patchperpix_tpu_torch.utils.io import IoZarr
from patchperpix_tpu_torch.utils.skeleton import skeletonize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = os.path.join(REPO, "data", "JRC_SS05008-20160318_24_B2_crop.zarr")


def _crop_channel(c):
    return IoZarr(CROP).read(key="volumes/gt_instances")[c] > 0


def _blobs(seed):
    rng = np.random.RandomState(seed)
    seeds = rng.rand(24, 20, 28) > 0.985
    return ndimage.binary_dilation(seeds, iterations=2)


def _tube():
    z, y, x = np.mgrid[:30, :30, :30]
    c = 15 + 6 * np.sin(z / 5.0)
    return (y - c) ** 2 + (x - 15) ** 2 <= 9


def _worms():
    return synthetic.worm_labels(120, 240, 4, seed=0)[0] > 0


VOLUMES = {
    "crop_gt_0": lambda: _crop_channel(0),
    "crop_gt_1": lambda: _crop_channel(1),
    "crop_gt_2": lambda: _crop_channel(2),
    "blobs_seed0": lambda: _blobs(0),
    "blobs_seed1": lambda: _blobs(1),
    "tube": _tube,
    "worms_2d": _worms,
    "worms_flat_z": lambda: _worms()[None],
}


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_skeleton_equals_jax_bit_for_bit(name):
    vol = VOLUMES[name]()
    got = skeletonize(vol)
    assert got.dtype == np.uint8 and got.shape == vol.shape
    assert 0 < got.sum() < vol.sum()
    np.testing.assert_array_equal(got, skeletonize(vol, native=False))
    np.testing.assert_array_equal(got, jax_skeletonize(vol))
    np.testing.assert_array_equal(got, jax_skeletonize(vol, native=False))


def _fresh_build(monkeypatch, tmp_path):
    """Make the loader build again, into ``tmp_path``."""
    monkeypatch.setattr(native, "BUILD", str(tmp_path))
    monkeypatch.setattr(native, "_loaded", {})


def test_loader_raises_without_gxx(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        skeletonize(_tube())


def test_loader_raises_with_compiler_stderr(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "GXX_FLAGS",
                        native.GXX_FLAGS + ("--no-such-flag",))
    with pytest.raises(RuntimeError, match="no-such-flag"):
        skeletonize(_tube())


def test_library_named_by_source_and_flags(monkeypatch):
    path = native.lib_path("thinning")
    assert os.path.basename(path).startswith("libthinning-")
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-g",))
    assert native.lib_path("thinning") != path
