"""The yardstick's counts and inputs: the FLOP counter on a tiny reference
network against a hand count, the reflected volume against numpy's own
padding, and each configuration's stated output extent against the
reference network's."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import PB
from portbench import data
from portbench.counts import flops, peaks
from portbench.reference import model as ref_model


def _tiny():
    return {"num_fmaps": 2, "fmap_inc_factors": [2], "fmap_dec_factors": [1],
            "downsample_factors": [[2, 2, 2]], "num_repetitions": 1,
            "padding": "same", "patchshape": [3, 3, 3], "code_units": 8,
            "max_num_inst": 1,
            "autoencoder": {"code_fmaps": 1, "num_fmaps": [2],
                            "num_repetitions": 1}}


def test_unet_flops_by_hand():
    S = 4 * 4 * 4
    s = 2 * 2 * 2
    mac = (S * 27 * 1 * 2          # level 0: 1 -> 2
           + s * 27 * 2 * 4        # bottom: 2 -> 4
           + s * 8 * 4 * 2         # transposed 2^3: 4 -> 2, over the input
           + S * 27 * 4 * 2        # up pass: 2 + 2 -> 2
           + S * 2 * 8 + S * 2 * 2)   # heads: code 8, numinst 2
    assert flops.unet_flops(_tiny(), 1, (4, 4, 4)) == 2 * mac


def test_decoder_flops_by_hand():
    # code 8 = 1 fmap on 2^3; 1x1 conv 1 -> 2 at 2^3; resize to 4^3 and
    # 1x1 conv 2 -> 1; one 3^3 conv 1 -> 1 at 4^3
    mac = 8 * 1 * 2 + 64 * 2 * 1 + 64 * 27
    assert flops.decoder_flops(_tiny(), 5) == 5 * 2 * mac


def test_peaks():
    assert peaks.FP32_FLOPS == 67e12 and peaks.HBM_BYTES_PER_S == 3.35e12


@pytest.mark.parametrize("seed", range(6))
def test_reflect_to_equals_numpy_pad(seed):
    """The gathered reflection is numpy's "reflect" padding by 2 S on each
    side, cut at the phase, also where the extent spans several periods."""
    rng = np.random.RandomState(seed)
    shape = rng.randint(2, 9, size=3)
    extent = rng.randint(1, 40, size=3)
    phase = [rng.randint(0, 2 * s) for s in shape]
    vol = rng.rand(2, *shape).astype(np.float32)
    big = np.pad(vol, [(0, 0)] + [(2 * s, e + 2 * s)
                                  for s, e in zip(shape, extent)],
                 mode="reflect")
    want = big[(slice(None),) + tuple(slice(p, p + e)
                                      for p, e in zip(phase, extent))]
    np.testing.assert_array_equal(data.reflect_to(vol, extent, phase), want)


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(PB,
                                                               "configs"))))
def test_stated_output_shape_is_the_networks(name):
    with open(os.path.join(PB, "configs", name)) as f:
        cfg = json.load(f)
    got = ref_model.output_shape(ref_model.net_config(cfg),
                                 cfg["model"]["num_channels"],
                                 cfg["train_input_shape"])
    assert list(got) == cfg["train_output_shape"]
