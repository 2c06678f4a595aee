"""Port's fused predict/decode vs the JAX package's, trained crop model,
float32, on a 24^3 subcrop of the FlyLight fixture.

Tolerance 1e-4 absolute: float32 on both sides, convolution sums in
another order (measured differences are ~1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import bench
from patchperpix_tpu.infer.fused import decode_volume_device as jax_decode
from patchperpix_tpu.infer.fused import predict_volume_device as jax_predict
from patchperpix_tpu.models import PPPModel as JModel
from patchperpix_tpu_torch.infer.fused import (decode_volume_device,
                                               predict_volume_device)
from patchperpix_tpu_torch.infer.predict import enumerate_shifts, pad_to_grid
from patchperpix_tpu_torch.models import PPPConfig
from patchperpix_tpu_torch.weights import build_model

torch.set_num_threads(1)

S = 24


@pytest.fixture(scope="module")
def trained():
    jm, jcfg = bench.crop_model()
    params = bench.load_trained_params(jm, jcfg)
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    cfg = PPPConfig(**{f.name: getattr(jcfg, f.name)
                       for f in dataclasses.fields(jcfg)})
    return JModel(jcfg), jcfg, params, cfg, build_model(cfg, device="cpu")


def test_predict_and_decode_match_jax(trained):
    jm, jcfg, params, cfg, model = trained
    raw = bench.load_raw_clip()[:, :S, :S, :S]
    win = (S, S, S)
    code_j, prob_j = jax_predict(jm, params, raw, jcfg, win, win)
    code, prob = predict_volume_device(model, raw, cfg, win, win,
                                       device="cpu")
    np.testing.assert_allclose(code.numpy(), np.asarray(code_j), atol=1e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(prob_j), atol=1e-4)
    fg = np.asarray(prob_j)[1:].max(0) > 0.5
    assert 100 < fg.sum() < S ** 3
    dec_j = jax_decode(jm, params, code_j, fg, jcfg, batch_size=1000)
    dec = decode_volume_device(model, torch.from_numpy(np.array(code_j)),
                               fg, cfg, batch_size=1000, device="cpu")
    assert dec.shape == (343, S, S, S)
    np.testing.assert_allclose(dec.numpy(), np.asarray(dec_j), atol=1e-4)
    assert np.all(dec.numpy()[:, ~fg] == 0)


def test_window_geometry_matches_jax():
    from patchperpix_tpu.infer import predict as jp

    for shape, inp, out in [((50, 50, 50), (52,) * 3, (52,) * 3),
                            ((60, 31, 45), (40, 40, 40), (20, 20, 20))]:
        raw = np.zeros((1,) + shape, np.float32)
        sp, i, o = np.array(shape), np.array(inp), np.array(out)
        a = pad_to_grid(raw, sp, i, o)
        b = jp.pad_to_grid(raw, sp, i, o)
        assert a[0].shape == b[0].shape
        np.testing.assert_array_equal(a[1], b[1])
        assert enumerate_shifts(a[1], i, o) == jp.enumerate_shifts(b[1], i,
                                                                     o)


def test_entry_points_raise_without_cuda(trained):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, _, _, cfg, model = trained
    raw = np.zeros((3, 8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_volume_device(model, raw, cfg, (8,) * 3, (8,) * 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_volume_device(model, torch.zeros(176, 4, 4, 4),
                             np.ones((4, 4, 4), bool), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
