"""The port's roofline helper against the JAX package's, on the CPU.

The cost model is the JAX package's: every cost function gives the same
FLOPs and bytes for the same shapes, and ``analyze`` /
``assembly_mfu_summary`` give the same values for a ``ChipPeaks`` of
equal numbers, the JAX unit names ("mxu", "vpu") read as the card's
("tensor", "fp32").  The peaks are this card's: a card without published
figures raises.
"""

import pytest
import torch

from patchperpix_tpu.utils import roofline as J
from patchperpix_tpu_torch.utils import roofline as T

UNIT = {"mxu": "tensor", "vpu": "fp32"}
SHAPES = [((50, 50, 50), (7, 7, 7)), ((1, 520, 696), (1, 25, 25)),
          ((12, 30, 41), (3, 5, 3)), ((100, 100, 100), (7, 7, 7))]


def _same(t, j):
    assert (t.flops, t.hbm_bytes, t.unit) == (j.flops, j.hbm_bytes,
                                              UNIT[j.unit])


def _peaks(a, b, c):
    return (T.ChipPeaks("card", a, b, c), J.ChipPeaks("card", a, b, c))


def _renamed(jd):
    return {k.replace("_mxu_", "_tensor_").replace("_vpu_", "_fp32_"): v
            for k, v in jd.items()}


@pytest.mark.parametrize("vol,ps", SHAPES)
@pytest.mark.parametrize("bf16", [False, True])
def test_costs_equal_jax(vol, ps, bf16):
    _same(T.consensus_cost(vol, ps, bf16), J.consensus_cost(vol, ps, bf16))
    _same(T.rank_cost(vol, ps, bf16), J.rank_cost(vol, ps, bf16))
    for n in (0, 1, 68121):
        _same(T.graph_cost(n, ps, bf16), J.graph_cost(n, ps, bf16))


@pytest.mark.parametrize("kw", [
    dict(vol_shape=(52, 52, 52), num_fmaps=20, fmap_inc=3, levels=3,
         in_ch=1),
    dict(vol_shape=(512, 512), num_fmaps=32, fmap_inc=2, levels=4, in_ch=1,
         ndim=2),
    dict(vol_shape=(156, 156, 156), num_fmaps=12, fmap_inc=5, levels=2,
         in_ch=2, kernel_size=5, reps=3),
])
def test_unet_cost_equals_jax(kw):
    _same(T.unet_cost(**kw), J.unet_cost(**kw))


@pytest.mark.parametrize("peaks", [(989.0, 67.0, 3350.0),
                                   (197.0, 7.5, 819.0), (0.1, 0.05, 20.0)])
@pytest.mark.parametrize("wall", [1e-4, 0.0123, 3.7])
def test_analyze_equals_jax(peaks, wall):
    tp, jp = _peaks(*peaks)
    for vol, ps in SHAPES:
        for tc, jc in ((T.consensus_cost(vol, ps), J.consensus_cost(vol, ps)),
                       (T.graph_cost(517, ps, True),
                        J.graph_cost(517, ps, True)),
                       (T.unet_cost(vol, 20, 3, 2, 1),
                        J.unet_cost(vol, 20, 3, 2, 1))):
            assert T.analyze(tc, wall, tp) == _renamed(J.analyze(jc, wall,
                                                                 jp))


@pytest.mark.parametrize("stages", [
    {"consensus": 0.0021, "rank": 0.0016, "graph": 0.2},
    {"consensus+rank": 0.0037, "graph": 0.2},
    {"consensus": 0.004}, {"graph": 0.1}])
@pytest.mark.parametrize("n_pairs", [0, 68121])
def test_assembly_summary_equals_jax(stages, n_pairs):
    tp, jp = _peaks(989.0, 67.0, 3350.0)
    got = T.assembly_mfu_summary((50, 50, 50), (7, 7, 7), n_pairs, stages,
                                 peaks=tp)
    want = J.assembly_mfu_summary((50, 50, 50), (7, 7, 7), n_pairs, stages,
                                  peaks=jp)
    assert got == {k: _renamed(v) for k, v in want.items()}
    assert set(got) == set(want)


def test_chip_peaks(monkeypatch):
    """The H100 SXM5's datasheet figures by its device name, the JAX
    package's CPU estimate for the CPU, and a raise for any other card."""
    cpu = T.chip_peaks("cpu")
    j = J.chip_peaks("cpu")
    assert (cpu.tensor_bf16_tflops, cpu.fp32_tflops, cpu.hbm_gbps) == (
        j.mxu_bf16_tflops, j.vpu_f32_tflops, j.hbm_gbps)
    h = T.peaks_for_name("NVIDIA H100 80GB HBM3")
    assert (h.tensor_bf16_tflops, h.fp32_tflops, h.hbm_gbps,
            h.tensor_tf32_tflops) == (989.0, 67.0, 3350.0, 494.7)
    assert h.hbm_gbps * 1e9 == 3.35e12 and h.fp32_tflops * 1e12 == 67e12
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "TPU v5e"):
        with pytest.raises(KeyError, match="no published peaks"):
            T.peaks_for_name(name)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 PCIe")
    with pytest.raises(KeyError, match="H100 PCIe"):
        T.chip_peaks("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert T.chip_peaks("cuda:0") is h
    assert T.analyze(T.rank_cost((8, 8, 8), (3, 3, 3)), 1.0)["chip"] \
        == h.name
    with pytest.raises(KeyError):
        T.chip_peaks("meta")


def test_roofline_bound_of_the_kernel_table():
    """The kernel table's bounds (``scripts/kernel_timing.bound_ms``):
    bytes over the card's memory rate or operations over its f32 rate,
    with the helper's figures."""
    from scripts.kernel_timing import bound_ms

    nbytes, ops = 1.2775e9, 15 * 1.0e9
    assert bound_ms(nbytes, ops) == (nbytes / 3.35e12 * 1e3, "bytes")
    assert bound_ms(1.0, 1e12) == (1e12 / 67e12 * 1e3, "operations")
