"""Host rehearsal of the consensus and rank CUDA kernels, 3D
(``csrc/consensus.cu``, ``csrc/rank.cu``, with ``csrc/pack_codes.cuh``) and
2D (``csrc/consensus2d.cu``, ``csrc/rank2d.cu``), with
``csrc/fill_zero.cuh``, of the row-window probe (``csrc/probe_window.cu``)
of the cover loops (``csrc/cover_cascade.cu``, ``csrc/thin_cover.cu``,
with ``csrc/cover_window.cuh``) and of the convolutions' weight gradients
(``csrc/conv3d_wgrad.cu``, ``csrc/conv_wgrad_gemm.cu``): compiled by g++
against the small mock of the CUDA headers in ``tests/cuda_mock/`` and run
on the CPU, the grid as loops and one host thread per CUDA thread of a
block, against their plain versions at tiny shapes.

This checks the kernels' indexing, gates and sums before any time on a
card is spent; what only nvcc and the card can say (that the source
builds for sm_90a, launch limits, the asynchronous copies, which the mock
takes as plain loads) is left to ``tests/test_torch_cuda.py``.  Skips
where g++ is missing.

Tolerances as for the kernels on the card: consensus 1e-4 absolute and
relative (2^-7 relative for a bf16 half), rank 1e-3 absolute / 1e-4
relative, the probe 1e-4 absolute (it sums in the plain version's order,
so it is also held to equal bits); the pack pass's words and planes are
compared exactly, and so are the cover loops' selections and
still-uncovered volumes (their counts are integers); the weight gradients
within 1e-5 of its largest value against the plain version in float64
(float32 sums in split-K order), and equal bits from two runs.
"""

import ctypes
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
from patchperpix_tpu_torch.ops import conv_kernels as WG
from patchperpix_tpu_torch.ops import cover as COV
from patchperpix_tpu_torch.ops import cover_kernels as CK
from patchperpix_tpu_torch.ops import probe as PR
from patchperpix_tpu_torch.ops._build import CSRC

torch.set_num_threads(1)

MOCK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda_mock")
_LAUNCH = re.compile(
    r"(\b[\w:]+(?:<[^;<>()]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)
_DYN_SMEM = re.compile(r"extern\s+__shared__\s+([\w ]+?)\s+(\w+)\[\];")


def _split_top(text):
    """Split at the commas outside parentheses."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<"
        depth -= ch in ")>"
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def host_source(text):
    """A CUDA source as C++ for the mock: launches as PPP_MOCK_LAUNCH,
    dynamic shared memory as a pointer into the launch's buffer."""
    def launch(m):
        cfg = _split_top(m.group(2))
        grid, block = cfg[0], cfg[1]
        smem = cfg[2] if len(cfg) > 2 else "0"
        return (f"PPP_MOCK_LAUNCH({grid}, {block}, {smem}, "
                f"{m.group(1)}({m.group(3)}));")

    text = _LAUNCH.sub(launch, text)
    return _DYN_SMEM.sub(
        r"\1* \2 = reinterpret_cast<\1*>(ppp_mock::dyn_smem);", text)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: ctypes library} of the sources built for the host."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("kernel_mock")
    for fname in os.listdir(CSRC):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, fname)) as f:
                src = host_source(f.read())
            name = fname.replace(".cu", ".cpp") if fname.endswith(".cu") \
                else fname
            with open(out / name, "w") as f:
                f.write(src)
    built = {}
    # rank_rounds: the rank kernel with room for few items, so that a block
    # needs several rounds over its lanes at these shapes; thin_cover_list2:
    # the thin cover refreshing at most two stale entries a round
    for name, src, flags in (("consensus", "consensus", []),
                             ("rank", "rank", []),
                             ("rank_rounds", "rank",
                              ["-DPPP_RANK_ITEMS_MIN=50"]),
                             ("consensus2d", "consensus2d", []),
                             ("rank2d", "rank2d", []),
                             ("rank2d_rounds", "rank2d",
                              ["-DPPP_RANK_ITEMS_MIN=50"]),
                             ("probe_window", "probe_window", []),
                             ("cover_cascade", "cover_cascade", []),
                             ("thin_cover", "thin_cover", []),
                             ("thin_cover_list2", "thin_cover",
                              ["-DPPP_THIN_LIST=2"]),
                             ("conv3d_wgrad", "conv3d_wgrad", []),
                             ("conv_wgrad_gemm", "conv_wgrad_gemm", [])):
        so = out / f"lib{name}_host.so"
        subprocess.run(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", *flags,
             "-I", MOCK, "-I", str(out), "-o", str(so),
             str(out / f"{src}.cpp")], check=True, capture_output=True,
            text=True)
        built[name] = ctypes.CDLL(str(so))
    return built


def test_host_source_rewrites_launches():
    src = host_source(
        "extern __shared__ uint2 smem[];\n"
        "k<ST, true><<<(unsigned)blocks, block, smem, s>>>(\n"
        "    static_cast<const ST*>(S), acc);")
    assert "<<<" not in src and "extern" not in src
    assert "uint2* smem = reinterpret_cast<uint2*>(ppp_mock::dyn_smem);" \
        in src
    assert "PPP_MOCK_LAUNCH((unsigned)blocks, block, smem, k<ST, true>(" \
        in src


def _inputs(ps, shape, seed, disjoint=True):
    """General 0/1 masks (nonzero at border centers too; hi and lo
    disjoint, as the thresholds make them, or not) and affinities."""
    rng = np.random.RandomState(seed)
    P = int(np.prod(ps))
    hi = (rng.rand(P, *shape) > 0.6).astype(np.float32)
    lo = (rng.rand(P, *shape) > 0.6).astype(np.float32)
    if disjoint:
        lo = lo * (1 - hi)
    dead = rng.rand(*shape) > 0.5       # centers with no live pixel
    hi[:, dead] = 0
    lo[:, dead] = 0
    affs = rng.rand(P, *shape).astype(np.float32)
    return (torch.from_numpy(affs), torch.from_numpy(hi),
            torch.from_numpy(lo))


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


_MODES = {"norm_prob_product": 0, "prob_product": 1, "count": 2}


def _check_vals(vals, a, b, hi, lo):
    """The pack pass's centre-major values: a - b under any bit, b under
    the lo bit."""
    any_bit = ((hi != 0) | (lo != 0)).movedim(0, -1)
    assert torch.equal(vals[0][any_bit], (a - b).movedim(0, -1)[any_bit])
    lo_bit = (lo != 0).movedim(0, -1)
    assert torch.equal(vals[1][lo_bit], b.movedim(0, -1)[lo_bit])


def _consensus_host(lib, affs, hi, lo, cfg):
    vol = tuple(hi.shape[1:])
    a, b = (affs * hi).contiguous(), ((1.0 - affs) * lo).contiguous()
    out = torch.full(K._half_shape(cfg, vol), 7.0,
                     dtype=torch.bfloat16 if cfg.cons_bf16
                     else torch.float32)
    codes, targets = (torch.full_like(t, 3) for t in
                      K._pack_scratch(cfg, vol, "cpu", targets=True))
    vals = torch.full((2,) + vol + (cfg.P,), 9.0)
    fn = lib.ppp_consensus_half
    fn.argtypes = K.CONSENSUS.argtypes
    fn.restype = ctypes.c_int
    err = fn(_ptr(a), _ptr(b), _ptr(hi), _ptr(lo), _ptr(out),
             int(cfg.cons_bf16), *vol, *(int(p) for p in cfg.ps),
             _MODES[cfg.weight_mode], float(cfg.patch_threshold),
             int(cfg.norm_aff), _ptr(codes), _ptr(targets), _ptr(vals), None)
    assert err == 0
    _check_vals(vals, a, b, hi, lo)
    return out, codes, targets


def _rank_host(lib, hi, lo, half, cfg):
    vol = tuple(hi.shape[1:])
    acc = torch.full(vol, 7.0)
    codes, elig = (torch.full_like(t, 3) for t in
                   K._pack_scratch(cfg, vol, "cpu", targets=False))
    fn = lib.ppp_rank_half
    fn.argtypes = K.RANK.argtypes
    fn.restype = ctypes.c_int
    err = fn(_ptr(hi), _ptr(lo), _ptr(half),
             int(half.dtype == torch.bfloat16), _ptr(acc), *vol,
             *(int(p) for p in cfg.ps), int(cfg.rank_int_counter),
             _ptr(codes), _ptr(elig), None)
    assert err == 0
    return acc, codes, elig


CASES = [
    ((3, 3, 3), (5, 6, 7), {}),
    ((3, 3, 3), (4, 5, 9), {"weight_mode": "count", "norm_aff": False}),
    ((3, 3, 3), (4, 5, 9), {"weight_mode": "prob_product"}),
    ((3, 3, 3), (5, 6, 7), {"cons_bf16": True}),
    ((1, 5, 3), (3, 7, 6), {"patch_threshold": 0.6}),
    ((3, 5, 3), (4, 6, 5), {}),          # 45 pixels: two code words
    ((3, 3, 3), (5, 6, 7), {"overlapping_masks": True}),
]


@pytest.mark.parametrize("ps,shape,kw", CASES)
def test_consensus_source_matches_plain_on_host(libs, ps, shape, kw):
    kw = dict(kw)
    disjoint = not kw.pop("overlapping_masks", False)
    cfg = C.ConsensusConfig(patchshape=ps, **kw)
    affs, hi, lo = _inputs(ps, shape, 1, disjoint)
    assert disjoint != bool((hi * lo).any())
    got, codes, targets = _consensus_host(libs["consensus"], affs, hi, lo,
                                          cfg)
    assert torch.equal(codes, K.pack_target_codes(hi, lo, cfg))
    assert torch.equal(targets, K.pack_codes(hi, lo, cfg)[2])
    want = C.consensus_half_plain(affs, hi, lo, cfg)
    assert float(want.float().abs().max()) > 0.1
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -7 if cfg.cons_bf16 else 1e-4)


@pytest.mark.parametrize("ps,shape,kw", [
    ((3, 3, 3), (5, 6, 7), {}),
    ((3, 3, 3), (5, 6, 7), {"rank_int_counter": True}),
    ((1, 5, 3), (3, 7, 6), {}),
    ((3, 5, 3), (4, 6, 5), {}),
    ((3, 5, 3), (4, 6, 5), {"rank_int_counter": True}),
])
@pytest.mark.parametrize("bf16,lib", [(False, "rank"), (True, "rank"),
                                      (False, "rank_rounds")])
def test_rank_source_matches_plain_on_host(libs, ps, shape, kw, bf16, lib):
    cfg = C.ConsensusConfig(patchshape=ps, **kw)
    _, hi, lo = _inputs(ps, shape, 2)
    rng = np.random.RandomState(3)
    half = torch.from_numpy(rng.randn(*K._half_shape(cfg, shape)).astype(
        np.float32))
    half[:, :, :, 1] = 0            # exact zeros for the int_counter variant
    if bf16:
        half = half.to(torch.bfloat16)
    got, codes, elig = _rank_host(libs[lib], hi, lo, half, cfg)
    want_codes, want_elig, _ = K.pack_codes(hi, lo, cfg)
    assert torch.equal(codes, want_codes) and torch.equal(elig, want_elig)
    want = C.rank_acc_plain(hi, lo, half, cfg)
    assert float(want.abs().max()) > 1.0
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


def test_host_kernels_on_all_zero_masks(libs):
    cfg = C.ConsensusConfig(patchshape=(3, 3, 3))
    shape = (4, 5, 6)
    z = torch.zeros((27,) + shape)
    half, codes, targets = _consensus_host(
        libs["consensus"], torch.rand((27,) + shape), z, z, cfg)
    assert not half.any() and not codes.any() and not targets.any()
    acc, _, _ = _rank_host(libs["rank"], z, z,
                           torch.randn(K._half_shape(cfg, shape)), cfg)
    assert not acc.any()


def _gated_2d(p, shape, seed, cfg, center_frac=None):
    """The 2D kernels' operands (ag, tgt) from bimodal affinities of a
    (1, H, W) image: about half of it foreground; an overlap block under
    ``overlapping_inst``; with ``center_frac`` only that share of the
    centers valid."""
    rng = np.random.RandomState(seed)
    a = rng.rand(p * p, *shape).astype(np.float32)
    a = np.where(a > 0.45, 0.6 + 0.4 * a, 0.4 * a).astype(np.float32)
    affs = torch.from_numpy(a)
    ov = torch.zeros(shape, dtype=torch.bool)
    ov[0, 2:4, 3:9] = True
    cv = None
    if center_frac is not None:
        cv = torch.from_numpy(rng.rand(*shape) < center_frac)
    return C.gated_stack_2d(affs, cfg, ov, cv)


def _consensus2d_host(lib, ag, tgt, cfg):
    """The wrapper's steps (``consensus_kernels._consensus2d_launch``)
    against the host library: (half, idx, pix, G)."""
    _, H, W = ag.shape
    p = int(cfg.ps[1])
    out = torch.full((p, 2 * p - 1, H, W), 7.0,
                     dtype=torch.bfloat16 if cfg.cons_bf16
                     else torch.float32)
    row_off = torch.full((H + 1,), 5, dtype=torch.int32)
    count = lib.ppp_consensus2d_count
    count.argtypes = K.CONSENSUS2D_COUNT[1]
    count.restype = ctypes.c_int
    assert count(_ptr(tgt), H, W, _ptr(row_off), None) == 0
    n = int(row_off[H])
    assert n == int((tgt != 0).sum())
    idx = torch.full((H, W), 3, dtype=torch.int32)
    pix = torch.full((n,), 3, dtype=torch.int32)
    G = torch.full((K._n_words(cfg), n, 2), 3, dtype=torch.int32)
    fn = lib.ppp_consensus2d_half
    fn.argtypes = K.CONSENSUS2D.argtypes
    fn.restype = ctypes.c_int
    err = fn(_ptr(ag), _ptr(tgt), _ptr(out), int(cfg.cons_bf16), H, W, p,
             _MODES[cfg.weight_mode], float(cfg.patch_threshold),
             float(cfg.bg_th), int(cfg.norm_aff), _ptr(row_off), n, _ptr(idx),
             _ptr(pix), _ptr(G), None)
    assert err == 0
    return out, idx, pix, G


def _rank2d_host(lib, ag, tgt, half, cfg):
    _, H, W = ag.shape
    acc = torch.full((H, W), 7.0)
    fn = lib.ppp_rank2d_half
    fn.argtypes = K.RANK2D.argtypes
    fn.restype = ctypes.c_int
    err = fn(_ptr(ag), _ptr(tgt), _ptr(half),
             int(half.dtype == torch.bfloat16), _ptr(acc), H, W,
             int(cfg.ps[1]), float(cfg.patch_threshold), float(cfg.bg_th),
             int(cfg.rank_int_counter), None)
    assert err == 0
    return acc


CASES_2D = [
    (3, (1, 7, 37), {}),
    (5, (1, 11, 35), {}),
    (5, (1, 11, 35), {"weight_mode": "count", "norm_aff": False}),
    (5, (1, 11, 35), {"weight_mode": "prob_product", "cons_bf16": True}),
    (5, (1, 12, 33), {"overlapping_inst": True}),
    (5, (1, 11, 35), {"bg_mode": "half", "patch_threshold": 0.6}),
    (7, (1, 13, 34), {"cons_bf16": True}),     # 49 pixels: two words
    (9, (1, 17, 26), {"patch_threshold": 0.6}),  # 153 displacements: 3 blocks
]


@pytest.mark.parametrize("p,shape,kw", CASES_2D)
def test_consensus2d_source_matches_plain_on_host(libs, p, shape, kw):
    cfg = C.ConsensusConfig(patchshape=(1, p, p), **kw)
    ag, tgt = _gated_2d(p, shape, 4, cfg)
    got, idx, pix, G = _consensus2d_host(libs["consensus2d"], ag, tgt, cfg)
    want_idx, want_pix, want_G = K.pack_target_codes_2d(ag, tgt, cfg)
    assert torch.equal(idx, want_idx) and torch.equal(pix, want_pix)
    assert torch.equal(G, want_G)
    want = C.consensus_half_2d_plain(ag, tgt, cfg)
    assert float(want.float().abs().max()) > 0.1
    torch.testing.assert_close(got.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -7 if cfg.cons_bf16 else 1e-4)


@pytest.mark.parametrize("p,shape,kw", [
    (3, (1, 7, 37), {}),
    (5, (1, 11, 35), {}),
    (5, (1, 11, 35), {"rank_int_counter": True}),
    (5, (1, 12, 33), {"overlapping_inst": True}),
    (7, (1, 13, 34), {"rank_int_counter": True}),
])
@pytest.mark.parametrize("bf16,lib", [(False, "rank2d"), (True, "rank2d"),
                                      (False, "rank2d_rounds")])
def test_rank2d_source_matches_plain_on_host(libs, p, shape, kw, bf16, lib):
    cfg = C.ConsensusConfig(patchshape=(1, p, p), **kw)
    ag, tgt = _gated_2d(p, shape, 5, cfg)
    rng = np.random.RandomState(6)
    half = torch.from_numpy(
        rng.randn(p, 2 * p - 1, *shape[1:]).astype(np.float32))
    half[:, :, :, 1] = 0            # exact zeros for the int_counter variant
    if bf16:
        half = half.to(torch.bfloat16)
    got = _rank2d_host(libs[lib], ag, tgt, half, cfg)
    want = C.rank_acc_2d_plain(ag, tgt, half, cfg)
    assert float(want.abs().max()) > 1.0
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("int_counter", [False, True])
def test_host_2d_kernels_on_all_sentinel_input(libs, int_counter):
    """No eligible center (the stack all sentinel) on a target plane that is
    half set: a zero half and a zero sum."""
    cfg = C.ConsensusConfig(patchshape=(1, 5, 5),
                            rank_int_counter=int_counter)
    H, W = 9, 35
    ag = torch.full((25, H, W), -1.0)
    tgt = (torch.rand(H, W, generator=torch.Generator().manual_seed(0))
           > 0.5).to(torch.float32)
    half, idx, pix, G = _consensus2d_host(libs["consensus2d"], ag, tgt, cfg)
    assert not half.any() and not G.any() and len(pix) > 0
    acc = _rank2d_host(libs["rank2d"], ag, tgt,
                       torch.randn(5, 9, H, W), cfg)
    assert not acc.any()


@pytest.mark.parametrize("p", [3, 5])
def test_host_2d_kernels_on_one_eligible_center(libs, p):
    cfg = C.ConsensusConfig(patchshape=(1, p, p))
    shape = (1, 11, 35)
    ag, tgt = _gated_2d(p, shape, 7, cfg, center_frac=0.0)
    rad = p // 2
    c = (rad + 3, 20)
    a = torch.from_numpy(np.random.RandomState(8).rand(
        p * p).astype(np.float32))
    ag[:, c[0], c[1]] = torch.where(a > 0.3, 0.6 + 0.4 * a, 0.2 * a)
    ag[cfg.mid, c[0], c[1]] = 0.9
    assert int((ag[cfg.mid] >= 0).sum()) == 1
    half, _, _, _ = _consensus2d_host(libs["consensus2d"], ag, tgt, cfg)
    want = C.consensus_half_2d_plain(ag, tgt, cfg)
    assert float(want.abs().max()) > 0.1
    torch.testing.assert_close(half, want, atol=1e-4, rtol=1e-4)
    acc = _rank2d_host(libs["rank2d"], ag, tgt, want, cfg)
    want_acc = C.rank_acc_2d_plain(ag, tgt, want, cfg)
    assert int((want_acc != 0).sum()) == 1
    torch.testing.assert_close(acc, want_acc, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_host_kernels_on_a_gated_border_window(libs, bf16):
    """A blockwise border window: ``center_valid`` gates the centers
    outside the whole volume's interior out of the mask stacks, from
    which alone the pack pass derives its bits and planes."""
    from patchperpix_tpu_torch.assembly.blockwise import _global_center_valid

    cfg = C.ConsensusConfig(patchshape=(3, 3, 3), cons_bf16=bf16)
    shape = (6, 7, 8)
    rng = np.random.RandomState(9)
    a = rng.rand(27, *shape).astype(np.float32)
    affs = torch.from_numpy(
        np.where(a > 0.4, 0.6 + 0.4 * a, 0.4 * a).astype(np.float32))
    cv = _global_center_valid((-1, 2, 4), shape, (9, 12, 11), (1, 1, 1))
    assert 0 < cv.sum() < cv.size
    hi, lo, _ = C._masks(affs, cfg, None, torch.from_numpy(cv))
    assert hi.any() and not hi[:, ~cv].any() and not lo[:, ~cv].any()
    half, codes, targets = _consensus_host(libs["consensus"], affs, hi, lo,
                                           cfg)
    assert torch.equal(codes, K.pack_target_codes(hi, lo, cfg))
    assert torch.equal(targets, K.pack_codes(hi, lo, cfg)[2])
    want = C.consensus_half_plain(affs, hi, lo, cfg)
    torch.testing.assert_close(half.float(), want.float(), atol=1e-4,
                               rtol=2.0 ** -7 if bf16 else 1e-4)
    acc, codes, elig = _rank_host(libs["rank"], hi, lo, half, cfg)
    want_codes, want_elig, _ = K.pack_codes(hi, lo, cfg)
    assert torch.equal(codes, want_codes) and torch.equal(elig, want_elig)
    assert not elig[torch.from_numpy(~cv)].any()
    want_acc = C.rank_acc_plain(hi, lo, half, cfg)
    assert not want_acc[torch.from_numpy(~cv)].any()
    torch.testing.assert_close(acc, want_acc, atol=1e-3, rtol=1e-4)


def _probe_host(lib, x, n_slab, mode):
    ZS, _, W = x.shape
    out = torch.full((ZS - n_slab + 1, PR.V, W), 7.0)
    fn = lib.ppp_probe_window
    fn.argtypes = PR.PROBE.argtypes
    fn.restype = ctypes.c_int
    assert fn(_ptr(x), _ptr(out), ZS, W, n_slab, PR.MODES[mode], None) == 0
    return out


@pytest.mark.parametrize("mode,n_slab,W", PR.CASES + (PR.OPT_IN_CASE,))
def test_probe_source_matches_plain_on_host(libs, mode, n_slab, W):
    """The twelve cases of the probe and the one that stages past 48 KB:
    every block of 128 columns (the last one ragged at W = 696 and 720)
    against the plain version, bit for bit."""
    x = PR.case_input(n_slab, W)
    got = _probe_host(libs["probe_window"], x, n_slab, mode)
    want = PR.probe_window_plain(x, n_slab)
    assert float(want.abs().max()) > 10.0
    assert float((got - want).abs().max()) < 1e-4
    assert torch.equal(got, want)


def test_probe_source_rejects_bad_arguments(libs):
    x = torch.rand(4, PR.V, 40)
    out = torch.empty(4, PR.V, 40)
    fn = libs["probe_window"].ppp_probe_window
    fn.argtypes = PR.PROBE.argtypes
    fn.restype = ctypes.c_int
    for ZS, n_slab, mode in ((4, 5, 0), (4, 0, 0), (4, 2, 2)):
        assert fn(_ptr(x), _ptr(out), ZS, 40, n_slab, mode, None) != 0
    assert PR.staged_bytes(PR.OPT_IN_CASE[1]) > 48 * 1024 \
        > PR.staged_bytes(3)


def test_cuda_kernel_binds_each_entry_point_once(libs, monkeypatch):
    """``CudaKernel.bind`` looks a C function up and sets its types at the
    first call only; later calls return the same function object, and a
    binding of the same symbol elsewhere cannot change its types."""
    from patchperpix_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "_loaded",
                        {"probe_window": libs["probe_window"]})
    kern = _build.CudaKernel("probe_window", "ppp_probe_window",
                             PR.PROBE.argtypes, PR.PROBE.replaces)
    fn = kern.bind(kern.symbol, kern.argtypes)
    assert kern.bind(kern.symbol, kern.argtypes) is fn
    other = libs["probe_window"].ppp_probe_window
    other.argtypes, other.restype = None, ctypes.c_double
    assert fn.argtypes == tuple(PR.PROBE.argtypes)
    assert fn.restype is ctypes.c_int
    x = PR.case_input(2, 40)
    out = torch.empty(7, PR.V, 40)
    assert fn(x.data_ptr(), out.data_ptr(), 8, 40, 2, 0, None) == 0
    assert torch.equal(out, PR.probe_window_plain(x, 2))
    msg = kern.bind("ppp_probe_window_error_string", [ctypes.c_int],
                    ctypes.c_char_p)
    assert msg(0) and kern.bind("ppp_probe_window_error_string",
                                [ctypes.c_int]) is msg


# the cover loops (K5, K6): the wrappers' own marshalling
# (ops/cover_kernels.py) around the host build of each source

def _entry(lib, kernel):
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int

    def launch(*args):
        assert fn(*args) == 0
    return launch


def _cascade_host(libs, affs, mask, centers, ovl, ps, fc, ths, **kw):
    return CK.run_cover_cascade(_entry(libs["cover_cascade"],
                                       CK.COVER_CASCADE),
                                torch.from_numpy(affs), mask, centers, ovl,
                                ps, fc, ths, **kw)


def _thin_host(libs, affs, mask, centers, ps, fc, mode="lazy", max_it=None,
               **kw):
    return CK.run_thin_cover(_entry(libs["thin_cover"], CK.THIN_COVER),
                             torch.from_numpy(affs), mask, centers, ps, fc,
                             mode, max_it, **kw)


def _pix_ths(ps):
    mid = int(np.prod(ps)) // 2
    return tuple(t for t in (500, 100, 50, 10, 0) if t < mid)


def _blobs_2d(shape, p, seed):
    """A (1, H, W) image of a few overlapping discs, reaching the borders,
    with noisy ideal (1, p, p) affinities; the mask to cover is all of the
    foreground (border pixels included), the candidates every foreground
    pixel in a seeded order with ties.  Returns (affs, mask, centers,
    overlap rows)."""
    from patchperpix_tpu_torch.ops import synthetic

    rng = np.random.RandomState(seed)
    lab = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[:shape[1], :shape[2]]
    for k in range(1, 6):
        cy, cx = rng.randint(0, shape[1]), rng.randint(0, shape[2])
        r = rng.randint(3, 7)
        lab[0][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = k
    affs = synthetic.labels_to_affinities(lab, np.array((1, p, p)))
    affs = np.clip(affs * 0.7 + 0.3 * rng.rand(*affs.shape), 0, 1).astype(
        np.float32)
    fg = lab > 0
    cand = np.argwhere(fg)
    scores = rng.rand(len(cand)).astype(np.float32)
    scores[::5] = scores[1]
    centers = cand[np.argsort(-scores, kind="stable")]
    ovl = rng.rand(len(centers)) < 0.05
    return affs, fg, centers, ovl


def _cover_data(seed):
    """tests/test_torch_cover.py's 3D inputs (5^3 patches, 16x17x18, tied
    scores, overlap rows): (affs, mask, ranked centers, overlap rows)."""
    from test_torch_cover import _data

    affs, mask, ranked, overlap = _data(seed)
    centers = np.array([c for c, _ in ranked])
    return affs, mask, centers, overlap[tuple(centers.T)] > 0


def _r16(b):
    return (b + 15) // 16 * 16


def _cascade_smem(n, vol, ps, chunk):
    """(bytes of csrc/cover_cascade.cu's shared memory before the staged
    parts, of its running words, of its two mask buffers)."""
    wp, nwords = CK._geometry(vol, ps)
    return (_r16(6 * 8 + 4 * 4 + 2 * chunk * 4), _r16(4 * nwords),
            2 * _r16(chunk * wp * 4 + 32))


def _thin_smem(n, vol, ps, list_len=1024):
    """(bytes of csrc/thin_cover.cu's shared memory before the staged
    parts, of its running words, of its arrays, of its masks)."""
    wp, nwords = CK._geometry(vol, ps)
    return (_r16(64 * 8 + 8 + 16 + 4 * list_len), _r16(4 * nwords),
            _r16(12 * n), _r16(4 * n * wp))


@pytest.mark.parametrize("threads,smem_cap,chunk", [
    (64, CK.SMEM_CAP, 256),     # running bits and masks in shared memory
    (96, 0, 40),                # both in device memory, three warps
    (64, "run", 16),            # the running bits only
])
@pytest.mark.parametrize("seed,fc", [(0, 0.5), (2, 0.7)])
def test_cover_cascade_source_matches_plain_on_host(libs, seed, fc, threads,
                                                    smem_cap, chunk):
    affs, mask, centers, ovl = _cover_data(seed)
    ps = (5, 5, 5)
    if smem_cap == "run":
        base, run_b, _ = _cascade_smem(len(centers), mask.shape, ps, chunk)
        smem_cap = base + run_b
    want_sel, want_run = COV.cover_cascade_plain(
        torch.from_numpy(affs), mask, centers, ovl, ps, fc, _pix_ths(ps))
    sel, run, st = _cascade_host(libs, affs, mask, centers, ovl, ps, fc,
                                 _pix_ths(ps), threads=threads,
                                 smem_cap=smem_cap, chunk=chunk)
    assert ovl.any() and 0 < want_sel.sum() < len(centers)
    assert not (sel & ovl).any()
    np.testing.assert_array_equal(sel, want_sel)
    np.testing.assert_array_equal(run, want_run)
    assert st["takes"] == want_sel.sum() and st["visits"] >= st["takes"]


@pytest.mark.parametrize("seed", [3, 7])
def test_cover_cascade_source_stops_mid_chunk_on_host(libs, seed):
    """A flat (1, H, W) image with (1, 7, 7) patches whose mask to cover
    reaches the borders: the interior is covered (rem reaches 0) at a
    candidate in the middle of a chunk while later candidates still cover
    more than the threshold outside the interior; none of them is taken."""
    ps = (1, 7, 7)
    affs, mask, centers, ovl = _blobs_2d((1, 24, 27), 7, seed)
    ths = _pix_ths(ps)
    a = torch.from_numpy(affs)
    want_sel, want_run = COV.cover_cascade_plain(a, mask, centers, ovl, ps,
                                                 0.5, ths)
    # the same cascade counting every pixel to cover as interior: rem then
    # reaches 0 later, and more candidates are taken
    pm = COV._patch_masks(a, centers, 0.5)
    win, run0, _ = COV._thin_cover_volumes(mask, centers, np.array(ps))
    more = COV._greedy_cover_cascade(pm, win, run0.copy(),
                                     (run0 > 0).astype(np.float32), ovl, ths)
    assert more.sum() > want_sel.sum() > 0
    last = int(np.flatnonzero(want_sel)[-1])
    assert last + 1 < len(centers)
    for chunk in (last + 3, 16):
        assert last % chunk != chunk - 1
        sel, run, st = _cascade_host(libs, affs, mask, centers, ovl, ps, 0.5,
                                     ths, threads=64, chunk=chunk)
        np.testing.assert_array_equal(sel, want_sel)
        np.testing.assert_array_equal(run, want_run)
        assert run.any() and st["sweeps"] <= len(ths)


@pytest.mark.parametrize("chunk", [16, 40])
@pytest.mark.parametrize("threads,smem_cap", [(64, CK.SMEM_CAP), (96, 0)])
def test_cover_cascade_source_takes_at_chunk_ends_on_host(libs, chunk,
                                                          threads, smem_cap):
    """Chunks of 16 and 40 on the 2D blobs, where the walk takes
    candidates in the last rows of a chunk: the bounding warps count the
    next chunk's windows while those takes clear bits, in shared and in
    device memory; selection and volume equal the plain version's."""
    ps = (1, 7, 7)
    affs, mask, centers, ovl = _blobs_2d((1, 24, 27), 7, 9)
    ths = _pix_ths(ps)
    want_sel, want_run = COV.cover_cascade_plain(
        torch.from_numpy(affs), mask, centers, ovl, ps, 0.5, ths)
    taken = np.flatnonzero(want_sel)
    assert (taken % chunk >= chunk - 2).any()
    sel, run, st = _cascade_host(libs, affs, mask, centers, ovl, ps, 0.5,
                                 ths, threads=threads, smem_cap=smem_cap,
                                 chunk=chunk)
    np.testing.assert_array_equal(sel, want_sel)
    np.testing.assert_array_equal(run, want_run)
    assert st["takes"] == len(taken) and st["visits"] >= st["takes"]
    assert st["bounded"] >= len(centers) - ovl.sum()


def test_cover_sources_long_windows_on_host(libs):
    """(1, 131, 3) patches: 131 items a window, more than the kernels'
    table of 128 (cover_window.cuh's kTab), so that a lane keeps up to
    four items and the last three come from the items past the table; K5
    and K6 against their plain versions on seeded random affinities."""
    rng = np.random.RandomState(11)
    ps, shape = (1, 131, 3), (1, 136, 5)
    P = int(np.prod(ps))
    affs = (rng.rand(P, *shape) > 0.55).astype(np.float32)
    mask = rng.rand(*shape) > 0.3
    centers = np.argwhere(mask)[rng.permutation(int(mask.sum()))]
    ovl = rng.rand(len(centers)) < 0.1
    a = torch.from_numpy(affs)
    ths = _pix_ths(ps)
    want_sel, want_run = COV.cover_cascade_plain(a, mask, centers, ovl, ps,
                                                 0.5, ths)
    sel, run, st = _cascade_host(libs, affs, mask, centers, ovl, ps, 0.5,
                                 ths, threads=64, chunk=16)
    assert 0 < want_sel.sum() < len(centers)
    np.testing.assert_array_equal(sel, want_sel)
    np.testing.assert_array_equal(run, want_run)
    want = COV.thin_cover_plain(a, mask, centers, ps, 0.5)
    got, st = _thin_host(libs, affs, mask, centers, ps, 0.5, threads=64)
    assert 0 < want.sum() < len(centers)
    np.testing.assert_array_equal(got, want)


_STRESS = """
import sys
import numpy as np
import torch
import test_torch_kernel_mock as T
from patchperpix_tpu_torch.ops import cover as COV
from patchperpix_tpu_torch.ops import cover_kernels as CK

launch = T._entry(T.ctypes.CDLL(sys.argv[1]), CK.COVER_CASCADE)
ps, runs = (1, 7, 7), int(sys.argv[2])
for it in range(runs):
    affs, mask, centers, ovl = T._blobs_2d((1, 24, 27), 7, 3 + it % 9)
    a = torch.from_numpy(affs)
    want = COV.cover_cascade_plain(a, mask, centers, ovl, ps, 0.5,
                                   T._pix_ths(ps))
    got = CK.run_cover_cascade(launch, a, mask, centers, ovl, ps, 0.5,
                               T._pix_ths(ps), threads=96, chunk=16,
                               smem_cap=(0, CK.SMEM_CAP)[it % 2])
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                              want[1])
print(runs)
"""


def test_cover_cascade_source_many_launches_on_host(libs):
    """A time-bounded stress run of the cascade's host build: 24 launches
    on the 2D blobs, where rem reaches 0 part-way and the bounding warps
    stop on the walk's done flag, staged and in device memory, one host
    thread per CUDA thread while the other test workers load the CPU.  It
    runs in a subprocess with a time limit, so that a hand-off between the
    warps that can deadlock fails the test instead of hanging it (an early
    version did: bounding warps that decided to stop at different chunks
    left one waiting for a copy that another was to issue).  Each launch
    equals the plain version."""
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(tests), tests, os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run([sys.executable, "-c", _STRESS,
                        libs["cover_cascade"]._name, "24"], env=env,
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.split()[-1] == "24"


def _thin_centers(affs, mask, centers, ovl, ps, fc):
    """The candidates a thin cover takes: the greedy cover's selection."""
    sel, _ = COV.cover_cascade_plain(torch.from_numpy(affs), mask, centers,
                                     ovl, ps, fc, (0,))
    return centers[sel]


def _thin_batched(pmasks, win, running, inner, centers, ps, max_it=None):
    """The kernel's lazy schedule in rounds (``csrc/thin_cover.cu``, an
    unbounded refresh list) on the host: b the largest fresh key (size <<
    32 | ~index), S the stale entries above it; S empty picks b, else S is
    counted anew.  Returns (selected, statistics as the kernel's, the
    largest S, the refresh rounds whose S holds a size equal to b's)."""
    n = len(centers)
    max_it = 64 * n + 1024 if max_it is None else max_it
    sizes = np.sum(pmasks * running[win], axis=1).astype(np.int64)
    stale = np.zeros(n, bool)
    selected = np.zeros(n, bool)
    rem = int(np.dot(running, inner))
    low = 0xffffffff - np.arange(n, dtype=np.int64)
    rounds = picks = refreshes = largest = ties = 0
    done = False
    while not done and picks < n and rem > 0 and rounds < max_it:
        rounds += 1
        key = (sizes << 32) | low
        kf = int(key[~stale].max()) if (~stale).any() else 0
        bsize = kf >> 32
        S = np.flatnonzero(stale & (key > kf))
        if len(S):
            largest = max(largest, len(S))
            ties += bool(kf and (sizes[S] == bsize).any())
            for j in S:
                sizes[j] = int(np.dot(pmasks[j], running[win[j]]))
            stale[S] = False
            refreshes += len(S)
            continue
        best = 0xffffffff - (kf & 0xffffffff)
        selected[best] = True
        if bsize > 0:
            w = win[best]
            newly = pmasks[best] * running[w]
            rem -= int(np.dot(newly, inner[w]))
            running[w] -= newly
            stale |= np.all(np.abs(centers - centers[best][None])
                            < ps[None], axis=1)
            stale[best] = False
            sizes[best] = 0
        picks += 1
        done = bsize <= 0
    return selected, {"rounds": rounds, "picks": picks,
                      "refreshes": refreshes,
                      "capped": rounds >= max_it}, largest, ties


def _thin_model(affs, mask, cen, ps, fc, max_it=None):
    pm = COV._patch_masks(torch.from_numpy(affs), cen, fc)
    win, run0, inner = COV._thin_cover_volumes(mask, cen, np.array(ps))
    return _thin_batched(pm, win, run0.copy(), inner, cen,
                         np.array(ps), max_it)


@pytest.mark.parametrize("threads,smem_cap", [(64, CK.SMEM_CAP), (96, 0),
                                              (64, "arrays")])
@pytest.mark.parametrize("seed,fc", [(0, 0.5), (1, 0.5), (2, 0.7)])
def test_thin_cover_source_matches_plain_on_host(libs, seed, fc, threads,
                                                 smem_cap):
    """Masks in shared memory, everything in device memory, and the masks
    alone in device memory ("arrays": the running bits and the arrays
    staged); the kernel's counts are those of its schedule's host model."""
    affs, mask, centers, ovl = _cover_data(seed)
    ps = (5, 5, 5)
    cen = _thin_centers(affs, mask, centers, ovl, ps, fc)
    if smem_cap == "arrays":
        base, run_b, arr_b, _ = _thin_smem(len(cen), mask.shape, ps)
        smem_cap = base + run_b + arr_b
    want = COV.thin_cover_plain(torch.from_numpy(affs), mask, cen, ps, fc)
    got, st = _thin_host(libs, affs, mask, cen, ps, fc, threads=threads,
                         smem_cap=smem_cap)
    assert 0 < want.sum() < len(cen)
    np.testing.assert_array_equal(got, want)
    assert not st["capped"] and st["picks"] == want.sum()
    assert st["rounds"] >= st["picks"]
    model, mst, _, _ = _thin_model(affs, mask, cen, ps, fc)
    np.testing.assert_array_equal(model, want)
    assert {k: st[k] for k in mst} == mst
    full, _ = _thin_host(libs, affs, mask, cen, ps, fc, "full",
                         threads=threads, smem_cap=smem_cap)
    np.testing.assert_array_equal(full, want)


@pytest.mark.parametrize("seed", [3, 5])
def test_thin_cover_source_2d_on_host(libs, seed):
    ps = (1, 7, 7)
    affs, mask, centers, ovl = _blobs_2d((1, 24, 27), 7, seed)
    cen = _thin_centers(affs, mask, centers, ovl, ps, 0.5)
    want = COV.thin_cover_plain(torch.from_numpy(affs), mask, cen, ps, 0.5)
    got, st = _thin_host(libs, affs, mask, cen, ps, 0.5, threads=64)
    assert 0 < want.sum() < len(cen)
    np.testing.assert_array_equal(got, want)
    assert st["refreshes"] > 0 and st["rounds"] >= st["picks"]
    # the same image as a 2D volume (H, W) with (7, 7) patches
    got2, _ = _thin_host(libs, affs.reshape(49, 24, 27), mask[0], cen[:, 1:],
                         (7, 7), 0.5, threads=64)
    np.testing.assert_array_equal(got2, want)


def test_thin_cover_source_at_its_cap_on_host(libs):
    """A lazy loop cut at 12 rounds: it reports the cap and has selected
    what its schedule selects in 12 rounds, which is what the plain lazy
    loop has selected after as many picks; the full mode then selects what
    the uncapped loops select."""
    affs, mask, centers, ovl = _cover_data(1)
    ps = (5, 5, 5)
    a = torch.from_numpy(affs)
    cen = _thin_centers(affs, mask, centers, ovl, ps, 0.5)
    want_cut, mst, _, _ = _thin_model(affs, mask, cen, ps, 0.5, max_it=12)
    assert mst["capped"] and 0 < want_cut.sum() < 12
    got_cut, st = _thin_host(libs, affs, mask, cen, ps, 0.5, max_it=12,
                             threads=64)
    assert st["capped"] and st["rounds"] == 12
    np.testing.assert_array_equal(got_cut, want_cut)
    pm = COV._patch_masks(a, cen, 0.5)
    win, run0, inner = COV._thin_cover_volumes(mask, cen, np.array(ps))
    it = 1
    while True:
        plain_cut, capped = COV._thin_cover_lazy(
            pm, win, run0.copy(), inner, cen, np.array(ps), max_it=it)
        if plain_cut.sum() >= st["picks"]:
            break
        it += 1
    assert capped
    np.testing.assert_array_equal(got_cut, plain_cut)
    want = COV.thin_cover_plain(a, mask, cen, ps, 0.5)
    np.testing.assert_array_equal(
        COV.thin_cover_plain(a, mask, cen, ps, 0.5, max_it=12), want)
    full, st_full = _thin_host(libs, affs, mask, cen, ps, 0.5, "full",
                               threads=64)
    assert not st_full["capped"]
    np.testing.assert_array_equal(full, want)


@pytest.mark.parametrize("seed", [0, 2])
def test_thin_cover_source_batched_refresh_on_host(libs, seed):
    """Picks that make more entries stale than the block has warps, and
    refresh rounds whose S holds a size equal to the best fresh one's (the
    tie goes to the smaller index): two warps refresh such an S at once;
    the kernel's rounds, picks and refreshes are its schedule's, and the
    selection the plain loops'.  With a refresh list of two entries
    (PPP_THIN_LIST=2) what does not fit stays stale for the next round:
    more rounds, the same selection."""
    affs, mask, centers, ovl = _cover_data(seed)
    ps = (5, 5, 5)
    cen = _thin_centers(affs, mask, centers, ovl, ps, 0.5)
    want = COV.thin_cover_plain(torch.from_numpy(affs), mask, cen, ps, 0.5)
    model, mst, largest, ties = _thin_model(affs, mask, cen, ps, 0.5)
    assert largest > 2 and ties > 0
    got, st = _thin_host(libs, affs, mask, cen, ps, 0.5, threads=64)
    np.testing.assert_array_equal(got, want)
    assert {k: st[k] for k in mst} == mst
    short, st2 = CK.run_thin_cover(
        _entry(libs["thin_cover_list2"], CK.THIN_COVER),
        torch.from_numpy(affs), mask, cen, ps, 0.5, threads=64)
    np.testing.assert_array_equal(short, want)
    assert st2["rounds"] > st["rounds"] and st2["picks"] == st["picks"]


def test_cover_routes_to_the_sources_on_host(libs, monkeypatch):
    """``greedy_cover_device`` (dense data) and ``thin_out_cover_device``
    on a tensor routed as a card's: the wrappers launch the host build of
    the kernels, no host loop runs, and the selections equal the JAX
    package's, in order."""
    from patchperpix_tpu.ops import cover as jcover

    affs, mask, centers, ovl = _cover_data(0)
    from test_torch_cover import _data
    _, _, ranked, overlap = _data(0)
    ps = (5, 5, 5)
    monkeypatch.setattr(COV, "_route", lambda t, what: True)
    for kern, lib in ((CK.COVER_CASCADE, "cover_cascade"),
                      (CK.THIN_COVER, "thin_cover")):
        monkeypatch.setattr(
            CK, "_card", lambda k, t: (_entry(libs[k.name], k), None))

    def no_host_loop(*a, **k):
        raise AssertionError("a host loop ran")
    for name in ("_greedy_cover_cascade", "_thin_cover_lazy",
                 "_thin_cover_full", "_patch_masks"):
        monkeypatch.setattr(COV, name, no_host_loop)
    a = torch.from_numpy(affs)
    got, got_run = COV.greedy_cover_device(a, mask, ranked, ps,
                                           overlap=overlap, sparse_data=False)
    want, want_run = jcover.greedy_cover_device(affs, mask, ranked, ps,
                                                overlap=overlap,
                                                sparse_data=False)
    assert 0 < len(want) < len(ranked)
    np.testing.assert_array_equal([c for c, _ in got], [c for c, _ in want])
    np.testing.assert_array_equal(got_run, np.asarray(want_run))
    thin_g = COV.thin_out_cover_device(a, mask, got, ps)
    thin_w = jcover.thin_out_cover_device(affs, mask, want, ps)
    assert 0 < len(thin_w) < len(want)
    np.testing.assert_array_equal([c for c, _ in thin_g],
                                  [c for c, _ in thin_w])


# (N, Ci, Co, D, H, W, config, splits, P): every tile instance, ragged
# channel tiles, one chunk and several per plane, shares that end
# inside a walk down z, and a plane whose last chunk runs past it
_WGRAD_CASES = [(1, 3, 5, 5, 6, 7, 0, 1, None), (2, 5, 7, 6, 5, 9, 1, 3, 8),
                (1, 9, 11, 5, 7, 6, 2, 2, 12), (2, 33, 35, 5, 6, 5, 3, 4, 16),
                (1, 4, 6, 7, 9, 10, 3, 5, 20)]


@pytest.mark.parametrize("case", _WGRAD_CASES)
def test_conv3d_wgrad_source_matches_plain_on_host(libs, case):
    N, Ci, Co, D, H, W, config, splits, P = case
    if P is None:
        P = WG._chunk(config, H, W)[0]
    xstr, dstr = WG._strides(P, W)
    g = torch.Generator().manual_seed(Ci)
    x = torch.randn((N, Ci, D, H, W), generator=g)
    dy = torch.randn((N, Co, D - 2, H - 2, W - 2), generator=g)
    nw = Co * Ci * 27
    fn = libs["conv3d_wgrad"].ppp_conv3d_wgrad
    fn.argtypes = WG.WGRAD.argtypes
    fn.restype = ctypes.c_int
    outs = []
    for _ in range(2):
        out = torch.full((nw + Co,), 7.0)
        ws = torch.full((splits * (nw + Co),), 9.0)
        assert fn(_ptr(x), _ptr(dy), _ptr(ws), _ptr(out), N, Ci, Co, D, H,
                  W, config, P, xstr, dstr, splits, None) == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    dw, db = WG.conv3d_wgrad_plain(x.double(), dy.double())
    for got, want in ((outs[0][:nw].view(dw.shape), dw),
                      (outs[0][nw:], db)):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def test_conv3d_wgrad_source_refuses_a_bad_plan(libs):
    fn = libs["conv3d_wgrad"].ppp_conv3d_wgrad
    fn.argtypes = WG.WGRAD.argtypes
    fn.restype = ctypes.c_int
    x, dy, o = torch.zeros(1, 1, 4, 4, 4), torch.zeros(1, 1, 2, 2, 2), \
        torch.zeros(28)
    # N, Ci, Co, D, H, W, then the plan: config, P, xstr, dstr, splits
    # (at most the 4 chunk-planes: 2 output planes of 2 chunks)
    ok = dict(N=1, Ci=1, Co=1, D=4, H=4, W=4, config=0, P=4, xstr=15,
              dstr=4, splits=1)
    assert fn(_ptr(x), _ptr(dy), _ptr(o), _ptr(o), *ok.values(), None) == 0
    for key, bad in (("config", 4), ("P", 6), ("xstr", 14), ("dstr", 8),
                     ("splits", 5)):
        args = dict(ok, **{key: bad})
        assert fn(_ptr(x), _ptr(dy), _ptr(o), _ptr(o), *args.values(),
                  None) != 0, key


# (N, M, K, S, config, splits, vec): every instance, ragged tiles of both
# operands, one share and several (a share ending inside an element),
# depths that end inside a chunk, 16-byte and 4-byte staging (S not a
# multiple of 4)
_GEMM_CASES = [(2, 5, 7, 36, 0, 1, 1), (3, 130, 9, 52, 1, 3, 1),
               (1, 17, 70, 45, 2, 2, 0), (4, 3, 33, 24, 3, 3, 1),
               (5, 1, 40, 7, 4, 2, 0), (2, 65, 3, 52, 4, 3, 1)]


@pytest.mark.parametrize("case", _GEMM_CASES)
def test_conv_wgrad_gemm_source_matches_plain_on_host(libs, case):
    N, M, K, S, config, splits, vec = case
    g = torch.Generator().manual_seed(M)
    a = torch.randn((N, M, S), generator=g)
    b = torch.randn((N, K, S), generator=g)
    fn = libs["conv_wgrad_gemm"].ppp_conv_wgrad_gemm
    fn.argtypes = WG.GEMM.argtypes
    fn.restype = ctypes.c_int
    outs = []
    for _ in range(2):
        out = torch.full((M * K + M,), 7.0)
        ws = torch.full((splits * (M * K + M),), 9.0)
        assert fn(_ptr(a), _ptr(b), _ptr(ws), _ptr(out), N, M, K, S, config,
                  splits, vec, None) == 0
        outs.append(out)
    assert torch.equal(outs[0], outs[1])
    dw, db = WG.conv_wgrad_gemm_plain(a.double(), b.double())
    for got, want in ((outs[0][:M * K].view(M, K), dw), (outs[0][M * K:], db)):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err


def test_conv_wgrad_gemm_source_refuses_a_bad_plan(libs):
    fn = libs["conv_wgrad_gemm"].ppp_conv_wgrad_gemm
    fn.argtypes = WG.GEMM.argtypes
    fn.restype = ctypes.c_int
    a, b, o = torch.zeros(1, 2, 64), torch.zeros(1, 3, 64), torch.zeros(16)
    # N, M, K, S, then the plan: config, splits (at most the 2 chunks), vec
    ok = dict(N=1, M=2, K=3, S=64, config=4, splits=2, vec=1)
    assert fn(_ptr(a), _ptr(b), _ptr(o), _ptr(o), *ok.values(), None) == 0
    for key, bad in (("config", 5), ("splits", 3), ("splits", 0),
                     ("S", 62), ("M", 0)):
        args = dict(ok, **{key: bad})
        assert fn(_ptr(a), _ptr(b), _ptr(o), _ptr(o), *args.values(),
                  None) != 0, key
