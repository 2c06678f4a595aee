"""Host rehearsal of the consensus and rank CUDA kernels, 3D
(``csrc/consensus.cu``, ``csrc/rank.cu``, with ``csrc/pack_codes.cuh``) and
2D (``csrc/consensus2d.cu``, ``csrc/rank2d.cu``), with
``csrc/fill_zero.cuh``: compiled by g++ against the small mock of the CUDA
headers in ``tests/cuda_mock/`` and run on the CPU, the grid as loops and
one host thread per CUDA thread of a block, against their plain PyTorch
versions at tiny shapes.

This checks the kernels' indexing, gates and sums before any time on a
card is spent; what only nvcc and the card can say (that the source
builds for sm_90a, launch limits, the asynchronous copies, which the mock
takes as plain loads) is left to ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Skips where g++ is missing.

Tolerances as for the kernels on the card: consensus 1e-4 absolute and
relative (2^-7 relative for a bf16 half), rank 1e-3 absolute / 1e-4
relative; the pack pass's words and planes are compared exactly.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from patchperpix_tpu_torch.ops import consensus as C
from patchperpix_tpu_torch.ops import consensus_kernels as K
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
    # needs several rounds over its lanes at these shapes
    for name, src, flags in (("consensus", "consensus", []),
                             ("rank", "rank", []),
                             ("rank_rounds", "rank",
                              ["-DPPP_RANK_ITEMS_MIN=50"]),
                             ("consensus2d", "consensus2d", []),
                             ("rank2d", "rank2d", []),
                             ("rank2d_rounds", "rank2d",
                              ["-DPPP_RANK_ITEMS_MIN=50"])):
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
