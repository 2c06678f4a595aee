"""Port's cover stages vs the JAX package's: the selected lists must be
equal, in order."""

import numpy as np
import pytest
import torch

from patchperpix_tpu.ops import cover as jcover
from patchperpix_tpu.ops import synthetic
from patchperpix_tpu_torch.ops import cover as tcover

torch.set_num_threads(1)

PS = (5, 5, 5)


def _data(seed):
    rng = np.random.RandomState(seed)
    lab = np.zeros((16, 17, 18), np.int32)
    lab[2:14, 2:8, 2:16] = 1
    lab[2:14, 8:15, 2:16] = 2
    lab[5:9, 12:16, 6:9] = 3
    affs = synthetic.labels_to_affinities(lab, np.array(PS))
    affs = np.clip(affs * 0.7 + 0.3 * rng.rand(*affs.shape), 0, 1).astype(
        np.float32)
    fg = affs[len(affs) // 2] > 0.5
    interior = np.zeros(fg.shape, bool)
    interior[2:-2, 2:-2, 2:-2] = True
    cand = np.argwhere(fg & interior)
    scores = rng.rand(len(cand)).astype(np.float32)
    scores[::7] = scores[3]                 # ties keep scan order
    order = np.argsort(-scores, kind="stable")
    ranked = [(cand[i], float(scores[i])) for i in order]
    overlap = np.zeros(fg.shape, np.uint8)
    overlap[6:8, 7:10, 5:12] = 1
    mask = fg & (overlap == 0)
    return affs, mask, ranked, overlap


@pytest.mark.parametrize("seed,fc,use_overlap", [(0, 0.5, True),
                                                 (1, 0.5, False),
                                                 (2, 0.7, True)])
def test_greedy_and_thin_cover_match_jax(seed, fc, use_overlap):
    affs, mask, ranked, overlap = _data(seed)
    ov = overlap if use_overlap else None
    want, want_run = jcover.greedy_cover_device(
        affs, mask, ranked, PS, fc_threshold=fc, overlap=ov,
        sparse_data=True)
    got, got_run = tcover.greedy_cover_device(
        torch.from_numpy(affs), mask, ranked, PS, fc_threshold=fc,
        overlap=ov, sparse_data=True)
    assert 10 < len(want) < len(ranked)
    np.testing.assert_array_equal([c for c, _ in got], [c for c, _ in want])
    assert [s for _, s in got] == [s for _, s in want]
    np.testing.assert_array_equal(got_run, want_run)

    thin_w = jcover.thin_out_cover_device(affs, mask, want, PS,
                                          fc_threshold=fc)
    thin_g = tcover.thin_out_cover_device(torch.from_numpy(affs), mask, got,
                                          PS, fc_threshold=fc)
    assert 0 < len(thin_w) < len(want)
    np.testing.assert_array_equal([c for c, _ in thin_g],
                                  [c for c, _ in thin_w])


def test_thin_cover_full_fallback_equals_lazy():
    """The exact full-recompute loop (taken when the lazy loop hits its
    iteration cap) selects what the lazy loop selects."""
    affs, mask, ranked, _ = _data(3)
    sel, _ = tcover.greedy_cover_device(torch.from_numpy(affs), mask,
                                        ranked, PS)
    centers = np.array([c for c, _ in sel])
    pm = (affs[:, centers[:, 0], centers[:, 1], centers[:, 2]].T
          > 0.5).astype(np.float32)
    win, run, inner = tcover._thin_cover_volumes(mask, centers,
                                                 np.array(PS))
    lazy, capped = tcover._thin_cover_lazy(pm, win, run.copy(), inner,
                                           centers, np.array(PS))
    full = tcover._thin_cover_full(pm, win, run.copy(), inner)
    assert not capped and 10 < lazy.sum() < len(centers)
    np.testing.assert_array_equal(lazy, full)


@pytest.mark.parametrize("seed,fc,use_overlap", [(0, 0.5, True),
                                                 (1, 0.5, False),
                                                 (2, 0.7, True)])
def test_dense_cascade_matches_jax(seed, fc, use_overlap):
    """The dense-data cascade (one ranked sweep per pixel threshold below
    P // 2) is no longer refused: it selects what the JAX package's
    selects, in order, and leaves the same pixels uncovered."""
    affs, mask, ranked, overlap = _data(seed)
    ov = overlap if use_overlap else None
    want, want_run = jcover.greedy_cover_device(
        affs, mask, ranked, PS, fc_threshold=fc, overlap=ov,
        sparse_data=False)
    got, got_run = tcover.greedy_cover_device(
        torch.from_numpy(affs), mask, ranked, PS, fc_threshold=fc,
        overlap=ov, sparse_data=False)
    sparse, _ = tcover.greedy_cover_device(
        torch.from_numpy(affs), mask, ranked, PS, fc_threshold=fc,
        overlap=ov, sparse_data=True)
    assert 0 < len(want) < len(sparse)
    np.testing.assert_array_equal([c for c, _ in got], [c for c, _ in want])
    assert [s for _, s in got] == [s for _, s in want]
    np.testing.assert_array_equal(got_run, np.asarray(want_run))


def test_card_route_never_runs_a_host_loop(monkeypatch):
    """Off the CPU the cover stages launch their kernels or raise: a tensor
    on another device (``meta``) raises before any host loop runs, and the
    kernels' wrappers refuse a CPU tensor."""
    from patchperpix_tpu_torch.ops import cover_kernels as CK

    affs, mask, ranked, overlap = _data(0)

    def no_host_loop(*a, **k):
        raise AssertionError("a host loop ran")
    for name in ("_greedy_cover_cascade", "_thin_cover_lazy",
                 "_thin_cover_full", "_patch_masks", "cover_cascade_plain",
                 "thin_cover_plain"):
        monkeypatch.setattr(tcover, name, no_host_loop)
    meta = torch.empty(affs.shape, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tcover.greedy_cover_device(meta, mask, ranked, PS, overlap=overlap,
                                   sparse_data=False)
    with pytest.raises(ValueError, match="no kernel for device"):
        tcover.thin_out_cover_device(meta, mask, ranked[:20], PS)
    centers = np.array([c for c, _ in ranked])
    with pytest.raises(ValueError, match="not CUDA"):
        CK.cover_cascade_cuda(torch.from_numpy(affs), mask, centers,
                              np.zeros(len(centers), bool), PS, 0.5, (50, 0))
    with pytest.raises(ValueError, match="not CUDA"):
        CK.thin_cover_cuda(torch.from_numpy(affs), mask, centers, PS, 0.5)
    assert CK.COVER_CASCADE.launches == CK.THIN_COVER.launches == 0
