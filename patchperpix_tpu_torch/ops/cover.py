"""Foreground cover stages.

Counterpart of ``patchperpix_tpu/ops/cover.py`` for the main path:

- ``greedy_cover_device``: the ranked-list greedy cover.  For the
  sparse-data threshold (pix_th 0) its exact closed form, one
  min-reduction of rank volumes on the device
  (``_greedy_cover_min_scatter``, cover.py:84-140), z-sharded over a
  mesh where one is given (cover.py:293-343).  For dense data the
  cascade of ranked-order sweeps, one per pix_th in 500/100/50/10/0 below
  P // 2 (``_greedy_cover_volume``, cover.py:30-81): on a CUDA tensor the
  kernel ``csrc/cover_cascade.cu`` runs the whole cascade on the card
  (``ops/cover_kernels.py``); on a CPU tensor its plain version, the host
  loop ``_greedy_cover_cascade`` over the candidates' fc-thresholded
  columns.
- ``thin_out_cover_device``: the lazy greedy set cover (cover.py:143-234)
  with its exact full-recompute fallback (:237-284) when the iteration cap
  is hit.  On a CUDA tensor the kernel ``csrc/thin_cover.cu`` runs both
  loops on the card; on a CPU tensor their plain versions, the host loops
  ``_thin_cover_lazy`` / ``_thin_cover_full`` over the (n, P) patch masks.

On the card nothing but the selection (and the cascade's still-uncovered
volume) comes back to the host, once; any other device raises.
Tie-breaking matches the reference: candidates are visited in ranked
order and the set-cover argmax takes the first maximal patch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .consensus_kernels import _route
from .cover_kernels import cover_cascade_cuda, thin_cover_cuda
from .np_reference import interior, patch_offsets

_INF = 2 ** 30


def greedy_cover_device(affs: torch.Tensor, mask_to_cover: np.ndarray,
                        ranked_patches: list, patchshape,
                        fc_threshold: float = 0.5,
                        overlap: np.ndarray | None = None,
                        sparse_data: bool = True, mesh=None):
    """Greedy foreground cover over the ranked patch list, on
    ``affs.device``.  Returns (selected list of (center, score),
    still-uncovered bool volume).  With a ``mesh`` (a list of devices,
    ``parallel/sharded.py``) the closed form runs z-sharded over it
    (``sharded_cover_min_scatter``) when Z divides by the mesh size into
    slabs of at least rad slices, as in the JAX package; the dense-data
    cascade stays on one device.

    Closed form (pix_th 0): with m(x) the minimum rank over candidates
    whose fc-thresholded window contains x, candidate m(x) is always
    selected, so a candidate is selected iff it owns some pixel's minimum;
    the reference's stop once every interior to-cover pixel is covered is
    the rank cutoff r* = max of m over those pixels."""
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    if not ranked_patches:
        return [], mask_to_cover.astype(bool).copy()
    mid = int(np.prod(ps) // 2)
    pix_ths = (0,) if sparse_data else tuple(
        t for t in (500, 100, 50, 10, 0) if t < mid)
    dev = affs.device
    vol_shape = tuple(int(s) for s in mask_to_cover.shape)
    centers = np.array([rp[0] for rp in ranked_patches], dtype=np.int64)
    n = len(centers)
    if overlap is not None:
        overlap_rows = np.asarray(overlap)[tuple(centers.T)] > 0
    else:
        overlap_rows = np.zeros(n, dtype=bool)
    if pix_ths != (0,):
        run = cover_cascade_cuda if _route(affs, "greedy cover") \
            else cover_cascade_plain
        selected, running = run(affs, mask_to_cover, centers, overlap_rows,
                                ps, fc_threshold, pix_ths)[:2]
        return [rp for i, rp in enumerate(ranked_patches) if selected[i]], \
            running
    ranks = np.where(overlap_rows, _INF, np.arange(n))
    rankvol = torch.full(vol_shape, _INF, dtype=torch.int32, device=dev)
    c_t = torch.as_tensor(centers, device=dev)
    rankvol[c_t[:, 0], c_t[:, 1], c_t[:, 2]] = torch.as_tensor(
        ranks, dtype=torch.int32, device=dev)
    mask = torch.as_tensor(np.asarray(mask_to_cover, bool), device=dev)
    inner = torch.as_tensor(interior(vol_shape, rad), device=dev)
    if mesh is not None and len(mesh) > 1 and vol_shape[0] % len(mesh) \
            == 0 and vol_shape[0] // len(mesh) >= int(rad[0]):
        from ..parallel.sharded import sharded_cover_min_scatter

        selected, running = sharded_cover_min_scatter(
            affs, rankvol, mask, inner, n, ps, fc_threshold, mesh)
        return [rp for i, rp in enumerate(ranked_patches) if selected[i]], \
            running

    m_all = min_rank_field(affs, rankvol, ps, fc_threshold)
    m_all = torch.where(mask, m_all, torch.full_like(m_all, _INF))
    r_star = torch.max(torch.where(inner & mask, m_all,
                                   torch.full_like(m_all, -1)))
    covered = (m_all <= r_star) & (m_all < _INF)
    idx = torch.where(covered, m_all, torch.full_like(m_all, n))
    selected = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    selected[idx.reshape(-1).long()] = True
    selected = selected[:n].cpu().numpy()
    running = (mask & ~covered).cpu().numpy()
    return [rp for i, rp in enumerate(ranked_patches) if selected[i]], \
        running


def min_rank_field(affs: torch.Tensor, rankvol: torch.Tensor, ps,
                   fc_threshold: float) -> torch.Tensor:
    """m(x) = min over q of the rank volume, gated by affs[q] >
    fc_threshold, read at x - (off(q) - rad); INF outside the volume.

    Padded by rad with INF, that read is gp[q][x + 2 rad - off(q)], whose
    element offset off(q) . (pixel strides - spatial strides) + x .
    spatial strides + 2 rad . spatial strides is affine in (off(q), x):
    one strided view of all q, reduced at once."""
    ps = tuple(int(p) for p in ps)
    rad = [p // 2 for p in ps]
    vol_shape = tuple(int(s) for s in rankvol.shape)
    pad = []
    for r in reversed(rad):
        pad += [r, r]
    gated = torch.where(affs > fc_threshold, rankvol[None],
                        torch.full_like(rankvol, _INF)[None])
    gp = F.pad(gated.reshape(ps + gated.shape[1:]), pad, value=_INF)
    st = gp.stride()
    view = gp.as_strided(
        ps + vol_shape, tuple(st[a] - st[a + 3] for a in range(3)) + st[3:],
        sum(2 * r * st[a + 3] for a, r in enumerate(rad)))
    return view.amin(dim=(0, 1, 2))


def cover_cascade_plain(affs: torch.Tensor, mask_to_cover: np.ndarray,
                        centers: np.ndarray, overlap_rows: np.ndarray,
                        ps, fc_threshold: float, pix_ths) -> tuple:
    """Plain version of ``csrc/cover_cascade.cu``: the host cascade over
    the candidates' columns, gathered on ``affs.device``.  Returns
    (selected bool (n,), still-uncovered bool volume)."""
    ps = np.asarray(ps, dtype=np.int64)
    rad = ps // 2
    vol_shape = tuple(int(s) for s in mask_to_cover.shape)
    pmasks = _patch_masks(affs, centers, fc_threshold)
    win, running, inner = _thin_cover_volumes(mask_to_cover, centers, ps)
    selected = _greedy_cover_cascade(pmasks, win, running, inner,
                                     overlap_rows, pix_ths)
    pad_shape = tuple(int(s + 2 * r) for s, r in zip(vol_shape, rad))
    crop = tuple(slice(int(r), int(r) + s) for r, s in zip(rad, vol_shape))
    return selected, running.reshape(pad_shape)[crop] > 0.5


def thin_cover_plain(affs: torch.Tensor, mask_to_cover: np.ndarray,
                     centers: np.ndarray, ps, fc_threshold: float,
                     max_it: int | None = None) -> np.ndarray:
    """Plain version of ``csrc/thin_cover.cu``: the host lazy loop over
    the patch masks gathered on ``affs.device`` and, where it reaches its
    cap (``max_it``, by default 64 n + 1024), the full loop.  Returns
    selected bool (n,)."""
    ps = np.asarray(ps, dtype=np.int64)
    pmasks = _patch_masks(affs, centers, fc_threshold)
    win, running0, inner = _thin_cover_volumes(mask_to_cover, centers, ps)
    selected, capped = _thin_cover_lazy(pmasks, win, running0.copy(), inner,
                                        centers, ps, max_it)
    if capped:
        selected = _thin_cover_full(pmasks, win, running0.copy(), inner)
    return selected


def _patch_masks(affs: torch.Tensor, centers: np.ndarray,
                 fc_threshold: float) -> np.ndarray:
    """(n, P) float32 0/1 on the host: each center's patch column above
    the cover threshold, gathered and thresholded on ``affs.device``."""
    c_t = torch.as_tensor(centers, device=affs.device)
    return (affs[:, c_t[:, 0], c_t[:, 1], c_t[:, 2]].T
            > fc_threshold).cpu().numpy().astype(np.float32)


def _greedy_cover_cascade(pmasks, win, running, inner, overlap_rows,
                          pix_ths, chunk: int = 256) -> np.ndarray:
    """Ranked-order greedy cover, one sweep per pixel threshold
    (cover.py:30-81): candidate i (not selected yet, not on an overlap
    pixel) is taken iff its fc-thresholded window covers more than pix_th
    still-uncovered pixels while interior to-cover pixels remain (an exact
    integer count).  ``running`` / ``inner`` are the flat rad-padded
    volumes and ``win[i]`` the flat indices of patch i's window; ``running``
    is updated in place.

    Coverage only falls as the sweep goes on, so the count of a whole
    chunk of candidates at the chunk's start bounds each one's count at
    its visit from above: candidates at or below pix_th there are passed
    over without a visit, the rest are visited in order with their exact
    count.  Once nothing remains no later candidate is taken in any sweep."""
    n = len(pmasks)
    selected = np.zeros(n, bool)
    rem = int(np.count_nonzero(running * inner > 0.5))
    for pix_th in pix_ths:
        for s in range(0, n, chunk):
            if rem <= 0:
                return selected
            idx = np.arange(s, min(n, s + chunk))
            idx = idx[~selected[idx] & ~overlap_rows[idx]]
            bound = np.sum(pmasks[idx] * running[win[idx]], axis=1)
            for i in idx[bound > pix_th]:
                w = win[i]
                newly = pmasks[i] * running[w]
                if rem > 0 and newly.sum() > pix_th:
                    rem -= int(np.count_nonzero(newly * inner[w] > 0.5))
                    running[w] -= newly
                    selected[i] = True
    return selected


def _thin_cover_lazy(pmasks, win, running, inner, centers, ps,
                     max_it=None):
    """Exact lazy greedy set cover (cover.py:143-234) over the flat
    rad-padded volumes ``running`` / ``inner``; ``win[i]`` holds the flat
    indices of patch i's window.  Stops at ``max_it`` iterations (64 n +
    1024 by default, as the reference).  Returns (selected, capped)."""
    n = len(centers)
    if max_it is None:
        max_it = 64 * n + 1024
    sizes = np.sum(pmasks * running[win], axis=1, dtype=np.float64)
    stale = np.zeros(n, bool)
    selected = np.zeros(n, bool)
    rem = float(np.dot(running, inner))
    picks = it = 0
    done = False
    while not done and picks < n and rem > 0 and it < max_it:
        it += 1
        best = int(np.argmax(sizes))
        if stale[best]:
            sizes[best] = float(np.dot(pmasks[best], running[win[best]]))
            stale[best] = False
            continue
        best_size = sizes[best]
        # the reference marks the pick before its zero-size stop
        selected[best] = True
        if best_size > 0:
            w = win[best]
            newly = pmasks[best] * running[w]
            rem -= float(np.dot(newly, inner[w]))
            running[w] -= newly
            near = np.all(np.abs(centers - centers[best][None]) < ps[None],
                          axis=1)
            stale |= near
            stale[best] = False
            sizes[best] = 0.0
        picks += 1
        done = best_size <= 0
    return selected, it >= max_it


def _thin_cover_full(pmasks, win, running, inner):
    """Exact full-recompute greedy set cover (cover.py:237-284)."""
    n = len(pmasks)
    selected = np.zeros(n, bool)
    picks, last = 0, 1.0
    while np.dot(running, inner) > 0 and last > 0 and picks < n:
        sizes = np.sum(pmasks * running[win], axis=1, dtype=np.float64)
        best = int(np.argmax(sizes))
        last = sizes[best]
        selected[best] = True
        if last > 0:
            running[win[best]] -= pmasks[best] * running[win[best]]
        picks += 1
    return selected


def _thin_cover_volumes(mask_to_cover: np.ndarray, centers: np.ndarray,
                        ps: np.ndarray):
    """(win, running, inner) for the set-cover loops: the to-cover mask and
    the interior, rad-padded and flattened (float32), and for each patch
    the flat indices of its window, centers[i] + off(p) in padded
    coordinates."""
    rad = ps // 2
    pads = [(int(r), int(r)) for r in rad]
    running = np.pad(np.asarray(mask_to_cover, np.float32), pads)
    inner = np.pad(interior(mask_to_cover.shape, rad).astype(np.float32),
                   pads)
    # the flat index is linear in the coordinates: lin(c + off) = lin(c) +
    # lin(off)
    strides = np.array([np.prod(running.shape[a + 1:], dtype=np.int64)
                        for a in range(len(ps))])
    win = (centers @ strides)[:, None] + (patch_offsets(ps) @ strides)[None]
    return win, running.reshape(-1), inner.reshape(-1)


def thin_out_cover_device(affs: torch.Tensor, mask_to_cover: np.ndarray,
                          selected_patches: list, patchshape,
                          fc_threshold: float = 0.5) -> list:
    """Greedy set-cover thinning of the selected patches: repeatedly keep
    the patch covering the most still-uncovered pixels."""
    ps = np.asarray(patchshape, dtype=np.int64)
    if not selected_patches:
        return []
    centers = np.array([rp[0] for rp in selected_patches], dtype=np.int64)
    if _route(affs, "thin cover"):
        selected = thin_cover_cuda(affs, mask_to_cover, centers, ps,
                                   fc_threshold)[0]
    else:
        selected = thin_cover_plain(affs, mask_to_cover, centers, ps,
                                    fc_threshold)
    return [rp for i, rp in enumerate(selected_patches) if selected[i]]
