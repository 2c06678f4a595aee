"""Host-side assembly stages, copied from ``patchperpix_tpu/ops/np_reference.py``.

The patch geometry helpers, the ranked-list sort, the host greedy cover
and set-cover thinning (the path of the [vote_instances] options that need
the host loop: ``score_threshold``, the overlap-neighbourhood second pass,
``mark_close_neighboorhood``), candidate patch pairs, connected components
/ mutex watershed over the patch graph and the instance painter.  They
follow the reference PatchPerPix semantics (foreground_cover.py,
get_patch_sets.py, aff_patch_graph.py, graph_to_labeling.py, graph_mws.py)
exactly and are kept equal in behaviour to the JAX package's copies, which
the tests check.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_dilation


def neigh_extent(patchshape: np.ndarray) -> np.ndarray:
    """Consensus offset-axis extents: 2*ps-1 where ps>1, else 1."""
    ps = np.asarray(patchshape)
    return np.where(ps > 1, 2 * ps - 1, 1)


def patch_offsets(patchshape: np.ndarray) -> np.ndarray:
    """(P, ndim) integer patch coordinates in C order (linear index order)."""
    ps = tuple(int(p) for p in patchshape)
    grid = np.stack(np.meshgrid(*[np.arange(p) for p in ps], indexing="ij"),
                    axis=-1)
    return grid.reshape(-1, len(ps))


def bg_threshold(th: float, bg_mode: str) -> float:
    """Background-vote threshold variant (utilVoteInstances.py:389-406).

    ``inv``  : v2 < 1-th (falls back to "less" when th < 0.5)
    ``half`` : v2 < th/2
    ``less`` : v2 < th     (flylight default: vi_bg_use_less_than_th)
    """
    if bg_mode == "inv":
        return (1.0 - th) if th >= 0.5 else th
    if bg_mode == "half":
        return th / 2.0
    if bg_mode == "less":
        return th
    raise ValueError(f"unknown bg_mode {bg_mode}")


def rank_patch_list(all_patches, scores):
    """Sort patch centers by score, descending (ranked_patches.py:21-30).

    Python's sort is stable, so ties keep the (scan-order) center order.
    Returns list of (center ndarray, score).
    """
    ranked = [(np.asarray(idx), float(scores[tuple(idx)]))
              for idx in all_patches]
    ranked.sort(key=lambda t: t[1], reverse=True)
    return ranked


def _cover_loop(affs, running, radslice, ranked_patches, overlap, selected,
                ps, rad, pix_th, fc_threshold, score_threshold, marked,
                mark_close):
    """One ranked-list scan of the greedy cover
    (foreground_cover.py:111-180)."""
    for r, (idx, sc) in enumerate(ranked_patches):
        if not running[radslice].any():
            break
        if selected[r]:
            continue
        if score_threshold is not None and sc < score_threshold:
            break
        idx = np.asarray(idx)
        if mark_close and marked[tuple(idx)]:
            continue
        if overlap is not None and overlap[tuple(idx)] > 0:
            continue
        patch = affs[(slice(None),) + tuple(idx)].reshape(tuple(ps))
        window = tuple(slice(int(i - rr), int(i + rr + 1))
                       for i, rr in zip(idx, rad))
        pmask = patch > fc_threshold
        covered = int(np.count_nonzero(running[window][pmask]))
        if covered > pix_th:
            selected[r] = True
            if mark_close:
                # radius (0, 3, 3) neighbourhood (foreground_cover.py:162-168)
                m_rad = np.zeros(len(ps), dtype=np.int64)
                m_rad[-2:] = 3
                m_sl = tuple(slice(max(int(i - mr), 0), int(i + mr + 1))
                             for i, mr in zip(idx, m_rad))
                marked[m_sl] = True
            running[window][pmask] = False


def foreground_cover_reference(
    affs: np.ndarray,
    mask_to_cover: np.ndarray,
    ranked_patches: list,
    patchshape,
    fc_threshold: float = 0.5,
    overlap: np.ndarray | None = None,
    sparse_data: bool = False,
    score_threshold: float | None = None,
    overlap_neighborhood: bool = False,
    mark_close: bool = False,
):
    """Greedy foreground cover on the host (foreground_cover.py:15-180).

    Walks the ranked list; selects a patch when it covers more than pix_th
    still-uncovered pixels, which are then removed.  pix_th cascades
    500/100/50/10/0 below P // 2 for dense data ([0] for sparse), each pass
    rescanning from the start; ``score_threshold`` ends a pass at the first
    candidate scoring below it.

    ``overlap_neighborhood`` adds the second pass around overlap regions
    (select_patches_overlap_neighborhood, foreground_cover.py:53-85): more
    patches from the 2..5-dilation ring of the overlap mask, the result
    returned in coordinate order with each center's score.
    ``mark_close`` (mark_close_neighboorhood) skips candidates within an
    in-plane radius-3 box of a selected center.
    Returns (selected list of (center, score), running mask after)."""
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    vol_shape = np.array(mask_to_cover.shape)
    radslice = tuple(slice(int(r), int(s - r))
                     for r, s in zip(rad, vol_shape))
    running = mask_to_cover.astype(bool).copy()
    selected = np.zeros(len(ranked_patches), dtype=bool)
    marked = np.zeros_like(running)

    mid = int(np.prod(ps) // 2)
    pix_ths = [0] if sparse_data else [t for t in (500, 100, 50, 10, 0)
                                       if t < mid]
    for pix_th in pix_ths:
        _cover_loop(affs, running, radslice, ranked_patches, overlap,
                    selected, ps, rad, pix_th, fc_threshold,
                    score_threshold, marked, mark_close)
        if not running[radslice].any():
            break

    if overlap_neighborhood and overlap is not None:
        sel_vol = np.zeros(tuple(vol_shape), dtype=bool)
        for i, (idx, _) in enumerate(ranked_patches):
            if selected[i]:
                sel_vol[tuple(np.asarray(idx))] = True
        ov = overlap.astype(bool)
        dil_mask = np.logical_and(
            ~binary_dilation(ov, iterations=2),
            binary_dilation(ov, iterations=5))
        fg_dil = np.logical_and(dil_mask, mask_to_cover.astype(bool))
        rp_list = [rp for rp in ranked_patches
                   if not sel_vol[tuple(np.asarray(rp[0]))]
                   and fg_dil[tuple(np.asarray(rp[0]))]]
        sel2 = np.zeros(len(rp_list), dtype=bool)
        _cover_loop(affs, fg_dil.copy(), radslice, rp_list, overlap, sel2,
                    ps, rad, pix_ths[-1], fc_threshold, score_threshold,
                    marked, mark_close)
        for i, (idx, _) in enumerate(rp_list):
            if sel2[i]:
                sel_vol[tuple(np.asarray(idx))] = True
        score_of = {tuple(np.asarray(idx)): sc
                    for idx, sc in ranked_patches}
        out = [(c, score_of.get(tuple(c), 0.0))
               for c in np.argwhere(sel_vol)]
        return out, running

    return [rp for i, rp in enumerate(ranked_patches) if selected[i]], \
        running


def patch_fg_set(idx, affs, mask, patchshape, fc_threshold):
    """Set of absolute coordinates a patch claims in ``mask``
    (get_patch_sets.py:32-54); empty for a patch crossing the border."""
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    idx = np.asarray(idx)
    start = idx - rad
    stop = idx + rad + 1
    if np.any(start < 0) or np.any(stop > np.array(mask.shape)):
        return set()
    patch = affs[(slice(None),) + tuple(idx)].reshape(tuple(ps))
    window = tuple(slice(int(s), int(e)) for s, e in zip(start, stop))
    sel = np.logical_and(patch > fc_threshold, mask[window])
    return set(map(tuple, (start + np.argwhere(sel)).tolist()))


def thin_out_cover_reference(
    affs: np.ndarray,
    mask_to_cover: np.ndarray,
    selected_patches: list,
    patchshape,
    fc_threshold: float = 0.5,
):
    """Greedy set-cover thinning on the host (foreground_cover.py:183-256):
    repeatedly keep the patch with the largest remaining pixel set, remove
    its pixels from the running mask and from every other set."""
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    vol_shape = np.array(mask_to_cover.shape)
    radslice = tuple(slice(int(r), int(s - r))
                     for r, s in zip(rad, vol_shape))
    running = mask_to_cover.astype(bool).copy()
    fgs = [patch_fg_set(rp[0], affs, mask_to_cover, ps, fc_threshold)
           for rp in selected_patches]
    selected = np.zeros(len(selected_patches), dtype=bool)
    while running[radslice].any():
        sizes = [len(s) for s in fgs]
        best = int(np.argmax(sizes))
        selected[best] = True
        best_fg = patch_fg_set(selected_patches[best][0], affs, running,
                               ps, fc_threshold)
        if best_fg:
            running[tuple(np.array(sorted(best_fg)).T)] = False
        fgs = [s - best_fg for s in fgs]
        if sizes[best] == 0 and not best_fg:
            break   # nothing can be covered anymore
    return [rp for i, rp in enumerate(selected_patches) if selected[i]]


def patch_pairs_reference(
    selected_patches: list,
    patchshape,
    max_ps_dist: float = 2.0,
    include_singleton: bool = True,
):
    """Candidate patch pairs (aff_patch_graph.py:43-110).

    Sorts centers by last coordinate (stable), finds all pairs within L1
    distance 2*sum(ps), drops pairs with any per-axis distance >
    max_ps_dist*ps, optionally appends self-pairs.  Returns (pairs array
    (N, 2*ndim) uint32, sorted points (M, ndim) uint32) or (None, pts).
    """
    from scipy.spatial import cKDTree

    ps = np.asarray(patchshape, dtype=np.float32)
    ndim = len(ps)
    patches = sorted(selected_patches, key=lambda p: p[0][ndim - 1])
    pts = np.array([p[0] for p in patches], dtype=np.uint32).reshape(-1, ndim)
    if len(pts) == 0:
        return None, pts
    tree = cKDTree(pts, leafsize=4)
    pairs = tree.query_pairs(2 * float(np.sum(ps)), output_type="ndarray",
                             p=1)
    # sort lexicographically (matches sorted(set-of-tuples))
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs = pairs[order]
    d = np.abs(pts[pairs[:, 0]].astype(np.float32)
               - pts[pairs[:, 1]].astype(np.float32))
    kept = pairs[~(d > max_ps_dist * ps).any(axis=1)]
    n = len(kept) + (len(pts) if include_singleton else 0)
    if n == 0:
        return None, pts
    arr = np.zeros((n, 2 * ndim), dtype=np.uint32)
    arr[:len(kept), :ndim] = pts[kept[:, 0]]
    arr[:len(kept), ndim:] = pts[kept[:, 1]]
    if include_singleton:
        arr[len(kept):, :ndim] = pts
        arr[len(kept):, ndim:] = pts
    return arr, pts


def graph_components(pairs: np.ndarray, weights: np.ndarray):
    """Mutex-watershed components of the patch graph (graph_mws.py:7-85;
    the plain connected components of graph_to_labeling.py:46-54 are
    ``ops.graph_device.graph_components_device``).  Nodes are patch-center
    tuples.  Returns a list of lists of node tuples (deterministic order).
    """
    ndim = pairs.shape[1] // 2
    keep = np.asarray(weights) != 0
    # (a, b, w) with Python-int tuples and floats, converted in bulk
    edges = list(zip(map(tuple, pairs[keep, :ndim].tolist()),
                     map(tuple, pairs[keep, ndim:].tolist()),
                     np.asarray(weights, np.float64)[keep].tolist()))
    return _mws(edges)


def _mws(edges):
    """Mutex watershed on the patch graph (graph_mws.py:7-85 semantics).

    Kruskal over |aff|-sorted edges; positive edges merge unless a mutex
    (negative edge seen earlier at higher |aff|) separates the two
    clusters.  Union-find with per-cluster mutex sets that merge (and
    re-point) on union; output-identical to the literal re-scan
    formulation (``_mws_naive`` in the JAX package): same cluster ids
    (created on first merge, min id kept), same membership, same order.
    """
    nodes = []
    node_ids = {}
    for a, b, w in edges:
        for n in (a, b):
            if n not in node_ids:
                node_ids[n] = len(nodes)
                nodes.append(n)
    typed = [(node_ids[a], node_ids[b], abs(w), 1 if w > 0 else -1)
             for a, b, w in edges]
    typed.sort(key=lambda x: x[2], reverse=True)

    N = len(nodes)
    parent = list(range(N))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    cid = [0] * N            # naive loop's cluster id; 0 = singleton pool
    members = {}             # root -> member node ids (only once merged)
    mutex_sets = {}          # root -> set of mutexed roots
    next_cc = 1
    for e0, e1, a, attractive in typed:
        r0, r1 = find(e0), find(e1)
        if attractive == 1:
            if r0 == r1:
                continue
            ms0 = mutex_sets.get(r0)
            if ms0 is not None and r1 in ms0:
                continue
            c0, c1 = cid[r0], cid[r1]
            if c0 and c1:
                new_id = min(c0, c1)
            elif c0 or c1:
                new_id = max(c0, c1)
            else:
                new_id = next_cc
                next_cc += 1
            m0 = members.get(r0) or [r0]
            m1 = members.get(r1) or [r1]
            if len(m0) < len(m1):         # union by size
                r0, r1 = r1, r0
                m0, m1 = m1, m0
            parent[r1] = r0
            m0.extend(m1)
            members[r0] = m0
            members.pop(r1, None)
            cid[r0] = new_id
            ms1 = mutex_sets.pop(r1, None)
            if ms1:
                ms0 = mutex_sets.setdefault(r0, set())
                for m in ms1:
                    mutex_sets[m].discard(r1)
                    mutex_sets[m].add(r0)
                    ms0.add(m)
        elif r0 != r1:
            mutex_sets.setdefault(r0, set()).add(r1)
            mutex_sets.setdefault(r1, set()).add(r0)

    by_id = {}
    for r, m in members.items():
        by_id[cid[r]] = m
    return [[nodes[i] for i in sorted(by_id[c])] for c in sorted(by_id)]


def components_to_instances(components, patches: dict, patchshape,
                            vol_shape, patch_threshold: float = 0.5,
                            one_instance_per_channel: bool = False,
                            no_overlap_per_channel: bool = False,
                            min_pack_size: int = 2000):
    """Paint components into an instance label volume
    (graph_to_labeling.py:56-115), later components over earlier ones.

    ``patches`` maps each node's center tuple to its (P,) patch vector,
    the reference's ``sparse_labels`` mode (graph_to_labeling.py:65-67):
    only the components' patches leave the device.

    ``one_instance_per_channel`` returns a (C, *vol) stack, one instance
    per channel; ``no_overlap_per_channel`` packs them into as few channels
    as it can: an instance of more than ``min_pack_size`` pixels takes the
    first channel it overlaps nothing in, or opens a new one, smaller ones
    go into channel 0 (graph_to_labeling.py:96-113).
    """
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    vol_shape = tuple(int(s) for s in vol_shape)
    instances = np.zeros(vol_shape, dtype=np.uint16)
    per_channel = []
    multi = one_instance_per_channel or no_overlap_per_channel
    for value, comp in enumerate(components, start=1):
        tgt = np.zeros(vol_shape, dtype=np.uint16) if multi else instances
        for idx in comp:
            idx = np.asarray(idx)
            patch = np.asarray(
                patches[tuple(int(i) for i in idx)]).reshape(tuple(ps))
            start = np.maximum(0, idx - rad)
            stop = np.minimum(idx + rad + 1, vol_shape)
            window = tuple(slice(int(s), int(e))
                           for s, e in zip(start, stop))
            psl = tuple(slice(int(s - (i - r)), int(ps_ - ((i + r + 1) - e)))
                        for s, e, i, r, ps_ in
                        zip(start, stop, idx, rad, ps))
            tgt[window][patch[psl] > patch_threshold] = value
        if one_instance_per_channel:
            per_channel.append(tgt)
        elif no_overlap_per_channel:
            mask = tgt > 0
            if not per_channel:
                per_channel.append(tgt)
            elif int(mask.sum()) > min_pack_size:
                for chan in per_channel:
                    if np.all(chan[mask] == 0):
                        chan[mask] = value
                        break
                else:
                    per_channel.append(tgt)
            else:
                per_channel[0][mask] = value
    if multi:
        return (np.stack(per_channel, axis=0) if per_channel
                else np.zeros((0,) + vol_shape, dtype=np.uint16))
    return instances


def interior(vol_shape, rad) -> np.ndarray:
    """bool (*vol): voxels at least ``rad`` from every border (the patch
    centers whose patch lies inside the volume)."""
    out = np.zeros(tuple(int(s) for s in vol_shape), dtype=bool)
    out[tuple(slice(int(r), int(s) - int(r))
              for r, s in zip(rad, vol_shape))] = True
    return out
