"""Host-side assembly stages, copied from ``patchperpix_tpu/ops/np_reference.py``.

Only what the port's main path runs: the patch geometry helpers, the
ranked-list sort, candidate patch pairs, connected components / mutex
watershed over the patch graph and the instance painter.  They follow the
reference PatchPerPix semantics (aff_patch_graph.py, graph_to_labeling.py,
graph_mws.py) exactly and are kept byte-for-byte equal in behaviour to the
JAX package's copies, which the tests check.
"""

from __future__ import annotations

import numpy as np


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
                            vol_shape, patch_threshold: float = 0.5):
    """Paint components into one instance label volume
    (graph_to_labeling.py:56-115), later components over earlier ones.

    ``patches`` maps each node's center tuple to its (P,) patch vector,
    the reference's ``sparse_labels`` mode (graph_to_labeling.py:65-67):
    only the components' patches leave the device.
    """
    ps = np.asarray(patchshape, dtype=np.int64)
    rad = ps // 2
    vol_shape = tuple(int(s) for s in vol_shape)
    instances = np.zeros(vol_shape, dtype=np.uint16)
    for value, comp in enumerate(components, start=1):
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
            instances[window][patch[psl] > patch_threshold] = value
    return instances


def interior(vol_shape, rad) -> np.ndarray:
    """bool (*vol): voxels at least ``rad`` from every border (the patch
    centers whose patch lies inside the volume)."""
    out = np.zeros(tuple(int(s) for s in vol_shape), dtype=bool)
    out[tuple(slice(int(r), int(s) - int(r))
              for r, s in zip(rad, vol_shape))] = True
    return out
