"""Connected components of the patch graph on the device.

Counterpart of ``patchperpix_tpu/ops/graph_device.py``: min-label
propagation with pointer jumping, the labeling the assembly uses when the
mutex watershed is off.  Nodes are the patch centers of positive-weight
edges; two nodes share a component iff positive edges connect them.
Components come in the order in which their first member appears in the
positive edge list, and members keep their first-appearance order (a
before b within an edge): the host union-find's enumeration, which decides
instance ids and paint order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device


def _label_propagation(e0: torch.Tensor, e1: torch.Tensor,
                       n_nodes: int) -> torch.Tensor:
    """(n_nodes,) int64 labels, the minimum node index of each component:
    every edge pulls both ends down to the smaller label, then every label
    jumps to its label's label, until nothing changes."""
    labels = torch.arange(n_nodes, dtype=torch.int64, device=e0.device)
    while True:
        m = torch.minimum(labels[e0], labels[e1])
        new = labels.scatter_reduce(0, e0, m, "amin")
        new = new.scatter_reduce(0, e1, m, "amin")
        new = torch.minimum(new, new[new])
        if torch.equal(new, labels):
            return labels
        labels = new


def graph_components_device(pairs: np.ndarray, weights: np.ndarray,
                            device="cuda") -> list:
    """Components of the positive-edge patch graph: a list of lists of
    node tuples, in the host union-find's order."""
    dev = resolve_device(device)
    pairs = np.asarray(pairs)
    ndim = pairs.shape[1] // 2
    pos = np.asarray(weights) > 0
    if not pos.any():
        return []
    pp = pairs[pos].astype(np.int64)
    # node ids in first-appearance order over the positive edge list
    flat = np.stack([pp[:, :ndim], pp[:, ndim:]], axis=1).reshape(-1, ndim)
    coords, first_idx, inverse = np.unique(flat, axis=0, return_index=True,
                                           return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    coords = coords[order]
    new_id = np.empty(len(order), np.int64)
    new_id[order] = np.arange(len(order))
    ids = new_id[inverse.reshape(-1)].reshape(-1, 2)
    labels = _label_propagation(
        torch.as_tensor(ids[:, 0], device=dev),
        torch.as_tensor(ids[:, 1], device=dev), len(coords)).cpu().numpy()
    comps: dict = {}
    for node, label in zip(coords.tolist(), labels.tolist()):
        comps.setdefault(label, []).append(tuple(node))
    return list(comps.values())
