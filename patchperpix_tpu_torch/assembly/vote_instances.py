"""Vote-instances assembly on the device.

Counterpart of ``patchperpix_tpu/assembly/vote_instances.py`` along its
main path (``to_instance_seg`` with the consensus and rank kernels,
vote_instances.py:375-780): consensus (CUDA kernel) -> rank (CUDA kernel)
-> candidate gather and host stable sort -> greedy cover (min-scatter for
sparse data, the threshold cascade for dense data) -> lazy thin cover ->
host patch pairs -> symmetrized consensus + graph weights -> components
(host mutex watershed, or label propagation on the device when mws is off)
-> paint from a thresholded device gather.

3D volumes and 2D ones run the same stages; a 2D volume is the flat-z
volume (1, H, W) with patchshape (1, p, p), as in the JAX package, and
takes the 2D kernels (``ops/consensus_kernels.py``).  ``consensus_bf16``
is honoured as given in 2D as in 3D: the JAX package's automatic switch
to a bf16 consensus above 1.5 GB answers a 16 GB TPU and is not carried
over.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import np_reference as ref
from ..ops.consensus import (ConsensusConfig, patch_graph_weights,
                             symmetrize_half)
from ..ops.consensus_kernels import (consensus_half, consensus_operands,
                                     rank_scores)
from ..ops.cover import greedy_cover_device, thin_out_cover_device
from ..ops.graph_device import graph_components_device
from ..utils.device import resolve_device


@dataclass
class VoteInstancesParams:
    """The [vote_instances] fields the port's path reads (defaults: the
    FlyLight reference config, as in the JAX package)."""
    patchshape: tuple = (7, 7, 7)
    patch_threshold: float = 0.5
    fc_threshold: float = 0.5
    select_patches_for_sparse_data: bool = True
    skeletonize_foreground: bool = False
    mws: bool = False
    includeSinglePatchCCS: bool = True
    removeIntersection: bool = True
    overlapping_inst: bool = False
    consensus_norm_prob_product: bool = True
    consensus_prob_product: bool = True
    consensus_norm_aff: bool = True
    vi_bg_use_half_th: bool = False
    vi_bg_use_less_than_th: bool = True
    rank_norm_patch_score: bool = True
    rank_int_counter: bool = False
    consensus_bf16: bool = False
    patch_graph_norm_aff: bool = True
    max_total_patch_distance_in_ps_multiples: float = 2.0
    numinst_threshs: tuple = (0.9, 0.1)

    @property
    def bg_mode(self) -> str:
        if self.vi_bg_use_less_than_th:
            return "less"
        if self.vi_bg_use_half_th:
            return "half"
        return "inv"

    @property
    def weight_mode(self) -> str:
        if self.consensus_norm_prob_product:
            return "norm_prob_product"
        if self.consensus_prob_product:
            return "prob_product"
        return "count"

    def consensus_config(self) -> ConsensusConfig:
        return ConsensusConfig(
            patchshape=tuple(int(p) for p in self.patchshape),
            patch_threshold=self.patch_threshold,
            bg_mode=self.bg_mode,
            weight_mode=self.weight_mode,
            norm_aff=self.consensus_norm_aff,
            norm_rank=self.rank_norm_patch_score,
            rank_int_counter=self.rank_int_counter,
            norm_graph=self.patch_graph_norm_aff,
            overlapping_inst=self.overlapping_inst,
            cons_bf16=self.consensus_bf16)


def numinst_from_probs(prob: np.ndarray,
                       params: VoteInstancesParams) -> np.ndarray:
    """Per-voxel instance count from class probabilities: per-class
    thresholds when configured, else argmax."""
    prob = np.asarray(prob, dtype=np.float32)
    if params.numinst_threshs:
        numinst = np.zeros(prob.shape[1:], dtype=np.uint8)
        for i, t in enumerate(params.numinst_threshs):
            numinst[prob[i + 1] > t] = i + 1
        return numinst
    return np.argmax(prob, axis=0).astype(np.uint8)


def _paint_src(affs: torch.Tensor, comps, patch_threshold: float) -> dict:
    """Component nodes' patch columns, thresholded on the device
    (``> patch_threshold``, the only test the painter applies), as a
    {center: (P,) uint8} dict for ``components_to_instances``."""
    nodes = [idx for comp in comps for idx in comp]
    if not nodes:
        return {}
    pts = np.asarray(nodes, dtype=np.int64)
    p = torch.as_tensor(pts, device=affs.device)
    cols = (affs[:, p[:, 0], p[:, 1], p[:, 2]] > patch_threshold)
    cols = cols.to(torch.uint8).cpu().numpy()
    return {tuple(int(x) for x in c): cols[:, i] for i, c in enumerate(pts)}


class _Stages:
    """Per-stage wall seconds, synchronizing the device at each boundary
    (only when the caller asks for the times)."""

    def __init__(self, out: dict | None, device):
        self.out, self.device = out, device
        self.t = time.perf_counter()

    def mark(self, name: str):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = now - self.t
        self.t = now


def to_instance_seg(pred_affs, foreground: np.ndarray,
                    mask_to_cover: np.ndarray, numinst: np.ndarray,
                    params: VoteInstancesParams, device="cuda",
                    timings: dict | None = None, intermediates: dict | None
                    = None):
    """Full assembly of a (P, *vol) affinity stack; *vol is (Z, Y, X),
    with Z == 1 and patchshape (1, p, p) for 2D.

    Returns (instances uint16, foreground uint8) as numpy arrays.
    ``timings``, if given, receives per-stage seconds; ``intermediates``,
    if given, receives the candidate order, the selected patches, the
    pairs and the graph weights."""
    dev = resolve_device(device)
    if params.skeletonize_foreground:
        raise NotImplementedError("skeletonize_foreground is not ported")
    ps = np.asarray(params.patchshape, dtype=np.int64)
    if len(ps) != 3:
        raise ValueError("patchshape must have three extents; 2D is "
                         "(1, p, p) on a (1, H, W) volume")
    rad = ps // 2
    if torch.is_tensor(pred_affs):
        affs = pred_affs.to(device=dev, dtype=torch.float32).contiguous()
    else:
        affs = torch.tensor(np.asarray(pred_affs), dtype=torch.float32,
                            device=dev)
    foreground = np.asarray(foreground).astype(bool)
    vol_shape = foreground.shape
    inner = ref.interior(vol_shape, rad)
    overlap_mask = (np.asarray(numinst) > 1).astype(np.uint8)
    mask_to_cover = np.asarray(mask_to_cover).astype(bool).copy()
    mask_to_cover[overlap_mask > 0] = False
    instances = np.zeros(vol_shape, dtype=np.uint16)
    if not np.any(mask_to_cover & inner):
        return instances, foreground.astype(np.uint8)

    stages = _Stages(timings, dev)
    inter = intermediates if intermediates is not None else {}
    ccfg = params.consensus_config()
    overlap = (torch.as_tensor(overlap_mask > 0, device=dev)
               if params.overlapping_inst else None)

    # (1) consensus: operands in PyTorch (2D: one gated stack and a target
    # plane; 3D: the mask stacks), the canonical half from the kernel
    operands = consensus_operands(affs, ccfg, overlap)
    cons = consensus_half(affs, operands, ccfg)
    stages.mark("consensus")

    # (2) rank kernel, then a gather of the candidates' scores and the
    # host stable descending sort (ties keep scan order)
    scores = rank_scores(affs, cons, operands, ccfg)
    del operands
    cand = np.argwhere(foreground & inner)
    if len(cand) == 0:
        return instances, foreground.astype(np.uint8)
    flat = torch.as_tensor(np.ravel_multi_index(tuple(cand.T), vol_shape),
                           device=dev)
    svals = scores.reshape(-1)[flat].cpu().numpy().astype(np.float32)
    order = np.argsort(-svals, kind="stable")
    ranked = [(cand[i], float(svals[i])) for i in order]
    inter["ranked_centers"] = cand[order]
    inter["ranked_scores"] = svals[order]
    stages.mark("rank")

    # (3) greedy cover (4) thin-out set cover
    selected, _ = greedy_cover_device(
        affs, mask_to_cover, ranked, ps, fc_threshold=params.fc_threshold,
        overlap=overlap_mask,
        sparse_data=params.select_patches_for_sparse_data)
    inter["cover_centers"] = np.array([c for c, _ in selected])
    stages.mark("cover")
    if selected:
        selected = thin_out_cover_device(
            affs, mask_to_cover, selected, ps,
            fc_threshold=params.fc_threshold)
    inter["thin_centers"] = np.array([c for c, _ in selected])
    stages.mark("thin_cover")

    # (5) patch pairs (host) + patch-graph weights (device)
    pairs, _ = ref.patch_pairs_reference(
        selected, ps,
        max_ps_dist=params.max_total_patch_distance_in_ps_multiples,
        include_singleton=params.includeSinglePatchCCS)
    stages.mark("pairs")
    if pairs is None or len(pairs) == 0:
        return instances, foreground.astype(np.uint8)
    sym = symmetrize_half(cons, ccfg)
    del cons
    weights = patch_graph_weights(affs, sym, pairs, ccfg,
                                  drop_intersection=params.removeIntersection)
    del sym
    inter["pairs"], inter["weights"] = pairs, weights
    stages.mark("graph")

    # (6) components (host mutex watershed, or label propagation on the
    # device) -> painting
    if params.mws:
        comps = ref.graph_components(pairs, weights)
    else:
        comps = graph_components_device(pairs, weights, dev)
    paint = _paint_src(affs, comps, params.patch_threshold)
    instances = ref.components_to_instances(
        comps, paint, ps, vol_shape, patch_threshold=params.patch_threshold)
    inter["n_components"] = len(comps)
    stages.mark("mws_paint")
    return instances.astype(np.uint16), foreground.astype(np.uint8)
