"""Vote-instances assembly on the device.

Counterpart of ``patchperpix_tpu/assembly/vote_instances.py`` along its
main path (``to_instance_seg`` with the consensus and rank kernels,
vote_instances.py:375-780): consensus (CUDA kernel) -> rank (CUDA kernel)
-> candidate gather and host stable sort -> greedy cover (min-scatter for
sparse data, the threshold cascade for dense data) -> lazy thin cover ->
host patch pairs -> symmetrized consensus + graph weights -> components
(host mutex watershed, or label propagation on the device when mws is off)
-> paint from a thresholded device gather.

The blockwise contract (``assembly/blockwise.py``) is that of the JAX
package: ``center_valid`` gates the candidate centers and the kernels'
operands to the interior of the whole volume; ``return_intermediates``
returns (pairs, weights), or (None, None), instead of an instance map;
``selected_patch_pairs`` with ``skipRanking`` (stitch windows) runs the
consensus and the graph weights of the given pairs, and no rank and no
cover.

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
    # blockwise assembly (assembly/blockwise.py) and its prediction store
    blockwise: bool = False
    ignore_small_comps: int = 0
    chunksize: tuple = (92, 92, 92)
    num_parallel_blocks: int = 1
    chessboard: bool = False
    block_devices: int = 0           # > 1: the multi-device slice, raises
    aff_key: str = "volumes/pred_affs"
    code_key: str = "volumes/pred_code"
    numinst_key: str | None = None
    fg_key: str | None = None
    fg_thresh_vi: float = -1.0
    # the blockwise contract of to_instance_seg
    return_intermediates: bool = False
    skipRanking: bool = False
    selected_patch_pairs: np.ndarray | None = None
    center_valid: np.ndarray | None = None

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


def _derive_fg_numinst(io, params: VoteInstancesParams,
                       center_channel_reader=None):
    """(numinst, foreground) from a prediction store without reading the
    dense affinities: numinst from the class probabilities under
    ``numinst_key``, else the ``fg_key`` probability above the threshold,
    else the center affinity channel that ``center_channel_reader``
    returns.  Closes ``io``."""
    fg_thresh = params.fg_thresh_vi if params.fg_thresh_vi > 0 \
        else params.patch_threshold
    numinst = None
    if params.numinst_key:
        prob = np.squeeze(io.read(key=params.numinst_key)).astype(np.float32)
        if prob.ndim == 3:
            prob = prob[:, None]
        numinst = numinst_from_probs(prob, params)
        foreground = numinst > 0
    elif params.fg_key:
        fg_prob = np.squeeze(io.read(key=params.fg_key))
        if fg_prob.ndim == 2:
            fg_prob = fg_prob[None]
        foreground = fg_prob > fg_thresh
    else:
        assert center_channel_reader is not None
        foreground = center_channel_reader() > fg_thresh
    io.close()
    if numinst is None:
        numinst = foreground.astype(np.uint8)
    return numinst, foreground.astype(bool)


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

    Returns (instances uint16, foreground uint8) as numpy arrays, or with
    ``params.return_intermediates`` (pairs, weights), (None, None) where
    nothing is assembled.  ``timings``, if given, receives per-stage
    seconds; ``intermediates``, if given, receives the candidate order,
    the selected patches, the pairs and the graph weights, and
    ``consensus`` True once the consensus kernel has run."""
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

    def nothing():
        if params.return_intermediates:
            return None, None
        return instances, foreground.astype(np.uint8)

    if not np.any(mask_to_cover & inner):
        return nothing()

    stages = _Stages(timings, dev)
    inter = intermediates if intermediates is not None else {}
    ccfg = params.consensus_config()
    overlap = (torch.as_tensor(overlap_mask > 0, device=dev)
               if params.overlapping_inst else None)
    cv = None
    if params.center_valid is not None:
        cv_np = np.asarray(params.center_valid, dtype=bool)
        if cv_np.shape != vol_shape:
            raise ValueError(f"center_valid {cv_np.shape} != volume "
                             f"{vol_shape}")
        inner = inner & cv_np
        cv = torch.as_tensor(cv_np, device=dev)
    injected = params.selected_patch_pairs is not None
    skip_rank = params.skipRanking and injected

    # (1) consensus: operands in PyTorch (2D: one gated stack and a target
    # plane; 3D: the mask stacks), the canonical half from the kernel
    operands = consensus_operands(affs, ccfg, overlap, cv)
    cons = consensus_half(affs, operands, ccfg)
    inter["consensus"] = True
    stages.mark("consensus")

    # (2) rank kernel, then a gather of the candidates' scores and the
    # host stable descending sort (ties keep scan order); injected pairs
    # with skipRanking (stitch windows) need neither
    cand = np.argwhere(foreground & inner)
    if skip_rank:
        del operands
        if len(cand) == 0:
            return nothing()
    else:
        scores = rank_scores(affs, cons, operands, ccfg, cv)
        del operands
        if len(cand) == 0:
            return nothing()
        flat = torch.as_tensor(
            np.ravel_multi_index(tuple(cand.T), vol_shape), device=dev)
        svals = scores.reshape(-1)[flat].cpu().numpy().astype(np.float32)
        del scores
        order = np.argsort(-svals, kind="stable")
        ranked = [(cand[i], float(svals[i])) for i in order]
        inter["ranked_centers"] = cand[order]
        inter["ranked_scores"] = svals[order]
    stages.mark("rank")

    if injected:
        # (3)-(5) the pair list is given: the cover stages would only feed
        # the pair generation
        pairs = np.asarray(params.selected_patch_pairs, dtype=np.uint32)
    else:
        # (3) greedy cover (4) thin-out set cover
        selected, _ = greedy_cover_device(
            affs, mask_to_cover, ranked, ps,
            fc_threshold=params.fc_threshold, overlap=overlap_mask,
            sparse_data=params.select_patches_for_sparse_data)
        inter["cover_centers"] = np.array([c for c, _ in selected])
        stages.mark("cover")
        if selected:
            selected = thin_out_cover_device(
                affs, mask_to_cover, selected, ps,
                fc_threshold=params.fc_threshold)
        inter["thin_centers"] = np.array([c for c, _ in selected])
        stages.mark("thin_cover")
        # (5) patch pairs (host)
        pairs, _ = ref.patch_pairs_reference(
            selected, ps,
            max_ps_dist=params.max_total_patch_distance_in_ps_multiples,
            include_singleton=params.includeSinglePatchCCS)
    stages.mark("pairs")
    if pairs is None or len(pairs) == 0:
        return nothing()
    # patch-graph weights (device)
    sym = symmetrize_half(cons, ccfg)
    del cons
    weights = patch_graph_weights(affs, sym, pairs, ccfg,
                                  drop_intersection=params.removeIntersection)
    del sym
    inter["pairs"], inter["weights"] = pairs, weights
    stages.mark("graph")
    if params.return_intermediates:
        return pairs, weights

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
