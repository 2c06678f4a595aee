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

With ``skeletonize_foreground`` the mask to cover is thinned to its
skeleton (``utils/skeleton.py``, host C++) before the overlap voxels are
cleared, and only when not blockwise: blockwise assembly skeletonizes the
whole sample's mask once (``assembly/blockwise.py``), never a block or a
stitch window.

The reference CLI's ``label`` task runs ``do_all``: ``load_affinities``
from a prediction store, ``to_instance_seg`` (or blockwise assembly), and
``finalize_and_write``, which writes ``<sample>.hdf`` under the JAX
package's keys and attributes (``utils/io.py``'s ``IoHDF5``: numpy,
struct and zlib, since the GPU machine has no h5py).  With
``vote_debug`` the whole-volume branch of ``do_all`` labels in two passes,
as the JAX package does: the pairs and weights first, the debug canvases
(``assembly/debug_viz.py``) from them, then the labelling of that given
graph, which runs no consensus or rank.  ``save_mip`` writes colour label
MIPs before and after the small-component removal and ``save_tif`` the
relabelled uint16 cleaned volume (``utils/io.py``'s PNG and TIFF writers).
``VoteInstancesParams.from_config`` reads a [vote_instances] section.

``sharded_devices`` > 1 (-1: every device) z-shards the consensus and
rank over a mesh of devices (``parallel/sharded.py``), and passes the
mesh on to the cover (the sharded closed form) and the graph weights
(first-patch groups round-robin over the devices).  The JAX package's
rule picks the mesh size (``_sharded_mesh_size``): one device when Z does
not divide or a slab would be thinner than the 3*rad halo, which is
logged.

The options of the JAX package's ``to_instance_seg`` follow its branches:
``pad_with_ps``, the ISBI hacks (``assembly/isbi_hacks.py``), ``sample``
/ ``seed``, ``shuffle_patches``, ``store_scores``, the host cover that
``score_threshold``, ``select_patches_overlap_neighborhood`` and
``mark_close_neighboorhood`` need (one device-to-host copy of the stack,
as in the JAX package), the skip flags, injected ``selected_patches`` or
``aff_graph``, the score oracle and the multi-channel outputs.  ``sample <
1`` thins each patch's pixels by a keep mask drawn on the host with
``np.random.RandomState(seed)`` and uploaded once: that is the JAX
package's host (``engine="numpy"``) draw, bit for bit; its device path
draws with ``jax.random.bernoulli``, a stream the port does not reproduce.

3D volumes and 2D ones run the same stages; a 2D volume is the flat-z
volume (1, H, W) with patchshape (1, p, p), as in the JAX package, and
takes the 2D kernels (``ops/consensus_kernels.py``).  ``consensus_bf16``
is honoured as given in 2D as in 3D: the JAX package's automatic switch
to a bf16 consensus above 1.5 GB answers a 16 GB TPU and is not carried
over.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, fields

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage
from scipy.special import expit

from ..ops import np_reference as ref
from ..ops.consensus import (ConsensusConfig, patch_graph_weights,
                             symmetrize_half)
from ..ops.consensus_kernels import (consensus_half, consensus_operands,
                                     rank_scores)
from ..ops.cover import greedy_cover_device, thin_out_cover_device
from ..ops.graph_device import graph_components_device
from ..parallel import sharded
from ..utils import io as vio
from ..utils import trace
from ..utils.device import resolve_device
from ..utils.io import save_tif, write_png
from ..utils.postprocess import (color_labels, relabel,
                                 remove_small_components)
from ..utils.skeleton import skeletonize
from . import isbi_hacks

logger = logging.getLogger(__name__)

# the JAX package's engines that run the device path; the port has one
# (the CUDA kernels on the card, their plain versions on the CPU)
_DEVICE_ENGINES = ("jax", "pallas", "xla")


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
    # do_all / finalize_and_write (the CLI's label task)
    remove_small_comps: int = 0
    dilate_instances: bool = False
    save_mip: bool = False      # colour label MIP PNGs, before and after
                                # the small-component removal
    save_tif: bool = False      # the relabelled cleaned volume as uint16 TIF
    vote_debug: bool = False    # the vote_debug / vote_debug2 canvases in
                                # the result store (whole volumes only)
    res_key: str = "vote_instances"
    result_folder: str = "."
    num_parallel_samples: int = 1
    # blockwise assembly (assembly/blockwise.py) and its prediction store
    blockwise: bool = False
    ignore_small_comps: int = 0
    chunksize: tuple = (92, 92, 92)
    num_parallel_blocks: int = 1
    chessboard: bool = False
    block_devices: int = 0           # > 1 (-1 = all): blocks over devices
    sharded_devices: int = 0         # > 1 (-1 = all): z-shard consensus +
                                     # rank, cover and graph over devices
    aff_key: str = "volumes/pred_affs"
    code_key: str = "volumes/pred_code"
    numinst_key: str | None = None
    fg_key: str | None = None
    fg_thresh_vi: float = -1.0
    code_decoder: object | None = None  # infer.decode.CodeDecoder: blockwise
                                        # windows decode codes on demand
    # the blockwise contract of to_instance_seg
    return_intermediates: bool = False
    skipRanking: bool = False
    selected_patch_pairs: np.ndarray | None = None
    center_valid: np.ndarray | None = None
    # the options (JAX vote_instances.py:77-196)
    one_instance_per_channel: bool = False
    no_overlap_per_channel: bool = False
    isbi_hack: bool = False
    isbi_sparsify_stride: int = 20
    select_patches_overlap_neighborhood: bool = False
    mark_close_neighboorhood: bool = False  # the reference's spelling
    pad_with_ps: bool = False
    skipThinCover: bool = False
    skipConsensus: bool = False
    skipSelection: bool = False
    score_threshold: float | None = None
    sample: float = 1.0        # < 1: patch-pixel thinning in the cover
                               # stages, patch-list subsample in the ISBI
                               # hack (get_patch_sets.py:32-54,
                               # isbi_hacks.py:25-28)
    seed: int = 0
    shuffle_patches: bool = False
    store_scores: bool = False  # rank scores (+100 at the candidates) back
                                # into the prediction store
    store_intermediates: bool = False  # do_all: pairs / weights as .npy
                                       # beside the result, reused on rerun
    use_score_oracle: bool = False
    score_oracle_key: str = "volumes/patch_iou"
    oracle_scores: np.ndarray | None = None
    selected_patches: list | None = None
    aff_graph: np.ndarray | None = None  # with selected_patch_pairs: label
                                         # the given graph, compute nothing
    crop_to_foreground: bool = True
    aff_file: str | None = None          # set by do_all (store_scores)
    profile_dir: str | None = None       # do_all: torch.profiler trace
    # read by nothing, in either package: bg_mode is "inv" when the other
    # two flags are off, and the reference's only_bb is always on
    vi_bg_use_inv_th: bool = False
    only_bb: bool = True

    @classmethod
    def from_config(cls, cfg: dict, **overrides) -> "VoteInstancesParams":
        """Typed view of a [vote_instances] section, as the JAX package's
        ``from_config``: keys that name no parameter of either package are
        dropped, ``patchshape`` becomes a tuple.  Raises
        NotImplementedError for an engine other than the device engines
        (the JAX package's host ``engine="numpy"`` is the port's CPU run
        with ``device="cpu"``)."""
        kwargs = {**cfg, **overrides}
        engine = kwargs.pop("engine", "jax")
        if engine not in _DEVICE_ENGINES:
            raise NotImplementedError(
                f"engine={engine!r}: the port has one engine, the CUDA "
                f"kernels on the card (plain PyTorch on the CPU); use one "
                f"of {_DEVICE_ENGINES}")
        known = {f.name for f in fields(cls)}
        kwargs = {k: v for k, v in kwargs.items() if k in known}
        if "patchshape" in kwargs:
            kwargs["patchshape"] = tuple(int(p) for p in kwargs["patchshape"])
        return cls(**kwargs)

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


def _sharded_mesh_size(params, vol_shape, ccfg, kind: str = "cuda") -> int:
    """Usable mesh size for z-sharded consensus + rank, or 1 (one device),
    by the JAX package's rule (vote_instances.py:53-73): the largest n up
    to ``sharded_devices`` (-1: every device of ``kind``) that divides Z
    into slabs of at least 3*rad slices.  A request that cannot be met in
    full is logged with the reason."""
    want = int(params.sharded_devices or 0)
    if want in (0, 1):
        return 1
    avail = len(sharded.local_devices(kind))
    n_max = avail if want < 0 else min(want, avail)
    halo = 3 * int(ccfg.rad[0])
    if n_max > 1 and len(vol_shape) == 3:
        Z = int(vol_shape[0])
        for n in range(n_max, 1, -1):
            if Z % n == 0 and Z // n >= max(halo, 1):
                if n < want:
                    logger.info("sharded_devices=%d: %d shards (%d %s "
                                "devices; z extent %d, halo %d)", want, n,
                                avail, kind, Z, halo)
                return n
    logger.info("sharded_devices=%d: one device (%d %s devices; volume %s "
                "splits into no equal z-slabs of at least %d slices)", want,
                avail, kind, tuple(vol_shape), max(halo, 1))
    return 1


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


def _pad_all(affs, arrays, rad):
    """Zero-pad the stack (on its device) and the masks by the patch
    radius on every spatial side (vote_instances.py:238-248)."""
    pad = []
    for r in reversed(rad):
        pad += [int(r), int(r)]
    pads = [(int(r), int(r)) for r in rad]
    return F.pad(affs, pad), [np.pad(np.asarray(a), pads) for a in arrays]


def _maybe_unpad(instances, foreground, rad, params):
    if params.pad_with_ps:
        sl = tuple(slice(int(r), int(s - r))
                   for r, s in zip(rad, foreground.shape))
        foreground = foreground[sl]
        instances = instances[(Ellipsis,) + sl]
    return instances.astype(np.uint16), foreground.astype(np.uint8)


def _multi_out(params) -> bool:
    return params.one_instance_per_channel or params.no_overlap_per_channel


def _components(pairs, weights, params, dev):
    if params.mws:
        return ref.graph_components(pairs, weights)
    return graph_components_device(pairs, weights, dev)


def _paint(comps, affs, ps, vol_shape, params):
    return ref.components_to_instances(
        comps, _paint_src(affs, comps, params.patch_threshold), ps,
        vol_shape, patch_threshold=params.patch_threshold,
        one_instance_per_channel=params.one_instance_per_channel,
        no_overlap_per_channel=params.no_overlap_per_channel)


def _candidates(cand, affs, foreground, mask_to_cover, ps, params):
    """The ISBI hack on the candidate centers (vote_instances.py:588-606):
    the sparse grid, with ``sample < 1`` a subsample of it, and on stacks
    of more than one slice the boundary filter of the mask to cover.
    Returns (centers (n, 3), mask to cover)."""
    vol_shape = foreground.shape
    pts = isbi_hacks.sparsify_patches([tuple(c) for c in cand],
                                      params.isbi_sparsify_stride,
                                      vol_shape=vol_shape)
    if params.sample < 1.0 and pts:
        rng = np.random.RandomState(params.seed)
        n_keep = max(1, int(params.sample * len(pts)))
        pts = [pts[i] for i in sorted(rng.choice(len(pts), n_keep,
                                                 replace=False))]
    if vol_shape[0] > 1:
        mask_to_cover = isbi_hacks.filter_instance_boundaries_from_fg(
            affs.cpu().numpy(), foreground, pts, ps, mask_to_cover,
            patch_threshold=params.patch_threshold)
    return np.asarray(pts, dtype=np.int64).reshape(-1, 3), mask_to_cover


def _write_scores_volume(params: VoteInstancesParams, scores: np.ndarray,
                         centers: np.ndarray, rad):
    """Rank scores into the prediction store (ranked_patches.py:147-181):
    candidate centers +100, key ``volumes/<patch_threshold>/scores`` (dots
    as underscores), cut by the radius after ``pad_with_ps``."""
    marked = np.array(scores, dtype=np.float32, copy=True)
    for c in centers:
        marked[tuple(int(x) for x in c)] += 100.0
    if params.pad_with_ps:
        marked = marked[tuple(slice(int(r), int(s - r))
                              for r, s in zip(rad, marked.shape))]
    key = "volumes/{}/scores".format(
        str(round(float(params.patch_threshold), 2)).replace(".", "_"))
    marked = np.squeeze(marked)
    out = vio.open_volume(params.aff_file, mode="r+")
    out.create(key, marked.shape, np.float32,
               chunks=[max(1, s // 2) for s in marked.shape])
    out.write(marked, key=key)
    out.close()


def to_instance_seg(pred_affs, foreground: np.ndarray,
                    mask_to_cover: np.ndarray, numinst: np.ndarray,
                    params: VoteInstancesParams, device="cuda",
                    timings: dict | None = None, intermediates: dict | None
                    = None):
    """Full assembly of a (P, *vol) affinity stack; *vol is (Z, Y, X),
    with Z == 1 and patchshape (1, p, p) for 2D.

    Returns (instances uint16, foreground uint8) as numpy arrays (instances
    (C, *vol) with ``one_instance_per_channel`` / ``no_overlap_per_channel``),
    or with ``params.return_intermediates`` (pairs, weights), (None, None)
    where nothing is assembled.  ``timings``, if given, receives per-stage
    seconds; ``intermediates``, if given, receives the candidate order,
    the selected patches, the pairs and the graph weights, and
    ``consensus`` True once the consensus kernel has run."""
    dev = resolve_device(device)
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
    if params.pad_with_ps:
        if params.blockwise:
            raise ValueError("pad_with_ps pads whole volumes only, not "
                             "blockwise windows")
        affs, (foreground, mask_to_cover, numinst) = _pad_all(
            affs, (foreground, mask_to_cover, numinst), rad)
    foreground = np.asarray(foreground).astype(bool)
    vol_shape = foreground.shape
    inner = ref.interior(vol_shape, rad)
    overlap_mask = (np.asarray(numinst) > 1).astype(np.uint8)
    mask_to_cover = np.asarray(mask_to_cover).astype(bool).copy()
    if params.isbi_hack and vol_shape[0] > 1:
        foreground = isbi_hacks.keep_single_slice(foreground)
        mask_to_cover = isbi_hacks.keep_single_slice(mask_to_cover)
    if not params.blockwise and params.skeletonize_foreground:
        with trace.Stages("label", None, timings) as stages:
            stages.next("skeletonize")
            mask_to_cover = skeletonize(mask_to_cover) > 0
    mask_to_cover[overlap_mask > 0] = False
    instances = np.zeros(((1,) if _multi_out(params) else ()) + vol_shape,
                         dtype=np.uint16)

    def nothing():
        if params.return_intermediates:
            return None, None
        return _maybe_unpad(instances, foreground, rad, params)

    if not np.any(mask_to_cover & inner):
        return nothing()

    if params.aff_graph is not None \
            and params.selected_patch_pairs is not None:
        # the graph is given (graph_to_labeling.py:16-31): label it
        pairs = np.asarray(params.selected_patch_pairs)
        weights = np.asarray(params.aff_graph, dtype=np.float32)
        if params.return_intermediates:
            return pairs, weights
        comps = _components(pairs, weights, params, dev)
        return _maybe_unpad(_paint(comps, affs, ps, vol_shape, params),
                            foreground, rad, params)
    if params.skipConsensus:
        # the rank and the graph weights both read the consensus: only the
        # given-graph case above can skip it
        raise ValueError(
            "skipConsensus=true requires precomputed selected_patch_pairs "
            "+ aff_graph (ranking and graph weights both consume the "
            "consensus array)")

    with trace.Stages("label", dev, timings) as stages:
        stages.next("consensus")
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
        oracle = params.use_score_oracle and params.oracle_scores is not None
        skip_rank = params.skipRanking and (
            injected or params.selected_patches is not None)

        # (1) consensus: operands in PyTorch (2D: one gated stack and a target
        # plane; 3D: the mask stacks), the canonical half from the kernel; with
        # sharded_devices, z-sharded over a mesh with the rank beside it
        n_sh = _sharded_mesh_size(params, vol_shape, ccfg, dev.type)
        mesh = sharded.make_spatial_mesh(n_sh, dev.type) if n_sh > 1 else None
        if mesh is not None:
            operands = None
            cons, sharded_scores = sharded.sharded_consensus_and_rank(
                affs, ccfg, mesh, overlap, cv)
        else:
            operands = consensus_operands(affs, ccfg, overlap, cv)
            cons = consensus_half(affs, operands, ccfg)
        inter["consensus"] = True
        stages.next("rank")

        # (2) rank kernel (or the oracle's scores, or none when the selection
        # is given), the candidates' scores gathered, and the host stable
        # descending sort (ties keep scan order)
        scores = None
        if oracle:
            scores = torch.as_tensor(np.asarray(params.oracle_scores,
                                                dtype=np.float32), device=dev)
            if tuple(scores.shape) != vol_shape:
                raise ValueError(f"oracle scores {tuple(scores.shape)} != "
                                 f"volume {vol_shape}")
        elif not skip_rank:
            scores = sharded_scores if mesh is not None \
                else rank_scores(affs, cons, operands, ccfg, cv)
        del operands
        cand = np.argwhere(foreground & inner)
        if params.isbi_hack:
            cand, mask_to_cover = _candidates(cand, affs, foreground,
                                              mask_to_cover, ps, params)
        if len(cand) == 0:
            return nothing()
        if scores is None:
            svals = np.zeros(len(cand), dtype=np.float32)
        else:
            flat = torch.as_tensor(
                np.ravel_multi_index(tuple(cand.T), vol_shape), device=dev)
            svals = scores.reshape(-1)[flat].cpu().numpy().astype(np.float32)
        order = np.argsort(-svals, kind="stable")
        if params.store_scores and params.aff_file:
            _write_scores_volume(
                params, np.zeros(vol_shape, np.float32) if scores is None
                else scores.cpu().numpy(), cand, rad)
        del scores
        if params.shuffle_patches:
            # diagnostic (ranked_patches.py:199-210): no rank order
            order = order[np.random.RandomState(params.seed).permutation(
                len(order))]
        ranked = [(cand[i], float(svals[i])) for i in order]
        if not skip_rank:
            inter["ranked_centers"] = cand[order]
            inter["ranked_scores"] = svals[order]

        if injected:
            # (3)-(5) the pair list is given: the cover stages would only
            # feed the pair generation
            stages.next("pairs")
            pairs = np.asarray(params.selected_patch_pairs, dtype=np.uint32)
        else:
            # (3) greedy cover (4) thin-out set cover, on each patch's
            # pixels thinned with sample < 1 (one keep mask, drawn as the
            # JAX package's host path draws it)
            stages.next("cover")
            given = params.selected_patches is not None or params.skipSelection
            thin = not (given or params.skipThinCover)
            cover_affs = affs
            if params.sample < 1.0 and not given:
                keep = np.random.RandomState(params.seed).rand(
                    *affs.shape) < params.sample
                cover_affs = torch.where(torch.as_tensor(keep, device=dev),
                                         affs, 0.0)
                del keep
            if params.selected_patches is not None:
                selected = [(np.asarray(c), 1.0)
                            for c in params.selected_patches]
            elif params.skipSelection:
                selected = ranked
            elif (params.score_threshold is not None
                  or params.select_patches_overlap_neighborhood
                  or params.mark_close_neighboorhood):
                # the options of the host loop: one copy of the stack
                selected, _ = ref.foreground_cover_reference(
                    cover_affs.cpu().numpy(), mask_to_cover, ranked, ps,
                    fc_threshold=params.fc_threshold, overlap=overlap_mask,
                    sparse_data=params.select_patches_for_sparse_data,
                    score_threshold=params.score_threshold,
                    overlap_neighborhood=(
                        params.select_patches_overlap_neighborhood),
                    mark_close=params.mark_close_neighboorhood)
            else:
                selected, _ = greedy_cover_device(
                    cover_affs, mask_to_cover, ranked, ps,
                    fc_threshold=params.fc_threshold, overlap=overlap_mask,
                    sparse_data=params.select_patches_for_sparse_data,
                    mesh=mesh)
            inter["cover_centers"] = np.array([c for c, _ in selected])
            stages.next("thin_cover")
            if thin and selected:
                selected = thin_out_cover_device(
                    cover_affs, mask_to_cover, selected, ps,
                    fc_threshold=params.fc_threshold)
            del cover_affs
            inter["thin_centers"] = np.array([c for c, _ in selected])
            stages.next("pairs")
            # (5) patch pairs (host)
            pairs, _ = ref.patch_pairs_reference(
                selected, ps,
                max_ps_dist=params.max_total_patch_distance_in_ps_multiples,
                include_singleton=params.includeSinglePatchCCS)
        if pairs is None or len(pairs) == 0:
            return nothing()
        stages.next("graph")
        # patch-graph weights (device)
        sym = symmetrize_half(cons, ccfg)
        del cons
        weights = patch_graph_weights(
            affs, sym, pairs, ccfg,
            drop_intersection=params.removeIntersection, mesh=mesh)
        del sym
        inter["pairs"], inter["weights"] = pairs, weights
        if params.return_intermediates:
            return pairs, weights
        stages.next("mws_paint")

        # (6) components (host mutex watershed, or label propagation on the
        # device) -> painting
        comps = _components(pairs, weights, params, dev)
        instances = _paint(comps, affs, ps, vol_shape, params)
        inter["n_components"] = len(comps)
    return _maybe_unpad(instances, foreground, rad, params)


def load_affinities(aff_file: str, params: VoteInstancesParams):
    """(affs (P, *vol) float32, numinst, foreground) from a prediction
    store: channels-last stacks rotated, logits turned into probabilities
    (either bound of [0, 1] violated beyond f16 round-off), 2D stacks
    lifted to (P, 1, H, W), and the masks from ``_derive_fg_numinst``."""
    ps = np.asarray(params.patchshape)
    io = vio.open_volume(aff_file, mode="r")
    affs = io.read(key=params.aff_key).astype(np.float32)
    P = int(np.prod(ps))
    if affs.ndim >= 2 and affs.shape[-1] == P and affs.shape[0] != P:
        affs = np.ascontiguousarray(np.moveaxis(affs, -1, 0))
    affs = np.squeeze(affs)
    if affs.ndim == 3:
        affs = affs[:, None]
    if affs.min() < -1e-3 or affs.max() > 1 + 1e-3:
        affs = expit(affs)
    numinst, foreground = _derive_fg_numinst(
        io, params, center_channel_reader=lambda: affs[P // 2])
    return affs, numinst, foreground


def do_all(aff_file: str, params: VoteInstancesParams,
           result_folder: str | None = None, device="cuda") -> str:
    """One prediction store into an instance store (the CLI's ``label``
    for one sample): blockwise assembly streaming from the store when
    ``params.blockwise``, else the whole volume through
    ``to_instance_seg``; then ``finalize_and_write``.  Returns the
    result's path.  With ``profile_dir`` the run is traced by
    torch.profiler into ``<profile_dir>/<sample>.trace.json`` (the JAX
    package writes a jax.profiler trace there)."""
    result_folder = result_folder or params.result_folder
    os.makedirs(result_folder, exist_ok=True)
    if not params.profile_dir:
        return _do_all_inner(aff_file, params, result_folder, device)
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = _do_all_inner(aff_file, params, result_folder, device)
    os.makedirs(params.profile_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(aff_file.rstrip("/")))[0]
    prof.export_chrome_trace(os.path.join(params.profile_dir,
                                          base + ".trace.json"))
    return out


def _do_all_inner(aff_file, params, result_folder, device):
    from .blockwise import blockwise_vote_instances_zarr

    base = os.path.splitext(os.path.basename(aff_file.rstrip("/")))[0]
    params = dataclasses.replace(params, aff_file=aff_file)
    if params.use_score_oracle and params.oracle_scores is None:
        # the GT patch-IoU volume evaluate_prediction wrote
        # (run_ppp.py:1347-1364)
        oio = vio.open_volume(aff_file, mode="r")
        oracle = np.squeeze(oio.read(key=params.score_oracle_key)).astype(
            np.float32)
        oio.close()
        params = dataclasses.replace(
            params, oracle_scores=oracle[None] if oracle.ndim == 2
            else oracle)
    canvases = None
    if params.blockwise:
        instances, fg_out = blockwise_vote_instances_zarr(
            aff_file, params, chunksize=params.chunksize,
            result_folder=result_folder, decoder=params.code_decoder,
            device=device)
    else:
        affs, numinst, foreground = load_affinities(aff_file, params)
        if params.vote_debug:
            params, canvases = _vote_debug(affs, numinst, foreground,
                                           params, device)
        if params.store_intermediates:
            # pairs and weights once, as .npy beside the result; a rerun
            # labels from them (aff_patch_graph.py:96-110)
            pp_path = os.path.join(result_folder,
                                   base + "_selected_patch_pairs.npy")
            ag_path = os.path.join(result_folder, base + "_aff_graph.npy")
            if not (os.path.exists(pp_path) and os.path.exists(ag_path)):
                pairs, weights = to_instance_seg(
                    affs, foreground, foreground.copy(), numinst,
                    dataclasses.replace(params, return_intermediates=True),
                    device=device)
                if pairs is not None:
                    np.save(pp_path, pairs)
                    np.save(ag_path, np.asarray(weights))
            if os.path.exists(pp_path):
                params = dataclasses.replace(
                    params, selected_patch_pairs=np.load(pp_path),
                    aff_graph=np.load(ag_path))
        instances, fg_out = to_instance_seg(
            affs, foreground, foreground.copy(), numinst, params,
            device=device)
    return finalize_and_write(instances, fg_out, params, base,
                              result_folder, extra_keys=canvases)


def _vote_debug(affs, numinst, foreground, params, device):
    """The first pass of ``vote_debug`` (JAX vote_instances.py:948-968):
    the pairs and weights, the two debug canvases, and the params that
    label from that graph.  Returns (params, {key: canvas})."""
    from .debug_viz import render_graph_edges, render_patch_tiles

    pairs, weights = to_instance_seg(
        affs, foreground, foreground.copy(), numinst,
        dataclasses.replace(params, return_intermediates=True),
        device=device)
    tiles = render_patch_tiles(affs, foreground, params.patchshape,
                               device=device)
    if pairs is None:
        return params, {"vote_debug": tiles,
                        "vote_debug2": np.zeros_like(tiles)}
    edges = render_graph_edges(pairs, weights, foreground.shape,
                               params.patchshape)
    params = dataclasses.replace(params, selected_patch_pairs=pairs,
                                 aff_graph=np.asarray(weights))
    return params, {"vote_debug": tiles, "vote_debug2": edges}


def _save_label_mip(instances: np.ndarray, out_file: str):
    """Colour label MIP PNG (stitch_patch_graph.py:824-829 ``color(
    np.max(instances, axis=0))``)."""
    mip = np.asarray(instances)
    while mip.ndim > 2:
        mip = mip.max(axis=0)
    write_png(out_file, color_labels(mip.astype(np.int64)))


def finalize_and_write(instances, fg_out, params: VoteInstancesParams,
                       base: str, result_folder: str,
                       extra_keys: dict | None = None) -> str:
    """Small-component removal, the crop to the foreground (with
    ``crop_to_foreground``) and the result file
    ``<result_folder>/<base>.hdf`` (vote_instances.py:521-554 and the
    stitch's post outputs, stitch_patch_graph.py:823-895): ``res_key``,
    ``vote_foreground``, ``vote_instances_masked`` (always cropped),
    with ``dilate_instances`` ``<res_key>_dil_1`` /
    ``<res_key>_masked_dil_1``, and every array of ``extra_keys`` under
    its key.  ``save_mip`` writes ``<base>.png`` before the small-component
    removal and ``<base>_cleaned.png`` after it, ``save_tif`` the relabelled
    cleaned map as ``<base>.tif`` (both only with ``remove_small_comps``,
    as in the JAX package).  Multi-channel maps (C, *vol) are cropped
    channel by channel.  ``res_key`` and ``vote_foreground`` carry the
    JAX package's ``offset`` (0, 0, 0) and ``resolution`` (1, 1, 1)
    attributes.  The file is appended to: its other keys stay, so each
    parameter set of ``validate_checkpoints`` keeps its ``res_key`` in
    one file.  Shared by ``do_all`` and the CLI's ``infer_fused``."""
    instances = np.asarray(instances)
    fg_out = np.asarray(fg_out)
    bg = (slice(None),) * (instances.ndim - fg_out.ndim) + (fg_out == 0,)
    if params.save_mip:
        _save_label_mip(instances, os.path.join(result_folder, base + ".png"))
    if params.remove_small_comps > 0:
        instances = remove_small_components(instances,
                                            params.remove_small_comps)
        if params.save_tif:
            save_tif(os.path.join(result_folder, base + ".tif"),
                     relabel(instances).astype(np.uint16))
        if params.save_mip:
            _save_label_mip(instances, os.path.join(
                result_folder, base + "_cleaned.png"))
    instances = instances.copy()
    if params.crop_to_foreground:
        instances[bg] = 0
    os.makedirs(result_folder, exist_ok=True)
    out_path = os.path.join(result_folder, base + ".hdf")
    where = {"offset": (0, 0, 0), "resolution": (1, 1, 1)}
    with vio.IoHDF5(out_path, mode="a") as out:
        out.write(instances, key=params.res_key, attrs=where)
        out.write(fg_out.astype(np.uint8), key="vote_foreground",
                  attrs=where)
        masked = instances.copy()
        masked[bg] = 0
        out.write(masked, key="vote_instances_masked")
        if params.dilate_instances:
            # per-label 1-iteration binary dilation; later (higher) labels
            # win contested voxels, as in the reference's ascending-label
            # loop
            instdil = instances.copy()
            for lbl in np.unique(instances):
                if lbl == 0:
                    continue
                grown = ndimage.binary_dilation(instdil == lbl,
                                                iterations=1)
                instdil[grown] = lbl
            out.write(instdil, key=params.res_key + "_dil_1")
            mdil = instdil.copy()
            mdil[bg] = 0
            out.write(mdil, key=params.res_key + "_masked_dil_1")
        for key, arr in (extra_keys or {}).items():
            out.write(np.asarray(arr), key=key)
    return out_path
