"""Blockwise vote-instances with cross-block stitching, out of core.

Counterpart of ``patchperpix_tpu/assembly/blockwise.py``.  A volume is
split into a grid of blocks over the foreground's bounding box; each block
window (the block plus a patch-radius halo, always chunksize + 2 rad) is
assembled on its own by ``to_instance_seg`` with ``return_intermediates``
(its selected patch pairs and their graph weights), with ``center_valid``
gating the window's centers to the interior of the whole volume.  Pairs
of selected patches in different blocks are then weighed in stitch
windows (``selected_patch_pairs`` + ``skipRanking``: the consensus kernel
runs, rank and cover do not), all edges go into one graph, and its
components are painted from the nodes' patch columns only.

- Windows stream from a prediction store through a reader
  (``ZarrAffReader`` for a dense float16 ``pred_affs`` array,
  ``infer.decode.CodeAffReader`` for a code store), so the dense
  (P, *vol) stack never exists in host memory.  The readers return each
  window as a tensor on the device.
- Per-block (pairs, weights) persist as ``.npz`` files beside the result,
  in a directory named by a fingerprint of the parameters that change
  them, and a rerun resumes from them.
- ``num_parallel_blocks`` runs blocks on a thread pool (host reads and
  host stages of one block overlap the device stages of another; every
  block launches on the default stream); ``chessboard`` orders blocks so
  that same-phase blocks, never grid neighbours, run first.
- ``skeletonize_foreground`` thins the whole sample's mask to cover once,
  before the blocks; block and stitch windows never skeletonize their own
  window (their params force it off).
- ``block_devices`` > 1 (-1: every device) spreads the blocks over the
  devices of ``parallel/sharded.py``'s ``local_devices``: worker thread i
  runs its blocks on device i (its launches with that device current),
  with at least one worker per device.  Blocks then never shard
  themselves (``sharded_devices`` is forced to 0 inside a block); without
  ``block_devices`` a block window z-shards like a whole volume.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import np_reference as ref
from ..ops.graph_device import graph_components_device
from ..parallel import sharded
from ..utils import io as vio
from ..utils.device import resolve_device
from ..utils.postprocess import clean_mask
from ..utils.skeleton import skeletonize
from .vote_instances import (VoteInstancesParams, _derive_fg_numinst,
                             to_instance_seg)


def _global_center_valid(w_start, w_shape, vol_shape, rad):
    """Bool mask gating a window's patch centers to the interior of the
    whole volume, or None when the window lies inside it (all valid).
    Without it a border window treats its zero-padded context as interior
    and selects centers that the whole-volume path excludes."""
    w_start = np.asarray(w_start)
    w_shape = np.asarray(w_shape)
    vol_shape = np.asarray(vol_shape)
    rad = np.asarray(rad)
    if np.all(w_start >= rad) and np.all(
            w_start + w_shape <= vol_shape - rad):
        return None
    axes = []
    for ax in range(len(w_shape)):
        g = w_start[ax] + np.arange(w_shape[ax])
        axes.append((g >= rad[ax]) & (g < vol_shape[ax] - rad[ax]))
    out = axes[0]
    for a in axes[1:]:
        out = out[..., None] & a
    return out


def get_offsets(shape, chunksize) -> list[np.ndarray]:
    """Grid of block offsets covering ``shape``."""
    shape = np.asarray(shape)
    chunksize = np.asarray(chunksize)
    ranges = [np.arange(0, s, c) for s, c in zip(shape, chunksize)]
    grids = np.meshgrid(*ranges, indexing="ij")
    return [np.array(o) for o in zip(*[g.ravel() for g in grids])]


def _phase(off, chunksize) -> int:
    """Chessboard color of a block: 8 in 3D, 4 in 2D."""
    p = 0
    for m in (np.asarray(off) // np.asarray(chunksize)) % 2:
        p = 2 * p + int(m)
    return p


def get_chessboard_offsets(shape, chunksize) -> list[np.ndarray]:
    """Block offsets with a leading chessboard phase: blocks of equal
    phase are never grid neighbours."""
    return [np.concatenate([[_phase(off, chunksize)], off])
            for off in get_offsets(shape, chunksize)]


def _crop(arr, start, stop, channel_dim=False, pad_value=0):
    """Window copy with constant padding outside the volume; numpy arrays
    and tensors."""
    spatial = np.array(arr.shape[1:] if channel_dim else arr.shape)
    start = np.asarray(start)
    stop = np.asarray(stop)
    rs = np.maximum(start, 0)
    re = np.minimum(stop, spatial)
    sl = tuple(slice(int(a), int(b)) for a, b in zip(rs, re))
    if channel_dim:
        sl = (slice(None),) + sl
    out = arr[sl]
    pad = [(int(a - b), int(c - d))
           for a, b, c, d in zip(rs, start, stop, re)]
    if not any(p != (0, 0) for p in pad):
        return out
    if torch.is_tensor(out):
        return F.pad(out, [v for p in reversed(pad) for v in p],
                     value=pad_value)
    if channel_dim:
        pad = [(0, 0)] + pad
    return np.pad(out, pad, mode="constant", constant_values=pad_value)


class ArrayAffReader:
    """In-memory affinity reader: a (P, *vol) numpy array, or a tensor
    (the windows are then tensors on its device)."""

    def __init__(self, pred_affs):
        if torch.is_tensor(pred_affs):
            self.pred_affs = pred_affs.float()
        else:
            self.pred_affs = np.asarray(pred_affs, dtype=np.float32)
        self.spatial_shape = tuple(self.pred_affs.shape[1:])

    def read_window(self, start, stop):
        return _crop(self.pred_affs, start, stop, channel_dim=True)

    def read_columns(self, coords) -> dict:
        coords = [tuple(int(x) for x in c) for c in coords]
        if not coords:
            return {}
        pts = np.asarray(coords, dtype=np.int64)
        if torch.is_tensor(self.pred_affs):
            p = torch.as_tensor(pts, device=self.pred_affs.device)
            cols = self.pred_affs[(slice(None),) + tuple(p.T)].T
            cols = cols.cpu().numpy()
        else:
            cols = self.pred_affs[(slice(None),) + tuple(pts.T)].T
        return {c: cols[i] for i, c in enumerate(coords)}

    def read_channel(self, chan: int) -> np.ndarray:
        ch = self.pred_affs[chan]
        return ch.cpu().numpy() if torch.is_tensor(ch) else ch

    def close(self):
        pass


class ZarrAffReader:
    """Out-of-core affinity reader over a prediction store: channels-last
    arrays rotated, 2D lifted to (P, 1, H, W), logits turned into
    probabilities (probed on the first, center and last channels).
    Windows are float32 tensors on ``device`` (float16 crosses the bus)."""

    def __init__(self, path: str, aff_key: str, patchsize: int,
                 device="cuda"):
        self.io = vio.open_volume(path, mode="r")
        self.key = aff_key
        self.P = int(patchsize)
        self.device = resolve_device(device)
        shape = self.io.shape(aff_key)
        self.channels_last = (shape[-1] == self.P and shape[0] != self.P)
        sp = shape[:-1] if self.channels_last else shape[1:]
        sp = tuple(int(s) for s in sp)
        self.lift_2d = len(sp) == 2
        self.spatial_shape = (1,) + sp if self.lift_2d else sp
        # logits: either bound violated (eps for the f16 round-off)
        self.is_logits = False  # read_channel must not sigmoid the probe
        lo, hi = np.inf, -np.inf
        for chan in {0, self.P // 2, self.P - 1}:
            c = self.read_channel(chan)
            lo = min(lo, float(c.min()))
            hi = max(hi, float(c.max()))
        self.is_logits = bool(lo < -1e-3 or hi > 1 + 1e-3)

    def _read_raw(self, start, stop) -> np.ndarray:
        bb = tuple(slice(int(a), int(b)) for a, b in zip(start, stop))
        if self.channels_last:
            data = self.io.read(bb=bb + (slice(None),), key=self.key)
            return np.ascontiguousarray(np.moveaxis(data, -1, 0))
        return self.io.read(bb=(slice(None),) + bb, key=self.key)

    def _probabilities(self, data: np.ndarray) -> np.ndarray:
        data = data.astype(np.float32)
        if self.is_logits:
            from scipy.special import expit

            data = expit(data)
        return data

    def read_window(self, start, stop):
        """(P, *(stop-start)) window in GLOBAL (possibly 2D-lifted) coords,
        zero-padded outside the volume."""
        start = np.asarray(start)
        stop = np.asarray(stop)
        start2, stop2 = (start[1:], stop[1:]) if self.lift_2d \
            else (start, stop)
        sp = np.array(self.io.shape(self.key)[:-1] if self.channels_last
                      else self.io.shape(self.key)[1:])
        rs = np.maximum(start2, 0)
        re = np.minimum(stop2, sp)
        data = self._read_raw(rs, re)
        if self.is_logits:
            data = self._probabilities(data)
        # the widening of float16 to float32 is exact, on either side
        data = torch.from_numpy(data).to(self.device).float()
        pad = [(int(a - b), int(c - d))
               for a, b, c, d in zip(rs, start2, stop2, re)]
        if self.lift_2d:
            data = data[:, None]
            pad = [(int(0 - start[0]), int(stop[0] - 1))] + pad
        if any(p != (0, 0) for p in pad):
            data = F.pad(data, [v for p in reversed(pad) for v in p])
        return data

    def read_columns(self, coords) -> dict:
        """Affinity columns at the given centers (each store chunk that
        holds one decoded once)."""
        coords = [tuple(int(x) for x in c) for c in coords]
        if not coords:
            return {}
        pts = np.array(coords, dtype=np.int64)
        upts = pts[:, 1:] if self.lift_2d else pts
        if self.channels_last:
            cols = np.stack([self.io.read(bb=tuple(int(x) for x in p),
                                          key=self.key) for p in upts])
        else:
            cols = self.io.read_points(upts, key=self.key)
        cols = self._probabilities(cols)
        return {c: cols[i] for i, c in enumerate(coords)}

    def read_channel(self, chan: int) -> np.ndarray:
        if self.channels_last:
            data = self.io.read(bb=(Ellipsis, slice(chan, chan + 1)),
                                key=self.key)[..., 0]
        else:
            data = self.io.read(bb=(slice(chan, chan + 1),),
                                key=self.key)[0]
        data = self._probabilities(data)
        if self.lift_2d:
            data = data[None]
        return data

    def close(self):
        self.io.close()


def _params_fingerprint(params: VoteInstancesParams, chunksize) -> str:
    """Short hash of every parameter that changes per-block results, so a
    resume store is never reused across incompatible configurations (the
    mask's ``skeletonize_foreground`` and ``ignore_small_comps`` too, which
    the JAX package's fingerprint leaves out)."""
    keys = ("patchshape", "patch_threshold", "fc_threshold", "bg_mode",
            "weight_mode", "consensus_norm_aff", "patch_graph_norm_aff",
            "rank_norm_patch_score", "rank_int_counter", "consensus_bf16",
            "overlapping_inst", "select_patches_for_sparse_data",
            "removeIntersection", "includeSinglePatchCCS",
            "max_total_patch_distance_in_ps_multiples",
            "skeletonize_foreground", "ignore_small_comps", "skipThinCover",
            "sample", "seed", "score_threshold", "isbi_hack",
            "isbi_sparsify_stride")
    sig = repr([(k, getattr(params, k)) for k in keys]
               + [tuple(int(c) for c in np.asarray(chunksize)), "window_v2"])
    return hashlib.sha1(sig.encode()).hexdigest()[:10]


def _block_store_path(result_folder: str, base: str,
                      params: VoteInstancesParams = None,
                      chunksize=None) -> str:
    suffix = ""
    if params is not None:
        suffix = "_" + _params_fingerprint(params, chunksize)
    return os.path.join(result_folder, base + "_blocks" + suffix)


def _save_block(store: str | None, key, pairs, weights):
    if store is None:
        return
    os.makedirs(store, exist_ok=True)
    name = os.path.join(store, "block_" + "_".join(str(k) for k in key))
    tmp = name + ".tmp.npz"
    if pairs is None:
        np.savez(tmp, empty=np.array([1]))
    else:
        np.savez(tmp, pairs=pairs, weights=weights)
    os.replace(tmp, name + ".npz")


def _load_block(store: str | None, key):
    """(found, result): result None (empty block) or (pairs, weights,
    key); an unreadable file is deleted and not found."""
    if store is None:
        return False, None
    name = os.path.join(store, "block_" + "_".join(str(k) for k in key)
                        + ".npz")
    if not os.path.exists(name):
        return False, None
    try:
        with np.load(name) as z:
            if "empty" in z:
                return True, None
            return True, (z["pairs"], z["weights"], key)
    except Exception:
        os.remove(name)
        return False, None


def _block_devices(block_devices, kind: str):
    """The devices blocks spread over, or None for one device."""
    if not block_devices or block_devices == 1:
        return None
    devices = list(sharded.local_devices(kind))
    if block_devices > 0:
        devices = devices[:block_devices]
    return devices if len(devices) > 1 else None


class BlockStats:
    """What a blockwise run did, for the caller to read: the reader that
    served the windows, blocks and stitch windows in all and those that
    reached the consensus stage, the stitch window extent, per-block stage
    seconds and the stitch's stage seconds summed over its windows (the
    device synchronised at each stage boundary while stats are kept)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.reader = None
        self.blocks = 0
        self.blocks_empty = 0
        self.blocks_resumed = 0
        self.blocks_consensus = 0
        self.stitch_windows = 0
        self.stitch_consensus = 0
        self.stitch_extent = None
        self.block_stages: list = []
        self.block_seconds: list = []
        self.stitch_seconds = 0.0
        self.stitch_stages: dict = {}

    def as_dict(self) -> dict:
        stages = {}
        for t in self.block_stages:
            for k, v in t.items():
                stages.setdefault(k, []).append(v)
        return {"reader": self.reader,
                "blocks": self.blocks, "blocks_empty": self.blocks_empty,
                "blocks_resumed": self.blocks_resumed,
                "blocks_consensus": self.blocks_consensus,
                "stitch_windows": self.stitch_windows,
                "stitch_consensus": self.stitch_consensus,
                "stitch_extent": self.stitch_extent,
                "block_seconds_median": (float(np.median(self.block_seconds))
                                         if self.block_seconds else None),
                "block_stage_seconds_median": {
                    k: float(np.median(v)) for k, v in stages.items()},
                "stitch_seconds": self.stitch_seconds,
                "stitch_stage_seconds": self.stitch_stages}


def compute_blocks(reader, fg: np.ndarray, mask_to_cover: np.ndarray,
                   numinst: np.ndarray, params: VoteInstancesParams,
                   chunksize, block_results: dict | None = None,
                   store: str | None = None, num_parallel_blocks: int = 1,
                   block_devices: int = 0, device="cuda",
                   stats: BlockStats | None = None) -> dict:
    """Per-block intermediates: {offset key: (pairs_global, weights, key)
    or None}.  Resumes from ``block_results`` and / or the on-disk
    ``store``.  ``block_devices`` > 1 (-1: all) runs blocks concurrently
    on that many devices of ``device``'s kind (JAX blockwise.py:437-467)."""
    dev = resolve_device(device)
    ps = np.asarray(params.patchshape, dtype=np.int64)
    rad = ps // 2
    vol_shape = np.array(fg.shape)
    chunksize = np.asarray(chunksize)

    nz = np.argwhere(fg)
    bb_start = np.maximum(nz.min(axis=0) - rad, 0)
    bb_stop = np.minimum(nz.max(axis=0) + rad + 1, vol_shape)
    offsets = get_offsets(bb_stop - bb_start, chunksize)
    block_results = {} if block_results is None else block_results
    # the whole sample's mask was skeletonized once (_masks_to_cover); no
    # block thins its own window.  Blocks over devices and z-sharding
    # inside a block exclude each other: blocks over devices win
    devices = _block_devices(block_devices, dev.type)
    block_params = dataclasses.replace(
        params, blockwise=True, return_intermediates=True,
        skeletonize_foreground=False, block_devices=0,
        sharded_devices=0 if devices else params.sharded_devices)
    worker = threading.local()

    def run_block(off):
        key = tuple(int(o) for o in off)
        if key in block_results:
            return key, block_results[key]
        found, res = _load_block(store, key)
        if found:
            if stats is not None:
                with stats.lock:
                    stats.blocks_resumed += 1
            return key, res
        g_start = bb_start + off
        g_stop = np.minimum(g_start + chunksize, bb_stop)
        if not fg[tuple(slice(int(a), int(b))
                        for a, b in zip(g_start, g_stop))].any():
            _save_block(store, key, None, None)
            if stats is not None:
                with stats.lock:
                    stats.blocks_empty += 1
            return key, None
        t0 = time.perf_counter()
        # halo = patch radius; the window is ALWAYS chunksize + 2 rad, a
        # ragged last block reading real volume (or the readers' zero
        # padding past the edge) instead of shrinking
        w_start = g_start - rad
        w_stop = g_start + chunksize + rad
        affs_b = reader.read_window(w_start, w_stop)
        fg_b = _crop(fg, w_start, w_stop)
        mask_b = _crop(mask_to_cover, w_start, w_stop)
        ni_b = _crop(numinst, w_start, w_stop)
        # cover only the core (the halo belongs to the neighbours)
        core = np.zeros_like(mask_b)
        core[tuple(slice(int(r), int(r + (b - a)))
                   for r, a, b in zip(rad, g_start, g_stop))] = True
        mask_b = np.logical_and(mask_b, core)
        cv = _global_center_valid(w_start, fg_b.shape, fg.shape, rad)
        bparams = dataclasses.replace(block_params, center_valid=cv)
        timings = {} if stats is not None else None
        inter: dict = {}
        timings_read = time.perf_counter() - t0
        res = to_instance_seg(affs_b, fg_b, mask_b, ni_b, bparams,
                              device=getattr(worker, "device", dev),
                              timings=timings, intermediates=inter)
        del affs_b
        if stats is not None:
            timings["read"] = timings_read
            with stats.lock:
                stats.blocks_consensus += int(inter.get("consensus", False))
                stats.block_stages.append(timings)
                stats.block_seconds.append(time.perf_counter() - t0)
        if res[0] is None:
            _save_block(store, key, None, None)
            return key, None
        pairs_local, weights = res
        ndim = len(rad)
        pairs_global = pairs_local.astype(np.int64).copy()
        pairs_global[:, :ndim] += w_start[None, :]
        pairs_global[:, ndim:] += w_start[None, :]
        weights = np.asarray(weights)
        _save_block(store, key, pairs_global, weights)
        return key, (pairs_global, weights, key)

    todo = [off for off in offsets
            if tuple(int(o) for o in off) not in block_results]
    if stats is not None:
        stats.blocks += len(offsets)
    if params.chessboard and len(todo) > 1:
        # phase order: concurrent workers drain same-phase blocks first
        todo = sorted(todo, key=lambda o: (_phase(o, chunksize),)
                      + tuple(int(x) for x in o))
    if devices is not None and len(todo) > 1:
        # worker thread i runs its blocks on device i (round-robin when
        # there are more workers than devices), with that device current
        n_workers = max(num_parallel_blocks, len(devices))
        lock = threading.Lock()
        started = iter(range(n_workers))

        def pin():
            with lock:
                worker.device = devices[next(started) % len(devices)]
            if worker.device.type == "cuda":
                torch.cuda.set_device(worker.device)

        with ThreadPoolExecutor(max_workers=n_workers,
                                initializer=pin) as ex:
            for key, res in ex.map(run_block, todo):
                block_results[key] = res
    elif num_parallel_blocks > 1 and len(todo) > 1:
        with ThreadPoolExecutor(max_workers=num_parallel_blocks) as ex:
            for key, res in ex.map(run_block, todo):
                block_results[key] = res
    else:
        for off in todo:
            key, res = run_block(off)
            block_results[key] = res
    return block_results


def _masks_to_cover(fg, numinst, params):
    """(foreground, mask to cover) of the whole sample: small components
    dropped, the mask skeletonized once with ``skeletonize_foreground``
    and then cleared of the overlap voxels."""
    fg = fg.astype(bool)
    if params.ignore_small_comps > 0:
        fg = clean_mask(fg, params.ignore_small_comps)
    mask_to_cover = fg.copy()
    if params.skeletonize_foreground:
        mask_to_cover = skeletonize(mask_to_cover) > 0
    mask_to_cover[numinst > 1] = False
    return fg, mask_to_cover


def blockwise_vote_instances(pred_affs, foreground: np.ndarray,
                             numinst: np.ndarray,
                             params: VoteInstancesParams,
                             chunksize=(92, 92, 92),
                             block_results: dict | None = None,
                             store: str | None = None, device="cuda",
                             stats: BlockStats | None = None):
    """Blockwise assembly of an in-memory (P, *vol) stack (numpy, or a
    tensor whose windows stay on its device).  Returns (instances
    uint16, fg uint8).  ``block_results`` (partially filled) and / or a
    ``store`` directory resume an earlier run."""
    dev = resolve_device(device)
    fg, mask_to_cover = _masks_to_cover(foreground, numinst, params)
    if not fg.any():
        return np.zeros(fg.shape, np.uint16), fg.astype(np.uint8)
    reader = ArrayAffReader(pred_affs)
    if stats is not None:
        stats.reader = type(reader).__name__
    block_results = compute_blocks(
        reader, fg, mask_to_cover, numinst, params, chunksize,
        block_results=block_results, store=store,
        num_parallel_blocks=params.num_parallel_blocks,
        block_devices=params.block_devices, device=dev, stats=stats)
    instances = stitch_blocks(reader, fg, numinst, block_results, params,
                              device=dev, stats=stats)
    return instances, fg.astype(np.uint8)


def blockwise_vote_instances_zarr(aff_file: str,
                                  params: VoteInstancesParams,
                                  chunksize=(92, 92, 92),
                                  result_folder: str | None = None,
                                  decoder=None, device="cuda",
                                  stats: BlockStats | None = None):
    """Out-of-core blockwise assembly streaming from the prediction store
    (the ``label --blockwise`` path).  Only the fg / numinst masks (1 byte
    a voxel) and one window at a time are resident; per-block results
    persist under ``<result_folder>/<base>_blocks_<fingerprint>/``.

    With ``decoder`` (an ``infer.decode.CodeDecoder``) and a store without
    ``params.aff_key``, windows decode from ``params.code_key`` on demand
    (``CodeAffReader``): the dense (P, *vol) stack is never produced."""
    from ..infer.decode import CodeAffReader

    dev = resolve_device(device)
    base = os.path.splitext(os.path.basename(aff_file.rstrip("/")))[0]
    store = (_block_store_path(result_folder, base, params, chunksize)
             if result_folder else None)
    P = int(np.prod(params.patchshape))
    if decoder is not None and not vio.check_file(aff_file,
                                                  keys=[params.aff_key]):
        reader = CodeAffReader(
            aff_file, decoder, code_key=params.code_key,
            numinst_key=params.numinst_key, fg_key=params.fg_key,
            fg_thresh=(params.fg_thresh_vi if params.fg_thresh_vi > 0
                       else 0.5))
    else:
        reader = ZarrAffReader(aff_file, params.aff_key, P, device=dev)
    if stats is not None:
        stats.reader = type(reader).__name__
    try:
        numinst, fg = _derive_fg_numinst(
            vio.open_volume(aff_file, mode="r"), params,
            center_channel_reader=lambda: reader.read_channel(P // 2))
        fg, mask_to_cover = _masks_to_cover(fg, numinst, params)
        if not fg.any():
            return np.zeros(fg.shape, np.uint16), fg.astype(np.uint8)
        block_results = compute_blocks(
            reader, fg, mask_to_cover, numinst, params, chunksize,
            store=store, num_parallel_blocks=params.num_parallel_blocks,
            block_devices=params.block_devices, device=dev, stats=stats)
        instances = stitch_blocks(reader, fg, numinst, block_results,
                                  params, device=dev, stats=stats)
    finally:
        reader.close()
    return instances, fg.astype(np.uint8)


def stitch_blocks(reader, fg, numinst, block_results,
                  params: VoteInstancesParams, device="cuda",
                  stats: BlockStats | None = None):
    """One graph from the blocks' edges plus the cross-block edges,
    weighed in stitch windows; its components painted from the nodes'
    patch columns."""
    from scipy.spatial import cKDTree

    dev = resolve_device(device)
    t0 = clock = time.perf_counter()

    def lap(name):
        nonlocal clock
        if stats is None:
            return
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        stats.stitch_stages[name] = (stats.stitch_stages.get(name, 0.0)
                                     + now - clock)
        clock = now

    ps = np.asarray(params.patchshape, dtype=np.int64)
    vol_shape = np.array(fg.shape)
    ndim = len(ps)
    edges_pairs, edges_weights, node_block = [], [], {}
    for res in block_results.values():
        if res is None:
            continue
        pairs, weights, bkey = res
        edges_pairs.append(pairs)
        edges_weights.append(weights)
        for row in np.asarray(pairs).tolist():
            node_block[tuple(row[:ndim])] = bkey
            node_block[tuple(row[ndim:])] = bkey
    if not edges_pairs:
        return np.zeros(tuple(vol_shape), np.uint16)
    all_pairs = np.concatenate(edges_pairs, axis=0)
    all_weights = np.concatenate(edges_weights, axis=0)

    # candidate pairs of selected patches of different blocks within reach,
    # in the sorted order of the k-d tree's index pairs
    nodes = sorted(node_block.keys())
    pts = np.array(nodes, dtype=np.int64)
    cross_pairs = []
    if len(pts) > 1:
        tree = cKDTree(pts, leafsize=4)
        cand = tree.query_pairs(2 * float(np.sum(ps)), p=1,
                                output_type="ndarray")
        cand = cand[np.lexsort((cand[:, 1], cand[:, 0]))]
        block_id = {k: i for i, k in enumerate(set(node_block.values()))}
        blk = np.array([block_id[node_block[n]] for n in nodes])
        max_d = params.max_total_patch_distance_in_ps_multiples * ps
        a, b = cand[:, 0], cand[:, 1]
        keep = (blk[a] != blk[b]) & ~np.any(
            np.abs(pts[a] - pts[b]) > max_d, axis=1)
        cross_pairs = [(nodes[i], nodes[j]) for i, j in cand[keep].tolist()]
    lap("candidates")

    if cross_pairs:
        # one window per block pair and 48^3 cell of the pair midpoint,
        # all of ONE canonical shape: the per-axis largest need, rounded up
        # to 16 (readers zero-pad past the volume, which votes nothing);
        # flat axes keep extent 1.  The windows, and with them the maps,
        # are those of the JAX package's run.
        cell = 48
        groups: dict = {}
        for na, nb in cross_pairs:
            gkey = tuple(sorted((node_block[na], node_block[nb])))
            mid = tuple(((np.asarray(na) + np.asarray(nb)) // 2) // cell)
            groups.setdefault(gkey + mid, []).append((na, nb))
        bounds = {}
        for gkey, prs in groups.items():
            coords = np.array([c for pr in prs for c in pr], dtype=np.int64)
            bounds[gkey] = (coords.min(axis=0) - 2 * ps,
                            coords.max(axis=0) + 2 * ps + 1)
        need = np.max(np.array([h - l for l, h in bounds.values()]), axis=0)
        ext = -(-need // 16) * 16
        ext = np.where(vol_shape == 1, 1, ext)
        if stats is not None:
            stats.stitch_extent = [int(e) for e in ext]
        new_pairs, new_weights = [all_pairs], [all_weights]
        for gkey, prs in groups.items():
            lo, hi = bounds[gkey]
            w_start = lo - (ext - (hi - lo)) // 2
            w_stop = w_start + ext
            lap("windows_host")
            affs_w = reader.read_window(w_start, w_stop)
            lap("windows_read")
            fg_w = _crop(fg, w_start, w_stop)
            ni_w = _crop(numinst, w_start, w_stop)
            glob = np.array([np.concatenate([na, nb]) for na, nb in prs],
                            dtype=np.int64)
            local_pairs = (glob - np.concatenate([w_start, w_start])[None]
                           ).astype(np.uint32)
            cv = _global_center_valid(w_start, fg_w.shape, fg.shape,
                                      ps // 2)
            wparams = dataclasses.replace(
                params, blockwise=True, return_intermediates=True,
                skipRanking=True, skeletonize_foreground=False,
                selected_patch_pairs=local_pairs, selected_patches=None,
                center_valid=cv)
            inter: dict = {}
            timings = {} if stats is not None else None
            lap("windows_host")
            res = to_instance_seg(affs_w, fg_w, fg_w.copy(), ni_w, wparams,
                                  device=dev, timings=timings,
                                  intermediates=inter)
            del affs_w
            lap("windows_assemble")
            if stats is not None:
                stats.stitch_windows += 1
                stats.stitch_consensus += int(inter.get("consensus", False))
                for k, v in timings.items():
                    k = "windows_assemble_" + k
                    stats.stitch_stages[k] = stats.stitch_stages.get(k, 0) + v
            if res[0] is None:
                continue
            new_pairs.append(glob)
            new_weights.append(np.asarray(res[1]))
        all_pairs = np.concatenate(new_pairs, axis=0)
        all_weights = np.concatenate(new_weights)

    if params.mws:
        comps = ref.graph_components(all_pairs, all_weights)
    else:
        comps = graph_components_device(all_pairs, all_weights, dev)
    lap("components")
    # sparse_labels mode: only the component nodes' patch columns
    patch_dict = reader.read_columns([idx for comp in comps for idx in comp])
    instances = ref.components_to_instances(
        comps, patch_dict, ps, tuple(vol_shape),
        patch_threshold=params.patch_threshold,
        one_instance_per_channel=params.one_instance_per_channel,
        no_overlap_per_channel=params.no_overlap_per_channel)
    lap("paint")
    if stats is not None:
        stats.stitch_seconds = time.perf_counter() - t0
    return instances
