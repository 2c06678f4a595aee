"""Spatially sharded consensus, rank and cover over several devices.

Counterpart of ``patchperpix_tpu/parallel/sharded.py``.  The JAX package
runs one controller over a ``Mesh`` with ``shard_map``; the port mirrors
that with one process driving a list of devices: a *mesh* is a list of
``torch.device`` (``make_spatial_mesh``), the volume's z axis is split
into one slab per device, each slab is extended by its neighbours' halo
slices (copied with ``.to()``; zero halos at the global edges), and each
device runs the port's consensus + rank (the CUDA kernels K1 + K2 on a
card, their plain versions on the CPU) on its extended slab.  Results
equal the whole-volume computation: centers outside the global interior
are gated with ``center_valid``.

Halo width: votes into voxel x come from centers within rad of x, which
read targets within 2*rad; ranking a center c reads consensus up to rad
away, whose votes involve centers up to 2*rad and targets up to 3*rad.

``local_devices(kind)`` lists the devices a mesh is built from: every
card for ``"cuda"``, the one CPU device for ``"cpu"``.  It is the one
hook the tests replace to lay n shards on the CPU
or on one card (``tests/conftest.py`` gives JAX 8 virtual CPU devices the
same way).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.consensus import ConsensusConfig
from ..ops.consensus_kernels import (consensus_half, consensus_operands,
                                     rank_scores)
from ..ops.cover import min_rank_field

_INF = 2 ** 30


def local_devices(kind: str = "cuda") -> list:
    """The devices of this process: ``cuda:0`` ... ``cuda:{count-1}`` for
    ``"cuda"``, ``[cpu]`` for ``"cpu"``."""
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no devices of kind {kind!r}")


def make_spatial_mesh(n_devices: int | None = None,
                      kind: str = "cuda") -> list:
    """The first ``n_devices`` of ``local_devices(kind)`` (all of them for
    None)."""
    devices = list(local_devices(kind))
    if n_devices is not None:
        devices = devices[:n_devices]
    return devices


def _split(x: torch.Tensor, mesh, axis: int) -> list:
    """``x`` cut into len(mesh) equal slabs along ``axis``, slab k on
    mesh[k]."""
    return [t.to(d) for t, d in zip(torch.chunk(x, len(mesh), dim=axis),
                                     mesh)]


def _halo_exchange(blocks: list, halo: int, axis: int) -> list:
    """Each block extended by ``halo`` slices of its left and right
    neighbours along ``axis``, copied onto its device; the global edges
    get zero halos."""
    if halo == 0:
        return list(blocks)
    out = []
    n = len(blocks)
    for i, blk in enumerate(blocks):
        size = blk.shape[axis]
        if i > 0:
            left = blocks[i - 1].narrow(axis, size - halo, halo).to(
                blk.device)
        else:
            left = torch.zeros_like(blk.narrow(axis, 0, halo))
        if i < n - 1:
            right = blocks[i + 1].narrow(axis, 0, halo).to(blk.device)
        else:
            right = torch.zeros_like(blk.narrow(axis, 0, halo))
        out.append(torch.cat([left, blk, right], dim=axis))
    return out


def _check_slabs(Z: int, n: int, halo: int, what: str) -> int:
    if Z % n:
        raise ValueError(f"z extent {Z} not divisible by mesh size {n}")
    if Z // n < halo:
        raise ValueError(f"local slab ({Z // n} z-slices) must cover the "
                         f"{halo}-slice {what} halo; use fewer devices or a "
                         "larger volume")
    return Z // n


def sharded_consensus_and_rank(affs: torch.Tensor, cfg: ConsensusConfig,
                               mesh, overlap=None, center_valid=None):
    """Whole-volume-exact canonical-half consensus and rank scores,
    z-sharded over ``mesh``.

    affs: (P, Z, Y, X) with Z divisible by the mesh size and each slab at
    least 3*rad thick.  Returns (half (psz, ndy, ndx, Z, Y, X), scores
    (Z, Y, X)) gathered onto ``affs.device``: the half the whole-volume
    ``consensus_half`` gives (the JAX package returns the full canonical
    array; the port's graph stage symmetrizes the half).  ``overlap`` and
    ``center_valid`` ((Z, Y, X) bool) ride the same halo exchange, and
    ``center_valid`` (e.g. blockwise stitching's global-interior gate)
    composes with the shard-boundary gate."""
    rad = int(cfg.rad[0])
    halo = 3 * rad
    n = len(mesh)
    Z = int(affs.shape[1])
    local = _check_slabs(Z, n, halo, "consensus")
    home = affs.device
    ext = _halo_exchange(_split(affs, mesh, 1), halo, 1)
    ov_ext = cv_ext = [None] * n
    if overlap is not None:
        ov_ext = _halo_exchange(_split(torch.as_tensor(overlap).bool(),
                                       mesh, 0), halo, 0)
    if center_valid is not None:
        cv_ext = _halo_exchange(_split(torch.as_tensor(center_valid).bool(),
                                       mesh, 0), halo, 0)
    halves, scores = [], []
    for k in range(n):
        e = ext[k].contiguous()
        dev = e.device
        # the global interior in z: the edge shards' zero halos are no
        # volume, and neighbours' halo centers are interior wherever their
        # own tests pass on the extended slab
        zpos = torch.arange(e.shape[1], device=dev) - halo + k * local
        cv = ((zpos >= rad) & (zpos < Z - rad))[:, None, None].expand(
            e.shape[1:])
        if cv_ext[k] is not None:
            cv = cv & cv_ext[k]
        ops = consensus_operands(e, cfg, ov_ext[k], cv)
        half = consensus_half(e, ops, cfg)
        sc = rank_scores(e, half, ops, cfg, cv)
        del ops
        halves.append(half.narrow(3, halo, local).to(home))
        scores.append(sc.narrow(0, halo, local).to(home))
    return torch.cat(halves, dim=3), torch.cat(scores, dim=0)


def sharded_cover_min_scatter(affs: torch.Tensor, rankvol: torch.Tensor,
                              mask: torch.Tensor, interior: torch.Tensor,
                              n: int, ps, fc_threshold: float, mesh):
    """z-sharded exact min-rank greedy cover (the sparse-data closed form
    of ``ops/cover.py``'s ``greedy_cover_device``).

    m(x), the minimum rank over candidates whose fc-thresholded window
    contains x, needs a ``rad``-slice halo of the affinities and of the
    rank field; the rank field travels as its INF complement, so that the
    zero halos at the global edges read INF.  The cross-shard quantities
    are a max (the rank cutoff r*) and an OR (the selected set; each
    voxel belongs to one shard).  affs (P, Z, Y, X); rankvol int32 (INF
    off the candidates, overlap rows pre-gated to INF), mask and interior
    bool (Z, Y, X).  Returns (selected (n,) bool numpy, still-uncovered
    (Z, Y, X) bool numpy), equal to the single-device closed form."""
    ps = tuple(int(p) for p in ps)
    halo = ps[0] // 2
    nsh = len(mesh)
    Z = int(mask.shape[0])
    local = _check_slabs(Z, nsh, halo, "cover")
    ext_affs = _halo_exchange(_split(affs, mesh, 1), halo, 1)
    ext_rank = [_INF - t for t in _halo_exchange(
        _split(_INF - rankvol.to(torch.int32), mesh, 0), halo, 0)]
    masks = _split(mask.bool(), mesh, 0)
    inners = _split(interior.bool(), mesh, 0)
    ms, r_loc = [], []
    for k in range(nsh):
        m = min_rank_field(ext_affs[k], ext_rank[k], ps, fc_threshold)
        m = m.narrow(0, halo, local)
        m = torch.where(masks[k], m, torch.full_like(m, _INF))
        ms.append(m)
        r_loc.append(torch.max(torch.where(
            inners[k] & masks[k], m, torch.full_like(m, -1))).cpu())
    r_star = int(max(int(r) for r in r_loc))
    selected = np.zeros(n + 1, bool)
    running = []
    for k in range(nsh):
        covered = (ms[k] <= r_star) & (ms[k] < _INF)
        idx = torch.where(covered, ms[k], torch.full_like(ms[k], n))
        sel = torch.zeros(n + 1, dtype=torch.bool, device=ms[k].device)
        sel[idx.reshape(-1).long()] = True
        selected |= sel.cpu().numpy()
        running.append((masks[k] & ~covered).cpu().numpy())
    return selected[:n], np.concatenate(running, axis=0)
