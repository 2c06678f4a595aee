"""Consensus / rank / patch-graph math in plain PyTorch.

Counterpart of ``patchperpix_tpu/ops/consensus_jax.py``.  This module
holds the plain versions of the two hand-written kernels
(``ops/consensus_kernels.py``) and the tensor ops around them:

- ``_masks``: the (hi, lo, tgt) eligibility stacks, as XLA builds them for
  the Pallas kernels in the JAX package;
- ``consensus_half_plain``: the canonical half of the consensus array,
  the same function as ``consensus_array(...)[psz-1:]`` and the plain
  version of the CUDA kernel ``csrc/consensus.cu``;
- ``rank_acc_plain``: the rank sum over the canonical half, the plain
  version of ``csrc/rank.cu``; ``rank_epilogue`` finishes the score;
- ``symmetrize_half`` / ``embed_half``;
- ``patch_graph_weights``: the per-pair patch-graph weight in the JAX
  package's expectation form;
- the 2D path (``ps = (1, p, p)`` on a ``(P, 1, H, W)`` stack, square odd
  p >= 3: ``is_2d``), counterpart of
  ``patchperpix_tpu/ops/pallas_consensus_2d.py``: ``gated_stack_2d`` (one
  sentinel-gated stack and a target plane instead of four stacks),
  ``consensus_half_2d_plain`` and ``rank_acc_2d_plain``, the plain
  versions of ``csrc/consensus2d.cu`` and ``csrc/rank2d.cu``, and
  ``rank_epilogue_2d``.  The 2D canonical half is ``(p, 2p-1, H, W)``:
  row displacement d >= 0, and at d == 0 only dx > 0.

Conventions follow ``ops/np_reference.py``: affs is (P, *vol) float32,
the full consensus is (*neigh, *vol) with neigh = 2*ps-1, the offset index
of delta d = p2 - p1 is d + ps - 1, and the canonical half keeps the
dz >= 0 planes, (psz, ndy, ndx, *vol), with the lex-nonpositive (dy, dx)
entries of the dz == 0 plane zero.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import exact_f32
from .np_reference import (bg_threshold, interior, neigh_extent,
                           patch_offsets)


@dataclass(frozen=True)
class ConsensusConfig:
    """Static configuration for the consensus / rank / graph stages
    (defaults: the FlyLight reference config)."""
    patchshape: tuple
    patch_threshold: float = 0.5
    bg_mode: str = "less"                   # vi_bg_use_less_than_th
    weight_mode: str = "norm_prob_product"  # consensus_norm_prob_product
    norm_aff: bool = True                   # consensus_norm_aff
    norm_rank: bool = True                  # rank_norm_patch_score
    rank_int_counter: bool = False          # rank_int_counter
    norm_graph: bool = True                 # patch_graph_norm_aff
    overlapping_inst: bool = False
    cons_bf16: bool = False                 # store the consensus in bf16

    @property
    def ps(self) -> np.ndarray:
        return np.asarray(self.patchshape, dtype=np.int64)

    @property
    def rad(self) -> np.ndarray:
        return self.ps // 2

    @property
    def neigh(self) -> np.ndarray:
        return neigh_extent(self.ps)

    @property
    def P(self) -> int:
        return int(np.prod(self.ps))

    @property
    def mid(self) -> int:
        return self.P // 2

    @property
    def bg_th(self) -> float:
        return bg_threshold(self.patch_threshold, self.bg_mode)


def _check_3d(cfg: ConsensusConfig, affs: torch.Tensor):
    if len(cfg.ps) != 3 or affs.ndim != 4 or affs.shape[0] != cfg.P:
        raise ValueError(f"expected affs (P={cfg.P}, Z, Y, X) for a 3D "
                         f"patchshape, got {tuple(affs.shape)}, "
                         f"ps {tuple(cfg.ps)}")


def interior_mask(vol_shape, rad, device) -> torch.Tensor:
    """bool (*vol) on ``device``: voxels at least ``rad`` from every
    border."""
    return torch.as_tensor(interior(vol_shape, rad), device=device)


def _windows(vol: torch.Tensor, ps) -> torch.Tensor:
    """(Z+ps-1, Y+ps-1, X+ps-1) -> (P, Z, Y, X): out[p][c] = vol[c + off(p)]."""
    psz, psy, psx = (int(p) for p in ps)
    w = vol.unfold(0, psz, 1).unfold(1, psy, 1).unfold(2, psx, 1)
    Z, Y, X = w.shape[:3]
    return w.permute(3, 4, 5, 0, 1, 2).reshape(psz * psy * psx, Z, Y, X)


def _center_ok(affs: torch.Tensor, cfg: ConsensusConfig,
               center_valid: torch.Tensor | None = None) -> torch.Tensor:
    """bool (*vol): the eligible patch centers, foreground and interior,
    and where ``center_valid`` is given (blockwise windows: interior in
    the whole volume) also valid there."""
    ok = (affs[cfg.mid] > cfg.patch_threshold) & interior_mask(
        affs.shape[1:], cfg.rad, affs.device)
    if center_valid is not None:
        ok = ok & center_valid.to(device=affs.device,
                                  dtype=torch.bool).reshape(ok.shape)
    return ok


def _masks(affs: torch.Tensor, cfg: ConsensusConfig,
           overlap: torch.Tensor | None = None,
           center_valid: torch.Tensor | None = None):
    """(hi, lo, tgt) eligibility stacks, each (P, *vol) float32.

    hi[p, c]: center c eligible (``_center_ok``), patch value > th, target
    pixel c + off(p) - rad fg (and not overlap); lo likewise with the bg
    threshold; tgt: target-eligible at an eligible center, whatever the
    patch value (the rank fgCnt).  The kernels derive every gate from
    these stacks, so ``center_valid`` needs no kernel change."""
    _check_3d(cfg, affs)
    th = cfg.patch_threshold
    rad = cfg.rad
    fg = affs[cfg.mid] > th
    center_ok = _center_ok(affs, cfg, center_valid)
    tgt_ok = fg
    if cfg.overlapping_inst and overlap is not None:
        tgt_ok = tgt_ok & ~overlap.to(device=affs.device, dtype=torch.bool)
    pad = []
    for r in reversed(rad):
        pad += [int(r), int(r)]
    tgt_pad = F.pad(tgt_ok.to(torch.float32), pad)
    tgt = center_ok.to(torch.float32)[None] * _windows(tgt_pad, cfg.ps)
    hi = tgt * (affs > th)
    lo = tgt * (affs < cfg.bg_th)
    return hi, lo, tgt


def _pos_weight(vq, vr, cfg: ConsensusConfig):
    th = cfg.patch_threshold
    if cfg.weight_mode == "norm_prob_product":
        return (vq * vr - th * th) / (1.0 - th * th)
    if cfg.weight_mode == "prob_product":
        return vq * vr
    return torch.ones_like(vq * vr)


def _neg_weight(v_hi, v_lo, cfg: ConsensusConfig):
    th = cfg.patch_threshold
    if cfg.weight_mode == "norm_prob_product":
        return (v_hi * (1.0 - v_lo) - th * th) / (1.0 - th * th)
    if cfg.weight_mode == "prob_product":
        return v_hi * (1.0 - v_lo)
    return torch.ones_like(v_hi * v_lo)


def _active_centers(hi: torch.Tensor, lo: torch.Tensor):
    """Linear indices and coordinates of the centers with any nonzero hi
    or lo entry: every other center adds exact zeros to consensus and
    rank."""
    vol = tuple(int(s) for s in hi.shape[1:])
    act = torch.nonzero(((hi != 0) | (lo != 0)).any(dim=0).reshape(-1))[:, 0]
    coords = torch.stack(torch.unravel_index(act, vol), dim=1)
    return act, coords


def _partner_targets(q: int, cfg: ConsensusConfig, coords, pad_sp, device):
    """For base patch pixel q: the first partner channel r0 (the partners
    r with rz >= qz are the contiguous channels r0..P-1) and the flat
    index, in the spatially rad-padded canonical half, of each partner's
    vote at each active center: d-index (rz - qz, ry - qy + psy - 1,
    rx - qx + psx - 1), padded voxel c + q.  Returns (r0, (P - r0, n))."""
    psz, psy, psx = (int(p) for p in cfg.ps)
    ndy, ndx = 2 * psy - 1, 2 * psx - 1
    qz, qy, qx = (int(v) for v in np.unravel_index(q, (psz, psy, psx)))
    r0 = qz * psy * psx
    rz, ry, rx = (torch.as_tensor(v, device=device) for v in np.unravel_index(
        np.arange(r0, psz * psy * psx), (psz, psy, psx)))
    d_lin = ((rz - qz) * ndy + ry - qy + psy - 1) * ndx + rx - qx + psx - 1
    x = coords + torch.as_tensor([qz, qy, qx], device=device)
    x_lin = (x[:, 0] * pad_sp[1] + x[:, 1]) * pad_sp[2] + x[:, 2]
    n_pad = pad_sp[0] * pad_sp[1] * pad_sp[2]
    return r0, d_lin[:, None] * n_pad + x_lin[None]


def consensus_half_plain(affs: torch.Tensor, hi: torch.Tensor,
                         lo: torch.Tensor,
                         cfg: ConsensusConfig) -> torch.Tensor:
    """Canonical-half consensus (psz, ndy, ndx, Z, Y, X), count-normalized
    if ``cfg.norm_aff``; bf16 if ``cfg.cons_bf16``.

    The XLA scan of ``consensus_jax.consensus_array`` restricted to the
    dz >= 0 planes and to the active centers: for each base pixel q, the
    votes of all partners r > q at all active centers are one
    (P - r0, n_active) expression, added at their (d, x) targets (unique
    within one q, so the sums run over q in order)."""
    _check_3d(cfg, affs)
    P = cfg.P
    psz, ndy, ndx = int(cfg.ps[0]), int(cfg.neigh[1]), int(cfg.neigh[2])
    vol = tuple(int(s) for s in affs.shape[1:])
    rad = cfg.rad
    pad_sp = tuple(s + 2 * int(r) for s, r in zip(vol, rad))
    cons = torch.zeros((psz, ndy, ndx) + pad_sp, dtype=torch.float32,
                       device=affs.device)
    cnt = torch.zeros_like(cons)
    act, coords = _active_centers(hi, lo)
    v, h, l_ = (t.reshape(P, -1)[:, act] for t in (affs, hi, lo))
    lin = torch.arange(P, device=affs.device)
    cons_f, cnt_f = cons.view(-1), cnt.view(-1)
    for q in range(P):
        r0, idx = _partner_targets(q, cfg, coords, pad_sp, affs.device)
        v_q, hi_q, lo_q = v[q][None], h[q][None], l_[q][None]
        v_r, hi_r, lo_r = v[r0:], h[r0:], l_[r0:]
        mask = (lin[r0:] > q).to(torch.float32)[:, None]
        w_pos = _pos_weight(v_q, v_r, cfg)
        w_nqr = _neg_weight(v_q, v_r, cfg)
        w_nrq = _neg_weight(v_r, v_q, cfg)
        contrib = mask * (hi_q * hi_r * w_pos - hi_q * lo_r * w_nqr
                          - lo_q * hi_r * w_nrq)
        contrib_cnt = mask * (hi_q * hi_r + hi_q * lo_r + lo_q * hi_r)
        cons_f.index_add_(0, idx.reshape(-1), contrib.reshape(-1))
        cnt_f.index_add_(0, idx.reshape(-1), contrib_cnt.reshape(-1))
    crop = (slice(None),) * 3 + tuple(
        slice(int(r), int(r) + s) for r, s in zip(rad, vol))
    cons, cnt = cons[crop], cnt[crop]
    if cfg.norm_aff:
        cons = torch.where(cnt != 0, cons / torch.clamp(cnt, min=1e-30),
                           cons)
    if cfg.cons_bf16:
        cons = cons.to(torch.bfloat16)
    return cons.contiguous()


def rank_acc_plain(hi: torch.Tensor, lo: torch.Tensor,
                   cons_half: torch.Tensor,
                   cfg: ConsensusConfig) -> torch.Tensor:
    """Unnormalized per-voxel rank sum from the canonical half:

        acc[c] = sum_{q < r} (hi_q hi_r - hi_q lo_r - lo_q hi_r)[c]
                 * S[r - q][c + q - rad]

    (or the ``rank_int_counter`` sign variant); the XLA scan of
    ``consensus_jax.rank_scores`` restricted to the stored half and the
    active centers."""
    P = cfg.P
    vol = tuple(int(s) for s in hi.shape[1:])
    pad = []
    for r in reversed(cfg.rad):
        pad += [int(r), int(r)]
    s_pad = F.pad(cons_half, pad)
    pad_sp = tuple(int(s) for s in s_pad.shape[3:])
    s_flat = s_pad.reshape(-1)
    act, coords = _active_centers(hi, lo)
    h, l_ = hi.reshape(P, -1)[:, act], lo.reshape(P, -1)[:, act]
    acc = torch.zeros(len(act), dtype=torch.float32, device=hi.device)
    lin = torch.arange(P, device=hi.device)
    for q in range(P):
        r0, idx = _partner_targets(q, cfg, coords, pad_sp, hi.device)
        block = s_flat[idx].to(torch.float32)
        mask = (lin[r0:] > q).to(torch.float32)[:, None]
        w_hh = mask * h[q][None] * h[r0:]
        w_hl = mask * (h[q][None] * l_[r0:] + l_[q][None] * h[r0:])
        if cfg.rank_int_counter:
            sgn = torch.sign(block)
            pos_v = torch.where(block != 0, sgn, -1.0)
            neg_v = torch.where(block != 0, sgn, 1.0)
            acc += torch.sum(w_hh * pos_v - w_hl * neg_v, dim=0)
        else:
            acc += torch.sum((w_hh - w_hl) * block, dim=0)
    out = torch.zeros(vol, dtype=torch.float32, device=hi.device)
    out.view(-1)[act] = acc
    return out


def rank_epilogue(acc: torch.Tensor, affs: torch.Tensor, hi: torch.Tensor,
                  tgt: torch.Tensor, cfg: ConsensusConfig,
                  center_valid: torch.Tensor | None = None) -> torch.Tensor:
    """fgCnt normalization + center gating (``_center_ok``, not the
    overlap mask) + sentinel.

    fgCnt (rankPatches.cu:139): ordered pairs (q hi, r target-eligible,
    q != r) minus hi-hi pairs with r <= q."""
    n_tgt = torch.sum(tgt, dim=0)
    n_hi = torch.sum(hi, dim=0)
    fg_cnt = n_hi * (n_tgt - 1.0) - n_hi * (n_hi - 1.0) / 2.0
    center_ok = _center_ok(affs, cfg, center_valid)
    sentinel = -1.0 if cfg.norm_rank else -9999999.0
    score = acc / torch.clamp(fg_cnt, min=1.0) if cfg.norm_rank else acc
    return torch.where(center_ok, score,
                       torch.full_like(score, sentinel)).to(torch.float32)


def is_2d(cfg: ConsensusConfig, vol_shape=None) -> bool:
    """True where the 2D kernels cover this configuration: a flat-z
    volume and a square odd 2D patch of side >= 3."""
    ps = cfg.ps
    if len(ps) != 3 or int(ps[0]) != 1:
        return False
    if vol_shape is not None and int(vol_shape[0]) != 1:
        return False
    p = int(ps[1])
    return p == int(ps[2]) and p % 2 == 1 and p >= 3


def _rows_cfg(cfg: ConsensusConfig) -> ConsensusConfig:
    """The (1, p, p) patch over (1, H, W) relabelled as a (p, p, 1) patch
    over (H, W, 1): the same pixels in the same memory order, and the 3D
    canonical half (psz, ndy, ndx = 1, H, W, 1) of that labelling is the 2D
    canonical half (p, 2p-1, H, W), so the 3D plain versions serve 2D."""
    p = int(cfg.ps[1])
    return dataclasses.replace(cfg, patchshape=(p, p, 1))


def gated_stack_2d(affs: torch.Tensor, cfg: ConsensusConfig,
                   overlap: torch.Tensor | None = None,
                   center_valid: torch.Tensor | None = None):
    """The operands of the 2D kernels: (ag (P, H, W), tgt (H, W)), float32.

    ag[q][c] = affs[q][c] where c is an eligible center (foreground,
    interior, ``center_valid``), else the sentinel -1; tgt is 1 where a
    pixel is target-eligible (foreground and, with ``overlapping_inst``,
    outside ``overlap``).  With affs in [0, 1] the four stacks of the 3D
    path follow from them per pixel (``derive_2d``), so device memory
    holds one (P, H, W) stack instead of four.  The stack is centre-
    aligned: the target of ag[q][c] is pixel c + off(q) - rad."""
    if not is_2d(cfg, affs.shape[1:]) or affs.shape[0] != cfg.P:
        raise ValueError(f"expected affs (P={cfg.P}, 1, H, W) for a square "
                         f"odd 2D patchshape, got {tuple(affs.shape)}, ps "
                         f"{tuple(cfg.ps)}")
    H, W = (int(s) for s in affs.shape[2:])
    a2 = affs.reshape(cfg.P, H, W)
    fg = a2[cfg.mid] > cfg.patch_threshold
    center_ok = fg & interior_mask((1, H, W), cfg.rad, affs.device)[0]
    if center_valid is not None:
        center_ok = center_ok & center_valid.to(
            device=affs.device, dtype=torch.bool).reshape(H, W)
    tgt_ok = fg
    if cfg.overlapping_inst and overlap is not None:
        tgt_ok = tgt_ok & ~overlap.to(device=affs.device,
                                      dtype=torch.bool).reshape(H, W)
    ag = torch.where(center_ok[None], a2.to(torch.float32),
                     a2.new_full((), -1.0, dtype=torch.float32))
    return ag.contiguous(), tgt_ok.to(torch.float32)


def _target_windows_2d(tgt: torch.Tensor, p: int) -> torch.Tensor:
    """(H, W) -> a (p, p, H, W) view: out[qy, qx][c] = tgt[c + q - rad],
    zero outside the image."""
    rad = p // 2
    w = F.pad(tgt, (rad, rad, rad, rad)).unfold(0, p, 1).unfold(1, p, 1)
    return w.permute(2, 3, 0, 1)


def derive_2d(ag: torch.Tensor, tgt: torch.Tensor, cfg: ConsensusConfig):
    """(hi, lo), each (P, H, W) float32, from the gated stack and the
    target plane: hi = (ag > th) * tgt[target], lo = (0 <= ag < bg_th) *
    tgt[target]; a = ag * hi and b = (1 - ag) * lo follow."""
    P, H, W = ag.shape
    t = _target_windows_2d(tgt, int(cfg.ps[1])).reshape(P, H, W)
    hi = (ag > cfg.patch_threshold).to(torch.float32) * t
    lo = ((ag >= 0) & (ag < cfg.bg_th)).to(torch.float32) * t
    return hi, lo


def consensus_half_2d_plain(ag: torch.Tensor, tgt: torch.Tensor,
                            cfg: ConsensusConfig) -> torch.Tensor:
    """2D canonical-half consensus (p, 2p-1, H, W), float32 or bf16
    (``cfg.cons_bf16``): what ``unfold_consensus`` of the JAX package
    holds before it symmetrizes.  Runs ``consensus_half_plain`` over the
    active centers on the relabelled patch (``_rows_cfg``)."""
    P, H, W = ag.shape
    hi, lo = derive_2d(ag, tgt, cfg)
    half = consensus_half_plain(ag[..., None], hi[..., None], lo[..., None],
                                _rows_cfg(cfg))
    return half.reshape(int(cfg.ps[1]), int(cfg.neigh[2]), H, W)


def rank_acc_2d_plain(ag: torch.Tensor, tgt: torch.Tensor,
                      cons_half: torch.Tensor,
                      cfg: ConsensusConfig) -> torch.Tensor:
    """Unnormalized 2D rank sum (H, W) over the (p, 2p-1, H, W) half."""
    P, H, W = ag.shape
    hi, lo = derive_2d(ag, tgt, cfg)
    p, nd = int(cfg.ps[1]), int(cfg.neigh[2])
    acc = rank_acc_plain(hi[..., None], lo[..., None],
                         cons_half.reshape(p, nd, 1, H, W, 1),
                         _rows_cfg(cfg))
    return acc.reshape(H, W)


def rank_epilogue_2d(acc: torch.Tensor, ag: torch.Tensor, tgt: torch.Tensor,
                     cfg: ConsensusConfig) -> torch.Tensor:
    """``rank_epilogue`` for 2D without (P, H, W) mask stacks: (1, H, W).

    n_tgt is the p x p box sum of the target plane, n_hi the count of
    patch pixels above threshold whose target is eligible; both are zero
    off eligible centers (ag is -1 there, and the center gate is
    ag[mid] >= 0).  fg_cnt = n_hi (n_tgt - 1) - n_hi (n_hi - 1) / 2."""
    P, H, W = ag.shape
    p = int(cfg.ps[1])
    center_ok = ag[cfg.mid] >= 0
    win = _target_windows_2d(tgt, p)
    n_tgt = torch.where(center_ok, win.sum(dim=(0, 1)),
                        torch.zeros_like(tgt))
    n_hi = ((ag.reshape(p, p, H, W) > cfg.patch_threshold)
            & (win > 0)).sum(dim=(0, 1)).to(torch.float32)
    fg_cnt = n_hi * (n_tgt - 1.0) - n_hi * (n_hi - 1.0) / 2.0
    sentinel = -1.0 if cfg.norm_rank else -9999999.0
    score = acc / torch.clamp(fg_cnt, min=1.0) if cfg.norm_rank else acc
    return torch.where(center_ok, score, torch.full_like(score, sentinel)
                       ).to(torch.float32).reshape(1, H, W)


def embed_half(cons_half: torch.Tensor,
               cfg: ConsensusConfig) -> torch.Tensor:
    """Canonical half -> full-extent canonical array (lex-negative planes
    zero), the layout ``consensus_jax.consensus_array`` returns.  A 2D
    half (p, 2p-1, H, W) gives (1, 2p-1, 2p-1, 1, H, W)."""
    if cons_half.ndim == 4:
        p, nd, H, W = cons_half.shape
        return embed_half(cons_half.reshape(p, nd, 1, H, W, 1),
                          _rows_cfg(cfg)).reshape(1, nd, nd, 1, H, W)
    psz = int(cfg.ps[0])
    assert cons_half.shape[0] == psz and cons_half.ndim == 6
    zeros = torch.zeros((psz - 1,) + tuple(cons_half.shape[1:]),
                        dtype=cons_half.dtype, device=cons_half.device)
    return torch.cat([zeros, cons_half], dim=0)


def symmetrize_half(cons_half: torch.Tensor,
                    cfg: ConsensusConfig) -> torch.Tensor:
    """Canonical half -> full symmetrized array (ndz, ndy, ndx, *vol):
    every lex-negative d gets S[d][x] = S[-d][x + d] (zero outside).

    With m = ps - 1 and offset index e = d + m, the twin of plane e
    (e_z <= m_z) is plane m - e of the half flipped over its offset axes,
    H, read at x + e - m.  Zero-padded by m on every spatial side, that
    read is Hp[e][x + e]: one strided view of Hp, since the element
    offset e . (offset strides + spatial strides) + x . spatial strides
    is affine in (e, x) (strides are 64-bit, so the 2D array at 520x696
    and 25x25, 8.7e8 elements, is addressed like any other).  A 2D half
    (p, 2p-1, H, W) gives (1, 2p-1, 2p-1, 1, H, W)."""
    if cons_half.ndim == 4:
        p, nd, H, W = cons_half.shape
        return symmetrize_half(cons_half.reshape(p, nd, 1, H, W, 1),
                               _rows_cfg(cfg)).reshape(1, nd, nd, 1, H, W)
    full = embed_half(cons_half, cfg)
    psz = int(cfg.ps[0])
    m = [int(v) for v in cfg.ps - 1]
    hp = F.pad(torch.flip(cons_half, dims=(0, 1, 2)),
               (m[2], m[2], m[1], m[1], m[0], m[0]))
    st = hp.stride()
    view = hp.as_strided(tuple(cons_half.shape),
                         tuple(st[a] + st[a + 3] for a in range(3))
                         + st[3:], 0)
    d = torch.as_tensor(patch_offsets(cons_half.shape[:3]) - np.asarray(m),
                        device=cons_half.device)
    neg = (d[:, 0] < 0) | ((d[:, 0] == 0) & ((d[:, 1] < 0) | (
        (d[:, 1] == 0) & (d[:, 2] < 0))))
    neg = neg.reshape(tuple(cons_half.shape[:3]) + (1, 1, 1))
    full[:psz] = torch.where(neg, view, full[:psz])
    return full


def graph_hi(affs: torch.Tensor, centers: torch.Tensor,
             cfg: ConsensusConfig) -> torch.Tensor:
    """(n, P) float 0/1: patch value > th and target pixel fg, for each
    patch center (the per-patch operand of computePatchGraph.cu)."""
    th = cfg.patch_threshold
    fg = (affs[cfg.mid] > th).to(torch.float32)
    pad = []
    for r in reversed(cfg.rad):
        pad += [int(r), int(r)]
    fg_pad = F.pad(fg, pad)
    offs = torch.as_tensor(patch_offsets(cfg.ps), device=affs.device)
    pos = centers[:, None, :] + offs[None]          # padded coords
    win = fg_pad[pos[..., 0], pos[..., 1], pos[..., 2]]
    v = affs[:, centers[:, 0], centers[:, 1], centers[:, 2]].T
    return (v > th).to(torch.float32) * win


def _compact(h: torch.Tensor, k: int):
    """(B, P) 0/1 with at most k ones per row -> (indices (B, k) with the
    ones first, valid (B, k))."""
    idx = torch.argsort(h, dim=1, descending=True, stable=True)[:, :k]
    return idx, torch.gather(h, 1, idx)


def _lin(coords: torch.Tensor, extent) -> torch.Tensor:
    """Row-major linear index of (..., 3) coordinates in ``extent``."""
    return (coords[..., 0] * extent[1] + coords[..., 1]) * extent[2] \
        + coords[..., 2]


def _in_box(coords: torch.Tensor, lo, hi) -> torch.Tensor:
    return torch.all((coords >= lo) & (coords <= hi), dim=-1)


def patch_graph_weights(affs: torch.Tensor, cons_sym: torch.Tensor,
                        pairs: np.ndarray, cfg: ConsensusConfig,
                        drop_intersection: bool = True,
                        budget: int = 1 << 25, mesh=None) -> np.ndarray:
    """Affinity weight per candidate patch pair (computePatchGraph.cu), in
    the JAX package's expectation form (consensus_jax.py:913-958).

    For a pair (c1, c2), dc = c2 - c1, patch pixels p1, p2 with the hi
    vectors of ``graph_hi`` and x_i = c_i + off(p_i) - rad, dt = x2 - x1:

        acc    = sum hi1 hi2 S_sym[dt + ps - 1][x1]   (|dt| <= ps - 1)
        fg_cnt = sum hi1 hi2 [in reach(dt)]
        in reach: -(ps-1) <= dt <= ps if dt . strides >= 0,
                  else -ps <= dt <= ps - 1
        weight = acc / max(1, fg_cnt)  (acc if not norm_graph)

    Intersection pixel pairs (x1 within rad of c2 and x2 within rad of
    c1) count 0.2 in both sums: the CUDA kernel keeps 20% of them with a
    sequential LCG; the JAX package takes the expectation, so no seed
    plays a part.  Pairs farther than 2(ps-1) on any axis weigh 0.

    Both sums depend on p1 only through the first patch, so pairs are
    grouped by first patch and each group gets two fields over
    u = dc + off(p2):

        F[u] = sum_p1 hi1 S_sym[u - off(p1)][x1]  (one gather per p1)
        C[u] = sum_p1 hi1 [in reach(u - off(p1))] (one matmul with a
                                                   static 0/1 table)

    and each pair reads them at its partner's hi pixels.  The intersection
    term, nonzero only for pairs within ps - 1 on every axis, is the
    direct sum over the two intersection boxes.  Every sum is a gather and
    a reduction in a fixed order: the result does not depend on the run.
    ``budget`` bounds the elements of one batch of intersection terms.

    With a ``mesh`` (a list of devices, ``parallel/sharded.py``), the
    groups of pairs that share a first patch go round-robin over the
    devices, each with its own copy of the affinities and the consensus
    (consensus_jax.py:998-1056 sends its segments round-robin the same
    way; the JAX package pads the segment count to 8 * n_dev so that its
    compiled shapes split evenly, which eager PyTorch does not need).
    """
    if mesh is not None and len(mesh) > 1 and len(pairs) > 0:
        return _graph_weights_mesh(affs, cons_sym, pairs, cfg,
                                   drop_intersection, budget, mesh)
    dev = affs.device
    ps_np = cfg.ps
    pairs = np.asarray(pairs).astype(np.int64)
    out = np.zeros(len(pairs), np.float32)
    if len(pairs) == 0:
        return out
    dc_np = pairs[:, 3:] - pairs[:, :3]
    near = np.nonzero(np.all(np.abs(dc_np) <= 2 * (ps_np - 1)[None],
                             axis=1))[0]
    if len(near) == 0:
        return out
    vol = tuple(int(s) for s in affs.shape[1:])
    V = int(np.prod(vol))
    ends = np.concatenate([pairs[near, :3], pairs[near, 3:]])
    centers, inv = np.unique(ends, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    id1, id2 = inv[:len(near)], inv[len(near):]
    firsts, slot = np.unique(id1, return_inverse=True)

    ps = torch.as_tensor(ps_np, device=dev)
    rad = ps // 2
    offs = torch.as_tensor(patch_offsets(ps_np), device=dev)      # (P, 3)
    c_t = torch.as_tensor(centers, device=dev)
    HI = graph_hi(affs, c_t, cfg)                                 # (n_u, P)
    s_flat = cons_sym.reshape(-1)
    vol_t = torch.as_tensor(vol, device=dev)

    def x_lin(c, o):  # voxel c + off - rad, clamped (hi is 0 outside)
        x = torch.minimum((c + o - rad).clamp(min=0), vol_t - 1)
        return _lin(x, vol)

    # static tables over the field extents: U = 3ps - 2 for the values
    # (u = dc + off(p2) + ps - 1) and E = 3ps for the counts, whose reach
    # extends to |dt| = ps (e = dc + off(p2) + ps)
    U = tuple(int(3 * p - 2) for p in ps_np)
    E = tuple(int(3 * p) for p in ps_np)
    w_all = torch.as_tensor(patch_offsets(E), device=dev) - ps    # (E^3, 3)
    dt = w_all[:, None] - offs[None]                              # (E^3,P,3)
    vstr = torch.as_tensor([vol[1] * vol[2], vol[2], 1], device=dev)
    fwd = ((dt * vstr).sum(-1) >= 0)[..., None]
    reach = _in_box(dt, torch.where(fwd, -(ps - 1), -ps),
                    torch.where(fwd, ps, ps - 1)).to(torch.float32)

    # per-first-patch value fields: F = sum over p1 of hi1[p1] times the
    # (2ps-1)^3 consensus window at x1(p1), placed at offset off(p1); one
    # gather over all first patches per p1, added in patch-pixel order
    f_c = c_t[torch.as_tensor(firsts, device=dev)]
    f_hi = HI[torch.as_tensor(firsts, device=dev)]
    n_f = len(firsts)
    nd = tuple(int(n) for n in cfg.neigh)
    field = torch.zeros((n_f,) + U, dtype=torch.float32, device=dev)
    n_idx = torch.arange(int(np.prod(nd)), device=dev) * V
    x1l = x_lin(f_c[:, None], offs[None])                         # (n_f, P)
    offs_h = patch_offsets(ps_np)       # host copy: no sync per p1
    for p1 in torch.nonzero(f_hi.any(dim=0))[:, 0].tolist():
        win = s_flat[n_idx[None] + x1l[:, p1, None]].to(torch.float32)
        o = [int(v) for v in offs_h[p1]]
        field[:, o[0]:o[0] + nd[0], o[1]:o[1] + nd[1],
              o[2]:o[2] + nd[2]] += (win * f_hi[:, p1, None]).reshape(
                  (n_f,) + nd)
    field = field.reshape(n_f, -1)
    with exact_f32():
        count = f_hi @ reach.T                                    # (n_f,E^3)

    # pairs: read the fields at the partner's hi pixels
    dc = torch.as_tensor(dc_np[near], device=dev)
    slot_t = torch.as_tensor(slot, device=dev)
    hi2 = HI[torch.as_tensor(id2, device=dev)]                    # (n, P)
    u = dc[:, None] + offs[None] + ps - 1                         # (n, P, 3)
    u_ok = _in_box(u, 0, 3 * (ps - 1))
    base = slot_t[:, None] * field.shape[1]
    acc = torch.sum(hi2 * u_ok * field.reshape(-1)[
        base + torch.where(u_ok, _lin(u.clamp(min=0), U), 0)], dim=1)
    e = u + 1                         # = dc + off(p2) + ps, in [0, 3ps)
    e_ok = _in_box(e, 0, ps * 3 - 1)
    base = slot_t[:, None] * count.shape[1]
    fg_cnt = torch.sum(hi2 * e_ok * count.reshape(-1)[
        base + torch.where(e_ok, _lin(e.clamp(min=0), E), 0)], dim=1)

    if drop_intersection:
        # x1 and x2 both lie in the patches' intersection box, whose
        # extent is ps - |dc| <= ps per axis, so every such pixel pair is
        # within consensus reach: its neighbourhood index is
        # lin(dc + ps - 1) + lin(off(p2) - off(p1)), with no bounds test
        close = torch.nonzero(torch.all(dc.abs() <= ps - 1, dim=1))[:, 0]
        neigh = torch.as_tensor(cfg.neigh, device=dev)
        d_lin = _lin(offs[None] - offs[:, None], neigh)           # (P, P)
        c1_all = torch.as_tensor(pairs[near, :3], device=dev)
        id1_t = torch.as_tensor(id1, device=dev)
        a_hi = HI[id1_t[close]] * _in_box(
            (offs - rad)[None] - dc[close, None], -rad, rad)
        b_hi = hi2[close] * _in_box(
            (offs - rad)[None] + dc[close, None], -rad, rad)
        na, nb = a_hi.sum(1), b_hi.sum(1)
        # batches of similar box sizes, each compacted to its own extent
        # (sizes read once on the host: no device sync per batch)
        na_h = na.cpu().numpy().astype(np.int64)
        nb_h = nb.cpu().numpy().astype(np.int64)
        order_h = np.argsort(-(na_h * nb_h), kind="stable")
        order = torch.as_tensor(order_h, device=dev)
        corr = torch.zeros(len(close), dtype=torch.float32, device=dev)
        s = 0
        while s < len(close):
            big = order_h[s]
            n_sl = max(1, budget // max(1, int(na_h[big] * nb_h[big])))
            sl_h = order_h[s:s + n_sl]
            sl = order[s:s + n_sl]
            s += len(sl_h)
            i1, v1 = _compact(a_hi[sl], max(1, int(na_h[sl_h].max())))
            i2, v2 = _compact(b_hi[sl], max(1, int(nb_h[sl_h].max())))
            ci = close[sl]
            nl = _lin(dc[ci] + ps - 1, neigh)[:, None, None] \
                + d_lin[i1[:, :, None], i2[:, None, :]]
            xl = x_lin(c1_all[ci, None], offs[i1])[:, :, None]
            w = v1[:, :, None] * v2[:, None, :]
            nl = torch.where(w > 0, nl, 0)    # compaction padding
            val = s_flat[nl * V + xl].to(torch.float32)
            corr[sl] = torch.sum(w * val, dim=(1, 2))
        acc[close] = acc[close] - 0.8 * corr
        fg_cnt[close] = fg_cnt[close] - 0.8 * (na * nb)
    w = acc / torch.clamp(fg_cnt, min=1.0) if cfg.norm_graph else acc
    out[near] = w.cpu().numpy()
    return out


def _graph_weights_mesh(affs, cons_sym, pairs, cfg, drop_intersection,
                        budget, mesh) -> np.ndarray:
    """``patch_graph_weights`` with the first-patch groups round-robin over
    ``mesh``: every pair's weight reads its own group's fields only, so
    each device weighs its share of the pairs on its own.  The devices
    take their shares in turn: the weighing reads batch sizes back to the
    host, so shares on several cards overlap only in part."""
    pairs = np.asarray(pairs).astype(np.int64)
    _, group = np.unique(pairs[:, :3], axis=0, return_inverse=True)
    group = group.reshape(-1) % len(mesh)
    out = np.zeros(len(pairs), np.float32)
    for k, dev in enumerate(mesh):
        sel = np.nonzero(group == k)[0]
        if len(sel):
            out[sel] = patch_graph_weights(
                affs.to(dev), cons_sym.to(dev), pairs[sel], cfg,
                drop_intersection, budget)
    return out
