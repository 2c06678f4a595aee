"""Prediction-quality metrics (before assembly).

Counterpart of ``patchperpix_tpu/evaluate/prediction.py`` (reference
PatchPerPix/evaluate/evaluate_prediction.py): patch-affinity precision /
recall / F1 and the per-pixel patch IoU against ground-truth affinities
(``evaluate_patch``, :38-150), per-class numinst metrics (:153-255), and
foreground-mask metrics over thresholds and small-component removal sizes
(:258-371).  The ground-truth affinities come from ``ops/affinities.py``
on ``device``.
"""

from __future__ import annotations

import numpy as np

from ..ops.affinities import gt_affinities_dense
from ..utils.postprocess import clean_mask


def _prf(tp, fp, fn):
    p = tp / max(tp + fp, 1)
    r = tp / max(tp + fn, 1)
    f = 2 * p * r / (p + r) if p + r > 0 else 0.0
    return {"precision": p, "recall": r, "fscore": f,
            "TP": int(tp), "FP": int(fp), "FN": int(fn)}


def evaluate_patch(pred_affs: np.ndarray, gt_labels: np.ndarray,
                   patchshape, thresholds=(0.5, 0.6, 0.7, 0.8, 0.9),
                   overlap_mask: np.ndarray | None = None,
                   store_iou: bool = True, device="cuda") -> dict:
    """pred_affs (P, *vol); gt_labels (C, *vol).

    GT affinities from the labels; overlap regions zeroed on both sides;
    per-threshold P/R/F1 plus the per-pixel patch IoU volume (the ranking
    oracle, use_score_oracle)."""
    ps = np.asarray(patchshape)
    rad = ps // 2
    labels_pad = np.pad(np.asarray(gt_labels),
                        [(0, 0)] + [(int(r), int(r)) for r in rad])
    gt_affs = gt_affinities_dense(labels_pad[None], tuple(int(p) for p in ps),
                                  device=device)[0].cpu().numpy()

    if overlap_mask is not None:
        m = overlap_mask[None] > 0
        gt_affs = np.where(m, 0.0, gt_affs)
        pred_affs = np.where(m, 0.0, pred_affs)

    fg_any = gt_affs.max(axis=0) > 0
    out = {}
    for th in thresholds:
        pred_b = pred_affs > th
        gt_b = gt_affs > 0.5
        tp = int(np.logical_and(pred_b, gt_b).sum())
        fp = int(np.logical_and(pred_b, ~gt_b).sum())
        fn = int(np.logical_and(~pred_b, gt_b).sum())
        key = "th_" + str(round(th, 2)).replace(".", "_")
        out[key] = _prf(tp, fp, fn)
        if store_iou:
            inter = np.logical_and(pred_b, gt_b).sum(axis=0)
            union = np.logical_or(pred_b, gt_b).sum(axis=0)
            iou = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
            iou = np.where(fg_any, iou, 0.0)
            out[key]["iou_volume"] = iou.astype(np.float32)
    return out


def evaluate_numinst(pred_numinst: np.ndarray, gt_labels: np.ndarray,
                     max_numinst: int = 2) -> dict:
    """pred_numinst (K, *vol) softmax probs; gt from per-channel labels."""
    gt_ni = np.clip(np.sum(np.asarray(gt_labels) > 0, axis=0),
                    0, max_numinst)
    pred_cls = np.argmax(pred_numinst, axis=0)
    out = {}
    for k in range(max_numinst + 1):
        tp = int(np.logical_and(pred_cls == k, gt_ni == k).sum())
        fp = int(np.logical_and(pred_cls == k, gt_ni != k).sum())
        fn = int(np.logical_and(pred_cls != k, gt_ni == k).sum())
        out[f"class_{k}"] = _prf(tp, fp, fn)
    out["accuracy"] = float((pred_cls == gt_ni).mean())
    return out


def evaluate_fg(pred_fg: np.ndarray, gt_fg: np.ndarray,
                thresholds=(0.3, 0.5, 0.7, 0.9),
                remove_small_comps=(0, 100, 500)) -> dict:
    """Foreground probability vs gt mask, over thresholds x cleanup sizes."""
    gt_b = np.asarray(gt_fg) > 0
    out = {}
    for th in thresholds:
        for rm in remove_small_comps:
            mask = np.asarray(pred_fg) > th
            if rm > 0:
                mask = clean_mask(mask, rm)
            tp = int(np.logical_and(mask, gt_b).sum())
            fp = int(np.logical_and(mask, ~gt_b).sum())
            fn = int(np.logical_and(~mask, gt_b).sum())
            key = (f"th_{str(round(th, 2)).replace('.', '_')}"
                   f"_rm_{rm}")
            out[key] = _prf(tp, fp, fn)
    return out
