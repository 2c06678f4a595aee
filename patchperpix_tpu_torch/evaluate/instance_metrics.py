"""Instance-segmentation scores; counterpart of
``patchperpix_tpu/evaluate/instance_metrics.py`` trimmed to the slice:
IoU localization, Hungarian assignment and the AP at one threshold.
The clDice / avg_f1_cov scores need skeletonization and are not ported.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def instance_masks(labels: np.ndarray, keep_shape: bool = False):
    """List of (id, boolean mask) from a flat label volume or a
    one-instance-per-channel stack (keep_gt_shape semantics): the stack
    reading applies only when every nonzero channel holds one id."""
    if labels.ndim >= 3 and keep_shape and labels.shape[0] > 1 \
            and len(np.unique(labels)) <= labels.shape[0] + 1:
        masks = []
        ok = True
        for c in range(labels.shape[0]):
            m = labels[c] > 0
            if not m.any():
                continue
            ids = np.unique(labels[c][m])
            if len(ids) != 1:
                ok = False
                break
            masks.append((int(ids[0]), m))
        if ok and masks:
            return masks
    masks = []
    flat = labels if labels.ndim <= 3 else np.max(labels, axis=0)
    for i in np.unique(flat[flat > 0]):
        masks.append((int(i), flat == i))
    return masks


def iou_matrix(gt_masks, pred_masks) -> np.ndarray:
    out = np.zeros((len(gt_masks), len(pred_masks)), dtype=np.float64)
    for gi, (_, g) in enumerate(gt_masks):
        gs = int(g.sum())
        for pi, (_, p) in enumerate(pred_masks):
            inter = int(np.logical_and(g, p).sum())
            if inter == 0:
                continue
            out[gi, pi] = inter / (gs + int(p.sum()) - inter)
    return out


def assign(scores: np.ndarray, threshold: float):
    """Hungarian matching of gt rows to pred columns; returns the matches
    (gi, pi, score) scoring above ``threshold``."""
    if scores.size == 0:
        return []
    ri, ci = linear_sum_assignment(-scores)
    return [(int(g), int(p), scores[g, p])
            for g, p in zip(ri, ci) if scores[g, p] > threshold]


def average_precision(pred_labels: np.ndarray, gt_labels: np.ndarray,
                      threshold: float = 0.5,
                      keep_gt_shape: bool = False) -> dict:
    """AP = TP / (TP + FP + FN) under IoU with Hungarian matching, as
    ``evaluate_labels(..., "iou", "hungarian")`` reports it per
    threshold."""
    gt = instance_masks(np.asarray(gt_labels), keep_shape=keep_gt_shape)
    pred = instance_masks(np.asarray(pred_labels))
    tp = len(assign(iou_matrix(gt, pred), threshold))
    fp, fn = len(pred) - tp, len(gt) - tp
    return {"AP": tp / max(tp + fp + fn, 1), "AP_TP": tp, "AP_FP": fp,
            "AP_FN": fn}
