"""Instance segmentation metrics.

Counterpart of ``patchperpix_tpu/evaluate/instance_metrics.py``, in full:
the surface of the external ``evaluate-instance-segmentation`` package the
reference depends on (run_ppp.py:44, consumed keys
run_ppp.py:1609-1654, 1922-1931): per-threshold confusion matrices with
IoU or clDice localization, greedy or hungarian assignment, false
split/merge counts, skeleton coverage, and the FlyLight combined score
avg_f1_cov_score = (avFscore + avg_gt_skel_coverage) / 2.

Result dict layout (dotted-path addressable via config.get_by_path):
  general.{Num GT, Num Pred, avg_gt_skel_coverage, avg_f1_cov_score}
  confusion_matrix.avFscore
  confusion_matrix.th_0_5.{AP, AP_TP, AP_FP, AP_FN, precision, recall,
                           fscore, false_split, false_merge,
                           avg_tp_skel_coverage}
"""

from __future__ import annotations

import csv

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..config import get_by_path
from ..utils import io as vio
from ..utils.postprocess import remove_small_components as rm_small
from ..utils.skeleton import skeletonize

DEFAULT_THRESHOLDS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def _instance_masks(labels: np.ndarray, keep_shape: bool = False):
    """List of (id, boolean mask) from a flat label volume or a
    one-instance-per-channel stack (keep_gt_shape semantics).

    The stack interpretation is only used when every nonzero channel
    carries exactly ONE instance id — a flat volume whose leading axis
    slices hold several ids (the common misconfiguration) falls back to
    flat labeling instead of silently scoring slices as instances."""
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
                ok = False  # not one-instance-per-channel
                break
            masks.append((int(ids[0]), m))
        if ok and masks:
            return masks
    masks = []
    flat = labels if labels.ndim <= 3 else np.max(labels, axis=0)
    for i in np.unique(flat[flat > 0]):
        masks.append((int(i), flat == i))
    return masks


def _th_key(t: float) -> str:
    """Canonical per-threshold result key (shared by evaluate_labels and
    the fold averaging so float noise can't desynchronize lookups)."""
    return "th_" + str(round(float(t), 2)).replace(".", "_")


def iou_matrix(gt_masks, pred_masks) -> np.ndarray:
    n_gt, n_pred = len(gt_masks), len(pred_masks)
    out = np.zeros((n_gt, n_pred), dtype=np.float64)
    for gi, (_, g) in enumerate(gt_masks):
        gs = int(g.sum())
        for pi, (_, p) in enumerate(pred_masks):
            inter = int(np.logical_and(g, p).sum())
            if inter == 0:
                continue
            out[gi, pi] = inter / (gs + int(p.sum()) - inter)
    return out


def gt_skel_recall_matrix(gt_masks, pred_masks, gt_skels=None):
    """Per-(gt, pred) gt-skeleton recall |gt_skel AND pred| / |gt_skel| —
    the avg_tp_skel_coverage building block.  Needs NO pred skeletons
    (cheaper than the full clDice matrix on the iou path)."""
    if gt_skels is None:
        gt_skels = [skeletonize(g) > 0 for _, g in gt_masks]
    out = np.zeros((len(gt_masks), len(pred_masks)), dtype=np.float64)
    for gi, gsk in enumerate(gt_skels):
        gsk_n = max(int(gsk.sum()), 1)
        for pi, (_, p) in enumerate(pred_masks):
            out[gi, pi] = int(np.logical_and(gsk, p).sum()) / gsk_n
    return out


def cldice_matrix(gt_masks, pred_masks, gt_skels=None):
    """clDice localization: harmonic mean of topology precision/sensitivity
    on skeletons.  Also returns per-(gt, pred) gt-skeleton recall (the
    skeleton-coverage building block)."""
    if gt_skels is None:
        gt_skels = [skeletonize(g) > 0 for _, g in gt_masks]
    pred_skels = [skeletonize(p) > 0 for _, p in pred_masks]
    n_gt, n_pred = len(gt_masks), len(pred_masks)
    mat = np.zeros((n_gt, n_pred), dtype=np.float64)
    gt_cov = np.zeros((n_gt, n_pred), dtype=np.float64)
    for gi, (_, g) in enumerate(gt_masks):
        gsk = gt_skels[gi]
        gsk_n = max(int(gsk.sum()), 1)
        for pi, (_, p) in enumerate(pred_masks):
            psk = pred_skels[pi]
            psk_n = max(int(psk.sum()), 1)
            tprec = int(np.logical_and(psk, g).sum()) / psk_n
            tsens = int(np.logical_and(gsk, p).sum()) / gsk_n
            gt_cov[gi, pi] = tsens
            if tprec + tsens > 0:
                mat[gi, pi] = 2 * tprec * tsens / (tprec + tsens)
    return mat, gt_cov


def assign(scores: np.ndarray, threshold: float, strategy: str):
    """Match gt rows to pred columns; returns list of (gi, pi, score)."""
    if scores.size == 0:
        return []
    if strategy == "hungarian":
        ri, ci = linear_sum_assignment(-scores)
        return [(int(g), int(p), scores[g, p])
                for g, p in zip(ri, ci) if scores[g, p] > threshold]
    if strategy == "greedy":
        order = np.dstack(np.unravel_index(
            np.argsort(-scores, axis=None), scores.shape))[0]
        used_g, used_p, out = set(), set(), []
        for g, p in order:
            s = scores[g, p]
            if s <= threshold:
                break
            if g in used_g or p in used_p:
                continue
            used_g.add(int(g))
            used_p.add(int(p))
            out.append((int(g), int(p), float(s)))
        return out
    raise ValueError(f"unknown assignment strategy {strategy}")


def union_skel_coverage(gt_masks, pred_union: np.ndarray,
                        gt_skels=None) -> np.ndarray:
    """Per-gt skeleton coverage by the UNION of all predictions:
    |gt_skel AND (pred > 0)| / |gt_skel|.  This is the package's
    gt_skel_coverage (a per-gt list; run_ppp.py:1624-1626 consumes it as
    ``general.gt_skel_coverage``), NOT a per-pred sum."""
    if gt_skels is None:
        gt_skels = [skeletonize(g) > 0 for _, g in gt_masks]
    out = np.zeros(len(gt_masks), dtype=np.float64)
    for gi, gsk in enumerate(gt_skels):
        n = int(gsk.sum())
        if n == 0:
            continue
        out[gi] = int(np.logical_and(gsk, pred_union).sum()) / n
    return out


def rand_voi_scores(gt_flat: np.ndarray, pred_flat: np.ndarray) -> dict:
    """Foreground-restricted adapted Rand + variation of information.

    The ISBI 2012 / CREMI conventions (the reference's ISBI numbers,
    README.md:110-120, come from the challenge server which computes
    exactly these — the reference has no local implementation):

    - pixels with gt == 0 (boundary/background) are excluded;
    - ``rand_fscore`` is V^Rand (the ISBI leaderboard's rRAND, higher is
      better); ``adapted_rand_error`` = 1 - V^Rand;
    - ``voi_split`` = H(pred | gt) (over-segmentation),
      ``voi_merge`` = H(gt | pred) (under-segmentation), nats.
    """
    gt = np.asarray(gt_flat).ravel().astype(np.int64)
    pred = np.asarray(pred_flat).ravel().astype(np.int64)
    m = gt > 0
    gt, pred = gt[m], pred[m]
    n = gt.size
    zero = {"rand_fscore": 0.0, "adapted_rand_error": 1.0,
            "rand_precision": 0.0, "rand_recall": 0.0,
            "voi_split": 0.0, "voi_merge": 0.0}
    if n == 0:
        return zero
    # joint contingency via a fused key (labels are small ints)
    key = gt * (pred.max() + 1) + pred
    p_ij = np.unique(key, return_counts=True)[1].astype(np.float64) / n
    a_i = np.unique(gt, return_counts=True)[1].astype(np.float64) / n
    b_j = np.unique(pred, return_counts=True)[1].astype(np.float64) / n
    sum_p2 = float(np.sum(p_ij ** 2))
    sum_a2 = float(np.sum(a_i ** 2))
    sum_b2 = float(np.sum(b_j ** 2))
    if sum_p2 == 0.0:
        return zero
    precision = sum_p2 / sum_b2
    recall = sum_p2 / sum_a2
    f = 2.0 * precision * recall / (precision + recall)
    h_joint = -float(np.sum(p_ij * np.log(p_ij)))
    h_gt = -float(np.sum(a_i * np.log(a_i)))
    h_pred = -float(np.sum(b_j * np.log(b_j)))
    return {"rand_fscore": f, "adapted_rand_error": 1.0 - f,
            "rand_precision": precision, "rand_recall": recall,
            "voi_split": h_joint - h_gt, "voi_merge": h_joint - h_pred}


def evaluate_labels(
    pred_labels: np.ndarray,
    gt_labels: np.ndarray,
    localization_criterion: str = "iou",
    assignment_strategy: str = "hungarian",
    thresholds=DEFAULT_THRESHOLDS,
    remove_small_components: int = 0,
    keep_gt_shape: bool = False,
    add_general_metrics=("avg_gt_skel_coverage", "avg_f1_cov_score"),
    add_multi_thresh_metrics=("avg_tp_skel_coverage",),
    fs_fm_floor: float = 0.1,
    partly: bool = False,
) -> dict:
    """Full metric dict for one sample.

    Definitions (evaluate-instance-segmentation package semantics, consumed
    keys per run_ppp.py:1609-1654):

    - false_split: for each gt, predicted segments beyond the first whose
      localization score exceeds ``fs_fm_floor`` (extra fragments covering
      the same gt).  false_merge: symmetric, gts beyond the first covered
      by one prediction.  Both are matching-independent counts reported per
      threshold key (the reference consumes th_0_5).
    - gt_skel_coverage (general): PER-GT list of skeleton coverage by the
      union of all predictions; avg_gt_skel_coverage is its mean.
    - avg_tp_skel_coverage (per threshold): mean over matched gts of the
      ASSIGNED prediction's gt-skeleton recall gt_cov[g, p].
    - avg_f1_cov_score = (avFscore + avg_gt_skel_coverage) / 2.
    - partly: the GT is only partly labeled — predictions that do not
      intersect any labeled GT voxel are dropped before matching so they
      are not counted as FP (reference routes ``partly=`` into the
      external evaluate_file, run_ppp.py:1206-1212, 1254; unlabeled
      regions may contain true instances the annotators skipped).
    """
    pred_labels = np.asarray(pred_labels)
    if remove_small_components:
        pred_labels = rm_small(pred_labels, remove_small_components)
    gt_masks = _instance_masks(np.asarray(gt_labels), keep_shape=keep_gt_shape)
    pred_masks = _instance_masks(pred_labels)

    n_pred_unfiltered = len(pred_masks)
    if partly and gt_masks:
        gt_union = np.zeros_like(gt_masks[0][1])
        for _, g in gt_masks:
            gt_union |= g
        pred_masks = [(i, p) for i, p in pred_masks
                      if np.logical_and(p, gt_union).any()]

    want_tp_skel = "avg_tp_skel_coverage" in (add_multi_thresh_metrics or ())
    want_gt_skel = "avg_gt_skel_coverage" in (add_general_metrics or ())
    # gt skeletons computed ONCE and shared by the clDice matrix, the
    # tp-coverage matrix and the union coverage (skeletonization is the
    # dominant cost per sample)
    gt_skels = None
    if want_tp_skel or want_gt_skel or localization_criterion == "cldice":
        gt_skels = [skeletonize(g) > 0 for _, g in gt_masks]
    gt_cov = None
    if localization_criterion == "iou":
        scores = iou_matrix(gt_masks, pred_masks)
        if want_tp_skel:
            # only the gt-skeleton recall is needed — skip the pred
            # skeletonization the full clDice matrix would pay for
            gt_cov = gt_skel_recall_matrix(gt_masks, pred_masks, gt_skels)
    elif localization_criterion == "cldice":
        scores, gt_cov = cldice_matrix(gt_masks, pred_masks, gt_skels)
    else:
        raise ValueError(localization_criterion)

    n_gt, n_pred = len(gt_masks), len(pred_masks)
    result = {"general": {"Num GT": n_gt, "Num Pred": n_pred},
              "confusion_matrix": {}}
    if partly:
        result["general"]["Num Pred unfiltered"] = n_pred_unfiltered
        result["general"]["partly"] = True

    # matching-independent split/merge counts above the overlap floor
    overl = scores > fs_fm_floor
    false_split = int(np.maximum(overl.sum(axis=1) - 1, 0).sum())
    false_merge = int(np.maximum(overl.sum(axis=0) - 1, 0).sum())

    fscores = []
    for th in thresholds:
        matches = assign(scores, th, assignment_strategy)
        tp = len(matches)
        fp = n_pred - tp
        fn = n_gt - tp
        precision = tp / max(n_pred, 1)
        recall = tp / max(n_gt, 1)
        fscore = (2 * precision * recall / (precision + recall)
                  if precision + recall > 0 else 0.0)
        ap = tp / max(tp + fp + fn, 1)
        key = _th_key(th)
        entry = {
            "AP": ap, "AP_TP": tp, "AP_FP": fp, "AP_FN": fn,
            "precision": precision, "recall": recall, "fscore": fscore,
            "false_split": false_split, "false_merge": false_merge,
        }
        if gt_cov is not None and want_tp_skel:
            # coverage of each matched gt by its ASSIGNED pred
            tp_cov = [gt_cov[g, p] for g, p, _s in matches]
            entry["avg_tp_skel_coverage"] = float(np.mean(tp_cov)) \
                if tp_cov else 0.0
        result["confusion_matrix"][key] = entry
        fscores.append(fscore)

    result["confusion_matrix"]["avFscore"] = float(np.mean(fscores)) \
        if fscores else 0.0

    if {"adapted_rand_error", "voi", "rand_fscore"} \
            & set(add_general_metrics or ()):
        # align ranks: a channel-stacked side (one instance per channel)
        # is flattened by max to match the flat side's spatial rank
        flat_gt, fp_ = np.asarray(gt_labels), pred_labels
        while flat_gt.ndim > fp_.ndim:
            flat_gt = flat_gt.max(axis=0)
        while fp_.ndim > flat_gt.ndim:
            fp_ = fp_.max(axis=0)
        if (flat_gt.shape != fp_.shape
                and flat_gt.shape[1:] == fp_.shape[1:]):
            # equal rank but different channel counts (e.g. 2-channel gt
            # stack vs single-channel pred volume): flatten both
            flat_gt, fp_ = flat_gt.max(axis=0), fp_.max(axis=0)
        result["general"].update(rand_voi_scores(flat_gt, fp_))

    if want_gt_skel:
        flat_pred = (pred_labels if pred_labels.ndim <= 3
                     else np.max(pred_labels, axis=0))
        per_gt = union_skel_coverage(gt_masks, flat_pred > 0, gt_skels)
        cov = float(np.mean(per_gt)) if n_gt else 0.0
        result["general"]["gt_skel_coverage"] = per_gt.tolist()
        result["general"]["avg_gt_skel_coverage"] = cov
        if "avg_f1_cov_score" in (add_general_metrics or ()):
            result["general"]["avg_f1_cov_score"] = \
                0.5 * result["confusion_matrix"]["avFscore"] + 0.5 * cov
    return result


def evaluate_file(
    res_file: str,
    gt_file: str,
    res_key: str = "vote_instances",
    gt_key: str = "volumes/gt_instances",
    **kwargs,
) -> dict:
    """File-level entry matching the external package's call signature
    (run_ppp.py:1239-1262).  Either file is an HDF5 file (the results
    ``label`` writes) or a zarr store (``utils/io.open_volume``)."""
    rio = vio.open_volume(res_file, mode="r")
    pred = rio.read(key=res_key)
    rio.close()
    gio = vio.open_volume(gt_file, mode="r")
    gt = gio.read(key=gt_key)
    gio.close()
    known = {"localization_criterion", "assignment_strategy", "thresholds",
             "remove_small_components", "keep_gt_shape",
             "add_general_metrics", "add_multi_thresh_metrics", "partly"}
    kw = {k: v for k, v in kwargs.items() if k in known}
    return evaluate_labels(pred, gt, **kw)


def summarize_metric_dict(metric_dicts: dict, summary_keys,
                          out_csv: str | None = None) -> list[list]:
    """Rows of [sample, *metrics] for the configured dotted summary keys
    (run_ppp.py:1516-1529)."""
    rows = [["sample"] + list(summary_keys)]
    for sample, md in metric_dicts.items():
        rows.append([sample] + [get_by_path(md, k) for k in summary_keys])
    if out_csv:
        with open(out_csv, "w", newline="") as f:
            csv.writer(f).writerows(rows)
    return rows


def average_score_over_instances(metric_dicts: dict,
                                 thresholds=DEFAULT_THRESHOLDS):
    """FlyLight instance-count-weighted fold score
    (run_ppp.py:1609-1654): per threshold, TP/FP/FN summed over samples
    before the F-score; gt skeleton coverages concatenated per instance;
    avS = (mean fscore + mean coverage) / 2.  Returns (avS, counts dict
    for cross-fold accumulation)."""
    fscores = []
    gt_covs: list = []
    tp = {t: 0 for t in thresholds}
    fp = {t: 0 for t in thresholds}
    fn = {t: 0 for t in thresholds}
    false_split = 0
    false_merge = 0
    for md in metric_dicts.values():
        gt_covs += [float(c) for c in
                    md["general"].get("gt_skel_coverage", [])]
        for t in thresholds:
            cm = md["confusion_matrix"][_th_key(t)]
            tp[t] += cm["AP_TP"]
            fp[t] += cm["AP_FP"]
            fn[t] += cm["AP_FN"]
            if abs(t - 0.5) < 1e-9:
                false_split += cm["false_split"]
                false_merge += cm["false_merge"]
    for t in thresholds:
        denom = 2 * tp[t] + fp[t] + fn[t]
        fscores.append(2 * tp[t] / denom if denom else 0.0)
    avS = 0.5 * float(np.mean(fscores)) + \
        0.5 * (float(np.mean(gt_covs)) if gt_covs else 0.0)
    counts = {
        "gt_covs": gt_covs,
        "false_split": int(false_split),
        "false_merge": int(false_merge),
        "tp": [int(tp[t]) for t in thresholds],
        "fp": [int(fp[t]) for t in thresholds],
        "fn": [int(fn[t]) for t in thresholds],
    }
    return avS, counts


def average_score_with_instance_counts(counts1: dict, counts2: dict):
    """Combine two folds' per-instance counts (run_ppp.py:1657-1671)."""
    gt_covs = counts1["gt_covs"] + counts2["gt_covs"]
    tps = np.array(counts1["tp"]) + np.array(counts2["tp"])
    fps = np.array(counts1["fp"]) + np.array(counts2["fp"])
    fns = np.array(counts1["fn"]) + np.array(counts2["fn"])
    denom = 2 * tps + fps + fns
    fscores = np.where(denom > 0, 2 * tps / np.maximum(denom, 1), 0.0)
    cov = float(np.mean(gt_covs)) if gt_covs else 0.0
    avS = 0.5 * cov + 0.5 * float(np.mean(fscores))
    return avS, {
        "avg_f1_cov_score": avS,
        "avg_gt_skel_coverage": cov,
        "fscores": fscores.tolist(),
        "avFscore": float(np.mean(fscores)),
        "false_split": counts1["false_split"] + counts2["false_split"],
        "false_merge": counts1["false_merge"] + counts2["false_merge"],
    }
