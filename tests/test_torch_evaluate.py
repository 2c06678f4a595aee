"""Port's evaluation (``evaluate/instance_metrics.py``,
``evaluate/prediction.py``, ``ops/affinities.py``) vs the JAX package's,
on the CPU.

Every metric dict must equal the JAX package's: the same keys, equal
integers and lists, floats within 1e-12 (the same numpy arithmetic in
the same order on both sides).  On the stored float32 map of the FlyLight
crop the port gives the JAX run's avg_f1_cov 0.5921277619200735 and
AP@0.5 0.2857142857142857 (clDice, greedy).
"""

import json
import os

import numpy as np
import pytest
import torch

import patchperpix_tpu.evaluate.instance_metrics as JM
import patchperpix_tpu.evaluate.prediction as JP
from patchperpix_tpu.ops import synthetic as jsyn
from patchperpix_tpu.ops.affinities import \
    gt_affinities_dense as jax_gt_affs
import patchperpix_tpu_torch.evaluate.instance_metrics as TM
import patchperpix_tpu_torch.evaluate.prediction as TP
from patchperpix_tpu_torch.ops.affinities import gt_affinities_dense
from patchperpix_tpu_torch.utils.io import IoZarr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = os.path.join(REPO, "data", "JRC_SS05008-20160318_24_B2_crop.zarr")
REF = os.path.join(REPO, "parity", "torch_port_ref_f32")


def assert_same(got, want, path="result"):
    """Recursive equality: keys, ints, bools and strings exact, floats
    within 1e-12, arrays equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (bool, np.bool_, str)) or want is None:
        assert got == want, path
    elif isinstance(want, (int, np.integer)) and not isinstance(
            got, (float, np.floating)):
        assert got == want, path
    else:
        assert abs(float(got) - float(want)) <= 1e-12, (path, got, want)


# -- the stored float32 map of the crop ------------------------------------

@pytest.fixture(scope="module")
def crop_map():
    inst = np.load(REF + ".npz")["inst"]
    gt = IoZarr(CROP).read(key="volumes/gt_instances").astype(np.int32)
    return inst, gt, json.load(open(REF + ".json"))


@pytest.mark.parametrize("criterion,strategy", [("cldice", "greedy"),
                                                ("iou", "hungarian")])
def test_evaluate_labels_on_stored_map(crop_map, criterion, strategy):
    inst, gt, meta = crop_map
    kw = dict(localization_criterion=criterion,
              assignment_strategy=strategy, keep_gt_shape=True,
              remove_small_components=400)
    got = TM.evaluate_labels(inst, gt, **kw)
    assert_same(got, JM.evaluate_labels(inst, gt, **kw))
    ap = got["confusion_matrix"]["th_0_5"]["AP"]
    if criterion == "cldice":
        assert abs(got["general"]["avg_f1_cov_score"]
                   - 0.5921277619200735) <= 1e-12
        assert abs(got["general"]["avg_f1_cov_score"]
                   - meta["avg_f1_cov_score"]) <= 1e-12
        assert abs(ap - meta["AP_0.5_cldice_greedy"]) <= 1e-12
    else:
        assert abs(ap - meta["AP_0.5_iou_hungarian"]) <= 1e-12
    assert abs(ap - 0.2857142857142857) <= 1e-12


def test_evaluate_file_reads_zarr_result(crop_map, tmp_path):
    inst, gt, _ = crop_map
    res = str(tmp_path / "s.zarr")
    io = IoZarr(res, mode="w")
    io.create("vote_instances", inst.shape, inst.dtype)
    io.write(inst, key="vote_instances")
    kw = dict(localization_criterion="cldice", assignment_strategy="greedy",
              keep_gt_shape=True, remove_small_components=60,
              add_general_metrics=["avg_gt_skel_coverage",
                                   "avg_f1_cov_score"],
              add_multi_thresh_metrics=(), gt_key="volumes/gt_instances")
    assert_same(TM.evaluate_file(res, CROP, **kw),
                JM.evaluate_labels(inst, gt, **{
                    k: v for k, v in kw.items() if k != "gt_key"}))


# -- the inputs of tests/test_evaluate.py ----------------------------------

def _perfect():
    gt = np.zeros((20, 20), dtype=np.int32)
    gt[2:8, 2:8] = 1
    gt[12:18, 12:18] = 2
    return gt, gt.copy()


def _split():
    gt, _ = _perfect()
    pred = np.zeros_like(gt)
    pred[2:8, 2:5] = 1
    pred[2:8, 5:8] = 2
    return pred, gt


def _offset():
    gt, _ = _perfect()
    pred = np.zeros_like(gt)
    pred[4:10, 4:10] = 7
    return pred, gt


def _cldice_line():
    gt = np.zeros((1, 30, 30), dtype=np.int32)
    gt[0, 15, 5:25] = 1
    pred = np.zeros_like(gt)
    pred[0, 15, 5:20] = 3
    return pred, gt


def _channel_stack():
    gt = np.zeros((2, 20, 20), dtype=np.int32)
    gt[0, 2:10, 2:10] = 1
    gt[1, 6:14, 6:14] = 2
    pred = np.zeros((20, 20), dtype=np.int32)
    pred[2:10, 2:10] = 1
    pred[10:14, 10:14] = 2
    return pred, gt


def _junk():
    gt, pred = _perfect()
    pred[0, 19] = 9
    return pred, gt


def _hline(y, x0, x1, shape=(20, 40)):
    m = np.zeros(shape, np.int32)
    m[y, x0:x1] = 1
    return m


def _hand_split():
    pred = np.zeros((20, 40), np.int32)
    pred[10, 0:18] = 1
    pred[10, 18:30] = 2
    return pred, _hline(10, 0, 30)


def _hand_merge():
    gt = np.zeros((20, 40), np.int32)
    gt[10, 0:10] = 1
    gt[10, 20:30] = 2
    pred = np.zeros((20, 40), np.int32)
    pred[10, 0:30] = 1
    return pred, gt


def _tp_skel():
    gt = np.zeros((30, 40), np.int32)
    gt[10, 0:20] = 1
    pred = np.zeros((30, 40), np.int32)
    pred[10, 0:15] = 1
    pred[12:29, 0:40] = 2
    pred[10, 15:20] = 2
    return pred, gt


def _partly():
    gt = np.zeros((20, 20), dtype=np.int32)
    gt[2:8, 2:8] = 1
    pred = np.zeros((20, 20), dtype=np.int32)
    pred[2:8, 2:8] = 1
    pred[12:18, 12:18] = 2
    return pred, gt


def _flat_volume():
    gt = np.zeros((4, 20, 20), dtype=np.int32)
    gt[1:3, 2:8, 2:8] = 1
    gt[1:3, 12:18, 12:18] = 2
    return gt.copy(), gt


def _rand_voi_gt():
    gt = np.zeros((16, 16), np.int32)
    gt[2:8, 2:8] = 1
    gt[10:15, 10:15] = 2
    return gt


def _fold_dicts():
    def md(tp, fp, fn, covs):
        return {"general": {"gt_skel_coverage": covs},
                "confusion_matrix": {"th_0_5": {
                    "AP_TP": tp, "AP_FP": fp, "AP_FN": fn,
                    "false_split": 1, "false_merge": 0}}}
    return {"a": md(1, 0, 0, [1.0]), "b": md(1, 0, 2, [0.5, 0.0, 1.0])}


def _fold_averages(m):
    avs, counts = m.average_score_over_instances(_fold_dicts(),
                                                 thresholds=(0.5,))
    return avs, counts, m.average_score_with_instance_counts(counts, counts)


def _noisy_thresholds(m):
    ths = tuple(np.arange(0.1, 1.0, 0.1))
    res = m.evaluate_labels(*_perfect()[::-1], thresholds=ths)
    return res, m.average_score_over_instances({"s": res}, thresholds=ths)


def _union_coverage(m):
    pred = np.zeros((2, 20, 40), np.int32)
    pred[0, 10, 0:18] = 1
    pred[1, 10, 0:18] = 2
    return m.union_skel_coverage(m._instance_masks(_hline(10, 0, 30)),
                                 pred.max(axis=0) > 0)


def _even_split(m):
    gt = np.ones((10, 8), np.int32)
    pred = np.ones_like(gt)
    pred[5:] = 2
    return m.rand_voi_scores(gt, pred)


def _summary(m):
    res = m.evaluate_labels(*_perfect()[::-1])
    return m.summarize_metric_dict(
        {"s1": res}, ["general.Num GT", "confusion_matrix.th_0_5.fscore"])


IOU_H = dict(localization_criterion="iou", assignment_strategy="hungarian")
CASES = {
    "perfect": lambda m: m.evaluate_labels(*_perfect()[::-1], **IOU_H),
    "split": lambda m: m.evaluate_labels(
        *_split(), localization_criterion="iou", assignment_strategy="greedy"),
    "merge": lambda m: m.evaluate_labels((_perfect()[0] > 0).astype(
        np.int32), _perfect()[0]),
    "offset_hungarian": lambda m: m.evaluate_labels(
        *_offset(), assignment_strategy="hungarian"),
    "offset_greedy": lambda m: m.evaluate_labels(
        *_offset(), assignment_strategy="greedy"),
    "cldice_line": lambda m: m.evaluate_labels(
        *_cldice_line(), localization_criterion="cldice",
        assignment_strategy="greedy"),
    "keep_gt_shape_stack": lambda m: m.evaluate_labels(
        *_channel_stack(), keep_gt_shape=True),
    "remove_small": lambda m: m.evaluate_labels(
        *_junk(), remove_small_components=5),
    "hand_split": lambda m: m.evaluate_labels(*_hand_split(), **IOU_H),
    "hand_merge": lambda m: m.evaluate_labels(*_hand_merge()),
    "tp_skel_assigned": lambda m: m.evaluate_labels(*_tp_skel()),
    "partly": lambda m: m.evaluate_labels(*_partly(), partly=True, **IOU_H),
    "partly_off": lambda m: m.evaluate_labels(*_partly(), **IOU_H),
    "flat_volume_fallback": lambda m: m.evaluate_labels(
        *_flat_volume(), keep_gt_shape=True, **IOU_H),
    "rand_voi_labels": lambda m: m.evaluate_labels(
        _rand_voi_gt(), _rand_voi_gt(), add_general_metrics=(
            "avg_gt_skel_coverage", "avg_f1_cov_score",
            "adapted_rand_error", "voi"), **IOU_H),
    "rand_voi_relabelled": lambda m: m.rand_voi_scores(
        _perfect()[0], _perfect()[0] + 5 * (_perfect()[0] > 0)),
    "rand_voi_even_split": _even_split,
    "union_skel_coverage": _union_coverage,
    "fold_averages": _fold_averages,
    "noisy_threshold_keys": _noisy_thresholds,
    "summary_rows": _summary,
    "th_keys": lambda m: [m._th_key(t) for t in np.arange(0.1, 1.0, 0.1)],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_equal_jax(case):
    assert_same(CASES[case](TM), CASES[case](JM))


@pytest.mark.parametrize("strategy", ["greedy", "hungarian"])
def test_assign_equals_jax_on_near_ties(strategy):
    """Greedy keeps np.argsort(-scores, axis=None): near-tied scores break
    ties in the JAX package's order."""
    rng = np.random.RandomState(3)
    scores = np.round(rng.rand(9, 11), 2)
    scores[2, 3] = scores[4, 5] = scores[7, 1] = 0.77
    got = TM.assign(scores, 0.3, strategy)
    assert got == JM.assign(scores, 0.3, strategy) and len(got) == 9


# -- prediction metrics ----------------------------------------------------

def _labels3d(seed):
    rng = np.random.RandomState(seed)
    labels = np.zeros((2, 14, 12, 13), np.int32)
    labels[0, 2:9, 3:10, 2:8] = 1
    labels[1, 5:12, 1:6, 4:12] = 2
    labels[0, 10:13, 7:11, 8:12] = 3
    return labels, rng


def test_gt_affinities_dense_equal_jax():
    labels, _ = _labels3d(0)
    for ps in ((3, 3, 3), (5, 3, 5)):
        got = gt_affinities_dense(labels[None], ps, device="cpu")
        want = np.asarray(jax_gt_affs(labels[None], ps))
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("overlap", [False, True])
def test_evaluate_patch_equals_jax(overlap):
    labels, rng = _labels3d(1)
    ps = np.array([3, 3, 3])
    affs = jsyn.labels_to_affinities(labels.max(0), ps)
    affs = np.clip(affs + 0.3 * rng.randn(*affs.shape), 0, 1
                   ).astype(np.float32)
    om = (labels > 0).sum(0) > 1 if overlap else None
    got = TP.evaluate_patch(affs, labels, ps, overlap_mask=om, device="cpu")
    assert_same(got, JP.evaluate_patch(affs, labels, ps, overlap_mask=om))
    assert got["th_0_5"]["iou_volume"].shape == labels.shape[1:]


def test_evaluate_numinst_and_fg_equal_jax():
    labels, rng = _labels3d(2)
    probs = rng.rand(3, *labels.shape[1:]).astype(np.float32)
    probs /= probs.sum(0, keepdims=True)
    assert_same(TP.evaluate_numinst(probs, labels, 2),
                JP.evaluate_numinst(probs, labels, 2))
    fg_prob = rng.rand(*labels.shape[1:]).astype(np.float32)
    gt_fg = labels.max(0) > 0
    kw = dict(remove_small_comps=(0, 3, 50))
    assert_same(TP.evaluate_fg(fg_prob, gt_fg, **kw),
                JP.evaluate_fg(fg_prob, gt_fg, **kw))
