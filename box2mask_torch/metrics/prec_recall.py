"""Per-scene detection precision/recall helpers + center+size box IoU (the
port's copy of box2mask_tpu/metrics/prec_recall.py).

Behavior-parity with reference utils/metric_util.py:19-113 (whose __main__
block is the reference's only real unit test suite — mirrored in
tests/test_misc_units.py): greedy best-IoU matching of predicted
boxes to ground truth at a threshold; each gt matched at most once.
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.metrics.box3d import aabb_iou_cs


def scene_precision_recall(pred_boxes, gt_boxes, iou_threshold=0.25,
                           get_iou=aabb_iou_cs):
    """pred_boxes/gt_boxes: lists of (center, size). Returns
    (precision, recall, tp, fp, fn)."""
    matched = [False] * len(gt_boxes)
    tp = 0
    for pb in pred_boxes:
        best, best_j = 0.0, -1
        for j, gb in enumerate(gt_boxes):
            if matched[j]:
                continue
            iou = get_iou(pb, gb)
            if iou > best:
                best, best_j = iou, j
        if best >= iou_threshold and best_j >= 0:
            matched[best_j] = True
            tp += 1
    fp = len(pred_boxes) - tp
    fn = len(gt_boxes) - tp
    precision = tp / max(len(pred_boxes), 1)
    recall = tp / max(len(gt_boxes), 1)
    return precision, recall, tp, fp, fn


def dataset_precision_recall(per_scene_pred, per_scene_gt, iou_threshold=0.25):
    """Micro-averaged precision/recall over scenes."""
    tps = fps = fns = 0
    for pred, gt in zip(per_scene_pred, per_scene_gt):
        _, _, tp, fp, fn = scene_precision_recall(pred, gt, iou_threshold)
        tps, fps, fns = tps + tp, fps + fp, fns + fn
    precision = tps / max(tps + fps, 1)
    recall = tps / max(tps + fns, 1)
    return precision, recall
