"""VOC-style 3D detection AP, used by the ARKitScenes eval (the port's copy
of box2mask_tpu/metrics/detection_ap.py).

Protocol-parity with the reference's detection evaluator
(utils/evaluate_detections.py:28-274, itself derived from the public votenet
code): per-class greedy confidence-ranked matching at an IoU threshold, AP by
VOC integration (11-point or continuous).
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.metrics.box3d import box3d_iou


def voc_ap(rec, prec, use_07_metric=False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def corners_iou(c1, c2):
    return box3d_iou(np.asarray(c1), np.asarray(c2))[0]


def eval_det_cls(pred, gt, ovthresh=0.25, use_07_metric=False,
                 get_iou_func=corners_iou):
    """pred: {img_id: [(bb, score)]}, gt: {img_id: [bb]} for ONE class.
    Returns (rec, prec, ap)."""
    class_recs = {}
    npos = 0
    for img_id, bbs in gt.items():
        class_recs[img_id] = {'bb': np.array(bbs),
                              'det': [False] * len(bbs)}
        npos += len(bbs)
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {'bb': np.array([]), 'det': []}

    image_ids, confidence, BB = [], [], []
    for img_id, dets in pred.items():
        for bb, score in dets:
            image_ids.append(img_id)
            confidence.append(score)
            BB.append(bb)
    confidence = np.array(confidence)
    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    BB = [BB[i] for i in order]

    nd = len(image_ids)
    tp, fp = np.zeros(nd), np.zeros(nd)
    for d in range(nd):
        R = class_recs[image_ids[d]]
        bb = BB[d]
        ovmax, jmax = -np.inf, -1
        for j in range(len(R['bb'])):
            iou = get_iou_func(bb, R['bb'][j])
            if iou > ovmax:
                ovmax, jmax = iou, j
        if ovmax > ovthresh and not R['det'][jmax]:
            tp[d] = 1.0
            R['det'][jmax] = True
        else:
            fp[d] = 1.0

    fp, tp = np.cumsum(fp), np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all, gt_all, ovthresh=0.25, use_07_metric=False,
             get_iou_func=corners_iou):
    """pred_all: {img_id: [(classname, bb, score)]}, gt_all: {img_id:
    [(classname, bb)]}. Returns (rec, prec, ap) dicts keyed by classname."""
    pred, gt = {}, {}
    for img_id, dets in pred_all.items():
        for classname, bb, score in dets:
            pred.setdefault(classname, {}).setdefault(img_id, []).append((bb, score))
    for img_id, boxes in gt_all.items():
        for classname, bb in boxes:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(bb)

    rec, prec, ap = {}, {}, {}
    for classname in gt:
        if classname in pred:
            rec[classname], prec[classname], ap[classname] = eval_det_cls(
                pred[classname], gt[classname], ovthresh, use_07_metric,
                get_iou_func)
        else:
            rec[classname], prec[classname], ap[classname] = 0.0, 0.0, 0.0
    return rec, prec, ap
