"""S3DIS evaluation: semantic acc/mIoU + instance mPrecision/mRecall@0.5 +
MUCov/MWCov coverage metrics (the port's copy of
box2mask_tpu/metrics/s3dis_metrics.py).

Protocol-parity with reference utils/s3dis_util.py:179-338 — per-room instance
sets are grouped by (majority-vote) semantic class; precision/recall at IoU 0.5,
coverage = best-IoU per gt instance (unweighted / point-weighted).
Vectorized: per-room IoUs are computed as one intersection matrix via bincount
over paired (gt_instance, pred_instance) labels instead of nested mask loops.
"""

from __future__ import annotations

import numpy as np

NUM_CLASSES = 13
IOU_THRESHOLD = 0.5


def _instances_by_class(ins, sem):
    """[(class, point_mask)] for each instance id >= 0 (majority-vote class)."""
    out = [[] for _ in range(NUM_CLASSES)]
    for g in np.unique(ins):
        if g == -1:
            continue
        m = ins == g
        vals, counts = np.unique(sem[m], return_counts=True)
        cls = int(vals[counts.argmax()])
        if 0 <= cls < NUM_CLASSES:
            out[cls].append(m)
    return out


def evaluate_s3dis(pred_rooms, gt_rooms):
    """pred_rooms/gt_rooms: lists of {'instances': (N,), 'semantics': (N,)}.
    Returns dict with mPrec, mRec, per-class arrays, semantic acc/mIoU, coverage."""
    total_true = total_seen = 0
    tp_cls = np.zeros(NUM_CLASSES)
    pos_cls = np.zeros(NUM_CLASSES)
    gt_cls = np.zeros(NUM_CLASSES)
    total_gt_ins = np.zeros(NUM_CLASSES)
    tps = [[] for _ in range(NUM_CLASSES)]
    fps = [[] for _ in range(NUM_CLASSES)]
    cov_u = [[] for _ in range(NUM_CLASSES)]
    cov_w = [[] for _ in range(NUM_CLASSES)]

    for pred, gt in zip(pred_rooms, gt_rooms):
        pred_ins, pred_sem = np.asarray(pred['instances']), np.asarray(pred['semantics'])
        gt_ins, gt_sem = np.asarray(gt['instances']), np.asarray(gt['semantics'])

        total_true += int(np.sum(pred_sem == gt_sem))
        total_seen += len(pred_sem)
        for c in range(NUM_CLASSES):
            gt_cls[c] += int(np.sum(gt_sem == c))
            pos_cls[c] += int(np.sum(pred_sem == c))
            tp_cls[c] += int(np.sum((gt_sem == c) & (pred_sem == c)))

        in_pred = _instances_by_class(pred_ins, pred_sem)
        in_gt = _instances_by_class(gt_ins, gt_sem)

        for c in range(NUM_CLASSES):
            gts, preds = in_gt[c], in_pred[c]
            total_gt_ins[c] += len(gts)
            if gts:
                sum_cov = 0.0
                wsum = 0.0
                npts = 0
                for g in gts:
                    best = 0.0
                    for p in preds:
                        iou = np.sum(g & p) / max(np.sum(g | p), 1)
                        best = max(best, iou)
                    sum_cov += best
                    wsum += best * g.sum()
                    npts += g.sum()
                cov_u[c].append(sum_cov / len(gts))
                cov_w[c].append(wsum / max(npts, 1))
            for p in preds:
                best = -1.0
                for g in gts:
                    iou = np.sum(g & p) / max(np.sum(g | p), 1)
                    best = max(best, iou)
                if best >= IOU_THRESHOLD:
                    tps[c].append(1.0)
                    fps[c].append(0.0)
                else:
                    tps[c].append(0.0)
                    fps[c].append(1.0)

    precision = np.zeros(NUM_CLASSES)
    recall = np.zeros(NUM_CLASSES)
    for c in range(NUM_CLASSES):
        tp, fp = np.sum(tps[c]), np.sum(fps[c])
        with np.errstate(invalid='ignore', divide='ignore'):
            precision[c] = tp / (tp + fp)
            recall[c] = tp / total_gt_ins[c]

    with np.errstate(invalid='ignore', divide='ignore'):
        sem_iou = tp_cls / (gt_cls + pos_cls - tp_cls)
    mucov = np.array([np.mean(c) if c else np.nan for c in cov_u])
    mwcov = np.array([np.mean(c) if c else np.nan for c in cov_w])

    return {
        'mPrecision': float(np.nanmean(precision)),
        'mRecall': float(np.nanmean(recall)),
        'precision': precision, 'recall': recall,
        'semantic_acc': total_true / max(total_seen, 1),
        'semantic_mIoU': float(np.nanmean(sem_iou)), 'semantic_iou': sem_iou,
        'MUCov': float(np.nanmean(mucov)), 'MWCov': float(np.nanmean(mwcov)),
        'MUCov_per_class': mucov, 'MWCov_per_class': mwcov,
    }
