"""Detection-to-mask post-processing of one scene, in NumPy float32 (the
precision the configurations state for it).

From the per-segment head outputs: box score sigmoid(s); box = centre
(segment location + offset) -/+ half-size (at least min_bb_size); class =
argmax of the semantics, foreground by the dataset's rule. Greedy
clustering: repeatedly the remaining foreground box of highest score
(first on ties) founds a cluster whose heat map is its IoU with every box
(1 for itself); boxes with IoU above the cluster threshold leave the
remaining set; at most `max_masks` clusters. A cluster whose founder
scores above the score threshold is a candidate; its mask is the
foreground segments whose heat exceeds the mask threshold. Greedy mask
NMS over the candidates in cluster order: a kept mask removes every later
candidate whose voxel IoU with it exceeds the NMS threshold. A kept mask's
class is the most frequent class among its voxels (first on ties). Masks
go to the points through each point's segment.
"""

from __future__ import annotations

import numpy as np

from h100bench.reference.targets import is_foreground

EPS = 1e-6


def _iou_row(box, boxes, P):
    sa = box[3:] - box[:3]
    sb = boxes[:, 3:] - boxes[:, :3]
    inter = np.maximum(np.minimum(box[3:], boxes[:, 3:])
                       - np.maximum(box[:3], boxes[:, :3]), np.float32(0))
    inter = P(P(inter[:, 0] * inter[:, 1]) * inter[:, 2])
    vol_a = P(P(sa[0] * sa[1]) * sa[2])
    vol_b = P(P(sb[:, 0] * sb[:, 1]) * sb[:, 2])
    union = P(P(P(vol_a + vol_b) - inter) + np.float32(EPS))
    return P(inter / union)


def scene_masks(heads, seg_loc, vox_seg_row, point_seg_row, ths, valid_ids,
                fg_rule, min_bb, max_masks, numerics):
    """heads: {offsets, bounds, scores (S,), semantics (S, C)} of one
    scene's segments. Returns {conf (n,), label_id (n,), mask (n, points)}
    of the kept masks in cluster order."""
    P = numerics.post
    f32 = np.float32
    cluster_th, score_th, bin_th, nms_th = (f32(t) for t in ths)
    nms_th = min(nms_th, f32(1.0 - 1e-6))
    off = P(heads['offsets'])
    bnd = P(np.maximum(P(heads['bounds']), f32(min_bb)))
    with np.errstate(over='ignore'):
        score = P(f32(1) / (f32(1) + np.exp(-P(heads['scores']).astype(f32))))
    centre = P(P(seg_loc) + off)
    boxes = np.concatenate([P(centre - bnd), P(centre + bnd)], 1)
    sem = np.argmax(heads['semantics'], axis=1)
    fg = is_foreground(np.asarray(valid_ids)[sem], fg_rule)

    remaining = fg.copy()
    reps, heat = [], []
    for _ in range(max_masks):
        if not remaining.any():
            break
        top = int(np.argmax(np.where(remaining, score, -np.inf)))
        row = _iou_row(boxes[top], boxes, P)
        row[top] = 1.0
        reps.append(top)
        heat.append(row)
        remaining &= row <= cluster_th
    S = len(score)
    n_vox = np.bincount(vox_seg_row, minlength=S).astype(f32)
    if not reps:
        return {'conf': np.zeros(0, f32), 'label_id': np.zeros(0, np.int32),
                'mask': np.zeros((0, len(point_seg_row)), bool)}
    heat = np.stack(heat) * fg[None, :]
    rep_score = score[reps]
    seg_mask = heat > bin_th                               # (R, S)
    M = seg_mask.astype(f32)
    inter = (M * n_vox) @ M.T
    area = np.diag(inter)
    union = area[:, None] + area[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, f32(1)), f32(0))
    remaining = rep_score > score_th
    keep = np.zeros(len(reps), bool)
    while remaining.any():
        top = int(np.argmax(remaining))
        keep[top] = True
        row = iou[top].copy()
        row[top] = 1.0
        remaining &= row <= nms_th
    onehot = np.eye(heads['semantics'].shape[1], dtype=f32)[sem]
    label = np.argmax((M * n_vox) @ onehot, axis=1)
    kept = np.nonzero(keep)[0]
    return {'conf': rep_score[kept].astype(f32),
            'label_id': np.asarray(valid_ids)[label[kept]].astype(np.int32),
            'mask': seg_mask[kept][:, point_seg_row]}
