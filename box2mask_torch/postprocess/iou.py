"""Axis-aligned box and mask IoU: the device version of
box2mask_tpu/postprocess/iou.py:37 one_vs_all_ious in torch, and the port's
copies of its NumPy versions for the host oracle (postprocess/
detection2mask.py). The reference's +1e-6 in the union is kept for
threshold parity (models/iou_nms.py:4-45, 109-128)."""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6


def one_vs_all_ious(box, boxes):
    """(M,) IoU of one (6,) [min, max] box vs (M, 6) boxes."""
    sb = boxes[:, 3:] - boxes[:, :3]
    sa = box[3:] - box[:3]
    imin = torch.maximum(box[:3], boxes[:, :3])
    imax = torch.minimum(box[3:], boxes[:, 3:])
    inter = torch.prod(torch.clamp(imax - imin, min=0), dim=1)
    union = torch.prod(sa) + torch.prod(sb, dim=1) - inter + EPS
    return inter / union


def set_ious_np(boxes_a, boxes_b):
    """(N,) pairwise-aligned IoU of (N,6)[min,max] boxes."""
    sa = boxes_a[:, 3:] - boxes_a[:, :3]
    sb = boxes_b[:, 3:] - boxes_b[:, :3]
    assert (sa >= 0).all() and (sb >= 0).all()
    imin = np.maximum(boxes_a[:, :3], boxes_b[:, :3])
    imax = np.minimum(boxes_a[:, 3:], boxes_b[:, 3:])
    inter = np.prod(np.clip(imax - imin, 0, None), axis=1)
    union = np.prod(sa, 1) + np.prod(sb, 1) - inter + EPS
    return inter / union


def one_vs_all_ious_np(box, boxes):
    """(M,) IoU of one (6,) box vs (M,6) boxes."""
    sb = boxes[:, 3:] - boxes[:, :3]
    sa = box[3:] - box[:3]
    imin = np.maximum(box[:3], boxes[:, :3])
    imax = np.minimum(box[3:], boxes[:, 3:])
    inter = np.prod(np.clip(imax - imin, 0, None), axis=1)
    union = np.prod(sa) + np.prod(sb, 1) - inter + EPS
    return inter / union


def masks_iou_np(mask, masks, allow_empty=False):
    """(M,) IoU of one bool mask vs (M, V) masks (reference iou_nms.py:109-121)."""
    inter = np.sum(mask[None, :] & masks, axis=1)
    union = np.sum(mask[None, :] | masks, axis=1)
    if not allow_empty:
        assert (masks.sum(1) > 0).all() and mask.sum() > 0
        return inter / union
    out = np.zeros(len(masks), np.float64)
    nz = union > 0
    out[nz] = inter[nz] / union[nz]
    return out


def to_bbs_min_max_np(locations, offsets, bounds, scores=None):
    """[score?, min, max] columns from vote parametrization
    (reference utils/util.py:46-64)."""
    centers = offsets + locations
    bbs = np.concatenate([centers - bounds, centers + bounds], axis=1)
    if scores is not None:
        bbs = np.concatenate([scores.reshape(-1, 1), bbs], axis=1)
    return bbs
