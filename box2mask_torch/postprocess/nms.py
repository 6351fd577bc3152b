"""Non-maximum clustering of box votes on the device (port of
box2mask_tpu/postprocess/nms.py:69 nms_clustering_jax), and the port's copies
of its NumPy versions for the host oracle: nms_clustering_np, mask_nms_np
and mask_nms_matrix (postprocess/detection2mask.py).

Greedy by score: each representative's IoU row against ALL boxes is its
cluster heatmap (its own entry forced to 1); boxes with IoU > cluster_th join
its cluster. The loop is bounded by `max_clusters`. Each step is masked, so
steps after the last cluster change nothing, and the host reads the "any box
left" flag only every `SYNC_EVERY` steps instead of every step; the steps
and the reads are counted (tracing).
"""

from __future__ import annotations

import numpy as np
import torch

from box2mask_torch import tracing
from box2mask_torch.postprocess import iou as I
from box2mask_torch.postprocess.iou import one_vs_all_ious

SYNC_EVERY = 16


def nms_clustering(boxes, valid, cluster_th, max_clusters=256):
    """boxes: (N, 7) [score, min, max]; valid: (N,) bool (padding excluded).
    Returns (reps (R,) int64, heatmaps (R, N) f32, rep_valid (R,) bool,
    overflow 0-dim bool): overflow is True when the bound stopped the
    clustering with boxes left unclustered."""
    N = boxes.shape[0]
    dev = boxes.device
    scores = torch.where(valid, boxes[:, 0], float('-inf'))
    geo = boxes[:, 1:]
    reps = torch.zeros(max_clusters, dtype=torch.int64, device=dev)
    heatmaps = torch.zeros(max_clusters, N, dtype=torch.float32, device=dev)
    repv = torch.zeros(max_clusters, dtype=torch.bool, device=dev)
    remaining = valid.clone()
    ar = torch.arange(N, device=dev)
    steps = syncs = 0
    for r in range(max_clusters):
        if r % SYNC_EVERY == 0:
            syncs += 1
            if not bool(remaining.any()):
                break
        steps += 1
        active = remaining.any()
        top = torch.argmax(torch.where(remaining, scores, float('-inf')))
        row = one_vs_all_ious(geo[top], geo)
        row = torch.where(ar == top, 1.0, row)
        reps[r] = torch.where(active, top, 0)
        heatmaps[r] = torch.where(active, row, 0.0)
        repv[r] = active
        remaining = remaining & ((row <= cluster_th) | ~active)
    tracing.add('cluster_steps', steps)
    tracing.add('post_syncs', syncs)
    return reps, heatmaps, repv, remaining.any()


def nms_clustering_np(boxes, cluster_th=0.5, get_heatmaps=True,
                      matrix_threshold=4000):
    """boxes: (N,7) [score, min, max]. Returns (reps, clusters, heatmaps).

    For N <= matrix_threshold all pairwise IoUs are computed once as a matrix
    and the greedy loop runs on its rows (no per-iteration IoU recompute);
    above it, rows are computed lazily to bound memory."""
    assert boxes.ndim == 2 and boxes.shape[1] == 7
    assert 0 < cluster_th < 1
    boxes = np.asarray(boxes, np.float64)
    side = boxes[:, 4:] - boxes[:, 1:4]
    if not (side.min(axis=1) > 0).all():
        print('Warning: Invalid boxes found.')
    order = np.argsort(-boxes[:, 0], kind='stable')
    geo = boxes[:, 1:]
    N = len(boxes)
    iou_matrix = None
    if N and N <= matrix_threshold:
        imin = np.maximum(geo[:, None, :3], geo[None, :, :3])
        imax = np.minimum(geo[:, None, 3:], geo[None, :, 3:])
        inter = np.prod(np.clip(imax - imin, 0, None), axis=2)
        vol = np.prod(geo[:, 3:] - geo[:, :3], axis=1)
        iou_matrix = inter / (vol[:, None] + vol[None, :] - inter + I.EPS)
    reps, clusters, heatmaps = [], [], []
    remaining = order
    while len(remaining):
        top = remaining[0]
        row = (iou_matrix[top].copy() if iou_matrix is not None
               else I.one_vs_all_ious_np(geo[top], geo))
        row[top] = 1.0
        ious = row[remaining]
        keep = ious <= cluster_th
        reps.append(top)
        clusters.append(remaining[~keep])
        if get_heatmaps:
            heatmaps.append(row)
        remaining = remaining[keep]
    reps = np.array(reps, np.int64)
    if get_heatmaps:
        hm = np.stack(heatmaps, 0) if heatmaps else np.zeros((0, len(boxes)))
        return reps, clusters, hm
    return reps, clusters


def mask_nms_np(sorted_masks, cluster_th=0.5, allow_empty=False):
    """Greedy mask dedup; input masks sorted by confidence. Returns kept indices."""
    remaining = np.arange(len(sorted_masks))
    kept, suppressed = [], []
    while len(remaining):
        top = remaining[0]
        ious = I.masks_iou_np(sorted_masks[top], sorted_masks[remaining], allow_empty)
        ious[0] = 1.0
        keep = ious <= cluster_th
        kept.append(top)
        suppressed.append((top, remaining[~keep]))
        remaining = remaining[keep]
    return np.array(kept, np.int64), suppressed


def mask_nms_matrix(sorted_masks, cluster_th=0.5):
    """Exact mask_nms_np semantics, but all pairwise IoUs are computed once via
    one f32 matmul (R^2*V flops) and the greedy loop runs on the R x R matrix —
    removes the O(R^2*V) python re-scan that dominated post-processing."""
    R = len(sorted_masks)
    if R == 0:
        return np.zeros(0, np.int64), []
    M = np.asarray(sorted_masks, np.float32)
    inter = M @ M.T
    areas = np.diag(inter).copy()
    union = areas[:, None] + areas[None, :] - inter
    iou = np.divide(inter, union, out=np.zeros_like(inter), where=union > 0)
    np.fill_diagonal(iou, 1.0)
    remaining = np.ones(R, bool)
    kept, suppressed = [], []
    while remaining.any():
        top = int(np.argmax(remaining))
        keep = iou[top] <= cluster_th
        kept.append(top)
        suppressed.append((top, np.nonzero(remaining & ~keep)[0]))
        remaining &= keep
    return np.array(kept, np.int64), suppressed
