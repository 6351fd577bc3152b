"""Votes -> instance masks: clustering, score filtering, heatmap projection,
binarization, mask NMS, per-mask semantics.

Behavior-parity with SelectionNet.detection2mask (models/detection_net.py:369-488):
  1. votes -> [sigmoid(score), min, max] boxes per oversegment,
  2. per scene: predicted-foreground filter, NMS clustering -> representatives +
     IoU heatmaps over all fg segments,
  3. score threshold, zero-pad heatmaps over background, project seg -> vox,
  4. binarize at mask_bin_th, greedy mask NMS (skipped for per-voxel semantics,
     matching the reference), per-mask majority-vote semantic label,
  5. eval mode: project vox -> point.

Thresholds (cluster_th, score_th, mask_bin_th, mask_nms_th) = cfg.eval_ths.
The port's copy of box2mask_tpu/postprocess/detection2mask.py: the host NumPy
oracle, which the non-fused evaluation runs off the card and for the
per-voxel semantics head, which the device post-processing does not read.
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.datasets.voxelize import segment_mode
from box2mask_torch.postprocess import nms
from box2mask_torch.postprocess.iou import to_bbs_min_max_np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def detection_to_masks(pred, dev, host, cfg, valid_class_ids, is_foreground,
                       mode='eval', score_filtering=True, ths=None,
                       scene_idx=None):
    """pred: dict of np arrays (padded); dev/host: batch dicts from build_batch.
    Returns {scene_name: {conf, label_id, mask, ...}} like the reference.
    With scene_idx set, processes only that scene (parallel post-processing)."""
    cluster_th, score_th, mask_bin_th, mask_nms_th = ths if ths is not None \
        else cfg.eval_ths
    S = int(dev['num_segments'])
    loc = np.asarray(dev['input_location'])[:S]
    offsets = np.asarray(pred[cfg.mlp_offsets])[:S]
    bounds = np.asarray(pred[cfg.mlp_bounds])[:S]
    if cfg.min_bb_size is not None:       # to_min_size clamp (detection_net.py:519)
        bounds = np.clip(bounds, cfg.min_bb_size, None)
    scores = _sigmoid(np.asarray(pred[cfg.mlp_bb_scores])[:S, 0])
    pred_bbs = to_bbs_min_max_np(loc, offsets, bounds, scores)

    per_vox = cfg.mlp_per_vox_semantics in cfg.network_heads
    if per_vox:
        # full array + batch0 masks (supports both tail-padded and interleaved
        # voxel layouts, see datasets/batching.py)
        vox_sem_all = np.argmax(np.asarray(pred[cfg.mlp_per_vox_semantics]), 1)
    else:
        sem_idx = np.argmax(np.asarray(pred[cfg.mlp_semantics])[:S], 1)
        sem_ids = np.asarray(valid_class_ids)[sem_idx]

    batch_ids = np.asarray(dev['batch_ids'])[:S]
    vox_batch = np.asarray(dev['batch0'])
    results = {}
    scene_list = (enumerate(host['scene']) if scene_idx is None
                  else [(scene_idx, host['scene'][scene_idx])])
    for scene_idx, scene in scene_list:
        smask = batch_ids == scene_idx
        n_seg = int(smask.sum())
        seg2vox = host['seg2vox'][scene_idx]

        if per_vox:
            scene_vox_sem = vox_sem_all[vox_batch == scene_idx]
            # per-segment majority vote of voxel predictions
            seg_sem = segment_mode(scene_vox_sem, seg2vox, n_seg)
            scene_fg = np.asarray(is_foreground(seg_sem))
            scene_sem_for_masks = scene_vox_sem
        else:
            scene_seg_sem_ids = sem_ids[smask]
            scene_fg = np.asarray(is_foreground(scene_seg_sem_ids))
            scene_sem_for_masks = None  # projected below

        scene_bbs = pred_bbs[smask][scene_fg]
        if len(scene_bbs) == 0:
            results[scene['name']] = {'conf': np.zeros(0), 'label_id':
                                      np.zeros(0, np.int32),
                                      'mask': np.zeros((0, 0), bool)}
            continue

        reps, _, heatmaps = nms.nms_clustering_np(scene_bbs, cluster_th=cluster_th)
        rep_scores = scene_bbs[reps][:, 0]
        rep_bbs = scene_bbs[reps]
        if score_filtering:
            keep = rep_scores > score_th
            heatmaps, rep_scores = heatmaps[keep], rep_scores[keep]
            rep_bbs, reps = rep_bbs[keep], reps[keep]

        # zero-pad heatmaps over background segments, project to voxels
        hm_w_bg = np.zeros((len(heatmaps), n_seg), np.float32)
        hm_w_bg[:, scene_fg] = heatmaps
        vox_heatmaps = hm_w_bg[:, seg2vox]
        if not per_vox:
            scene_sem_for_masks = scene_seg_sem_ids[seg2vox]

        masks = vox_heatmaps > mask_bin_th
        if not per_vox:
            kept, _ = nms.mask_nms_matrix(masks, mask_nms_th)
        else:
            kept = np.arange(len(masks))
        masks, rep_scores = masks[kept], rep_scores[kept]
        rep_bbs, reps = rep_bbs[kept], reps[kept]
        vox_heatmaps = vox_heatmaps[kept]

        # per-mask majority semantic via one bincount over (mask, class) pairs
        labels = np.zeros(len(masks), np.int32)
        if len(masks):
            R = len(masks)
            C = int(scene_sem_for_masks.max()) + 1
            mi, vi = np.nonzero(masks)
            counts = np.bincount(mi * C + scene_sem_for_masks[vi],
                                 minlength=R * C).reshape(R, C)
            labels = counts.argmax(axis=1).astype(np.int32)

        if mode == 'eval':
            vox2point = host['vox2point'][scene_idx]
            results[scene['name']] = {'conf': rep_scores, 'label_id': labels,
                                      'mask': masks[:, vox2point]}
        else:
            results[scene['name']] = {'conf': rep_scores, 'label_id': labels,
                                      'mask': masks,
                                      'cluster_representatives': reps,
                                      'cluster_heatmaps': vox_heatmaps,
                                      'bbs': rep_bbs, 'pred_fg': scene_fg}
    return results
