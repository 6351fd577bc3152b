"""Weak-label association: GT bounding boxes -> per-point / per-oversegment pseudo
instance labels, fully vectorized (the port's copy of the ScanNet part of
box2mask_tpu/datasets/association.py:1-166; ARKitScenes and S3DIS wait,
ROADMAP A15).

Behavior-parity with the reference's approx_association logic, which is a Python
loop over segments (models/dataloader.py:203-314 ScanNet, :539-621 ARKitScenes,
:805-927 S3DIS). Label algebra (models/dataloader.py:241): instance id -1 =
background, -2 = unknown/undecided, >=0 = instance.

Rules (ScanNet / segment pooling, models/dataloader.py:274-312):
  * if any point of a segment lies in no box -> whole segment is background (-1),
  * elif some point lies in exactly one box -> assign that (first such point's) box,
  * else undecided (-2); with --smallest_bb_heuristic the smallest-volume box
    containing the segment's min-count point is assigned instead.

Vectorization notes: per-segment min / first-occurrence reductions are
np.minimum.at scatters; majority votes are bincount modes (datasets/voxelize.py
segment_mode, tie -> smallest id, same as scipy.stats.mode).
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.datasets import tables
from box2mask_torch.datasets.voxelize import segment_mode

BG = -1       # pseudo background
UNKNOWN = -2  # undecided / multi-box


def scene_seed(name):
    """Deterministic per-scene RNG seed (reference models/dataloader.py:214,228)."""
    try:
        return abs(int(str(name).replace('_', ''), 36)) % (2 ** 63)
    except ValueError:
        return abs(hash(str(name))) % (2 ** 63)


def aabb_occupancy(points, min_corner, max_corner):
    """(B, P) bool: point inside axis-aligned box."""
    inside = (points[None, :, :] >= min_corner[:, None, :]) & \
             (points[None, :, :] <= max_corner[:, None, :])
    return inside.all(axis=2)


def _per_point_from_occupancy(occ, instance_ids, bb_volume, smallest_bb):
    """Point-level association: single box -> that box; multiple -> UNKNOWN or the
    smallest containing box; none -> BG."""
    num = occ.sum(axis=0)
    first = occ.argmax(axis=0)
    inst = np.full(occ.shape[1], BG, np.int64)
    single = num == 1
    inst[single] = instance_ids[first[single]]
    multi = num > 1
    if smallest_bb:
        masked_vol = np.where(occ, bb_volume[:, None], np.inf)
        best = masked_vol.argmin(axis=0)
        inst[multi] = instance_ids[best[multi]]
    else:
        inst[multi] = UNKNOWN
    return inst, num, first


def _segment_rows(unique_segs, point_segments):
    """Map each point to its row in unique_segs (-1 if its segment is absent —
    possible when voxelization dropped a whole segment)."""
    rows = np.searchsorted(unique_segs, point_segments)
    rows_c = np.minimum(rows, len(unique_segs) - 1)
    found = unique_segs[rows_c] == point_segments
    return np.where(found, rows_c, -1)


def _first_point_per_segment(seg_rows, candidates, num_segments):
    """Earliest point index per segment among candidate points, else -1."""
    out = np.full(num_segments, np.iinfo(np.int64).max, np.int64)
    idx = np.nonzero(candidates & (seg_rows >= 0))[0]
    np.minimum.at(out, seg_rows[idx], idx)
    return np.where(out == np.iinfo(np.int64).max, -1, out)


def associate_scannet(labels, scene, cfg, unique_segs):
    """ScanNet association incl. dropout/noisy-box robustness modes.
    Returns (inst_per_point, inst_per_seg or None)."""
    sem = labels['per_instance_semantics']
    scene_fg = tables.scannet_is_foreground(sem)

    if cfg.dropout_boxes:
        rng = np.random.default_rng(seed=scene_seed(scene['name']))
        keep = rng.binomial(1, 1 - cfg.dropout_boxes, scene_fg.sum()) != 0
        scene_fg[scene_fg.copy()] = keep

    centers = labels['per_instance_bb_centers'][scene_fg]
    bounds = labels['per_instance_bb_bounds'][scene_fg] + 0.005
    min_corner, max_corner = centers - bounds, centers + bounds
    instance_ids = labels['unique_instances'][scene_fg]

    noisy_bbs = None
    if cfg.noisy_boxes:
        rng = np.random.default_rng(seed=scene_seed(scene['name']))
        min_corner = min_corner + rng.normal(0, cfg.noisy_boxes / 2, min_corner.shape)
        max_corner = max_corner + rng.normal(0, cfg.noisy_boxes / 2, max_corner.shape)
        noisy_bbs = (min_corner, max_corner)

    occ = aabb_occupancy(scene['positions'], min_corner, max_corner)
    bb_volume = np.prod(2 * bounds, axis=1)
    num = occ.sum(axis=0)
    first = occ.argmax(axis=0)

    if cfg.point_association or cfg.majority_vote:
        inst_pp, _, _ = _per_point_from_occupancy(
            occ, instance_ids, bb_volume, cfg.smallest_bb_heuristic)
        if cfg.point_association:
            return inst_pp, None, noisy_bbs
        # majority vote over each voxel-segment's points
        S = len(unique_segs)
        seg_rows = _segment_rows(unique_segs, scene['segments'])
        ok = seg_rows >= 0
        inst_ps = np.full(S, UNKNOWN, np.int64)
        have = np.unique(seg_rows[ok])
        mode = segment_mode(inst_pp[ok], seg_rows[ok], S)
        inst_ps[have] = mode[have]
        inst_pp_pooled = np.full(len(scene['positions']), UNKNOWN, np.int64)
        inst_pp_pooled[ok] = inst_ps[seg_rows[ok]]
        return inst_pp_pooled, inst_ps, noisy_bbs

    # segment-pooled rule
    S = len(unique_segs)
    seg_rows = _segment_rows(unique_segs, scene['segments'])
    ok = seg_rows >= 0
    seg_min = np.full(S, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(seg_min, seg_rows[ok], num[ok])
    seg_min = np.where(seg_min == np.iinfo(np.int64).max, UNKNOWN, seg_min)

    inst_ps = np.full(S, UNKNOWN, np.int64)
    inst_ps[seg_min == 0] = BG
    one = seg_min == 1
    first_pt = _first_point_per_segment(seg_rows, num == 1, S)
    sel = one & (first_pt >= 0)
    inst_ps[sel] = instance_ids[first[first_pt[sel]]]

    if cfg.smallest_bb_heuristic:
        undecided = (inst_ps == UNKNOWN) & (seg_min >= 2)
        # first point achieving the per-segment min count
        cand = num == seg_min[np.where(seg_rows >= 0, seg_rows, 0)]
        cand &= seg_rows >= 0
        pt = _first_point_per_segment(seg_rows, cand, S)
        masked_vol = np.where(occ, bb_volume[:, None], np.inf)
        best = masked_vol.argmin(axis=0)
        sel = undecided & (pt >= 0)
        inst_ps[sel] = instance_ids[best[pt[sel]]]

    inst_pp = np.full(len(scene['positions']), UNKNOWN, np.int64)
    inst_pp[ok] = inst_ps[seg_rows[ok]]
    return inst_pp, inst_ps, noisy_bbs
