"""Box-supervision targets of one ScanNet-style scene, per oversegment
(Box2Mask's weak association, segment-pooled, with the smallest-box rule).

Boxes are the foreground instances' axis-aligned boxes grown by 5 mm. For
each point, count the boxes that hold it. A segment with a point in no box
is background; else, if some point lies in exactly one box, the segment
takes that box (the first such point's); else the first point with the
segment's least count picks the smallest box holding it. Foreground
segments regress to their box: offset = box centre - segment location,
bounds = the box's half-size. Semantics: the box's class; background ->
class 2 (floor); a segment whose own annotated instance is unlabelled
(class 0) -> 0; class ids map to indices over the valid ids, others to
the ignore label -100.
"""

from __future__ import annotations

import numpy as np

IGNORE = -100
GROW = 0.005


def is_foreground(sem, rule):
    sem = np.asarray(sem)
    if rule == 'sem>2,sem!=22':
        return (sem > 2) & (sem != 22)
    if rule == 'sem>2':
        return sem > 2
    raise ValueError(f'unknown foreground rule {rule!r}')


def scene_targets(scene, labels, vox, valid_ids, fg_rule):
    """vox: reference/voxel.py's dict for the scene. Returns fg (S,) bool,
    offsets, bounds (S, 3) f32, sem_idx (S,) int64."""
    sem_i = labels['per_instance_semantics']
    keep = is_foreground(sem_i, fg_rule)
    ids = labels['unique_instances'][keep]
    ctr = labels['per_instance_bb_centers'][keep]
    half = labels['per_instance_bb_bounds'][keep] + GROW
    lo, hi = ctr - half, ctr + half
    pos = scene['positions']
    inside = ((pos[None] >= lo[:, None]) & (pos[None] <= hi[:, None])).all(2)
    count = inside.sum(0)
    volume = np.prod(2 * half, axis=1)

    segs = vox['segments']
    row_of = {s: i for i, s in enumerate(segs.tolist())}
    point_row = np.array([row_of.get(s, -1) for s in
                          np.asarray(scene['segments']).tolist()])
    S = len(segs)
    inst = np.full(S, -2, np.int64)
    order = np.argsort(point_row, kind='stable')
    bounds_at = np.searchsorted(point_row[order], np.arange(S + 1))
    for r in range(S):
        pts = order[bounds_at[r]:bounds_at[r + 1]]      # ascending indices
        if not len(pts):
            continue
        c = count[pts]
        if c.min() == 0:
            inst[r] = -1
        elif (c == 1).any():
            p = pts[np.argmax(c == 1)]
            inst[r] = ids[np.argmax(inside[:, p])]
        else:
            p = pts[np.argmax(c == c.min())]
            inst[r] = ids[np.argmin(np.where(inside[:, p], volume, np.inf))]

    fg = inst > -1
    offsets = np.zeros((S, 3), np.float32)
    bounds = np.zeros((S, 3), np.float32)
    c_all = labels['per_instance_bb_centers']
    b_all = labels['per_instance_bb_bounds']
    offsets[fg] = c_all[inst[fg]]
    bounds[fg] = b_all[inst[fg]]
    offsets = offsets - vox['seg_loc'] * fg[:, None]
    sem = np.zeros(S, np.int64)
    sem[fg] = sem_i[inst[fg]]
    sem[inst == -1] = 2
    own = sem_i[labels['seg2inst'][segs]]
    sem[own == 0] = 0
    idx = np.full(S, IGNORE, np.int64)
    valid_ids = np.asarray(valid_ids)
    for i, v in enumerate(valid_ids):
        idx[sem == v] = i
    return {'fg': fg, 'offsets': offsets.astype(np.float32),
            'bounds': bounds, 'sem_idx': idx}
