"""The numbers that decide `correct`, each computed from what the program
produced and what the reference produced, and the limits they are held to
(`limits/<workload>.json`, found by the cell's name).

Inference:
  head_gap   over the four heads, the largest |program - reference| over
             the segments of the checked batches, as a share of that
             head's largest |reference|;
  mask_miss  the share of masks (program's and reference post-processing's
             of the program's heads) left without a partner: same class,
             confidence within CONF_TOL, point IoU at least MASK_IOU.
Training (the first three steps of the window's own call and feed):
  head_gap   head_gap of the first step's train-mode heads;
  loss_gap   the first step's optimisation loss, relative gap;
  loss3_gap  the largest relative gap of the three steps' losses;
  grad_gap   the first step's gradient as the optimiser got it (Adam's first
             moment after one step over 1 - b1), by the worst leaf: the gap
             between the two norms of a leaf, over the larger of the
             reference's norm of that leaf and of the median leaf;
  grad_gap_median  the median leaf's gap of the same;
  grad_diff_median the median leaf's norm of the difference of the two
             gradients (which sees a gradient that points elsewhere, where
             the norms agree), over the same scale;
  out_grad_diff the same difference by the worst leaf of the heads' output
             layers (reference/net.output_leaves): the loss and its mean
             over the batch reach them directly, the bf16 rounding of the
             layers below only through their inputs;
  change_gap grad_gap of the parameters' change over the three steps.
Leaves whose reference gradient is under LEAF_FLOOR of the median leaf's
move by round-off alone under Adam and are not counted. Every number is
printed with each run; the cell's limits file names those that decide
`correct` (the readings they were set from beside them).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

CONF_TOL = 1e-5
MASK_IOU = 0.9
LEAF_FLOOR = 1e-3


def load_limits(root, workload):
    with open(os.path.join(root, 'h100bench', 'limits',
                           f'{workload}.json')) as f:
        return json.load(f)['limits']


def head_gap(port, ref):
    """port, ref: {head: (rows, d) arrays} over the same segments."""
    gap = 0.0
    for h, r in ref.items():
        p = np.asarray(port[h], np.float64)
        r = np.asarray(r, np.float64)
        if p.shape != r.shape or not np.isfinite(p).all():
            return float('inf')
        gap = max(gap, float(np.abs(p - r).max() / max(np.abs(r).max(),
                                                       1e-30)))
    return gap


def mask_miss(port, ref):
    """(misses, masks) over one scene's results {conf, label_id, mask}."""
    pc, rc = np.asarray(port['conf']), np.asarray(ref['conf'])
    n_p, n_r = len(pc), len(rc)
    if not n_p or not n_r:
        return n_p + n_r, n_p + n_r
    pm = np.asarray(port['mask'], np.float32)
    rm = np.asarray(ref['mask'], np.float32)
    if pm.shape[1] != rm.shape[1]:
        return n_p + n_r, n_p + n_r
    inter = rm @ pm.T
    union = rm.sum(1)[:, None] + pm.sum(1)[None, :] - inter
    iou = np.where(union > 0, inter / np.maximum(union, 1), 1.0)
    ok = ((np.abs(rc[:, None] - pc[None, :]) <= CONF_TOL)
          & (np.asarray(ref['label_id'])[:, None]
             == np.asarray(port['label_id'])[None, :])
          & (iou >= MASK_IOU))
    used = np.zeros(n_p, bool)
    matched = 0
    for i in range(n_r):
        cand = np.nonzero(ok[i] & ~used)[0]
        if len(cand):
            used[cand[np.argmax(iou[i, cand])]] = True
            matched += 1
    return n_p + n_r - 2 * matched, n_p + n_r


def counted_leaves(ref_grad_norms):
    med = float(np.median(list(ref_grad_norms.values())))
    return [k for k, v in ref_grad_norms.items() if v >= LEAF_FLOOR * med]


def norms(tensors):
    """{leaf: its L2 norm} of {leaf: tensor}."""
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def leaf_scale(ref_norms, leaves):
    """{leaf: the larger of the reference's norm of the leaf and of the
    median leaf} over `leaves`: what a leaf's gap is measured against."""
    med = float(np.median([ref_norms[k] for k in leaves]))
    return {k: max(ref_norms[k], med, 1e-30) for k in leaves}


def norm_gaps(port_norms, ref_norms, scale):
    """Per leaf of `scale`: |port norm - ref norm| / its scale."""
    return {k: (abs(port_norms[k] - ref_norms[k]) / sc
                if np.isfinite(port_norms[k]) else float('inf'))
            for k, sc in scale.items()}


def diff_gaps(port, ref, scale):
    """Per leaf of `scale`: |port - ref| (the norm of the difference, which
    sees a change of direction) / its scale."""
    out = {}
    for k, sc in scale.items():
        if port[k].shape != ref[k].shape:
            out[k] = float('inf')
            continue
        d = float(torch.linalg.vector_norm(port[k].double() - ref[k].double()))
        out[k] = d / sc if np.isfinite(d) else float('inf')
    return out


def worst(gaps):
    """(the largest per-leaf gap, its leaf)."""
    at = max(gaps, key=lambda k: gaps[k])
    return gaps[at], at


def median(gaps):
    return float(np.median(list(gaps.values())))


def loss_gap(port, ref):
    if len(port) != len(ref):
        return float('inf')
    return max(abs(p - r) / max(abs(r), 1e-30) if np.isfinite(p)
               else float('inf') for p, r in zip(port, ref))


def verdict(numbers, limits):
    """numbers {name: value}; limits {name: limit}. Returns (correct,
    [{name, value, limit}]) with every limited number."""
    rows = [{'name': k, 'value': numbers.get(k, float('inf')),
             'limit': v} for k, v in limits.items()]
    ok = all(np.isfinite(r['value']) and r['value'] <= r['limit']
             for r in rows)
    return ok, rows
