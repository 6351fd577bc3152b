"""ScanNet v2 instance-segmentation AP metric (official benchmark protocol).

Protocol-parity with the public ScanNet benchmark script, which the reference
adapted (utils/eval_metric.py:1-473): 18 instance classes, overlaps
0.50:0.05:0.95 plus 0.25, min region 100 vertices, GT id encoding
``semantic_id * 1000 + instance_id`` (utils/gt2eval.py:15), greedy
confidence-ranked matching with void/group ignore handling, and step-integrated
PR curves.

Implementation is our own: per-scene intersections are computed with a single
bincount over (gt_id, pred_mask) pairs instead of per-instance count_nonzero
loops, and the PR integration is vectorized.

The port's copy of box2mask_tpu/metrics/scannet_ap.py (NumPy), with the class
tables of the port's datasets/tables.py.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from box2mask_torch.datasets import tables

CLASS_LABELS = tables.SCANNET_INSTANCE_CLASS_LABELS
VALID_CLASS_IDS = tables.SCANNET_INSTANCE_VALID_CLASS_IDS
ID_TO_LABEL = {int(i): n for i, n in zip(VALID_CLASS_IDS, CLASS_LABELS)}
OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


def encode_gt_ids(semantics, instances):
    """Per-point gt id = semantic*1000 + instance (gt2eval.py encoding)."""
    return np.asarray(instances) + 1000 * np.asarray(semantics)


def _gt_instance_records(gt_ids):
    """{label_name: [record]} for every instance id with a valid class."""
    out = {n: [] for n in CLASS_LABELS}
    uniq, counts = np.unique(gt_ids, return_counts=True)
    for iid, cnt in zip(uniq, counts):
        if iid == 0:
            continue
        label_id = int(iid) // 1000
        if label_id in ID_TO_LABEL:
            out[ID_TO_LABEL[label_id]].append({
                'instance_id': int(iid), 'label_id': label_id,
                'vert_count': int(cnt), 'matched_pred': []})
    return out


def assign_scene(scene_name, pred, gt_ids):
    """Cross-link predictions and gt instances of one scene.

    pred: {'conf': (M,), 'label_id': (M,), 'mask': (M, N)} — reference result
    format (models/detection_net.py:473-477).
    """
    gt2pred = _gt_instance_records(gt_ids)
    pred2gt = {n: [] for n in CLASS_LABELS}
    void = ~np.isin(gt_ids // 1000, VALID_CLASS_IDS)
    n_pred = 0
    for i in range(len(pred['label_id'])):
        label_id = int(pred['label_id'][i])
        if label_id not in ID_TO_LABEL:
            continue
        label_name = ID_TO_LABEL[label_id]
        mask = np.asarray(pred['mask'][i]) != 0
        if len(mask) != len(gt_ids):
            raise ValueError(
                f'{scene_name}: pred mask has {len(mask)} entries, gt {len(gt_ids)}')
        vert_count = int(mask.sum())
        if vert_count < MIN_REGION_SIZE:
            continue
        rec = {'uid': f'{scene_name}_{n_pred:03d}', 'pred_id': n_pred,
               'label_id': label_id, 'vert_count': vert_count,
               'confidence': float(pred['conf'][i]),
               'void_intersection': int(np.count_nonzero(void & mask)),
               'matched_gt': []}
        # one pass: intersection with every gt instance of the same class
        ids_in_mask = gt_ids[mask]
        uniq, counts = np.unique(ids_in_mask, return_counts=True)
        inter = dict(zip(uniq.tolist(), counts.tolist()))
        for gt in gt2pred[label_name]:
            isect = inter.get(gt['instance_id'], 0)
            if isect > 0:
                gt_copy = {k: v for k, v in gt.items() if k != 'matched_pred'}
                gt_copy['intersection'] = isect
                p_copy = {k: v for k, v in rec.items() if k != 'matched_gt'}
                p_copy['intersection'] = isect
                rec['matched_gt'].append(gt_copy)
                gt['matched_pred'].append(p_copy)
        n_pred += 1
        pred2gt[label_name].append(rec)
    return gt2pred, pred2gt


def _pr_from_scores(y_true, y_score, hard_fns):
    """Official step-integrated AP from (tp/fp, score) pairs + hard FNs."""
    order = np.argsort(y_score)
    ys, yt = y_score[order], y_true[order]
    cum = np.cumsum(yt)
    thresholds, first_idx = np.unique(ys, return_index=True)
    n = len(ys)
    n_true = cum[-1] if n else 0
    n_pr = len(first_idx) + 1
    precision = np.zeros(n_pr)
    recall = np.zeros(n_pr)
    cum_ext = np.append(cum, 0)
    for out_i, i in enumerate(first_idx):
        below = cum_ext[i - 1]  # true positives with score < threshold
        tp = n_true - below
        fp = n - i - tp
        fn = below + hard_fns
        precision[out_i] = tp / (tp + fp)
        recall[out_i] = tp / (tp + fn)
    precision[-1], recall[-1] = 1.0, 0.0
    r = np.concatenate([[recall[0]], recall, [0.0]])
    step = np.convolve(r, [-0.5, 0, 0.5], 'valid')
    return float(np.dot(precision, step)), precision, recall


def evaluate_matches(matches):
    """matches: {scene: {'gt': gt2pred, 'pred': pred2gt}} -> ap (C, O) array."""
    ap = np.zeros((len(CLASS_LABELS), len(OVERLAPS)))
    pr_curves = defaultdict(dict)
    for oi, overlap_th in enumerate(OVERLAPS):
        visited = {}
        for m in matches.values():
            for lst in m['pred'].values():
                for p in lst:
                    visited[p['uid']] = False
        for li, label_name in enumerate(CLASS_LABELS):
            y_true, y_score = [], []
            hard_fns = 0
            has_gt = has_pred = False
            for m in matches.values():
                preds = m['pred'][label_name]
                gts = [g for g in m['gt'][label_name]
                       if g['instance_id'] >= 1000
                       and g['vert_count'] >= MIN_REGION_SIZE]
                has_gt |= bool(gts)
                has_pred |= bool(preds)
                cur_true, cur_score, cur_match = [], [], []
                for gt in gts:
                    found = False
                    gi = len(cur_true)
                    cur_true.append(1.0)
                    cur_score.append(-np.inf)
                    cur_match.append(False)
                    for p in gt['matched_pred']:
                        if visited[p['uid']]:
                            continue
                        ov = p['intersection'] / (
                            gt['vert_count'] + p['vert_count'] - p['intersection'])
                        if ov > overlap_th:
                            conf = p['confidence']
                            if cur_match[gi]:
                                # duplicate match: lower-scored one is a FP
                                lo, hi = sorted([cur_score[gi], conf])
                                cur_score[gi] = hi
                                cur_true.append(0.0)
                                cur_score.append(lo)
                                cur_match.append(True)
                            else:
                                found = True
                                cur_match[gi] = True
                                cur_score[gi] = conf
                                visited[p['uid']] = True
                    if not found:
                        hard_fns += 1
                for t, s, mt in zip(cur_true, cur_score, cur_match):
                    if mt:
                        y_true.append(t)
                        y_score.append(s)
                # unmatched predictions are FPs unless mostly void/ignored
                for p in preds:
                    found_gt = any(
                        g['intersection'] / (g['vert_count'] + p['vert_count']
                                             - g['intersection']) > overlap_th
                        for g in p['matched_gt'])
                    if not found_gt:
                        n_ignore = p['void_intersection']
                        for g in p['matched_gt']:
                            if g['instance_id'] < 1000:
                                n_ignore += g['intersection']
                            if g['vert_count'] < MIN_REGION_SIZE:
                                n_ignore += g['intersection']
                        if n_ignore / p['vert_count'] <= overlap_th:
                            y_true.append(0.0)
                            y_score.append(p['confidence'])
            if has_gt and has_pred:
                cur_ap, prec, rec = _pr_from_scores(
                    np.array(y_true), np.array(y_score), hard_fns)
                pr_curves[overlap_th][label_name] = (prec, rec)
            elif has_gt:
                cur_ap = 0.0
            else:
                cur_ap = np.nan
            ap[li, oi] = cur_ap
    return ap, pr_curves


def compute_averages(ap):
    o50 = np.isclose(OVERLAPS, 0.5)
    o25 = np.isclose(OVERLAPS, 0.25)
    not25 = ~o25
    avgs = {
        'all_ap': float(np.nanmean(ap[:, not25])),
        'all_ap_50%': float(np.nanmean(ap[:, o50])),
        'all_ap_25%': float(np.nanmean(ap[:, o25])),
        'classes': {},
    }
    for li, name in enumerate(CLASS_LABELS):
        avgs['classes'][name] = {
            'ap': float(np.average(ap[li, not25])),
            'ap50%': float(np.average(ap[li, o50])),
            'ap25%': float(np.average(ap[li, o25])),
        }
    return avgs


def evaluate_scannet(results, gt_ids_per_scene):
    """One-call evaluation: results {scene: pred_info}, gt ids per scene."""
    assert sorted(results.keys()) == sorted(gt_ids_per_scene.keys()), \
        'prediction/gt key sets differ (reference asserts split equality)'
    matches = {}
    for scene_name, pred in results.items():
        gt2pred, pred2gt = assign_scene(scene_name, pred,
                                        np.asarray(gt_ids_per_scene[scene_name]))
        matches[scene_name] = {'gt': gt2pred, 'pred': pred2gt}
    ap, pr_curves = evaluate_matches(matches)
    return compute_averages(ap), ap, pr_curves


def format_results_table(avgs):
    """Human-readable AP table (reference writes table.txt, eval_metric.py:348+)."""
    lines = [f"{'class':>16} {'AP':>8} {'AP50':>8} {'AP25':>8}"]
    for name in CLASS_LABELS:
        c = avgs['classes'][name]
        lines.append(f"{name:>16} {c['ap']:8.3f} {c['ap50%']:8.3f} {c['ap25%']:8.3f}")
    lines.append(f"{'average':>16} {avgs['all_ap']:8.3f} "
                 f"{avgs['all_ap_50%']:8.3f} {avgs['all_ap_25%']:8.3f}")
    return '\n'.join(lines)
