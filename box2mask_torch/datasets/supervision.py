"""Supervision: turn (voxelized scene, labels) into per-segment GT arrays
(the port's copy of box2mask_tpu/datasets/supervision.py; the ARKitScenes and
S3DIS box-supervision branches wait, ROADMAP A15).

Behavior-parity with the Dataset.{mask,bbs}_supervision methods of the reference
(models/dataloader.py:138-201 ScanNet, :472-537 ARKitScenes, :740-803 S3DIS).
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.datasets import association as assoc
from box2mask_torch.datasets import tables


def mask_supervision(ret, labels, cfg, dataset_name):
    """Full (mask-level) supervision path."""
    point2vox = ret['point2vox']
    ret['vox_instances'] = labels['seg2inst'][ret['vox_segments']]
    if not cfg.do_segment_pooling:
        ret['gt_semantics'] = labels['semantics'][point2vox]
        ret['gt_bb_bounds'] = labels['bb_bounds'][point2vox]
        gt_bb_centers = labels['bb_centers'][point2vox]
        ret['instance_ids'] = ret['vox_instances']
    else:
        seg_inst = labels['seg2inst'][ret['unique_vox_segments']]
        ret['gt_bb_bounds'] = labels['per_instance_bb_bounds'][seg_inst]
        ret['gt_semantics'] = labels['per_instance_semantics'][seg_inst]
        gt_bb_centers = labels['per_instance_bb_centers'][seg_inst]
        ret['instance_ids'] = seg_inst
        if dataset_name == 's3dis':
            ret['gt_per_vox_semantics'] = labels['semantics'][point2vox]
    ret['gt_bb_offsets'] = gt_bb_centers - ret['input_location']

    sem = ret['gt_semantics']
    if dataset_name == 'scannet':
        ret['fg_instances'] = tables.scannet_is_foreground(sem)
    elif dataset_name == 'arkitscenes':
        ret['fg_instances'] = tables.arkitscenes_is_foreground(sem)
    else:
        ret['fg_instances'] = tables.s3dis_foreground_mask(sem, cfg)
    return ret


def _gather_instance_gt(ret, labels, instances):
    """Common box-GT gather for fg instances (reference dataloader.py:181-188)."""
    fg = instances > -1
    ret['fg_instances'] = fg
    gt_bb_bounds = np.zeros((len(fg), 3), np.float32)
    gt_bb_bounds[fg] = labels['per_instance_bb_bounds'][instances[fg]]
    ret['gt_bb_bounds'] = gt_bb_bounds
    gt_bb_centers = np.zeros((len(fg), 3), np.float32)
    gt_bb_centers[fg] = labels['per_instance_bb_centers'][instances[fg]]
    # bg/unknown rows: offset target is 0 (location zeroed by fg multiply)
    ret['gt_bb_offsets'] = gt_bb_centers - ret['input_location'] * fg[:, None]
    return fg


def bbs_supervision_scannet(ret, labels, scene, cfg):
    unique_segs = ret.get('unique_vox_segments')
    if unique_segs is None and not cfg.point_association:
        unique_segs = np.unique(ret['vox_segments'])
    inst_pp, inst_ps, noisy = assoc.associate_scannet(labels, scene, cfg, unique_segs)
    ret['pseudo_inst'] = (inst_pp, inst_ps)
    if noisy is not None:
        ret['noisy_bbs'] = noisy
    if not cfg.do_segment_pooling:
        instances = inst_pp[ret['point2vox']]
        gt_full_sem = labels['semantics'][ret['point2vox']]
    else:
        assert inst_ps is not None, 'point_association incompatible with pooling'
        instances = inst_ps
        seg_inst = labels['seg2inst'][unique_segs]
        gt_full_sem = labels['per_instance_semantics'][seg_inst]

    gt_unlabeled = gt_full_sem == 0   # ScanNet missing annotations
    fg = _gather_instance_gt(ret, labels, instances)
    gt_semantics = np.zeros(len(fg), np.int64)
    gt_semantics[fg] = labels['per_instance_semantics'][instances[fg]]
    gt_semantics[instances == assoc.BG] = 2     # pseudo-background -> floor
    gt_semantics[gt_unlabeled] = 0              # unlabeled stays ignore-class 0
    ret['gt_semantics'] = gt_semantics
    return ret


def build_supervision(ret, labels, scene, cfg, dataset_name, mode='train'):
    if cfg.bb_supervision and (dataset_name != 's3dis' or mode == 'train'):
        if dataset_name == 'scannet':
            return bbs_supervision_scannet(ret, labels, scene, cfg)
        raise NotImplementedError(
            f'box supervision for {dataset_name} is not ported yet '
            '(ROADMAP A15)')
    return mask_supervision(ret, labels, cfg, dataset_name)
