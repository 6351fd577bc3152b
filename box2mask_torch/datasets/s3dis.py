"""S3DIS reader: preprocessed ``.normals.instance.npy`` rooms + learned
superpoints (the port's copy of box2mask_tpu/datasets/s3dis.py).

Behavior-parity with dataprocessing/s3dis.py of the reference: fold-based
train/val split by ``Area_<fold>`` prefix, recentering (mean-xy / min-z),
augmentations in the same order (rotation/scale/90deg/x-y flips, elastic x2
variants, jitter, HAIS affine; color suite), learned-superpoint segmentation
npys from ``segment_labels/learned_superpoint_graph_segmentations``, point
subsampling (deterministic ``[::4]`` at eval, random rate at train), and the
small-segment refinement / majority-vote helpers.
"""

from __future__ import annotations

import glob
import os

import numpy as np
from scipy.spatial import cKDTree

from box2mask_torch.datasets import augmentation as aug
from box2mask_torch.datasets.scannet import (compute_avg_centers,
                                             compute_bounding_box)
from box2mask_torch.datasets.voxelize import segment_mode


def get_scene_names(mode, cfg):
    paths = glob.glob(os.path.join(cfg.data_dir, 'Area_*/*.npy'))
    names = [p.split('/')[-2] + '.' + p.split('/')[-1].split('.')[0]
             for p in paths]
    prefix = f'Area_{cfg.s3dis_split_fold}'
    if mode == 'train':
        names = [n for n in names if prefix not in n]
    elif mode == 'val':
        names = [n for n in names if prefix in n]
    return sorted(names)


def refine_segments(segments, counts, positions, min_verts=20):
    """Merge sub-min_verts segments into the nearest large segment
    (reference s3dis.py:65-77)."""
    seg_count = counts[segments]
    large = seg_count > min_verts
    small = ~large
    if small.any() and large.any():
        tree = cKDTree(positions[large])
        _, nn = tree.query(positions[small], k=1)
        segments = segments.copy()
        segments[small] = segments[large][nn]
    return segments


def seg2label(segments, label_ids):
    """Majority-vote label per segment (reference s3dis.py:150-164)."""
    uniq = np.unique(segments)
    lut = np.zeros(int(uniq.max()) + 1, np.int32)
    rows = np.searchsorted(uniq, segments)
    modes = segment_mode(label_ids, rows, len(uniq))
    lut[uniq] = modes
    return lut[segments], lut


def read_scene_from_numpy(scene_name, cfg, do_augmentations=False,
                          rng=np.random):
    area, room = scene_name.split('.', 1)
    npy_path = os.path.join(cfg.data_dir, area, room + '.normals.instance.npy')
    data = np.load(npy_path)
    positions = data[:, :3].astype(np.float64)
    colors = data[:, 3:6].astype(np.float64) / 255.0
    normals = data[:, 6:9].astype(np.float64)
    semantics = data[:, -2].astype(np.int32)
    instances = data[:, -1].astype(np.int32)

    positions = positions - positions.mean(0)
    positions[:, 2] -= positions[:, 2].min()

    if cfg.augmentation and do_augmentations:
        if rng.rand() < cfg.rotation_aug[0]:
            R = None
            center = positions.mean(0)
            rz = rng.uniform(0, 2 * np.pi)
            rx = rng.uniform(-np.pi / 100, np.pi / 100)
            ry = rng.uniform(-np.pi / 100, np.pi / 100)
            R = aug.rotation_matrix_xyz(rx, ry, rz)
            positions = (positions - center) @ R.T + center
            normals = normals @ R.T
        if rng.rand() < cfg.scaling_aug[0]:
            positions = aug.scale_points(positions, cfg.scaling_aug[1],
                                         cfg.scaling_aug[2], rng=rng)
        if cfg.rotation_90_aug:
            positions = aug.rotate_points_90(positions, rng=rng)
        if rng.rand() < cfg.flipping_aug:
            positions = aug.flip_x(positions)
        if rng.rand() < cfg.flipping_aug:
            positions = positions.copy()
            positions[:, 1] *= -1
        if rng.rand() < cfg.elastic_distortion:
            for granularity, magnitude in aug.SCANNET_ELASTIC_DISTORT_PARAMS:
                positions = aug.elastic_distortion(positions, granularity,
                                                   magnitude, rng=rng)
        if rng.rand() < cfg.elastic_distortion_HAIS:
            positions = positions - positions.mean(0)
            positions = aug.hais_elastic(positions,
                                         6 * (1 / cfg.voxel_size) // 50,
                                         40 * (1 / cfg.voxel_size) / 50,
                                         rng=rng)
            positions = aug.hais_elastic(positions,
                                         20 * (1 / cfg.voxel_size) // 50,
                                         160 * (1 / cfg.voxel_size) / 50,
                                         rng=rng)
            positions = positions - positions.mean(0)
            positions[:, 2] -= positions[:, 2].min()
        if rng.rand() < cfg.position_jittering[0]:
            positions = aug.position_jitter(positions,
                                            cfg.position_jittering[1], rng=rng)
        if cfg.HAIS_jitter_aug:
            positions = aug.hais_jitter(positions, rng=rng)
            positions[:, 2] -= positions[:, 2].min()

        if rng.rand() < cfg.chromatic_auto_contrast:
            colors = aug.chromatic_auto_contrast(colors, rng=rng)
        if rng.rand() < cfg.chromatic_translation[0]:
            colors = aug.chromatic_translation(colors,
                                               cfg.chromatic_translation[1],
                                               rng=rng)
        if rng.rand() < cfg.color_jittering_aug[0]:
            colors = aug.color_jittering(colors, -cfg.color_jittering_aug[1],
                                         cfg.color_jittering_aug[1], rng=rng)
        if rng.rand() < cfg.random_brightness[0]:
            colors = aug.random_brightness(colors, cfg.random_brightness[1],
                                           rng=rng)
        if cfg.apply_hue_aug:
            colors = aug.apply_hue_aug(colors, rng=rng)

    # learned-superpoint oversegmentation + its label/instance LUTs
    seg_dir = os.path.join(cfg.data_dir, 'segment_labels',
                           'learned_superpoint_graph_segmentations')
    info = np.load(os.path.join(seg_dir, scene_name + '.npy'),
                   allow_pickle=True).item()
    segments = info['segments']
    per_point_segment_instanceID = info['per_point_segment_instanceID']
    per_point_segment_semanticID = info['per_point_segment_semanticID']
    seg2instanceID = info['seg2instanceID']
    seg2semanticID = info['seg2semanticID']

    if cfg.point_sampling_rate is not None:
        n = len(positions)
        if not do_augmentations:
            ids = np.arange(n)[::4]            # deterministic eval subsample
        else:
            ids = rng.choice(n, int(n * cfg.point_sampling_rate),
                             replace=False)
        mask = np.zeros(n, bool)
        mask[ids] = True
        segments = segments[mask]
        per_point_segment_semanticID = per_point_segment_semanticID[mask]
        per_point_segment_instanceID = per_point_segment_instanceID[mask]
        positions, colors, normals = (positions[mask], colors[mask],
                                      normals[mask])
        instances, semantics = instances[mask], semantics[mask]

    scene = {'name': scene_name, 'positions': positions, 'colors': colors,
             'normals': normals, 'segments': segments}
    labels = {'instances': instances, 'semantics': semantics,
              'per_point_segment_instanceID': per_point_segment_instanceID,
              'per_point_segment_semanticID': per_point_segment_semanticID,
              'seg2instanceID': seg2instanceID,
              'seg2semanticID': seg2semanticID}
    return scene, labels


def process_scene(scene_name, mode, cfg, do_augmentations=False,
                  rng=np.random):
    scene, labels = read_scene_from_numpy(scene_name, cfg,
                                          do_augmentations=do_augmentations,
                                          rng=rng)
    centers, center_distances = compute_avg_centers(scene['positions'],
                                                    labels['instances'])
    (bb_centers, bb_offsets, bb_bounds, bb_dist, bb_radius, unique_instances,
     per_instance_semantics, per_instance_bb_centers, per_instance_bb_bounds,
     per_instance_bb_radius) = compute_bounding_box(
        scene['positions'], labels['instances'], labels['semantics'])
    assert np.array_equal(unique_instances, np.arange(len(unique_instances)))

    labels.update({
        'centers': centers, 'center_distances': center_distances,
        'bb_centers': bb_centers, 'bb_offsets': bb_offsets,
        'bb_bounds': bb_bounds, 'bb_center_distances': bb_dist,
        'bb_radius': bb_radius, 'unique_instances': unique_instances,
        'per_instance_semantics': per_instance_semantics,
        'per_instance_bb_centers': per_instance_bb_centers,
        'per_instance_bb_bounds': per_instance_bb_bounds,
        'per_instance_bb_radius': per_instance_bb_radius,
        'seg2inst': labels['seg2instanceID']})
    return scene, labels
