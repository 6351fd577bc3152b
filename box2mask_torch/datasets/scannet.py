"""ScanNet v2 scene reader + GT derivation + augmentation application (the
port's copy of box2mask_tpu/datasets/scannet.py).

Behavior-parity with dataprocessing/scannet.py of the reference: same file
layout (``scans/<scene>/<scene>_vh_clean_2.ply``, ``.aggregation.json``,
``_vh_clean_2.0.010000.segs.json``, axis-alignment from the scene txt), same
label semantics (TSV label map col raw-name -> nyu40 id, instance ids 1..K,
double-defined-instance fix via dense ranking), same augmentation order
(geometric on the mesh -> vertex normals -> color augs). GT derivation
(compute_avg_centers / compute_bounding_box) is vectorized with segment
reductions instead of per-instance Python loops.
"""

from __future__ import annotations

import csv
import json
import os

import numpy as np

from box2mask_torch.datasets import augmentation as aug
from box2mask_torch.datasets.ply import read_mesh, compute_vertex_normals


def read_axis_alignment(path_txt):
    with open(path_txt) as f:
        for line in f:
            if line.startswith('axisAlignment'):
                vals = [float(v) for v in line.split('=')[1].strip().split()]
                return np.array(vals).reshape(4, 4)
    raise ValueError(f'No axis alignment found in {path_txt}')


def _apply_transform(positions, Rt):
    return positions @ Rt[:3, :3].T + Rt[:3, 3]


def read_scene(path_ply, path_txt, cfg, align=False, do_augmentations=False,
               rotate_z=None, rng=np.random):
    """-> (positions, normals, colors) with augmentations applied.
    Geometric augs act on the mesh vertices BEFORE normal computation
    (reference scannet.py:162-217). `rng` is a per-scene RandomState stream
    (datasets/loader.py scene_rng) so parallel workers never race a global
    RNG — the analog of the reference's per-worker reseeding
    (models/dataloader.py:324-332)."""
    positions, colors, faces = read_mesh(path_ply)
    if align:
        positions = _apply_transform(positions, read_axis_alignment(path_txt))

    if do_augmentations and cfg.augmentation:
        if rng.rand() < cfg.rotation_aug[0]:
            positions = aug.rotate_points(positions,
                                          max_xy_angle=cfg.rotation_aug[1],
                                          individual_prob=cfg.rotation_aug[2],
                                          rng=rng)
        if cfg.rotation_90_aug:
            positions = aug.rotate_points_90(positions, rng=rng)
        if rng.rand() < cfg.flipping_aug:
            positions = aug.flip_x(positions)
        if cfg.HAIS_jitter_aug:
            positions = aug.hais_jitter(positions, rng=rng)
        if rng.rand() < cfg.elastic_distortion:
            for granularity, magnitude in aug.SCANNET_ELASTIC_DISTORT_PARAMS:
                positions = aug.elastic_distortion(positions, granularity,
                                                   magnitude, rng=rng)
        if rng.rand() < cfg.elastic_distortion_HAIS:
            positions = aug.hais_elastic(
                positions, 6 * (1 / cfg.voxel_size) // 50,
                40 * (1 / cfg.voxel_size) / 50, rng=rng)
            positions = aug.hais_elastic(
                positions, 20 * (1 / cfg.voxel_size) // 50,
                160 * (1 / cfg.voxel_size) / 50, rng=rng)
            positions = positions - positions.min(0)
        if rng.rand() < cfg.position_jittering[0]:
            positions = aug.position_jitter(positions,
                                            cfg.position_jittering[1], rng=rng)
        if rng.rand() < cfg.scaling_aug[0]:
            positions = aug.scale_points(positions, cfg.scaling_aug[1],
                                         cfg.scaling_aug[2], rng=rng)
    elif rotate_z:
        positions = aug.rotate_about_center(
            positions, aug.rotation_matrix_xyz(0, 0, rotate_z / 2))

    normals = (compute_vertex_normals(positions, faces) if faces is not None
               else np.zeros_like(positions))

    if colors is None:
        colors = np.zeros_like(positions)
    if do_augmentations and cfg.augmentation:
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
        if cfg.mix_3d_color_aug:
            colors = aug.apply_mix3d_color_aug(colors, rng=rng)
        if cfg.apply_hue_aug:
            colors = aug.apply_hue_aug(colors, rng=rng)
    return positions, normals, colors


def read_label_map(label_map_file):
    """raw-name -> nyu40-id strings from scannetv2-labels.combined.tsv."""
    label_map = {}
    with open(label_map_file) as f:
        for i, line in enumerate(csv.reader(f, delimiter='\t')):
            if i == 0:
                continue
            label_map[line[1]] = line[4] if len(line[4]) > 0 else '0'
    return label_map


def read_labels(label_map_file, path_aggregation, per_point_segment_ids):
    """-> (per-point semantics, per-point instances 0..K, seg2inst)."""
    label_map = read_label_map(label_map_file)
    with open(path_aggregation) as f:
        aggregation = json.load(f)

    n = len(per_point_segment_ids)
    semantics = np.zeros(n, np.int32)
    instances = np.zeros(n, np.int32)
    # vectorized: map segment id -> instance / semantic through a LUT
    max_seg = int(per_point_segment_ids.max()) + 1
    seg_inst = np.zeros(max_seg, np.int32)
    seg_sem = np.zeros(max_seg, np.int32)
    for instance_id, inst in enumerate(aggregation['segGroups']):
        sem_str = label_map.get(inst['label'], '-')
        sem_id = int(sem_str) if sem_str not in ('-', '') else 0
        segs = np.asarray(inst['segments'], np.int64)
        segs = segs[segs < max_seg]
        seg_inst[segs] = instance_id + 1
        seg_sem[segs] = sem_id
    semantics = seg_sem[per_point_segment_ids]
    instances = seg_inst[per_point_segment_ids]

    # fix double-defined instances (e.g. scene0217_00): dense re-rank
    uniq = np.unique(instances)
    if not np.array_equal(uniq, np.arange(len(uniq))):
        remap = np.zeros(uniq.max() + 1, np.int32)
        remap[uniq] = np.arange(len(uniq))
        instances = remap[instances]

    # seg -> instance map (every segment belongs to exactly one instance)
    unique_segs = np.unique(per_point_segment_ids)
    seg2inst = np.zeros(int(unique_segs.max()) + 1, np.int32)
    order = np.argsort(per_point_segment_ids, kind='stable')
    first_of_seg = order[np.unique(per_point_segment_ids[order],
                                   return_index=True)[1]]
    seg2inst[per_point_segment_ids[first_of_seg]] = instances[first_of_seg]
    return semantics, instances, seg2inst


def compute_avg_centers(positions, instance_labels):
    """Per-point instance mean centers (vectorized; reference scannet.py:304)."""
    uniq, inv = np.unique(instance_labels, return_inverse=True)
    K = len(uniq)
    cnt = np.bincount(inv, minlength=K).astype(np.float64)
    means = np.stack([np.bincount(inv, weights=positions[:, d], minlength=K)
                      for d in range(3)], 1) / cnt[:, None]
    centers = means[inv].astype(np.float32)
    dists = np.linalg.norm(centers - positions, axis=1).astype(np.float32)
    return centers, dists


def compute_bounding_box(positions, instance_labels, semantic_labels):
    """Per-point + per-instance box centers/bounds/radius (vectorized;
    reference scannet.py:321-367). Instance ids must be contiguous 0..K-1."""
    uniq, inv = np.unique(instance_labels, return_inverse=True)
    K = len(uniq)
    big = np.float64(1e30)
    mins = np.full((K, 3), big)
    maxs = np.full((K, 3), -big)
    for d in range(3):
        np.minimum.at(mins[:, d], inv, positions[:, d])
        np.maximum.at(maxs[:, d], inv, positions[:, d])
    centers_i = ((mins + maxs) / 2).astype(np.float32)
    bounds_i = (maxs - (mins + maxs) / 2).astype(np.float32)

    order = np.argsort(inv, kind='stable')
    first = order[np.unique(inv[order], return_index=True)[1]]
    sem_i = semantic_labels[first].astype(np.int32)

    bb_centers = centers_i[inv]
    bb_bounds = bounds_i[inv]
    bb_offsets = bb_centers - positions.astype(np.float32)
    bb_dist = np.linalg.norm(bb_offsets, axis=1).astype(np.float32)
    radius_i = np.zeros(K, np.float32)
    np.maximum.at(radius_i, inv, bb_dist)
    return (bb_centers, bb_offsets, bb_bounds, bb_dist.reshape(-1, 1),
            radius_i[inv].reshape(-1, 1), uniq, sem_i, centers_i, bounds_i,
            radius_i)


def process_scene(scene_name, mode, cfg, do_augmentations=False, rotate_z=None,
                  rng=np.random):
    """-> (scene, labels) dicts; the contract every downstream stage consumes
    (reference scannet.py:369-439)."""
    align = cfg.align
    if mode != 'test':
        data_path = os.path.join(cfg.data_dir, 'scans')
        path_seg = os.path.join(
            data_path, scene_name,
            f'{scene_name}_vh_clean_2.0.010000.segs.json')
    else:
        align = False
        data_path = os.path.join(cfg.data_dir, 'scans_test')
        path_seg = os.path.join(
            cfg.data_dir, 'scans_test_segmented',
            f'{scene_name}_vh_clean_2.0.010000.segs.json')
    path_txt = os.path.join(data_path, scene_name, f'{scene_name}.txt')
    path_ply = os.path.join(data_path, scene_name,
                            f'{scene_name}_vh_clean_2.ply')
    path_agg = os.path.join(data_path, scene_name,
                            f'{scene_name}.aggregation.json')
    label_map_file = os.path.join(data_path, '..',
                                  'scannetv2-labels.combined.tsv')

    positions, normals, colors = read_scene(
        path_ply, path_txt, cfg, align=align,
        do_augmentations=do_augmentations, rotate_z=rotate_z, rng=rng)
    with open(path_seg) as f:
        segments = np.asarray(json.load(f)['segIndices'], np.int32)

    scene = {'name': scene_name, 'positions': positions, 'normals': normals,
             'colors': colors, 'segments': segments}
    if mode == 'test':
        return scene, None

    semantics, instances, seg2inst = read_labels(label_map_file, path_agg,
                                                 segments)
    centers, center_distances = compute_avg_centers(positions, instances)
    (bb_centers, bb_offsets, bb_bounds, bb_dist, bb_radius, unique_instances,
     per_instance_semantics, per_instance_bb_centers, per_instance_bb_bounds,
     per_instance_bb_radius) = compute_bounding_box(positions, instances,
                                                    semantics)
    assert np.array_equal(unique_instances, np.arange(len(unique_instances)))

    labels = {
        'semantics': semantics, 'instances': instances,
        'centers': centers, 'center_distances': center_distances,
        'bb_centers': bb_centers, 'bb_offsets': bb_offsets,
        'bb_bounds': bb_bounds, 'seg2inst': seg2inst,
        'bb_center_distances': bb_dist, 'bb_radius': bb_radius,
        'unique_instances': unique_instances,
        'per_instance_semantics': per_instance_semantics,
        'per_instance_bb_centers': per_instance_bb_centers,
        'per_instance_bb_bounds': per_instance_bb_bounds,
        'per_instance_bb_radius': per_instance_bb_radius,
    }
    return scene, labels
