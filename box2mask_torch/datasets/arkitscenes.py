"""ARKitScenes reader: mesh + oriented-bounding-box-only annotations (the
port's copy of box2mask_tpu/datasets/arkitscenes.py).

Behavior-parity with dataprocessing/arkitscenes.py of the reference: file
layout (``3dod/{Training,Validation}/<id>/<id>_3dod_mesh.ply`` +
``_3dod_annotation.json``, oversegmentation jsons under
``3dod/segmented_{train,val}_clean``), label derivation from obbAligned
annotations (normalizedAxes row-major 3x3, centroid, axesLengths/2), mesh
subsampling ``[::subsample_rate]``, xy-mean/z-min recentering of points AND
boxes, and joint point+box augmentations (rotation applied to rotations as
``R_aug.T @ rot``, scale applied to centers and bounds).
"""

from __future__ import annotations

import json
import os

import numpy as np

from box2mask_torch.datasets import augmentation as aug
from box2mask_torch.datasets.ply import read_mesh, compute_vertex_normals
from box2mask_torch.datasets.tables import ARKITSCENES_NAME2ID
from box2mask_torch.metrics.box3d import rotated_bounds

# annotation label name -> semantic id (reference arkitscenes.py:86-131; the
# full name table includes the ScanNet-shared classes)
NAME2ID = dict(ARKITSCENES_NAME2ID)
NAME2ID.update({'wall': 1, 'floor': 2, 'door': 8, 'window': 9, 'bookshelf': 10,
                'picture': 11, 'counter': 12, 'desk': 14, 'curtain': 16,
                'shower curtain': 28, 'otherfurn': 39, 'unlabeled': 0})


def read_scene(path_ply, cfg, rng=np.random):
    """Positions/normals/colors (color augs only — the reference disables the
    geometric mesh augs for ARKit and augments points+boxes jointly later)."""
    positions, colors, faces = read_mesh(path_ply)
    normals = (compute_vertex_normals(positions, faces) if faces is not None
               else np.zeros_like(positions))
    if colors is None:
        colors = np.zeros_like(positions)
    if cfg.augmentation:
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


def read_bounding_box_annotations(annotations_file, axis_aligned_bb=False):
    """OBB annotations -> (ids, semantics, centers, half-bounds, 3x3 rotations
    flattened row-major). Reference arkitscenes.py:254-299."""
    with open(annotations_file) as f:
        annotations = json.load(f)
    instances = annotations['data']
    K = len(instances)
    ids = np.arange(K)
    semantics = np.zeros(K, np.int64)
    centers = np.zeros((K, 3))
    bounds = np.zeros((K, 3))
    rotations = np.zeros((K, 9))
    for i, inst in enumerate(instances):
        semantics[i] = NAME2ID[inst['label']]
        obb = inst['segments']['obbAligned']
        rot = np.asarray(obb['normalizedAxes'], np.float64).reshape(3, 3)
        centers[i] = np.asarray(obb['centroid'], np.float64).reshape(3)
        bounds[i] = np.asarray(obb['axesLengths'], np.float64).reshape(3) * 0.5
        rotations[i] = rot.reshape(9)
        if axis_aligned_bb:
            bounds[i] = rotated_bounds(bounds[i], rot)
    return ids, semantics, centers, bounds, rotations


def process_scene(scene_name, mode, cfg, do_augmentations=False,
                  subsample_rate=10, rng=np.random):
    if mode == 'train':
        data_path = os.path.join(cfg.data_dir, '3dod/Training')
        seg_path = os.path.join(cfg.data_dir, '3dod/segmented_train_clean',
                                f'{scene_name}_3dod_mesh.0.010000.segs.json')
    elif mode == 'val':
        data_path = os.path.join(cfg.data_dir, '3dod/Validation')
        seg_path = os.path.join(cfg.data_dir, '3dod/segmented_val_clean',
                                f'{scene_name}_3dod_mesh.0.010000.segs.json')
    elif mode == 'predict_specific_scene':
        data_path = os.path.join(cfg.data_dir, '3dod/Training')
        seg_path = os.path.join(cfg.data_dir, '3dod/segmented_train_clean',
                                f'{scene_name}_3dod_mesh.0.010000.segs.json')
        if not os.path.exists(os.path.join(
                data_path, scene_name, f'{scene_name}_3dod_mesh.ply')):
            data_path = os.path.join(cfg.data_dir, '3dod/Validation')
            seg_path = os.path.join(
                cfg.data_dir, '3dod/segmented_val_clean',
                f'{scene_name}_3dod_mesh.0.010000.segs.json')
    else:
        raise ValueError(f'Unknown mode {mode} for ARKitScenes')

    path_ply = os.path.join(data_path, scene_name,
                            f'{scene_name}_3dod_mesh.ply')
    path_ann = os.path.join(data_path, scene_name,
                            f'{scene_name}_3dod_annotation.json')

    positions, normals, colors = read_scene(path_ply, cfg, rng=rng)
    with open(seg_path) as f:
        segments = np.asarray(json.load(f)['segIndices'], np.int32)

    scene = {'name': scene_name,
             'positions': positions[::subsample_rate].copy(),
             'normals': normals[::subsample_rate].copy(),
             'colors': colors[::subsample_rate].copy(),
             'segments': segments[::subsample_rate].copy()}
    if mode == 'test':
        return scene, None

    (unique_instances, per_instance_semantics, centers, bounds,
     rotations) = read_bounding_box_annotations(path_ann)

    # recentre: xy-mean / z-min of the (subsampled) points, boxes shifted too
    txy = np.mean(scene['positions'][:, :2], 0)
    tz = np.min(scene['positions'][:, 2])
    scene['positions'][:, :2] -= txy
    scene['positions'][:, 2] -= tz
    centers[:, :2] -= txy
    centers[:, 2] -= tz

    if cfg.augmentation and do_augmentations:
        if rng.rand() < cfg.rotation_aug[0]:
            ip, mx = cfg.rotation_aug[2], cfg.rotation_aug[1]
            rz = rng.uniform(0, 2 * np.pi) if rng.rand() < ip else 0
            rx = rng.uniform(-mx, mx) if rng.rand() < ip else 0
            ry = rng.uniform(-mx, mx) if rng.rand() < ip else 0
            # scipy R.from_euler('xyz') == Rz @ Ry @ Rx (extrinsic xyz)
            Rm = (aug.rotation_matrix_xyz(0, 0, rz)
                  @ aug.rotation_matrix_xyz(0, ry, 0)
                  @ aug.rotation_matrix_xyz(rx, 0, 0))
            scene['positions'] = scene['positions'] @ Rm.T
            scene['normals'] = scene['normals'] @ Rm.T
            centers = centers @ Rm.T
            for i in range(len(rotations)):
                rotations[i] = (Rm.T @ rotations[i].reshape(3, 3)).reshape(9)
        if rng.rand() < cfg.position_jittering[0]:
            scene['positions'] = aug.position_jitter(
                scene['positions'], cfg.position_jittering[1], rng=rng)
        if rng.rand() < cfg.scaling_aug[0]:
            s = rng.uniform(cfg.scaling_aug[1], cfg.scaling_aug[2])
            scene['positions'] *= s
            centers *= s
            bounds *= s

    labels = {'unique_instances': unique_instances,
              'per_instance_semantics': per_instance_semantics,
              'per_instance_bb_centers': centers,
              'per_instance_bb_bounds': bounds,
              'per_instance_bb_rotations': rotations}
    return scene, labels
