"""Visualization producers: colored PLYs of predictions / GT + box dumps
(the port's copy of box2mask_tpu/viz/export.py; it writes the same bytes).

Behavior-parity with the reference's visualization writers
(models/evaluation.py:368-615): per scene writes rgb.ply, pred_instances.ply,
pred_semantics.ply, gt_instances.ply, gt_semantics.ply and bbs.npy into
<exp>/viz/<scene>/. Instance colors come from a deterministic random LUT
(utils/util.py:100-113); semantic colors from the dataset color map.
"""

from __future__ import annotations

import os

import numpy as np

from box2mask_torch.datasets.ply import write_ply_points
from box2mask_torch.datasets.tables import SCANNET_COLOR_MAP
from box2mask_torch.postprocess.detection2mask import detection_to_masks
from box2mask_torch.viz.html_viewer import write_html_viewer
from box2mask_torch.viz.surface import write_surface_mesh_ply
from box2mask_torch.viz.wireframe import bbs_lines, write_wireframe_ply


def instance_colors(ids):
    """Deterministic random color per instance id; 0 black, -2 red."""
    ids = np.asarray(ids)
    out = np.zeros((len(ids), 3), np.float64)
    uniq = np.unique(ids)
    for u in uniq:
        rng = np.random.default_rng(abs(int(u)) + 7)
        if u == 0:
            c = np.zeros(3)
        elif u == -2:
            c = np.array([255.0, 0, 0])
        else:
            c = rng.uniform(0, 255, 3)
        out[ids == u] = c
    return out


def semantic_colors(sem_ids, color_map=None):
    cm = SCANNET_COLOR_MAP if color_map is None else color_map
    sem = np.clip(np.asarray(sem_ids), 0, len(cm) - 1)
    return cm[sem]


def masks_to_instance_ids(masks, confs):
    """Overlay masks by ascending confidence so the most confident wins."""
    if len(masks) == 0:
        return None
    n = np.asarray(masks[0]).shape[0]
    ids = np.zeros(n, np.int64)
    order = np.argsort(confs)
    for j in order:
        ids[np.asarray(masks[j]) > 0] = int(j) + 1
    return ids


def export_scene_visualization(out_dir, scene, labels, result, cfg=None):
    os.makedirs(out_dir, exist_ok=True)
    pos = scene['positions']
    point_layers = []           # (name, colors, visible) for viewer.html
    line_layers = []
    if scene.get('colors') is not None:
        rgb = np.asarray(scene['colors'])
        if rgb.max() <= 1.0 + 1e-6:
            rgb = rgb * 255.0
        write_ply_points(os.path.join(out_dir, 'rgb.ply'), pos, scene['colors'])
        point_layers.append(('Input scene', rgb, True))
    if labels is not None:
        gt_inst = instance_colors(labels['instances'])
        gt_sem = semantic_colors(labels['semantics'])
        write_ply_points(os.path.join(out_dir, 'gt_instances.ply'), pos,
                         gt_inst)
        write_ply_points(os.path.join(out_dir, 'gt_semantics.ply'), pos,
                         gt_sem)
        point_layers += [('GT Instances', gt_inst, False),
                         ('GT Semantics', gt_sem, False)]
        if 'per_instance_bb_centers' in labels:
            # GT box line set (reference evaluation.py:610-612 'GT BBs')
            centers = np.asarray(labels['per_instance_bb_centers'])
            bounds = np.asarray(labels['per_instance_bb_bounds'])
            s, e = bbs_lines(centers, bounds)
            c = np.repeat(semantic_colors(
                labels['per_instance_semantics']), 12, axis=0)
            line_layers.append(('GT BBs', s, e, c, False))
    if result is not None:
        inst = masks_to_instance_ids(result['mask'], result['conf'])
        if inst is None or len(inst) != len(pos):
            # no surviving predictions: still write the files (all background)
            # so the visualization set is always complete
            inst = np.zeros(len(pos), np.int64)
        pred_inst = instance_colors(inst)
        write_ply_points(os.path.join(out_dir, 'pred_instances.ply'), pos,
                         pred_inst)
        sem = np.zeros(len(pos), np.int64)
        order = np.argsort(result['conf'])
        for j in order:
            mask = np.asarray(result['mask'][j]) > 0
            if len(mask) == len(pos):
                sem[mask] = int(result['label_id'][j])
        pred_sem = semantic_colors(sem)
        write_ply_points(os.path.join(out_dir, 'pred_semantics.ply'), pos,
                         pred_sem)
        point_layers += [('Pred Instances', pred_inst, False),
                         ('Pred Semantics', pred_sem, False)]
        if cfg is not None and getattr(cfg, 'mesh_viz', False):
            # Poisson-reconstruction substitute (viz/surface.py): voxel
            # boundary meshes colored by prediction labels (reference
            # utils/s3dis_util.py:19-51)
            vs = 2 * (cfg.voxel_size or 0.02)
            write_surface_mesh_ply(
                os.path.join(out_dir, 'pred_instances_mesh.ply'), pos,
                instance_colors(inst), voxel_size=vs)
            write_surface_mesh_ply(
                os.path.join(out_dir, 'pred_semantics_mesh.ply'), pos,
                semantic_colors(sem), voxel_size=vs)
        if 'bbs' in result:
            bbs = np.asarray(result['bbs'])       # (R, 7) [score, min, max]
            np.save(os.path.join(out_dir, 'bbs.npy'), bbs)
            # predicted-box wireframes (reference utils/util.py:5-43 line sets)
            centers = (bbs[:, 1:4] + bbs[:, 4:7]) / 2
            bounds = (bbs[:, 4:7] - bbs[:, 1:4]) / 2
            colors = instance_colors(np.arange(1, len(bbs) + 1))
            write_wireframe_ply(os.path.join(out_dir, 'pred_bbs.ply'),
                                centers, bounds, colors)
            s, e = bbs_lines(centers, bounds)
            line_layers.append(('Pred BBs', s, e,
                                np.repeat(colors, 12, axis=0), False))
    if point_layers:
        # interactive single-file bundle — the pyviz3d-save equivalent
        # (reference models/evaluation.py:605-615)
        write_html_viewer(os.path.join(out_dir, 'viewer.html'), pos,
                          point_layers, line_layers,
                          title=os.path.basename(out_dir) or 'scene')


def produce_visualizations(evaluater, dataset, cfg):
    """Reference --produce_visualizations / --predict_specific_scene flow
    (evaluation.py:523-615,711-715). The masks come from
    `evaluater.pred_entries_to_results` (the device post-processing on the
    card, the host oracle on the CPU), the boxes from the host oracle's viz
    mode, as in the JAX package on its chip."""
    entries = evaluater.load_or_predict(dataset)
    results = evaluater.pred_entries_to_results(entries)
    base = os.path.join(cfg.exp_path, 'viz')
    for pred, dev, host in entries:
        # viz-mode pass carries the representative boxes for bbs.npy +
        # wireframes (reference evaluation.py:532-615 box line sets)
        viz_results = detection_to_masks(
            pred, dev, host, cfg, evaluater.valid_class_ids,
            evaluater.is_foreground, mode='viz')
        for scene, labels in zip(host['scene'], host['labels']):
            name = scene['name']
            if name not in results:
                continue
            merged = dict(results[name])
            if 'bbs' in viz_results.get(name, {}):
                merged['bbs'] = viz_results[name]['bbs']
            export_scene_visualization(os.path.join(base, name), scene,
                                       labels, merged, cfg)
            print(f'visualizations written: {os.path.join(base, name)}')
    return base
