"""Voxelization + NN feature assignment + segment pooling geometry (host, NumPy).

The port's copy of box2mask_tpu/datasets/voxelize.py: unique voxels in
np.unique(axis=0) order, each voxel carrying its nearest point's features,
and per-segment mean world positions; and segment_mode (:90), the
per-segment majority vote of the association. The voxels and nearest
points come from the C voxelizer (native/, :32-40) under
`cfg.use_native_host_ops` (on by default), else from the NumPy/cKDTree
plain version. The two may pick different nearest points on exact distance
ties.

  vox2point: (P,) point -> voxel row (np.unique inverse; named for parity
             with the reference although it is indexed by point).
  point2vox: (V,) voxel row -> index of its nearest scene point.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from box2mask_torch.native import native_voxelize


def voxelize_scene(scene, cfg):
    """Voxelize one scene dict {positions, colors, normals, segments} -> ret dict."""
    ret = {}
    positions = scene['positions']
    origin = min(0, np.min(positions)) if len(positions) else 0.0
    input_coords = (positions - origin) / cfg.voxel_size

    if cfg.use_native_host_ops:
        vox_coords, vox2point, point2vox = native_voxelize(input_coords)
    else:
        vox = np.round(input_coords)
        vox_coords, vox2point = np.unique(vox, axis=0, return_inverse=True)
        vox2point = vox2point.reshape(-1)
        tree = cKDTree(input_coords)
        _, point2vox = tree.query(vox_coords.astype(np.float64), k=1)
        point2vox = np.asarray(point2vox).reshape(-1)
        vox_coords = vox_coords.astype(np.int32)
    ret['vox_coords'] = vox_coords
    ret['vox2point'] = vox2point
    ret['point2vox'] = point2vox

    feats = [scene['colors']]
    if cfg.use_normals_input:
        feats.append(scene['normals'])
    feats = np.concatenate(feats, axis=1)
    ret['vox_features'] = feats[point2vox].astype(np.float32)
    ret['vox_world_coords'] = (vox_coords * cfg.voxel_size + origin).astype(np.float32)
    ret['scene'] = scene

    if cfg.do_segment_pooling:
        ret['vox_segments'] = scene['segments'][point2vox]
        unique_segs, seg2vox = np.unique(ret['vox_segments'], return_inverse=True)
        seg2vox = seg2vox.reshape(-1)
        S = len(unique_segs)
        cnt = np.bincount(seg2vox, minlength=S).astype(np.float64)
        mids = np.stack([
            np.bincount(seg2vox, weights=ret['vox_world_coords'][:, d], minlength=S)
            for d in range(3)], axis=1) / cnt[:, None]
        assert not np.any(np.isnan(mids))
        ret['unique_vox_segments'] = unique_segs
        ret['seg2vox'] = seg2vox
        ret['seg2point'] = seg2vox[vox2point]
        ret['input_location'] = mids.astype(np.float32)
        ret['pred2point'] = ret['seg2point']
    else:
        ret['input_location'] = ret['vox_world_coords']
        ret['pred2point'] = vox2point
        ret['vox_segments'] = scene.get(
            'segments', np.zeros(len(positions), np.int32))[point2vox]
    return ret


def segment_mode(values, seg2x, num_segments, minlength=None):
    """Per-segment mode (majority vote) of integer `values`, vectorized.

    Used for the majority-vote association variants (models/dataloader.py:263-271)
    and per-segment semantic voting. Ties resolve to the smallest value (same as
    scipy.stats.mode)."""
    values = np.asarray(values)
    vmin = values.min() if len(values) else 0
    shifted = values - vmin
    R = int(shifted.max()) + 1 if len(shifted) else 1
    combo = seg2x.astype(np.int64) * R + shifted
    counts = np.bincount(combo, minlength=num_segments * R).reshape(num_segments, R)
    return counts.argmax(axis=1) + vmin
