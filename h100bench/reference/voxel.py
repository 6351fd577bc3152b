"""Voxelisation and segment geometry of one scene, in NumPy.

A point p falls in voxel round((p - origin) / voxel_size), origin the
smaller of 0 and the scene's least coordinate, the quotient taken in
float32 (the precision in which the presets' host ops voxelize) and
rounded half to even; voxels are the distinct cells in lexicographic
order; each voxel takes the features (colour, then normal) of the scene
point nearest its centre; a voxel's segment is that point's segment.
Segments are the distinct voxel segments in ascending order, and a
segment's location is the mean world position of its voxels.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def voxelize(scene, voxel_size, use_normals=True):
    pos = np.asarray(scene['positions'], np.float64)
    origin = min(0.0, float(pos.min())) if len(pos) else 0.0
    grid = ((pos - origin) / voxel_size).astype(np.float32)
    cells, point_cell = np.unique(np.round(grid), axis=0,
                                  return_inverse=True)
    point_cell = point_cell.reshape(-1)
    grid = grid.astype(np.float64)
    _, nearest = cKDTree(grid).query(cells.astype(np.float64), k=1)
    feats = [scene['colors']] + ([scene['normals']] if use_normals else [])
    feats = np.concatenate(feats, axis=1)[nearest].astype(np.float32)
    coords = cells.astype(np.int64)
    world = (coords * voxel_size + origin).astype(np.float32)
    vox_seg = np.asarray(scene['segments'])[nearest]
    segs, vox_seg_row = np.unique(vox_seg, return_inverse=True)
    vox_seg_row = vox_seg_row.reshape(-1)
    cnt = np.bincount(vox_seg_row, minlength=len(segs)).astype(np.float64)
    loc = np.stack([np.bincount(vox_seg_row, weights=world[:, d],
                                minlength=len(segs)) for d in range(3)],
                   1) / cnt[:, None]
    return {'coords': coords, 'features': feats, 'point_vox': point_cell,
            'segments': segs, 'vox_seg_row': vox_seg_row,
            'seg_loc': loc.astype(np.float32),
            'point_seg_row': vox_seg_row[point_cell]}
