"""Surface-mesh visualization without open3d.

The reference's S3DIS visualization runs Poisson reconstruction + color
interpolation onto the mesh (utils/s3dis_util.py:19-51, open3d). This module
provides the dependency-free substitute: a voxel boundary surface mesh —
every occupied-voxel face adjacent to empty space becomes a colored quad.
Blocky but watertight-ish and label-faithful; written with the project PLY
mesh writer so any mesh viewer opens it.

The port's copy of box2mask_tpu/viz/surface.py: it writes the same
bytes.
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.datasets.ply import write_ply_mesh

# face corner offsets for the 6 axis directions; each row: 4 corner offsets
# (in voxel-corner units) of the face normal to +-axis, wound outward
_FACES = {
    (1, 0, 0): [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
    (-1, 0, 0): [(0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0)],
    (0, 1, 0): [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
    (0, -1, 0): [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
    (0, 0, 1): [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    (0, 0, -1): [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
}


def _pack(c):
    c = c.astype(np.int64)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def voxel_surface_mesh(positions, point_colors, voxel_size=0.04):
    """-> (vertices (M,3) float, faces (F,3) int, vertex_colors (M,3)).

    Points are quantized to `voxel_size`; each voxel takes the color of its
    first point (callers pass label colors, which are constant per voxel in
    practice). Exposed faces are triangulated into 2 triangles each."""
    positions = np.asarray(positions)
    origin = positions.min(0)
    vox = np.floor((positions - origin) / voxel_size).astype(np.int64) + 1
    keys_all = _pack(vox)
    keys, first = np.unique(keys_all, return_index=True)
    vcoords = vox[first]                       # (V, 3)
    vcolors = np.asarray(point_colors)[first]  # (V, 3)

    verts, tris, cols = [], [], []
    for d, corner_offs in _FACES.items():
        nbr = _pack(vcoords + np.asarray(d, np.int64))
        pos = np.searchsorted(keys, nbr)
        pos_c = np.minimum(pos, len(keys) - 1)
        exposed = keys[pos_c] != nbr
        cv = vcoords[exposed]
        base = sum(v.shape[0] for v in verts)
        quad = np.stack([cv + np.asarray(o, np.int64) for o in corner_offs],
                        axis=1)                       # (E, 4, 3)
        verts.append(((quad - 1) * voxel_size + origin).reshape(-1, 3))
        idx = base + np.arange(len(cv))[:, None] * 4
        tris.append(np.concatenate(
            [idx + np.array([0, 1, 2]), idx + np.array([0, 2, 3])], axis=0))
        cols.append(np.repeat(vcolors[exposed], 4, axis=0))
    if not verts:
        return (np.zeros((0, 3)), np.zeros((0, 3), np.int64),
                np.zeros((0, 3)))
    return (np.concatenate(verts, 0).astype(np.float32),
            np.concatenate(tris, 0).astype(np.int64),
            np.concatenate(cols, 0))


def write_surface_mesh_ply(path, positions, point_colors, voxel_size=0.04):
    """Poisson-visualization substitute: voxel boundary mesh colored by the
    given per-point colors (reference utils/s3dis_util.py:19-51 equivalent)."""
    v, f, c = voxel_surface_mesh(positions, point_colors, voxel_size)
    write_ply_mesh(path, v, f, c)
    return path
