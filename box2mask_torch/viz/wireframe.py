"""Bounding-box wireframe geometry + PLY export.

The reference builds per-box line sets for pyviz3d scenes
(utils/util.py:5-43 get_bb_lines/get_bbs_lines; consumed by
models/evaluation.py:532-615). We have no pyviz3d; instead the wireframes are
written as a standard PLY with `edge` elements (CloudCompare/MeshLab render
them as line sets) plus densified line points so point-cloud-only viewers show
the boxes too.

The port's copy of box2mask_tpu/viz/wireframe.py: it writes the same
bytes.
"""

from __future__ import annotations

import numpy as np

# the 12 edges of a unit box as corner-index pairs; corners enumerated by
# bit pattern (x, y, z) in {0, 1}^3, index = 4x + 2y + z
BOX_EDGES = np.array([
    (0, 1), (0, 2), (3, 1), (3, 2),          # z/y edges of the x=0 face
    (4, 5), (4, 6), (7, 5), (7, 6),          # z/y edges of the x=1 face
    (0, 4), (1, 5), (2, 6), (3, 7),          # x edges
], np.int64)


def box_corners(bb_min, bb_max):
    """(8, 3) corners of one AABB, bit-pattern order."""
    bb_min, bb_max = np.asarray(bb_min), np.asarray(bb_max)
    bits = ((np.arange(8)[:, None] >> np.array([2, 1, 0])) & 1).astype(bool)
    return np.where(bits, bb_max, bb_min)


def bb_lines(bb_center, bb_bounds):
    """(start (12,3), end (12,3)) line segments of one box — the reference's
    get_bb_lines contract (utils/util.py:5-28)."""
    corners = box_corners(np.asarray(bb_center) - np.asarray(bb_bounds),
                          np.asarray(bb_center) + np.asarray(bb_bounds))
    return corners[BOX_EDGES[:, 0]], corners[BOX_EDGES[:, 1]]


def bbs_lines(centers, bounds):
    """Concatenated segments of many boxes (get_bbs_lines, util.py:30-43)."""
    starts, ends = [], []
    for c, b in zip(np.asarray(centers), np.asarray(bounds)):
        s, e = bb_lines(c, b)
        starts.append(s)
        ends.append(e)
    if not starts:
        z = np.zeros((0, 3))
        return z, z
    return np.concatenate(starts, 0), np.concatenate(ends, 0)


def write_wireframe_ply(path, centers, bounds, colors=None,
                        points_per_edge=24):
    """Write box wireframes as a PLY: 8 vertices + 12 edge elements per box,
    plus densified points along each edge (so plain point viewers see boxes).
    `colors`: (N, 3) uint8-ish per box, default deterministic per-index."""
    centers = np.asarray(centers, np.float64)
    bounds = np.asarray(bounds, np.float64)
    N = len(centers)
    if colors is None:
        colors = np.stack([np.random.default_rng(i + 7).uniform(60, 255, 3)
                           for i in range(N)]) if N else np.zeros((0, 3))
    colors = np.asarray(colors)

    verts, vcols, edges = [], [], []
    for i in range(N):
        corners = box_corners(centers[i] - bounds[i], centers[i] + bounds[i])
        base = len(verts)
        verts.extend(corners)
        vcols.extend([colors[i]] * 8)
        edges.extend(BOX_EDGES + base)
    # densified edge points appended after the corner vertices
    t = np.linspace(0.0, 1.0, points_per_edge)[1:-1, None]
    for i in range(N):
        s, e = bb_lines(centers[i], bounds[i])
        pts = (s[:, None, :] * (1 - t[None]) + e[:, None, :] * t[None]
               ).reshape(-1, 3)
        verts.extend(pts)
        vcols.extend([colors[i]] * len(pts))

    # (0, 3) with no box: the JAX writer raises there (ROADMAP section C)
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    vcols = np.clip(np.asarray(vcols), 0, 255).astype(np.uint8).reshape(-1, 3)
    edges = np.asarray(edges, np.int32)
    with open(path, 'wb') as f:
        hdr = ['ply', 'format binary_little_endian 1.0',
               f'element vertex {len(verts)}',
               'property float x', 'property float y', 'property float z',
               'property uchar red', 'property uchar green',
               'property uchar blue',
               f'element edge {len(edges)}',
               'property int vertex1', 'property int vertex2',
               'end_header']
        f.write(('\n'.join(hdr) + '\n').encode())
        rec = np.zeros(len(verts), dtype=[('xyz', np.float32, 3),
                                          ('rgb', np.uint8, 3)])
        rec['xyz'] = verts
        rec['rgb'] = vcols
        f.write(rec.tobytes())
        f.write(edges.astype('<i4').tobytes())
    return path
