"""Oriented 3D box geometry: polygon clipping, convex-hull intersection, OBB IoU
(the port's copy of box2mask_tpu/metrics/box3d.py).

Protocol-parity with the reference's box utilities (utils/box_util.py:19-140
polygon_clip/convex_hull_intersection/box3d_iou, :236-274 get_3d_box,
:339-383 rotated bounds/corners) used by the ARKitScenes detection eval: boxes are
compared by 2D convex-polygon intersection in the xy-plane times z-extent overlap.
"""

from __future__ import annotations

import numpy as np


def polygon_clip(subject, clip):
    """Sutherland–Hodgman clipping of polygon `subject` by convex polygon `clip`.
    Both are (N, 2) vertex lists; returns vertex list or None if empty."""
    def inside(p, a, b):
        # boundary-tolerant orientation test: vertices exactly on a clip edge
        # count as inside (the textbook strict test loses area on degenerate
        # inputs like identical boxes due to fp cancellation)
        cross = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        scale = abs(b[0] - a[0]) + abs(b[1] - a[1]) + abs(p[0] - a[0]) \
            + abs(p[1] - a[1])
        return cross > -1e-10 * max(scale, 1.0)

    def intersect(a, b, p, q):
        dc = (a[0] - b[0], a[1] - b[1])
        dp = (p[0] - q[0], p[1] - q[1])
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p[0] * q[1] - p[1] * q[0]
        den = dc[0] * dp[1] - dc[1] * dp[0]
        return ((n1 * dp[0] - n2 * dc[0]) / den, (n1 * dp[1] - n2 * dc[1]) / den)

    output = list(subject)
    a = clip[-1]
    for b in clip:
        if not output:
            return None
        inputs, output = output, []
        s = inputs[-1]
        for e in inputs:
            if inside(e, a, b):
                if not inside(s, a, b):
                    output.append(intersect(a, b, s, e))
                output.append(e)
            elif inside(s, a, b):
                output.append(intersect(a, b, s, e))
            s = e
        a = b
    return output if output else None


def poly_area(pts):
    """Shoelace area of a 2D polygon (N, 2)."""
    pts = np.asarray(pts)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def convex_hull_intersection(p1, p2):
    """Intersection area of two convex 2D polygons."""
    inter = polygon_clip(p1, p2)
    if inter is None:
        return None, 0.0
    return inter, poly_area(inter)


def rotz(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def get_3d_box(box_size, heading_angle, center):
    """(8, 3) corners of a z-rotated box; corner order compatible with box3d_iou
    (first four = top face counter-clockwise, last four = bottom face)."""
    R = rotz(heading_angle)
    l, w, h = box_size
    x = [l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2]
    y = [w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2]
    z = [h / 2, h / 2, h / 2, h / 2, -h / 2, -h / 2, -h / 2, -h / 2]
    corners = R @ np.vstack([x, y, z])
    return (corners + np.asarray(center)[:, None]).T


def corners_from_rotation(center, bounds, rotation):
    """(8, 3) corners of an OBB given 3x3 rotation + half-extents; top 4 first."""
    signs = np.array([[1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
                      [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1]],
                     np.float64)
    local = signs * np.asarray(bounds)[None, :]
    return (np.asarray(rotation).reshape(3, 3).T @ local.T).T + np.asarray(center)


def box3d_iou(corners1, corners2):
    """(iou_3d, iou_2d) of two boxes given (8,3) corners, top face first.

    2D hull intersection in xy x z-overlap (reference box_util.py:101-140)."""
    p1 = [(corners1[i, 0], corners1[i, 1]) for i in range(3, -1, -1)]
    p2 = [(corners2[i, 0], corners2[i, 1]) for i in range(3, -1, -1)]
    area1, area2 = poly_area(p1), poly_area(p2)
    _, inter_area = convex_hull_intersection(p1, p2)
    iou_2d = inter_area / (area1 + area2 - inter_area + 1e-12)
    zmax = min(corners1[0, 2], corners2[0, 2])
    zmin = max(corners1[4, 2], corners2[4, 2])
    inter_vol = inter_area * max(0.0, zmax - zmin)
    vol1 = box3d_vol(corners1)
    vol2 = box3d_vol(corners2)
    iou = inter_vol / (vol1 + vol2 - inter_vol + 1e-12)
    return iou, iou_2d


def box3d_vol(corners):
    a = np.linalg.norm(corners[0] - corners[1])
    b = np.linalg.norm(corners[1] - corners[2])
    c = np.linalg.norm(corners[0] - corners[4])
    return a * b * c


def hull_box_iou(corners1, corners2):
    """OBB-vs-hull IoU, the ARKit eval variant (reference box_util.py:101-140 with
    the repo's bottom-face-first order): `corners1` may be a general prism — k
    bottom hull vertices then k top vertices; `corners2` is an 8-corner box
    (bottom 4 first). vol1 = footprint area x height (exact for prisms)."""
    c1, c2 = np.asarray(corners1), np.asarray(corners2)
    k = c1.shape[0] // 2
    rect1 = [(c1[i, 0], c1[i, 1]) for i in range(k - 1, -1, -1)]
    rect2 = [(c2[i, 0], c2[i, 1]) for i in [0, 1, 2, 3]]
    area1, area2 = poly_area(rect1), poly_area(rect2)
    _, inter_area = convex_hull_intersection(rect1, rect2)
    iou_2d = inter_area / max(area1 + area2 - inter_area, 1e-12)
    zmax = min(c1[-1, 2], c2[-1, 2])
    zmin = max(c1[0, 2], c2[0, 2])
    inter_vol = inter_area * max(0.0, zmax - zmin)
    vol1 = area1 * (c1[-1, 2] - c1[0, 2])
    vol2 = box3d_vol(c2)
    return inter_vol / max(vol1 + vol2 - inter_vol, 1e-12), iou_2d


def oriented_corners(bounds, rotation, translation):
    """(8,3) OBB corners, bottom face first (reference box_util.py:360-383)."""
    signs = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                      [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float64)
    local = signs * np.asarray(bounds)[None, :]
    return (np.asarray(rotation) @ local.T).T + np.asarray(translation)


def rotated_bounds(bb_bounds, rotation):
    """Axis-aligned half-extents of a rotated box (box_util.py:339-357)."""
    signs = np.array([[i, j, k] for i in (-1, 1) for j in (-1, 1)
                      for k in (-1, 1)], np.float64)
    corners = (np.asarray(rotation) @ (signs * np.asarray(bb_bounds)).T).T
    return np.maximum(corners.max(axis=0), 0.0)


def aabb_iou_cs(box_a, box_b):
    """IoU of (center, size) axis-aligned boxes — the get_iou used for AABB
    detection eval (reference utils/metric_util.py:91-113).
    box: dict or tuple (center (3,), size (3,))."""
    ca, sa = np.asarray(box_a[0]), np.asarray(box_a[1])
    cb, sb = np.asarray(box_b[0]), np.asarray(box_b[1])
    amin, amax = ca - sa / 2, ca + sa / 2
    bmin, bmax = cb - sb / 2, cb + sb / 2
    inter = np.prod(np.clip(np.minimum(amax, bmax) - np.maximum(amin, bmin), 0, None))
    union = np.prod(sa) + np.prod(sb) - inter
    return float(inter / max(union, 1e-12))
