"""Scene generators of the benchmark: frozen copies, so that a later change
to the program's own generators cannot change what is measured.

  scannet_scene   a ScanNet-like room of box-shaped furniture, its points,
                  oversegments and instance labels (a copy of the port's
                  datasets/synthetic.py make_scene and derive_labels);
  arkit_scene     an ARKitScenes-like room of gridded surfaces with yawed
                  objects (a copy of datasets/fixtures.py make_room), as the
                  ARKitScenes reader returns it in test mode: area-weighted
                  vertex normals, every `subsample_rate`-th vertex;
  augment         the ScanNet preset's host augmentation (a copy of
                  datasets/augmentation.py augment_scene, limited to the
                  transforms a preset here turns on), applied before the
                  labels are derived, as the synthetic training set does.

Every function draws from the generator it is given, so the same seed gives
the same scene. The program receives only what these produce.
"""

from __future__ import annotations

import numpy as np

# ScanNet's instance classes (NYU40 ids), the furniture the generator draws
SCANNET_INSTANCE_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


# ------------------------------------------------------------------ ScanNet
def _box_surface_points(rng, center, half, n):
    face = rng.integers(0, 6, n)
    u = rng.uniform(-1, 1, (n, 3))
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    u[np.arange(n), axis] = sign
    return center + u * half


def scannet_scene(seed, name, num_instances=18, points_per_instance=4000,
                  room_size=(6.0, 5.0, 2.6), floor_points=45000,
                  wall_points=35000, segs_per_instance=6):
    """(scene, labels): scene = {name, positions, normals, colors,
    segments}; labels = per-point semantics / instances and the instance
    boxes (derive_labels)."""
    rng = np.random.default_rng(seed)
    W, D, H = room_size
    pos, col, sem, inst, segs = [], [], [], [], []
    seg_counter = 0

    def add(points, color, sem_id, inst_id, nsegs):
        nonlocal seg_counter
        n = len(points)
        pos.append(points)
        c = np.clip(color + rng.normal(0, 0.03, (n, 3)), 0, 1)
        col.append(np.round(c * 255.0) / 255.0)
        sem.append(np.full(n, sem_id, np.int32))
        inst.append(np.full(n, inst_id, np.int32))
        if nsegs <= 1:
            s = np.full(n, seg_counter, np.int32)
            seg_counter += 1
        else:
            proj = points @ rng.normal(size=(3,))
            qs = np.quantile(proj, np.linspace(0, 1, nsegs + 1)[1:-1])
            s = (np.searchsorted(qs, proj) + seg_counter).astype(np.int32)
            seg_counter += nsegs
        segs.append(s)

    fp = np.stack([rng.uniform(0, W, floor_points),
                   rng.uniform(0, D, floor_points),
                   np.abs(rng.normal(0, 0.01, floor_points))], 1)
    add(fp, np.array([0.5, 0.4, 0.3]), 2, 1, 6)
    next_inst = 2
    for wall in range(2):
        n = wall_points // 2
        if wall == 0:
            wp = np.stack([np.abs(rng.normal(0, 0.01, n)),
                           rng.uniform(0, D, n), rng.uniform(0, H, n)], 1)
        else:
            wp = np.stack([rng.uniform(0, W, n),
                           np.abs(rng.normal(0, 0.01, n)),
                           rng.uniform(0, H, n)], 1)
        add(wp, np.array([0.7, 0.7, 0.65]), 1, next_inst, 4)
        next_inst += 1

    placed = []
    for _ in range(num_instances):
        sem_id = int(rng.choice(SCANNET_INSTANCE_IDS))
        for _ in range(50):
            half = rng.uniform(0.15, 0.6, 3)
            center = np.array([rng.uniform(1, W - 1), rng.uniform(1, D - 1),
                               half[2]])
            lo, hi = center - half, center + half
            if all((lo > p_hi).any() or (hi < p_lo).any()
                   for p_lo, p_hi in placed):
                break
        placed.append((center - half, center + half))
        pts = _box_surface_points(rng, center, half, points_per_instance)
        add(pts, rng.uniform(0.1, 0.9, 3), sem_id, next_inst,
            segs_per_instance)
        next_inst += 1

    positions = np.concatenate(pos).astype(np.float64)
    normals = rng.normal(size=positions.shape)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    scene = {'name': name, 'positions': positions, 'normals': normals,
             'colors': np.concatenate(col).astype(np.float64),
             'segments': np.concatenate(segs)}
    labels = {'semantics': np.concatenate(sem),
              'instances': np.concatenate(inst)}
    return scene, derive_labels(positions, labels['semantics'],
                                labels['instances'], scene['segments'])


def derive_labels(positions, semantics, instances, segments):
    """Instance boxes, centres and seg2inst from per-point labels (the
    readers' ground-truth derivation)."""
    uniq = np.unique(instances)
    remap = np.zeros(uniq.max() + 1, np.int32)
    remap[uniq] = np.arange(len(uniq))
    inst_c = remap[instances]
    K = len(uniq)
    per_sem = np.zeros(K, np.int32)
    per_c = np.zeros((K, 3), np.float32)
    per_b = np.zeros((K, 3), np.float32)
    per_r = np.zeros(K, np.float32)
    bb_centers = np.zeros((len(positions), 3), np.float32)
    bb_bounds = np.zeros((len(positions), 3), np.float32)
    centers = np.zeros((len(positions), 3), np.float32)
    for i in range(K):
        m = inst_c == i
        p = positions[m]
        mx, mn = p.max(0), p.min(0)
        c = (mx + mn) / 2
        per_sem[i] = semantics[m][0]
        per_c[i] = c
        per_b[i] = mx - c
        per_r[i] = np.linalg.norm(p - c, axis=1).max()
        bb_centers[m] = c
        bb_bounds[m] = mx - c
        centers[m] = p.mean(0)
    useg = np.unique(segments)
    seg2inst = np.zeros(useg.max() + 1, np.int32)
    for s in useg:
        seg2inst[s] = inst_c[segments == s][0]
    return {
        'semantics': semantics, 'instances': inst_c, 'centers': centers,
        'center_distances': np.zeros(len(positions), np.float32),
        'bb_centers': bb_centers, 'bb_offsets': bb_centers - positions,
        'bb_bounds': bb_bounds, 'seg2inst': seg2inst,
        'bb_center_distances': np.zeros((len(positions), 1), np.float32),
        'bb_radius': np.zeros((len(positions), 1), np.float32),
        'unique_instances': np.arange(K),
        'per_instance_semantics': per_sem,
        'per_instance_bb_centers': per_c,
        'per_instance_bb_bounds': per_b,
        'per_instance_bb_radius': per_r,
    }


# ------------------------------------------------------------- ARKitScenes
def _grid(origin, u, v, h, seg_size):
    u, v = np.asarray(u, np.float64), np.asarray(v, np.float64)
    nu = max(2, int(round(np.linalg.norm(u) / h)) + 1)
    nv = max(2, int(round(np.linalg.norm(v) / h)) + 1)
    a, b = np.linspace(0, 1, nu), np.linspace(0, 1, nv)
    verts = (np.asarray(origin, np.float64) + a[:, None, None] * u
             + b[None, :, None] * v).reshape(-1, 3)
    idx = np.arange(nu * nv).reshape(nu, nv)
    c00, c10 = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c11, c01 = idx[1:, 1:].ravel(), idx[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([c00, c10, c11], 1),
                            np.stack([c00, c11, c01], 1)])
    pu = max(1, int(round(seg_size / np.linalg.norm(u) * (nu - 1))))
    pv = max(1, int(round(seg_size / np.linalg.norm(v) * (nv - 1))))
    ia, ib = np.meshgrid(np.arange(nu) // pu, np.arange(nv) // pv,
                         indexing='ij')
    patch = (ia * (ib.max() + 1) + ib).ravel()
    return verts, faces, patch


def _box_faces(center, half, yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    hx, hy, hz = half
    local = [((-hx, -hy, hz), (2 * hx, 0, 0), (0, 2 * hy, 0)),
             ((hx, -hy, -hz), (0, 2 * hy, 0), (0, 0, 2 * hz)),
             ((-hx, hy, -hz), (0, -2 * hy, 0), (0, 0, 2 * hz)),
             ((-hx, -hy, -hz), (2 * hx, 0, 0), (0, 0, 2 * hz)),
             ((hx, hy, -hz), (-2 * hx, 0, 0), (0, 0, 2 * hz))]
    return [(R @ np.asarray(o) + center, R @ np.asarray(u), R @ np.asarray(v))
            for o, u, v in local]


def make_room(rng, n_vertices, n_objects, size=(8.0, 7.0, 2.6), yaw=True,
              seg_size=0.5):
    """A room of gridded surfaces: floor, four walls and `n_objects` boxes
    turned by a random yaw; mesh = {positions, faces, colors, segments}."""
    W, D, H = size
    rects = [[((0, 0, 0), (W, 0, 0), (0, D, 0))]]
    for o, u, v in (((0, 0, 0), (0, D, 0), (0, 0, H)),
                    ((W, D, 0), (0, -D, 0), (0, 0, H)),
                    ((W, 0, 0), (-W, 0, 0), (0, 0, H)),
                    ((0, D, 0), (W, 0, 0), (0, 0, H))):
        rects.append([(o, u, v)])
    placed = []
    for _ in range(n_objects):
        for _ in range(100):
            half = rng.uniform([0.2, 0.2, 0.2], [0.7, 0.6, 0.6])
            r = np.hypot(half[0], half[1])
            center = np.array([rng.uniform(r + 0.1, W - r - 0.1),
                               rng.uniform(r + 0.1, D - r - 0.1), half[2]])
            if all(np.hypot(*(center[:2] - p[:2])) > r + q + 0.1
                   for p, q in placed):
                break
        placed.append((center, r))
        theta = float(rng.uniform(0, np.pi)) if yaw else 0.0
        rects.append(_box_faces(center, half, theta))
    area = sum(np.linalg.norm(np.cross(u, v)) for fs in rects
               for _, u, v in fs)
    h = float(np.sqrt(area / n_vertices))
    pos, faces, segs, cols = [], [], [], []
    n = n_seg = 0
    for fs in rects:
        base = rng.uniform(0.15, 0.85, 3)
        for o, u, v in fs:
            vtx, f, patch = _grid(o, u, v, h, seg_size)
            pos.append(vtx)
            faces.append(f + n)
            segs.append(patch + n_seg)
            c = np.clip(base + rng.normal(0, 0.04, vtx.shape), 0, 1)
            cols.append(np.round(c * 255.0) / 255.0)
            n += len(vtx)
            n_seg += int(patch.max()) + 1
    _, segs = np.unique(np.concatenate(segs), return_inverse=True)
    pos = np.concatenate(pos)
    return {'positions': pos + rng.normal(0, 0.002, pos.shape),
            'faces': np.concatenate(faces).astype(np.int64),
            'colors': np.concatenate(cols),
            'segments': segs.astype(np.int64)}


def vertex_normals(positions, faces):
    """Area-weighted unit vertex normals (the ARKitScenes reader's)."""
    v = np.asarray(positions, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    normals = np.zeros_like(v)
    for k in range(3):
        normals += np.stack([np.bincount(f[:, k], weights=fn[:, d],
                                         minlength=len(v))
                             for d in range(3)], 1)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)


def arkit_scene(seed, name, n_vertices=300_000, n_objects=10,
                room_size=(8.0, 7.0, 2.6), subsample_rate=2):
    """(scene, None): an ARKitScenes room as its reader gives it in test
    mode (no labels)."""
    rng = np.random.default_rng(seed)
    mesh = make_room(rng, n_vertices, n_objects, size=tuple(room_size))
    normals = vertex_normals(mesh['positions'], mesh['faces'])
    r = subsample_rate
    return {'name': name,
            'positions': mesh['positions'][::r].copy(),
            'normals': normals[::r].copy(),
            'colors': mesh['colors'][::r].copy(),
            'segments': mesh['segments'][::r].astype(np.int32)}, None


GENERATORS = {'scannet_scene': scannet_scene, 'arkit_scene': arkit_scene}


# ------------------------------------------------------------ augmentation
MIX3D_COLOR_MEAN = (0.47793125906962, 0.4303257521323044, 0.3749598901421883)
MIX3D_COLOR_STD = (0.2834475483823543, 0.27566157565723015,
                   0.27018971370874995)


def _rotation_z(rz):
    c, s = np.cos(rz), np.sin(rz)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])


def _rotate_about_center(positions, R):
    center = positions.mean(axis=0)
    return (positions - center) @ R.T + center


def _rgb_to_hsv_cv(rgb_u8):
    rgb = rgb_u8.astype(np.float32) / 255.0
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.zeros_like(mx)
    nz = diff > 0
    rmax = nz & (mx == r)
    gmax = nz & (mx == g) & ~rmax
    bmax = nz & ~rmax & ~gmax
    h[rmax] = (60 * (g - b) / np.maximum(diff, 1e-12))[rmax] % 360
    h[gmax] = (60 * (b - r) / np.maximum(diff, 1e-12) + 120)[gmax]
    h[bmax] = (60 * (r - g) / np.maximum(diff, 1e-12) + 240)[bmax]
    s = np.where(mx > 0, diff / np.maximum(mx, 1e-12), 0)
    return h / 2.0, s * 255.0, mx * 255.0


def _hsv_to_rgb_cv(h, s, v):
    h = h * 2.0 / 60.0
    s = s / 255.0
    v = v / 255.0
    i = np.floor(h).astype(int) % 6
    f = h - np.floor(h)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.clip(np.stack([r, g, b], -1) * 255.0, 0, 255)


def _hue_aug(colors01, rng):
    """HueSaturationValue, then RandomBrightnessContrast and RGBShift (each
    p=.5) on the u8 image, then the fixed mean / std normalisation."""
    h, s, v = _rgb_to_hsv_cv((colors01 * 255).astype(np.uint8))
    h = (h + rng.uniform(-50, 50)) % 180.0
    s = np.clip(s + rng.uniform(-60, 60), 0, 255)
    v = np.clip(v + rng.uniform(-50, 50), 0, 255)
    img = _hsv_to_rgb_cv(h, s, v).astype(np.uint8).astype(np.float32)
    if rng.random() < 0.5:
        alpha = 1.0 + rng.uniform(-0.2, 0.2)
        beta = rng.uniform(-0.2, 0.2)
        img = np.clip(img * alpha + beta * 255.0, 0, 255)
    if rng.random() < 0.5:
        shift = np.array([rng.uniform(-20, 20) for _ in range(3)], np.float32)
        img = np.clip(img + shift, 0, 255)
    mean = np.asarray(MIX3D_COLOR_MEAN, np.float32) * 255.0
    std = np.asarray(MIX3D_COLOR_STD, np.float32) * 255.0
    return (img - mean) / std


def augment(scene, aug, rng):
    """The preset's augmentation of one scene, drawn from `rng` (a
    np.random.RandomState) in the order of the program's augment_scene:
    `aug` holds rotation_90_aug, flipping_aug, scaling_aug [p, lo, hi] and
    apply_hue_aug. Transforms a preset here leaves off (probability 0)
    still take their draw, so the stream stays aligned."""
    pos = scene['positions']
    rng.rand()                                  # rotation_aug, p = 0
    if aug['rotation_90_aug']:
        rz = [0, 0.5 * np.pi, np.pi, 1.5 * np.pi][rng.randint(0, 4)]
        pos = _rotate_about_center(pos, _rotation_z(rz))
    if rng.rand() < aug['flipping_aug']:
        pos = pos.copy()
        pos[:, 0] *= -1
    rng.rand()                                  # position_jittering, p = 0
    p, lo, hi = aug['scaling_aug']
    if rng.rand() < p:
        pos = pos * rng.uniform(lo, hi)
    for _ in range(4):      # auto contrast, translation, jitter, brightness
        rng.rand()
    colors = scene['colors']
    if aug['apply_hue_aug']:
        colors = _hue_aug(colors, rng)
    out = dict(scene)
    out['positions'] = pos
    out['colors'] = colors
    return out
