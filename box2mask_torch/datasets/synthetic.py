"""Synthetic indoor scenes for tests and benchmarks (the port's copy of
box2mask_tpu/datasets/synthetic.py; the same seed gives the same scene).

Generates ScanNet-like rooms (floor + walls + box-shaped furniture instances with
oversegments and GT boxes) following the label contract of the readers
(reference dataprocessing/scannet.py:369-439): every scene/labels key a reader
produces is produced here too, so the whole pipeline downstream of the readers can
be exercised without dataset downloads (none ship with the reference either).
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.datasets.tables import SCANNET_INSTANCE_VALID_CLASS_IDS


def _box_surface_points(rng, center, half, n):
    """Sample n points on the surface of an axis-aligned box."""
    face = rng.integers(0, 6, n)
    u = rng.uniform(-1, 1, (n, 3))
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    u[np.arange(n), axis] = sign
    return center + u * half


def make_scene(seed=0, num_instances=8, points_per_instance=600,
               room_size=(6.0, 5.0, 2.6), floor_points=3000, wall_points=2200,
               segs_per_instance=3, name=None):
    """Returns (scene, labels) dicts mirroring scannet.process_scene's contract."""
    rng = np.random.default_rng(seed)
    W, D, H = room_size
    pos, col, sem, inst, segs = [], [], [], [], []
    seg_counter = 0

    def add(points, color, sem_id, inst_id, nsegs):
        nonlocal seg_counter
        n = len(points)
        pos.append(points)
        # quantize to the u8 grid like real PLY colors (u8/255 -> float) so
        # the compact wire codec (engine/hostload.py u8x255) applies exactly
        c = np.clip(color + rng.normal(0, 0.03, (n, 3)), 0, 1)
        col.append(np.round(c * 255.0) / 255.0)
        sem.append(np.full(n, sem_id, np.int32))
        inst.append(np.full(n, inst_id, np.int32))
        # spatial oversegmentation: k-means-ish split by random projections
        if nsegs <= 1:
            s = np.full(n, seg_counter, np.int32)
            seg_counter += 1
        else:
            proj = points @ rng.normal(size=(3,))
            qs = np.quantile(proj, np.linspace(0, 1, nsegs + 1)[1:-1])
            s = (np.searchsorted(qs, proj) + seg_counter).astype(np.int32)
            seg_counter += nsegs
        segs.append(s)

    # floor (sem 2, instance 1) and walls (sem 1, one instance each)
    fp = np.stack([rng.uniform(0, W, floor_points), rng.uniform(0, D, floor_points),
                   np.abs(rng.normal(0, 0.01, floor_points))], 1)
    add(fp, np.array([0.5, 0.4, 0.3]), 2, 1, 6)
    next_inst = 2
    for wall in range(2):
        n = wall_points // 2
        if wall == 0:
            wp = np.stack([np.abs(rng.normal(0, 0.01, n)), rng.uniform(0, D, n),
                           rng.uniform(0, H, n)], 1)
        else:
            wp = np.stack([rng.uniform(0, W, n), np.abs(rng.normal(0, 0.01, n)),
                           rng.uniform(0, H, n)], 1)
        add(wp, np.array([0.7, 0.7, 0.65]), 1, next_inst, 4)
        next_inst += 1

    # furniture instances — rejection-sampled so boxes don't overlap (real
    # rooms rarely have interpenetrating furniture; overlapping GT boxes
    # also make the weak box->segment association ambiguous and merge the
    # IoU-heatmap masks of distinct instances, which no trained model can fix)
    placed = []
    for i in range(num_instances):
        sem_id = int(rng.choice(SCANNET_INSTANCE_VALID_CLASS_IDS))
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
        add(pts, rng.uniform(0.1, 0.9, 3), sem_id, next_inst, segs_per_instance)
        next_inst += 1

    positions = np.concatenate(pos).astype(np.float64)
    colors = np.concatenate(col).astype(np.float64)
    semantics = np.concatenate(sem)
    instances = np.concatenate(inst)
    segments = np.concatenate(segs)

    # fake unit normals (synthetic points carry no mesh)
    normals = rng.normal(size=positions.shape)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)

    scene = {'name': name or f'synth{seed:04d}_00', 'positions': positions,
             'normals': normals, 'colors': colors, 'segments': segments}
    labels = derive_labels(positions, semantics, instances, segments)
    return scene, labels


def derive_labels(positions, semantics, instances, segments):
    """Instance boxes/centers + seg2inst, matching the reader-side GT derivation
    (reference scannet.py:304-367 compute_avg_centers/compute_bounding_box)."""
    uniq = np.unique(instances)
    # remap instance ids to 0..K-1 contiguous (reference asserts contiguity)
    remap = {v: i for i, v in enumerate(uniq)}
    inst_c = np.array([remap[v] for v in instances], np.int32)
    K = len(uniq)
    per_instance_semantics = np.zeros(K, np.int32)
    per_instance_bb_centers = np.zeros((K, 3), np.float32)
    per_instance_bb_bounds = np.zeros((K, 3), np.float32)
    per_instance_bb_radius = np.zeros(K, np.float32)
    bb_centers = np.zeros((len(positions), 3), np.float32)
    bb_bounds = np.zeros((len(positions), 3), np.float32)
    centers = np.zeros((len(positions), 3), np.float32)
    for i in range(K):
        m = inst_c == i
        p = positions[m]
        mx, mn = p.max(0), p.min(0)
        c = (mx + mn) / 2
        per_instance_semantics[i] = semantics[m][0]
        per_instance_bb_centers[i] = c
        per_instance_bb_bounds[i] = mx - c
        per_instance_bb_radius[i] = np.linalg.norm(p - c, axis=1).max()
        bb_centers[m] = c
        bb_bounds[m] = mx - c
        centers[m] = p.mean(0)

    useg = np.unique(segments)
    seg2inst = np.zeros(useg.max() + 1, np.int32)
    for s in useg:
        seg2inst[s] = inst_c[segments == s][0]

    return {
        'semantics': semantics, 'instances': inst_c,
        'centers': centers, 'center_distances': np.zeros(len(positions), np.float32),
        'bb_centers': bb_centers, 'bb_offsets': bb_centers - positions,
        'bb_bounds': bb_bounds, 'seg2inst': seg2inst,
        'bb_center_distances': np.zeros((len(positions), 1), np.float32),
        'bb_radius': np.zeros((len(positions), 1), np.float32),
        'unique_instances': np.arange(K),
        'per_instance_semantics': per_instance_semantics,
        'per_instance_bb_centers': per_instance_bb_centers,
        'per_instance_bb_bounds': per_instance_bb_bounds,
        'per_instance_bb_radius': per_instance_bb_radius,
    }


def scannet_scale_batches(cfg, n_batches, batch_size=4, seed0=1000,
                          mode='test'):
    """Batches of unique ScanNet-val-scale synthetic scenes (~120k voxels at
    2 cm; the recipe of the JAX package's bench.py), built with the port's
    host code in `mode` (which, under --key_conv eval, picks the conv path).
    Returns a list of (dev, host) from datasets/batching."""
    from box2mask_torch.datasets import batching, voxelize
    out = []
    for b in range(n_batches):
        rets = []
        for i in range(batch_size):
            scene, _ = make_scene(
                seed=seed0 + b * batch_size + i, num_instances=18,
                points_per_instance=4000, floor_points=45000,
                wall_points=35000, segs_per_instance=6)
            rets.append(voxelize.voxelize_scene(scene, cfg))
        out.append(batching.build_batch(rets, cfg, mode=mode))
    return out
