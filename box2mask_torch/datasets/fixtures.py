"""On-disk datasets in the layouts the three readers read, made from a seed:
rooms of gridded surfaces (floor, walls, a ceiling for S3DIS, box-shaped
objects) written as the ScanNet v2, ARKitScenes and S3DIS files. For tests
and `chip_smoke.py`; no dataset ships with the repository.

  write_scannet(root, ...)      scans/<scene>/<scene>_vh_clean_2.ply, .txt
                                (axisAlignment), .aggregation.json,
                                _vh_clean_2.0.010000.segs.json;
                                scannetv2-labels.combined.tsv; split.npz
  write_arkitscenes(root, ...)  3dod/{Training,Validation}/<id>/
                                <id>_3dod_mesh.ply, _3dod_annotation.json
                                (obbAligned boxes); 3dod/segmented_{train,
                                val}_clean/<id>_3dod_mesh.0.010000.segs.json
  write_s3dis(root, ...)        Area_<a>/<room>.normals.instance.npy;
                                segment_labels/learned_superpoint_graph_
                                segmentations/Area_<a>.<room>.npy

Surfaces are grids of vertices at one spacing, chosen so that a room holds
about the vertex (or point) count asked for, moved by 2 mm of noise (no
surface of a scan is a plane); each grid patch of about `seg_size` metres
is one segment.
"""

from __future__ import annotations

import json
import os

import numpy as np

from box2mask_torch.datasets import tables
from box2mask_torch.datasets.ply import write_ply_mesh

SCANNET_LABELS = dict(zip(tables.SCANNET_SEMANTIC_CLASS_LABELS,
                          tables.SCANNET_SEMANTIC_VALID_CLASS_IDS.tolist()))
SCANNET_OBJECTS = [n for n in tables.SCANNET_INSTANCE_CLASS_LABELS
                   if n not in ('door', 'window', 'picture', 'curtain',
                                'shower curtain')]
ARKIT_OBJECTS = sorted(tables.ARKITSCENES_NAME2ID)
S3DIS_OBJECTS = [3, 4, 7, 8, 9, 10, 12]     # beam ... clutter (no boards)


def _grid(origin, u, v, h, seg_size):
    """A gridded rectangle origin + a*u + b*v, a, b in [0, 1]: vertices
    (n, 3), faces (f, 3) (two triangles per cell, counter-clockwise seen
    along u x v), patch ids (n,) of seg_size-metre patches."""
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
    """The five visible faces (top and four sides) of a box turned by yaw
    about z, as (origin, u, v) with u x v pointing out."""
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    hx, hy, hz = half
    local = [((-hx, -hy, hz), (2 * hx, 0, 0), (0, 2 * hy, 0)),     # top
             ((hx, -hy, -hz), (0, 2 * hy, 0), (0, 0, 2 * hz)),     # +x
             ((-hx, hy, -hz), (0, -2 * hy, 0), (0, 0, 2 * hz)),    # -x
             ((-hx, -hy, -hz), (2 * hx, 0, 0), (0, 0, 2 * hz)),    # -y
             ((hx, hy, -hz), (-2 * hx, 0, 0), (0, 0, 2 * hz))]     # +y
    return [(R @ np.asarray(o) + center, R @ np.asarray(u), R @ np.asarray(v))
            for o, u, v in local]


def make_room(rng, n_vertices, n_objects, size=(6.0, 5.0, 2.6),
              ceiling=False, yaw=False, seg_size=0.5):
    """A room of gridded surfaces. Returns (mesh, parts): mesh = dict of
    positions (n, 3), faces (f, 3), normals (n, 3), colors (n, 3) on the
    u8 grid in [0, 1], segments (n,) 0..S-1, instances (n,) 0..K-1;
    parts = [(kind, center, half, yaw)] per instance, kind one of 'floor',
    'ceiling', 'wall' or 'object'."""
    W, D, H = size
    rects, parts = [], []
    rects.append([((0, 0, 0), (W, 0, 0), (0, D, 0))])            # floor, up
    parts.append(('floor', np.array([W / 2, D / 2, 0]),
                  np.array([W / 2, D / 2, 0.0]), 0.0))
    if ceiling:
        rects.append([((0, D, H), (W, 0, 0), (0, -D, 0))])       # down
        parts.append(('ceiling', np.array([W / 2, D / 2, H]),
                      np.array([W / 2, D / 2, 0.0]), 0.0))
    for o, u, v, c, hf in (((0, 0, 0), (0, D, 0), (0, 0, H), (0, D / 2),
                            (0, D / 2)),
                           ((W, D, 0), (0, -D, 0), (0, 0, H), (W, D / 2),
                            (0, D / 2)),
                           ((W, 0, 0), (-W, 0, 0), (0, 0, H), (W / 2, 0),
                            (W / 2, 0)),
                           ((0, D, 0), (W, 0, 0), (0, 0, H), (W / 2, D),
                            (W / 2, 0))):
        rects.append([(o, u, v)])
        parts.append(('wall', np.array([c[0], c[1], H / 2]),
                      np.array([hf[0], hf[1], H / 2]), 0.0))
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
        parts.append(('object', center, half, theta))

    area = sum(np.linalg.norm(np.cross(u, v)) for fs in rects
               for _, u, v in fs)
    h = float(np.sqrt(area / n_vertices))
    pos, faces, normals, segs, inst, cols = [], [], [], [], [], []
    n = n_seg = 0
    for k, fs in enumerate(rects):
        base = rng.uniform(0.15, 0.85, 3)
        for o, u, v in fs:
            vtx, f, patch = _grid(o, u, v, h, seg_size)
            nrm = np.cross(u, v)
            pos.append(vtx)
            faces.append(f + n)
            normals.append(np.broadcast_to(nrm / np.linalg.norm(nrm),
                                           vtx.shape))
            segs.append(patch + n_seg)
            inst.append(np.full(len(vtx), k))
            c = np.clip(base + rng.normal(0, 0.04, vtx.shape), 0, 1)
            cols.append(np.round(c * 255.0) / 255.0)
            n += len(vtx)
            n_seg += int(patch.max()) + 1
    segs = np.concatenate(segs)
    _, segs = np.unique(segs, return_inverse=True)        # 0..S-1
    pos = np.concatenate(pos)
    mesh = {'positions': pos + rng.normal(0, 0.002, pos.shape),  # scan noise
            'faces': np.concatenate(faces).astype(np.int64),
            'normals': np.concatenate(normals),
            'colors': np.concatenate(cols),
            'segments': segs.astype(np.int64),
            'instances': np.concatenate(inst).astype(np.int64)}
    return mesh, parts


def _segments_json(path, segments):
    with open(path, 'w') as f:
        json.dump({'segIndices': segments.tolist()}, f)


def write_scannet(root, names, n_vertices=150_000, n_objects=12, seed=0,
                  split=None):
    """ScanNet v2 scenes under root (the --data_dir). `split` maps split
    name -> scene names for the npz written at root/split.npz (default:
    every scene in 'val'); returns that path, the --data_split."""
    rng = np.random.default_rng(seed)
    labels = dict(SCANNET_LABELS)
    with open(os.path.join(root, 'scannetv2-labels.combined.tsv'), 'w') as f:
        f.write('id\traw_category\tcategory\tcount\tnyu40id\n')
        for i, (name, nyu) in enumerate(labels.items()):
            f.write(f'{i + 1}\t{name}\t{name}\t10\t{nyu}\n')
    for name in names:
        d = os.path.join(root, 'scans', name)
        os.makedirs(d, exist_ok=True)
        mesh, parts = make_room(rng, n_vertices, n_objects)
        # the scan's own frame: turned by a multiple of 90 degrees and
        # shifted; the scene txt holds the alignment back
        k = int(rng.integers(4))
        c, s = np.cos(k * np.pi / 2), np.sin(k * np.pi / 2)
        align = np.eye(4)
        align[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        align[:3, 3] = rng.uniform(-2, 2, 3)
        inv = np.linalg.inv(align)
        raw = mesh['positions'] @ inv[:3, :3].T + inv[:3, 3]
        write_ply_mesh(os.path.join(d, f'{name}_vh_clean_2.ply'), raw,
                       mesh['faces'], mesh['colors'])
        with open(os.path.join(d, f'{name}.txt'), 'w') as f:
            f.write('axisAlignment = '
                    + ' '.join(repr(float(x)) for x in align.ravel()) + '\n')
        _segments_json(os.path.join(d, f'{name}_vh_clean_2.0.010000.'
                                        'segs.json'), mesh['segments'])
        groups = []
        for i, (kind, *_) in enumerate(parts):
            label = (kind if kind in ('floor', 'wall') else
                     SCANNET_OBJECTS[int(rng.integers(len(SCANNET_OBJECTS)))])
            segs = np.unique(mesh['segments'][mesh['instances'] == i])
            groups.append({'id': i, 'label': label,
                           'segments': segs.tolist()})
        with open(os.path.join(d, f'{name}.aggregation.json'), 'w') as f:
            json.dump({'sceneId': name, 'segGroups': groups}, f)
    split = split or {'val': list(names)}
    path = os.path.join(root, 'split.npz')
    np.savez(path, **{k: np.array(v) for k, v in split.items()})
    return path


def write_arkitscenes(root, names, split='Validation', n_vertices=300_000,
                      n_objects=10, seed=0, size=(8.0, 7.0, 2.6)):
    """ARKitScenes scenes (ids starting with 4) of one split ('Training'
    or 'Validation') under root: the mesh of a room of `size` (x, y, z
    metres), its oriented-box annotations of the objects (walls and floor
    are not annotated, as in the dataset) and its segments."""
    rng = np.random.default_rng(seed)
    seg_dir = os.path.join(root, '3dod', {'Training': 'segmented_train_clean',
                                          'Validation': 'segmented_val_clean'
                                          }[split])
    os.makedirs(seg_dir, exist_ok=True)
    for name in names:
        d = os.path.join(root, '3dod', split, name)
        os.makedirs(d, exist_ok=True)
        mesh, parts = make_room(rng, n_vertices, n_objects, size=size,
                                yaw=True)
        write_ply_mesh(os.path.join(d, f'{name}_3dod_mesh.ply'),
                       mesh['positions'], mesh['faces'], mesh['colors'])
        _segments_json(os.path.join(seg_dir, f'{name}_3dod_mesh.0.010000.'
                                             'segs.json'), mesh['segments'])
        data = []
        for kind, center, half, yaw in parts:
            if kind != 'object':
                continue
            c, s = np.cos(yaw), np.sin(yaw)
            rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]]).T
            data.append({'label': ARKIT_OBJECTS[int(rng.integers(
                len(ARKIT_OBJECTS)))], 'segments': {'obbAligned': {
                    'normalizedAxes': rot.ravel().tolist(),
                    'centroid': center.tolist(),
                    'axesLengths': (2 * half).tolist()}}})
        with open(os.path.join(d, f'{name}_3dod_annotation.json'), 'w') as f:
            json.dump({'data': data, 'stats': {}}, f)


def write_s3dis(root, names, n_points=1_000_000, n_objects=10, seed=0):
    """S3DIS rooms named 'Area_<a>.<room>' under root: the point cloud with
    colours, normals, semantics and instances (float32 columns), and its
    learned-superpoint segmentation."""
    rng = np.random.default_rng(seed)
    seg_dir = os.path.join(root, 'segment_labels',
                           'learned_superpoint_graph_segmentations')
    os.makedirs(seg_dir, exist_ok=True)
    for name in names:
        area, room = name.split('.', 1)
        os.makedirs(os.path.join(root, area), exist_ok=True)
        mesh, parts = make_room(rng, n_points, n_objects,
                                size=(7.0, 6.0, 3.0), ceiling=True)
        sem_of = {'ceiling': 0, 'floor': 1, 'wall': 2}
        inst_sem = np.array([sem_of.get(kind) if kind in sem_of else
                             S3DIS_OBJECTS[int(rng.integers(
                                 len(S3DIS_OBJECTS)))]
                             for kind, *_ in parts])
        pos = mesh['positions']
        inst = mesh['instances']
        sem = inst_sem[inst]
        data = np.concatenate([pos, mesh['colors'] * 255.0, mesh['normals'],
                               sem[:, None], inst[:, None]], 1)
        np.save(os.path.join(root, area, room + '.normals.instance.npy'),
                data.astype(np.float32))
        segs = mesh['segments']
        seg2inst = np.zeros(int(segs.max()) + 1, np.int64)
        seg2inst[segs] = inst
        info = {'segments': segs,
                'per_point_segment_instanceID': seg2inst[segs],
                'per_point_segment_semanticID': inst_sem[seg2inst[segs]],
                'seg2instanceID': seg2inst,
                'seg2semanticID': inst_sem[seg2inst]}
        np.save(os.path.join(seg_dir, name + '.npy'),
                np.array(info, dtype=object))
