"""Minimal NumPy PLY reader/writer (the port's copy of
box2mask_tpu/datasets/ply.py; replaces open3d's IO used throughout the
reference, e.g. dataprocessing/scannet.py:147, models/evaluation.py:532-615).

Supports ascii and binary_little_endian, vertex properties (xyz, rgb[a],
normals, arbitrary scalars) and triangle faces with uchar-count vertex index
lists. Vectorized reads via np.frombuffer with a structured dtype.
"""

from __future__ import annotations

import numpy as np

_PLY_TYPES = {
    'char': 'i1', 'int8': 'i1', 'uchar': 'u1', 'uint8': 'u1',
    'short': 'i2', 'int16': 'i2', 'ushort': 'u2', 'uint16': 'u2',
    'int': 'i4', 'int32': 'i4', 'uint': 'u4', 'uint32': 'u4',
    'float': 'f4', 'float32': 'f4', 'double': 'f8', 'float64': 'f8',
}


def read_ply(path):
    """Returns {'vertex': structured array, 'face': (F,3) int array or None}."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'ply':
            raise ValueError(f'{path}: not a PLY file')
        fmt = None
        elements = []          # (name, count, [(prop_name, dtype)| list-prop])
        while True:
            line = f.readline()
            if not line:
                raise ValueError('unexpected EOF in header')
            tok = line.decode('ascii', 'replace').strip().split()
            if not tok or tok[0] == 'comment':
                continue
            if tok[0] == 'format':
                fmt = tok[1]
            elif tok[0] == 'element':
                elements.append([tok[1], int(tok[2]), []])
            elif tok[0] == 'property':
                if tok[1] == 'list':
                    elements[-1][2].append((tok[4], 'list',
                                            _PLY_TYPES[tok[2]],
                                            _PLY_TYPES[tok[3]]))
                else:
                    elements[-1][2].append((tok[2], _PLY_TYPES[tok[1]]))
            elif tok[0] == 'end_header':
                break
        out = {}
        if fmt == 'ascii':
            text = f.read().decode('ascii').split('\n')
            cursor = 0
            for name, count, props in elements:
                rows = text[cursor:cursor + count]
                cursor += count
                if any(len(p) == 4 for p in props):  # list property (faces)
                    faces = [np.fromstring(r, sep=' ')[1:].astype(np.int64)
                             if hasattr(np, 'fromstring')
                             else np.array(r.split()[1:], np.int64)
                             for r in rows]
                    out[name] = np.array(
                        [fc[:3] for fc in faces], np.int64) if faces else None
                else:
                    dt = np.dtype([(p[0], p[1]) for p in props])
                    arr = np.array([tuple(np.array(r.split(), np.float64))
                                    for r in rows])
                    st = np.zeros(count, dt)
                    for i, p in enumerate(props):
                        st[p[0]] = arr[:, i].astype(dt[p[0]])
                    out[name] = st
        elif fmt == 'binary_little_endian':
            for name, count, props in elements:
                if any(len(p) == 4 for p in props):
                    # assume constant list length 3 (triangle meshes); verify
                    cprop = props[0]
                    cdt = np.dtype('<' + cprop[2])
                    idt = np.dtype('<' + cprop[3])
                    first = np.frombuffer(f.read(cdt.itemsize), cdt)[0]
                    if first != 3:
                        raise ValueError('only triangle faces supported')
                    row = np.dtype([('n', cdt), ('v', idt, (3,))])
                    f.seek(-cdt.itemsize, 1)
                    data = np.frombuffer(f.read(row.itemsize * count), row)
                    if not (data['n'] == 3).all():
                        raise ValueError('only triangle faces supported')
                    out[name] = data['v'].astype(np.int64)
                else:
                    dt = np.dtype([(p[0], '<' + p[1]) for p in props])
                    out[name] = np.frombuffer(f.read(dt.itemsize * count), dt)
        else:
            raise ValueError(f'unsupported PLY format {fmt}')
    out.setdefault('face', None)
    return out


def read_mesh(path):
    """-> (positions (N,3) f64, colors (N,3) f64 in [0,1] or None,
    faces (F,3) i64 or None)."""
    data = read_ply(path)
    v = data['vertex']
    pos = np.stack([v['x'], v['y'], v['z']], axis=1).astype(np.float64)
    colors = None
    names = v.dtype.names
    if 'red' in names:
        colors = np.stack([v['red'], v['green'], v['blue']], 1)
        if v.dtype['red'].kind == 'u':
            colors = colors.astype(np.float64) / 255.0
    return pos, colors, data.get('face')


def write_ply_points(path, positions, colors=None):
    """Binary point-cloud PLY (uchar RGB). Colors in [0,1] or [0,255]."""
    n = len(positions)
    with open(path, 'wb') as f:
        header = ['ply', 'format binary_little_endian 1.0',
                  f'element vertex {n}',
                  'property float x', 'property float y', 'property float z']
        if colors is not None:
            header += ['property uchar red', 'property uchar green',
                       'property uchar blue']
        header += ['end_header']
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        if colors is not None:
            c = np.asarray(colors)
            if c.max() <= 1.0 + 1e-6:
                c = c * 255.0
            dt = np.dtype([('x', '<f4'), ('y', '<f4'), ('z', '<f4'),
                           ('r', 'u1'), ('g', 'u1'), ('b', 'u1')])
            rec = np.zeros(n, dt)
            rec['x'], rec['y'], rec['z'] = positions.T.astype(np.float32)
            rec['r'], rec['g'], rec['b'] = np.clip(c, 0, 255).astype(np.uint8).T
        else:
            rec = np.zeros(n, np.dtype([('x', '<f4'), ('y', '<f4'),
                                        ('z', '<f4')]))
            rec['x'], rec['y'], rec['z'] = positions.T.astype(np.float32)
        f.write(rec.tobytes())


def write_ply_mesh(path, positions, faces, colors=None):
    n, m = len(positions), len(faces)
    with open(path, 'wb') as f:
        header = ['ply', 'format binary_little_endian 1.0',
                  f'element vertex {n}',
                  'property float x', 'property float y', 'property float z']
        if colors is not None:
            header += ['property uchar red', 'property uchar green',
                       'property uchar blue']
        header += [f'element face {m}',
                   'property list uchar int vertex_indices', 'end_header']
        f.write(('\n'.join(header) + '\n').encode('ascii'))
        if colors is not None:
            c = np.asarray(colors)
            if c.max() <= 1.0 + 1e-6:
                c = c * 255.0
            dt = np.dtype([('x', '<f4'), ('y', '<f4'), ('z', '<f4'),
                           ('r', 'u1'), ('g', 'u1'), ('b', 'u1')])
            rec = np.zeros(n, dt)
            rec['x'], rec['y'], rec['z'] = positions.T.astype(np.float32)
            rec['r'], rec['g'], rec['b'] = np.clip(c, 0, 255).astype(np.uint8).T
        else:
            dt = np.dtype([('x', '<f4'), ('y', '<f4'), ('z', '<f4')])
            rec = np.zeros(n, dt)
            rec['x'], rec['y'], rec['z'] = positions.T.astype(np.float32)
        f.write(rec.tobytes())
        fdt = np.dtype([('n', 'u1'), ('v', '<i4', (3,))])
        frec = np.zeros(m, fdt)
        frec['n'] = 3
        frec['v'] = np.asarray(faces, np.int32)
        f.write(frec.tobytes())


def compute_vertex_normals(positions, faces):
    """Area-weighted vertex normals, unit length (open3d
    compute_vertex_normals + normalize_normals equivalent,
    dataprocessing/scannet.py:215-217)."""
    v = np.asarray(positions, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    normals = np.zeros_like(v)
    for k in range(3):
        np.add.at(normals, f[:, k], fn)
    norm = np.linalg.norm(normals, axis=1, keepdims=True)
    return normals / np.maximum(norm, 1e-12)
