"""ctypes bindings for the native host ops (hostops.c): the port's copy of
box2mask_tpu/native/__init__.py:21-98, native_voxelize and
native_unpack_masks.

The library builds with `cc` at first use into `box2mask_torch/build/`
under a name that carries a hash of the source and the compile command (as
sparse/_build.py names the CUDA libraries), and loads once per process. A
failed build raises with the compiler's output: when the caller asked for
the native ops (`--use_native_host_ops`, on by default) nothing drops to
NumPy behind its back. The NumPy paths (datasets/voxelize.py,
postprocess/device_post.py) are the plain versions, taken only when
`cfg.use_native_host_ops` is False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, 'hostops.c')
BUILD_DIR = os.path.join(os.path.dirname(_DIR), 'build')
CFLAGS = ['-O3', '-shared', '-fPIC']

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_lib = None
_lock = threading.Lock()


def library_path():
    """The build target: build/libhostops_<hash of source and flags>.so."""
    h = hashlib.sha1(' '.join(CFLAGS).encode())
    with open(SRC, 'rb') as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f'libhostops_{h.hexdigest()[:12]}.so')


def _build(so):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    try:
        proc = subprocess.run(['cc'] + CFLAGS + ['-o', tmp, SRC, '-lm'],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'native host ops: cannot run cc ({e}); the '
                           'C compiler is required while '
                           'use_native_host_ops is on') from e
    if proc.returncode != 0:
        raise RuntimeError(f'native host ops: cc failed building {SRC}:\n'
                           f'{proc.stderr}')
    os.replace(tmp, so)


def get_lib():
    """The loaded library, built if needed (raises when it cannot be)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            lib.b2m_voxelize.restype = ctypes.c_int32
            lib.b2m_voxelize.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
                _I32P, _I32P, _I32P]
            lib.b2m_unpack_masks.restype = None
            lib.b2m_unpack_masks.argtypes = [
                _U8P, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                _I32P, ctypes.c_int32, _U8P]
            _lib = lib
    return _lib


def native_voxelize(scaled_points):
    """(vox_coords (V,3) i32, vox2point (P,) i32, point2vox (V,) i32) of the
    points in voxel units: unique voxels in np.unique(axis=0) order, each
    voxel's nearest point (ties to the lowest index)."""
    lib = get_lib()
    pts = np.ascontiguousarray(scaled_points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f'points must be (P, 3), got {pts.shape}')
    P = len(pts)
    vox_coords = np.empty((P, 3), np.int32)
    vox2point = np.empty(P, np.int32)
    point2vox = np.empty(P, np.int32)
    V = lib.b2m_voxelize(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), P,
        vox_coords.ctypes.data_as(_I32P), vox2point.ctypes.data_as(_I32P),
        point2vox.ctypes.data_as(_I32P))
    if V < 0:
        raise MemoryError(f'native voxelize: allocation failed ({P} points)')
    return vox_coords[:V].copy(), vox2point, point2vox[:V].copy()


def native_unpack_masks(packed, base_byte, vox2point):
    """Point masks (R, P) uint8 from bit-packed voxel masks (R, stride):
    the bit of each point's voxel, voxel v at bit v of the row from byte
    `base_byte` on, in one C pass."""
    lib = get_lib()
    packed = np.ascontiguousarray(packed, np.uint8)
    v2p = np.ascontiguousarray(vox2point, np.int32)
    R, stride = packed.shape
    P = len(v2p)
    n_bits = (stride - int(base_byte)) * 8
    if P and (base_byte < 0 or v2p.min() < 0 or v2p.max() >= n_bits):
        raise ValueError(f'voxel index out of the {n_bits} mask bits from '
                         f'byte {base_byte}')
    out = np.empty((R, P), np.uint8)
    lib.b2m_unpack_masks(
        packed.ctypes.data_as(_U8P), R, stride, int(base_byte),
        v2p.ctypes.data_as(_I32P), P, out.ctypes.data_as(_U8P))
    return out
