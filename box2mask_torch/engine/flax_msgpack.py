"""A decoder of flax's msgpack serialization, in pure Python (no msgpack
package): what `flax.serialization.to_bytes` writes and the JAX package's
checkpoints carry (box2mask_tpu/engine/checkpoint.py:38-53: the params,
batch stats and optimizer state of a run, each one msgpack blob).

`restore(data)` returns the state dict as flax's `msgpack_restore` does:
nested dicts (a tuple or namedtuple of the tree was written as a dict keyed
'0', '1', ... or by field name), numpy arrays for array leaves, Python
scalars, str, bytes and None. It reads

  * the msgpack types flax writes: maps, arrays (as lists), str, bin, ints,
    floats, bool and nil;
  * ext type 1, an ndarray: a packed (shape, dtype name, C-order buffer).
    A `bfloat16` buffer comes back as a torch.bfloat16 tensor (numpy has no
    bfloat16; the buffer is viewed as uint16 and then as torch.bfloat16);
  * ext type 2, a complex scalar packed as (real, imag);
  * ext type 3, a numpy scalar: an ndarray of shape () unpacked to a numpy
    scalar;
  * the '__msgpack_chunked_array__' dicts that flax writes for an array
    past its MAX_CHUNK_SIZE (2**30 bytes): {'shape': {'0': n, ...},
    'chunks': {'0': flat part, ...}}, joined back into one array.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = '__msgpack_chunked_array__'

# fixed-size scalars: tag -> struct format (big-endian)
_SCALARS = {0xca: '>f', 0xcb: '>d', 0xcc: '>B', 0xcd: '>H', 0xce: '>I',
            0xcf: '>Q', 0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
# length-prefixed types: tag -> (kind, struct format of the length)
_SIZED = {0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
          0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I'),
          0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
          0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
          0xde: ('map', '>H'), 0xdf: ('map', '>I')}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError('msgpack data ends early')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        tag = self.take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8f:
            return self._map(tag & 0x0f)
        if 0x90 <= tag <= 0x9f:
            return self._array(tag & 0x0f)
        if 0xa0 <= tag <= 0xbf:
            return str(self.take(tag & 0x1f), 'utf-8')
        if tag == 0xc0:
            return None
        if tag in (0xc2, 0xc3):
            return tag == 0xc3
        if tag in _SCALARS:
            return self.unpack(_SCALARS[tag])
        if tag in _FIXEXT:
            code = self.unpack('>b')
            return _ext(code, self.take(_FIXEXT[tag]))
        if tag in _SIZED:
            kind, fmt = _SIZED[tag]
            n = self.unpack(fmt)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'str':
                return str(self.take(n), 'utf-8')
            if kind == 'array':
                return self._array(n)
            if kind == 'map':
                return self._map(n)
            code = self.unpack('>b')
            return _ext(code, self.take(n))
        raise ValueError(f'msgpack tag 0x{tag:02x} at byte {self.pos - 1}')

    def _array(self, n):
        return [self.value() for _ in range(n)]

    def _map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data):
    """One msgpack object from `data` (bytes), ext types decoded."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError(f'{len(r.buf) - r.pos} bytes after the msgpack '
                         'object')
    return out


def _ndarray(data):
    shape, dtype, buf = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == 'bfloat16':
        a = np.frombuffer(buf, dtype='<u2').astype(np.uint16)
        return torch.from_numpy(a).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code, data):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        a = _ndarray(data)
        return a.reshape(()).clone() if torch.is_tensor(a) else a[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f'msgpack ext type {code} is not one flax writes')


def _unchunk(d):
    shape = tuple(d['shape'][str(i)] for i in range(len(d['shape'])))
    parts = [d['chunks'][str(i)] for i in range(len(d['chunks']))]
    if torch.is_tensor(parts[0]):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk_tree(t):
    if isinstance(t, dict):
        if CHUNKED in t:
            return _unchunk(t)
        return {k: _unchunk_tree(v) for k, v in t.items()}
    return t


def restore(data):
    """The state dict in flax msgpack bytes `data` (flax's msgpack_restore)."""
    return _unchunk_tree(unpackb(data))
