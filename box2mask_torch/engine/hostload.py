"""Single-buffer host->device batch upload with lossless compact wire codecs
(the port of box2mask_tpu/engine/hostload.py).

A batch dict holds ~50 small numpy arrays (key pyramids, validity masks,
segment ids, supervision). pack() writes them into ONE contiguous uint8
buffer on the host, byte for byte the buffer the JAX package packs for the
same batch and arguments; the buffer crosses to the card in one
non-blocking copy from pinned memory; unpack() rebuilds every array from
it on the card with slices, bit casts and a few scatters and cumulative
sums (eager: a few dozen launches per batch, where the JAX package fuses
them into its jit).

wire='compact' shrinks the buffer ~3x with codecs whose bounds are
structural (known from the batch layout, not guessed from values); each
round-trips exactly and pack() asserts it where a value could break it:

  * bool arrays        -> bit-packed, LSB first (8x)
  * vox_features       -> uint8 + a /255 LUT decode, iff the floats are
                          exactly u8/255 (PLY colors, the synthetic
                          generator); the LUT is built in float64 and
                          rounded to f32, never a division on the card
  * batch0/batch_ids   -> int8   (values in [-1, B), B <= 127 by layout)
  * pooling_ids        -> int8 deltas + a (pos, value) exception list
                          ('d8f'); decode = scatter + cumsum
  * up_parent{l}       -> scene-local int8 deltas ('d8p') with exceptions,
                          sentinel rows re-derived from keys{l}_b at decode;
                          plain uint16 otherwise
  * keys{l}_b          -> uint16 row deltas ('d16k') for levels of pad >=
                          8192, with an int32 exception list for the
                          x-plane carries
  * kc*_cnt / kc*_base -> uint8 / uint16 tile deltas ('d16b'): the JAX
                          package's window plans (--key_conv_force), which
                          the port's batches never carry; kept so that pack
                          gives the JAX package's bytes on those batches too

derive=True also drops valid0, batch0 and seg_valid, which are exact
functions of keys0_b and num_segments, and recomputes them at decode
(pack() verifies each derivation on the host first).

64-bit host arrays ship as their 32-bit counterparts, as jax.device_put
ships them; pack() asserts that the values survive, and unpack() gives the
64-bit dtype back, so the batch comes back bit for bit.

    pack, unpack, nbytes = make_batch_packer(example, wire='compact')
    buf = pack(dev_np)                          # host: one pass
    batch = unpack(torch.from_numpy(buf).to(device))

BatchUploader keeps one packer per batch signature with the JAX package's
fallback chain, and stages the buffers in pinned memory. upload() is the
per-array route (the Trainer, the non-fused eval, the spatial path).
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

from box2mask_torch import tracing
from box2mask_torch.sparse.keys import SENT_KEY

_ALIGN = 128

# u8 color decode table: matches the host-side (u8 / 255.).astype(f32) path
# bit-for-bit (a plain f32 divide on device can differ by 1 ulp)
_U8_LUT = (np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)
_LUTS = {}                      # device -> _U8_LUT on it
# pinned staging buffers per packer; a buffer is refilled only once its
# copy has completed, and the pipeline packs one batch ahead of the one it
# ships, so two would do: the third keeps the packer from waiting on it
RING = 3

# jax.device_put under the default no-x64 config ships 64-bit host arrays
# as their 32-bit counterparts; the wire does the same
_NARROW = {np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32),
           np.dtype(np.float64): np.dtype(np.float32)}


def upload(dev_np, device):
    """numpy batch dict -> tensors on `device`, one copy per array (pinned
    staging on CUDA)."""
    out = {}
    with tracing.span('b2m.train.upload'):
        for k, v in dev_np.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == 'cuda':
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


def _torch_dtype(dt):
    return torch.from_numpy(np.zeros(0, dt)).dtype


def _pick_codec(k, a, example, wire, u8_colors=True):
    """Codec for key k given the example batch. Bounds are structural."""
    if wire != 'compact':
        return 'raw'
    if a.dtype == np.bool_:
        return 'bits'
    if k == 'vox_features' and a.dtype == np.float32:
        if not u8_colors:     # augmented/continuous colors: never on u8 grid
            return 'raw'
        u8 = np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)
        if np.array_equal(_U8_LUT[u8], a):
            return 'u8x255'
        return 'raw'
    if k in ('batch0', 'batch_ids') and a.dtype.kind == 'i':
        return 'i8'
    if k == 'pooling_ids' and a.dtype.kind == 'i':
        # voxels are key-sorted and segments are spatially coherent, so the
        # voxel->segment stream moves in tiny steps (84% |d|<=1 measured at
        # ScanNet scale; 7/524288 i8 exceptions): flat i8 deltas + a (pos,
        # value) exception list, decode = scatter + cumsum. 2x smaller than
        # the former u16 codec and value-range free.
        return ('d8f', int(a.size) // 512 + 64)
    m = re.fullmatch(r'up_parent(\d+)', k)
    if m and a.dtype.kind == 'i':
        l = int(m.group(1))
        nxt = f'keys{l + 1}_b'
        if nxt in example:
            B, pad1 = np.asarray(example[nxt]).shape
            if (f'keys{l}_b' in example
                    and a.size == B * np.asarray(example[f'keys{l}_b']).shape[1]):
                # window layout: valid rows hold pos + scene*pad1; the
                # sentinel (B*pad1, exactly the fine SENT rows) is re-derived
                # from keys{l}_b at decode. Scene-local positions along the
                # key-sorted window delta-encode to i8 with a short exception
                # list (i8 doesn't cover the backward jumps at coordinate
                # carries: flooring is not monotone across field carries).
                # 4x smaller than raw.
                pad_f = a.size // B
                return ('d8p', int(pad1), int(B), l, pad_f // 64 + 64)
            if B * pad1 < 65535:
                return 'u16'
        return 'raw'
    m = re.fullmatch(r'keys(\d+)_b', k)
    if (m and a.ndim == 2 and a.dtype.kind == 'i' and a.shape[1] >= 8192):
        # sorted SENT-padded key rows: u16 deltas + per-row exceptions
        B, pad = a.shape
        return ('d16k', int(B), int(pad), pad // 64 + 64)
    if re.fullmatch(r'kc[35du]_cnt\d+', k) and a.dtype.kind == 'i':
        # key_conv chunk counts: <= ceil(pad/window), single digits in
        # practice (asserted < 256 at pack)
        return 'u8'
    if (re.fullmatch(r'kc[35du]_base\d+', k) and a.ndim == 3
            and a.dtype.kind == 'i'):
        # key_conv window starts: monotone along the tile axis per (scene,
        # group) — consecutive tiles' windows advance by ~tile/density rows
        # (measured max 4224 at ScanNet l0) -> u16 deltas per (b, g) row
        B, T, G = a.shape
        return ('d16b', int(B), int(T), int(G), T // 64 + 8)
    return 'raw'


def _encoded_nbytes(codec, size, itemsize):
    if isinstance(codec, tuple):
        tag = codec[0]
        if tag == 'd8p':                         # ('d8p', pad1, B, l, E)
            return size + 8 * codec[2] * codec[4]
        if tag == 'd16k':                        # ('d16k', B, pad, E)
            return 2 * size + 8 * codec[1] * codec[3]
        if tag == 'd8f':                         # ('d8f', E)
            return size + 8 * codec[1]
        if tag == 'd16b':                        # ('d16b', B, T, G, E)
            return 2 * size + 8 * codec[1] * codec[3] * codec[4]
        raise AssertionError(codec)
    return {'bits': (size + 7) // 8,
            'u8x255': size, 'i8': size, 'u8': size,
            'u16': 2 * size}.get(codec, size * itemsize)


def _delta_exceptions(d, small_lo, small_hi, E, key):
    """Split per-row deltas into an in-range stream + (pos, value) exception
    list. d: (B, pad) int64 true deltas. Returns (d_small int64 with 0 at
    exception slots, flat_pos int32 (B*E,), values int32 (B*E,)); unused
    exception slots get pos = B*pad (out of range -> dropped by the device
    scatter)."""
    B, pad = d.shape
    exc = (d < small_lo) | (d > small_hi)
    n_exc = exc.sum(axis=1)
    assert int(n_exc.max()) <= E, (
        f'{key}: {int(n_exc.max())} delta exceptions exceed the signature '
        f'cap {E} — degenerate key distribution; rebuild the packer with '
        "wire='raw'")
    pos = np.full((B, E), B * pad, np.int32)
    val = np.zeros((B, E), np.int32)
    for b in range(B):
        idx = np.flatnonzero(exc[b])
        pos[b, :idx.size] = (b * pad + idx).astype(np.int32)
        val[b, :idx.size] = d[b, idx].astype(np.int32)
    return np.where(exc, 0, d), pos.reshape(-1), val.reshape(-1)


def _derivable_keys(example):
    """Batch arrays that are exact functions of OTHER batch arrays under the
    device-maps layout (datasets/batching.py _build_batch_small), so they
    need not ride the wire at all — unpack() recomputes them on the device:

      * valid0        = keys0_b != SENT_KEY   (level-0 keys are 1:1 voxels)
      * batch0        = scene index where valid else -1 (window layout)
      * seg_valid     = arange(S_pad) < num_segments

    pack() VERIFIES each derivation against the array it was handed, so a
    layout drift fails loudly on the host instead of corrupting device
    results. up_parent{l} is not derived: re-deriving it takes a binary
    search per level on the device, for the ~0.5 MB a scene that its 'd8p'
    codec ships."""
    drop = {}
    if 'keys0_b' not in example:
        return drop
    if 'valid0' in example:
        drop['valid0'] = ('valid0', 0)
    if 'batch0' in example:
        drop['batch0'] = ('batch0', 0)
    if 'seg_valid' in example and 'num_segments' in example:
        drop['seg_valid'] = ('seg_valid', 0)
    return drop


def _derive_np(name, how, dev):
    """Host (numpy) reference of the decode-time derivations — used by pack() to
    verify the dropped arrays really are redundant for THIS batch."""
    kind, l = how
    keys0 = np.asarray(dev['keys0_b'])
    B, Vs = keys0.shape
    if kind == 'valid0':
        return (keys0 != SENT_KEY).reshape(-1)
    if kind == 'batch0':
        valid = keys0 != SENT_KEY
        scene = np.broadcast_to(np.arange(B, dtype=np.int32)[:, None],
                                valid.shape)
        return np.where(valid, scene, -1).astype(np.int32).reshape(-1)
    if kind == 'seg_valid':
        s_pad = np.asarray(dev['seg_valid']).shape[0]
        return np.arange(s_pad) < int(dev['num_segments'])
    raise AssertionError(f'unknown derivation {kind}')


def make_batch_packer(example: dict, wire: str = 'raw', derive: bool = False,
                      u8_colors: bool = True):
    """Build (pack, unpack, nbytes) for dicts matching `example`'s signature.

    pack:   dict[str, np.ndarray] -> (nbytes,) np.uint8; with `out`, packs
            into that (nbytes,) uint8 array, which must be zero where no
            array is written (as a fresh or previously packed buffer is)
    unpack: (nbytes,) uint8 tensor -> dict[str, tensor] on its device
    wire:   'raw' ships every array verbatim; 'compact' applies the lossless
            codecs documented in the module docstring (~3x smaller).
    derive: additionally drop arrays that are exact functions of other batch
            arrays and recompute them at decode (_derivable_keys); pack()
            verifies each derivation on the host per batch.
    """
    derived = _derivable_keys(example) if derive else {}
    dspec = [(k, np.asarray(example[k]).shape,
              np.asarray(example[k]).dtype, derived[k])
             for k in sorted(derived)]
    spec = []
    off = 0
    for k in sorted(example):
        if k in derived:
            continue
        a = np.asarray(example[k])
        dt = _NARROW.get(a.dtype, a.dtype)
        codec = _pick_codec(k, np.asarray(a, dtype=dt), example, wire,
                            u8_colors=u8_colors)
        nb = _encoded_nbytes(codec, a.size, dt.itemsize)
        spec.append((k, a.shape, dt, off, nb, codec))
        off += (nb + _ALIGN - 1) // _ALIGN * _ALIGN
    total = off
    # the dtype each array comes back as: its own, 64-bit ones included
    out_dtype = {k: _torch_dtype(np.asarray(example[k]).dtype)
                 for k in example}

    def _encode(k, a, codec, dev=None):
        flat = np.ascontiguousarray(a).reshape(-1)
        if codec == 'raw':
            return flat.view(np.uint8)
        if isinstance(codec, tuple) and codec[0] == 'd8f':
            E = codec[1]
            d = np.diff(flat.astype(np.int64), prepend=0)[None, :]
            d_small, pos, val = _delta_exceptions(d, -128, 127, E, k)
            return np.concatenate([
                d_small.astype(np.int8).reshape(-1).view(np.uint8),
                pos.view(np.uint8), val.view(np.uint8)])
        if isinstance(codec, tuple) and codec[0] == 'd16b':
            _, B, T, G, E = codec
            # deltas along the tile axis per (scene, group) row
            vt = flat.reshape(B, T, G).astype(np.int64).transpose(0, 2, 1)
            d = np.diff(vt.reshape(B * G, T), axis=1, prepend=0)
            assert (d >= 0).all(), (
                f'{k}: window bases are not monotone along tiles — plan '
                "layout drift (sparse/key_conv.py _host_bases); rebuild the "
                "packer with wire='raw'")
            d_small, pos, val = _delta_exceptions(d, 0, 65535, E, k)
            return np.concatenate([
                d_small.astype(np.uint16).reshape(-1).view(np.uint8),
                pos.view(np.uint8), val.view(np.uint8)])
        if isinstance(codec, tuple) and codec[0] == 'd16k':
            _, B, pad, E = codec
            v = flat.reshape(B, pad).astype(np.int64)
            d = np.diff(v, axis=1, prepend=0)    # d[:, 0] == v[:, 0]
            assert (d >= 0).all(), (
                f'{k}: rows are not sorted — batch layout drift '
                "(datasets/batching.py); rebuild the packer with wire='raw'")
            d_small, pos, val = _delta_exceptions(d, 0, 65535, E, k)
            return np.concatenate([
                d_small.astype(np.uint16).reshape(-1).view(np.uint8),
                pos.view(np.uint8), val.view(np.uint8)])
        if isinstance(codec, tuple) and codec[0] == 'd8p':
            _, pad1, B, l, E = codec
            sent_rows = flat == B * pad1
            if dev is not None:                  # verify the layout invariant
                fine = np.asarray(dev[f'keys{l}_b']).reshape(-1)
                assert np.array_equal(sent_rows, fine == SENT_KEY), (
                    f'{k}: sentinel rows disagree with keys{l}_b SENT rows — '
                    'batch layout drift (datasets/batching.py); rebuild the '
                    "packer with wire='raw'")
            assert (sent_rows | ((flat >= 0) & (flat < B * pad1))).all(), (
                f'{k}: values exceed the scene-local range')
            pad_f = flat.size // B
            u = (flat.astype(np.int64) % pad1).reshape(B, pad_f)
            sent2 = sent_rows.reshape(B, pad_f)
            # the SENT padding is a contiguous row tail (keys are sorted,
            # SENT_KEY is the maximum); carry the last valid value forward so
            # the tail delta-encodes to zeros (tail values are overwritten
            # from keys{l}_b at decode anyway)
            n_valid = (~sent2).sum(axis=1)
            assert np.array_equal(sent2,
                                  np.arange(pad_f)[None, :] >= n_valid[:, None]), (
                f'{k}: SENT rows are not a contiguous row tail — rebuild the '
                "packer with wire='raw'")
            for b in range(B):
                u[b, n_valid[b]:] = u[b, n_valid[b] - 1] if n_valid[b] else 0
            d = np.diff(u, axis=1, prepend=0)    # d[:, 0] == u[:, 0]
            d_small, pos, val = _delta_exceptions(d, -128, 127, E, k)
            return np.concatenate([
                d_small.astype(np.int8).reshape(-1).view(np.uint8),
                pos.view(np.uint8), val.view(np.uint8)])
        if codec == 'bits':
            return np.packbits(flat, bitorder='little')
        if codec == 'u8x255':
            u8 = np.clip(np.round(flat * 255.0), 0, 255).astype(np.uint8)
            assert np.array_equal(_U8_LUT[u8], flat), (
                f'{k}: floats are not exactly u8/255 — rebuild the packer '
                "with wire='raw' (augmented/continuous colors)")
            return u8
        small = {'i8': np.int8, 'u8': np.uint8, 'u16': np.uint16}[codec]
        enc = flat.astype(small)
        assert np.array_equal(enc.astype(flat.dtype), flat), (
            f'{k}: values exceed the {codec} wire range — structural bound '
            'violated, file a bug (hostload._pick_codec)')
        return enc.view(np.uint8)

    def pack(dev, out=None):
        buf = np.zeros(total, np.uint8) if out is None else out
        for k, shape, dtype, o, nb, codec in spec:
            src = np.asarray(dev[k])
            a = np.asarray(src, dtype=dtype)
            assert a.shape == tuple(shape), \
                f'{k}: shape {a.shape} != packer signature {shape}'
            if src.dtype in _NARROW:
                assert np.array_equal(a.astype(src.dtype), src), (
                    f'{k}: {src.dtype} values do not fit {dtype}')
            buf[o:o + nb] = _encode(k, a, codec, dev=dev)
        for k, shape, dtype, how in dspec:
            got = np.asarray(_derive_np(k, how, dev), dtype=dtype)
            want = np.asarray(dev[k], dtype=dtype).reshape(got.shape)
            assert np.array_equal(got, want), (
                f'{k}: host derivation mismatches the batch array — layout '
                'drift between datasets/batching.py and hostload._derive_np; '
                "rebuild the packer with derive=False")
        return buf

    def unpack(buf):
        dev = buf.device
        out = {}
        for k, shape, dtype, o, nb, codec in spec:
            out[k] = _decode(buf[o:o + nb], shape, dtype, codec, dev)
        for k, shape, dtype, o, nb, codec in spec:
            if isinstance(codec, tuple) and codec[0] == 'd8p':
                pad1, B = codec[1], codec[2]        # sentinel re-derive
                fine = out[f'keys{codec[3]}_b'].reshape(-1)
                out[k] = torch.where(fine == SENT_KEY, B * pad1,
                                     out[k].reshape(-1)).reshape(shape)
        if dspec:
            keys0 = out['keys0_b']
            B = keys0.shape[0]
            valid2d = keys0 != SENT_KEY
            for k, shape, dtype, (kind, _) in dspec:
                if kind == 'valid0':
                    v = valid2d.reshape(-1)
                elif kind == 'batch0':
                    scene = torch.arange(B, dtype=torch.int32,
                                         device=dev)[:, None]
                    v = torch.where(valid2d, scene, -1).reshape(-1)
                elif kind == 'seg_valid':
                    v = (torch.arange(shape[0], device=dev)
                         < out['num_segments'].to(torch.int32))
                else:
                    raise AssertionError(f'unknown derivation {kind}')
                out[k] = v.reshape(shape)
        return {k: v.to(out_dtype[k]) for k, v in out.items()}

    return pack, unpack, total


def _bitcast(raw, dtype):
    """The bytes of the uint8 tensor `raw` as `dtype` (a copy when they do
    not start at a multiple of its size, as Tensor.view needs)."""
    it = torch.empty(0, dtype=dtype).element_size()
    if raw.storage_offset() % it:
        raw = raw.clone()
    return raw.view(dtype)


def _u16(raw):
    """uint16 little-endian words -> int32 (torch.uint16 has few ops)."""
    return _bitcast(raw, torch.int16).to(torch.int32) & 0xFFFF


def _scatter_drop(d, pos, val):
    """d[pos] = val, dropping the positions past the end (the unused
    exception slots carry pos = d.numel(); an out-of-range index_put_ is a
    device-side assert on CUDA)."""
    n = d.numel()
    ext = torch.cat([d, d.new_zeros(1)])
    ext[pos.long().clamp(max=n)] = val
    return ext[:n]


def _deltas(raw, nd, n_exc, small):
    """(deltas with the exceptions written in, int32) of a delta codec:
    `nd` bytes of `small` deltas (int8 or uint16), then n_exc int32
    positions and n_exc int32 values."""
    d = (_bitcast(raw[:nd], torch.int8).to(torch.int32) if small == 'i8'
         else _u16(raw[:nd]))
    pos = _bitcast(raw[nd:nd + 4 * n_exc], torch.int32)
    val = _bitcast(raw[nd + 4 * n_exc:nd + 8 * n_exc], torch.int32)
    return _scatter_drop(d, pos, val)


def _decode(raw, shape, dtype, codec, dev):
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    tdt = _torch_dtype(dtype)
    if isinstance(codec, tuple) and codec[0] == 'd8f':
        d = _deltas(raw, size, codec[1], 'i8')
        return torch.cumsum(d, 0, dtype=torch.int32).to(tdt).reshape(shape)
    if isinstance(codec, tuple) and codec[0] == 'd16b':
        _, B, T, G, E = codec
        d = _deltas(raw, 2 * size, B * G * E, 'u16')
        vt = torch.cumsum(d.reshape(B * G, T), 1, dtype=torch.int32)
        return vt.reshape(B, G, T).permute(0, 2, 1).to(tdt).reshape(shape)
    if isinstance(codec, tuple) and codec[0] == 'd16k':
        _, B, pad, E = codec
        d = _deltas(raw, 2 * size, B * E, 'u16')
        return torch.cumsum(d.reshape(B, pad), 1,
                            dtype=torch.int32).reshape(shape)
    if isinstance(codec, tuple) and codec[0] == 'd8p':
        _, pad1, B, l, E = codec
        d = _deltas(raw, size, B * E, 'i8')
        local = torch.cumsum(d.reshape(B, size // B), 1, dtype=torch.int32)
        # sentinel rows re-derived from keys{l}_b in the unpack post-pass
        scene = torch.arange(B, dtype=torch.int32, device=dev)[:, None]
        return (local + scene * pad1).reshape(shape)
    if codec == 'bits':
        bits = torch.bitwise_right_shift(
            raw[:, None], torch.arange(8, dtype=torch.uint8, device=dev))
        return (bits & 1).reshape(-1)[:size].bool().reshape(shape)
    if codec == 'u8x255':
        if dev not in _LUTS:
            _LUTS[dev] = torch.from_numpy(_U8_LUT).to(dev)
        return _LUTS[dev][raw.long()].reshape(shape)
    if codec in ('i8', 'u8'):
        arr = raw if codec == 'u8' else _bitcast(raw, torch.int8)
        return arr.to(tdt).reshape(shape)
    if codec == 'u16':
        return _u16(raw).to(tdt).reshape(shape)
    if dtype == np.bool_:
        return (raw != 0).reshape(shape)
    return _bitcast(raw, tdt).reshape(shape)


class BatchUploader:
    """Batch dict -> tensors on `device` through one packed buffer, with a
    packer per batch signature and the JAX package's fallback chain: the
    compact wire with derivations, then without the u8 colour codec
    (augmented colours left the u8 grid), then without the derivations,
    then the raw wire; correctness never depends on the fast path.

    pack() may run on another thread than ship(), one batch ahead: each
    packer stages its buffers in a ring of RING pinned host buffers on CUDA
    and refills one only after its copy has completed; ship() enqueues one
    non-blocking copy. On the CPU each batch packs into a fresh buffer (the
    decoded tensors may alias it). `pack_s` and `wire_bytes` add up the
    packing seconds and the bytes packed."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cache = {}
        self.pack_s = 0.0
        self.wire_bytes = 0

    @staticmethod
    def signature(dev):
        return tuple(sorted((k, np.asarray(v).shape, str(np.asarray(v).dtype))
                            for k, v in dev.items()))

    def wires(self):
        """{signature: (wire, derive, u8 colours)} of every packer built."""
        return {sig: e['how'] for sig, e in self._cache.items()}

    def _build(self, dev, u8_colors, derive, wire):
        pack, unpack, nbytes = make_batch_packer(dev, wire=wire, derive=derive,
                                                 u8_colors=u8_colors)
        return {'pack': pack, 'unpack': unpack, 'nbytes': nbytes,
                'how': (wire, derive, u8_colors), 'staging': [], 'next': 0}

    def _stage(self, entry):
        """The next pinned buffer of the entry's ring, once its last copy
        has completed: (tensor, its numpy view, its copy's event)."""
        ring = entry['staging']
        if len(ring) < RING:
            host = torch.zeros(entry['nbytes'], dtype=torch.uint8,
                               pin_memory=True)
            ring.append((host, host.numpy(), torch.cuda.Event()))
        slot = ring[entry['next'] % len(ring)]
        entry['next'] += 1
        slot[2].synchronize()
        return slot

    def pack(self, dev):
        """Pack the batch on the host, down the fallback chain where a codec
        refuses it: (its packer, the staging slot or None, the buffer)."""
        with tracing.span('b2m.infer.pack'):
            return self._pack(dev)

    def _pack(self, dev):
        sig = self.signature(dev)
        entry = self._cache.get(sig)
        if entry is None:
            entry = self._cache[sig] = self._build(dev, True, True,
                                                   'compact')
        while True:
            wire, derive, u8_colors = entry['how']
            slot = self._stage(entry) if self.device.type == 'cuda' else None
            try:
                t0 = time.perf_counter()
                buf = entry['pack'](dev, None if slot is None else slot[1])
                self.pack_s += time.perf_counter() - t0
                break
            except AssertionError:
                if u8_colors:          # augmented colors left the u8 grid
                    entry = self._build(dev, False, derive, wire)
                elif derive:           # derivation verify failed: ship all
                    entry = self._build(dev, False, False, wire)
                elif wire != 'raw':    # codec cap/layout assert: ship raw
                    entry = self._build(dev, False, False, 'raw')
                else:
                    raise
                self._cache[sig] = entry
        self.wire_bytes += buf.nbytes
        return entry, slot, buf

    def ship(self, packed):
        """Enqueue a packed batch's one copy to the device: (device buffer,
        unpack)."""
        entry, slot, buf = packed
        if slot is None:
            return torch.from_numpy(buf), entry['unpack']
        out = torch.empty(buf.nbytes, dtype=torch.uint8, device=self.device)
        out.copy_(slot[0], non_blocking=True)
        slot[2].record()
        return out, entry['unpack']
