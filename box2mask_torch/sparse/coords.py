"""Host-side coordinate pyramid + neighbor-map construction (NumPy).

The port's copy of box2mask_tpu/sparse/coords.py (pack :35, kernel_offsets
:43, _lookup :56, neighbor_map :66, build_scene_pyramid :76, _unpack :123,
round_up :130, batch_pyramids :134). It builds the host-maps batch layout
(datasets/batching.build_batch with device_maps=False): scenes whose
coordinates leave the 10-bit-per-axis key packing of sparse/keys.py, or any
scene under --host_coordinate_maps.

    nbr[v, k] = row index (into the input level) of the voxel at kernel
                offset k for output voxel v, or -1 if that neighbor is
                inactive (batch_pyramids turns -1 into the padded input size,
                the conv ops' zero row).

Level semantics:
  * level-l coords are in units of the finest voxel and are multiples of 2**l,
  * downsample (kernel 2, stride 2): out coords = unique(c & ~(2**(l+1)-1));
    the inputs of output voxel o are o + {0, 2**l}^3,
  * transpose conv (kernel 2, stride 2) from level l+1 to level l: out coords
    are the stored encoder coords of level l; each fine voxel has exactly one
    coarse parent ``(c >> (l+1)) << (l+1)`` and a weight slot in [0, 8) given
    by bit l of each axis.
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.sparse.keys import NUM_LEVELS

_SHIFT = 21
_OFF = 256              # guard so offset-shifted queries never underflow a field


def pack(coords):
    """Pack int (N,3) coords into unique int64 keys (lexicographic order)."""
    c = coords.astype(np.int64) + _OFF
    if c.size and (c.min() < 0 or c.max() >= (1 << _SHIFT) - _OFF):
        raise ValueError('voxel coordinates out of packable range')
    return (c[:, 0] << (2 * _SHIFT)) | (c[:, 1] << _SHIFT) | c[:, 2]


def kernel_offsets(size, step):
    """(size^3, 3) int offsets of a cubic kernel, scaled by `step` (= 2**level).

    Odd kernels are centered (e.g. 3 -> {-1,0,1}); even kernels cover
    {0..size-1} (stride-2 downsample convention)."""
    if size % 2:
        r = np.arange(-(size // 2), size // 2 + 1)
    else:
        r = np.arange(size)
    g = np.stack(np.meshgrid(r, r, r, indexing='ij'), axis=-1).reshape(-1, 3)
    return (g * step).astype(np.int64)


def _lookup(sorted_keys, query_keys):
    """Row index of each query key in sorted_keys, or -1 if absent."""
    if len(sorted_keys) == 0:
        return np.full(query_keys.shape, -1, dtype=np.int32)
    idx = np.searchsorted(sorted_keys, query_keys)
    idx_c = np.minimum(idx, len(sorted_keys) - 1).astype(np.int32)
    found = sorted_keys[idx_c] == query_keys
    return np.where(found, idx_c, np.int32(-1))


def neighbor_map(out_coords, in_sorted_keys, offsets):
    """(V_out, K) int32 map; -1 marks missing neighbors."""
    # offset keys use arithmetic (offsets can be negative; '|' would corrupt
    # the bit fields). _OFF >= max |offset| guarantees no borrow between fields.
    off_keys = (offsets[:, 0] * (1 << (2 * _SHIFT))
                + offsets[:, 1] * (1 << _SHIFT) + offsets[:, 2])
    q = pack(out_coords)[:, None] + off_keys[None, :]
    return _lookup(in_sorted_keys, q)


def build_scene_pyramid(vox_coords, num_levels=NUM_LEVELS, stem_kernel=5):
    """The full coordinate pyramid + all conv neighbor maps of one scene.

    vox_coords: (V, 3) int array of finest-level voxel coords (non-negative).
    Returns a dict of NumPy arrays: coords{l} (V_l, 3) int32 sorted,
    nmap3_{l} (V_l, 27), nmap5_0 (V_0, 125), down{l} (V_{l+1}, 8),
    up_parent{l} (V_l,), up_widx{l} (V_l,) in [0, 8), num{l} () int32.
    """
    coords = np.asarray(vox_coords)
    keys = np.unique(pack(coords))
    out = {}
    level_keys = []
    for l in range(num_levels):
        if l > 0:
            mask = ~np.int64((1 << l) - 1)
            # unpack previous level, floor to multiples of 2**l
            prev = _unpack(level_keys[l - 1])
            cur = prev & mask
            keys = np.unique(pack(cur))
        level_keys.append(keys)
        c = _unpack(keys).astype(np.int32)
        out[f'coords{l}'] = c
        out[f'num{l}'] = np.int32(len(c))
        out[f'nmap3_{l}'] = neighbor_map(c, keys, kernel_offsets(3, 1 << l))
    out['nmap5_0'] = neighbor_map(out['coords0'], level_keys[0],
                                  kernel_offsets(stem_kernel, 1))
    for l in range(num_levels - 1):
        fine = out[f'coords{l}'].astype(np.int64)
        coarse_keys = level_keys[l + 1]
        out[f'down{l}'] = neighbor_map(out[f'coords{l + 1}'], level_keys[l],
                                       kernel_offsets(2, 1 << l))
        parent = fine & ~np.int64((1 << (l + 1)) - 1)
        prow = _lookup(coarse_keys, pack(parent))
        assert (prow >= 0).all(), 'every fine voxel must have a coarse parent'
        bits = (fine >> l) & 1
        out[f'up_parent{l}'] = prow.astype(np.int32)
        out[f'up_widx{l}'] = (bits[:, 0] * 4 + bits[:, 1] * 2
                              + bits[:, 2]).astype(np.int32)
    return out


def _unpack(keys):
    x = (keys >> (2 * _SHIFT)) - _OFF
    y = ((keys >> _SHIFT) & ((1 << _SHIFT) - 1)) - _OFF
    z = (keys & ((1 << _SHIFT) - 1)) - _OFF
    return np.stack([x, y, z], axis=-1)


def round_up(n, m):
    return ((int(n) + m - 1) // m) * m


def batch_pyramids(pyramids, vox_bucket=4096, num_levels=NUM_LEVELS):
    """Concatenate per-scene pyramids into one padded batch pyramid.

    Row indices in every map are shifted by the running offset of the input
    level, so convolutions never mix scenes. Missing/padded neighbors are set
    to the padded input-level size, the conv ops' zero row. Also emits
    per-level `valid{l}` masks and `batch{l}` scene ids.
    """
    B = len(pyramids)
    out = {}
    sizes = {l: [int(p[f'num{l}']) for p in pyramids]
             for l in range(num_levels)}
    totals = {l: sum(sizes[l]) for l in range(num_levels)}
    pads = {l: max(round_up(totals[l], vox_bucket), vox_bucket)
            for l in range(num_levels)}
    offs = {l: np.concatenate([[0], np.cumsum(sizes[l])]).astype(np.int64)
            for l in range(num_levels)}

    def cat_rows(key, level_of_rows, ncols, in_level):
        """Concat a row-index map, shifted into the batch row space of
        in_level."""
        parts = []
        for i, p in enumerate(pyramids):
            m = p[key].astype(np.int64)
            m = np.where(m < 0, -1, m + offs[in_level][i])
            parts.append(m)
        m = (np.concatenate(parts, axis=0) if parts
             else np.zeros((0, ncols), np.int64))
        sent = pads[in_level]
        m = np.where(m < 0, sent, m)
        pad_n = pads[level_of_rows] - m.shape[0]
        if m.ndim == 1:
            m = np.concatenate([m, np.full(pad_n, sent, np.int64)])
        else:
            m = np.concatenate([m, np.full((pad_n, m.shape[1]), sent,
                                           np.int64)])
        return m.astype(np.int32)

    for l in range(num_levels):
        c = np.concatenate([p[f'coords{l}'] for p in pyramids], axis=0)
        pad_n = pads[l] - c.shape[0]
        out[f'coords{l}'] = np.concatenate(
            [c, np.zeros((pad_n, 3), c.dtype)]).astype(np.int32)
        out[f'valid{l}'] = (np.arange(pads[l]) < totals[l])
        bids = np.concatenate(
            [np.full(sizes[l][i], i, np.int32) for i in range(B)] +
            [np.full(pad_n, -1, np.int32)])
        out[f'batch{l}'] = bids
        out[f'num{l}'] = np.int32(totals[l])
        out[f'nmap3_{l}'] = cat_rows(f'nmap3_{l}', l, 27, l)
    out['nmap5_0'] = cat_rows('nmap5_0', 0, 125, 0)
    for l in range(num_levels - 1):
        out[f'down{l}'] = cat_rows(f'down{l}', l + 1, 8, l)
        out[f'up_parent{l}'] = cat_rows(f'up_parent{l}', l, 1, l + 1)
        # padded rows: weight slot 0 with sentinel parent (resolved in ops)
        w = np.concatenate([p[f'up_widx{l}'] for p in pyramids])
        out[f'up_widx{l}'] = np.concatenate(
            [w, np.zeros(pads[l] - len(w), np.int32)]).astype(np.int32)
    return out
