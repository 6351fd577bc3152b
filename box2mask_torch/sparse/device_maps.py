"""Neighbor maps built on the batch's device from the key pyramid (torch).

Port of box2mask_tpu/sparse/device_maps.py: unpack_keys / lookup :44-82,
neighbor_map :85 (here the direct lookup of :144, one binary search per
(row, offset); the maps come out bit-equal to the z-run form),
_subkernel_columns :164, maps_from_level_keys :172, _globalize_batch :229
and build_batch_maps_from_keys :274. The JAX vmap over scenes is a written-
out batch dimension: every per-scene array carries a leading B.

The batch carries per-scene sorted unique packed keys per level,
`keys{l}_b` (B, pad_l) int32, SENT_KEY-padded (datasets/batching). The maps
use the interleaved `B * pad_l` row layout; a missing neighbor points at the
single global sentinel row `B * pad_l`, the conv ops' zero row:

  nmap3_{l}    (B*pad_l, 27)    3^3 same-level conv at level l
  nmap5_0      (B*pad_0, 125)   5^3 stem (nmap3_0 is a column subset of it)
  down{l}      (B*pad_{l+1}, 8) level-l inputs of the stride-2 conv to l+1
  up_parent{l} (B*pad_l,)       parent row at level l+1 (the inverse of
                                 down{l}: one scatter, no search)
  up_widx{l}   (B*pad_l,)       transpose-conv weight slot = bit l of x, y, z
  valid{l}, num{l}, coords{l}, batch{l}

The searches and gathers are library calls (torch.searchsorted, gather,
scatter): the JAX package builds the same maps in XLA, outside any Pallas
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from box2mask_torch.sparse.coords import kernel_offsets
from box2mask_torch.sparse.keys import AXIS_BITS, AXIS_MAX, NUM_LEVELS, SENT_KEY


def unpack_keys(keys):
    x = keys >> (2 * AXIS_BITS)
    y = (keys >> AXIS_BITS) & (AXIS_MAX - 1)
    z = keys & (AXIS_MAX - 1)
    return x, y, z


def lookup(sorted_keys, q_keys, q_valid):
    """Row of each query in its scene's sorted key row, or the pad size when
    absent or invalid. sorted_keys (B, Vp); q_keys, q_valid (B, Q)."""
    Vp = sorted_keys.shape[1]
    i = torch.searchsorted(sorted_keys, q_keys, out_int32=True)
    ic = torch.clamp(i, max=Vp - 1)
    found = (torch.gather(sorted_keys, 1, ic.long()) == q_keys) & q_valid
    return torch.where(found, ic, Vp)


def neighbor_map(out_keys, in_sorted, offsets):
    """(B, Vout, K) per-scene neighbor map, missing == in_sorted.shape[1].
    out_keys (B, Vout), in_sorted (B, Vin) int32; `offsets` a (K, 3) numpy
    array. Query bounds are checked per axis before packing, so no query
    wraps into a neighbouring field."""
    x, y, z = unpack_keys(out_keys)
    dev = out_keys.device
    ox, oy, oz = (torch.as_tensor(np.asarray(offsets)[:, i], dtype=torch.int32,
                                  device=dev) for i in range(3))
    qx = x[..., None] + ox
    qy = y[..., None] + oy
    qz = z[..., None] + oz
    valid = ((qx >= 0) & (qx < AXIS_MAX) & (qy >= 0) & (qy < AXIS_MAX)
             & (qz >= 0) & (qz < AXIS_MAX) & (out_keys < SENT_KEY)[..., None])
    qk = ((qx.clamp(0, AXIS_MAX - 1) << (2 * AXIS_BITS))
          | (qy.clamp(0, AXIS_MAX - 1) << AXIS_BITS)
          | qz.clamp(0, AXIS_MAX - 1))
    B, V, K = qk.shape
    return lookup(in_sorted, qk.reshape(B, V * K),
                  valid.reshape(B, V * K)).reshape(B, V, K)


def _subkernel_columns(big, small, step):
    """Column indices of the `small`-kernel offsets inside the `big`-kernel
    offset list (both from kernel_offsets at the same step)."""
    big_offs = [tuple(o) for o in kernel_offsets(big, step)]
    return [big_offs.index(tuple(o)) for o in kernel_offsets(small, step)]


def maps_from_level_keys(keys, stem_kernel=5):
    """Every per-scene map (leading B) from the 8-level key pyramid `keys`
    (tuple of (B, pad_l) int32). Local convention: missing == pad size of
    the input level. The 3^3 map at level 0 is a column subset of the stem
    map (same in/out keys); up_parent inverts the down map."""
    out = {}
    B = keys[0].shape[0]
    level_pads = tuple(k.shape[1] for k in keys)
    for l in range(NUM_LEVELS):
        valid = keys[l] < SENT_KEY
        out[f'num{l}'] = valid.sum(1, dtype=torch.int32)
        out[f'valid{l}'] = valid
        x, y, z = unpack_keys(torch.where(valid, keys[l], 0))
        out[f'coords{l}'] = torch.stack([x, y, z], dim=-1)
        if l > 0:
            out[f'nmap3_{l}'] = neighbor_map(keys[l], keys[l],
                                             kernel_offsets(3, 1 << l))
    out['nmap5_0'] = neighbor_map(keys[0], keys[0],
                                  kernel_offsets(stem_kernel, 1))
    if stem_kernel >= 3:
        sub = _subkernel_columns(stem_kernel, 3, 1)
        out['nmap3_0'] = out['nmap5_0'][:, :, sub]
    else:
        out['nmap3_0'] = neighbor_map(keys[0], keys[0], kernel_offsets(3, 1))
    for l in range(NUM_LEVELS - 1):
        down = neighbor_map(keys[l + 1], keys[l], kernel_offsets(2, 1 << l))
        out[f'down{l}'] = down
        # each fine voxel is the child of exactly one coarse row: scatter the
        # coarse row ids to their children; misses land on a trash column
        Vl, Vl1 = level_pads[l], level_pads[l + 1]
        parents = torch.arange(Vl1, dtype=torch.int32,
                               device=down.device)[None, :, None].expand(
                                   down.shape)
        child = torch.where(down < Vl, down, Vl).long()
        up_parent = torch.full((B, Vl + 1), Vl1, dtype=torch.int32,
                               device=down.device)
        up_parent.scatter_(1, child.reshape(B, -1), parents.reshape(B, -1))
        out[f'up_parent{l}'] = torch.where(keys[l] < SENT_KEY,
                                           up_parent[:, :Vl], Vl1)
        x, y, z = unpack_keys(keys[l])
        out[f'up_widx{l}'] = (((x >> l) & 1) * 4 + ((y >> l) & 1) * 2
                              + ((z >> l) & 1)).to(torch.int32)
    return out


def _globalize_batch(per_scene, B, level_pads):
    """Per-scene maps (leading B) -> the interleaved global layout."""
    out = {}
    for l in range(NUM_LEVELS):
        valid = per_scene[f'valid{l}']
        out[f'valid{l}'] = valid.reshape(-1)
        out[f'coords{l}'] = per_scene[f'coords{l}'].reshape(-1, 3)
        out[f'num{l}'] = per_scene[f'num{l}'].sum(dtype=torch.int32)
        s_ids = torch.arange(B, dtype=torch.int32,
                             device=valid.device)[:, None]
        out[f'batch{l}'] = torch.where(valid, s_ids, -1).reshape(-1)

    def globalize(local, in_level):
        pad = level_pads[in_level]
        s = torch.arange(B, dtype=torch.int32, device=local.device).reshape(
            (B,) + (1,) * (local.dim() - 1))
        return torch.where(local >= pad, B * pad, local + s * pad).reshape(
            (-1,) + tuple(local.shape[2:]))

    for l in range(NUM_LEVELS):
        out[f'nmap3_{l}'] = globalize(per_scene[f'nmap3_{l}'], l)
    out['nmap5_0'] = globalize(per_scene['nmap5_0'], 0)
    for l in range(NUM_LEVELS - 1):
        out[f'down{l}'] = globalize(per_scene[f'down{l}'], l)
        out[f'up_parent{l}'] = globalize(per_scene[f'up_parent{l}'], l + 1)
        out[f'up_widx{l}'] = per_scene[f'up_widx{l}'].reshape(-1)
    return out


def build_batch_maps_from_keys(keys_b, stem_kernel=5):
    """keys_b: tuple of 8 (B, pad_l) int32 tensors, the per-scene sorted
    unique packed keys per level, SENT_KEY-padded. Returns the global map
    dict, on the keys' device."""
    keys_b = tuple(k.to(torch.int32).contiguous() for k in keys_b)
    B = keys_b[0].shape[0]
    level_pads = tuple(k.shape[1] for k in keys_b)
    per_scene = maps_from_level_keys(keys_b, stem_kernel)
    return _globalize_batch(per_scene, B, level_pads)
