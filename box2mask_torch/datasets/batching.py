"""Batch assembly: per-scene dicts -> one padded, static-shape batch (host, NumPy).

The port's copy of box2mask_tpu/datasets/batching.py:27
(map_semantics_to_idx) and :161-294 (_build_batch_small), key-pyramid layout
only:

  * `keys{l}_b` (B, pad_l) int32: per-scene sorted packed keys of level l,
    SENT_KEY-padded (sparse/keys.py host_level_keys),
  * voxel-axis arrays in the interleaved `B*Vs` layout (scene i rows at
    [i*Vs, i*Vs + n_i)), Vs = pad_0,
  * segment-axis arrays (`pooling_ids` maps every voxel to its globally
    renumbered oversegment, padding to the trash segment S_pad),
  * in train and val batches of supervised scenes, the labels the losses
    read: gt_bb_offsets, gt_bb_bounds, fg_instances, gt_semantics and
    gt_semantics_idx in the segment layout (and the per-voxel semantics
    where the scenes carry them).

The key-matching conv searches the sorted key rows itself, so the batch
carries no window plans (the JAX package's kc*_base / kc*_cnt) and no
neighbor maps.

Returns (dev, host): `dev` is a flat dict of numpy arrays ready for upload;
`host` keeps per-scene Python objects needed by post-processing and eval.
"""

from __future__ import annotations

import numpy as np

from box2mask_torch.datasets import tables
from box2mask_torch.sparse.keys import NUM_LEVELS, SENT_KEY, host_level_keys


def map_semantics_to_idx(sem_ids, id2idx):
    """Dataset id -> dense class index; invalid/ignore -> -100
    (reference SEMANTIC_ID2IDX tables, scannet.py:116-118)."""
    sem_ids = np.asarray(sem_ids)
    valid = (sem_ids >= 0) & (sem_ids < len(id2idx))
    safe = np.clip(sem_ids, 0, len(id2idx) - 1)
    return np.where(valid, id2idx[safe], tables.IGNORE).astype(np.int32)


def round_up(x, m):
    return int(((x + m - 1) // m) * m)


def _pad_to(arr, n, fill=0):
    pad_n = n - arr.shape[0]
    if pad_n <= 0:
        return arr[:n]
    pad_shape = (pad_n,) + arr.shape[1:]
    return np.concatenate([arr, np.full(pad_shape, fill, arr.dtype)], axis=0)


def level_pads(keys_per_scene, vox_bucket):
    """Per-level pad sizes: the largest scene's key count, bucketed (a floor
    of min(512, vox_bucket) keeps the coarse levels from degenerate pads)."""
    pads = []
    for l in range(NUM_LEVELS):
        count = max(len(ks[l]) for ks in keys_per_scene)
        bucket = max(min(512, vox_bucket), vox_bucket >> l)
        pads.append(max(round_up(count, bucket), bucket))
    return tuple(pads)


def build_batch(rets, cfg, sem_id2idx=None, mode='train'):
    """rets: list of per-scene dicts from voxelize_scene (+ supervision).
    Labels are added unless mode == 'test' or the scenes carry none; they
    need the dataset's `sem_id2idx` table."""
    B = len(rets)
    for r in rets:
        c = r['vox_coords']
        if len(c) and (c.min() < 0 or c.max() >= 1 << 10):
            raise ValueError(
                f'scene exceeds the 1024-voxel/axis key packing (coords in '
                f'[{c.min()}, {c.max()}]); use a larger --voxel_size')
    keys_per_scene = [host_level_keys(r['vox_coords']) for r in rets]
    pads = level_pads(keys_per_scene, cfg.vox_bucket)
    Vs = pads[0]
    ns = [len(r['vox_coords']) for r in rets]
    dev = {}
    for l in range(NUM_LEVELS):
        kb = np.full((B, pads[l]), SENT_KEY, np.int32)
        for i, ks in enumerate(keys_per_scene):
            kb[i, :len(ks[l])] = ks[l]
        dev[f'keys{l}_b'] = kb

    def interleave(key, fill=0, dtype=None):
        a0 = np.asarray(rets[0][key])
        shape = (B, Vs) + a0.shape[1:]
        out = np.full(shape, fill, dtype or a0.dtype)
        for i, r in enumerate(rets):
            out[i, :ns[i]] = r[key]
        return out.reshape((B * Vs,) + a0.shape[1:])

    dev['vox_features'] = interleave('vox_features', dtype=np.float32)
    valid0 = np.zeros((B, Vs), bool)
    batch0 = np.full((B, Vs), -1, np.int32)
    for i, n in enumerate(ns):
        valid0[i, :n] = True
        batch0[i, :n] = i
    dev['valid0'] = valid0.reshape(-1)
    dev['batch0'] = batch0.reshape(-1)
    dev['num0'] = np.int32(sum(ns))

    if cfg.do_segment_pooling:
        seg_sizes = [len(r['input_location']) for r in rets]
        S_total = sum(seg_sizes)
        S_pad = max(round_up(S_total, cfg.seg_bucket), cfg.seg_bucket)
        seg_off = np.concatenate([[0], np.cumsum(seg_sizes)])
        pooling = np.full((B, Vs), S_pad, np.int32)
        for i, r in enumerate(rets):
            pooling[i, :ns[i]] = r['seg2vox'] + seg_off[i]
        dev['pooling_ids'] = pooling.reshape(-1)
        dev['seg_valid'] = np.arange(S_pad) < S_total
        dev['num_segments'] = np.int32(S_total)
        dev['batch_ids'] = _pad_to(
            np.concatenate([np.full(seg_sizes[i], i, np.int32)
                            for i in range(B)]), S_pad, fill=-1)
        loc = np.concatenate([r['input_location'] for r in rets], axis=0)
        dev['input_location'] = _pad_to(loc.astype(np.float32), S_pad)

        def seg_layout(key, fill):
            return _pad_to(np.concatenate([np.asarray(r[key]) for r in rets],
                                          axis=0), S_pad, fill=fill)
    else:
        dev['pooling_ids'] = np.arange(B * Vs, dtype=np.int32)
        dev['seg_valid'] = dev['valid0']
        dev['num_segments'] = dev['num0']
        dev['batch_ids'] = dev['batch0']
        dev['input_location'] = interleave('input_location', dtype=np.float32)

        def seg_layout(key, fill):
            return interleave(key, fill=fill)

    host = {
        'scene': [r['scene'] for r in rets],
        'labels': [r.get('labels') for r in rets],
        'vox2point': [r['vox2point'] for r in rets],
        'point2vox': [r['point2vox'] for r in rets],
        'seg2vox': [r.get('seg2vox') for r in rets],
        'seg2point': [r.get('seg2point') for r in rets],
        'vox_segments': [r['vox_segments'] for r in rets],
        'input_location': [r['input_location'] for r in rets],
        'vox_world_coords': [r['vox_world_coords'] for r in rets],
        'num_voxels': ns,
        'interleaved_vs': Vs,
    }
    if mode == 'test' or 'gt_bb_offsets' not in rets[0]:
        return dev, host
    if sem_id2idx is None:
        raise ValueError('a labelled batch needs the sem_id2idx table')
    dev['gt_bb_offsets'] = seg_layout('gt_bb_offsets', 0.0).astype(np.float32)
    dev['gt_bb_bounds'] = seg_layout('gt_bb_bounds', 0.0).astype(np.float32)
    dev['fg_instances'] = seg_layout('fg_instances', False).astype(bool)
    gt_sem = seg_layout('gt_semantics', 0).astype(np.int32)
    dev['gt_semantics'] = gt_sem
    dev['gt_semantics_idx'] = np.where(
        dev['seg_valid'] if cfg.do_segment_pooling else dev['valid0'],
        map_semantics_to_idx(gt_sem, sem_id2idx),
        tables.IGNORE).astype(np.int32)
    if 'gt_per_vox_semantics' in rets[0]:
        pv = interleave('gt_per_vox_semantics', dtype=np.int64)
        dev['gt_per_vox_semantics'] = pv.astype(np.int32)
        dev['gt_per_vox_semantics_idx'] = np.where(
            dev['valid0'], map_semantics_to_idx(pv, sem_id2idx),
            tables.IGNORE).astype(np.int32)
    host['instance_ids'] = [r.get('instance_ids') for r in rets]
    return dev, host
