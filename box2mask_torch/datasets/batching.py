"""Batch assembly: per-scene dicts -> one padded, static-shape batch (host, NumPy).

The port's copy of box2mask_tpu/datasets/batching.py: map_semantics_to_idx
:27, _device_maps_ok :44, build_batch :63 and _build_batch_small :161. Two
layouts:

  * key pyramid (the default): `keys{l}_b` (B, pad_l) int32, per-scene
    sorted packed keys of level l, SENT_KEY-padded (sparse/keys.py
    host_level_keys); voxel-axis arrays in the interleaved `B*Vs` layout
    (scene i rows at [i*Vs, i*Vs + n_i)), Vs = pad_0. The convs either match
    keys (key_conv kernels: no maps, no window plans) or, on the
    neighbor-map path, run over maps that engine/state.ensure_maps builds on
    the device; such a batch carries the `device_nmaps` marker. The
    key-matching path is taken as in the JAX package (:196-198): --key_conv
    on, or eval outside mode 'train'. The JAX package's other conditions
    there (pads multiples of 128, a TPU backend) are TPU-only.
  * host maps (device_maps=False; JAX :84-148): scenes concatenated, padding
    at the tail, every neighbor map built on the host (sparse/coords.py).
    Taken under --host_coordinate_maps, or with a RuntimeWarning when a
    scene's coords leave the 10-bit-per-axis key packing, [0, 1024).

Both carry the segment-axis arrays (`pooling_ids` maps every voxel to its
globally renumbered oversegment, padding to the trash segment S_pad) and, in
train and val batches of supervised scenes, the labels the losses read.

Returns (dev, host): `dev` is a flat dict of numpy arrays ready for upload;
`host` keeps per-scene Python objects needed by post-processing and eval.
"""

from __future__ import annotations

import warnings

import numpy as np

from box2mask_torch.datasets import tables
from box2mask_torch.sparse import coords as C
from box2mask_torch.sparse.keys import (AXIS_MAX, NUM_LEVELS, SENT_KEY,
                                        host_level_keys)

# marks a key-pyramid batch whose convs run over neighbor maps that
# engine/state.ensure_maps builds on the device
DEVICE_NMAPS = 'device_nmaps'


def map_semantics_to_idx(sem_ids, id2idx):
    """Dataset id -> dense class index; invalid/ignore -> -100
    (reference SEMANTIC_ID2IDX tables, scannet.py:116-118)."""
    sem_ids = np.asarray(sem_ids)
    valid = (sem_ids >= 0) & (sem_ids < len(id2idx))
    safe = np.clip(sem_ids, 0, len(id2idx) - 1)
    return np.where(valid, id2idx[safe], tables.IGNORE).astype(np.int32)


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
        pads.append(max(C.round_up(count, bucket), bucket))
    return tuple(pads)


def _device_maps_ok(rets, cfg):
    """False under --host_coordinate_maps, and (with a RuntimeWarning) when a
    scene's coords leave the key packing range."""
    if cfg.host_coordinate_maps:
        return False
    ok = all(r['vox_coords'].max() < AXIS_MAX and r['vox_coords'].min() >= 0
             for r in rets)
    if not ok:
        # 10-bit/axis key packing limit: ~20 m at 2 cm voxels (~40 m at 4 cm)
        worst = max(int(r['vox_coords'].max()) for r in rets)
        warnings.warn(
            f'scene exceeds the {AXIS_MAX}-voxel/axis device-map packing '
            f'(max coord {worst}); falling back to host-built neighbor maps '
            f'(slow). Consider a larger --voxel_size or --subsample_rate.',
            RuntimeWarning, stacklevel=3)
    return ok


def common_level_pads(rets, vox_bucket):
    """The level pads of one batch holding all of `rets` (the JAX package's
    level_pads_for_scenes, sparse/device_maps.py:302): per-shard batches
    built at these pads share their shapes."""
    return level_pads([host_level_keys(r['vox_coords']) for r in rets],
                      vox_bucket)


def _key_pyramid(rets, cfg, mode, ns, pads=None):
    """The key-pyramid layout's level keys, its `device_nmaps` marker and
    its level-0 voxel-axis arrays (interleaved, Vs = pad_0 rows a scene).
    `pads` forces the level pads (default: this batch's own)."""
    B = len(rets)
    keys_per_scene = [host_level_keys(r['vox_coords']) for r in rets]
    if pads is None:
        pads = level_pads(keys_per_scene, cfg.vox_bucket)
    dev = {}
    for l in range(NUM_LEVELS):
        kb = np.full((B, pads[l]), SENT_KEY, np.int32)
        for i, ks in enumerate(keys_per_scene):
            kb[i, :len(ks[l])] = ks[l]
        dev[f'keys{l}_b'] = kb
    if not (cfg.key_conv == 'on' or (cfg.key_conv == 'eval'
                                     and mode != 'train')):
        dev[DEVICE_NMAPS] = np.ones((), bool)
    valid0 = np.zeros((B, pads[0]), bool)
    batch0 = np.full((B, pads[0]), -1, np.int32)
    for i, n in enumerate(ns):
        valid0[i, :n] = True
        batch0[i, :n] = i
    dev['valid0'] = valid0.reshape(-1)
    dev['batch0'] = batch0.reshape(-1)
    dev['num0'] = np.int32(sum(ns))
    return dev


def build_batch(rets, cfg, sem_id2idx=None, mode='train', device_maps=None,
                level_pads=None, seg_pad=None):
    """rets: list of per-scene dicts from voxelize_scene (+ supervision).
    Labels are added unless mode == 'test' or the scenes carry none; they
    need the dataset's `sem_id2idx` table. `device_maps` None picks the
    layout as the module docstring says; False forces host maps. The two
    layouts differ only in the pyramid and in where `place` puts each
    scene's voxel-axis rows. `level_pads` / `seg_pad` force the padded
    sizes of the key-pyramid layout (the sharded loader's common shapes)."""
    if device_maps is None:
        device_maps = _device_maps_ok(rets, cfg)
    B = len(rets)
    ns = [len(r['vox_coords']) for r in rets]
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
    }
    if device_maps:
        dev = _key_pyramid(rets, cfg, mode, ns, level_pads)
        Vs = host['interleaved_vs'] = dev['keys0_b'].shape[1]

        def place(arrays, fill=0, dtype=None):
            """Scene i's rows at [i*Vs, i*Vs + n_i)."""
            a0 = np.asarray(arrays[0])
            out = np.full((B, Vs) + a0.shape[1:], fill, dtype or a0.dtype)
            for i, a in enumerate(arrays):
                out[i, :ns[i]] = a
            return out.reshape((B * Vs,) + a0.shape[1:])
    else:
        dev = C.batch_pyramids([C.build_scene_pyramid(r['vox_coords'])
                                for r in rets], vox_bucket=cfg.vox_bucket)

        def place(arrays, fill=0, dtype=None):
            """Scenes concatenated, padding at the tail."""
            a = np.concatenate([np.asarray(a) for a in arrays], axis=0)
            return _pad_to(a.astype(dtype or a.dtype), dev['valid0'].shape[0],
                           fill=fill)

    def voxel_axis(key, fill=0, dtype=None):
        return place([r[key] for r in rets], fill, dtype)

    dev['vox_features'] = voxel_axis('vox_features', dtype=np.float32)
    if cfg.do_segment_pooling:
        seg_sizes = [len(r['input_location']) for r in rets]
        S_total = sum(seg_sizes)
        S_pad = seg_pad if seg_pad is not None else max(
            C.round_up(S_total, cfg.seg_bucket), cfg.seg_bucket)
        seg_off = np.concatenate([[0], np.cumsum(seg_sizes)])
        dev['pooling_ids'] = place([r['seg2vox'] + seg_off[i]
                                    for i, r in enumerate(rets)],
                                   fill=S_pad, dtype=np.int32)
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
        # per-voxel prediction: the "segment" axis is the voxel axis
        dev['pooling_ids'] = np.arange(dev['valid0'].shape[0], dtype=np.int32)
        dev['seg_valid'] = dev['valid0']
        dev['num_segments'] = dev['num0']
        dev['batch_ids'] = dev['batch0']
        dev['input_location'] = voxel_axis('input_location', dtype=np.float32)
        seg_layout = voxel_axis

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
        dev['seg_valid'], map_semantics_to_idx(gt_sem, sem_id2idx),
        tables.IGNORE).astype(np.int32)
    if 'gt_per_vox_semantics' in rets[0]:
        pv = voxel_axis('gt_per_vox_semantics', dtype=np.int32)
        dev['gt_per_vox_semantics'] = pv
        dev['gt_per_vox_semantics_idx'] = np.where(
            dev['valid0'], map_semantics_to_idx(pv, sem_id2idx),
            tables.IGNORE).astype(np.int32)
    host['instance_ids'] = [r.get('instance_ids') for r in rets]
    return dev, host
