"""On-device detection -> masks post-processing, and the host unpack (port of
box2mask_tpu/postprocess/device_post.py: _pack_bits :44, _make_core :57,
make_device_postproc :166, make_fused_infer's per-scene packing :229-251
(with the per-voxel semantics plane),
host unpack :264-411, both batch layouts as at :228 and :394-398). The
voxel-level unpack (no segment pooling, and the top-k overflow fallback)
runs through the C unpack of native/ as the JAX package's _scene_result
does (:264-290), unless the caller asks for the NumPy plain version
(`native=False`, from cfg.use_native_host_ops); the segment-level unpack
stays NumPy, as there.

Per scene:
  1. votes -> [sigmoid(score), min, max] boxes (min_bb clamp),
  2. foreground filter from the semantics head + NMS clustering,
  3. score threshold, seg -> vox heatmap projection, binarization,
  4. greedy mask NMS on the IoU matrix of ONE f32 matmul of 0/1 masks
     (exact integer counts),
  5. per-mask majority-vote semantics (mask x one-hot matmul),
  6. kept rows first (stable sort) and masks bit-packed to uint8.

Only the packed segment-level masks and scalar metadata of the best `top_k`
rows are copied to the host; a scene with more kept masks re-runs unfused at
full width (`post_full`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from box2mask_torch import tracing
from box2mask_torch.native import native_unpack_masks
from box2mask_torch.postprocess.nms import SYNC_EVERY, nms_clustering

# the evaluation's static bound on the masks NMS clustering keeps per scene
MAX_MASKS = 256


def pack_bits(masks):
    """(R, V) bool -> (R, V // 8) uint8, little-endian bit order."""
    R, V = masks.shape
    if V % 8:
        raise ValueError(f'mask width {V} not a multiple of 8: pick a '
                         'vox_bucket / seg_bucket divisible by 8')
    w = (1 << torch.arange(8, device=masks.device)).to(torch.uint8)
    return (masks.reshape(R, V // 8, 8).to(torch.uint8) * w).sum(
        -1).to(torch.uint8)


def make_core(cfg, valid_class_ids, is_foreground, max_masks):
    """fn(pred, batch, scene_idx, ths, vox_slice=None) -> dict with n_keep,
    conf (R,), label_idx (R,), masks (R, V) bool and seg_masks (R, S) bool
    ordered kept-first, cluster_cap_hit (0-dim bool)."""
    ids = np.asarray(valid_class_ids)
    fg_np = np.asarray(is_foreground(ids)).astype(bool)
    min_bb = cfg.min_bb_size
    off_h, bnd_h = cfg.mlp_offsets, cfg.mlp_bounds
    score_h, sem_h = cfg.mlp_bb_scores, cfg.mlp_semantics

    def core(pred, batch, scene_idx, ths, vox_slice=None):
        """ths: (4,) f32 tensor [cluster, score, mask_bin, mask_nms];
        vox_slice restricts the voxel axis to one scene's window."""
        dev = pred[off_h].device
        fg_lut = torch.as_tensor(fg_np, device=dev)
        cluster_th, score_th, mask_bin_th, mask_nms_th = ths
        # a mask_nms_th >= 1 would never suppress the selected row itself
        mask_nms_th = torch.clamp(mask_nms_th, max=1.0 - 1e-6)
        loc = batch['input_location']
        S = loc.shape[0]
        off = pred[off_h][:S]
        bnd = pred[bnd_h][:S]
        if min_bb is not None:
            bnd = torch.clamp(bnd, min=min_bb)
        scores = torch.sigmoid(pred[score_h][:S, 0])
        center = loc + off
        boxes = torch.cat([scores[:, None], center - bnd, center + bnd], 1)
        sem_idx = torch.argmax(pred[sem_h][:S], dim=1)
        fg = (fg_lut[sem_idx] & batch['seg_valid']
              & (batch['batch_ids'] == scene_idx))

        with tracing.span('b2m.post.cluster'):
            reps, heatmaps, repv, cap_hit = nms_clustering(
                boxes, fg, cluster_th, max_clusters=max_masks)
        rep_scores = boxes[reps, 0]
        keep0 = repv & (rep_scores > score_th)
        heatmaps = heatmaps * fg[None, :].float()

        pool = batch['pooling_ids']
        valid0, batch0 = batch['valid0'], batch['batch0']
        if vox_slice is not None:
            pool, valid0, batch0 = (pool[vox_slice], valid0[vox_slice],
                                    batch0[vox_slice])
        vox_ok = valid0 & (batch0 == scene_idx) & (pool < S)
        pool_c = torch.clamp(pool, max=S - 1).long()
        vox_heat_t = heatmaps.T[pool_c]                          # (V, R)
        masks_t = (vox_heat_t > mask_bin_th) & vox_ok[:, None]

        M = masks_t.float()
        inter = M.T @ M                                          # (R, R)
        areas = torch.diagonal(inter)
        union = areas[:, None] + areas[None, :] - inter
        iou = torch.where(union > 0, inter / torch.clamp(union, min=1.0),
                          0.0)
        R = iou.shape[0]
        rank = R - torch.arange(R, device=dev)
        remaining = keep0
        keep = torch.zeros(R, dtype=torch.bool, device=dev)
        with tracing.span('b2m.post.mask_nms'):
            steps = syncs = 0
            for it in range(R):    # greedy: smallest remaining index first
                if it % SYNC_EVERY == 0:
                    syncs += 1
                    if not bool(remaining.any()):
                        break
                steps += 1
                active = remaining.any()
                top = torch.argmax(torch.where(remaining, rank, 0))
                keep[top] = keep[top] | active
                row = iou[top].clone()
                row[top] = 1.0
                remaining = remaining & (row <= mask_nms_th)
            tracing.add('mask_nms_steps', steps)
            tracing.add('post_syncs', syncs)

        vox_sem = sem_idx[pool_c]
        onehot = torch.nn.functional.one_hot(vox_sem, fg_np.shape[0]).float()
        counts = M.T @ onehot                                    # (R, C)
        label_idx = torch.argmax(counts, dim=1).to(torch.int32)

        order = torch.argsort((~keep).to(torch.uint8), stable=True)
        seg_masks = heatmaps > mask_bin_th                       # (R, S)
        return {'n_keep': keep.sum().to(torch.int32),
                'conf': rep_scores[order],
                'label_idx': label_idx[order],
                'masks': masks_t.T[order],
                'seg_masks': seg_masks[order],
                'cluster_cap_hit': cap_hit}

    return core


def make_device_postproc(cfg, valid_class_ids, is_foreground,
                         max_masks=MAX_MASKS):
    """fn(pred, batch, scene_idx, ths) -> compact full-width result dict
    (masks bit-packed over the whole voxel axis)."""
    core = make_core(cfg, valid_class_ids, is_foreground, max_masks)

    @torch.no_grad()
    def post(pred, batch, scene_idx, ths):
        out = core(pred, batch, scene_idx, ths)
        out.pop('seg_masks')
        out['masks_packed'] = pack_bits(out.pop('masks'))
        return out

    return post


def fused_postproc(core, cfg, pred, batch, ths, top_k):
    """Every scene of the batch through `core` on its own voxel window, the
    best `top_k` rows packed, stacked into one dict of (B, ...) tensors;
    with the per-voxel semantics head, its argmax over the window rides
    along as u8 `vox_sem` (JAX device_post.py:243-249). A host-maps batch
    (no key pyramid) holds one scene (JAX device_post.py:228)."""
    B = batch['keys0_b'].shape[0] if 'keys0_b' in batch else 1
    vs = batch['valid0'].shape[0] // B
    outs = []
    for b in range(B):
        o = core(pred, batch, b, ths, vox_slice=slice(b * vs, (b + 1) * vs))
        if cfg.do_segment_pooling:
            o.pop('masks')
            o['seg_masks_packed'] = pack_bits(o.pop('seg_masks')[:top_k])
        else:
            o.pop('seg_masks')
            o['masks_packed'] = pack_bits(o.pop('masks')[:top_k])
        o['conf'] = o['conf'][:top_k]
        o['label_idx'] = o['label_idx'][:top_k]
        o['topk_overflow'] = o['n_keep'] > top_k
        if cfg.mlp_per_vox_semantics in pred:
            o['vox_sem'] = torch.argmax(
                pred[cfg.mlp_per_vox_semantics][b * vs:(b + 1) * vs],
                dim=1).to(torch.uint8)
        outs.append(o)
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


# ------------------------------------------------------------ host unpack
def _unpack(packed, n, lo, hi):
    """Rows [:n] of bit-packed masks, bits [lo, hi), as bool."""
    if not n:
        return np.zeros((0, hi - lo), bool)
    return np.unpackbits(packed[:n], axis=1,
                         bitorder='little')[:, lo:hi].astype(bool)


def _point_masks(packed, n, start, n_vox, vox2point, native):
    """Rows [:n] of bit-packed voxel masks, the scene's voxels [start,
    start + n_vox), projected to its points: (n, P) bool. The C pass needs
    the scene to start on a byte (JAX device_post.py:401-402)."""
    if native and start % 8 == 0:
        return native_unpack_masks(packed[:n], start // 8,
                                   vox2point).view(np.bool_)
    return _unpack(packed, n, start, start + n_vox)[:, vox2point]


def _result(conf, label_idx, masks, valid_class_ids):
    label_id = np.asarray(valid_class_ids)[label_idx].astype(np.int32)
    return {'conf': conf, 'label_id': label_id, 'mask': masks}


def warn_cap(host, scene_idx, cap_hit):
    if bool(cap_hit):
        warnings.warn(
            f"scene {host['scene'][scene_idx]['name']}: NMS clustering hit "
            'the static max_masks bound — instances beyond it were dropped '
            '(raise max_masks; typical for untrained/degenerate models)')


def stacked_masks_to_results(out_np, host, valid_class_ids,
                             post_fallback=None, pred=None, dev_t=None,
                             ths=None, native=True):
    """Host side: unpack one stacked (numpy) fused output into the
    detection_to_masks result dict {scene: {conf, label_id, mask}}, masks
    over each scene's points, for every scene. A scene with more kept masks
    than shipped rows re-runs through `post_fallback(pred, dev_t, scene_idx,
    ths)` at full width. `native` picks the C voxel-level unpack."""
    results = {}
    seg_level = 'seg_masks_packed' in out_np
    packed_key = 'seg_masks_packed' if seg_level else 'masks_packed'
    seg_off = np.concatenate(
        [[0], np.cumsum([len(il) for il in host['input_location']])])
    for si, scene in enumerate(host['scene']):
        n = int(out_np['n_keep'][si])
        warn_cap(host, si, out_np['cluster_cap_hit'][si])
        cap = out_np[packed_key].shape[1]
        if n > cap:
            if post_fallback is None or pred is None:
                warnings.warn(f"scene {scene['name']}: {n} masks kept but "
                              f'only {cap} packed rows shipped; truncated')
                n = cap
            else:
                with tracing.span('b2m.harvest.fallback'):
                    out = post_fallback(pred, dev_t, si, ths)
                    results.update(device_masks_to_results(
                        out, host, valid_class_ids, si, native))
                continue
        v2p = np.asarray(host['vox2point'][si])
        if seg_level:
            # a mask is a set of segments: seg -> point in one gather
            cache = host.setdefault('_seg2point', {})
            if si not in cache:
                cache[si] = np.asarray(host['seg2vox'][si])[v2p]
            masks = _unpack(out_np[packed_key][si], n, seg_off[si],
                            seg_off[si + 1])[:, cache[si]]
        else:
            masks = _point_masks(out_np[packed_key][si], n, 0,
                                 host['num_voxels'][si], v2p, native)
        results[scene['name']] = _result(
            out_np['conf'][si][:n], out_np['label_idx'][si][:n], masks,
            valid_class_ids)
    return results


def device_masks_to_results(out, host, valid_class_ids, scene_idx,
                            native=True):
    """Host side: unpack one scene's full-width result (make_device_postproc)
    into the detection_to_masks result dict, masks over the scene's points."""
    out = {k: v.cpu().numpy() for k, v in out.items()}
    n = int(out['n_keep'])
    warn_cap(host, scene_idx, out['cluster_cap_hit'])
    if 'interleaved_vs' in host:                 # key-pyramid layout
        start = scene_idx * host['interleaved_vs']
    else:                                        # host maps: tail-padded
        start = int(np.sum(host['num_voxels'][:scene_idx]))
    masks = _point_masks(out['masks_packed'], n, start,
                         host['num_voxels'][scene_idx],
                         np.asarray(host['vox2point'][scene_idx]), native)
    return {host['scene'][scene_idx]['name']: _result(
        out['conf'][:n], out['label_idx'][:n], masks, valid_class_ids)}
