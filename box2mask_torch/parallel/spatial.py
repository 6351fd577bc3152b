"""Spatial sharding: ONE scene's U-Net split over ranks (port of
box2mask_tpu/parallel/spatial.py).

For scenes too large for one device at full resolution (the reference
downsamples them instead). The voxels are key-sorted (x-major), so a
contiguous range of sorted rows is a slab in x:

  * the host splits one scene's sorted rows into D balanced contiguous
    slabs, one per rank (build_spatial_unet_batch); coarser levels follow
    the level-0 boundaries;
  * levels < G (--spatial_gather_level) run sharded: a conv at level l
    needs rows within its reach of the slab boundary, the HALO, which each
    rank receives from its neighbours before every conv (halo_extend: one
    send each way, edge ranks receive zeros), and it convolves over the
    extended rows [from_left | local | from_right];
  * at level G the local rows of every rank are summed into one replicated
    array (an all-reduce of a zero buffer with this rank's slot filled),
    and levels >= G run replicated on every rank;
  * the segment pool sums and counts over every rank (two all-reduces), so
    the heads see the whole scene.

The JAX package runs one process over a D-device mesh under shard_map; here
one process drives each rank over torch.distributed (parallel/mesh.py: NCCL,
one card per rank, or gloo, which takes CPU tensors for its sends, so a
gloo rank on a card stages the halo rows through the host). The backward
runs through each collective's transpose: all-reduce -> all-reduce, the
halo exchange -> the reverse exchange, added into the rows that were sent.
`SpatialSelectionNet` subclasses nn/unet.SelectionNet, so its state_dict
(names, shapes, order) is SelectionNet's and checkpoints interchange.

The key operands keep only what the port's key-matching kernels read: each
shard's compact sorted extended keys (`sp_ext_keys{l}`), the gather from
the halo layout into them (`sp_ext_map{l}`), where the local rows start
(`sp_ext_lo{l}`) and the local coarse keys of the down convs
(`sp_kcd_okeys{l}`). The TPU's window plans (sp_kc*_base / cnt) do not
exist: the kernels search the keys themselves. Nor do the down convs'
transpose maps (sp_kcd_par / widx): sparse/key_conv.py's down-conv
backward computes dx with the stride_parent kernel over (local coarse
keys, extended fine keys), where an extended fine row whose parent lives
on a neighbour finds no key and gets 0, the function the JAX `_kcd_bwd`
computes with par's sentinel; that row's cotangent reaches the neighbour
through the halo exchange's backward.
"""

from __future__ import annotations

import functools
import hashlib
import re
import warnings

import numpy as np
import torch
import torch.distributed as dist

from box2mask_torch import tracing
from box2mask_torch.datasets import tables
from box2mask_torch.datasets.batching import map_semantics_to_idx
from box2mask_torch.engine import state as S
from box2mask_torch.engine.hostload import upload
from box2mask_torch.nn.losses import compute_losses
from box2mask_torch.nn.modules import MaskedBatchNorm
from box2mask_torch.nn.unet import SelectionNet
from box2mask_torch.parallel import mesh as M
from box2mask_torch.runtime import resolve_device
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import ops
from box2mask_torch.sparse.coords import (_SHIFT, batch_pyramids,
                                          build_scene_pyramid,
                                          kernel_offsets, pack, round_up)
from box2mask_torch.sparse.keys import AXIS_BITS, AXIS_MAX, SENT_KEY

# this rank's halo exchanges and the bytes it sent in them since
# reset_counts; their time is read under torch.profiler, where each
# exchange is a 'spatial.halo_exchange' span (the level-G all-reduce a
# 'spatial.level_gather' one, the pool's a 'spatial.pool_all_reduce')
HALO = {'exchanges': 0, 'bytes': 0}


def reset_counts():
    HALO['exchanges'] = HALO['bytes'] = 0


# ------------------------------------------------------------------- host
def plan_shards(vox_coords, n_shards, kernel_size=3, halo_pad=None,
                bucket=256):
    """Split a key-sorted scene into contiguous shards with halo maps (the
    level-0 conv stack of make_spatial_conv_stack). Returns a dict of
    stacked per-shard arrays:
      nmap: (D, pad, K) int32 neighbor maps into the extended row space
            [0,H) = halo from the left neighbor shard, [H, H+pad) = local,
            [H+pad, H+2H) = halo from the right; missing == H+pad+H,
      slab_left / slab_right: (D, H) int32 local rows each shard sends to
            its left / right neighbor (sentinel pad for none),
      valid: (D, pad) bool, num: (D,) int32, pad, halo."""
    c = np.asarray(vox_coords)
    keys = pack(c)
    if not (np.diff(keys) > 0).all():
        raise ValueError('vox_coords must be key-sorted unique')
    n = len(keys)
    D = n_shards
    per = -(-n // D)
    bounds = [min(i * per, n) for i in range(D + 1)]
    half = kernel_size // 2
    offs = kernel_offsets(kernel_size, 1)
    pad = max(round_up(per, bucket), bucket)
    H = pad if halo_pad is None else halo_pad

    nmaps = np.full((D, pad, len(offs)), H + pad + H, np.int32)
    slab_l = np.full((D, H), pad, np.int32)   # rows sent to the LEFT nbr
    slab_r = np.full((D, H), pad, np.int32)   # rows sent to the RIGHT nbr
    valid = np.zeros((D, pad), bool)
    # the largest key delta of a k^3 offset: half*(1<<2S) + half*(1<<S) +
    # half with coords.pack's field shift S
    span = np.int64(half) * ((1 << (2 * _SHIFT)) + (1 << _SHIFT) + 1)
    for d in range(D):
        lo, hi = bounds[d], bounds[d + 1]
        nd = hi - lo
        valid[d, :nd] = True
        hl_lo = np.searchsorted(keys[:lo], keys[lo] - span) if nd else lo
        hr_hi = (lo + nd + np.searchsorted(keys[hi:], keys[hi - 1] + span + 1)
                 if nd else hi)
        hl_n = lo - hl_lo
        hr_n = hr_hi - hi
        if hl_n > H or hr_n > H:
            raise ValueError(f'halo overflow: need {max(hl_n, hr_n)} > {H}')
        if d > 0:
            # left-halo keys sit right-aligned at ext[H-hl_n:H): the source
            # rows go right-aligned in the slab as well
            start_in_prev = hl_lo - bounds[d - 1]
            slab_r[d - 1, H - hl_n:] = np.arange(start_in_prev,
                                                 start_in_prev + hl_n)
        if d < D - 1:
            slab_l[d + 1, :hr_n] = np.arange(0, hr_n)
        ext_keys = np.full(H + pad + H, np.int64(1) << 62, np.int64)
        ext_keys[H - hl_n:H] = keys[hl_lo:lo]
        ext_keys[H:H + nd] = keys[lo:hi]
        ext_keys[H + pad:H + pad + hr_n] = keys[hi:hr_hi]
        order = np.argsort(ext_keys, kind='stable')
        sk = ext_keys[order]
        n_ext = int(np.searchsorted(sk, np.int64(1) << 61))
        for k, off in enumerate(offs):
            q = pack(c[lo:hi] + off[None, :])
            pos = np.searchsorted(sk[:n_ext], q)
            hit = (pos < n_ext) & (sk[np.minimum(pos, n_ext - 1)] == q)
            nmaps[d, :nd, k] = np.where(hit, order[np.minimum(pos, n_ext - 1)],
                                        H + pad + H)
    return {'nmap': nmaps, 'slab_left': slab_l, 'slab_right': slab_r,
            'valid': valid, 'num': valid.sum(1).astype(np.int32),
            'pad': pad, 'halo': H}


def build_spatial_unet_batch(ret, n_shards, gather_level=3, stem_kernel=5,
                             bucket=128, halo_bucket=128, seg_bucket=64,
                             num_levels=8, sem_id2idx=None, key_conv=False):
    """Host: the sharded batch of ONE scene's SelectionNet forward.

    Returns (dev, meta):
      dev: 'sp_*' arrays lead with the shard axis (D, ...), each rank takes
           its row (local_batch), except the replicated 'sp_gather_rows';
           everything else is replicated: the standard padded pyramid of
           the scene under 'g_' (levels >= gather_level run on it) and the
           segment-level arrays under their batch names;
      meta: halos and pads per sharded level, G, D, the level-G pads, the
           segment pad, the key-sort permutation, bounds of levels 0 and G.

    Halo sizes are measured from the scene's neighbor maps (the rows each
    shard's consumers reference beyond its slab), rounded to halo_bucket;
    a halo past the smallest shard raises ValueError (use fewer shards)."""
    G, D = gather_level, n_shards
    coords = np.asarray(ret['vox_coords'])
    keys0 = pack(coords)
    perm = np.argsort(keys0, kind='stable')
    if len(np.unique(keys0)) != len(keys0):
        raise ValueError('voxel coords must be unique')
    coords = coords[perm]
    feats = np.asarray(ret['vox_features'])[perm]
    vox_seg = np.asarray(ret['seg2vox'])[perm]        # per-voxel segment id

    pyr = build_scene_pyramid(coords, num_levels=num_levels,
                              stem_kernel=stem_kernel)
    level_keys = [pack(pyr[f'coords{l}'].astype(np.int64))
                  for l in range(num_levels)]
    n_l = [len(k) for k in level_keys]

    # shard bounds: balanced at level 0; coarser levels floor the level-0
    # boundary keys, so every level's slab d covers about the same space.
    # Flooring does not keep the x-major order (floor((0,5,0)) = (0,4,0) >
    # (0,0,0) = floor((1,0,0)) at level 1), so the first slab starts at
    # row 0 of every level and the bounds never decrease: every coarse row
    # belongs to one slab. The JAX package's bounds start at the floored
    # first key, and coarse rows below it belong to no slab (ROADMAP
    # section C); any partition into contiguous slabs computes the same
    # function, the halos being measured from the maps below.
    bounds = np.zeros((G + 1, D + 1), np.int64)
    per = -(-n_l[0] // D)
    bounds[0] = [min(i * per, n_l[0]) for i in range(D + 1)]
    for l in range(1, G + 1):
        m = ~np.int64((1 << l) - 1)
        bkeys = []
        for d in range(D + 1):
            b0 = bounds[0][d]
            if b0 >= n_l[0]:
                bkeys.append(np.int64(1) << 62)
            else:
                c0 = pyr['coords0'][b0].astype(np.int64)
                bkeys.append(pack((c0 & m)[None, :])[0])
        bounds[l] = np.searchsorted(level_keys[l], np.asarray(bkeys))
        bounds[l][0], bounds[l][-1] = 0, n_l[l]
        bounds[l] = np.maximum.accumulate(bounds[l])

    pads = [max(round_up(int(np.diff(bounds[l]).max()), bucket), bucket)
            for l in range(G)]
    padG_shard = max(round_up(int(np.diff(bounds[G]).max()), bucket), bucket)

    # halo needs per sharded level, from the scene's maps. Consumers of
    # level-l rows: nmap3_l (out rows level l), nmap5_0 (l == 0), down{l}
    # (out rows level l+1), up_parent{l-1} (out rows level l-1)
    need = np.zeros((G, D, 2), np.int64)
    big = np.iinfo(np.int64).max

    def _account_map(mp, in_level, out_bounds):
        mp = np.asarray(mp, np.int64)     # int64 BEFORE the max sentinel
        if mp.ndim == 1:
            mp = mp[:, None]
        masked_min = np.where(mp < 0, big, mp).min(axis=1)
        masked_max = np.where(mp < 0, -1, mp).max(axis=1)
        for d in range(D):
            lo_o, hi_o = out_bounds[d], out_bounds[d + 1]
            mi = masked_min[lo_o:hi_o]
            ma = masked_max[lo_o:hi_o]
            mi = mi[mi != big]
            ma = ma[ma >= 0]
            if not len(mi):
                continue
            lo_i, hi_i = bounds[in_level][d], bounds[in_level][d + 1]
            need[in_level, d, 0] = max(need[in_level, d, 0],
                                       lo_i - int(mi.min()))
            need[in_level, d, 1] = max(need[in_level, d, 1],
                                       int(ma.max()) + 1 - hi_i)

    for l in range(G):
        _account_map(pyr[f'nmap3_{l}'], l, bounds[l])
        if l == 0:
            _account_map(pyr['nmap5_0'], 0, bounds[0])
        _account_map(pyr[f'down{l}'], l, bounds[l + 1])
        if l + 1 < G:
            _account_map(pyr[f'up_parent{l}'], l + 1, bounds[l])
    halos = [max(halo_bucket, round_up(int(need[l].max()), halo_bucket))
             for l in range(G)]
    for l in range(G):
        smallest = int(np.diff(bounds[l]).min())
        if halos[l] > smallest:
            raise ValueError(
                f'level {l}: halo {halos[l]} exceeds smallest shard '
                f'{smallest}; use fewer shards for this scene')

    dev = {}

    def _to_ext(mp, in_level, d):
        """Global row refs -> ext-space indices of shard d (sentinel =
        ext size)."""
        H = halos[in_level]
        pad = pads[in_level] if in_level < G else padG_shard
        lo, hi = bounds[in_level][d], bounds[in_level][d + 1]
        sent = H + pad + H
        mp = np.asarray(mp, np.int64)
        out = np.where(mp < 0, sent, mp - lo + H)
        # right-halo rows sit after the PADDED local block
        out = np.where(mp >= hi, mp - hi + H + pad, out)
        assert ((out >= 0) & (out <= sent)).all()
        return out.astype(np.int32)

    def _shard_rows(arr, l, out_bounds, fill):
        """Stack per-shard row slices of a per-row array, padded."""
        pad = pads[l] if l < G else padG_shard
        arr = np.asarray(arr)
        out = np.full((D, pad) + arr.shape[1:], fill, arr.dtype)
        for d in range(D):
            lo, hi = out_bounds[d], out_bounds[d + 1]
            out[d, :hi - lo] = arr[lo:hi]
        return out

    def _ext_maps(key, row_level, out_bounds, in_level):
        rows = _shard_rows(pyr[key], row_level, out_bounds, -1)
        return np.stack([_to_ext(rows[d], in_level, d) for d in range(D)])

    # features / validity / pooling at level 0
    dev['sp_feats'] = _shard_rows(feats.astype(np.float32), 0, bounds[0], 0.0)
    seg_ids = np.asarray(vox_seg, np.int64)
    S = int(seg_ids.max()) + 1 if len(seg_ids) else 0
    S_pad = max(round_up(max(S, 1), seg_bucket), seg_bucket)
    dev['sp_pool'] = _shard_rows(seg_ids.astype(np.int32), 0, bounds[0],
                                 S_pad)
    for l in range(G):
        nd = np.diff(bounds[l])
        valid = np.zeros((D, pads[l]), bool)
        for d in range(D):
            valid[d, :nd[d]] = True
        dev[f'sp_valid{l}'] = valid
        dev[f'sp_num{l}'] = nd.astype(np.int32)

    # maps into ext spaces, per shard
    for l in range(G):
        H = halos[l]
        dev[f'sp_nmap3_{l}'] = _ext_maps(f'nmap3_{l}', l, bounds[l], l)
        # slabs: rows each shard sends (local indices; sentinel pad =
        # zeros): my LAST H rows to the right, my FIRST H rows to the left
        slabL = np.full((D, H), pads[l], np.int32)
        slabR = np.full((D, H), pads[l], np.int32)
        for d in range(D):
            nd = bounds[l][d + 1] - bounds[l][d]
            k = min(H, nd)
            if d + 1 < D:
                slabR[d, H - k:] = np.arange(nd - k, nd)
            if d > 0:
                slabL[d, :k] = np.arange(0, k)
        dev[f'sp_slabL{l}'] = slabL
        dev[f'sp_slabR{l}'] = slabR
    dev['sp_nmap5'] = _ext_maps('nmap5_0', 0, bounds[0], 0)
    for l in range(G - 1):
        dev[f'sp_down{l}'] = _ext_maps(f'down{l}', l + 1, bounds[l + 1], l)
        dev[f'sp_up_parent{l}'] = _ext_maps(f'up_parent{l}', l, bounds[l],
                                            l + 1)
        dev[f'sp_up_widx{l}'] = _shard_rows(pyr[f'up_widx{l}'], l,
                                            bounds[l], 0)
    # the down conv into the gather level
    dev['sp_downG'] = _ext_maps(f'down{G - 1}', G, bounds[G], G - 1)

    # replicated pyramid for levels >= G (standard padded one-scene batch)
    g = batch_pyramids([pyr], vox_bucket=bucket)
    padG_full = g[f'valid{G}'].shape[0]
    for k, v in g.items():
        dev[f'g_{k}'] = v
    # up transpose G -> G-1: parent rows index the REPLICATED level-G array
    up_pG = _shard_rows(pyr[f'up_parent{G - 1}'], G - 1, bounds[G - 1], -1)
    dev['sp_up_parentG'] = np.where(up_pG < 0, padG_full,
                                    up_pG).astype(np.int32)
    dev['sp_up_widxG'] = _shard_rows(pyr[f'up_widx{G - 1}'], G - 1,
                                     bounds[G - 1], 0)
    # gather: padded level-G row -> row of the flattened (D * padG_shard)
    gather_rows = np.full(padG_full, D * padG_shard, np.int32)
    for d in range(D):
        lo, hi = bounds[G][d], bounds[G][d + 1]
        gather_rows[lo:hi] = d * padG_shard + np.arange(hi - lo)
    dev['sp_gather_rows'] = gather_rows

    if key_conv:
        _emit_spatial_key_operands(dev, pyr, bounds, halos, pads,
                                   padG_shard, G, D)

    # segment-level arrays (replicated) under the standard batch names
    loc = np.zeros((S_pad, 3), np.float32)
    il = np.asarray(ret['input_location'], np.float32)
    loc[:len(il)] = il
    dev['input_location'] = loc
    dev['seg_valid'] = np.arange(S_pad) < S
    dev['num_segments'] = np.int32(S)
    dev['batch_ids'] = np.where(np.arange(S_pad) < S, 0, -1).astype(np.int32)

    # supervision targets (replicated; datasets/batching.py's names, so
    # nn/losses.compute_losses reads the spatial batch unchanged)
    if 'gt_bb_offsets' in ret:
        def _seg_pad(key, fill, dtype):
            a = np.asarray(ret[key])
            out = np.full((S_pad,) + a.shape[1:], fill, dtype)
            out[:len(a)] = a
            return out

        dev['gt_bb_offsets'] = _seg_pad('gt_bb_offsets', 0.0, np.float32)
        dev['gt_bb_bounds'] = _seg_pad('gt_bb_bounds', 0.0, np.float32)
        dev['fg_instances'] = _seg_pad('fg_instances', False, bool)
        gt_sem = _seg_pad('gt_semantics', 0, np.int32)
        dev['gt_semantics'] = gt_sem
        if sem_id2idx is not None:
            dev['gt_semantics_idx'] = np.where(
                dev['seg_valid'], map_semantics_to_idx(gt_sem, sem_id2idx),
                tables.IGNORE).astype(np.int32)

    meta = {'halos': halos, 'pads': pads, 'gather_level': G, 'n_shards': D,
            'padG_shard': padG_shard, 'padG_full': padG_full, 'S_pad': S_pad,
            'perm': perm, 'bounds0': bounds[0].copy(),
            'boundsG': bounds[G].copy()}
    return dev, meta


def _emit_spatial_key_operands(dev, pyr, bounds, halos, pads, padG_shard, G,
                               D):
    """The key operands of the sharded levels l < G (JAX
    _emit_spatial_kc_plans, :425, without its window plans and transpose
    maps; the module docstring says why). Each shard's extended rows
    [halo | local | halo] are a CONTIGUOUS range of the scene's sorted
    rows, so they are sorted themselves:

      * sp_ext_keys{l}:  (D, ext_pad) compact sorted int32 keys: left-halo,
        local and right-halo rows back to back, SENT-padded,
      * sp_ext_map{l}:   (D, ext_pad) gather from halo_extend's [H|pad|H]
        slot layout into the compact order,
      * sp_ext_lo{l}:    (D, 1) start of the local rows in the compact order,
      * sp_kcd_okeys{l}: (D, out_pad) the shard's local level-(l+1) keys,
        the down conv's output rows.

    Same-level convs compute outputs over the whole ext space (input space
    == output space, so the same-level autograd's mirrored dx applies) and
    keep rows [ext_lo, ext_lo + pad). Needs coords in the 10-bit-per-axis
    key packing; outside it a RuntimeWarning says the neighbor-map halo
    route is used, and no key operand is emitted."""
    for l in range(G + 1):
        c = np.asarray(pyr[f'coords{l}'])
        if len(c) and (c.max() >= AXIS_MAX or c.min() < 0):
            warnings.warn(
                f'scene exceeds the {AXIS_MAX}-voxel/axis key packing; '
                'sharded key_conv plans skipped (nmap halo path used)',
                RuntimeWarning)
            return

    def keys10(l):
        c = pyr[f'coords{l}'].astype(np.int64)
        return ((c[:, 0] << (2 * AXIS_BITS)) | (c[:, 1] << AXIS_BITS)
                | c[:, 2]).astype(np.int32)

    k10 = [keys10(l) for l in range(G + 1)]
    for l in range(G):
        H, pad = halos[l], pads[l]
        ext_pad = H + pad + H
        out_pad = pads[l + 1] if l + 1 < G else padG_shard
        nd_all = np.diff(bounds[l])
        ext_keys = np.full((D, ext_pad), SENT_KEY, np.int32)
        ext_map = np.zeros((D, ext_pad), np.int32)
        ext_lo = np.zeros((D, 1), np.int32)
        okeys = np.full((D, out_pad), SENT_KEY, np.int32)
        for d in range(D):
            lo, hi = int(bounds[l][d]), int(bounds[l][d + 1])
            nd = hi - lo
            kL = min(H, int(nd_all[d - 1])) if d > 0 else 0
            kR = min(H, int(nd_all[d + 1])) if d + 1 < D else 0
            n_ext = kL + nd + kR
            ext_keys[d, :n_ext] = k10[l][lo - kL:hi + kR]
            ext_map[d, :n_ext] = np.concatenate([
                (H - kL) + np.arange(kL),          # halo_extend left slots
                H + np.arange(nd),                 # local slots
                H + pad + np.arange(kR)])          # right slots
            ext_lo[d, 0] = kL
            loc, hic = int(bounds[l + 1][d]), int(bounds[l + 1][d + 1])
            okeys[d, :hic - loc] = k10[l + 1][loc:hic]
        dev[f'sp_ext_keys{l}'] = ext_keys
        dev[f'sp_ext_map{l}'] = ext_map
        dev[f'sp_ext_lo{l}'] = ext_lo
        dev[f'sp_kcd_okeys{l}'] = okeys


def _unread(key, G, key_route):
    """True for the arrays of a spatial batch that SpatialSelectionNet
    does not read: the replicated pyramid's coords, scene ids, stem map and
    levels < G, and on the key route the neighbor maps of the sharded
    levels (a level-0 map alone holds 125 int32 per voxel)."""
    if key.startswith('g_'):
        name = key[2:]
        return (name.startswith(('coords', 'batch', 'nmap5'))
                or int(re.search(r'(\d+)$', name).group(1)) < G)
    return key_route and key.startswith(('sp_nmap', 'sp_down'))


def check_same_scene(dev, group, device):
    """Raise unless every rank of `group` built the same host batch `dev`:
    a digest of its level-0 features (every shard's), row counts and
    segment locations, which an augmentation drawn apart changes. The halo
    exchanges would otherwise splice rows of different scenes."""
    h = hashlib.blake2b(digest_size=8)
    for k in ('sp_num0', 'sp_feats', 'input_location'):
        h.update(np.ascontiguousarray(dev[k]).tobytes())
    M.same_on_every_rank(int.from_bytes(h.digest(), 'little') >> 1, group,
                         device, 'scenes')


def local_batch(dev, rank, device):
    """Rank `rank`'s batch on `device`: its row of every sharded 'sp_*'
    array, the replicated arrays whole, except the arrays the net does not
    read (_unread). The start of the local rows of an extended key row
    (sp_ext_lo{l}) stays on the host, a Python int, as the slice of the
    same-level convs reads it."""
    G = sum(1 for k in dev if k.startswith('sp_valid'))
    key_route = 'sp_ext_keys0' in dev
    arrays, ints = {}, {}
    for k, v in dev.items():
        if _unread(k, G, key_route):
            continue
        if k.startswith('sp_ext_lo'):
            ints[k] = int(np.asarray(v)[rank, 0])
        elif k.startswith('sp_') and k != 'sp_gather_rows':
            arrays[k] = np.asarray(v)[rank]
        else:
            arrays[k] = v
    return dict(upload(arrays, device), **ints)


# ------------------------------------------------------------ collectives
def _peer(group, rank):
    return dist.get_global_rank(group, rank) if group is not None else rank


def exchange(to_right, to_left, group):
    """(from_left, from_right): `to_right` goes one rank right and
    `to_left` one rank left, each rank receiving its neighbours' blocks;
    an edge rank receives zeros on its open side. Under gloo the blocks of
    a card travel through the host (gloo's sends take CPU tensors)."""
    D, r = dist.get_world_size(group), dist.get_rank(group)
    device = to_right.device
    host = device.type != 'cpu' and dist.get_backend(group) != 'nccl'
    with tracing.span('spatial.halo_exchange'):
        if host:
            to_right, to_left = to_right.cpu(), to_left.cpu()
        to_right, to_left = to_right.contiguous(), to_left.contiguous()
        from_left = torch.zeros_like(to_right)
        from_right = torch.zeros_like(to_left)
        p2p = []
        if r > 0:
            left = _peer(group, r - 1)
            p2p += [dist.P2POp(dist.isend, to_left, left, group),
                    dist.P2POp(dist.irecv, from_left, left, group)]
        if r + 1 < D:
            right = _peer(group, r + 1)
            p2p += [dist.P2POp(dist.isend, to_right, right, group),
                    dist.P2POp(dist.irecv, from_right, right, group)]
        if p2p:
            for req in dist.batch_isend_irecv(p2p):
                req.wait()
            HALO['exchanges'] += 1
            HALO['bytes'] += sum(op.tensor.numel() * op.tensor.element_size()
                                 for op in p2p if op.op is dist.isend)
        if host:
            from_left = from_left.to(device)
            from_right = from_right.to(device)
    return from_left, from_right


class _HaloExtend(torch.autograd.Function):
    """[from_left | x | from_right] (JAX halo_extend: two ppermutes). The
    backward is their transpose: each received block's cotangent goes back
    to the rank it came from (the same exchange, the blocks swapped), which
    adds it into the rows it sent."""

    @staticmethod
    def forward(ctx, x, slab_left, slab_right, group):
        xz = torch.cat([x, x.new_zeros(1, x.shape[1])])
        to_right = xz[slab_right.long()]
        to_left = xz[slab_left.long()]
        from_left, from_right = exchange(to_right, to_left, group)
        ctx.save_for_backward(slab_left, slab_right)
        ctx.group = group
        return torch.cat([from_left, x, from_right])

    @staticmethod
    def backward(ctx, g):
        slab_left, slab_right = ctx.saved_tensors
        H = slab_left.shape[0]
        pad = g.shape[0] - 2 * H
        g_to_left, g_to_right = exchange(g[H + pad:].contiguous(),
                                         g[:H].contiguous(), ctx.group)
        dx = torch.cat([g[H:H + pad], g.new_zeros(1, g.shape[1])])
        dx.index_add_(0, slab_right.long(), g_to_right)
        dx.index_add_(0, slab_left.long(), g_to_left)
        return dx[:pad], None, None, None


def halo_extend(x_local, slab_left, slab_right, group):
    """This rank's extended rows [from-left | local | from-right]: x_local
    (pad, C); slab_*: (H,) local rows to send (sentinel pad sends the zero
    row). Differentiable in x_local."""
    return _HaloExtend.apply(x_local, slab_left, slab_right, group)


def all_reduce_sum(x, group):
    """Sum over the ranks; the backward all-reduces the cotangent (the
    transpose of psum)."""
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=group)


class _AllReduceMax(torch.autograd.Function):
    """pmax: the elementwise maximum over the ranks. The JAX package cannot
    differentiate it (jax.lax.pmax has no differentiation rule, ROADMAP
    section C); the port raises the same way."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "Differentiation rule for 'pmax' not implemented: the JAX "
            'package cannot train --max_pool_segments_detection_net under '
            '--spatial_shards either')


def all_reduce_max(x, group):
    return _AllReduceMax.apply(x, group)


def gather_to_replicated(x, gather_rows, group):
    """The shards' level-G rows -> the replicated padded level-G array:
    an all-reduce of a zero buffer holding this rank's rows in its slot,
    then the rows `gather_rows` (D * ps, the zero row, for padding). An
    all-reduce, not an all_gather: its transpose SUMS every rank's
    cotangents for each slot, where all_gather's keeps only the local
    block and drops the cross-shard contributions that the decoder's up
    convs send (JAX spatial.py:673-681)."""
    D, r = dist.get_world_size(group), dist.get_rank(group)
    ps, C = x.shape
    buf = torch.cat([x.new_zeros(r * ps, C), x,
                     x.new_zeros((D - r - 1) * ps, C)])
    with tracing.span('spatial.level_gather'):
        flat = all_reduce_sum(buf, group)
    flat = torch.cat([flat, x.new_zeros(1, C)])
    return flat[gather_rows.long()]


# ------------------------------------------------------------------ convs
def _nmap_conv(op, x, w, compute_dtype, use_pallas):
    ext = halo_extend(x, op['slab_left'], op['slab_right'], op['group'])
    return ops.gather_conv(ext, op['nmap'], w, compute_dtype, use_pallas)


def _key_conv(op, x, w, compute_dtype, use_pallas):
    """The key route's conv over this rank's extended rows (JAX ops.py:
    42-85): the halo exchange, the gather into the shard's compact sorted
    order, then a same-level conv over the whole extended space (input
    space == output space, so the mirrored dx applies) keeping the local
    rows, or a down conv onto the shard's local coarse keys. The stem
    takes the 5^3 stem kernel, which computes the JAX spatial stem's
    _kernel at 5^3."""
    ext = halo_extend(x, op['slab_left'], op['slab_right'], op['group'])
    xe = ext[op['ext_map'].long()]
    keys = op['ext_keys'].reshape(1, -1)
    ks, scale = op['ksize'], op['scale']
    if 'keys_out' in op:
        return KC.key_conv_down_train(xe, keys, op['keys_out'], w,
                                      scale=scale)
    if ks == 5 and scale == 1 and x.shape[1] <= 8:
        out = KC.key_conv_stem_train(xe, keys, w)
    else:
        out = KC.key_conv_train(xe, keys, keys.reshape(-1), w,
                                kernel_size=ks, scale=scale, guard=True)
    return out[op['ext_lo']:op['ext_lo'] + op['pad']]


def nmap_operand(batch, l, nmap, group):
    """ops.gather_conv's operand of a halo-exchanged neighbor-map conv of
    level-l rows over `nmap` (into the extended rows)."""
    return functools.partial(_nmap_conv, {
        'nmap': nmap, 'slab_left': batch[f'sp_slabL{l}'],
        'slab_right': batch[f'sp_slabR{l}'], 'group': group})


def key_operand(batch, l, kind, group, stem_kernel=5):
    """ops.gather_conv's operand of a key-route conv of level-l rows:
    `kind` '3' / '5' a same-level conv at 3^3 / the stem's kernel, 'd' the
    down conv l -> l+1."""
    op = {'ksize': {'3': 3, '5': stem_kernel, 'd': 2}[kind], 'scale': 1 << l,
          'slab_left': batch[f'sp_slabL{l}'],
          'slab_right': batch[f'sp_slabR{l}'], 'group': group,
          'ext_map': batch[f'sp_ext_map{l}'],
          'ext_keys': batch[f'sp_ext_keys{l}']}
    if kind == 'd':
        op['keys_out'] = batch[f'sp_kcd_okeys{l}']
    else:
        op['ext_lo'] = batch[f'sp_ext_lo{l}']
        op['pad'] = batch[f'sp_valid{l}'].shape[-1]
    return functools.partial(_key_conv, op)


def spatial_conv(x_local, plan, w, group, compute_dtype=torch.bfloat16):
    """One halo-exchanged sparse conv: exchange boundary rows, then the
    gather-GEMM over the extended-space neighbor map."""
    ext = halo_extend(x_local, plan['slab_left'], plan['slab_right'], group)
    return ops.gather_conv(ext, plan['nmap'], w, compute_dtype=compute_dtype)


def make_spatial_conv_stack(n_layers, group, compute_dtype=torch.float32):
    """f(x, nmap, slab_l, slab_r, ws) -> (pad, C): `n_layers` successive
    3^3 convs (relu between) over this rank's shard of one scene."""
    def stack(x, nmap, slab_l, slab_r, ws):
        plan = {'nmap': nmap, 'slab_left': slab_l, 'slab_right': slab_r}
        for i in range(n_layers):
            x = spatial_conv(x, plan, ws[i], group, compute_dtype)
            if i + 1 < n_layers:
                x = torch.relu(x)
        return x
    return stack


# ------------------------------------------------------------------ model
_LEVEL = re.compile(r'(?:stem_|(?:down|enc|up|dec)(\d)_)')


class SpatialSelectionNet(SelectionNet):
    """SelectionNet's forward over one scene sharded across the ranks of
    `group` (JAX SpatialSelectionNet, :560-768). It is a SelectionNet: the
    same modules, names, shapes and parameter order, so checkpoints and
    state_dicts interchange. The BNs of levels < gather_level (the stem's
    included) and of per-voxel heads take their moments over the ranks;
    those of levels >= gather_level and of pooled heads run on replicated
    rows. Activations stay f32; no neighbor-map kernel, no remat (the JAX
    spatial net has neither). The batch is a rank's local_batch."""

    def __init__(self, num_classes, in_channels,
                 heads=('mlp_offsets', 'mlp_bounds', 'mlp_bb_scores',
                        'mlp_semantics'),
                 layers=2, gather_level=3, do_segment_pooling=True,
                 max_pool_segments=False, mlp_bounds_relu=False,
                 stem_kernel=5, compute_dtype=torch.bfloat16, group=None):
        super().__init__(num_classes, in_channels, heads=heads,
                         layers=layers, do_segment_pooling=do_segment_pooling,
                         max_pool_segments=max_pool_segments,
                         mlp_bounds_relu=mlp_bounds_relu,
                         stem_kernel=stem_kernel,
                         compute_dtype=compute_dtype)
        if not 1 <= gather_level <= 7:
            raise ValueError(f'gather_level {gather_level} not in [1, 7]')
        self.gather_level = gather_level
        self.group = group
        for name, m in self.named_modules():
            if not isinstance(m, MaskedBatchNorm):
                continue
            lv = _LEVEL.match(name)
            sharded = (int(lv.group(1) or 0) < gather_level if lv
                       else name.startswith('mlp_per_vox'))
            m.group = group if sharded else None

    def forward(self, batch):
        G, group = self.gather_level, self.group

        def sp_op(l, nmap):
            return nmap_operand(batch, l, nmap, group)

        def sp_kc(l, kind):
            return key_operand(batch, l, kind, group, self.stem_kernel)

        def has_kc(l):
            return f'sp_ext_keys{l}' in batch

        def vn(l):
            if l < G:
                return batch[f'sp_valid{l}'], batch[f'sp_num{l}']
            return batch[f'g_valid{l}'], batch[f'g_num{l}']

        def blocks(x, l, stage):
            nbr = ((sp_kc(l, '3') if has_kc(l)
                    else sp_op(l, batch[f'sp_nmap3_{l}'])) if l < G
                   else batch[f'g_nmap3_{l}'])
            v, n = vn(l)
            for i in range(self.layers):
                x = getattr(self, f'{stage}_block{i}')(x, nbr, v, n)
            return x

        x = self.stem_conv(batch['sp_feats'], sp_kc(0, '5') if has_kc(0)
                           else sp_op(0, batch['sp_nmap5']))
        x = self.stem_bn(x, *vn(0), relu=True)
        skips = [x]
        for l in range(1, 8):
            if l <= G and has_kc(l - 1):
                nbr = sp_kc(l - 1, 'd')
            elif l < G:
                nbr = sp_op(l - 1, batch[f'sp_down{l - 1}'])
            elif l == G:
                nbr = sp_op(G - 1, batch['sp_downG'])
            else:
                nbr = batch[f'g_down{l - 1}']
            x = getattr(self, f'down{l}_conv')(x, nbr)
            if l == G:
                x = gather_to_replicated(x, batch['sp_gather_rows'], group)
            x = getattr(self, f'down{l}_bn')(x, *vn(l), relu=True)
            x = blocks(x, l, f'enc{l}')
            skips.append(x)

        for l in range(6, -1, -1):
            if l + 1 > G:
                xc, op = x, (batch[f'g_up_parent{l}'], batch[f'g_up_widx{l}'])
            elif l + 1 == G:                 # replicated level-G rows
                xc, op = x, (batch['sp_up_parentG'], batch['sp_up_widxG'])
            else:
                xc = halo_extend(x, batch[f'sp_slabL{l + 1}'],
                                 batch[f'sp_slabR{l + 1}'], group)
                op = (batch[f'sp_up_parent{l}'], batch[f'sp_up_widx{l}'])
            x = getattr(self, f'up{l}_tr')(xc, op)
            x = getattr(self, f'up{l}_bn')(x, *vn(l), relu=True)
            x = torch.cat([x, skips[l]], dim=-1)
            x = blocks(x, l, f'dec{l}')

        outputs = {}
        if any('per_vox' in h for h in self.heads):
            outputs['vox_feats'] = x          # this rank's rows
        if self.do_segment_pooling:
            S_pad = batch['seg_valid'].shape[0]
            pool_ids = batch['sp_pool']
            if self.max_pool_segments:
                # a segment with no local rows gives 0, as one device's
                # segment_max does for an empty segment
                part = ops.segment_max(x, pool_ids, S_pad)
                with tracing.span('spatial.pool_all_reduce'):
                    pooled = all_reduce_max(part, group)
            else:
                s = ops.segment_sum(x.float(), pool_ids, S_pad)
                c = ops.segment_sum(torch.ones(x.shape[0], 1,
                                               device=x.device),
                                    pool_ids, S_pad)
                with tracing.span('spatial.pool_all_reduce'):
                    s = all_reduce_sum(s, group)
                    c = all_reduce_sum(c, group)
                pooled = s / torch.clamp(c, min=1.0)
            pv, pn = batch['seg_valid'], batch['num_segments']
        else:
            pooled, (pv, pn) = x, vn(0)
        for head in self.heads:
            mlp = getattr(self, head)
            out = (mlp(x, *vn(0)) if 'per_vox' in head
                   else mlp(pooled, pv, pn))
            if self.mlp_bounds_relu and head == 'mlp_bounds':
                out = torch.relu(out)
            outputs[head] = out
        return outputs


def build_spatial_model(cfg, num_classes, device=None, group=None):
    """SpatialSelectionNet for `cfg` (uninitialized conv kernels, eval
    mode) on `device` (None: the card)."""
    model = SpatialSelectionNet(
        num_classes=num_classes, in_channels=cfg.in_channels,
        heads=tuple(cfg.network_heads), layers=cfg.layers,
        gather_level=cfg.spatial_gather_level,
        do_segment_pooling=cfg.do_segment_pooling,
        max_pool_segments=cfg.max_pool_segments_detection_net,
        mlp_bounds_relu=cfg.mlp_bounds_relu,
        compute_dtype=S.DTYPES[cfg.compute_dtype], group=group)
    model.eval()
    return model.to(resolve_device(device))


# ------------------------------------------------------------------ steps
def make_spatial_apply(model, train=False):
    """fn(local batch) -> head outputs (replicated pooled heads; per-voxel
    outputs are this rank's rows). `train` runs BN on batch moments and
    moves the running statistics alike on every rank."""
    def fwd(batch):
        model.train(train)
        with torch.set_grad_enabled(train):
            return model(batch)
    return fwd


def make_spatial_init(cfg, model, group, seed=0):
    """A TrainState of `model` with seeded kaiming weights, rank 0's
    copied to every rank (the JAX package initialises once, replicated)."""
    state = S.init_state(cfg, model, S.make_optimizer(cfg), seed=seed)
    return M.broadcast_state(state, group)


def make_spatial_train_step(cfg, group):
    """`step(state, batch, lr, bb_w, cs_w) -> (state, loss dict)` of one
    rank on its local batch of ONE spatially sharded scene.

    The loss is computed alike on every rank from the all-reduced segment
    pool. That all-reduce's backward all-reduces the cotangent, so below
    the pool every rank holds D x its own share of each gradient, while
    the head MLPs above it compute the whole gradient on every rank.
    Either way the sum over the ranks is D x the one-device gradient (JAX
    spatial.py:805-813), and mesh.average_grads (the sum / D) recovers it
    for every parameter. The loss dict is the same on every rank and is
    not averaged."""
    def step(state, batch, lr, bb_w, cs_w):
        if any('per_vox' in h for h in state.model.heads):
            raise NotImplementedError('per-vox heads are not supported under '
                                      '--spatial_shards yet')
        state.model.train()
        ld = compute_losses(cfg, state.model(batch), batch, bb_w, cs_w)
        S.backward(ld)
        M.average_grads(state, group)
        S.apply_update(state, lr)
        return state, {k: v.detach() for k, v in ld.items()}
    return step


def make_spatial_val_step(cfg, group):
    """`step(state, batch, bb_w, cs_w) -> loss dict`: the eval-mode
    spatial forward (its halo exchanges and all-reduces need every rank)
    and the losses, the same on every rank."""
    @torch.no_grad()
    def step(state, batch, bb_w, cs_w):
        state.model.eval()
        return compute_losses(cfg, state.model(batch), batch, bb_w, cs_w)
    return step
