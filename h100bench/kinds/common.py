"""What the traffic kinds share: the pool of generated scenes and the
reference's view of one batch."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from h100bench import scenes as G
from h100bench.reference import geometry, voxel

HOST_THREADS = 4


def scene_seeds(seed, n):
    """n scene seeds drawn from the run's seed."""
    return np.random.default_rng(int(seed)).integers(0, 2**31 - 1, n)


def make_scenes(config, seeds, augment=None):
    """[(scene, labels)] from the configuration's generator, one per seed;
    with `augment`, each scene takes the preset's augmentation from a
    RandomState of its seed and its labels are derived after it."""
    spec = dict(config['scene'])
    gen = G.GENERATORS[spec.pop('generator')]

    def one(i):
        s = int(seeds[i])
        scene, labels = gen(s, f'scene{i:03d}_{s}', **spec)
        if augment is not None:
            scene = G.augment(scene, augment, np.random.RandomState(s))
            raw = {'semantics': labels['semantics'],
                   'instances': labels['instances']}
            labels = G.derive_labels(scene['positions'], raw['semantics'],
                                     raw['instances'], scene['segments'])
        return scene, labels
    with ThreadPoolExecutor(HOST_THREADS) as ex:
        return list(ex.map(one, range(len(seeds))))


def reference_batch(config, items, device):
    """The reference's voxels, geometry, features and segment rows of one
    batch of (scene, labels)."""
    m = config['model']
    vox = [voxel.voxelize(s, m['voxel_size'], m['in_channels'] == 6)
           for s, _ in items]
    geo = geometry.build([v['coords'] for v in vox], device)
    feats = torch.as_tensor(np.concatenate([v['features'] for v in vox]),
                            device=device)
    seg_off = np.cumsum([0] + [len(v['segments']) for v in vox])
    pool = torch.as_tensor(np.concatenate(
        [v['vox_seg_row'] + seg_off[i] for i, v in enumerate(vox)]),
        dtype=torch.int64, device=device)
    return {'vox': vox, 'geo': geo, 'feats': feats, 'pool': pool,
            'seg_off': seg_off, 'n_seg': int(seg_off[-1])}
