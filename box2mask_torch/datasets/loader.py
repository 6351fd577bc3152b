"""Dataset classes + prefetching batch loader (the port's copy of
box2mask_tpu/datasets/loader.py; data-parallel shards as in its
num_shards; one scene split over ranks under --spatial_shards).

The loader is a thread-pool prefetcher feeding padded host batches: the
per-scene work is vectorized NumPy (it releases the GIL), and batches are
built ahead of the device in a bounded queue. Every scene draws its
augmentation from its own RandomState (`scene_rng`), so under --fixed_seed a
scene gives the same batch whatever the worker count or order.

Datasets: scannet / arkitscenes / s3dis (the readers in datasets/{name}.py,
on the on-disk layouts they document) plus 'synthetic'
(datasets/synthetic.py) for dataset-free runs and tests.
"""

from __future__ import annotations

import functools
import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from box2mask_torch.datasets import (arkitscenes, augmentation, s3dis,
                                     scannet, supervision, synthetic)
from box2mask_torch.datasets.batching import (_device_maps_ok, build_batch,
                                              common_level_pads)
from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.datasets.voxelize import voxelize_scene
from box2mask_torch.sparse.coords import round_up


def scene_rng(cfg, scene_name, epoch=0):
    """Per-scene RandomState stream: deterministic under --fixed_seed (varying
    with scene name + epoch so TTA eval and training epochs differ), else
    under `cfg.augment_seed` alike, the seed the ranks of a run share
    (parallel/mesh.agree_seeds sets it), fresh OS-entropy without either."""
    seed = (cfg.fixed_seed if cfg.fixed_seed is not None
            else getattr(cfg, 'augment_seed', None))
    if seed is None:
        return np.random.RandomState()
    h = np.uint32(seed)
    with np.errstate(over='ignore'):          # the hash wraps mod 2^32
        for c in f'{scene_name}|{epoch}':
            h = np.uint32(h * np.uint32(31) + np.uint32(ord(c)))
    return np.random.RandomState(int(h))


class SceneDataset:
    """Base: data_list + read_scene -> voxelized+supervised ret dict."""

    dataset_name = None

    def __init__(self, mode, cfg, do_augmentations=True):
        self.mode = mode
        self.cfg = cfg
        self.epoch = 0
        self.do_augmentations = do_augmentations
        self.data_list = self._build_data_list(mode, cfg)
        # debug/overfit harness (reference models/dataloader.py:41-48)
        if cfg.overfit_to_single_scene is not None:
            self.data_list = [self.data_list[cfg.overfit_to_single_scene]] * 100
        if cfg.overfit_to_single_scene_str is not None:
            self.data_list = [cfg.overfit_to_single_scene_str] * 100
        if cfg.dataset_size is not None:
            self.data_list = self.data_list[:cfg.dataset_size]
        _, self.sem_id2idx, _, _ = get_tables(self.table_name)

    @property
    def table_name(self):
        return self.dataset_name if self.dataset_name != 'synthetic' else 'scannet'

    def _build_data_list(self, mode, cfg):
        raise NotImplementedError

    def read_scene(self, scene_name, rng=np.random):
        """-> (scene, labels) dicts."""
        raise NotImplementedError

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, idx):
        scene_name = self.data_list[idx]
        rng = scene_rng(self.cfg, scene_name, self.epoch)
        scene, labels = self.read_scene(scene_name, rng=rng)
        ret = voxelize_scene(scene, self.cfg)
        if self.mode == 'test' or labels is None:
            return ret
        ret['labels'] = labels
        supervision.build_supervision(ret, labels, scene, self.cfg,
                                      self.dataset_name
                                      if self.dataset_name != 'synthetic'
                                      else 'scannet', self.mode)
        return ret

    def get_loader(self, shuffle=True, drop_last=True, batch_size=None,
                   seed=None, num_shards=1, shard=None):
        return BatchLoader(self, self.cfg, batch_size or self.cfg.batch_size,
                           shuffle=shuffle, drop_last=drop_last, seed=seed,
                           num_shards=num_shards, shard=shard)


class Synthetic(SceneDataset):
    dataset_name = 'synthetic'
    SPLIT_SIZES = {'train': 64, 'val': 16, 'test': 8, 'train+val': 80}

    def _build_data_list(self, mode, cfg):
        if mode == 'predict_specific_scene':
            return [cfg.predict_specific_scene]
        n = self.SPLIT_SIZES.get(mode, 16)
        base = {'train': 0, 'val': 10000, 'test': 20000}.get(
            mode.split('+')[0], 0)
        return [f'synth{base + i:05d}_00' for i in range(n)]

    def read_scene(self, scene_name, rng=np.random):
        seed = int(scene_name[5:10])
        cfg = self.cfg
        scene, labels = synthetic.make_scene(
            seed=seed, name=scene_name,
            num_instances=cfg.synthetic_instances,
            points_per_instance=cfg.synthetic_points_per_instance,
            floor_points=cfg.synthetic_floor_points,
            wall_points=cfg.synthetic_wall_points)
        if self.do_augmentations and self.cfg.augmentation:
            scene = augmentation.augment_scene(scene, self.cfg, rng=rng)
            # geometric augs move the GT boxes too: rederive from points
            labels = synthetic.derive_labels(
                scene['positions'], labels['semantics'], labels['instances'],
                scene['segments'])
        return scene, labels


class ScanNet(SceneDataset):
    dataset_name = 'scannet'

    def _build_data_list(self, mode, cfg):
        if mode == 'predict_specific_scene':
            return [cfg.predict_specific_scene]
        if mode == 'train+val':
            d = np.load(cfg.data_split, allow_pickle=True)
            return np.concatenate((d['train'], d['val']))
        return np.load(cfg.data_split, allow_pickle=True)[mode]

    def read_scene(self, scene_name, rng=np.random):
        return scannet.process_scene(scene_name, self.mode, self.cfg,
                                     do_augmentations=self.do_augmentations,
                                     rng=rng)


class ARKitScenes(SceneDataset):
    dataset_name = 'arkitscenes'

    def _build_data_list(self, mode, cfg):
        if mode == 'predict_specific_scene':
            return [cfg.predict_specific_scene]
        sub = {'train': '3dod/Training', 'val': '3dod/Validation'}[mode]
        files = [f for f in os.listdir(os.path.join(cfg.data_dir, sub))
                 if f.startswith('4')]
        return np.array(files)

    def read_scene(self, scene_name, rng=np.random):
        return arkitscenes.process_scene(
            scene_name, self.mode, self.cfg,
            do_augmentations=self.do_augmentations,
            subsample_rate=self.cfg.subsample_rate, rng=rng)


class S3DIS(SceneDataset):
    dataset_name = 's3dis'

    def _build_data_list(self, mode, cfg):
        if mode == 'predict_specific_scene':
            return [cfg.predict_specific_scene]
        return s3dis.get_scene_names(mode, cfg)

    def read_scene(self, scene_name, rng=np.random):
        return s3dis.process_scene(scene_name, self.mode, self.cfg,
                                   do_augmentations=self.do_augmentations,
                                   rng=rng)


DATASETS = {'scannet': ScanNet, 'arkitscenes': ARKitScenes, 's3dis': S3DIS,
            'synthetic': Synthetic}


def get_dataset(cfg, mode, do_augmentations=True):
    if cfg.dataset_name not in DATASETS:
        raise ValueError(f'unknown dataset {cfg.dataset_name!r}: one of '
                         f'{sorted(DATASETS)}')
    return DATASETS[cfg.dataset_name](mode, cfg, do_augmentations)


class BatchLoader:
    """Iterates (host batch, host_meta) with background prefetch.

    Data parallel (JAX loader.py:192-282): with `num_shards` D each step
    takes the next batch_size x D scenes of one shuffled order, and shard d
    gets the contiguous chunk [d B, (d + 1) B) of them. `num_shards` alone
    yields the list of the D shards' batches, key-pyramid batches built at
    common level and segment pads, as the JAX loader's; with `shard` r it
    builds and yields only rank r's batch, at its own pads (every rank of a
    torch.distributed run reads its own shard)."""

    def __init__(self, dataset, cfg, batch_size, shuffle=True, drop_last=True,
                 seed=None, num_shards=1, shard=None):
        if shard is not None and not 0 <= shard < num_shards:
            raise ValueError(f'shard {shard} of {num_shards}')
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard = shard
        self.epoch = 0
        per_step = batch_size * (num_shards if shard is None else 1)
        workers = max(1, min(cfg.num_workers, per_step))
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.dataset.epoch = epoch

    def __len__(self):
        return len(self.steps())

    def close(self):
        self._pool.shutdown(wait=True)

    def _order(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            seed = (self.seed if self.seed is not None
                    else (self.cfg.fixed_seed or 0)) + self.epoch
            np.random.default_rng(seed).shuffle(idx)
        return idx

    def _build(self, indices):
        D = self.num_shards
        # shard d's contiguous chunk; a last partial group splits evenly too
        per = len(indices) // D
        if self.shard is not None:
            indices = indices[self.shard * per:(self.shard + 1) * per]
        rets = list(self._pool.map(self.dataset.__getitem__, indices))
        if self.cfg.spatial_shards > 1:
            return self._build_spatial(rets)
        build = functools.partial(build_batch, cfg=self.cfg,
                                  sem_id2idx=self.dataset.sem_id2idx,
                                  mode=self.dataset.mode)
        if D == 1 or self.shard is not None:
            return build(rets)
        chunks = [rets[d * per:(d + 1) * per] for d in range(D)]
        if not _device_maps_ok(rets, self.cfg):
            return [build(ch, device_maps=False) for ch in chunks]
        seg_pad = None
        if self.cfg.do_segment_pooling:
            sb = self.cfg.seg_bucket
            seg_pad = max(max(round_up(sum(len(r['input_location'])
                                           for r in ch), sb)
                              for ch in chunks), sb)
        pads = common_level_pads(rets, self.cfg.vox_bucket)
        return [build(ch, device_maps=True, level_pads=pads, seg_pad=seg_pad)
                for ch in chunks]

    def _build_spatial(self, rets):
        """One scene split over --spatial_shards ranks (JAX loader.py:
        233-254): every rank builds the whole host batch and uploads its
        own shard (parallel/spatial.local_batch); the host dict carries
        the shard plan in 'spatial_meta'. Key operands on the port's
        key-route rule (datasets/batching.py)."""
        from box2mask_torch.parallel.spatial import build_spatial_unet_batch
        if len(rets) != 1:
            raise ValueError('spatial sharding takes one scene per step')
        ret, cfg = rets[0], self.cfg
        use_kc = cfg.key_conv == 'on' or (cfg.key_conv == 'eval'
                                          and self.dataset.mode != 'train')
        dev, meta = build_spatial_unet_batch(
            ret, cfg.spatial_shards, gather_level=cfg.spatial_gather_level,
            sem_id2idx=self.dataset.sem_id2idx, key_conv=use_kc)
        host = {'scene': [ret['scene']], 'labels': [ret.get('labels')],
                'num_voxels': [len(ret['vox_coords'])],
                'vox2point': [ret['vox2point']],
                'seg2vox': [ret.get('seg2vox')],
                'input_location': [ret['input_location']],
                'spatial_meta': meta}
        return dev, host

    def steps(self):
        """The index groups of one pass, in order: batch_size scenes (x
        num_shards), the last partial group kept unless drop_last (under
        shards only if every shard gets a scene: each rank takes the same
        number of steps)."""
        order = self._order()
        group = self.batch_size * self.num_shards
        out = []
        for i in range(0, len(order), group):
            chunk = order[i:i + group]
            if len(chunk) < group and (self.drop_last
                                       or len(chunk) < self.num_shards):
                break
            out.append(chunk)
        return out

    def __iter__(self):
        steps = self.steps()
        q = queue.Queue(maxsize=max(1, self.cfg.prefetch_batches))
        stop = object()
        done = threading.Event()

        def producer():
            try:
                for chunk in steps:
                    if done.is_set():
                        return
                    q.put(self._build(chunk))
            except BaseException as e:   # surface worker errors to the consumer
                q.put(e)
            q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # a consumer that stops early: let the producer finish its put
            done.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
