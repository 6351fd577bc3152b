"""Dataset classes + prefetching batch loader (the port's copy of
box2mask_tpu/datasets/loader.py:28-125 and :189-314, single device).

The loader is a thread-pool prefetcher feeding padded host batches: the
per-scene work is vectorized NumPy (it releases the GIL), and batches are
built ahead of the device in a bounded queue. Every scene draws its
augmentation from its own RandomState (`scene_rng`), so under --fixed_seed a
scene gives the same batch whatever the worker count or order.

Datasets: 'synthetic' (datasets/synthetic.py) for dataset-free runs, tests
and chip_smoke.py. The ScanNet, ARKitScenes and S3DIS readers are not ported
yet (ROADMAP A15).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from box2mask_torch.datasets import augmentation, supervision, synthetic
from box2mask_torch.datasets.batching import build_batch
from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.datasets.voxelize import voxelize_scene


def scene_rng(cfg, scene_name, epoch=0):
    """Per-scene RandomState stream: deterministic under --fixed_seed (varying
    with scene name + epoch so TTA eval and training epochs differ), fresh
    OS-entropy otherwise."""
    if cfg.fixed_seed is None:
        return np.random.RandomState()
    h = np.uint32(cfg.fixed_seed)
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
                   seed=None):
        return BatchLoader(self, self.cfg, batch_size or self.cfg.batch_size,
                           shuffle=shuffle, drop_last=drop_last, seed=seed)


class Synthetic(SceneDataset):
    dataset_name = 'synthetic'
    SPLIT_SIZES = {'train': 64, 'val': 16, 'test': 8, 'train+val': 80}

    def _build_data_list(self, mode, cfg):
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


DATASETS = {'synthetic': Synthetic}


def get_dataset(cfg, mode, do_augmentations=True):
    if cfg.dataset_name not in DATASETS:
        raise NotImplementedError(
            f'the {cfg.dataset_name} reader is not ported yet (ROADMAP A15); '
            "use --dataset_name synthetic")
    return DATASETS[cfg.dataset_name](mode, cfg, do_augmentations)


class BatchLoader:
    """Iterates (host batch, host_meta) with background prefetch."""

    def __init__(self, dataset, cfg, batch_size, shuffle=True, drop_last=True,
                 seed=None):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        workers = max(1, min(cfg.num_workers, batch_size))
        self._pool = ThreadPoolExecutor(max_workers=workers)

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.dataset.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return max(n, 0)

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
        rets = list(self._pool.map(self.dataset.__getitem__, indices))
        return build_batch(rets, self.cfg, self.dataset.sem_id2idx,
                           mode=self.dataset.mode)

    def steps(self):
        """The index chunks of one pass, in order."""
        order = self._order()
        out = []
        for i in range(0, len(order), self.batch_size):
            chunk = order[i:i + self.batch_size]
            if len(chunk) < self.batch_size and self.drop_last:
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
