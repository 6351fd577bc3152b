"""Training CLI of the port: ``python -m box2mask_torch.train --config
configs/scannet.txt``.

The counterpart of the root train.py: the datasets of cfg.dataset_name
(train, or train+val under --train_submission; val for the validation
loss), a Trainer and its epoch loop. It resumes from the experiment's latest
checkpoint, the port's or the JAX package's, at its epoch, and warm-starts
under --apple_warmstart (engine/train.py). It runs on the card;
`BOX2MASK_PLATFORM=cpu` asks for the CPU, and without CUDA and without that
request it raises.

--multigpu trains data parallel, as the reference did (mp.spawn, one NCCL
process per GPU): --data_axis_size processes (default: every card), rank r
on cuda:r, each a Trainer on its shard of every batch
(parallel/mesh.py). Asked for more ranks than cards it raises. With
`BOX2MASK_PLATFORM=cpu` the ranks run on the CPU over gloo (the tests'
route; --data_axis_size is needed there). The ranks take rank 0's seeds
(parallel/mesh.agree_seeds). At the end the ranks' parameters are checked
to be equal.

--spatial_shards D trains one scene per step split over D ranks
(parallel/spatial.py), spawned the same way: one NCCL rank per card
(raises when there are fewer than D cards), or D gloo ranks on the CPU
under `BOX2MASK_PLATFORM=cpu`. Every rank builds the same scene, drawn
under rank 0's seeds, and each step checks that it did.
"""

import importlib
import os
import sys

import torch

from box2mask_torch.config import get_config
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine.train import Trainer
from box2mask_torch.parallel import mesh as M
from box2mask_torch.runtime import resolve_device


def _datasets(cfg):
    train_mode = 'train+val' if cfg.train_submission else 'train'
    return (get_dataset(cfg, train_mode, do_augmentations=True),
            get_dataset(cfg, 'val', do_augmentations=True))


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    cfg = get_config(argv)
    platform = os.environ.get('BOX2MASK_PLATFORM') or None
    if cfg.multigpu or cfg.spatial_shards > 1:
        world, backend = world_size_for(cfg, platform)
        # the worker pickles by import path: take it from the module as
        # imported by name, also when this file runs as __main__
        worker = importlib.import_module('box2mask_torch.train').rank_main
        return M.spawn_ranks(worker, world, backend, argv, platform)
    device = resolve_device(platform)
    train_ds, val_ds = _datasets(cfg)
    trainer = Trainer(cfg, train_ds, val_ds, device=device)
    trainer.train_model(cfg.num_epochs)
    return trainer


def world_size_for(cfg, platform):
    """The ranks of a --multigpu or --spatial_shards run and their
    backend: one NCCL rank per card (raises when more ranks than cards are
    asked for), or gloo ranks on the CPU when the platform is 'cpu'."""
    if cfg.spatial_shards > 1:
        return cfg.spatial_shards, M.ranks_backend(
            cfg.spatial_shards, platform, '--spatial_shards')
    if platform == 'cpu' and not cfg.data_axis_size:
        raise ValueError('--multigpu on the CPU needs --data_axis_size')
    world = cfg.data_axis_size or (torch.cuda.device_count()
                                   if torch.cuda.is_available() else 0)
    return world, M.ranks_backend(world, platform, '--multigpu')


def rank_main(rank, world, backend, init_method, argv, platform):
    """One rank of a --multigpu or --spatial_shards run: join the group,
    train (on the rank's shard of every batch, or on its slab of every
    scene), check that every rank ends with the same parameters."""
    device = resolve_device(M.rank_device(rank, world, platform))
    group = M.init_data_parallel(rank, world, backend, init_method, device,
                                 timeout=M.RANKS_TIMEOUT_S)
    try:
        cfg = M.agree_seeds(get_config(argv), group, device)
        train_ds, val_ds = _datasets(cfg)
        trainer = Trainer(cfg, train_ds, val_ds, device=device, rank=rank,
                          world_size=world, group=group)
        trainer.train_model(cfg.num_epochs)
        M.check_replicas(trainer.state, group)
        trainer.say(f'{world} ranks ended with equal parameters')
    finally:
        M.teardown()


if __name__ == '__main__':
    main(sys.argv[1:])
