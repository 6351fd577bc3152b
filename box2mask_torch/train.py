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
route; --data_axis_size is needed there). At the end the ranks' parameters
are checked to be equal. Not ported yet: spatial sharding (--spatial_shards
> 1, ROADMAP A13).
"""

import importlib
import os
import shutil
import sys
import tempfile

import torch
import torch.multiprocessing as mp

from box2mask_torch.config import get_config
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine.train import Trainer
from box2mask_torch.parallel import mesh as M
from box2mask_torch.runtime import resolve_device

# bound on every collective and barrier of a data-parallel run: the other
# ranks wait at a barrier while rank 0 writes a checkpoint or runs the full
# evaluation of the val set
DP_TIMEOUT_S = 7200.0


def _datasets(cfg):
    train_mode = 'train+val' if cfg.train_submission else 'train'
    return (get_dataset(cfg, train_mode, do_augmentations=True),
            get_dataset(cfg, 'val', do_augmentations=True))


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    cfg = get_config(argv)
    if cfg.spatial_shards > 1:
        raise NotImplementedError('spatially sharded training '
                                  '(--spatial_shards) is not ported to '
                                  'box2mask_torch yet (ROADMAP A13)')
    platform = os.environ.get('BOX2MASK_PLATFORM') or None
    if cfg.multigpu:
        return train_data_parallel(argv, cfg, platform)
    device = resolve_device(platform)
    train_ds, val_ds = _datasets(cfg)
    trainer = Trainer(cfg, train_ds, val_ds, device=device)
    trainer.train_model(cfg.num_epochs)
    return trainer


def world_size_for(cfg, platform):
    """The ranks of a --multigpu run and their backend: one NCCL rank per
    card (raises when more ranks than cards are asked for), or gloo ranks
    on the CPU when the platform is 'cpu'."""
    if platform == 'cpu':
        if not cfg.data_axis_size:
            raise ValueError('--multigpu on the CPU needs --data_axis_size')
        return cfg.data_axis_size, 'gloo'
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    world = cfg.data_axis_size or cards
    if world < 1 or world > cards:
        raise RuntimeError(f'--multigpu asks for {world} ranks, one per '
                           f'card, and {cards} CUDA cards are available; '
                           'set BOX2MASK_PLATFORM=cpu to run the ranks on '
                           'the CPU')
    return world, 'nccl'


def train_data_parallel(argv, cfg, platform):
    """Spawn the ranks of a --multigpu run and wait for them; a rank that
    fails ends the run with its error."""
    world, backend = world_size_for(cfg, platform)
    rendezvous = tempfile.mkdtemp(prefix='box2mask_dp_')
    # the worker pickles by import path: take it from the module as
    # imported by name, also when this file runs as __main__
    worker = importlib.import_module('box2mask_torch.train').rank_main
    try:
        mp.start_processes(
            worker, args=(world, backend, 'file://' + os.path.join(
                rendezvous, 'init'), argv, platform),
            nprocs=world, join=True, start_method='spawn')
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


def rank_main(rank, world, backend, init_method, argv, platform):
    """One rank of a --multigpu run: join the group, train on the rank's
    shard, check that every rank ends with the same parameters."""
    if platform == 'cpu':
        # the ranks share the cores: each takes its share, or fewer where
        # OMP_NUM_THREADS asks for fewer (torch's default reads it)
        torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                         (os.cpu_count() or 1) // world)))
        device = torch.device('cpu')
    else:
        device = torch.device('cuda', rank)
    device = resolve_device(device)
    cfg = get_config(argv)
    group = M.init_data_parallel(rank, world, backend, init_method, device,
                                 timeout=DP_TIMEOUT_S)
    try:
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
