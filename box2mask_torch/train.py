"""Training CLI of the port: ``python -m box2mask_torch.train --config
configs/scannet.txt``.

The counterpart of the root train.py: the datasets of cfg.dataset_name
(train, or train+val under --train_submission; val for the validation
loss), a Trainer and its epoch loop. It resumes from the experiment's latest
checkpoint, the port's or the JAX package's, at its epoch, and warm-starts
under --apple_warmstart (engine/train.py). It runs on the card;
`BOX2MASK_PLATFORM=cpu` asks for the CPU, and without CUDA and without that
request it raises. Not ported yet: data-parallel training (--multigpu,
ROADMAP A11) and spatial sharding (--spatial_shards > 1, ROADMAP A13).
"""

import os
import sys

from box2mask_torch.config import get_config
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine.train import Trainer
from box2mask_torch.runtime import resolve_device


def main(argv=None):
    cfg = get_config(argv)
    if cfg.multigpu:
        raise NotImplementedError('data-parallel training (--multigpu) is '
                                  'not ported to box2mask_torch yet '
                                  '(ROADMAP A11)')
    if cfg.spatial_shards > 1:
        raise NotImplementedError('spatially sharded training '
                                  '(--spatial_shards) is not ported to '
                                  'box2mask_torch yet (ROADMAP A13)')
    device = resolve_device(os.environ.get('BOX2MASK_PLATFORM') or None)
    train_mode = 'train+val' if cfg.train_submission else 'train'
    train_ds = get_dataset(cfg, train_mode, do_augmentations=True)
    val_ds = get_dataset(cfg, 'val', do_augmentations=True)
    trainer = Trainer(cfg, train_ds, val_ds, device=device)
    trainer.train_model(cfg.num_epochs)
    return trainer


if __name__ == '__main__':
    main(sys.argv[1:])
