"""LR schedule: constant until the start epoch, then cosine decay to `clip`
(port of box2mask_tpu/engine/schedule.py; epochs count from 0)."""

from __future__ import annotations

from math import cos, pi


def cosine_lr_after_step(base_lr, epoch, start_epoch, total_epochs, clip=1e-6):
    if not total_epochs or epoch < start_epoch:
        return base_lr
    frac = (epoch - start_epoch) / (total_epochs - start_epoch)
    return clip + 0.5 * (base_lr - clip) * (1 + cos(pi * frac))


def lr_for_epoch(cfg, epoch):
    if cfg.use_lr_scheduler:
        return cosine_lr_after_step(cfg.lr, epoch, cfg.lr_scheduler_start_epoch,
                                    cfg.lr_scheduler_end_epoch)
    return cfg.lr
