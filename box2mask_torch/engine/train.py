"""Training loop for one device (port of box2mask_tpu/engine/train.py:47-344).

Experiment dir with args.txt + config copy, auto-resume from the latest
time-encoded checkpoint, cosine LR, epoch-head checkpoint / val loss blocks,
the full val-set evaluation (mAP) at eval epochs, per-step timing and peak
device memory (torch.cuda.max_memory_allocated in place of the JAX memory
stats), val_min marker files. Scalars go to `<exp>/metrics.jsonl`, one JSON
object per line (ScalarLog, in place of the JAX package's tensorboard
writer).

Not in this slice: multi-device and spatially sharded training (ROADMAP
A11, A13).
"""

from __future__ import annotations

import json
import os
import shutil
import time
import traceback

import torch

from box2mask_torch.config import needs_remat
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.engine.infer import upload
from box2mask_torch.engine.schedule import lr_for_epoch
from box2mask_torch.runtime import resolve_device


class ScalarLog:
    """Scalars appended to a JSON-lines file, one object per call."""

    def __init__(self, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path

    def log(self, **scalars):
        with open(self.path, 'a') as f:
            f.write(json.dumps(scalars) + '\n')

    def add_scalar(self, tag, value, step):
        """The tensorboard writer's call, as the Evaluater makes it."""
        self.log(epoch=step, **{tag: value})


class Trainer:
    def __init__(self, cfg, train_dataset, val_dataset, num_classes=None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        valid_ids, _, _, _ = get_tables(train_dataset.table_name)
        self.num_classes = num_classes or len(valid_ids)
        self.tx = S.make_optimizer(cfg)
        self.train_step = S.make_train_step(cfg)
        self.val_step = S.make_val_step(cfg)
        self.train_loader = train_dataset.get_loader()
        self.val_loader = val_dataset.get_loader(
            shuffle=True, drop_last=False) if val_dataset is not None else None

        # experiment dir + provenance
        os.makedirs(cfg.exp_path, exist_ok=True)
        os.makedirs(cfg.checkpoint_path, exist_ok=True)
        with open(os.path.join(cfg.exp_path, 'args.txt'), 'w') as f:
            f.write(repr(vars(cfg)))
        if cfg.config and os.path.exists(cfg.config):
            shutil.copyfile(cfg.config, os.path.join(
                cfg.exp_path, os.path.basename(cfg.config)))
        self.metrics = ScalarLog(os.path.join(cfg.exp_path, 'metrics.jsonl'))

        self.state = None
        self.training_time = 0.0
        self.iteration_num = 0
        self.start_epoch = 0
        self.val_min = ckpt.read_val_min(cfg.exp_path)

    def log(self, **scalars):
        self.metrics.log(**scalars)

    # ------------------------------------------------------------------ setup
    def _ensure_state(self, sample_batch):
        if self.state is not None:
            return
        cfg = self.cfg
        # the first real batch's half of the auto-remat rule (config
        # .needs_remat): flip remat from the padded row count, which
        # get_config cannot know for configs that leave vox_bucket small
        rows = int(sample_batch['valid0'].shape[0])
        if (not cfg.remat and not cfg.no_auto_remat
                and needs_remat(rows, cfg.bf16_acts)):
            cfg.remat = True
            cfg.remat_auto = True
            print(f'auto-remat: {rows} padded rows/step is past the memory '
                  'rule without block remat (--no_auto_remat to override)')
        model = S.build_model(cfg, self.num_classes, self.device)
        self.state = S.init_state(cfg, model, self.tx,
                                  seed=cfg.fixed_seed or 0)
        self._resume()

    def _resume(self):
        path = ckpt.find_checkpoint(self.cfg.checkpoint_path)
        if path is None:
            print(f'No checkpoints found at {self.cfg.checkpoint_path}')
            return
        (self.state, epoch, self.training_time, self.iteration_num,
         name) = ckpt.load_checkpoint(path, self.state,
                                      strict=not self.cfg.loose_model_loading)
        self.start_epoch = epoch
        print(f'Resumed from {name} (epoch {epoch})')

    # ------------------------------------------------------------------ steps
    def compute_val_loss(self, epoch):
        """Validation loss over the first num_eval_batches batches."""
        if self.val_loader is None:
            return None
        bb_w, cs_w = S.head_weights(self.cfg, epoch)
        sums, n = {}, 0
        for i, (dev_np, _host) in enumerate(self.val_loader):
            if i >= self.cfg.num_eval_batches:
                break
            ld = self.val_step(self.state, upload(dev_np, self.device), bb_w,
                               cs_w)
            for k, v in ld.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    # ------------------------------------------------------------------ train
    def train_model(self, epochs):
        cfg = self.cfg
        cuda = self.device.type == 'cuda'
        if self.state is None:
            # build (and resume) the state before the epoch loop: a resume
            # moves start_epoch. The JAX Trainer resumes inside its loop,
            # after range(start_epoch, epochs) was fixed, so it restarts at
            # epoch 0 with the resumed weights; the port starts at the
            # checkpoint's epoch.
            self.train_loader.set_epoch(self.start_epoch)
            dev_np, _ = next(iter(self.train_loader))
            self._ensure_state(upload(dev_np, self.device))
        for epoch in range(self.start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            lr = lr_for_epoch(cfg, epoch)
            bb_w, cs_w = S.head_weights(cfg, epoch)
            self.log(epoch=epoch, learning_rate=lr)
            epoch_sums, epoch_n = {}, 0

            for batch_num, (dev_np, _host) in enumerate(self.train_loader):
                t0 = time.time()
                batch = upload(dev_np, self.device)
                prep_time = time.time() - t0

                # epoch-head block (reference training.py:99-152)
                if batch_num == 0 and not (
                        epoch == self.start_epoch and cfg.skip_first_eval):
                    self._epoch_head(epoch)

                t1 = time.time()
                self.state, ld = self.train_step(self.state, batch, lr, bb_w,
                                                 cs_w)
                loss = float(ld['optimization_loss'])  # waits: true step time
                step_time = time.time() - t1
                self.training_time += time.time() - t0
                self.iteration_num += 1
                for k, v in ld.items():
                    epoch_sums[k] = epoch_sums.get(k, 0.0) + float(v)
                epoch_n += 1
                self.log(iteration=self.iteration_num,
                         batch_prep_time=prep_time,
                         train_step_time=step_time, loss=loss,
                         max_memory_allocated=(
                             torch.cuda.max_memory_allocated(self.device)
                             if cuda else None))
                print(f'epoch {epoch} it {self.iteration_num} '
                      f'loss {loss:.4f} (prep {prep_time:.2f}s '
                      f'step {step_time:.2f}s)')

            self.log(epoch=epoch, iteration=self.iteration_num,
                     **{f'train_epoch/{k}': v / max(epoch_n, 1)
                        for k, v in epoch_sums.items()})
        return self.training_time

    def _epoch_head(self, epoch):
        cfg = self.cfg
        if epoch % cfg.ckpt_every == 0:
            t0 = time.time()
            path = ckpt.save_checkpoint(cfg.checkpoint_path, self.state,
                                        self.training_time, epoch,
                                        self.iteration_num)
            print(f'Saved checkpoint {os.path.basename(path)} '
                  f'({time.time() - t0:.1f}s)')
        if epoch % cfg.val_every == 0 and self.val_loader is not None:
            val = self.compute_val_loss(epoch)
            if val:
                self.log(epoch=epoch, **{f'val/{k}': v for k, v in val.items()})
                if val['optimization_loss'] < self.val_min:
                    self.val_min = val['optimization_loss']
                    ckpt.write_val_min_marker(cfg.exp_path, self.val_min)
        if (epoch % cfg.eval_every == 0 and epoch >= 250 and cfg.full_model
                and cfg.dataset_name == 'scannet'):
            self._full_eval(epoch)

    def _full_eval(self, epoch):
        """Full val-set mAP on the live weights (JAX engine/train.py:314-334).
        A failure must not end a long training run, but it is loud: the
        traceback on stderr and a `val/full_eval_failed` scalar."""
        try:
            ev = Evaluater(self.cfg, state=self.state, writer=self.metrics,
                           epoch=epoch)
            ev.eval(get_dataset(self.cfg, 'val',
                                do_augmentations=not self.cfg.eval_wo_aug))
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            traceback.print_exc()
            print(f'Full eval FAILED at epoch {epoch} (traceback above); '
                  'training continues')
            self.log(epoch=epoch, **{'val/full_eval_failed': 1.0})
