"""Training loop, on one device or data parallel across processes (port of
box2mask_tpu/engine/train.py:47-344).

Experiment dir with args.txt + config copy, auto-resume from the latest
time-encoded checkpoint, cosine LR, epoch-head checkpoint / val loss blocks,
the full val-set evaluation (mAP) at eval epochs, per-step timing and peak
device memory (torch.cuda.max_memory_allocated in place of the JAX memory
stats), val_min marker files, the --apple_warmstart warm start and, under
--profile_dir, a torch.profiler Chrome trace of train steps 10-14 (every
thread's host events, the port's b2m.* spans among them). Scalars
go to `<exp>/metrics.jsonl`, one JSON object per line (ScalarLog, in place
of the JAX package's tensorboard writer). It resumes from the port's
checkpoints and from the JAX package's (engine/checkpoint.py).

Data parallel (--multigpu): one Trainer per rank of a torch.distributed
process group (box2mask_torch/train.py spawns them), each on its own device
and its own shard of every batch (the loader's `shard`), its model built
with the group (SyncBN) and its steps those of parallel/mesh.py. Every rank
initialises, resumes, then takes rank 0's state (broadcast_state). Rank 0
alone writes the checkpoints, the validation loss, the full evaluation, the
scalars, the prints and the profiler trace, each followed by a barrier.

Spatially sharded (--spatial_shards D, JAX engine/train.py:56-75, :134-153):
D Trainers, one per rank, each on every scene of the loader (one a step),
uploading its own slab of it (parallel/spatial.local_batch), its model a
SpatialSelectionNet (the SelectionNet parameters, so the checkpoints are
one device's) and its steps make_spatial_train_step; no auto-remat. The
validation loss and the full evaluation run their sharded forwards on
every rank; rank 0 alone writes, logs and prints.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import traceback

import torch
import torch.distributed as dist

from box2mask_torch import tracing
from box2mask_torch.config import needs_remat
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.engine.hostload import upload
from box2mask_torch.engine.schedule import lr_for_epoch
from box2mask_torch.parallel import mesh as M
from box2mask_torch.parallel import spatial as SP
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


def _start_profiler(cuda):
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []),
                   experimental_config=tracing.profiler_config())
    prof.start()
    return prof


def _stop_profiler(prof, out_dir):
    """Stop `prof` and write its Chrome trace into `out_dir`."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f'train_steps_10-14_{int(time.time())}'
                        '.pt.trace.json')
    prof.export_chrome_trace(path)
    print(f'Profiler trace written to {path}')


def warmstart_fresh_params(model):
    """Parameter names of the last Linear1x1_* (in the reference's sorted
    order of names) of each semantics head the model has."""
    names = [n for n, _ in model.named_parameters()]
    keep = set()
    for head in ('mlp_semantics', 'mlp_per_vox_semantics'):
        layers = sorted({n.split('.')[1] for n in names
                         if n.startswith(head + '.Linear1x1')})
        if layers:
            keep |= {n for n in names
                     if n.startswith(f'{head}.{layers[-1]}.')}
    return keep


class Trainer:
    """`rank`, `world_size` and `group` place it in a data-parallel run
    (parallel/mesh.init_data_parallel); the defaults train on one
    device."""

    def __init__(self, cfg, train_dataset, val_dataset, num_classes=None,
                 device=None, rank=0, world_size=1, group=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank, self.world_size = rank, world_size
        self.group = group if world_size > 1 else None
        self.main = rank == 0
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        valid_ids, _, _, _ = get_tables(train_dataset.table_name)
        self.num_classes = num_classes or len(valid_ids)
        self.tx = S.make_optimizer(cfg)
        self.spatial = cfg.spatial_shards > 1
        if self.spatial and world_size != cfg.spatial_shards:
            raise ValueError(f'--spatial_shards {cfg.spatial_shards} trains '
                             f'on as many ranks, not {world_size}')
        if self.spatial:
            self.train_step = SP.make_spatial_train_step(cfg, self.group)
            self.train_loader = train_dataset.get_loader()
        elif self.group is not None:
            self.train_step = M.make_parallel_train_step(cfg, self.group)
            self.train_loader = train_dataset.get_loader(
                num_shards=world_size, shard=rank)
        else:
            self.train_step = S.make_train_step(cfg)
            self.train_loader = train_dataset.get_loader()
        # the validation loss runs on rank 0 alone, unsharded (BN on the
        # running statistics: no collective), as the JAX Trainer's; a
        # spatially sharded forward runs on every rank
        self.val_step = (SP.make_spatial_val_step(cfg, self.group)
                         if self.spatial else S.make_val_step(cfg))
        self.val_loader = val_dataset.get_loader(
            shuffle=True, drop_last=False) if (
                val_dataset is not None
                and (self.main or self.spatial)) else None

        # experiment dir + provenance
        os.makedirs(cfg.checkpoint_path, exist_ok=True)
        if self.main:
            with open(os.path.join(cfg.exp_path, 'args.txt'), 'w') as f:
                f.write(repr(vars(cfg)))
            if cfg.config and os.path.exists(cfg.config):
                shutil.copyfile(cfg.config, os.path.join(
                    cfg.exp_path, os.path.basename(cfg.config)))
        self.metrics = ScalarLog(os.path.join(cfg.exp_path, 'metrics.jsonl'))

        self.state = None
        self._profiler = None
        self.training_time = 0.0
        self.iteration_num = 0
        self.start_epoch = 0
        self.val_min = ckpt.read_val_min(cfg.exp_path)

    def log(self, **scalars):
        if self.main:
            self.metrics.log(**scalars)

    def say(self, text):
        if self.main:
            print(text, flush=True)

    def upload(self, dev_np):
        """A host batch on the rank's device (under spatial sharding its
        slab, once every rank is known to hold the same scene)."""
        if self.spatial:
            SP.check_same_scene(dev_np, self.group, self.device)
            return SP.local_batch(dev_np, self.rank, self.device)
        return upload(dev_np, self.device)

    def barrier(self):
        """All ranks wait here (after work of rank 0 alone)."""
        if self.group is not None:
            dist.barrier(group=self.group)

    # ------------------------------------------------------------------ setup
    def _ensure_state(self, sample_batch):
        if self.state is not None:
            return
        cfg = self.cfg
        if self.spatial:
            # the JAX Trainer has no auto-remat under spatial sharding, and
            # the spatial net no remat
            self._init_state(SP.build_spatial_model(
                cfg, self.num_classes, self.device, group=self.group))
            return
        # the first real batch's half of the auto-remat rule (config
        # .needs_remat): flip remat from the padded row count, which
        # get_config cannot know for configs that leave vox_bucket small.
        # Data parallel: from one rank's rows (the JAX Trainer divides one
        # device's rows by the device count once more, ROADMAP section C),
        # the most of any rank, so that every rank remats alike and issues
        # its BN all-reduces in the same order
        rows = int(sample_batch['valid0'].shape[0])
        if self.group is not None:
            r = torch.tensor([rows], dtype=torch.int64,
                             device=M.collective_device(
                                 self.group, sample_batch['valid0'].device))
            dist.all_reduce(r, op=dist.ReduceOp.MAX, group=self.group)
            rows = int(r.item())
        if (not cfg.remat and not cfg.no_auto_remat
                and needs_remat(rows, cfg.bf16_acts)):
            cfg.remat = True
            cfg.remat_auto = True
            self.say(f'auto-remat: {rows} padded rows/step is past the '
                     'memory rule without block remat (--no_auto_remat to '
                     'override)')
        self._init_state(S.build_model(cfg, self.num_classes, self.device,
                                       group=self.group))

    def _init_state(self, model):
        """Seeded weights, the resume, and across ranks rank 0's state and
        counts on every rank."""
        self.state = S.init_state(self.cfg, model, self.tx,
                                  seed=self.cfg.fixed_seed or 0)
        self._resume()
        if self.group is not None:
            M.broadcast_state(self.state, self.group)
            self.training_time, self.iteration_num, self.start_epoch = (
                self._broadcast_counts())

    def _broadcast_counts(self):
        """Rank 0's training time, iteration and start epoch."""
        c = torch.tensor([self.training_time, self.iteration_num,
                          self.start_epoch], dtype=torch.float64,
                         device=M.collective_device(
                             self.group, self.state.params[0].device))
        dist.broadcast(c, 0, group=self.group)
        t, it, ep = c.tolist()
        return t, int(it), int(ep)

    def _resume(self):
        """Resume from the experiment's latest checkpoint (the port's or the
        JAX package's), at its epoch. Under --apple_warmstart (JAX
        engine/train.py:178-192) start from its weights at epoch 0 instead,
        with the semantic output layers at their fresh init: the last
        Linear1x1_* of mlp_semantics and of mlp_per_vox_semantics, so that a
        checkpoint of another class count (ScanNet's 20 into ARKitScenes'
        28) carries over. Their optimizer moments start fresh too; the
        reference keeps the checkpoint's, whose shapes then no longer match
        and fail its first update (ROADMAP section C)."""
        cfg = self.cfg
        path = ckpt.find_checkpoint(cfg.checkpoint_path)
        if path is None:
            self.say(f'No checkpoints found at {cfg.checkpoint_path}')
            return
        keep = warmstart_fresh_params(self.state.model) \
            if cfg.apple_warmstart else ()
        (self.state, epoch, self.training_time, self.iteration_num,
         name) = ckpt.load_checkpoint(path, self.state,
                                      strict=not cfg.loose_model_loading,
                                      keep=keep)
        if cfg.apple_warmstart:
            self.start_epoch = 0
            self.say(f'Warm-started from {name} (semantic output layer '
                     're-init)')
            return
        self.start_epoch = epoch
        self.say(f'Resumed from {name} (epoch {epoch})')

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
            ld = self.val_step(self.state, self.upload(dev_np), bb_w, cs_w)
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
            self._ensure_state(self.upload(dev_np))
        for epoch in range(self.start_epoch, epochs):
            self.train_loader.set_epoch(epoch)
            lr = lr_for_epoch(cfg, epoch)
            bb_w, cs_w = S.head_weights(cfg, epoch)
            self.log(epoch=epoch, learning_rate=lr)
            epoch_sums, epoch_n = {}, 0

            for batch_num, (dev_np, _host) in enumerate(self.train_loader):
                t0 = time.time()
                batch = self.upload(dev_np)
                prep_time = time.time() - t0

                # epoch-head block (reference training.py:99-152)
                if batch_num == 0 and not (
                        epoch == self.start_epoch and cfg.skip_first_eval):
                    if self.main or self.spatial:
                        self._epoch_head(epoch)
                    self.barrier()

                if (cfg.profile_dir and self.iteration_num == 10
                        and self.main):
                    self._profiler = _start_profiler(cuda)
                t1 = time.time()
                self.state, ld = self.train_step(self.state, batch, lr, bb_w,
                                                 cs_w)
                with tracing.span('b2m.train.loss_read'):
                    # waits: true step time
                    loss = float(ld['optimization_loss'])
                    t2 = time.time()
                    for k, v in ld.items():
                        epoch_sums[k] = epoch_sums.get(k, 0.0) + float(v)
                step_time = t2 - t1
                self.training_time += t2 - t0
                self.iteration_num += 1
                if self._profiler is not None and self.iteration_num == 15:
                    _stop_profiler(self._profiler, cfg.profile_dir)
                    self._profiler = None
                epoch_n += 1
                self.log(iteration=self.iteration_num,
                         batch_prep_time=prep_time,
                         train_step_time=step_time, loss=loss,
                         max_memory_allocated=(
                             torch.cuda.max_memory_allocated(self.device)
                             if cuda else None))
                self.say(f'epoch {epoch} it {self.iteration_num} '
                         f'loss {loss:.4f} (prep {prep_time:.2f}s '
                         f'step {step_time:.2f}s)')

            self.log(epoch=epoch, iteration=self.iteration_num,
                     **{f'train_epoch/{k}': v / max(epoch_n, 1)
                        for k, v in epoch_sums.items()})
        return self.training_time

    def _epoch_head(self, epoch):
        cfg = self.cfg
        if epoch % cfg.ckpt_every == 0 and self.main:
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
                if val['optimization_loss'] < self.val_min and self.main:
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
                           epoch=epoch, rank=self.rank,
                           world_size=self.world_size, group=self.group)
            ev.eval(get_dataset(self.cfg, 'val',
                                do_augmentations=not self.cfg.eval_wo_aug))
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            traceback.print_exc()
            print(f'Full eval FAILED at epoch {epoch} (traceback above); '
                  'training continues')
            self.log(epoch=epoch, **{'val/full_eval_failed': 1.0})
