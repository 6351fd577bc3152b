"""train-steps: the loop of `Trainer.train_model` without its loader and
epoch heads. Each step uploads the next batch of a pool of `pool_batches`
labelled batches of the preset's batch size (engine/hostload.upload),
runs `engine/state.train_step`, and reads the loss back, as the Trainer
does. The scenes take the preset's augmentation in set-up, from the seed.
Head weights are those of epoch `head_epoch`, so every loss term trains.

Set-up builds one train state, drives it through its first `checked_steps`
steps with the window's own call and feed (pool batches 0, 1, 2: rows that
all differ) and hands that same state to the window. The reference follows
those steps from the same weights and scenes.

End-to-end: train_scenes_per_s (scenes of all steps of the window over its
seconds, from its first step's start to its last step's end) and
train_peak_gb (max_memory_allocated over the window, after a reset at its
start).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import checks, device as D, flops, weights
from h100bench.kinds.common import make_scenes, reference_batch, scene_seeds
from h100bench.reference import numerics as RN
from h100bench.reference import targets as RT
from h100bench.reference.net import (Adam, Net, is_trained, losses,
                                      output_leaves)


class Session:
    moves = 'train_scenes_per_s'

    def __init__(self, ctx):
        self.ctx = ctx
        port, cj, tr = ctx.port, ctx.config, ctx.traffic
        self.cfg = port.make_cfg(cj)
        self.dev = ctx.device
        self.bs = cj['model']['batch_size']
        n_pool = tr['pool_batches']
        items = make_scenes(cj, scene_seeds(ctx.seed, n_pool * self.bs),
                            augment=cj['augmentation'])
        self.items = [items[j * self.bs:(j + 1) * self.bs]
                      for j in range(n_pool)]
        t0 = time.perf_counter()
        self.pool = [port.host_batch(self.cfg, cj, b, 'train')[0]
                     for b in self.items]
        ctx.note('host_prep_s', time.perf_counter() - t0)
        ctx.note('voxels_per_batch', [int(d['num0']) for d in self.pool])
        self.lr = cj['model']['lr']
        model = port.build_model(self.cfg, cj, weights.make(
            cj, ctx.seed, self.dev), self.dev)
        self.trainer = port.Trainer(self.cfg, model, tr['head_epoch'],
                                    self.dev)
        p0 = self.trainer.params()
        self.losses = []
        n_seg = int(self.pool[0]['num_segments'])
        hook = model.register_forward_hook(lambda mod, args, out: setattr(
            self, 'heads', {h: v.detach()[:n_seg] for h, v in out.items()}))
        for k in range(tr['checked_steps']):
            self.losses.append(self.trainer.step(self.pool[k % n_pool],
                                                 self.lr))
            if k == 0:
                hook.remove()
                self.heads = {h: v.float().cpu().numpy()
                              for h, v in self.heads.items()}
                self.grads = self.trainer.first_grads()
        p3 = self.trainer.params()
        self.changes = {n: (p3[n] - p0[n]).float().cpu() for n in p0}
        del p0, p3
        self.k = tr['checked_steps']
        D.sync(self.dev)
        self.setup_peak = (torch.cuda.max_memory_allocated(self.dev)
                           if self.dev.type == 'cuda' else 0)

    def _steps(self, seconds):
        n_pool = len(self.pool)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n, failed = 0, 0
        while time.perf_counter() < deadline:
            loss = self.trainer.step(self.pool[self.k % n_pool], self.lr)
            failed += not np.isfinite(loss)
            self.k += 1
            n += 1
        return time.perf_counter() - t0, n, failed

    def window(self, seconds):
        if self.dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        self.ctx.mark_window_start(t0)
        window_s, n, failed = self._steps(seconds)
        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == 'cuda' else 0)
        self.peak = max(peak, self.setup_peak)
        self.window_s, self.n_steps = window_s, n
        self.ctx.note('steps', n)
        self.ctx.note('first_losses', self.losses)
        return {'attempted': n * self.bs, 'failed': failed * self.bs,
                'metrics': {'train_scenes_per_s': n * self.bs / window_s,
                            'train_peak_gb': peak / 1e9}}

    def memory_peak(self):
        return self.peak

    def trace(self):
        port, dev = self.ctx.port, self.dev
        cj = self.ctx.config
        m = dict(cj['model'], classes=cj['classes']['valid_ids'])
        t0 = time.perf_counter()
        split = [self.trainer.split_ms(d, self.lr) for d in self.pool]
        t1 = time.perf_counter()
        act_bytes = 2 if m['act_dtype'] == 'bfloat16' else 4
        step_flops, conv_dev, conv_bound = [], 0.0, 0.0
        n_pool = len(self.pool)
        for j, d in enumerate(self.pool):
            sites = flops.conv_sites(flops.batch_counts(d), m)
            step_flops.append(flops.train_flops(sites))
            conv_bound += flops.bound_s(
                flops.key_conv_launches(sites, act_bytes, train=True),
                D.PEAK_BF16_FLOP_S, D.PEAK_HBM_BYTES_S)
            prof = D.profile(lambda: self.trainer.step(d, self.lr), dev,
                             host=False)
            conv_dev += D.key_conv_device_s(prof['by_name'])
            self.k += 1
        window_flops = sum(step_flops[k % n_pool] for k in range(
            self.ctx.traffic['checked_steps'],
            self.ctx.traffic['checked_steps'] + self.n_steps))
        t2 = time.perf_counter()
        stretch = D.profile(lambda: [
            self.trainer.step(self.pool[k % n_pool], self.lr)
            for k in range(self.ctx.traffic['trace_steps'])], dev)
        self.ctx.note('trace_phases_s', {
            'stages': t1 - t0, 'counts_and_kernels': t2 - t1,
            'stretch': time.perf_counter() - t2})
        return {'train_stages': split,
                'conv': {'device_s': conv_dev, 'bound_s': conv_bound},
                'window': {'seconds': self.window_s, 'flops': window_flops,
                           'peak_flop_s': D.PEAK_BF16_FLOP_S},
                'profile': stretch}

    def release(self):
        del self.trainer
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    def program_readings(self):
        return {'losses': self.losses, 'heads': self.heads,
                'grads': self.grads, 'changes': self.changes}

    def reference_readings(self, numerics, half=False):
        """The reference's losses, first step's heads, first gradients and
        the parameters' changes over the checked steps (on the host), from
        the same weights and scenes (`half`: a fault, each step's forward
        over the whole batch and its loss over the first half of the
        scenes only, the mean taken over their segments)."""
        cj, dev = self.ctx.config, self.dev
        m = cj['model']
        params = weights.make(cj, self.ctx.seed, dev)
        train = {k: v.requires_grad_() for k, v in params.items()
                 if is_trained(k)}
        p0 = {k: v.detach().clone() for k, v in train.items()}
        adam = Adam(train)
        bb_w = m['loss_weights']['bb_scores'] if (
            self.ctx.traffic['head_epoch'] >= m['bb_scores_start_epoch']) \
            else 0.0
        w = dict(m['loss_weights'], bb_scores=bb_w,
                 min_bb_size=m['min_bb_size'])
        out = {'losses': []}
        n_pool = len(self.items)
        for k in range(self.ctx.traffic['checked_steps']):
            items = self.items[k % n_pool]
            rb = reference_batch(cj, items, dev)
            tg = [RT.scene_targets(s, lab, v, cj['classes']['valid_ids'],
                                   cj['classes']['foreground'])
                  for (s, lab), v in zip(items, rb['vox'])]
            tgt = {
                'fg': torch.as_tensor(np.concatenate([t['fg'] for t in tg]),
                                      device=dev),
                'offsets': torch.as_tensor(np.concatenate(
                    [t['offsets'] for t in tg]), device=dev),
                'bounds': torch.as_tensor(np.concatenate(
                    [t['bounds'] for t in tg]), device=dev),
                'sem_idx': torch.as_tensor(np.concatenate(
                    [t['sem_idx'] for t in tg]), device=dev),
                'loc': torch.as_tensor(np.concatenate(
                    [v['seg_loc'] for v in rb['vox']]), device=dev)}
            net = Net(params, m['heads'], m['layers'], numerics, train=True,
                      remat=True)
            pred = net(rb['geo'], rb['feats'], rb['pool'], rb['n_seg'])
            if k == 0:
                out['heads'] = {h: v.detach().cpu().numpy()
                                for h, v in pred.items()}
            if half:
                n = int(rb['seg_off'][len(items) // 2])
                loss = losses({h: v[:n] for h, v in pred.items()},
                              {t: v[:n] for t, v in tgt.items()}, w)
            else:
                loss = losses(pred, tgt, w)
            names = list(train)
            grads = torch.autograd.grad(loss, [train[n] for n in names])
            out['losses'].append(float(loss.detach()))
            grads = dict(zip(names, grads))
            if k == 0:
                out['grads'] = {n: g.detach().float().cpu()
                                for n, g in grads.items()}
            adam.step(train, grads, self.lr)
            del rb, grads, loss, pred
        out['changes'] = {n: (train[n].detach() - p0[n]).float().cpu()
                          for n in train}
        return out

    def check(self, program=None):
        """The program's readings (or `program`'s: the control's, a
        fault's) against the reference's: every number of checks.py's
        training list; limits/<cell>.json says which decide `correct`."""
        got = program or self.program_readings()
        if not hasattr(self, 'ref'):
            self.ref = self.reference_readings(RN.Numerics.reference())
        ref = self.ref
        if not hasattr(self, 'ref_norms'):
            self.ref_norms = {t: checks.norms(ref[t])
                              for t in ('grads', 'changes')}
        leaves = checks.counted_leaves(self.ref_norms['grads'])
        gn, cn = self.ref_norms['grads'], self.ref_norms['changes']
        g_scale = checks.leaf_scale(gn, leaves)
        grad_gap = checks.norm_gaps(checks.norms(got['grads']), gn, g_scale)
        grad_diff = checks.diff_gaps(got['grads'], ref['grads'], g_scale)
        out_diff = checks.diff_gaps(got['grads'], ref['grads'], {
            k: g_scale[k] for k in output_leaves(
                self.ctx.config['model']['heads']) if k in g_scale})
        change_gap = checks.norm_gaps(checks.norms(got['changes']), cn,
                                      checks.leaf_scale(cn, leaves))
        out = {'head_gap': checks.head_gap(got['heads'], ref['heads']),
               'loss_gap': checks.loss_gap(got['losses'][:1],
                                           ref['losses'][:1]),
               'loss3_gap': checks.loss_gap(got['losses'], ref['losses']),
               'grad_gap_median': checks.median(grad_gap),
               'grad_diff_median': checks.median(grad_diff)}
        worst = {}
        for name, gaps in (('grad_gap', grad_gap), ('out_grad_diff', out_diff),
                           ('change_gap', change_gap)):
            out[name], worst[name] = checks.worst(gaps)
        self.ctx.note('worst_leaves', worst)
        self.ctx.note('leaves_counted', [len(leaves),
                                         len(self.ref_norms['grads'])])
        self.ctx.note('losses', {'program': got['losses'],
                                 'reference': ref['losses']})
        return out

    def control_outputs(self):
        return self.reference_readings(RN.Numerics.control())

    def fault_outputs(self):
        """Readings with each of the cell's faults in the program's place:
        half of every batch left out of the loss (the reference, mean over
        the rest)."""
        return {'half_batch': self.reference_readings(
            RN.Numerics.reference(), half=True)}
