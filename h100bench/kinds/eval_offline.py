"""eval-offline: what `Evaluater` does over a validation split. A closed
loop: one `FusedInferencePipeline.run` over batches of `batch_size`
scenes from a pool of `pool_batches` unique batches, cycled until the
window closes; the pack, the copy to the card, the forward, the
post-processing, the readback and the host unpack all happen inside it.
Scene generation, voxelisation and batch building happen in set-up.

End-to-end: infer_peak_gb (max_memory_allocated over the window, after a
reset at its start). Per layer, from the traced run's window:
scenes_per_s.infer (scenes whose results `run` yielded, over the window
from its first batch taken to its last result) and batch_ms_p90.infer
(over every batch: from the pipeline taking it from the benchmark's
iterator to `run` yielding its results); every run notes both.

Correct: for each pool batch one occurrence in the window, drawn from the
seed, is kept: the four heads as the pipeline's `infer` made them, and the
results `run` yielded. The reference recomputes the heads from the scenes
(head_gap), and post-processes the program's heads itself (mask_miss).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100bench import checks, device as D, flops, weights
from h100bench.kinds.common import make_scenes, reference_batch, scene_seeds
from h100bench.reference import numerics as RN
from h100bench.reference import post as RP
from h100bench.reference import targets as RT
from h100bench.reference.net import Net


class Session:
    moves = 'infer_peak_gb'

    def __init__(self, ctx):
        self.ctx = ctx
        port, cfg_json, tr = ctx.port, ctx.config, ctx.traffic
        self.cfg = port.make_cfg(cfg_json)
        self.dev = ctx.device
        n_pool, bs = tr['pool_batches'], tr['batch_size']
        items = make_scenes(cfg_json, scene_seeds(ctx.seed, n_pool * bs))
        self.items = [items[j * bs:(j + 1) * bs] for j in range(n_pool)]
        t0 = time.perf_counter()
        self.pool = [port.host_batch(self.cfg, cfg_json, b, 'test')
                     for b in self.items]
        ctx.note('host_prep_s', time.perf_counter() - t0)
        ctx.note('voxels_per_scene',
                 [n for _, h in self.pool for n in h['num_voxels']])
        ctx.note('segments_per_batch',
                 [int(d['num_segments']) for d, _ in self.pool])
        self.model = port.build_model(self.cfg, cfg_json, self._weights(),
                                      self.dev)
        self.pipe = port.pipeline(self.cfg, cfg_json, self.model, self.dev)
        self.ths = self.cfg.eval_ths
        rng = np.random.default_rng([int(ctx.seed), 1])
        self.target_cycle = rng.integers(0, tr['check_cycles'], n_pool)
        self.captured, self.ref_heads = {}, {}
        for _ in self.pipe.run(None, iter(self.pool), self.ths):   # warm-up
            pass
        D.sync(self.dev)
        self.setup_peak = self._allocated_peak()

    # ------------------------------------------------------------ window
    def _run(self, seconds, capture, max_batches=None):
        """Cycle the pool through the pipeline until `seconds` have passed
        (or `max_batches` were fed); returns (window seconds, scenes,
        per-batch latencies, failures, batches fed)."""
        n_pool = len(self.pool)
        taken, fed = [], []
        infer = self.pipe.infer
        calls = [0]

        def capturing_infer(batch, ths):
            pred, full, out = infer(batch, ths)
            k = calls[0]
            calls[0] += 1
            j, c = fed[k]
            if capture and c <= self.target_cycle[j]:
                n = int(self.pool[j][0]['num_segments'])
                self.captured[j] = {'pred': {h: v[:n] for h, v in
                                             pred.items()}}
            return pred, full, out
        self.pipe.infer = capturing_infer

        t0 = time.perf_counter()
        deadline = t0 + seconds

        def feed():
            k = 0
            while (time.perf_counter() < deadline
                   and (max_batches is None or k < max_batches)):
                fed.append((k % n_pool, k // n_pool))
                taken.append(time.perf_counter())
                yield self.pool[k % n_pool]
                k += 1
        lat, scenes, failed = [], 0, 0
        try:
            for i, (results, _, _, host) in enumerate(
                    self.pipe.run(None, feed(), self.ths)):
                lat.append(time.perf_counter() - taken[i])
                j, c = fed[i]
                scenes += len(host['scene'])
                failed += _malformed(results, host)
                if capture and c <= self.target_cycle[j]:
                    self.captured[j]['results'] = results
        finally:
            self.pipe.infer = infer
        return time.perf_counter() - t0, scenes, lat, failed, len(fed)

    def window(self, seconds):
        if self.dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        self.ctx.mark_window_start(t0)
        window_s, scenes, lat, failed, n_batches = self._run(seconds, True)
        peak = self._allocated_peak()
        self.peak = max(peak, self.setup_peak)
        self.window_s, self.n_batches = window_s, n_batches
        self.scenes = scenes
        self.p90_ms = float(np.quantile(lat, 0.9, method='linear')) * 1e3
        bs = self.ctx.traffic['batch_size']
        self.ctx.note('batches', n_batches)
        self.ctx.note('latency_samples', len(lat))
        self.ctx.note('latency_ms_median', float(np.median(lat)) * 1e3)
        self.ctx.note('scenes_per_s', scenes / window_s)
        self.ctx.note('batch_ms_p90', self.p90_ms)
        return {'attempted': n_batches * bs, 'failed': failed
                + (n_batches * bs - scenes),
                'metrics': {'infer_peak_gb': peak / 1e9}}

    def _weights(self):
        """The seeded weights, with the traffic's background logit on the
        semantics head (weights.background_bias)."""
        w = weights.make(self.ctx.config, self.ctx.seed, self.dev)
        weights.background_bias(w, self.ctx.config,
                                self.ctx.traffic['background_logit'])
        return w

    def _unbiased(self, heads):
        """Heads with the background logit taken off the semantics, so
        that head_gap compares the logits the network computed."""
        b = np.zeros(heads['mlp_semantics'].shape[1], np.float32)
        fg = RT.is_foreground(self.ctx.config['classes']['valid_ids'],
                              self.ctx.config['classes']['foreground'])
        b[~fg] = self.ctx.traffic['background_logit']
        return dict(heads, mlp_semantics=heads['mlp_semantics'] - b)

    def _allocated_peak(self):
        return (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == 'cuda' else 0)

    def memory_peak(self):
        return self.peak

    # ------------------------------------------------------------- trace
    def trace(self):
        port, dev = self.ctx.port, self.dev
        m = dict(self.ctx.config['model'],
                 classes=self.ctx.config['classes']['valid_ids'])
        t0 = time.perf_counter()
        stages = [port.infer_stages(self.pipe, self.cfg, d, h, dev)
                  for d, h in self.pool]
        t1 = time.perf_counter()
        self.ctx.note('kept_masks_per_scene',
                      [n for s in stages for n in s['kept_masks']])
        fwd_flops, conv_dev, conv_bound = [], 0.0, 0.0
        act_bytes = 2 if m['act_dtype'] == 'bfloat16' else 4
        for d, _ in self.pool:
            sites = flops.conv_sites(flops.batch_counts(d), m)
            fwd_flops.append(flops.forward_flops(sites))
            conv_bound += flops.bound_s(
                flops.key_conv_launches(sites, act_bytes, train=False),
                D.PEAK_BF16_FLOP_S, D.PEAK_HBM_BYTES_S)
            prof = D.profile(port.forward_only(self.pipe, d, dev), dev,
                             host=False)
            conv_dev += D.key_conv_device_s(prof['by_name'])
        n_pool = len(self.pool)
        window_flops = sum(fwd_flops[k % n_pool] for k in
                           range(self.n_batches))
        t2 = time.perf_counter()
        stretch = D.profile(lambda: self._run(
            float('inf'), False, self.ctx.traffic['trace_batches']), dev)
        self.ctx.note('trace_phases_s', {
            'stages': t1 - t0, 'counts_and_kernels': t2 - t1,
            'stretch': time.perf_counter() - t2})
        return {'stages': stages,
                'conv': {'device_s': conv_dev, 'bound_s': conv_bound},
                'window': {'seconds': self.window_s, 'flops': window_flops,
                           'peak_flop_s': D.PEAK_BF16_FLOP_S,
                           'scenes': self.scenes, 'p90_ms': self.p90_ms},
                'profile': stretch}

    # ------------------------------------------------------------- check
    def release(self):
        """Free the program's state; keep what the check reads on the host."""
        for j, cap in self.captured.items():
            cap['pred'] = {h: v.float().cpu().numpy()
                           for h, v in cap['pred'].items()}
        del self.pipe, self.model
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    def check(self, program=None):
        """The numbers compared: the program's captured outputs against the
        reference. `program` stands in for the captured outputs (the
        control, `control_outputs`)."""
        numerics = RN.Numerics.reference()
        cj, dev = self.ctx.config, self.dev
        m = cj['model']
        params = self._weights()
        gaps, miss, total = [], 0, 0
        for j, items in enumerate(self.items):
            cap = (program or self.captured).get(j)
            if cap is None or 'results' not in cap:
                return {'head_gap': float('inf'), 'mask_miss': 1.0}
            rb = reference_batch(cj, items, dev)
            if j not in self.ref_heads:
                with torch.no_grad():
                    ref = Net(params, m['heads'], m['layers'], numerics)(
                        rb['geo'], rb['feats'], rb['pool'], rb['n_seg'])
                self.ref_heads[j] = {h: v.cpu().numpy()
                                     for h, v in ref.items()}
            ref = self.ref_heads[j]
            if len(cap['pred'][m['heads'][0]]) != rb['n_seg']:
                return {'head_gap': float('inf'), 'mask_miss': 1.0}
            gaps.append(checks.head_gap(self._unbiased(cap['pred']),
                                        self._unbiased(ref)))
            for i, (scene, _) in enumerate(items):
                want = self._post(rb, i, cap['pred'], numerics)
                got = cap['results'].get(scene['name'])
                if got is None:
                    n = len(want['conf'])
                    miss, total = miss + max(n, 1), total + max(n, 1)
                    continue
                a, b = checks.mask_miss(got, want)
                miss, total = miss + a, total + b
        return {'head_gap': max(gaps), 'mask_miss': miss / max(total, 1)}

    def _post(self, rb, i, pred, numerics):
        """The reference post-processing of scene i of a batch from the
        heads `pred` of the batch's segments."""
        cj = self.ctx.config
        m = cj['model']
        lo, hi = rb['seg_off'][i], rb['seg_off'][i + 1]
        v = rb['vox'][i]
        heads = {'offsets': pred['mlp_offsets'][lo:hi],
                 'bounds': pred['mlp_bounds'][lo:hi],
                 'scores': pred['mlp_bb_scores'][lo:hi, 0],
                 'semantics': pred['mlp_semantics'][lo:hi]}
        return RP.scene_masks(
            heads, v['seg_loc'], v['vox_seg_row'], v['point_seg_row'],
            m['eval_ths'], cj['classes']['valid_ids'],
            cj['classes']['foreground'], m['min_bb_size'],
            cj['eval']['max_masks'], numerics)

    def fault_outputs(self):
        return {}

    def control_outputs(self):
        """The control in the program's place: the reference one precision
        step down (numerics.Numerics.control) makes the heads and the
        results of every pool batch."""
        cj, dev = self.ctx.config, self.dev
        m = cj['model']
        low = RN.Numerics.control()
        params = self._weights()
        out = {}
        for j, items in enumerate(self.items):
            rb = reference_batch(cj, items, dev)
            with torch.no_grad():
                pred = Net(params, m['heads'], m['layers'], low)(
                    rb['geo'], rb['feats'], rb['pool'], rb['n_seg'])
            pred = {h: v.cpu().numpy() for h, v in pred.items()}
            out[j] = {'pred': pred, 'results': {
                scene['name']: self._post(rb, i, pred, low)
                for i, (scene, _) in enumerate(items)}}
        return out


def _malformed(results, host):
    """Scenes of a batch whose results are missing or malformed."""
    bad = 0
    for si, scene in enumerate(host['scene']):
        r = results.get(scene['name'])
        n_pts = len(host['vox2point'][si])
        if (r is None or r['mask'].shape != (len(r['conf']), n_pts)
                or not np.isfinite(r['conf']).all()):
            bad += 1
    return bad
