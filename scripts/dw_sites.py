#!/usr/bin/env python3
"""Every key_conv_dw call of a scannet-train step, on the card: shape, pair
share, in-step device ms (CUDA events around the call), the memory held
when it starts and its own peak; then each call alone, device ms by
kernel under torch.profiler. One JSON line per call, a summary last.
The step is the benchmark's (h100bench, cell scannet-train, the given
seed); the inputs of the first step's calls are kept for the timings
alone, so the memory readings hold them too (compare them between
versions, not with train_peak_gb).

    python3 scripts/dw_sites.py [seed] [out.json]
"""

import json
import os
import re
import statistics
import subprocess
import sys
import time

T = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from box2mask_torch.sparse import key_conv as KC  # noqa: E402
from box2mask_torch.sparse.keys import SENT_KEY  # noqa: E402
from h100bench import trace_program as TP  # noqa: E402


def split_ms(fn, reps=5):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    agg = {}
    for e in prof.events():
        if e.device_type.name == 'CUDA':
            m = re.search(r'(\w+_kernel\w*?)(?:<|\b)', e.name)
            k = m.group(1) if m else e.name[:40]
            t, c = agg.get(k, (0.0, 0))
            agg[k] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return {k: round(t / reps, 5) for k, (t, c) in agg.items()}


def event_ms(fn, reps=5):
    fn()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def main():
    seed = int(sys.argv[1]) if len(sys.argv) > 1 else 3500004005
    out_path = sys.argv[2] if len(sys.argv) > 2 else None
    dev = torch.device('cuda')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({'card': smi, 'torch': torch.__version__}), flush=True)
    sess, _ = TP._session(ROOT, 'scannet-train', seed, dev)
    orig = KC.key_conv_dw
    calls, keep = [], {'on': False, 'inputs': None}

    def wrapped(x, g, kin, kout, **kw):
        if not keep['on']:
            return orig(x, g, kin, kout, **kw)
        seg_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig(x, g, kin, kout, **kw)
        e1.record()
        call_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        calls.append(dict(kw=kw, cin=x.shape[1], cout=g.shape[1],
                          B=kin.shape[0], pad_in=kin.shape[1],
                          pad_out=kout.numel() // kin.shape[0],
                          before=before, call_peak=call_peak,
                          seg_peak=seg_peak, ev=(e0, e1)))
        if keep['inputs'] is not None:
            keep['inputs'].append((x.clone(), g.clone(), kin, kout, kw))
        return out

    KC.key_conv_dw = wrapped
    n_pool = len(sess.pool)
    steps = []
    for k in range(n_pool):
        calls.clear()
        keep['on'] = True
        keep['inputs'] = [] if k == 0 else None
        if k == 0:
            inputs = keep['inputs']
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sess.trainer.step(sess.pool[k], sess.lr)
        torch.cuda.synchronize()
        last = torch.cuda.max_memory_allocated()
        keep['on'] = False
        ms = [c['ev'][0].elapsed_time(c['ev'][1]) for c in calls]
        peaks = [max(c['call_peak'], c['seg_peak']) for c in calls] + [last]
        steps.append(dict(calls=[dict(c) for c in calls], ms=ms,
                          step_peak=max(peaks)))
    KC.key_conv_dw = orig
    base = steps[0]['calls']
    rows = []
    for i, c in enumerate(base):
        mem = steps[1]['calls'][i]
        x, g, kin, kout, kw = inputs[i]
        n_valid = int((kout < SENT_KEY).sum())
        pairs = [int(h.sum()) for h, _ in KC._matches(
            kin, kout, kw.get('kernel_size', 3), kw.get('stride_child', False),
            kw.get('stride_parent', False), kw.get('scale', 1),
            kw.get('guard', True))]
        mode = ('down' if kw.get('stride_child') else 'up'
                if kw.get('stride_parent') else 'same')
        fn = lambda: KC.key_conv_dw(x, g, kin, kout, **kw)   # noqa: E731
        row = dict(i=i, mode=mode, level=kw.get('scale', 1).bit_length() - 1,
                   cin=c['cin'], cout=c['cout'], rows_out=kout.numel(),
                   valid_out=n_valid, pairs=sum(pairs),
                   pair_share=sum(pairs) / (len(pairs) * kout.numel()),
                   empty_offsets=sum(p == 0 for p in pairs),
                   step_ms=[s['ms'][i] for s in steps],
                   alone_ms=event_ms(fn), split=split_ms(fn),
                   before_gb=mem['before'] / 1e9,
                   call_peak_gb=mem['call_peak'] / 1e9,
                   scratch_gb=(mem['call_peak'] - mem['before']) / 1e9)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = dict(
        card=smi, seed=seed, calls=len(base),
        step_ms_sum=[sum(s['ms']) for s in steps],
        alone_ms_sum=sum(r['alone_ms'] for r in rows),
        step_peak_gb=[s['step_peak'] / 1e9 for s in steps[1:]],
        max_call_peak_gb=max(r['call_peak_gb'] for r in rows),
        argmax_call_peak=max(rows, key=lambda r: r['call_peak_gb'])['i'],
        by_kernel={k: round(sum(r['split'].get(k, 0) for r in rows), 4)
                   for k in sorted({k for r in rows for k in r['split']})},
        seconds=time.perf_counter() - T)
    print(json.dumps(summary), flush=True)
    if out_path:
        os.makedirs(os.path.dirname(out_path) or '.', exist_ok=True)
        with open(out_path, 'w') as f:
            json.dump(dict(rows=rows, summary=summary), f)


if __name__ == '__main__':
    main()
