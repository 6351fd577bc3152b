#!/usr/bin/env python3
"""The program's own spans and counters over a cell's loop, on the card:

    python3 h100bench/trace_program.py --workload <cell> --seed <n>
        [--rounds 2]

Set-up as a run of the cell (h100bench/harness.py), then in turns, each
`--rounds` times (the second round in reverse order) the cell's traced
stretch (traffic's trace_batches batches or trace_steps steps of the
window's own loop) three ways: with no profiler ("off"), under the
benchmark's profiler (device.profile, the calling thread's host events:
"profile") and under spans.program_profile with the program's counters
reset before and read after ("program"). Prints one JSON line: the card,
each way's ms per batch or step, and per program stretch its per-layer
readings (spans.layer_readings), the idle ms per batch or step by span,
the share of idle time under a span, and the spans and counters.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from box2mask_torch import tracing  # noqa: E402
from h100bench import device as D  # noqa: E402
from h100bench import harness, spans  # noqa: E402


def _session(root, workload, seed, device):
    import importlib
    from h100bench import port
    from h100bench.reference.numerics import no_tf32
    bench = harness.load_bench(root)
    cell, config, traffic = harness.cell_files(root, bench, workload)
    no_tf32()
    ctx = harness.Context(root, cell, config, traffic, seed, device, port,
                          T_START)
    if device.type == 'cuda':
        ctx.note('nvcc_s', port.build_all())
    kind = importlib.import_module(f'h100bench.kinds.{traffic["kind"]}')
    return kind.Session(ctx), traffic


def _stretch(sess, traffic):
    """(kind, fn running the cell's traced stretch and returning its
    batches and scenes, or steps)."""
    if 'trace_batches' in traffic:
        def infer():
            _, scenes, _, _, fed = sess._run(float('inf'), False,
                                             traffic['trace_batches'])
            return {'batches': fed, 'scenes': scenes}
        return 'infer', infer
    n_pool = len(sess.pool)

    def train():
        for k in range(traffic['trace_steps']):
            sess.trainer.step(sess.pool[k % n_pool], sess.lr)
        return {'steps': traffic['trace_steps']}
    return 'train', train


def run(root, workload, seed, device, rounds=2):
    """The JSON-able result of trace_program on `workload`."""
    sess, traffic = _session(root, workload, seed, device)
    kind, fn = _stretch(sess, traffic)
    unit, one = ('batches', 'batch') if kind == 'infer' else ('steps',
                                                              'step')
    ms = {'off': [], 'profile': [], 'program': []}
    programs = []
    order = ['off', 'profile', 'program']
    for r in range(rounds):
        for way in order if r % 2 == 0 else order[::-1]:
            if way == 'off':
                D.sync(device)
                t0 = time.perf_counter()
                n = fn()
                D.sync(device)
                s = time.perf_counter() - t0
            elif way == 'profile':
                box = {}
                s = D.profile(lambda: box.update(fn()), device)['window_s']
                n = box
            else:
                tracing.reset_counts()
                n, prof = spans.program_profile(fn, device)
                prog = dict(n, profile=prof, counts=tracing.counts())
                if kind == 'infer':
                    prog.update(pack_s=sess.pipe.pack_s,
                                wire_bytes=sess.pipe.wire_bytes)
                programs.append(prog)
                s = prof['seconds']
            ms[way].append(1e3 * s / n[unit])
    out = {'workload': workload, 'seed': seed,
           'card': D.card(device) if device.type == 'cuda' else 'cpu',
           'torch': torch.__version__,
           f'ms_per_{one}': {k: statistics.median(v)
                             for k, v in ms.items()},
           f'ms_per_{one}_runs': ms, 'programs': []}
    for prog in programs:
        p = prog['profile']
        out['programs'].append({
            'readings': spans.layer_readings(kind, prog),
            'idle_ms_by_span': {k: 1e3 * v / prog[unit] for k, v in
                                p['idle_by_span'].items()},
            'idle_ms_unspanned': 1e3 * p['idle_s_unspanned'] / prog[unit],
            'idle_share': p['idle_s'] / p['seconds'],
            'spanned_share': spans.spanned_share(p),
            'launches': p['launches'], unit: prog[unit],
            'spans': p['spans'], 'counts': prog['counts']})
    return out


def main(argv):
    import argparse
    p = argparse.ArgumentParser('trace_program')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--rounds', type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log('no CUDA device: nothing measured')
        return 3
    out = run(os.path.dirname(harness.HERE), args.workload, args.seed,
              torch.device('cuda', 0), args.rounds)
    print(json.dumps(harness._finite(out)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
