"""The benchmark's driver, run as

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout. Everything is found by name from
BENCHMARK.json: the cell's configuration file, its traffic file
(`traffic/<traffic>.json`, whose "kind" names the driver
`kinds/<kind>.py`), its limits (`limits/<cell>.json`) and the readers of
its per-layer metrics (`metrics/<name>.py`, each `read(obs)` returning a
number, or None when its cell gives it nothing to read).

A run: set-up (the kernels built or found, the scenes and batches made,
the weights made on the card, every shape warmed up), the measured window,
with --trace 1 the per-layer readings, then the peak memory, the program's
state freed, and the comparison with the reference. The last line of
standard output is one JSON object: correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and last `compared`, every number that
decided `correct` beside its limit (also the last lines of standard
error). Without a card, with too few cards, or with JAX loaded in the
process, it prints no result and exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'box2mask_tpu')
HERE = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print('[h100bench]', *a, file=sys.stderr, flush=True)


def load_bench(root):
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        return json.load(f)


def _json(root, rel):
    with open(os.path.join(root, rel)) as f:
        return json.load(f)


def cell_files(root, bench, workload):
    """(cell entry, configuration file, traffic file) of `workload`."""
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}: one of '
                         f'{sorted(cells)}')
    cell = cells[workload]
    conf = {c['name']: c for c in bench['configs']}[cell['config']]
    config = _json(root, conf['file'])
    traffic = _json(root, os.path.join('h100bench', 'traffic',
                                       cell['traffic'] + '.json'))
    return cell, config, traffic


def end_to_end(bench, workload):
    return [m for m in bench['end_to_end']
            if 'workloads' not in m or workload in m['workloads']]


def per_layer(bench, workload):
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose `moves` metric the cell reports."""
    e2e = {m['name'] for m in end_to_end(bench, workload)}
    return [m for m in bench['per_layer']
            if workload in m.get('workloads', ())
            or ('workloads' not in m and m['moves'] in e2e)]


def reader(root, name):
    path = os.path.join(root, 'h100bench', 'metrics', name + '.py')
    spec = importlib.util.spec_from_file_location(
        'h100bench_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a traffic kind's Session gets: the run's arguments, files and
    device, the program's door (`port`), and a place for notes."""

    def __init__(self, root, cell, config, traffic, seed, device, port,
                 t_start):
        self.root, self.cell, self.config, self.traffic = (root, cell,
                                                           config, traffic)
        self.seed, self.device, self.port = seed, device, port
        self.t_start = t_start
        self.window_start = None
        self.notes = {}

    def note(self, key, value):
        self.notes[key] = value
        log(f'{key}: {json.dumps(value)}')

    def mark_window_start(self, t):
        self.window_start = t


def run_cell(root, workload, seed, seconds, trace, device, t_start,
             port=None, session_hook=None):
    """One run of `workload`; returns the result dict (without printing).
    `session_hook(session)`, if given, runs between set-up and the window
    (tests plant faults with it)."""
    from h100bench import checks
    from h100bench.reference.numerics import no_tf32
    bench = load_bench(root)
    cell, config, traffic = cell_files(root, bench, workload)
    if port is None:
        from h100bench import port
    no_tf32()
    ctx = Context(root, cell, config, traffic, seed, device, port, t_start)
    if device.type == 'cuda':
        ctx.note('nvcc_s', port.build_all())
    kind = importlib.import_module(f'h100bench.kinds.{traffic["kind"]}')
    sess = kind.Session(ctx)
    if session_hook is not None:
        session_hook(sess)
    port.reset_counts()
    res = sess.window(seconds)
    ctx.note('window_launches', port.counts())
    setup_s = ctx.window_start - t_start
    metrics = {}
    want = end_to_end(bench, workload)
    units = {m['name']: m['unit'] for m in bench['end_to_end']
             + bench['per_layer']}
    if not trace:
        vals = dict(res['metrics'], setup_s=setup_s)
        for m in want:
            metrics[m['name']] = {'value': vals[m['name']],
                                  'unit': m['unit']}
    import torch
    cuda = device.type == 'cuda'
    dev_info = {'platform': 'gpu' if cuda else 'cpu',
                'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
                'count': 1}
    breakdown = None
    if trace:
        obs = sess.trace()
        for m in per_layer(bench, workload):
            v = reader(root, m['name'])(obs)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': units[m['name']]}
        prof = obs['profile']
        dev_info['busy_s'] = prof['busy_s']
        dev_info['window_s'] = prof['window_s']
        from h100bench import device as D
        breakdown = {'device_ops': D.top_ops(prof['by_name']),
                     'idle_gaps': prof['idle_gaps']}
    dev_info['memory_peak_bytes'] = int(sess.memory_peak())
    sess.release()
    numbers = sess.check()
    ctx.note('readings', numbers)
    limits = checks.load_limits(root, workload)
    correct, rows = checks.verdict(numbers, limits)
    out = {'correct': bool(correct and res['failed'] == 0),
           'attempted': int(res['attempted']), 'failed': int(res['failed']),
           'metrics': metrics, 'device': dev_info}
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['compared'] = {r['name']: {'value': r['value'], 'limit': r['limit']}
                       for r in rows}
    return out


def _finite(obj):
    """The result with non-finite numbers as strings (JSON has none)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv, t_start):
    p = argparse.ArgumentParser('h100bench')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = os.path.dirname(HERE)
    import torch
    bench = load_bench(root)
    cell, _, _ = cell_files(root, bench, args.workload)
    if not torch.cuda.is_available():
        log('no CUDA device: nothing measured')
        return 3
    if torch.cuda.device_count() < cell['chips']:
        log(f'{cell["chips"]} cards asked for, '
            f'{torch.cuda.device_count()} present: nothing measured')
        return 3
    device = torch.device('cuda', 0)
    from h100bench import device as D
    card = D.card(device)
    log(f'card: {json.dumps(card)}; torch {torch.__version__} cuda '
        f'{torch.version.cuda}')
    out = run_cell(root, args.workload, args.seed, args.seconds,
                   bool(args.trace), device, t_start)
    bad = forbidden_loaded()
    if bad:
        log(f'modules loaded that the benchmark may not load: {bad}')
        return 4
    for name, r in out['compared'].items():
        log(f'compared {name} {r["value"]!r} limit {r["limit"]!r}')
    print(json.dumps(_finite(out)), flush=True)
    return 0
