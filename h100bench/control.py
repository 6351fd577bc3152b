#!/usr/bin/env python3
"""The readings that the limits of `correct` are set from (not run by the
benchmark's own runs). For each seed, in one process on the card:

  program   the numbers a run compares: the program's outputs against
            the reference (the lower readings);
  control   the same numbers with the control in the program's place:
            the reference one precision step below what the configuration
            states (reference/numerics.py; the upper readings);
  faults    the same numbers with each of the cell's faults in the
            program's place, where the kind plants one in the reference
            (train-steps: half of every batch left out).

    python3 h100bench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]

`--seconds` is the window each seed runs before its check (it has to see
the whole pool once). One JSON line per seed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from h100bench import harness  # noqa: E402


def readings(root, workload, seed, seconds, device, port):
    from h100bench.reference.numerics import no_tf32
    bench = harness.load_bench(root)
    cell, config, traffic = harness.cell_files(root, bench, workload)
    no_tf32()
    ctx = harness.Context(root, cell, config, traffic, seed, device, port,
                          time.perf_counter())
    kind = importlib.import_module(f'h100bench.kinds.{traffic["kind"]}')
    t0 = time.perf_counter()
    sess = kind.Session(ctx)
    sess.window(seconds)
    sess.release()
    row = {'workload': workload, 'seed': seed,
           'program': sess.check(),
           'control': sess.check(program=sess.control_outputs())}
    for name, got in sess.fault_outputs().items():
        row[f'fault_{name}'] = sess.check(program=got)
    row['seconds'] = time.perf_counter() - t0
    return row


def main(argv):
    p = argparse.ArgumentParser('h100bench-control')
    p.add_argument('--workload', required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--out', default=None)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        harness.log('no CUDA device')
        return 3
    device = torch.device('cuda', 0)
    from h100bench import port
    port.build_all()
    root = os.path.dirname(harness.HERE)
    for seed in args.seeds:
        row = readings(root, args.workload, seed, args.seconds, device, port)
        line = json.dumps(harness._finite(row))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
