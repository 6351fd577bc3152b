#!/usr/bin/env python3
"""How the whole-step grads distance of chip_smoke.py phase 7 depends on the
state it is read at (one NVIDIA GPU).

  python3 scripts/grads_state_spread.py [N]

Builds the kernels and phase 6's two batches of 8 ScanNet-scale scenes, then
N times: phase 6 (train_phase: its steps sum with index_add_'s CUDA atomics,
so each run ends in another state) and phase 7's check on the state it
left; then phase 7 as chip_smoke.py runs it, on the replayed state, twice.
Prints one JSON line per reading: the state, phase 7's loss and both
distances (the twins' backward on the same forward graph, the twins' whole
step), the ratio of the two grad norms, the five tensors with the largest
share of the whole-step difference, and whether the check passed. Last, the
card's name and power limit.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from box2mask_torch.sparse import _build  # noqa: E402

reading = {}
_distance = CS.grad_distance


def grad_distance(a, b):
    """chip_smoke's distance, recording the norms and the largest shares."""
    l2, cos, per = _distance(a, b)
    diff = {k: float((a[k].double() - b[k].double()).square().sum())
            for k in b}
    na = sum(float(a[k].double().square().sum()) for k in b)
    nb = sum(float(b[k].double().square().sum()) for k in b)
    total = sum(diff.values())
    reading.setdefault('distances', []).append({
        'l2': l2, 'cos': cos, 'norm_ratio': (na / nb) ** 0.5,
        'top_share': [(k, diff[k] / total) for k in
                      sorted(diff, key=lambda k: -diff[k])[:5]]})
    return l2, cos, per


def read(state_name, cfg, state, batch):
    global reading
    reading = {'state': state_name}
    try:
        CS.grads_phase(cfg, state, batch)
        reading['passed'] = True
    except AssertionError as e:
        reading['passed'] = str(e)
    print('SPREAD ' + json.dumps(reading), flush=True)


def main():
    if not torch.cuda.is_available():
        print('grads_state_spread: no CUDA device', file=sys.stderr)
        return 2
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    CS.grad_distance = grad_distance
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = CS.resolve_device(None)
    _build.build_all()
    cfg, batches = CS.train_batches(smi)
    dev = None
    for i in range(n):
        state, dev, _, _ = CS.train_phase(cfg, batches, device, smi)
        read(f'phase 6 run {i}', cfg, state, dev[1])
        del state
        torch.cuda.empty_cache()
    for i in range(2):
        read(f'replayed {i}', cfg,
             CS.replayed_state(cfg, dev, CS.TRAIN_STEPS), dev[1])
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == '__main__':
    sys.exit(main())
