#!/usr/bin/env python3
"""Data-parallel training across cards: chip_smoke.py phase 15 (c) at 2 and
4 NCCL ranks, one card each, and the `--multigpu` CLI over every card, on a
machine with two or more NVIDIA GPUs.

    python3 scripts/dp_multicard.py

Builds the kernels, prepares phase 6's two batches of 8 ScanNet-scale
scenes, then for each world size the machine's cards allow (2, 4) runs
chip_smoke.dp_multi_phase: every rank on its loader shard of each batch of
8 (4 or 2 scenes), phase 6's weights from rank 0, 3 data-parallel steps per
conv path with every loss finite and equal on the ranks, the parameters
bit-equal across the ranks after every step, every kernel launched on
every rank, one step's averaged grads against the twins' data-parallel
backward; `[dp_nccl<N>]` lines with each rank's ms per step, its grad
all-reduce ms and peak memory. Then chip_smoke.dp_cli_check: `python -m
box2mask_torch.train --multigpu`, one rank per card (`[dp_cli]`). Fails on
any miss, as chip_smoke.py does.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from box2mask_torch.runtime import resolve_device  # noqa: E402
from box2mask_torch.sparse import _build  # noqa: E402


def main():
    t00 = time.perf_counter()
    resolve_device(None)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    C.log('python', sys.version.split()[0], 'torch', torch.__version__,
          'cuda', torch.version.cuda, smi)
    smi = smi[0]
    n = torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f'needs two or more cards, found {n}')
    t0 = time.perf_counter()
    _build.build_all()
    C.log(f'[build] {time.perf_counter() - t0:.1f} s')
    _, tbatches = C.train_batches(smi)
    for world in (2, 4):
        if world <= n:
            t0 = time.perf_counter()
            C.dp_multi_phase(f'dp_nccl{world}', world, 'nccl',
                             list(range(world)), tbatches, smi)
            C.log(f'[t] nccl {world} ranks {time.perf_counter() - t0:.1f} s')
    t0 = time.perf_counter()
    C.dp_cli_check(smi)
    C.log(f'[t] cli {time.perf_counter() - t0:.1f} s; total '
          f'{time.perf_counter() - t00:.1f} s')


if __name__ == '__main__':
    main()
