"""End-to-end inference scenes/s of FusedInferencePipeline with each upload
route, over many alternating rounds, on one CUDA card.

The routes are those of chip_smoke.py phase 17 (c) (`wire_e2e`): the
per-array upload, the compact wire packed one batch ahead on the packer
thread (the pipeline as shipped) and the compact wire packed on the main
thread. The batches, weights and preset are chip_smoke.py phase 3's: 4
synthetic ScanNet-val-scale scenes a batch, configs/scannet.txt, seeded
kaiming weights. Each round runs the routes in the order per-array, ahead,
inline, inline, ahead, per-array; the last lines give each route's median
and, per round, each packed route's scenes/s over the per-array route's.

    python scripts/wire_ab.py [--rounds 5]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--rounds', type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('wire_ab: no CUDA device', file=sys.stderr)
        return 2
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    CS._build.build_all()
    cfg = CS.get_config(['--config', os.path.join(ROOT, 'configs',
                                                  'scannet.txt'),
                         '--vox_bucket', '131072', '--seg_bucket', '2048'])
    valid_ids, _, _, is_fg = CS.tables.get_tables('scannet')
    batches = CS.synthetic.scannet_scale_batches(cfg, CS.N_BATCHES + 1,
                                                 CS.BATCH)
    model = CS.S.build_model(cfg, len(valid_ids))
    CS.kaiming_init_(model, torch.Generator().manual_seed(1))
    pipe = CS.FusedInferencePipeline(cfg, valid_ids, is_fg, model=model,
                                     top_k=128, max_masks=256)
    for _ in pipe.run(None, batches, cfg.eval_ths):          # warm-up
        pass
    by = CS.wire_e2e(pipe, cfg, batches, smi, rounds=a.rounds)
    n = len(CS.WIRE_E2E_ORDER)
    ratios = {}
    for route in ('packed_ahead', 'packed_inline'):
        # per round: the route's two runs over the per-array route's two
        ratios[route] = [
            sum(by[route][2 * i:2 * i + 2])
            / sum(by['per_array'][2 * i:2 * i + 2]) for i in range(a.rounds)]
    print(smi)
    print(json.dumps({
        'rounds': a.rounds, 'runs_per_round': n,
        'median_scenes_s': {k: statistics.median(v) for k, v in by.items()},
        'over_per_array_per_round': ratios,
        'over_per_array_median': {k: statistics.median(v)
                                  for k, v in ratios.items()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
