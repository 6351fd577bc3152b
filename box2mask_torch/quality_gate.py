"""Quality gate of the port: overfit one synthetic scene through the port's
train and eval CLIs and hold its mAP@50 to a threshold (the counterpart of
scripts/quality_gate.py, whose overfit gate it follows).

The real SelectionNet trains on copies of one synthetic val scene
(`python -m box2mask_torch.train`'s main()) until it overfits, then the
real evaluation runs on that scene (`python -m box2mask_torch.evaluate`'s
main(): the fused pipeline and the ScanNet AP protocol). A regression in the
convs, their gradients, the optimizer, the clustering, the masks or the AP
metric drops the score to ~0 and trips the gate.

Usage: python -m box2mask_torch.quality_gate [--epochs N] [--threshold T]
[--dataset_size N] [--exp_root DIR]. On the card by default;
BOX2MASK_PLATFORM=cpu runs it on the CPU. Prints one JSON line {"map50":
..., "threshold": ..., "pass": ..., ...} and exits non-zero under the
threshold. The JAX gate's held-out variant and its --out artifact are not
ported.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from box2mask_torch import evaluate as eval_cli
from box2mask_torch import train as train_cli
from box2mask_torch.engine.checkpoint import list_checkpoints

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = 'synth10000_00'          # the first val scene

BASE = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
        '--fixed_seed', '10',    # the preset has no augmentation: the
                                 # overfit target is the eval target
        # 2 cm voxels, so that the deep levels hold more than one voxel
        # (scripts/quality_gate.py explains what goes wrong at 5 cm)
        '--voxel_size', '0.02',
        '--vox_bucket', '2048', '--seg_bucket', '128',
        '--layers', '1', '--num_workers', '2',
        '--mlp_bb_scores_start_epoch', '1',
        '--val_every', '1000000', '--eval_every', '1000000',
        '--overfit_to_single_scene_str', SCENE]


def run_gate(epochs, dataset_size):
    """Train, then eval; returns the measured mAP@50."""
    # checkpoints are written at epoch heads (epoch % ckpt_every == 0,
    # before the epoch trains): ckpt_every = epochs - 1 keeps the weights
    # after all but the last epoch, whose head is the last one
    trainer = train_cli.main(BASE + [
        '--dataset_size', str(dataset_size), '--num_epochs', str(epochs),
        '--ckpt_every', str(max(1, epochs - 1)), '--use_lr_scheduler',
        '--lr_scheduler_start_epoch', str(epochs // 4),
        '--lr_scheduler_end_epoch', str(epochs)])
    if not list_checkpoints(trainer.cfg.checkpoint_path):
        raise AssertionError('no checkpoint was written: the eval would '
                             'take the untrained model')
    avgs = eval_cli.main(BASE + ['--dataset_size', str(dataset_size),
                                 '--eval_wo_aug'])
    return float(avgs['all_ap_50%'])


def main(argv=None):
    ap = argparse.ArgumentParser('box2mask_torch.quality_gate')
    ap.add_argument('--epochs', type=int, default=75)
    ap.add_argument('--threshold', type=float, default=0.5)
    ap.add_argument('--dataset_size', type=int, default=32,
                    help='copies of the scene per epoch')
    ap.add_argument('--exp_root', default=None,
                    help='experiment root (default: a temporary directory, '
                         'removed afterwards)')
    a = ap.parse_args(argv)
    owned = a.exp_root is None
    exp_root = tempfile.mkdtemp(prefix='b2m_quality_gate_') if owned \
        else a.exp_root
    saved = os.environ.get('BOX2MASK_EXP_ROOT')
    os.environ['BOX2MASK_EXP_ROOT'] = exp_root
    t0 = time.perf_counter()
    try:
        map50 = run_gate(a.epochs, a.dataset_size)
    finally:
        if saved is None:
            os.environ.pop('BOX2MASK_EXP_ROOT', None)
        else:
            os.environ['BOX2MASK_EXP_ROOT'] = saved
        if owned:
            shutil.rmtree(exp_root, ignore_errors=True)
    ok = map50 == map50 and map50 >= a.threshold
    print(json.dumps({'metric': 'synthetic_overfit_map50', 'map50': map50,
                      'threshold': a.threshold, 'pass': bool(ok),
                      'epochs': a.epochs, 'dataset_size': a.dataset_size,
                      'seconds': time.perf_counter() - t0}))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
