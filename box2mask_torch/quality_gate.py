"""Quality gate of the port: overfit one synthetic scene through the port's
train and eval CLIs and hold its mAP@50 to a threshold; with --held_out,
also train on the synthetic train split and hold the mAP@50 of 4 unseen
val scenes to a looser one (the counterpart of scripts/quality_gate.py).

The overfit gate: the real SelectionNet trains on copies of one synthetic
val scene (`python -m box2mask_torch.train`'s main()) until it overfits,
then the real evaluation runs on that scene (`python -m
box2mask_torch.evaluate`'s main(): the fused pipeline and the ScanNet AP
protocol). A regression in the convs, their gradients, the optimizer, the
clustering, the masks or the AP metric drops the score to ~0 and trips it.
The held-out gate trains on train scenes 0 .. --held_out_scenes - 1 and
evaluates val scenes 10000-10003, for what only hurts generalization (BN,
augmentation, association), which the overfit gate cannot see. Its bar,
the JAX gate's 0.3, is out of reach on these scenes: the generator draws
each instance's class independently of everything the net sees, and
perfect masks with guessed classes score under 0.1 (ROADMAP section C).

Usage: python -m box2mask_torch.quality_gate [--epochs N] [--threshold T]
[--dataset_size N] [--held_out | --held_out_only] [--held_out_epochs N]
[--held_out_scenes N] [--held_out_threshold T] [--out FILE]
[--exp_root DIR]. On the card by default; BOX2MASK_PLATFORM=cpu runs it on
the CPU. Prints one JSON record (the JAX gate's fields, with `seconds` and
`dataset_size`) and exits non-zero when a gate fails. --out also writes it
with `git_sha` and `recorded`; --held_out_only runs the held-out gate alone
and merges it into the overfit record a prior run wrote there. Without
such a record it fails: the JAX gate counts the missing overfit result as
passed there (ROADMAP section C).
"""

import argparse
import json
import os
import shutil
import subprocess
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
        '--val_every', '1000000', '--eval_every', '1000000']


HELD_OUT_EVAL_SCENES = 4


def gate_args(epochs, dataset_size, held_out=False):
    """(train argv, eval argv) of a gate. The overfit gate trains on
    `dataset_size` copies of SCENE and evaluates them; the held-out gate
    trains on the first `dataset_size` train scenes and evaluates the
    first HELD_OUT_EVAL_SCENES val scenes."""
    base = BASE if held_out else BASE + ['--overfit_to_single_scene_str',
                                         SCENE]
    # checkpoints are written at epoch heads (epoch % ckpt_every == 0,
    # before the epoch trains): ckpt_every = epochs - 1 keeps the weights
    # after all but the last epoch, whose head is the last one
    train = base + [
        '--dataset_size', str(dataset_size), '--num_epochs', str(epochs),
        '--ckpt_every', str(max(1, epochs - 1)), '--use_lr_scheduler',
        '--lr_scheduler_start_epoch', str(epochs // 4),
        '--lr_scheduler_end_epoch', str(epochs)]
    evaluate = base + ['--dataset_size', str(
        HELD_OUT_EVAL_SCENES if held_out else dataset_size), '--eval_wo_aug']
    return train, evaluate


def run_gate(epochs, dataset_size, held_out=False):
    """Train, then eval; returns the measured mAP@50."""
    train, evaluate = gate_args(epochs, dataset_size, held_out)
    trainer = train_cli.main(train)
    if not list_checkpoints(trainer.cfg.checkpoint_path):
        raise AssertionError('no checkpoint was written: the eval would '
                             'take the untrained model')
    return float(eval_cli.main(evaluate)['all_ap_50%'])


def in_exp_root(exp_root, fn, *args):
    """fn(*args) with its experiments under exp_root (a temporary directory,
    removed afterwards, when None)."""
    owned = exp_root is None
    root = tempfile.mkdtemp(prefix='b2m_quality_gate_') if owned else exp_root
    saved = os.environ.get('BOX2MASK_EXP_ROOT')
    os.environ['BOX2MASK_EXP_ROOT'] = root
    try:
        return fn(*args)
    finally:
        if saved is None:
            os.environ.pop('BOX2MASK_EXP_ROOT', None)
        else:
            os.environ['BOX2MASK_EXP_ROOT'] = saved
        if owned:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser('box2mask_torch.quality_gate')
    ap.add_argument('--epochs', type=int, default=75)
    ap.add_argument('--threshold', type=float, default=0.5)
    ap.add_argument('--dataset_size', type=int, default=32,
                    help='copies of the scene per epoch')
    ap.add_argument('--held_out', action='store_true',
                    help='also run the held-out gate: train on the synthetic '
                         'train split, eval 4 unseen val scenes')
    ap.add_argument('--held_out_only', action='store_true',
                    help='run only the held-out gate and merge its fields '
                         'into the overfit record of a prior --out run')
    ap.add_argument('--held_out_epochs', type=int, default=150)
    ap.add_argument('--held_out_scenes', type=int, default=16)
    ap.add_argument('--held_out_threshold', type=float, default=0.3)
    ap.add_argument('--out', default=None,
                    help='also write the record (with the git SHA) here')
    ap.add_argument('--exp_root', default=None,
                    help='experiment root (default: a temporary directory, '
                         'removed afterwards)')
    a = ap.parse_args(argv)
    out = (a.out if a.out is None or os.path.isabs(a.out)
           else os.path.join(ROOT, a.out))
    t0 = time.perf_counter()
    if a.held_out_only:
        if out and os.path.exists(out):
            with open(out) as f:
                rec = json.load(f)
            ok = bool(rec.get('pass', False))
        else:           # no overfit result: the gate has not passed
            rec = {'metric': 'synthetic_overfit_map50', 'pass': False}
            ok = False
    else:
        map50 = in_exp_root(a.exp_root, run_gate, a.epochs, a.dataset_size)
        ok = map50 == map50 and map50 >= a.threshold
        rec = {'metric': 'synthetic_overfit_map50', 'map50': map50,
               'threshold': a.threshold, 'pass': bool(ok),
               'epochs': a.epochs, 'dataset_size': a.dataset_size}
    if a.held_out or a.held_out_only:
        # its own experiment: the overfit run's checkpoints would resume
        ho = in_exp_root(a.exp_root and os.path.join(a.exp_root, 'held_out'),
                         run_gate, a.held_out_epochs, a.held_out_scenes, True)
        ho_ok = ho == ho and ho >= a.held_out_threshold
        ok = ok and ho_ok
        rec.update({'held_out_map50': ho,
                    'held_out_threshold': a.held_out_threshold,
                    'held_out_train_scenes': a.held_out_scenes,
                    'held_out_eval_scenes': HELD_OUT_EVAL_SCENES,
                    'held_out_epochs': a.held_out_epochs,
                    'held_out_pass': bool(ho_ok), 'pass': bool(ok)})
    rec['seconds'] = time.perf_counter() - t0
    if out:
        rec['git_sha'] = subprocess.run(
            ['git', 'rev-parse', 'HEAD'], cwd=ROOT, capture_output=True,
            text=True).stdout.strip()
        rec['recorded'] = time.strftime('%Y-%m-%d %H:%M:%S')
        with open(out, 'w') as f:
            json.dump(rec, f, indent=1)
            f.write('\n')
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
