"""Checkpoint save/load with training-time-encoded file names (port of
box2mask_tpu/engine/checkpoint.py:27-121; same naming, selection and
`val_min` marker semantics):

  * the file name encodes cumulative training seconds:
    ``checkpoint_{H}h:{M}m:{S}s_{float}.ckpt``,
  * the payload carries {training_time, epoch, iteration_num} and the
    model and optimizer state,
  * "latest" = the largest trailing float; ``closest_to`` selects the
    checkpoint nearest N hours of training,
  * ``val_min={loss}`` marker files track the best validation loss.

The payload is one pickle container, as in the JAX package, holding numpy
copies of the port's state: `params` and `batch_stats` are the model's
parameters and BN buffers by state_dict name, `opt_state` the optimizer's
moments (engine/optim.py state_dict). A flax checkpoint is not read here
(ROADMAP A16). Unpickling runs code: load only checkpoints this program wrote.
"""

from __future__ import annotations

import glob
import os
import pickle

import numpy as np
import torch


def convert_secs(sec):
    return int(sec // 3600), int((sec // 60) % 60), int(sec % 60)


def checkpoint_name(training_time):
    h, m, s = convert_secs(training_time)
    return f'checkpoint_{h}h:{m}m:{s}s_{training_time}.ckpt'


def _split_state(model):
    names = {n for n, _ in model.named_parameters()}
    params, stats = {}, {}
    for k, v in model.state_dict().items():
        (params if k in names else stats)[k] = v.detach().cpu().numpy()
    return params, stats


def save_checkpoint(path_dir, state, training_time, epoch, iteration_num):
    os.makedirs(path_dir, exist_ok=True)
    params, stats = _split_state(state.model)
    payload = {
        'training_time': float(training_time),
        'epoch': int(epoch),
        'iteration_num': int(iteration_num),
        'step': int(state.step),
        'params': params,
        'batch_stats': stats,
        'opt_state': state.tx.state_dict(state.opt_state),
    }
    path = os.path.join(path_dir, checkpoint_name(training_time))
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    return path


def list_checkpoints(path_dir):
    """Sorted (time_float, path) pairs."""
    out = []
    for p in glob.glob(os.path.join(path_dir, 'checkpoint_*.ckpt')):
        try:
            t = float(os.path.splitext(os.path.basename(p))[0].split('_')[-1])
            out.append((t, p))
        except ValueError:
            continue
    return sorted(out)


def find_checkpoint(path_dir, checkpoint=None, closest_to=None):
    """Explicit name > closest-to-N-hours > latest. None if dir is empty."""
    if checkpoint is not None:
        path = os.path.join(path_dir, checkpoint)
        if not path.endswith('.ckpt'):
            path += '.ckpt'
        return path
    ckpts = list_checkpoints(path_dir)
    if not ckpts:
        return None
    if closest_to is not None:
        times = np.array([t for t, _ in ckpts])
        return ckpts[int(np.argmin(np.abs(times - closest_to * 3600)))][1]
    return ckpts[-1][1]


def load_checkpoint(path, state, strict=True):
    """Restore the model and optimizer state into `state` in place.
    Returns (state, epoch, training_time, iteration_num, name). With
    strict=False a part that does not fit is skipped with a warning (the
    JAX package's loose loading)."""
    with open(path, 'rb') as f:
        payload = pickle.load(f)
    sd = {k: torch.from_numpy(np.asarray(v)) for part in ('params',
                                                          'batch_stats')
          for k, v in payload[part].items()}
    try:
        state.model.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        if strict:
            raise
        print(f'Warning: loose checkpoint loading skipped the model: {e}')
    try:
        state.tx.load_state_dict(state.opt_state, payload['opt_state'])
        state.step = int(payload['step'])
    except (KeyError, ValueError, RuntimeError) as e:
        if strict:
            raise
        print(f'Warning: loose checkpoint loading skipped the optimizer: {e}')
    name = os.path.splitext(os.path.basename(path))[0]
    return (state, payload['epoch'], payload['training_time'],
            payload['iteration_num'], name)


def write_val_min_marker(exp_path, val_loss):
    """Best-val marker files `val_min={loss}`."""
    for f in glob.glob(os.path.join(exp_path, 'val_min=*')):
        os.remove(f)
    open(os.path.join(exp_path, f'val_min={val_loss}'), 'w').close()


def read_val_min(exp_path):
    files = glob.glob(os.path.join(exp_path, 'val_min=*'))
    if not files:
        return float('inf')
    return float(os.path.basename(files[0]).split('=')[1])
