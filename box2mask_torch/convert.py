"""Parameters: flax trees -> the port's state_dict, an optax optimizer state
-> the port's Optimizer state, and a seeded kaiming init.

The port's modules carry the flax names (`stem_conv.kernel`,
`enc1_block0.SparseConv_0.kernel`, `enc1_block0.downsample_bn.mean`,
`mlp_semantics.Linear1x1_2.bias`, ...) and layouts, so a flax path maps to a
state_dict key by joining its parts with '.'. Leaves may be numpy arrays,
array-likes or torch tensors (engine/flax_msgpack.py gives bfloat16 leaves
as torch.bfloat16 tensors).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from box2mask_torch.engine.optim import SLOTS
from box2mask_torch.nn.modules import Linear1x1, SparseConv, SparseConvTranspose


def _flatten(tree, prefix=''):
    for k in tree:
        v = tree[k]
        key = f'{prefix}{k}'
        if hasattr(v, 'keys'):
            yield from _flatten(v, key + '.')
        else:
            yield key, v


def _f32(v):
    if torch.is_tensor(v):
        return v.detach().to('cpu', torch.float32)
    return torch.from_numpy(np.array(v, np.float32))


def from_flax(params, batch_stats):
    """Numpy (or array-like) flax `params` and `batch_stats` trees -> a
    state_dict of f32 CPU tensors, one entry per flax leaf."""
    sd = {}
    for tree in (params, batch_stats):
        for key, v in _flatten(tree):
            if key in sd:
                raise ValueError(f'flax leaf {key} appears twice')
            sd[key] = _f32(v)
    return sd


def _slot_state(tree, slots):
    """The dict of `tree` (a state dict of nested dicts) that holds every
    slot name: depth first, the first one found."""
    if not isinstance(tree, dict):
        return None
    if all(s in tree for s in slots):
        return tree
    for v in tree.values():
        found = _slot_state(v, slots)
        if found is not None:
            return found
    return None


def opt_state_from_flax(opt_state, names, optimizer):
    """An optax `inject_hyperparams(adam | rmsprop | adadelta)` state, as
    its flax state dict (InjectHyperparamsState{count, hyperparams, ...,
    inner_state: {'0': ..., '1': ...}}), -> the port's Optimizer payload
    (engine/optim.py state_dict): `count`, and per slot one f32 array for
    each parameter name of `names` (model.named_parameters() order), taken
    from the slot's flax tree by path. The count is ScaleByAdamState's for
    Adam (its bias correction reads it), else the outer one; the two move
    together."""
    slots = SLOTS[optimizer]
    inner = _slot_state(opt_state.get('inner_state'), slots)
    if inner is None:
        raise ValueError(f'no {optimizer} state ({", ".join(slots)}) in the '
                         'optax state')
    out = {'count': int(np.asarray(inner.get('count', opt_state['count'])))}
    for s in slots:
        leaves = dict(_flatten(inner[s]))
        if set(leaves) != set(names):
            raise ValueError(f'optimizer slot {s}: the flax tree holds '
                             f'{sorted(set(leaves) ^ set(names))[:5]} that '
                             'the model does not, or misses them')
        out[s] = [_f32(leaves[n]).numpy() for n in names]
    return out


def kaiming_init_(model, generator):
    """He-normal with fan_out (K * Cout for convs, Cout for 1x1 layers), as
    box2mask_tpu/nn/modules.py:20 kaiming_fan_out, drawn from `generator`.
    Biases, BN scale/bias and running stats keep their constructor values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (SparseConv, SparseConvTranspose, Linear1x1)):
                w = m.kernel
                fan_out = (w.shape[0] * w.shape[2] if w.dim() == 3
                           else w.shape[-1])
                w.copy_(torch.randn(w.shape, generator=generator)
                        * math.sqrt(2.0 / fan_out))
    return model
