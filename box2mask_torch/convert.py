"""Parameters: flax trees -> the port's state_dict, an optax optimizer state
-> the port's Optimizer state, a seeded kaiming init, and the reference's
(PyTorch + MinkowskiEngine) checkpoints -> flax-layout trees (the port's
jax-free copy of the mapping in scripts/convert_torch_ckpt.py; its entry
point is convert_reference.py).

The port's modules carry the flax names (`stem_conv.kernel`,
`enc1_block0.SparseConv_0.kernel`, `enc1_block0.downsample_bn.mean`,
`mlp_semantics.Linear1x1_2.bias`, ...) and layouts, so a flax path maps to a
state_dict key by joining its parts with '.'. Leaves may be numpy arrays,
array-likes or torch tensors (engine/flax_msgpack.py gives bfloat16 leaves
as torch.bfloat16 tensors).
"""

from __future__ import annotations

import math
import re

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


# --------------------------------------------------------------- permutations
def cubic_perm_me_to_ours(k):
    """perm[i_ours] = i_me for a k^3 kernel: ME enumerates offsets x-fastest,
    ours z-fastest (sparse/coords.py kernel_offsets) — a 3-D index transpose."""
    idx = np.arange(k ** 3).reshape(k, k, k)       # [x][y][z] in OUR order
    # our linear index i_ours = (x*k + y)*k + z; ME's = (z*k + y)*k + x
    # idx.transpose(2,1,0)[x,y,z] == idx[z,y,x] = (z*k+y)*k+x == i_me(x,y,z)
    return np.transpose(idx, (2, 1, 0)).reshape(-1)


def convert_conv_kernel(w, transpose=False):
    """ME (K, Cin, Cout) -> ours (K, Cin, Cout) with offset-order permutation.
    K=1 (1x1) kernels are 2-D matrices in ME and stay as-is."""
    w = np.asarray(w, np.float32)
    if w.ndim == 2:
        return w
    K = w.shape[0]
    k = round(K ** (1 / 3))
    assert k ** 3 == K, f'non-cubic kernel volume {K}'
    perm = cubic_perm_me_to_ours(k)
    return w[perm]


# ------------------------------------------------------------- name mapping
def _block_entry(t_block, t_idx, f_stage):
    """Mapping rows for one BasicBlock: torch '{t_block}.{t_idx}.' prefix ->
    flax '{f_stage}_block{t_idx}' subtree."""
    tp = f'{t_block}.{t_idx}.'
    fp = (f'{f_stage}_block{t_idx}',)
    rows = []
    for t_conv, f_conv in (('conv1', 'SparseConv_0'), ('conv2', 'SparseConv_1')):
        rows.append((tp + t_conv + '.kernel', fp + (f_conv, 'kernel'), 'conv'))
    for t_bn, f_bn in (('norm1', 'MaskedBatchNorm_0'),
                       ('norm2', 'MaskedBatchNorm_1')):
        rows += _bn_rows(tp + t_bn, fp + (f_bn,))
    rows.append((tp + 'downsample.0.kernel', fp + ('downsample_conv', 'kernel'),
                 'conv'))
    rows += _bn_rows(tp + 'downsample.1', fp + ('downsample_bn',))
    return rows


def _bn_rows(t_prefix, f_path):
    return [
        (t_prefix + '.bn.weight', f_path + ('scale',), 'param'),
        (t_prefix + '.bn.bias', f_path + ('bias',), 'param'),
        (t_prefix + '.bn.running_mean', f_path + ('mean',), 'stat'),
        (t_prefix + '.bn.running_var', f_path + ('var',), 'stat'),
    ]


HEAD_NAMES = {   # torch module name -> flax head name (cfg head names)
    'mlp_offsets': 'mlp_offsets', 'mlp_bounds': 'mlp_bounds',
    'mlp_score': 'mlp_bb_scores', 'mlp_center_score': 'mlp_center_scores',
    'mlp_semantics': 'mlp_semantics',
    'mlp_per_vox_semantics': 'mlp_per_vox_semantics',
}


def build_mapping(layers=2):
    """-> list of (torch_key, flax_path_tuple, kind). kind: conv | param | stat.
    flax paths are relative to the params/batch_stats tree root."""
    rows = [('conv0p1s1.kernel', ('stem_conv', 'kernel'), 'conv')]
    rows += _bn_rows('bn0', ('stem_bn',))
    enc = [('conv1p1s2', 'bn1', 'block1', 1), ('conv2p2s2', 'bn2', 'block2', 2),
           ('conv3p4s2', 'bn3', 'block3', 3), ('conv4p8s2', 'bn4', 'block4', 4),
           ('added_conv1p16s2', 'added_bn1', 'added_block1', 5),
           ('added_conv2p32s2', 'added_bn2', 'added_block2', 6),
           ('added_conv3p64s2', 'added_bn3', 'added_block3', 7)]
    for t_conv, t_bn, t_block, lvl in enc:
        rows.append((t_conv + '.kernel', (f'down{lvl}_conv', 'kernel'), 'conv'))
        rows += _bn_rows(t_bn, (f'down{lvl}_bn',))
        for i in range(layers):
            rows += _block_entry(t_block, i, f'enc{lvl}')
    dec = [('added_convtr4p128s2', 'added_bntr4', 'added_block4', 6),
           ('added_convtr5p64s2', 'added_bntr5', 'added_block5', 5),
           ('added_convtr6p32s2', 'added_bntr6', 'added_block6', 4),
           ('convtr4p16s2', 'bntr4', 'block5', 3),
           ('convtr5p8s2', 'bntr5', 'block6', 2),
           ('convtr6p4s2', 'bntr6', 'block7', 1),
           ('convtr7p2s2', 'bntr7', 'block8', 0)]
    for t_conv, t_bn, t_block, lvl in dec:
        rows.append((t_conv + '.kernel', (f'up{lvl}_tr', 'kernel'), 'conv'))
        rows += _bn_rows(t_bn, (f'up{lvl}_bn',))
        for i in range(layers):
            rows += _block_entry(t_block, i, f'dec{lvl}')
    for t_head, f_head in HEAD_NAMES.items():
        for seq_idx, f_lin in ((0, 'Linear1x1_0'), (3, 'Linear1x1_1'),
                               (6, 'Linear1x1_2')):
            rows.append((f'{t_head}.{seq_idx}.kernel',
                         (f_head, f_lin, 'kernel'), 'conv'))
            rows.append((f'{t_head}.{seq_idx}.bias',
                         (f_head, f_lin, 'bias'), 'param'))
        for seq_idx, f_bn in ((2, 'MaskedBatchNorm_0'),
                              (5, 'MaskedBatchNorm_1')):
            rows += _bn_rows(f'{t_head}.{seq_idx}', (f_head, f_bn))
    return rows


# ------------------------------------------------------------------- convert
def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_state_dict(sd, layers=2, strict=False):
    """torch-format state_dict (str -> array) -> (params, batch_stats) nested
    dicts in the flax layout, for from_flax. Unmatched torch keys (unused
    heads final*, num_batches_tracked, heads absent from the model) are
    reported, not fatal."""
    sd = {re.sub(r'^module\.', '', k): np.asarray(v) for k, v in sd.items()}
    params, stats = {}, {}
    used = set()
    for t_key, f_path, kind in build_mapping(layers):
        if t_key not in sd:
            continue
        v = np.asarray(sd[t_key], np.float32)
        if kind == 'conv':
            v = convert_conv_kernel(v)
        if kind == 'stat':
            _set(stats, f_path, v)
        else:
            _set(params, f_path, v)
        used.add(t_key)
    leftover = [k for k in sd if k not in used
                and not k.endswith('num_batches_tracked')
                and not k.startswith('final')]
    if leftover:
        msg = f'{len(leftover)} torch keys had no flax target: {leftover[:10]}'
        if strict:
            raise ValueError(msg)
        print('NOTE:', msg)
    dropped = [k for k in sd if k.startswith('final')]
    if dropped:
        print(f'Dropped {len(dropped)} --load_unused_head back-compat keys '
              '(final*): dead weights in the reference too')
    return params, stats


def load_torch_tar(path):
    """The reference's checkpoint file -> (state_dict as numpy, payload).
    The payload is a pickled dict holding more than tensors, so it is read
    with torch.load(weights_only=False) (the default before torch 2.6):
    that runs the pickle's code, so load only a checkpoint you trust."""
    payload = torch.load(path, map_location='cpu', weights_only=False)
    sd = payload.get('model_state_dict', payload)
    return ({k: v.detach().numpy() for k, v in sd.items()},
            payload if isinstance(payload, dict) else {})


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
