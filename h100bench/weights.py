"""Seeded weights of the network, made on the device in one call: He-normal
conv and linear kernels over their fan-out, BN scale 1 and bias 0, stored
mean 0 and variance 1, biases 0. The program and the reference get the
same tensors."""

from __future__ import annotations

import math

import torch

from h100bench.reference.net import init_std, param_specs
from h100bench.reference.targets import is_foreground


def background_bias(params, config, value):
    """The semantics head's output bias set to `value` on the classes the
    configuration's foreground rule rejects (in place). With seeded random
    weights the class a segment's logits pick varies with the seed, and so
    does whether a room's segments count as foreground and how long the
    post-processing's loops run; a large negative `value` makes every
    segment foreground on every seed."""
    fg = is_foreground(config['classes']['valid_ids'],
                       config['classes']['foreground'])
    b = params['mlp_semantics.Linear1x1_2.bias']
    b[torch.as_tensor(~fg, device=b.device)] = value


def specs(config):
    m = config['model']
    return param_specs(len(config['classes']['valid_ids']),
                       m['in_channels'], m['heads'], m['layers'])


def make(config, seed, device):
    sp = specs(config)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    drawn = [(n, s, i) for n, s, i in sp if i in ('conv', 'linear')]
    flat = torch.randn(sum(math.prod(s) for _, s, _ in drawn), generator=g,
                       device=device)
    out, off = {}, 0
    for name, shape, init in sp:
        if init in ('conv', 'linear'):
            k = math.prod(shape)
            out[name] = flat[off:off + k].view(shape) * init_std(shape, init)
            off += k
        elif init == 'one':
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
