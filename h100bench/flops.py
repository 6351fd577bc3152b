"""Operations and bytes of the network's convolutions on one batch, from
the batch's keys, in NumPy: the arithmetic behind `key_conv_roofline.*`
and `mfu.*`.

A conv's operations are 2 x its matched (output row, kernel slot) pairs x
Cin x Cout: only pairs whose input cell exists count, not every slot. Same-
level convs count their pairs by looking every row's neighbours up among
the level's keys; each fine row of a stride-2 conv has exactly one parent,
so a down or up conv has as many pairs as the fine level has rows. A
launch's bytes count each input once and each output once: the operands
as the kernel reads them (bf16 activations and weights; the stem reads its
f32 data and writes f32), the key rows, and the output in the activation
dtype (dw: f32). A launch's bound is the larger of operations over the
chip's peak FLOP/s and bytes over its memory bandwidth.

The topology is a frozen copy of the program's: stem 5^3 -> 32; 7 x (down
2^3 + `layers` residual blocks) of widths ENC; 7 x (up 2^3 + blocks) of
widths DEC; segment pooling; per head 3 linear layers (hidden 96).
"""

from __future__ import annotations

import itertools

import numpy as np

INIT_DIM = 32
ENC = (32, 64, 128, 256, 256, 256, 256)
DEC = (256, 256, 256, 256, 128, 96, 96)
HEAD_OUT = {'mlp_offsets': 3, 'mlp_bounds': 3, 'mlp_bb_scores': 1}
SENT_KEY = 1 << 30
AXIS_BITS = 10
NUM_LEVELS = 8


def _cells(keys, level):
    k = keys[keys < SENT_KEY].astype(np.int64)
    c = np.stack([k >> 2 * AXIS_BITS, (k >> AXIS_BITS) & 1023, k & 1023], 1)
    return c >> level


def _pack(c):
    return (c[..., 0] << 2 * AXIS_BITS) | (c[..., 1] << AXIS_BITS) | c[..., 2]


def _pairs(cells, ksize):
    """Matched (row, slot) pairs of a same-level conv of kernel `ksize`."""
    h = ksize // 2
    offs = np.array(list(itertools.product(range(-h, h + 1), repeat=3)))
    packed = np.sort(_pack(cells))
    total = 0
    for o in offs:
        q = cells + o
        ok = ((q >= 0) & (q < 1024)).all(1)
        qk = _pack(q[ok])
        pos = np.clip(np.searchsorted(packed, qk), 0, len(packed) - 1)
        total += int((packed[pos] == qk).sum())
    return total


def batch_counts(dev_np):
    """Rows per level, matched pairs of the 3^3 convs per level and of the
    5^3 stem, over the scenes of one batch (`keys{l}_b` of the batch)."""
    B = dev_np['keys0_b'].shape[0]
    rows = [0] * NUM_LEVELS
    same = [0] * NUM_LEVELS
    stem = 0
    for b in range(B):
        for l in range(NUM_LEVELS):
            c = _cells(np.asarray(dev_np[f'keys{l}_b'][b]), l)
            rows[l] += len(c)
            same[l] += _pairs(c, 3)
            if l == 0:
                stem += _pairs(c, 5)
    return {'rows': rows, 'same': same, 'stem': stem,
            'segments': int(dev_np['num_segments'])}


def conv_sites(counts, model):
    """Every conv and linear site of one forward: dicts of kind ('stem',
    'same', 'down', 'up', 'linear', 'head'), pairs (rows for a linear),
    n_in, n_out, cin, cout, K."""
    rows, same = counts['rows'], counts['same']
    sites = [dict(kind='stem', pairs=counts['stem'], n_in=rows[0],
                  n_out=rows[0], cin=model['in_channels'], cout=INIT_DIM,
                  K=125)]

    def blocks(level, cin, planes):
        for i in range(model['layers']):
            ci = cin if i == 0 else planes
            sites.append(dict(kind='same', pairs=same[level], n_in=rows[level],
                              n_out=rows[level], cin=ci, cout=planes, K=27))
            sites.append(dict(kind='same', pairs=same[level], n_in=rows[level],
                              n_out=rows[level], cin=planes, cout=planes,
                              K=27))
            if ci != planes:
                sites.append(dict(kind='linear', pairs=rows[level],
                                  n_in=rows[level], n_out=rows[level],
                                  cin=ci, cout=planes, K=1))

    c, skip = INIT_DIM, [INIT_DIM]
    for l in range(1, 8):
        sites.append(dict(kind='down', pairs=rows[l - 1], n_in=rows[l - 1],
                          n_out=rows[l], cin=c, cout=c, K=8))
        blocks(l, c, ENC[l - 1])
        c = ENC[l - 1]
        skip.append(c)
    for i, l in enumerate(range(6, -1, -1)):
        planes = DEC[i]
        sites.append(dict(kind='up', pairs=rows[l], n_in=rows[l + 1],
                          n_out=rows[l], cin=c, cout=planes, K=8))
        blocks(l, planes + skip[l], planes)
        c = planes
    n = counts['segments']
    for h in model['heads']:
        out = HEAD_OUT.get(h, len(model['classes']))
        for ci, co in ((c, 96), (96, 96), (96, out)):
            sites.append(dict(kind='head', pairs=n, n_in=n, n_out=n, cin=ci,
                              cout=co, K=1))
    return sites


def site_flops(s):
    return 2 * s['pairs'] * s['cin'] * s['cout']


def forward_flops(sites):
    return sum(site_flops(s) for s in sites)


def train_flops(sites):
    """Forward, input gradient (none for the stem, whose input is data)
    and weight gradient of every site."""
    fwd = forward_flops(sites)
    stem = sum(site_flops(s) for s in sites if s['kind'] == 'stem')
    return fwd + (fwd - stem) + fwd


def key_conv_launches(sites, act_bytes, train):
    """(flops, bytes) of every key-conv kernel launch of one forward, or of
    one train step (forward, dx, dw, stem dw)."""
    out = []
    for s in sites:
        if s['kind'] in ('linear', 'head'):
            continue
        f = site_flops(s)
        keys = 4 * (s['n_in'] + s['n_out'])
        w = 2 * s['K'] * s['cin'] * s['cout']
        stem = s['kind'] == 'stem'
        x_b = 4 if stem else 2
        out_b = 4 if stem else act_bytes
        out.append((f, x_b * s['n_in'] * s['cin'] + w + keys
                    + out_b * s['n_out'] * s['cout']))
        if not train:
            continue
        g_b = 4 if stem else 2
        if not stem:            # dx: the cotangent in, dx out
            out.append((f, g_b * s['n_out'] * s['cout'] + w + keys
                        + act_bytes * s['n_in'] * s['cin']))
        out.append((f, 2 * s['n_in'] * s['cin'] + g_b * s['n_out'] * s['cout']
                    + keys + 4 * s['K'] * s['cin'] * s['cout']))
    return out


def bound_s(launches, peak_flop_s, peak_bytes_s):
    return sum(max(f / peak_flop_s, b / peak_bytes_s) for f, b in launches)
