"""Box2Mask's detection network in plain PyTorch: the parameters, the
forward, the losses and Adam.

The network (Box2Mask, Chibane et al., ECCV 2022; a sparse voxel U-Net):
  stem 5^3 conv -> 32, BN, ReLU;
  7 encoder stages: stride-2 2^3 conv, BN, ReLU, `layers` residual blocks
    (widths 32, 64, 128, 256, 256, 256, 256);
  7 decoder stages: stride-2 transpose conv, BN, ReLU, concatenation with
    the encoder's output of that level, `layers` residual blocks (widths
    256, 256, 256, 256, 128, 96, 96);
  a residual block: conv3 BN ReLU conv3 BN, plus the input (through a 1x1
    linear layer and BN where the width changes), ReLU;
  mean pooling of the 96-d voxel features over each oversegment;
  per head Linear ReLU BN Linear ReLU BN Linear (hidden 96).
Batch norm in training normalises with the batch's moments over the real
rows (biased variance, eps 1e-5); in evaluation with the stored mean and
variance. Parameter names and layouts are those of the program's state
dict: a conv kernel is (K, Cin, Cout) with kernel slots in x-major offset
order, a linear layer (Cin, Cout) plus a bias.

Every product goes through `numerics.q` (the identity for the reference);
a conv gathers its input rows per kernel slot from the tables of
`geometry` and keeps only its input for the backward.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

INIT_DIM = 32
ENC_PLANES = (32, 64, 128, 256, 256, 256, 256)
DEC_PLANES = (256, 256, 256, 256, 128, 96, 96)
HEAD_DIMS = {'mlp_offsets': 3, 'mlp_bounds': 3, 'mlp_bb_scores': 1}
HEAD_OUT = 'Linear1x1_2'          # a head's output layer
BN_EPS = 1e-5


def param_specs(num_classes, in_channels, heads, layers):
    """[(name, shape, init)]: init 'conv' / 'linear' (He normal over the
    fan-out), 'one', 'zero'; BN's stored mean ('zero') and variance
    ('one') included."""
    specs = []

    def bn(p, c):
        specs.extend([(f'{p}.scale', (c,), 'one'), (f'{p}.bias', (c,), 'zero'),
                      (f'{p}.mean', (c,), 'zero'), (f'{p}.var', (c,), 'one')])

    def block(p, cin, planes):
        specs.append((f'{p}.SparseConv_0.kernel', (27, cin, planes), 'conv'))
        bn(f'{p}.MaskedBatchNorm_0', planes)
        specs.append((f'{p}.SparseConv_1.kernel', (27, planes, planes),
                      'conv'))
        bn(f'{p}.MaskedBatchNorm_1', planes)
        if cin != planes:
            specs.append((f'{p}.downsample_conv.kernel', (cin, planes),
                          'linear'))
            bn(f'{p}.downsample_bn', planes)

    specs.append(('stem_conv.kernel', (125, in_channels, INIT_DIM), 'conv'))
    bn('stem_bn', INIT_DIM)
    c, skip = INIT_DIM, [INIT_DIM]
    for l in range(1, 8):
        specs.append((f'down{l}_conv.kernel', (8, c, c), 'conv'))
        bn(f'down{l}_bn', c)
        for i in range(layers):
            block(f'enc{l}_block{i}', c if i == 0 else ENC_PLANES[l - 1],
                  ENC_PLANES[l - 1])
        c = ENC_PLANES[l - 1]
        skip.append(c)
    for i, l in enumerate(range(6, -1, -1)):
        planes = DEC_PLANES[i]
        specs.append((f'up{l}_tr.kernel', (8, c, planes), 'conv'))
        bn(f'up{l}_bn', planes)
        for j in range(layers):
            block(f'dec{l}_block{j}', planes + skip[l] if j == 0 else planes,
                  planes)
        c = planes
    for h in heads:
        out = HEAD_DIMS.get(h, num_classes)
        for k, (ci, co) in enumerate(((c, 96), (96, 96), (96, out))):
            specs.append((f'{h}.Linear1x1_{k}.kernel', (ci, co), 'linear'))
            specs.append((f'{h}.Linear1x1_{k}.bias', (co,), 'zero'))
            if k < 2:
                bn(f'{h}.MaskedBatchNorm_{k}', 96)
    return specs


def output_leaves(heads):
    """The leaves of the heads' output layers, which the loss's gradient
    reaches through no other layer."""
    return [f'{h}.{HEAD_OUT}.{p}' for h in heads for p in ('kernel', 'bias')]


def init_std(shape, init):
    fan_out = shape[0] * shape[2] if init == 'conv' else shape[-1]
    return math.sqrt(2.0 / fan_out)


def is_trained(name):
    """Parameters the optimiser moves (BN's stored statistics are not)."""
    return not (name.endswith('.mean') or name.endswith('.var'))


# ------------------------------------------------------------------ products
class _QMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, q):
        ctx.q = q
        ctx.save_for_backward(a, b)
        return q(a) @ q(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        q = ctx.q
        gq = q(g)
        return gq @ q(b).T, q(a).T @ gq, None


class _GatherConv(torch.autograd.Function):
    """out[v] = sum_k x[nbr[v, k]] @ w[k] over the slots with nbr >= 0."""

    @staticmethod
    def forward(ctx, x, nbr, w, q):
        ctx.q = q
        ctx.save_for_backward(x, nbr, w)
        xp = torch.cat([q(x), x.new_zeros(1, x.shape[1])])
        wq = q(w)
        idx = torch.where(nbr < 0, x.shape[0], nbr)
        out = x.new_zeros(nbr.shape[0], w.shape[2])
        for k in range(w.shape[0]):
            out += xp[idx[:, k]] @ wq[k]
        return out

    @staticmethod
    def backward(ctx, g):
        x, nbr, w = ctx.saved_tensors
        q = ctx.q
        xp = torch.cat([q(x), x.new_zeros(1, x.shape[1])])
        wq, gq = q(w), q(g)
        idx = torch.where(nbr < 0, x.shape[0], nbr)
        dx = x.new_zeros(x.shape[0] + 1, x.shape[1])
        dw = torch.empty_like(w)
        for k in range(w.shape[0]):
            dw[k] = xp[idx[:, k]].T @ gq
            dx.index_add_(0, idx[:, k], gq @ wq[k].T)
        return dx[:-1], None, dw, None


class Net:
    """The forward over one batch's geometry (`geometry.build`)."""

    def __init__(self, params, heads, layers, numerics, train=False,
                 remat=False):
        self.p, self.heads, self.layers = params, tuple(heads), layers
        self.q = numerics.q
        self.train, self.remat = train, remat

    def conv(self, name, x, nbr):
        return _GatherConv.apply(x, nbr, self.p[name + '.kernel'], self.q)

    def linear(self, name, x):
        out = _QMatmul.apply(x, self.p[name + '.kernel'], self.q)
        b = self.p.get(name + '.bias')
        return out if b is None else out + b

    def bn(self, name, x):
        if self.train:
            mean = x.mean(0)
            var = (x - mean).square().mean(0)
        else:
            mean, var = self.p[name + '.mean'], self.p[name + '.var']
        inv = torch.rsqrt(var + BN_EPS)
        return ((x - mean) * inv * self.p[name + '.scale']
                + self.p[name + '.bias'])

    def block(self, name, x, nbr):
        out = torch.relu(self.bn(f'{name}.MaskedBatchNorm_0',
                                 self.conv(f'{name}.SparseConv_0', x, nbr)))
        out = self.bn(f'{name}.MaskedBatchNorm_1',
                      self.conv(f'{name}.SparseConv_1', out, nbr))
        res = x
        if f'{name}.downsample_conv.kernel' in self.p:
            res = self.bn(f'{name}.downsample_bn',
                          self.linear(f'{name}.downsample_conv', x))
        return torch.relu(out + res)

    def stage(self, prefix, x, nbr):
        for i in range(self.layers):
            name = f'{prefix}_block{i}'
            if self.remat and self.train:
                x = checkpoint(lambda t, n=name: self.block(n, t, nbr), x,
                               use_reentrant=False)
            else:
                x = self.block(name, x, nbr)
        return x

    def __call__(self, geo, feats, pool, n_seg):
        """Head outputs per segment: {head: (n_seg, dim)}."""
        x = torch.relu(self.bn('stem_bn', self.conv('stem_conv', feats,
                                                    geo['nbr5'])))
        skips = [x]
        for l in range(1, 8):
            x = self.bn(f'down{l}_bn', self.conv(f'down{l}_conv', x,
                                                 geo['down'][l - 1]))
            x = self.stage(f'enc{l}', torch.relu(x), geo['nbr3'][l])
            skips.append(x)
        for l in range(6, -1, -1):
            x = self.bn(f'up{l}_bn', self.conv(f'up{l}_tr', x, geo['up'][l]))
            x = torch.cat([torch.relu(x), skips[l]], 1)
            x = self.stage(f'dec{l}', x, geo['nbr3'][l])
        pooled = x.new_zeros(n_seg, x.shape[1]).index_add_(0, pool, x)
        cnt = torch.bincount(pool, minlength=n_seg).clamp(min=1)
        pooled = pooled / cnt[:, None].to(x.dtype)
        out = {}
        for h in self.heads:
            t = torch.relu(self.linear(f'{h}.Linear1x1_0', pooled))
            t = self.bn(f'{h}.MaskedBatchNorm_0', t)
            t = torch.relu(self.linear(f'{h}.Linear1x1_1', t))
            t = self.bn(f'{h}.MaskedBatchNorm_1', t)
            out[h] = self.linear(f'{h}.{HEAD_OUT}', t)
        return out


# -------------------------------------------------------------------- losses
def _masked_mean(x, m):
    m = m.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def _aabb_iou(a, b, eps=1e-6):
    inter = (torch.minimum(a[:, 3:], b[:, 3:])
             - torch.maximum(a[:, :3], b[:, :3])).clamp(min=0).prod(1)
    va = (a[:, 3:] - a[:, :3]).prod(1)
    vb = (b[:, 3:] - b[:, :3]).prod(1)
    return inter / (va + vb - inter + eps)


def losses(pred, tgt, w):
    """The optimisation loss of Box2Mask's box supervision over the
    segments: masked L1 of the centre offsets and of the box half-sizes
    over foreground segments; binary cross-entropy of the box score
    against the (detached) IoU of the predicted and the target box; the
    cross-entropy of the semantics, ignore label -100. `w` holds the loss
    weights and `min_bb_size`."""
    fg = tgt['fg']
    loc, off_t, bnd_t = tgt['loc'], tgt['offsets'], tgt['bounds']
    off_l1 = (pred['mlp_offsets'] - off_t).abs().sum(1)
    loss = w['offsets'] * _masked_mean(off_l1, fg)
    loss = loss + w['bounds'] * _masked_mean(
        (pred['mlp_bounds'] - bnd_t).abs().sum(1), fg)
    s = pred['mlp_bb_scores'][:, 0]
    pb = pred['mlp_bounds'].clamp(min=w['min_bb_size'])
    centre = pred['mlp_offsets'] + loc
    pr = torch.cat([centre - pb, centre + pb], 1)
    gc = off_t + loc
    gt = torch.cat([gc - bnd_t, gc + bnd_t], 1)
    target = _aabb_iou(gt, pr).detach()
    bce = s.clamp(min=0) - s * target + torch.log1p(torch.exp(-s.abs()))
    loss = loss + w['bb_scores'] * _masked_mean(bce, fg)
    labels = tgt['sem_idx']
    ok = labels >= 0
    logp = torch.log_softmax(pred['mlp_semantics'], 1)
    nll = -logp.gather(1, labels.clamp(min=0)[:, None])[:, 0]
    return loss + w['semantics'] * _masked_mean(nll, ok)


# ---------------------------------------------------------------------- Adam
class Adam:
    """Adam with the optax defaults (b1 0.9, b2 0.999, eps 1e-8, no decay)."""

    def __init__(self, params, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps, self.t = b1, b2, eps, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads, lr):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.mu[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps)
            params[k].sub_(lr * u)
