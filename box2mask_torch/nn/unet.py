"""SelectionNet: the 7-down/7-up sparse voxel U-Net with per-oversegment voting
heads (port of box2mask_tpu/nn/unet.py:37-221; same topology, skip order and
parameter names).

  * stem 5^3 conv -> 32 ch at stride 1,
  * 7 encoder stages (stride-2 2^3 conv + BN + ReLU + `layers` BasicBlocks)
    with block widths (32, 64, 128, 256, 256, 256, 256),
  * 7 decoder stages (stride-2 transpose conv + BN + ReLU + skip concat +
    blocks) with widths (256, 256, 256, 256, 128, 96, 96),
  * per-oversegment mean (or max) pooling of the 96-d voxel features,
  * head MLPs (Linear-ReLU-BN x2 + Linear) per configured head.

The forward consumes the batch dict of datasets/batching.py after
engine/state.ensure_maps (per-level keys, valid masks and counts). In
training mode BN normalizes with batch moments and moves its running
statistics; with `remat`, the BasicBlocks of levels <= `remat_max_level`
are rematerialized in the backward (torch.utils.checkpoint, the JAX
package's nn.remat at unet.py:134-146), and their BN statistics move once.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from box2mask_torch.nn.modules import (BasicBlock, Linear1x1, MaskedBatchNorm,
                                       SparseConv, SparseConvTranspose)
from box2mask_torch.sparse import ops

INIT_DIM = 32
ENC_PLANES = (32, 64, 128, 256, 256, 256, 256)      # blocks at levels 1..7
DEC_PLANES = (256, 256, 256, 256, 128, 96, 96)      # tr-conv/block out, levels 6..0
OUT_DIM = 96
HEAD_DIMS = {'mlp_offsets': 3, 'mlp_bounds': 3, 'mlp_bb_scores': 1,
             'mlp_center_scores': 1}


class HeadMLP(nn.Module):
    """3-layer 1x1-conv MLP head; hidden activations ride act_dtype, the
    output stays f32."""

    def __init__(self, cin, out_dim, hidden=96, compute_dtype=torch.bfloat16,
                 act_dtype=torch.float32):
        super().__init__()
        cd, ad = compute_dtype, act_dtype
        self.Linear1x1_0 = Linear1x1(cin, hidden, compute_dtype=cd)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(hidden, act_dtype=ad)
        self.Linear1x1_1 = Linear1x1(hidden, hidden, compute_dtype=cd)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(hidden, act_dtype=ad)
        self.Linear1x1_2 = Linear1x1(hidden, out_dim, compute_dtype=cd)
        self.act_dtype = ad

    def forward(self, x, valid, n_valid):
        ad = self.act_dtype
        h = torch.relu(self.Linear1x1_0(x).to(ad))
        h = self.MaskedBatchNorm_0(h, valid, n_valid)
        h = torch.relu(self.Linear1x1_1(h).to(ad))
        h = self.MaskedBatchNorm_1(h, valid, n_valid)
        return self.Linear1x1_2(h)


@contextlib.contextmanager
def _frozen_stats(module):
    """Recomputation context of a rematerialized block: its BN layers
    normalize as in the first pass but leave the running statistics alone."""
    bns = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True


class SelectionNet(nn.Module):

    def __init__(self, num_classes, in_channels,
                 heads=('mlp_offsets', 'mlp_bounds', 'mlp_bb_scores',
                        'mlp_semantics'),
                 layers=2, do_segment_pooling=True, max_pool_segments=False,
                 mlp_bounds_relu=False, stem_kernel=5,
                 compute_dtype=torch.bfloat16, act_dtype=torch.float32,
                 remat=False, remat_max_level=7):
        super().__init__()
        if layers < 1:
            raise ValueError(f'layers must be >= 1, got {layers}')
        cd, ad = compute_dtype, act_dtype
        self.heads = tuple(heads)
        self.layers = layers
        self.do_segment_pooling = do_segment_pooling
        self.max_pool_segments = max_pool_segments
        self.mlp_bounds_relu = mlp_bounds_relu
        self.stem_kernel = stem_kernel
        self.remat = remat
        self.remat_max_level = remat_max_level

        def blocks(stage, cin, planes):
            for i in range(layers):
                self.add_module(f'{stage}_block{i}', BasicBlock(
                    cin if i == 0 else planes, planes, compute_dtype=cd,
                    act_dtype=ad))

        self.stem_conv = SparseConv(in_channels, INIT_DIM, stem_kernel ** 3,
                                    act_dtype=ad)
        self.stem_bn = MaskedBatchNorm(INIT_DIM, act_dtype=ad)
        skip_ch = [INIT_DIM]
        c = INIT_DIM
        for l in range(1, 8):
            self.add_module(f'down{l}_conv', SparseConv(c, c, 8, act_dtype=ad))
            self.add_module(f'down{l}_bn', MaskedBatchNorm(c, act_dtype=ad))
            blocks(f'enc{l}', c, ENC_PLANES[l - 1])
            c = ENC_PLANES[l - 1]
            skip_ch.append(c)
        for i, l in enumerate(range(6, -1, -1)):
            planes = DEC_PLANES[i]
            self.add_module(f'up{l}_tr', SparseConvTranspose(c, planes,
                                                             act_dtype=ad))
            self.add_module(f'up{l}_bn', MaskedBatchNorm(planes, act_dtype=ad))
            blocks(f'dec{l}', planes + skip_ch[l], planes)
            c = planes
        dims = dict(HEAD_DIMS, mlp_semantics=num_classes,
                    mlp_per_vox_semantics=num_classes)
        for head in self.heads:
            self.add_module(head, HeadMLP(c, dims[head], compute_dtype=cd,
                                          act_dtype=ad))

    def forward(self, batch):
        def block_stage(x, level, stage):
            op = ops.conv_operand(batch, level, '3')
            v, n = batch[f'valid{level}'], batch[f'num{level}']
            remat = (self.remat and level <= self.remat_max_level
                     and torch.is_grad_enabled())
            for i in range(self.layers):
                block = getattr(self, f'{stage}_block{i}')
                if remat:
                    x = checkpoint(
                        block, x, op, v, n, use_reentrant=False,
                        preserve_rng_state=False,
                        context_fn=lambda b=block: (contextlib.nullcontext(),
                                                    _frozen_stats(b)))
                else:
                    x = block(x, op, v, n)
            return x

        x = self.stem_conv(batch['vox_features'],
                           ops.conv_operand(batch, 0, '5', self.stem_kernel))
        x = torch.relu(self.stem_bn(x, batch['valid0'], batch['num0']))
        skips = [x]
        for l in range(1, 8):
            x = getattr(self, f'down{l}_conv')(
                x, ops.conv_operand(batch, l - 1, 'd'))
            x = getattr(self, f'down{l}_bn')(x, batch[f'valid{l}'],
                                             batch[f'num{l}'])
            x = block_stage(torch.relu(x), l, f'enc{l}')
            skips.append(x)
        for l in range(6, -1, -1):
            x = getattr(self, f'up{l}_tr')(x, ops.up_operand(batch, l))
            x = getattr(self, f'up{l}_bn')(x, batch[f'valid{l}'],
                                           batch[f'num{l}'])
            x = torch.cat([torch.relu(x), skips[l]], dim=-1)
            x = block_stage(x, l, f'dec{l}')

        outputs = {}
        if any('per_vox' in h for h in self.heads):
            outputs['vox_feats'] = x
        if self.do_segment_pooling:
            pooled = ops.segment_pool(
                x, batch['pooling_ids'], batch['seg_valid'].shape[0],
                mode='max' if self.max_pool_segments else 'avg')
            pv, pn = batch['seg_valid'], batch['num_segments']
        else:
            pooled, pv, pn = x, batch['valid0'], batch['num0']
        for head in self.heads:
            mlp = getattr(self, head)
            if 'per_vox' in head:
                out = mlp(x, batch['valid0'], batch['num0'])
            else:
                out = mlp(pooled, pv, pn)
            if self.mlp_bounds_relu and head == 'mlp_bounds':
                out = torch.relu(out)
            outputs[head] = out
        return outputs
