"""Building blocks of the sparse U-Net: sparse convs, masked batch norm,
residual blocks (port of box2mask_tpu/nn/modules.py:20-182; the convs take
a key operand or a neighbor map, as sparse/ops.py dispatches).

Parameters keep the flax layouts and names, so a flax tree copies across by
path (convert.from_flax): conv kernels are (K, Cin, Cout) in the x-major
offset order of sparse/keys.offsets_3d, Linear1x1 is (Cin, Cout) plus a bias,
and batch norm keeps `scale`, `bias` and the running `mean` and `var`.

`act_dtype` is the dtype activations leave a module in (f32, or bf16 under
--bf16_acts); convs accumulate in f32 and BN normalizes in f32 either way.
BN takes the ReLU and the residual add that follow it into its own op.
"""

from __future__ import annotations

import torch
from torch import nn

from box2mask_torch.sparse import masked_bn, ops


class SparseConv(nn.Module):
    """Sparse conv over a key operand or a neighbor map
    (sparse/ops.conv_operand). `compute_dtype` and `use_pallas` steer the
    neighbor-map convs (sparse/ops.gather_conv); the key-matching convs
    always round their operands to bf16."""

    def __init__(self, cin, features, kernel_volume,
                 compute_dtype=torch.bfloat16, use_pallas=False,
                 act_dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_volume, cin, features))
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
        self.act_dtype = act_dtype

    def forward(self, x, op):
        return ops.gather_conv(x, op, self.kernel, self.compute_dtype,
                               self.use_pallas).to(self.act_dtype)


class SparseConvTranspose(nn.Module):
    """Stride-2 transpose conv (level l+1 -> l) over an up operand or a
    (parent, widx) pair (sparse/ops.up_operand)."""

    def __init__(self, cin, features, compute_dtype=torch.bfloat16,
                 use_pallas=False, act_dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, cin, features))
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
        self.act_dtype = act_dtype

    def forward(self, x_coarse, op):
        return ops.up_conv(x_coarse, op, self.kernel, self.compute_dtype,
                           self.use_pallas).to(self.act_dtype)


class Linear1x1(nn.Module):
    """1x1 sparse conv == per-row dense layer; f32 out."""

    def __init__(self, cin, features, use_bias=True,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(cin, features))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return ops.linear(x, self.kernel, self.bias, self.compute_dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid rows only, torch-style momentum; eval uses the
    running statistics. In training the running statistics move once per
    forward, unless `update_stats` is off: a block rematerialized in the
    backward (nn/unet.py) turns it off while it recomputes, as flax's
    nn.remat discards the mutations of its recomputation. With a process
    `group` the batch moments are those of every rank's valid rows
    (SyncBatchNorm, the JAX package's axis_name), so the running statistics
    move alike on every rank. The call site adds `residual` and applies
    ReLU where the network does (`relu`): one op, sparse/masked_bn.py."""

    def __init__(self, features, momentum=0.1, epsilon=1e-5,
                 act_dtype=torch.float32, group=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        self.momentum = momentum
        self.epsilon = epsilon
        self.act_dtype = act_dtype
        self.group = group
        self.update_stats = True

    def forward(self, x, valid, n_valid, relu=False, residual=None):
        return masked_bn.bn_act(
            x, valid, n_valid, self.scale, self.bias, self.mean, self.var,
            training=self.training, update_stats=self.update_stats,
            momentum=self.momentum, eps=self.epsilon, relu=relu,
            residual=residual, out_dtype=self.act_dtype, group=self.group)


class BasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + residual (+1x1 projection on channel change)
    + ReLU."""

    def __init__(self, cin, features, compute_dtype=torch.bfloat16,
                 use_pallas=False, act_dtype=torch.float32, group=None):
        super().__init__()
        ad = act_dtype
        conv = dict(compute_dtype=compute_dtype, use_pallas=use_pallas,
                    act_dtype=ad)
        bn = dict(act_dtype=ad, group=group)
        self.SparseConv_0 = SparseConv(cin, features, 27, **conv)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, **bn)
        self.SparseConv_1 = SparseConv(features, features, 27, **conv)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features, **bn)
        if cin != features:
            self.downsample_conv = Linear1x1(cin, features, use_bias=False,
                                             compute_dtype=compute_dtype)
            self.downsample_bn = MaskedBatchNorm(features, **bn)
        else:
            self.downsample_conv = None

    def forward(self, x, op, valid, n_valid):
        out = self.MaskedBatchNorm_0(self.SparseConv_0(x, op), valid, n_valid,
                                     relu=True)
        out = self.SparseConv_1(out, op)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), valid,
                                          n_valid)
        return self.MaskedBatchNorm_1(out, valid, n_valid, relu=True,
                                      residual=residual)
