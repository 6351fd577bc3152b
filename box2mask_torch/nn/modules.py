"""Building blocks of the sparse U-Net: sparse convs, masked batch norm,
residual blocks (port of box2mask_tpu/nn/modules.py:20-182).

Parameters keep the flax layouts and names, so a flax tree copies across by
path (convert.from_flax): conv kernels are (K, Cin, Cout) in the x-major
offset order of sparse/keys.offsets_3d, Linear1x1 is (Cin, Cout) plus a bias,
and batch norm keeps `scale`, `bias` and the running `mean` and `var`.

`act_dtype` is the dtype activations leave a module in (f32, or bf16 under
--bf16_acts); convs accumulate in f32 and BN normalizes in f32 either way.
"""

from __future__ import annotations

import torch
from torch import nn

from box2mask_torch.sparse import ops


class SparseConv(nn.Module):
    """Sparse conv over a key operand (sparse/ops.conv_operand)."""

    def __init__(self, cin, features, kernel_volume,
                 act_dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kernel_volume, cin, features))
        self.act_dtype = act_dtype

    def forward(self, x, op):
        return ops.gather_conv(x, op, self.kernel).to(self.act_dtype)


class SparseConvTranspose(nn.Module):
    """Stride-2 transpose conv (level l+1 -> l) over an up operand."""

    def __init__(self, cin, features, act_dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(8, cin, features))
        self.act_dtype = act_dtype

    def forward(self, x_coarse, op):
        return ops.up_conv(x_coarse, op, self.kernel).to(self.act_dtype)


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
    nn.remat discards the mutations of its recomputation."""

    def __init__(self, features, momentum=0.1, epsilon=1e-5,
                 act_dtype=torch.float32):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))
        self.momentum = momentum
        self.epsilon = epsilon
        self.act_dtype = act_dtype
        self.update_stats = True

    def forward(self, x, valid, n_valid):
        if self.training:
            mean, var, n = ops.masked_moments(x, valid, n_valid)
        else:
            mean, var = self.mean, self.var
        if self.training and self.update_stats:
            with torch.no_grad():
                m = self.momentum
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * unbiased)
        inv = torch.rsqrt(var + self.epsilon)
        return ((x - mean) * (inv * self.scale) + self.bias).to(self.act_dtype)


class BasicBlock(nn.Module):
    """conv3-BN-ReLU-conv3-BN + residual (+1x1 projection on channel change)
    + ReLU."""

    def __init__(self, cin, features, compute_dtype=torch.bfloat16,
                 act_dtype=torch.float32):
        super().__init__()
        ad = act_dtype
        self.SparseConv_0 = SparseConv(cin, features, 27, act_dtype=ad)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(features, act_dtype=ad)
        self.SparseConv_1 = SparseConv(features, features, 27, act_dtype=ad)
        self.MaskedBatchNorm_1 = MaskedBatchNorm(features, act_dtype=ad)
        if cin != features:
            self.downsample_conv = Linear1x1(cin, features, use_bias=False,
                                             compute_dtype=compute_dtype)
            self.downsample_bn = MaskedBatchNorm(features, act_dtype=ad)
        else:
            self.downsample_conv = None
        self.act_dtype = ad

    def forward(self, x, op, valid, n_valid):
        out = self.SparseConv_0(x, op)
        out = torch.relu(self.MaskedBatchNorm_0(out, valid, n_valid))
        out = self.SparseConv_1(out, op)
        out = self.MaskedBatchNorm_1(out, valid, n_valid)
        residual = x
        if self.downsample_conv is not None:
            residual = self.downsample_bn(self.downsample_conv(x), valid,
                                          n_valid)
        return torch.relu(out + residual.to(self.act_dtype))
