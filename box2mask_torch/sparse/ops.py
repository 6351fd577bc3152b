"""Sparse-voxel ops in plain PyTorch around the key-matching conv kernels:
conv dispatch, 1x1 linear, masked moments, segment pooling.

Port of box2mask_tpu/sparse/ops.py (gather_conv's key_conv branch :87-116,
up_conv's :160-165, both through the differentiable key_conv_*_train
wrappers; linear :182, masked_moments :192, segment_* :211-243).
Matmuls multiply operands rounded to `compute_dtype` in f32 (the JAX
package's preferred_element_type=f32); segment sums accumulate in f32 with a
trash segment at `num_segments` that is dropped.
"""

from __future__ import annotations

import torch

from box2mask_torch.sparse import key_conv as KC


def conv_operand(batch, level, kind, stem_kernel=5):
    """The key operand of one conv site: kind '3' (same level), '5' (stem) or
    'd' (stride-2 down from `level` to level + 1)."""
    out_l = level + 1 if kind == 'd' else level
    return {'keys_in': batch[f'keys{level}_b'],
            'keys_out': batch[f'keys{out_l}_b'].reshape(-1),
            'ksize': {'3': 3, '5': stem_kernel, 'd': 2}[kind],
            'stride_child': kind == 'd', 'scale': 1 << level}


def up_operand(batch, level):
    """Transpose ("generative up") conv from level + 1 to `level`: the fine
    rows query the coarse key row with negated child deltas."""
    return {'keys_in': batch[f'keys{level + 1}_b'],
            'keys_out': batch[f'keys{level}_b'].reshape(-1),
            'scale': 1 << level}


def gather_conv(x, op, w):
    """Sparse conv over a key operand (conv_operand), differentiable in x
    and w through the key_conv autograd Functions (train and eval alike)."""
    ks, scale = op['ksize'], op['scale']
    if op['stride_child']:
        return KC.key_conv_down_train(x, op['keys_in'], op['keys_out'], w,
                                      scale=scale)
    if ks == 5 and scale == 1 and x.shape[1] <= 8:
        return KC.key_conv_stem_train(x, op['keys_in'], w)
    return KC.key_conv_train(x, op['keys_in'], op['keys_out'], w,
                             kernel_size=ks, scale=scale, guard=True)


def up_conv(x_coarse, op, w):
    """Every fine row matches exactly one parent, in its up_widx weight slot
    (see key_conv stride_parent)."""
    return KC.key_conv_up_train(x_coarse, op['keys_in'], op['keys_out'], w,
                                scale=op['scale'])


def linear(x, w, b=None, compute_dtype=torch.bfloat16):
    """1x1 sparse conv == dense per-row linear layer: operands rounded to
    compute_dtype, product and sum in f32."""
    out = x.to(compute_dtype).float() @ w.to(compute_dtype).float()
    if b is not None:
        out = out + b
    return out


def masked_moments(x, valid, n_valid):
    """Mean/variance over valid rows only (padding excluded exactly)."""
    m = valid.float()[:, None]
    xf = x.float()
    s1 = (xf * m).sum(0)
    s2 = (xf.square() * m).sum(0)
    n = torch.clamp(n_valid.float(), min=1.0)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean.square(), min=0.0)
    return mean, var, n


def segment_sum(x, seg_ids, num_segments):
    """Segment sum with an extra trash segment: ids == num_segments drop."""
    out = torch.zeros((num_segments + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out.index_add_(0, seg_ids.long(), x)
    return out[:num_segments]


def segment_mean(x, seg_ids, num_segments):
    # f32 accumulation regardless of activation dtype: a segment can sum
    # thousands of rows, far past bf16's 8-bit mantissa
    s = segment_sum(x.float(), seg_ids, num_segments)
    cnt = segment_sum(torch.ones(x.shape[0], 1, device=x.device), seg_ids,
                      num_segments)
    return s / torch.clamp(cnt, min=1.0), cnt[:, 0]


def segment_max(x, seg_ids, num_segments):
    """Empty segments give 0 (the JAX package maps -inf to 0)."""
    idx = seg_ids.long()[:, None].expand(-1, x.shape[1])
    out = torch.full((num_segments + 1, x.shape[1]), float('-inf'),
                     device=x.device)
    out.scatter_reduce_(0, idx, x.float(), reduce='amax')
    out = torch.where(torch.isfinite(out), out, 0.0)
    return out[:num_segments]


def segment_pool(x, pooling_ids, num_segments, mode='avg'):
    """Per-oversegment pooling of voxel features; `pooling_ids` maps padded
    voxels to `num_segments` (the trash row)."""
    if mode == 'avg':
        return segment_mean(x, pooling_ids, num_segments)[0]
    if mode == 'max':
        return segment_max(x, pooling_ids, num_segments)
    raise ValueError(mode)
