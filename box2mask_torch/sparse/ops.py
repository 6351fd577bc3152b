"""Sparse-voxel ops in plain PyTorch around the conv kernels: conv dispatch,
1x1 linear, masked moments, segment pooling.

Port of box2mask_tpu/sparse/ops.py: gather_conv (:228) and up_conv (:340)
with the JAX package's dispatch over the operand a conv site is given,

  * a key operand (dict, conv_operand / up_operand): the key-matching convs,
    differentiable through the key_conv_*_train wrappers (:285-314,
    :358-363);
  * a neighbor map (tensor; up_conv: a (parent, widx) pair): with
    `use_pallas` and a row count that is a multiple of pallas_conv.TILE
    (:316-319, :371-375) the CUDA kernels of sparse/pallas_conv.py, which
    round x and w to bf16 and differentiate through its autograd
    Functions (SparseConvFn, GatherRowsFn); otherwise the XLA formulation
    of :320-337 and :376-377 (gather_conv_xla, up_pick_xla: operands in
    `compute_dtype`, summed in f32 in offset order; the up conv's row pick
    unrounded). The kernels take any row count; the rule is kept because
    it decides the function (bf16 rounding or not), so the port computes
    the JAX package's at every shape. The XLA formulations are plain PyTorch on any device
    and count their calls in XLA_CALLS;

and linear :380, masked_moments :390, segment_* :409-441. Matmuls multiply
operands rounded to `compute_dtype` in f32 (the JAX package's
preferred_element_type=f32); segment sums accumulate in f32 with a trash
segment at `num_segments` that is dropped.
"""

from __future__ import annotations

import torch

from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import masked_bn
from box2mask_torch.sparse import pallas_conv as PC

# calls of the XLA formulations, per op
XLA_CALLS = {'gather_conv': 0, 'up_conv': 0}


def reset_counts():
    for k in XLA_CALLS:
        XLA_CALLS[k] = 0


def conv_operand(batch, level, kind, stem_kernel=5):
    """The operand of one conv site: kind '3' (same level), '5' (stem) or
    'd' (stride-2 down from `level` to level + 1). A batch that carries
    neighbor maps (engine/state.ensure_maps) gives its map, any other the
    key operand."""
    if 'nmap5_0' in batch:
        return batch[{'3': f'nmap3_{level}', '5': 'nmap5_0',
                      'd': f'down{level}'}[kind]]
    out_l = level + 1 if kind == 'd' else level
    return {'keys_in': batch[f'keys{level}_b'],
            'keys_out': batch[f'keys{out_l}_b'].reshape(-1),
            'ksize': {'3': 3, '5': stem_kernel, 'd': 2}[kind],
            'stride_child': kind == 'd', 'scale': 1 << level}


def up_operand(batch, level):
    """Transpose ("generative up") conv from level + 1 to `level`: the
    (up_parent, up_widx) maps of a neighbor-map batch, or the key operand,
    whose fine rows query the coarse key row with negated child deltas."""
    if 'nmap5_0' in batch:
        return batch[f'up_parent{level}'], batch[f'up_widx{level}']
    return {'keys_in': batch[f'keys{level + 1}_b'],
            'keys_out': batch[f'keys{level}_b'].reshape(-1),
            'scale': 1 << level}


def gather_conv(x, nbr, w, compute_dtype=torch.bfloat16, use_pallas=False):
    """Sparse conv out[v] = sum_k x[nbr[v, k]] @ w[k] over a key operand
    (output dtype follows x, except the stem's f32; differentiable in x and
    w through the key_conv autograd Functions, train and eval alike) or a
    neighbor map nbr (Vout, K) int32 whose entries == x.shape[0] mark a
    missing neighbor (f32 out; differentiable through SparseConvFn or the
    XLA formulation's torch ops). A callable nbr is a spatially sharded
    operand (parallel/spatial.py): it runs its halo exchange and its conv,
    nbr(x, w, compute_dtype, use_pallas)."""
    if callable(nbr):
        return nbr(x, w, compute_dtype, use_pallas)
    if isinstance(nbr, dict):
        ks, scale = nbr['ksize'], nbr['scale']
        if nbr['stride_child']:
            return KC.key_conv_down_train(x, nbr['keys_in'], nbr['keys_out'],
                                          w, scale=scale)
        if ks == 5 and scale == 1 and x.shape[1] <= 8:
            return KC.key_conv_stem_train(x, nbr['keys_in'], w)
        return KC.key_conv_train(x, nbr['keys_in'], nbr['keys_out'], w,
                                 kernel_size=ks, scale=scale, guard=True)
    if use_pallas and nbr.shape[0] % PC.TILE == 0:
        return PC.SparseConvFn.apply(x, nbr, w)
    return gather_conv_xla(x, nbr, w, compute_dtype)


def gather_conv_xla(x, nbr, w, compute_dtype):
    """JAX ops.py:320-337: per-offset gather + f32 matmul of operands
    rounded to compute_dtype, summed in offset order; f32 out."""
    XLA_CALLS['gather_conv'] += 1
    return PC.gather_matmul_sum(x, nbr, w, compute_dtype)


def up_pick_xla(y, idx):
    """JAX ops.py:376-377: rows idx of y, unrounded; 0 where idx >= U*8."""
    XLA_CALLS['up_conv'] += 1
    return PC.with_zero_row(y, torch.float32)[torch.clamp(idx.long(),
                                                          max=y.shape[0])]


def up_conv(x_coarse, op, w, compute_dtype=torch.bfloat16, use_pallas=False):
    """Stride-2 transpose conv from level l+1 to level l.

    Key operand: every fine row matches exactly one parent, in its up_widx
    weight slot (see key_conv stride_parent); output dtype follows x.
    (parent, widx) maps: all 8 candidate outputs of each coarse row come
    from one product with the 8 weight slots, y (U*8, Cout) f32, and each
    fine row takes row parent * 8 + widx of it (U*8, the zero row, for a
    missing parent)."""
    if isinstance(op, dict):
        return KC.key_conv_up_train(x_coarse, op['keys_in'], op['keys_out'],
                                    w, scale=op['scale'])
    parent, widx = op
    U, cin = x_coarse.shape
    cout = w.shape[2]
    w_all = w.permute(1, 0, 2).reshape(cin, 8 * cout)
    y = linear(x_coarse, w_all, compute_dtype=compute_dtype).reshape(U * 8,
                                                                      cout)
    idx = torch.where(parent >= U, U * 8, parent * 8 + widx).to(torch.int32)
    if use_pallas and idx.shape[0] % PC.TILE == 0:
        # idx is monotone (children sorted within each parent block)
        return PC.GatherRowsFn.apply(y, idx)
    return up_pick_xla(y, idx)


def linear(x, w, b=None, compute_dtype=torch.bfloat16):
    """1x1 sparse conv == dense per-row linear layer: operands rounded to
    compute_dtype, product and sum in f32."""
    out = x.to(compute_dtype).float() @ w.to(compute_dtype).float()
    if b is not None:
        out = out + b
    return out


def masked_moments(x, valid, n_valid, group=None):
    """Mean/variance over valid rows only (padding excluded exactly): the
    formula of sparse/masked_bn.moments, differentiable. With a process
    group, the sums s1, s2 and n are summed over its ranks (the JAX
    package's psum over the mesh axis: SyncBatchNorm) by one all-reduce
    that autograd differentiates: its backward all-reduces the cotangent,
    as the transpose of psum does. The network's BN takes its moments
    inside masked_bn.bn_act; this is their reference with autograd."""
    from torch.distributed.nn.functional import all_reduce
    mean, v0, n = masked_bn.moments(
        x, valid, n_valid, group, lambda t, g: all_reduce(t, group=g))
    return mean, torch.clamp(v0, min=0.0), n


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
