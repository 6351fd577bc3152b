"""Sparse convolution by packed-key matching: CUDA kernel wrappers and their
plain PyTorch twins.

    out[v] = sum_k bf16(x[match(key_out[v] + sign * pack_delta(off_k, scale))])
                   @ bf16(w[k])            (f32 accumulation)

within scene b = v // pad_out, searching only that scene's sorted key row
keys_in_b[b]. A missing neighbour adds 0; an output row with a SENT key
gives 0. Four launch modes cover every conv of SelectionNet:

  mode     call                                     replaces (box2mask_tpu)
  same     key_conv(kernel_size=3, guard=True)      sparse/key_conv.py:116 _kernel
  down     key_conv(stride_child=True)                (:277 key_conv, :348
  up       key_conv(stride_parent=True)                pallas_call)
  stem     key_conv_stem (5^3, cin <= 8, f32 out)   :542 _stem_kernel (:666)
  dw       key_conv_dw (the three modes above)      :814 _dw_kernel (:934, :985)
  stem_dw  key_conv_stem_dw                         :557 _stem_dw_kernel (:698)

The weight gradients compute

    dw[k] = sum_v bf16(x[match(key_out[v] + sign * pack_delta(off_k, scale))])^T
                  @ bf16(g[v])              (f32 accumulation, f32 out)

and the four autograd Functions (`key_conv_train`, `key_conv_down_train`,
`key_conv_up_train`, `key_conv_stem_train`) compose them exactly as the JAX
custom VJPs do (`_kct_bwd` :1065, `_kcdp_bwd` :1150, `_kcu_bwd` :1201,
`_kcs_bwd` :731): dx is the forward conv of the cotangent (mirrored weights
for the same-level conv, the other stride-2 mode with transposed weights for
down and up, zeros for the stem, whose input is data), dw comes from the dw
kernel on x saved as bf16 (SAVED_X_DTYPE), dx is cast to x's dtype and dw to
w's.

What bounds them on the H100, and what the design does about it, is in the
header of csrc/key_conv.cu. The kernels search the key rows themselves (the
dw through per-offset lists of matched (input row, output row) pairs built
on the card, `key_conv_dw_pairs`; the stem dw in-block), so the TPU's host
window plans (kc*_base / kc*_cnt) do not exist in the port.

Rounding follows the JAX package: x and w round to bf16 on the f32 path too;
the output dtype follows x (bf16 under --bf16_acts), except the stem, whose
output is always f32.

A wrapper takes the plain twin only for CPU tensors; on a CUDA tensor it
launches its kernel or raises. `LAUNCHES` counts kernel launches per mode and
`PLAIN_CALLS` counts plain-twin calls, as plain integers; every `dw` launch
builds its pair lists (the dw has no other path).
"""

from __future__ import annotations

import torch

from box2mask_torch.sparse.keys import (AXIS_BITS, AXIS_MAX, SENT_KEY,
                                        offsets_3d, pack_delta)

MODES = ('same', 'down', 'up', 'stem', 'dw', 'stem_dw')
LAUNCHES = dict.fromkeys(MODES, 0)
PLAIN_CALLS = dict.fromkeys(MODES, 0)
# dtype the autograd Functions keep x in for the backward: the dw kernels
# round x to bf16 anyway, so the held activations halve at no cost (the JAX
# custom VJPs do the same); float32 keeps it unrounded, for comparisons
# without any bf16 rounding
SAVED_X_DTYPE = torch.bfloat16


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for m in MODES:
            d[m] = 0


def _mode(stride_child, stride_parent):
    return 'down' if stride_child else 'up' if stride_parent else 'same'


# ------------------------------------------------------------- plain twins
def _matches(keys_in_b, keys_out, kernel_size, stride_child, stride_parent,
             scale, guard):
    """Per offset k: (hit, src) over the output rows, hit (B*pad_out,) bool
    and src the matched input row (meaningful where hit)."""
    B, pad_in = keys_in_b.shape
    kin = keys_in_b.to(torch.int64).contiguous()
    ko = keys_out.reshape(B, -1).to(torch.int64)
    offs = offsets_3d(kernel_size, stride_child=stride_child or stride_parent)
    sign = -1 if stride_parent else 1
    valid = ko < SENT_KEY
    fields = (ko >> 2 * AXIS_BITS, (ko >> AXIS_BITS) & (AXIS_MAX - 1),
              ko & (AXIS_MAX - 1))
    base = (torch.arange(B, device=ko.device) * pad_in)[:, None]
    for off in offs:
        q = ko + sign * pack_delta(off, scale)
        ok = valid & (q >= 0)
        if guard:
            for f, d in zip(fields, off):
                ok = ok & (f + int(d) * scale >= 0) & (f + int(d) * scale
                                                      < AXIS_MAX)
        pos = torch.searchsorted(kin, q).clamp_(max=pad_in - 1)
        hit = ok & (kin.gather(1, pos) == q)
        yield hit.reshape(-1), (pos + base).reshape(-1)


def key_conv_plain(x, keys_in_b, keys_out, w, *, kernel_size=3,
                   stride_child=False, stride_parent=False, scale=1,
                   guard=True, out_dtype=None, operand_dtype=torch.bfloat16):
    """searchsorted + index gather + f32 matmul on bf16-rounded operands
    (`operand_dtype=torch.float32` leaves them unrounded).

    x:         (B*pad_in, Cin), scene-interleaved, key-sorted rows
    keys_in_b: (B, pad_in) int32 sorted keys (SENT-padded)
    keys_out:  (B*pad_out,) int32 output keys (the coarse keys for the down
               conv, the FINE keys for the stride_parent transpose conv)
    w:         (K, Cin, Cout)
    """
    xb = x.to(operand_dtype).float()
    wb = w.to(operand_dtype).float()
    out = torch.zeros(keys_out.numel(), w.shape[2], dtype=torch.float32,
                      device=x.device)
    for k, (hit, src) in enumerate(_matches(
            keys_in_b, keys_out, kernel_size, stride_child, stride_parent,
            scale, guard)):
        rows = hit.nonzero().squeeze(1)       # each row once per offset
        out.index_add_(0, rows, xb[src[rows]] @ wb[k])
    return out.to(out_dtype or x.dtype)


def key_conv_dw_plain(x, g, keys_in_b, keys_out, *, kernel_size=3,
                      stride_child=False, stride_parent=False, scale=1,
                      guard=True, operand_dtype=torch.bfloat16):
    """dw[k] = x[matched rows]^T @ g over the output rows that matched at
    offset k; x and g rounded to `operand_dtype`, f32 sums, f32 out
    (K, Cin, Cout) (float64 operands: f64 sums and out, a reference for
    the f32 ones). Arguments as key_conv_plain, g (B*pad_out, Cout)."""
    acc = torch.float64 if operand_dtype == torch.float64 else torch.float32
    xb = x.to(operand_dtype).to(acc)
    gb = g.to(operand_dtype).to(acc)
    dws = []
    for hit, src in _matches(keys_in_b, keys_out, kernel_size, stride_child,
                             stride_parent, scale, guard):
        rows = hit.nonzero().squeeze(1)
        dws.append(xb[src[rows]].T @ gb[rows])
    return torch.stack(dws)


def dw_pairs_plain(keys_in_b, keys_out, *, kernel_size=3, stride_child=False,
                   stride_parent=False, scale=1, guard=True):
    """The dw's pair lists: per offset k an (n_k, 2) int64 tensor of the
    matched (input row, output row) pairs, output rows ascending (misses,
    guarded axis wraps and SENT rows enter none). Arguments as
    key_conv_plain."""
    lists = []
    for hit, src in _matches(keys_in_b, keys_out, kernel_size, stride_child,
                             stride_parent, scale, guard):
        rows = hit.nonzero().squeeze(1)
        lists.append(torch.stack([src[rows], rows], 1))
    return lists


# ----------------------------------------------------------------- kernels
def _check_cuda(x, keys_in_b, keys_out, w):
    dev = x.device
    for name, t in (('keys_in_b', keys_in_b), ('keys_out', keys_out),
                    ('w', w)):
        if t.device != dev:
            raise ValueError(f'{name} on {t.device}, x on {dev}')
    if keys_in_b.dtype != torch.int32 or keys_out.dtype != torch.int32:
        raise TypeError('keys must be int32')
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f'bad shapes x {tuple(x.shape)} w {tuple(w.shape)}')
    if w.shape[2] % 16:
        raise ValueError(f'cout {w.shape[2]} must be a multiple of 16')
    B, pad_in = keys_in_b.shape
    if x.shape[0] != B * pad_in or keys_out.numel() % B:
        raise ValueError('x rows / keys_out must be B * pad')


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: cudaError {rc}')


def _bf16(t):
    """t as a contiguous bf16 tensor whose data is 16-byte aligned (the
    kernels load 8 bf16 values at a time)."""
    t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pad_cin(x, w=None):
    """bf16 x (rows, cin) and w (K, cin, cout) zero-padded to a multiple of
    8 input channels: the kernels gather x in 16-byte chunks of 8 channels
    (the stem's cin 6 becomes 8; zero channels add 0)."""
    p = -x.shape[1] % 8
    if p:
        x = torch.nn.functional.pad(x, (0, p))
        w = None if w is None else torch.nn.functional.pad(w, (0, 0, 0, p))
    return x, w


def _geometry(kernel_size, stride_child, stride_parent):
    """(offsets per axis, first offset, query sign) of a key_conv mode."""
    if stride_child or stride_parent:
        return 2, 0, -1 if stride_parent else 1
    return kernel_size, -(kernel_size // 2), 1


def _slices(n_rows):
    """Capacity of a stem dw launch's partials in row-tile slices: one wave
    of up to 4 blocks per SM of the H100's 132, 5 blocks (the dx groups) per
    slice (the kernel takes as many as the SMs hold), at most one slice per
    64-row tile."""
    n_tiles = max(1, -(-n_rows // 64))
    return max(1, min(n_tiles, 4 * 132 // 5))


def wpack_numel(K, cin, cout):
    """Elements of the packed-w scratch of a forward launch: cin in n_ch
    chunks of kc channels, kc % 16 == 0 and at most 128 (csrc/conv_tile.cuh
    chunks)."""
    kp = -(-cin // 16) * 16
    n_ch = -(-kp // 128)
    kc = -(-(-(-kp // n_ch)) // 16) * 16
    return K * cout * n_ch * kc


# pairs per dw tile, metadata ints before the per-offset triples
# (csrc/dw_plan.cuh DW_M, DW_META)
DW_M, DW_META = 64, 3
# the fields of csrc/key_conv.cu b2m_key_conv_dw_scratch's out array
DW_SCRATCH = ('total', 'cap', 'n_pad', 'n_chunks', 'pairs', 'table',
              'counts', 'meta')


def dw_scratch(lib, n_rows, kernel_size, cin, cout):
    """The scratch of a dw launch on the current device as
    csrc/dw_plan.cuh DwScratch lays it out (the one layout): a dict of
    DW_SCRATCH, sizes and offsets in ints."""
    import ctypes
    out = (ctypes.c_longlong * len(DW_SCRATCH))()
    _launch(lib.b2m_key_conv_dw_scratch, n_rows, kernel_size, cin, cout,
            ctypes.addressof(out))
    return dict(zip(DW_SCRATCH, out))


def dw_item_plan(counts, target):
    """The dw's work items from the per-offset pair counts, as
    csrc/key_conv.cu match_table_kernel_scan makes them: chunk (pairs per
    item), items and first item per offset, numbered offset by offset."""
    chunk = max(DW_M, -(-(-(-sum(counts) // target)) // DW_M) * DW_M)
    items = [-(-n // chunk) for n in counts]
    first = [sum(items[:k]) for k in range(len(items))]
    return dict(chunk=chunk, target=target, items=items, first=first)


def key_conv(x, keys_in_b, keys_out, w, *, kernel_size=3, stride_child=False,
             stride_parent=False, scale=1, guard=True):
    """Same-level (guarded), down (stride_child) or transpose up
    (stride_parent) conv; output dtype follows x. See the module docstring."""
    mode = _mode(stride_child, stride_parent)
    if x.device.type == 'cpu':
        PLAIN_CALLS[mode] += 1
        return key_conv_plain(x, keys_in_b, keys_out, w,
                              kernel_size=kernel_size,
                              stride_child=stride_child,
                              stride_parent=stride_parent, scale=scale,
                              guard=guard)
    if x.device.type != 'cuda':
        raise ValueError(f'key_conv: unsupported device {x.device}')
    _check_cuda(x, keys_in_b, keys_out, w)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'key_conv: x dtype {x.dtype}')
    from box2mask_torch.sparse import _build
    lib = _build.load('key_conv')
    ks, lo, sign = _geometry(kernel_size, stride_child, stride_parent)
    B, pad_in = keys_in_b.shape
    pad_out = keys_out.numel() // B
    xb, wb = pad_cin(_bf16(x), _bf16(w))
    kin = keys_in_b.contiguous()
    kout = keys_out.reshape(-1).contiguous()
    out = torch.empty(B * pad_out, w.shape[2], dtype=x.dtype, device=x.device)
    wp = torch.empty(wpack_numel(*wb.shape), dtype=torch.bfloat16,
                     device=x.device)
    with _build.on(x.device):
        stream = _build.stream(x.device)
        _launch(lib.b2m_key_conv, xb.data_ptr(), kin.data_ptr(),
                kout.data_ptr(), wb.data_ptr(), wp.data_ptr(),
                out.data_ptr(), B, pad_in,
                pad_out, xb.shape[1], w.shape[2], ks, lo, sign, scale,
                int(bool(guard)), int(x.dtype == torch.bfloat16), stream)
    LAUNCHES[mode] += 1
    return out


def key_conv_stem(x, keys_in_b, w):
    """5^3 stride-1 stem conv, cin <= 8: input space == output space, x
    rounded to bf16, output always f32."""
    if x.device.type == 'cpu':
        PLAIN_CALLS['stem'] += 1
        return key_conv_plain(x, keys_in_b, keys_in_b.reshape(-1), w,
                              kernel_size=5, guard=True,
                              out_dtype=torch.float32)
    if x.device.type != 'cuda':
        raise ValueError(f'key_conv_stem: unsupported device {x.device}')
    _check_cuda(x, keys_in_b, keys_in_b, w)
    if x.shape[1] > 8 or w.shape[0] != 125:
        raise ValueError(f'stem expects cin <= 8 and K = 125, got '
                         f'{tuple(w.shape)}')
    from box2mask_torch.sparse import _build
    lib = _build.load('key_conv')
    B, pad = keys_in_b.shape
    xb, wb = pad_cin(_bf16(x), _bf16(w))
    kin = keys_in_b.contiguous()
    out = torch.empty(B * pad, w.shape[2], dtype=torch.float32,
                      device=x.device)
    wp = torch.empty(wpack_numel(*wb.shape), dtype=torch.bfloat16,
                     device=x.device)
    with _build.on(x.device):
        stream = _build.stream(x.device)
        _launch(lib.b2m_key_conv_stem, xb.data_ptr(), kin.data_ptr(),
                wb.data_ptr(), wp.data_ptr(), out.data_ptr(), B, pad,
                xb.shape[1],
                w.shape[2], stream)
    LAUNCHES['stem'] += 1
    return out


def _check_dw(x, g, keys_in_b, keys_out):
    B, pad_in = keys_in_b.shape
    if x.dim() != 2 or g.dim() != 2 or x.shape[0] != B * pad_in:
        raise ValueError(f'bad shapes x {tuple(x.shape)} g {tuple(g.shape)}')
    if g.shape[0] != keys_out.numel() or keys_out.numel() % B:
        raise ValueError('g rows must equal keys_out, a multiple of B')
    for name, t in (('g', g), ('keys_in_b', keys_in_b),
                    ('keys_out', keys_out)):
        if t.device != x.device:
            raise ValueError(f'{name} on {t.device}, x on {x.device}')
    if keys_in_b.dtype != torch.int32 or keys_out.dtype != torch.int32:
        raise TypeError('keys must be int32')
    if g.shape[1] % 16:
        raise ValueError(f'cout {g.shape[1]} must be a multiple of 16')


def key_conv_dw(x, g, keys_in_b, keys_out, *, kernel_size=3,
                stride_child=False, stride_parent=False, scale=1, guard=True):
    """Weight gradient of key_conv in the same mode: (K, Cin, Cout) f32 from
    x (B*pad_in, Cin) and the output cotangent g (B*pad_out, Cout), both
    rounded to bf16. See the module docstring."""
    if x.device.type == 'cpu':
        PLAIN_CALLS['dw'] += 1
        return key_conv_dw_plain(x, g, keys_in_b, keys_out,
                                 kernel_size=kernel_size,
                                 stride_child=stride_child,
                                 stride_parent=stride_parent, scale=scale,
                                 guard=guard)
    if x.device.type != 'cuda':
        raise ValueError(f'key_conv_dw: unsupported device {x.device}')
    _check_dw(x, g, keys_in_b, keys_out)
    from box2mask_torch.sparse import _build
    lib = _build.load('key_conv')
    ks, lo, sign = _geometry(kernel_size, stride_child, stride_parent)
    K = ks ** 3
    B, pad_in = keys_in_b.shape
    pad_out = keys_out.numel() // B
    xb, gb = pad_cin(_bf16(x))[0], _bf16(g)
    cin, cout = xb.shape[1], g.shape[1]
    kin = keys_in_b.contiguous()
    kout = keys_out.reshape(-1).contiguous()
    dw = torch.empty(K, cin, cout, dtype=torch.float32, device=x.device)
    with _build.on(x.device):
        lay = dw_scratch(lib, B * pad_out, ks, cin, cout)
        scratch = torch.empty(lay['total'], dtype=torch.int32,
                              device=x.device)
        stream = _build.stream(x.device)
        _launch(lib.b2m_key_conv_dw, xb.data_ptr(), kin.data_ptr(),
                kout.data_ptr(), gb.data_ptr(), dw.data_ptr(),
                scratch.data_ptr(), B, pad_in, pad_out, cin, cout, ks, lo,
                sign, scale, int(bool(guard)), stream)
    LAUNCHES['dw'] += 1
    return dw if cin == x.shape[1] else dw[:, :x.shape[1]].contiguous()


def key_conv_dw_pairs(keys_in_b, keys_out, *, cin, cout, kernel_size=3,
                      stride_child=False, stride_parent=False, scale=1,
                      guard=True):
    """The card's build of key_conv_dw's pair lists at input / output widths
    cin / cout, as dw_pairs_plain gives them (int64 (n_k, 2) per offset),
    and the work items its multiply runs (dw_item_plan's dict). It reads
    the pair counts back: for tests and diagnostics, never the train step.
    CUDA int32 keys only (the twin is dw_pairs_plain)."""
    if keys_in_b.device.type != 'cuda':
        raise ValueError(f'key_conv_dw_pairs: a build on the card, not on '
                         f'{keys_in_b.device} (dw_pairs_plain is the twin)')
    if keys_in_b.dtype != torch.int32 or keys_out.dtype != torch.int32:
        raise TypeError('keys must be int32')
    from box2mask_torch.sparse import _build
    lib = _build.load('key_conv')
    ks, lo, sign = _geometry(kernel_size, stride_child, stride_parent)
    K = ks ** 3
    cin += -cin % 8                            # pad_cin's width
    B, pad_in = keys_in_b.shape
    pad_out = keys_out.numel() // B
    kin = keys_in_b.contiguous()
    kout = keys_out.reshape(-1).contiguous()
    with _build.on(keys_in_b.device):
        lay = dw_scratch(lib, B * pad_out, ks, cin, cout)
        scratch = torch.empty(lay['total'], dtype=torch.int32,
                              device=keys_in_b.device)
        stream = _build.stream(keys_in_b.device)
        _launch(lib.b2m_key_conv_dw_pairs, kin.data_ptr(), kout.data_ptr(),
                scratch.data_ptr(), B, pad_in, pad_out, cin, cout, ks, lo,
                sign, scale, int(bool(guard)), stream)
    meta = scratch[lay['meta']:lay['meta'] + DW_META + 3 * K].tolist()
    counts, items, first = meta[DW_META::3], meta[DW_META + 1::3], \
        meta[DW_META + 2::3]
    pairs = scratch[lay['pairs']:lay['pairs'] + 2 * K * lay['n_pad']].view(
        K, lay['n_pad'], 2)
    return ([pairs[k, :n].long() for k, n in enumerate(counts)],
            dict(chunk=meta[1], target=meta[2], items=items, first=first))


def key_conv_stem_dw(x, g, keys_in_b):
    """Weight gradient of key_conv_stem: (125, Cin, Cout) f32 from x
    (B*pad, Cin <= 8) and g (B*pad, Cout), both rounded to bf16 (g in the
    kernel: f32 g is read as it is, no cast pass)."""
    if x.device.type == 'cpu':
        PLAIN_CALLS['stem_dw'] += 1
        return key_conv_dw_plain(x, g, keys_in_b, keys_in_b.reshape(-1),
                                 kernel_size=5, guard=True)
    if x.device.type != 'cuda':
        raise ValueError(f'key_conv_stem_dw: unsupported device {x.device}')
    kin = keys_in_b.contiguous()
    _check_dw(x, g, kin, kin.reshape(-1))
    if not 1 <= x.shape[1] <= 8 or g.shape[1] not in (16, 32):
        raise ValueError(f'stem dw expects cin <= 8 and cout 16 or 32, got '
                         f'{x.shape[1]}, {g.shape[1]}')
    from box2mask_torch.sparse import _build
    lib = _build.load('key_conv')
    B, pad = kin.shape
    cin, cout = x.shape[1], g.shape[1]
    S = _slices(B * pad)
    xb = pad_cin(_bf16(x))[0]
    gc = (g if g.dtype in (torch.float32, torch.bfloat16)
          else g.to(torch.bfloat16)).contiguous()
    if gc.data_ptr() % 16:
        gc = gc.clone()
    part = torch.empty(S, 125, cin, cout, dtype=torch.float32,
                       device=x.device)
    dw = torch.empty(125, cin, cout, dtype=torch.float32, device=x.device)
    with _build.on(x.device):
        stream = _build.stream(x.device)
        _launch(lib.b2m_key_conv_stem_dw, xb.data_ptr(), kin.data_ptr(),
                gc.data_ptr(), part.data_ptr(), dw.data_ptr(), B, pad, cin,
                cout, int(gc.dtype == torch.bfloat16), S, stream)
    LAUNCHES['stem_dw'] += 1
    return dw


# ---------------------------------------------------------------- autograd
def mirror_weights(w):
    """w'[k] = w[K-1-k]^T: the same-level conv's dx weights (odd kernels
    enumerate x-major over symmetric ranges, so negating an offset reverses
    its index). Port of box2mask_tpu/sparse/key_conv.py:1023."""
    return w.flip(0).transpose(1, 2)


class _KeyConvSame(torch.autograd.Function):
    """Same-level conv (JAX key_conv_train, :1031 / _kct_bwd :1065)."""

    @staticmethod
    def forward(ctx, x, w, keys_in_b, keys_out, kernel_size, scale, guard):
        ctx.static = dict(kernel_size=kernel_size, scale=scale, guard=guard)
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(
            x.to(SAVED_X_DTYPE) if ctx.needs_input_grad[1] else None,
            keys_in_b, keys_out, w)
        return key_conv(x, keys_in_b, keys_out, w, **ctx.static)

    @staticmethod
    def backward(ctx, gout):
        x_bf, kin, kout, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = key_conv(gout, kin, kout, mirror_weights(w),
                          **ctx.static).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = key_conv_dw(x_bf, gout, kin, kout,
                             **ctx.static).to(w.dtype)
        return dx, dw, None, None, None, None, None


class _KeyConvDown(torch.autograd.Function):
    """Stride-2 down conv, fine keys_in_b -> coarse keys_out (JAX
    key_conv_down_plan_train, :1126 / _kcdp_bwd :1150): dx is the transpose
    (stride_parent) conv of the cotangent over (coarse rows, fine keys)
    with w^T; dw is the stride_child dw."""

    @staticmethod
    def forward(ctx, x, w, keys_in_b, keys_out, scale):
        ctx.scale = scale
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(
            x.to(SAVED_X_DTYPE) if ctx.needs_input_grad[1] else None,
            keys_in_b, keys_out, w)
        return key_conv(x, keys_in_b, keys_out, w, kernel_size=2,
                        stride_child=True, scale=scale, guard=False)

    @staticmethod
    def backward(ctx, gout):
        x_bf, kin, kout, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = key_conv(gout, kout.reshape(kin.shape[0], -1),
                          kin.reshape(-1), w.transpose(1, 2), kernel_size=2,
                          stride_parent=True, scale=ctx.scale,
                          guard=False).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = key_conv_dw(x_bf, gout, kin, kout, kernel_size=2,
                             stride_child=True, scale=ctx.scale,
                             guard=False).to(w.dtype)
        return dx, dw, None, None, None


class _KeyConvUp(torch.autograd.Function):
    """Stride-2 transpose conv, coarse keys_in_b -> fine keys_out (JAX
    key_conv_up_train, :1172 / _kcu_bwd :1201): dx is the down
    (stride_child) conv of the cotangent over (fine rows, coarse keys) with
    w^T; dw is the stride_parent dw."""

    @staticmethod
    def forward(ctx, x, w, keys_in_b, keys_out, scale):
        ctx.scale = scale
        ctx.x_dtype = x.dtype
        ctx.save_for_backward(
            x.to(SAVED_X_DTYPE) if ctx.needs_input_grad[1] else None,
            keys_in_b, keys_out, w)
        return key_conv(x, keys_in_b, keys_out, w, kernel_size=2,
                        stride_parent=True, scale=scale, guard=False)

    @staticmethod
    def backward(ctx, gout):
        x_bf, kin, kout, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = key_conv(gout, kout.reshape(kin.shape[0], -1),
                          kin.reshape(-1), w.transpose(1, 2), kernel_size=2,
                          stride_child=True, scale=ctx.scale,
                          guard=False).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = key_conv_dw(x_bf, gout, kin, kout, kernel_size=2,
                             stride_parent=True, scale=ctx.scale,
                             guard=False).to(w.dtype)
        return dx, dw, None, None, None


class _KeyConvStem(torch.autograd.Function):
    """5^3 stem (JAX key_conv_stem_train, :713 / _kcs_bwd :731): dw from the
    stem dw kernel; dx is zeros, the stem's input being data."""

    @staticmethod
    def forward(ctx, x, w, keys_in_b):
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        ctx.save_for_backward(
            x.to(SAVED_X_DTYPE) if ctx.needs_input_grad[1] else None,
            keys_in_b, w)
        return key_conv_stem(x, keys_in_b, w)

    @staticmethod
    def backward(ctx, gout):
        x_bf, kin, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.zeros(ctx.x_shape, dtype=ctx.x_dtype,
                             device=gout.device)
        if ctx.needs_input_grad[1]:
            dw = key_conv_stem_dw(x_bf, gout, kin).to(w.dtype)
        return dx, dw, None


def key_conv_train(x, keys_in_b, keys_out, w, *, kernel_size=3, scale=1,
                   guard=True):
    """Differentiable same-level conv (input space == output space)."""
    return _KeyConvSame.apply(x, w, keys_in_b, keys_out, kernel_size, scale,
                              guard)


def key_conv_down_train(x, keys_in_b, keys_out, w, *, scale=1):
    """Differentiable stride-2 down conv (fine keys_in_b -> coarse
    keys_out)."""
    return _KeyConvDown.apply(x, w, keys_in_b, keys_out, scale)


def key_conv_up_train(x, keys_in_b, keys_out, w, *, scale=1):
    """Differentiable stride-2 transpose conv (coarse keys_in_b -> fine
    keys_out)."""
    return _KeyConvUp.apply(x, w, keys_in_b, keys_out, scale)


def key_conv_stem_train(x, keys_in_b, w):
    """Differentiable 5^3 stem conv (dx is zeros)."""
    return _KeyConvStem.apply(x, w, keys_in_b)
