"""Neighbor-map sparse convolution and monotone row gather: CUDA kernel
wrappers and their plain PyTorch twins (named after
box2mask_tpu/sparse/pallas_conv.py, whose two Pallas kernels they replace).

  sparse_conv(x, nbr, w)   out[v] = sum_k bf16(x[nbr[v, k]]) @ bf16(w[k])
                           f32 accumulation, f32 out; nbr == Vin (or any
                           entry >= Vin) adds 0.
                           Replaces pallas_conv.py:36 _kernel (sparse_conv
                           :114, _pallas_forward :80, pallas_call :92).
  gather_rows(x, idx)      out[i] = f32(bf16(x[idx[i]])), 0 where idx >= Vin.
                           Replaces pallas_conv.py:148 _gather_kernel
                           (gather_rows :175, pallas_call :184).

Both round x (and w) to bf16 whatever the caller's compute dtype, as the
Pallas kernels do (:88-91, :182-183); the ops that call them
(sparse/ops.py gather_conv, up_conv) keep the JAX package's dispatch.

What bounds them on the H100, and what the design does about it
(csrc/nmap_conv.cu):
  * sparse_conv: at the network's widths (cin, cout 32..256) the FLOPs of
    the matched pairs are far under the bf16 tensor-core peak, so the bound
    is the bytes: the valid x rows and w in bf16, the int32 map (Vout x K x
    4 B: 57 MB for the level-0 3^3 map of 4 ScanNet scenes) and the f32
    output written once. A block owns 128 output rows x NT output
    channels, reads its rows' map entries once, lists the offsets with a
    hit in the tile, and streams the matched bf16 x rows (zeros at the
    sentinel) and the packed w[k] slabs through a ring of shared-memory
    stages (cp.async, bulk copies) into wgmma products with f32
    accumulators in registers. It is the key-matching conv of
    csrc/key_conv.cu with the match read from the map instead of searched,
    and shares its tile (csrc/conv_tile.cuh). The TPU kernel's union-window
    DMA, one-hot MXU gather and 128-lane channel padding have no part here.
  * gather_rows: a pure gather with a cast, bytes-bound (idx read once, the
    gathered f32 rows read and the f32 output written once). One wave of
    persistent blocks walks the output as a flat array of 16-byte elements,
    4 per thread in flight (idx loads, then x loads, then stores), each
    value rounded f32 -> bf16 -> f32 in registers; single floats where C %
    4 != 0 or x is not 16-byte aligned. The wrapper makes no copy of
    contiguous inputs and enters no device context when x's device is
    current (`_build.on`), and passes the raw stream handle
    (`_build.stream`): at the up 4->3 row pick the device work is ~35 us,
    so the host part of a call counts.

A wrapper takes the plain twin only for CPU tensors; on a CUDA tensor it
launches its kernel or raises. `LAUNCHES` counts kernel launches and
`PLAIN_CALLS` plain-twin calls, per kernel, as plain integers.

Training differentiates through two autograd Functions around the wrappers:
  SparseConvFn   forward sparse_conv; backward sparse_conv_bwd, the JAX
                 package's custom VJP (pallas_conv.py:123-141 _bwd) in torch
                 ops and in its order of roundings: dw[k] = bf16(x_z[nbr[:,
                 k]])^T bf16(g) and dx[nbr[:, k]] += bf16(g) bf16(w[k])^T,
                 both summed in f32 (dx by index_add_ over Vin + 1 rows, the
                 sentinel row dropped), dx cast to x's dtype and dw to w's.
                 The JAX package computes this backward outside Pallas, so
                 torch ops are its port. The dx of a same-level 3^3 conv is
                 the same sum taken by the forward kernel: a sparse_conv of
                 g over the same (symmetric) map with the mirrored,
                 transposed weights (mirrored_dx). dx is skipped when x
                 needs no grad (the stem's input is data).
  GatherRowsFn   forward gather_rows; backward the gradient of the row pick
                 it replaces (JAX ops.py:376-377, a take over y with a zero
                 row appended): dy = index_add_ of g over idx into U*8 + 1
                 rows, the zero row dropped. The bf16 rounding of y passes
                 the gradient straight through. The JAX package gives
                 gather_rows no VJP: jax.grad of its pallas_call raises
                 (ROADMAP section C).
"""

from __future__ import annotations

import torch

from box2mask_torch.sparse.key_conv import pad_cin, wpack_numel

TILE = 256      # row multiple the JAX dispatch requires (pallas_conv.py:32)
KERNELS = ('sparse_conv', 'gather_rows')
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in KERNELS:
            d[k] = 0


# ------------------------------------------------------------- plain twins
# The two formulations below are also sparse/ops.py's XLA route (operands in
# compute_dtype, the row pick unrounded), which counts its own calls.
def with_zero_row(x, operand_dtype):
    """x rounded to operand_dtype, in f32, with one zero row appended (the
    sentinel's target)."""
    xb = x.to(operand_dtype).float()
    return torch.cat([xb, xb.new_zeros(1, xb.shape[1])])


def gather_matmul_sum(x, nbr, w, operand_dtype):
    """Per-offset gather + f32 matmul of operands rounded to operand_dtype,
    summed in offset order. x (Vin, Cin), nbr (Vout, K) int, w (K, Cin,
    Cout)."""
    xz = with_zero_row(x, operand_dtype)
    wb = w.to(operand_dtype).float()
    idx = torch.clamp(nbr.long(), max=x.shape[0])
    out = torch.zeros(nbr.shape[0], w.shape[2], dtype=torch.float32,
                      device=x.device)
    for k in range(nbr.shape[1]):
        out = out + xz[idx[:, k]] @ wb[k]
    return out


def sparse_conv_plain(x, nbr, w):
    """The twin of sparse_conv: operands rounded to bf16."""
    return gather_matmul_sum(x, nbr, w, torch.bfloat16)


def gather_rows_plain(x, idx):
    """out[i] = f32(bf16(x[idx[i]])), 0 where idx >= Vin. x (Vin, C)."""
    return with_zero_row(x, torch.bfloat16)[torch.clamp(idx.long(),
                                                        max=x.shape[0])]


# ----------------------------------------------------------------- kernels
def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: cudaError {rc}')


def _bf16(t):
    """t as a contiguous bf16 tensor with 16-byte aligned data (the kernel
    loads 8 bf16 values at a time)."""
    t = t.to(torch.bfloat16).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(name, x, index, ndim):
    if x.device.type != 'cuda':
        raise ValueError(f'{name}: unsupported device {x.device}')
    if index.device != x.device:
        raise ValueError(f'{name}: index on {index.device}, x on {x.device}')
    if index.dtype != torch.int32 or index.dim() != ndim or x.dim() != 2:
        raise ValueError(f'{name}: x {tuple(x.shape)}, index '
                         f'{index.dtype}{tuple(index.shape)}')


def sparse_conv(x, nbr, w):
    """Neighbor-map sparse conv, (Vout, Cout) f32. See the module
    docstring."""
    if x.device.type == 'cpu':
        PLAIN_CALLS['sparse_conv'] += 1
        return sparse_conv_plain(x, nbr, w)
    _check('sparse_conv', x, nbr, 2)
    if w.device != x.device or w.dim() != 3 or w.shape[:2] != (
            nbr.shape[1], x.shape[1]):
        raise ValueError(f'sparse_conv: w {tuple(w.shape)} for x '
                         f'{tuple(x.shape)}, nbr {tuple(nbr.shape)}')
    if w.shape[2] % 16:
        raise ValueError(f'sparse_conv: cout {w.shape[2]} must be a multiple '
                         'of 16')
    from box2mask_torch.sparse import _build
    lib = _build.load('nmap_conv')
    xb, wb = pad_cin(_bf16(x), _bf16(w))
    nb = nbr.contiguous()
    out = torch.empty(nbr.shape[0], w.shape[2], dtype=torch.float32,
                      device=x.device)
    wp = torch.empty(wpack_numel(*wb.shape), dtype=torch.bfloat16,
                     device=x.device)
    with _build.on(x.device):
        stream = _build.stream(x.device)
        _launch(lib.b2m_nmap_conv, xb.data_ptr(), nb.data_ptr(),
                wb.data_ptr(), wp.data_ptr(), out.data_ptr(), nbr.shape[0],
                x.shape[0], nbr.shape[1], xb.shape[1], w.shape[2], stream)
    LAUNCHES['sparse_conv'] += 1
    return out


def gather_rows(x, idx):
    """Monotone row gather with bf16 rounding, (n, C) f32. See the module
    docstring."""
    if x.device.type == 'cpu':
        PLAIN_CALLS['gather_rows'] += 1
        return gather_rows_plain(x, idx)
    _check('gather_rows', x, idx, 1)
    if x.dtype != torch.float32:
        raise TypeError(f'gather_rows: x dtype {x.dtype}, expected float32')
    from box2mask_torch.sparse import _build
    fn = _build.load('nmap_conv').b2m_gather_rows
    xc, ic = x.contiguous(), idx.contiguous()   # no copy when contiguous
    out = torch.empty(idx.shape[0], x.shape[1], dtype=torch.float32,
                      device=x.device)
    with _build.on(x.device):
        _launch(fn, xc.data_ptr(), ic.data_ptr(), out.data_ptr(),
                idx.shape[0], x.shape[0], x.shape[1], _build.stream(x.device))
    LAUNCHES['gather_rows'] += 1
    return out


# ----------------------------------------------------------------- autograd
def sparse_conv_bwd(x, nbr, w, g, need_dx=True, need_dw=True):
    """(dx, dw) of sparse_conv for the output gradient g (Vout, Cout): JAX
    pallas_conv.py:123-141 _bwd in torch ops. dx is (Vin, Cin) in x's dtype
    (None unless need_dx), dw (K, Cin, Cout) in w's (None unless need_dw)."""
    vin, cin = x.shape
    xz = torch.cat([x, x.new_zeros(1, cin)])
    idx = torch.clamp(nbr.long(), max=vin)
    gb = g.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float()
    dx = (torch.zeros(vin + 1, cin, dtype=torch.float32, device=x.device)
          if need_dx else None)
    dws = []
    for k in range(nbr.shape[1]):
        ik = idx[:, k]
        if need_dw:
            dws.append(xz[ik].to(torch.bfloat16).float().T @ gb)
        if need_dx:
            dx.index_add_(0, ik, gb @ wb[k].T)
    return (dx[:vin].to(x.dtype) if need_dx else None,
            torch.stack(dws).to(w.dtype) if need_dw else None)


def mirrored_dx(nbr, x, w):
    """True for a same-level 3^3 conv (27 offsets, as many output rows as
    input rows) whose dx the forward kernel computes: its map is
    symmetric, so dx[u] = sum_k bf16(g[nbr[u, k]]) @ bf16(w[26 - k])^T, a
    sparse_conv of g over the same map with the mirrored, transposed
    weights (the offsets are x-major and centred: offset 26 - k is -offset
    k). The kernel needs Cin, its output width there, a multiple of 16."""
    return (nbr.shape[1] == 27 and nbr.shape[0] == x.shape[0]
            and w.shape[1] % 16 == 0)


class SparseConvFn(torch.autograd.Function):
    """sparse_conv with the JAX package's backward (sparse_conv_bwd); the dx
    of a same-level 3^3 conv is one more sparse_conv launch over the same
    map (mirrored_dx), as the key path computes its dx."""

    @staticmethod
    def forward(ctx, x, nbr, w):
        ctx.save_for_backward(x, nbr, w)
        return sparse_conv(x, nbr, w)

    @staticmethod
    def backward(ctx, g):
        x, nbr, w = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[0], ctx.needs_input_grad[2]
        if need_dx and mirrored_dx(nbr, x, w):
            dx = sparse_conv(g, nbr, w.flip(0).transpose(1, 2)).to(x.dtype)
            _, dw = sparse_conv_bwd(x, nbr, w, g, False, need_dw)
            return dx, None, dw
        dx, dw = sparse_conv_bwd(x, nbr, w, g, need_dx, need_dw)
        return dx, None, dw


def gather_rows_bwd(idx, g, n_rows):
    """dy (n_rows, C) of the row pick out[i] = y_z[idx[i]]: g summed into
    the rows it was picked from, the zero row n_rows dropped."""
    dy = g.new_zeros(n_rows + 1, g.shape[1])
    dy.index_add_(0, torch.clamp(idx.long(), max=n_rows), g)
    return dy[:n_rows]


class GatherRowsFn(torch.autograd.Function):
    """gather_rows with the gradient of the unrounded row pick."""

    @staticmethod
    def forward(ctx, y, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = y.shape[0]
        return gather_rows(y, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return gather_rows_bwd(idx, g.float(), ctx.n_rows), None
