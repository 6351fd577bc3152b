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
    output written once. A block owns 64 output rows x NT output channels,
    reads its rows' map column per offset, gathers the matched bf16 x rows
    into shared memory (zeros at the sentinel) and multiplies them with w[k]
    on the tensor cores (wmma, f32 accumulators in registers); a block vote
    skips an offset no row of the tile matched. It is the key-matching
    conv of csrc/key_conv.cu with the match read from the map instead of
    searched, and shares its gather and product device functions
    (csrc/conv_tile.cuh). The TPU kernel's union-window DMA, one-hot MXU
    gather and 128-lane channel padding have no part here.
  * gather_rows: a pure gather with a cast, bytes-bound (idx read once, the
    gathered f32 rows read and the f32 output written once). One warp per
    output row, 16-byte loads and stores, each value rounded f32 -> bf16 ->
    f32 in registers.

A wrapper takes the plain twin only for CPU tensors; on a CUDA tensor it
launches its kernel or raises. `LAUNCHES` counts kernel launches and
`PLAIN_CALLS` plain-twin calls, per kernel, as plain integers. Forward only:
the neighbor-map path does not train in the port yet (ROADMAP A18).
"""

from __future__ import annotations

import torch

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
    xb, wb = _bf16(x), _bf16(w)
    nb = nbr.contiguous()
    out = torch.empty(nbr.shape[0], w.shape[2], dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(lib.b2m_nmap_conv, xb.data_ptr(), nb.data_ptr(),
                wb.data_ptr(), out.data_ptr(), nbr.shape[0], x.shape[0],
                nbr.shape[1], x.shape[1], w.shape[2], stream)
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
    lib = _build.load('nmap_conv')
    xc = x.contiguous()
    if xc.data_ptr() % 16:
        xc = xc.clone()
    ic = idx.contiguous()
    out = torch.empty(idx.shape[0], x.shape[1], dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch(lib.b2m_gather_rows, xc.data_ptr(), ic.data_ptr(),
                out.data_ptr(), idx.shape[0], x.shape[0], x.shape[1], stream)
    LAUNCHES['gather_rows'] += 1
    return out
