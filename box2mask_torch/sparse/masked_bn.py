"""Masked batch norm + ReLU (+ residual) as one op, forward and backward:
CUDA kernels (csrc/masked_bn.cu) and their plain PyTorch twin.

    y = act( (x - mean) * (rsqrt(var + eps) * scale) + bias  [+ residual] )

act is ReLU or the identity, as the network's structure fixes it at each
call site (nn/modules.py). In training, mean and var are the moments of the
valid rows only (padding excluded exactly; with a process `group`, of every
rank's valid rows: SyncBatchNorm, the JAX package's axis_name), and the
running statistics move with torch-style momentum and the unbiased
correction unless `update_stats` is off (a rematerialized block's
recomputation, nn/unet.py); in eval they are the running statistics.
Every row is normalized, padded rows too. y is rounded to `out_dtype`
after the normalization and again after the residual add, as the module's
formula did (a sum of two tensors of that dtype). Port of
box2mask_tpu/nn/modules.py MaskedBatchNorm and the ReLU / residual add
around it (sparse/ops.py masked_moments); no Pallas kernel corresponds,
the JAX package leaves batch norm to XLA.

The backward is the formula's gradient written out (f32 throughout):

    g' = g * [y > 0] (or g),  xhat = (x - mean) * inv,  a = inv * scale
    dbias = sum g',  dscale = sum g' * xhat        over every row, rank-local
    dx = a g' - valid * a / n * (Sg' + xhat * Sg'xhat * [v0 >= 0])
    dresidual = g'

where S are the same two sums over every row of every rank (with a group
one all-reduce, as autograd's all-reduce backward gave the moments'
cotangent), n = max(valid rows of every rank, 1), and v0 = s2/n - mean^2
before the clamp at 0 (the clamp passes the gradient where v0 >= 0, as
torch.clamp's does). Padded rows' g enters the sums, since the forward
normalizes them with the batch moments. In eval, dx = a g'.

Saved for the backward: x in its own dtype, y (under ReLU: the next conv
holds the same tensor), the valid mask and per-channel f32 statistics
[mean, inv, clamp flags, n]; no f32 rows x channels tensor.

`bn_act` takes the plain twin only for CPU tensors; on a CUDA tensor it
launches the kernels or raises. `LAUNCHES` counts the calls that went
through the kernels and `PLAIN_CALLS` the plain twin's, per mode (a call
is 2-3 kernel launches: fwd_train sums, reduce (+ finalize after a group's
all-reduce), normalize; fwd_eval normalize; bwd sums, reduce, dx).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

MODES = ('fwd_train', 'fwd_eval', 'bwd')
LAUNCHES = dict.fromkeys(MODES, 0)
PLAIN_CALLS = dict.fromkeys(MODES, 0)

# partial sums: one wave of up to 4 blocks per SM of the H100's 132, each
# over a chunk of at least 256 rows
PARTS_MAX = 4 * 132
PART_ROWS = 256
MAX_C = 1024            # csrc/masked_bn.cu MAXC


def reset_counts():
    for d in (LAUNCHES, PLAIN_CALLS):
        for m in MODES:
            d[m] = 0


class Cfg(NamedTuple):
    training: bool
    update_stats: bool
    momentum: float
    eps: float
    relu: bool
    out_dtype: torch.dtype
    group: object


def _acc(dtype):
    """The twin's arithmetic dtype: f32, f64 for f64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def all_reduce_(t, group):
    dist.all_reduce(t, group=group)
    return t


def moments(x, valid, n_valid, group=None, all_reduce=all_reduce_):
    """The plain formula's masked moments: (mean, v0, n) with v0 = s2/n -
    mean^2 before its clamp at 0 and n = max(count, 1), the sums s1, s2 of
    the valid rows and their count summed over `group` by `all_reduce`."""
    acc = _acc(x.dtype)
    m = valid.to(acc)[:, None]
    xf = x.to(acc)
    s1 = (xf * m).sum(0)
    s2 = (xf.square() * m).sum(0)
    n = n_valid.to(acc).reshape(1)
    if group is not None:
        c = s1.shape[0]
        s1, s2, n = all_reduce(torch.cat([s1, s2, n]), group).split([c, c, 1])
    n = torch.clamp(n.reshape(()), min=1.0)
    mean = s1 / n
    return mean, s2 / n - mean.square(), n


# ------------------------------------------------------------- plain twin
def forward_plain(x, scale, bias, residual, valid, n_valid, rmean, rvar,
                  cfg):
    """The formula, op by op: (y, stats), stats = [mean, inv, clamp flags,
    n] in training, None in eval."""
    stats = None
    if cfg.training:
        mean, v0, n = moments(x, valid, n_valid, cfg.group)
        var = torch.clamp(v0, min=0.0)
        if cfg.update_stats:
            m = cfg.momentum
            unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
            rmean.mul_(1 - m).add_(m * mean)
            rvar.mul_(1 - m).add_(m * unbiased)
        inv = torch.rsqrt(var + cfg.eps)
        stats = torch.cat([mean, inv, (v0 >= 0).to(mean.dtype),
                           n.reshape(1)])
    else:
        mean, inv = rmean, torch.rsqrt(rvar + cfg.eps)
    y = ((x - mean) * (inv * scale) + bias).to(cfg.out_dtype)
    if residual is not None:
        y = y + residual.to(cfg.out_dtype)
    return (torch.relu(y) if cfg.relu else y), stats


def backward_plain(g, x, y, valid, scale, stats, rmean, rvar, cfg):
    """(dx, dscale, dbias, g') by the analytic gradient of the module
    docstring."""
    acc = _acc(x.dtype)
    c = x.shape[1]
    if stats is not None:
        mean, inv, ok, n = stats[:c], stats[c:2 * c], stats[2 * c:3 * c], \
            stats[3 * c]
    else:
        mean, inv = rmean, torch.rsqrt(rvar + cfg.eps)
    gp = torch.where(y > 0, g, 0) if cfg.relu else g
    gf = gp.to(acc)
    xhat = (x.to(acc) - mean) * inv
    sums = torch.cat([gf.sum(0), (gf * xhat).sum(0)])
    dbias, dscale = sums[:c], sums[c:]
    if stats is not None and cfg.group is not None:
        sums = all_reduce_(sums.clone(), cfg.group)
    a = inv * scale
    dx = gf * a
    if stats is not None:
        an = a / n
        dx = dx - valid.to(acc)[:, None] * (an * sums[:c]
                                            + xhat * (an * sums[c:] * ok))
    return dx.to(x.dtype), dscale, dbias, gp


# ----------------------------------------------------------------- kernels
def _aligned(t):
    """t contiguous, its data 16-byte aligned (the kernels move 16 bytes at
    a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(g):
    """(g, its row stride) with unit channel stride, 8-element row stride
    and 16-byte alignment: a slice of a concat's gradient as it comes."""
    if (g.stride(1) != 1 or g.stride(0) % 8 or g.stride(0) < g.shape[1]
            or g.data_ptr() % 16):
        g = g.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
    return g, g.stride(0)


def _parts(rows):
    """Blocks of a partial-sums launch."""
    return max(1, min(PARTS_MAX, -(-rows // PART_ROWS)))


def _check_cuda(x, scale, bias, residual, valid, n_valid, rmean, rvar, cfg):
    if x.dim() != 2:
        raise ValueError(f'bn_act: x must be (rows, c), got {tuple(x.shape)}')
    rows, c = x.shape
    if c % 8 or c > MAX_C:
        raise ValueError(f'bn_act: channels {c} must be a multiple of 8 and '
                         f'at most {MAX_C}')
    for name, dt in (('x', x.dtype), ('out_dtype', cfg.out_dtype)):
        if dt not in (torch.float32, torch.bfloat16):
            raise TypeError(f'bn_act: {name} dtype {dt}')
    for name, t in (('scale', scale), ('bias', bias), ('mean', rmean),
                    ('var', rvar)):
        if t.dtype != torch.float32 or t.shape != (c,):
            raise ValueError(f'bn_act: {name} must be f32 ({c},)')
    tensors = [scale, bias, rmean, rvar, valid, n_valid]
    if residual is not None:
        if residual.shape != x.shape:
            raise ValueError('bn_act: residual shape differs from x')
        tensors.append(residual)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f'bn_act: a tensor on {t.device}, x on '
                             f'{x.device}')
    if (valid.shape != (rows,) or valid.dtype != torch.bool
            or not valid.is_contiguous()):
        raise ValueError('bn_act: valid must be contiguous bool (rows,)')
    if n_valid.numel() != 1 or n_valid.dtype not in (torch.int32,
                                                     torch.int64):
        raise ValueError('bn_act: n_valid must be one integer')


def _launch(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f'{fn.__name__} launch failed: cudaError {rc}')


def _stat_ptrs(stats, rmean, rvar, c):
    """(mean, inv-or-var pointer, from_var) of the kernels' normalization:
    the batch statistics, or the running ones in eval."""
    if stats is not None:
        return stats.data_ptr(), stats.data_ptr() + 4 * c, 0
    return rmean.data_ptr(), rvar.data_ptr(), 1


def forward_cuda(x, scale, bias, residual, valid, n_valid, rmean, rvar, cfg):
    """forward_plain's (y, stats) from the kernels: x 16-byte aligned and
    contiguous, valid contiguous."""
    from box2mask_torch.sparse import _build
    _check_cuda(x, scale, bias, residual, valid, n_valid, rmean, rvar, cfg)
    lib = _build.load('masked_bn')
    rows, c = x.shape
    dev = x.device
    y = torch.empty(rows, c, dtype=cfg.out_dtype, device=dev)
    res = None if residual is None else _aligned(residual.to(cfg.out_dtype))
    stats = None
    m, keep, eps = cfg.momentum, 1 - cfg.momentum, cfg.eps
    with _build.on(dev):
        s = _build.stream(dev)
        if cfg.training:
            P = _parts(rows)
            part = torch.empty(P, 2 * c, dtype=torch.float32, device=dev)
            stats = torch.empty(3 * c + 1, dtype=torch.float32, device=dev)
            nv = n_valid.reshape(1).to(torch.int32)
            upd = int(bool(cfg.update_stats))
            _launch(lib.b2m_bn_sums, x.data_ptr(), valid.data_ptr(),
                    part.data_ptr(), rows, c, int(x.dtype == torch.bfloat16),
                    P, s)
            if cfg.group is None:
                _launch(lib.b2m_bn_reduce, part.data_ptr(), P, c,
                        nv.data_ptr(), None, stats.data_ptr(),
                        rmean.data_ptr(), rvar.data_ptr(), 1, upd, m, keep,
                        eps, s)
            else:
                sums = torch.empty(2 * c + 1, dtype=torch.float32,
                                   device=dev)
                _launch(lib.b2m_bn_reduce, part.data_ptr(), P, c,
                        nv.data_ptr(), sums.data_ptr(), None, None, None, 0,
                        0, m, keep, eps, s)
                dist.all_reduce(sums, group=cfg.group)
                _launch(lib.b2m_bn_finalize, sums.data_ptr(), c,
                        stats.data_ptr(), rmean.data_ptr(), rvar.data_ptr(),
                        upd, m, keep, eps, s)
        mean_p, istat_p, from_var = _stat_ptrs(stats, rmean, rvar, c)
        _launch(lib.b2m_bn_norm, x.data_ptr(),
                None if res is None else res.data_ptr(), y.data_ptr(),
                mean_p, istat_p, scale.data_ptr(), bias.data_ptr(), rows, c,
                int(x.dtype == torch.bfloat16),
                int(cfg.out_dtype == torch.bfloat16), int(bool(cfg.relu)),
                from_var, eps, s)
    LAUNCHES['fwd_train' if cfg.training else 'fwd_eval'] += 1
    return y, stats


def backward_cuda(g, x, y, valid, scale, stats, rmean, rvar, cfg, *,
                  need_res):
    """backward_plain's (dx, dscale, dbias, g') from the kernels, g' only
    when `need_res`; x, valid as forward_cuda took them."""
    from box2mask_torch.sparse import _build
    lib = _build.load('masked_bn')
    rows, c = x.shape
    dev = x.device
    g, ldg = _rows(g)
    P = _parts(rows)
    part = torch.empty(P, 2 * c, dtype=torch.float32, device=dev)
    sums = torch.empty(2 * c, dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dres = torch.empty(rows, c, dtype=g.dtype, device=dev) if need_res \
        else None
    mean_p, istat_p, from_var = _stat_ptrs(stats, rmean, rvar, c)
    xb, yb = int(x.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16)
    relu = int(bool(cfg.relu))
    y_p = y.data_ptr() if cfg.relu else None
    with _build.on(dev):
        s = _build.stream(dev)
        _launch(lib.b2m_bn_bwd_sums, g.data_ptr(), y_p, x.data_ptr(), mean_p,
                istat_p, part.data_ptr(), rows, c, ldg, xb, yb, relu,
                from_var, cfg.eps, P, s)
        _launch(lib.b2m_bn_reduce, part.data_ptr(), P, c, None,
                sums.data_ptr(), None, None, None, 0, 0, 0.0, 0.0, 0.0, s)
        dbias, dscale = sums[:c], sums[c:]
        if stats is not None and cfg.group is not None:
            local = sums.clone()
            dbias, dscale = local[:c], local[c:]
            dist.all_reduce(sums, group=cfg.group)
        batch = stats is not None
        _launch(lib.b2m_bn_dx, g.data_ptr(), y_p, x.data_ptr(),
                valid.data_ptr(), mean_p, istat_p, scale.data_ptr(),
                sums.data_ptr(),
                stats.data_ptr() + 8 * c if batch else None,
                stats.data_ptr() + 12 * c if batch else None,
                dx.data_ptr(), None if dres is None else dres.data_ptr(),
                rows, c, ldg, xb, yb, relu, from_var, cfg.eps, int(batch), s)
    LAUNCHES['bwd'] += 1
    return dx, dscale, dbias, dres


# ---------------------------------------------------------------- autograd
class _BnAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, residual, valid, n_valid, rmean, rvar,
                cfg):
        if x.device.type == 'cpu':
            PLAIN_CALLS['fwd_train' if cfg.training else 'fwd_eval'] += 1
            y, stats = forward_plain(x, scale, bias, residual, valid,
                                     n_valid, rmean, rvar, cfg)
        elif x.device.type == 'cuda':
            x, valid = _aligned(x), valid.contiguous()
            y, stats = forward_cuda(x, scale, bias, residual, valid, n_valid,
                                    rmean, rvar, cfg)
        else:
            raise ValueError(f'bn_act: unsupported device {x.device}')
        ctx.cfg = cfg
        ctx.res_dtype = None if residual is None else residual.dtype
        # eval saves the running statistics: an in-place update before the
        # backward would fail autograd's version check
        ctx.save_for_backward(x, y if cfg.relu else None, valid, scale, stats,
                              None if cfg.training else rmean,
                              None if cfg.training else rvar)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y, valid, scale, stats, rmean, rvar = ctx.saved_tensors
        cfg = ctx.cfg
        need_res = ctx.needs_input_grad[3]
        if g.device.type == 'cpu':
            PLAIN_CALLS['bwd'] += 1
            dx, dscale, dbias, dres = backward_plain(
                g, x, y, valid, scale, stats, rmean, rvar, cfg)
        else:
            dx, dscale, dbias, dres = backward_cuda(
                g, x, y, valid, scale, stats, rmean, rvar, cfg,
                need_res=need_res)
        dres = dres.to(ctx.res_dtype) if need_res else None
        return (dx, dscale.to(scale.dtype), dbias.to(scale.dtype), dres,
                None, None, None, None, None)


def bn_act(x, valid, n_valid, scale, bias, mean, var, *, training,
           update_stats=True, momentum=0.1, eps=1e-5, relu=False,
           residual=None, out_dtype=None, group=None):
    """Masked batch norm of x (rows, c) with scale, bias and the running
    statistics mean, var (moved in place in training unless
    `update_stats` is off), then `residual` added and ReLU where asked; y in
    `out_dtype` (default x's). See the module docstring."""
    cfg = Cfg(bool(training), bool(update_stats), float(momentum),
              float(eps), bool(relu), out_dtype or x.dtype,
              group if training else None)
    return _BnAct.apply(x, scale, bias, residual, valid, n_valid, mean, var,
                        cfg)
