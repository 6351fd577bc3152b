"""The masked batch norm + ReLU (+ residual) op of box2mask_torch
(sparse/masked_bn.py) on the CPU, where it takes its plain twin.

  * The twin against the formula it replaced in nn/modules.py, kept here
    (`formula`): forward and running statistics bit-equal, in f64 and in
    the working dtypes (bf16 and f32 x, bf16 and f32 y); the analytic
    backward against autograd through the formula in f64, within 1e-9 of
    each gradient's scale (the same function, another order of operations;
    where the clamp sits at 0, autograd's terms through rsqrt carry inv^2 =
    1/eps = 1e5 times the result and cancel, so its own f64 rounding
    reaches 1e-10 of the scale, elsewhere 1e-12). Cases:
    training and eval, ReLU and residual on and off, upstream gradient on
    the padded rows, no, one, some and every row valid, and one constant
    channel, whose variance clamp binds (v0 < 0) or sits at 0 (where the
    clamp passes the gradient).
  * With a process group (2 gloo ranks): the twin's forward and its
    backward's all-reduce of the two sums against autograd through the
    formula over ops.masked_moments' differentiable all-reduce, in f64.
  * One CPU train step of the small synthetic net: every BN goes through
    the twin once in the forward and once in the backward
    (tracing.counts()['masked_bn_plain']), and never through the kernels.
"""

import numpy as np
import pytest
import torch

from box2mask_torch import tracing
from box2mask_torch.engine import state as S
from box2mask_torch.nn.modules import MaskedBatchNorm
from box2mask_torch.sparse import masked_bn as MB
from box2mask_torch.sparse import ops
from test_torch_parallel_common import bn_group_worker, run_ranks
from test_torch_train_common import port_batch

ROWS, C = 48, 16
MOMENTUM, EPS = 0.1, 1e-5


def formula(x, valid, n_valid, scale, bias, rmean, rvar, training, update,
            relu, residual, out_dtype):
    """nn/modules.py MaskedBatchNorm.forward and the ReLU / residual add of
    its call sites before the fused op (f64 inputs computed in f64, as
    the twin does)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    if training:
        m = valid.to(acc)[:, None]
        xf = x.to(acc)
        s1 = (xf * m).sum(0)
        s2 = (xf.square() * m).sum(0)
        n = torch.clamp(n_valid.to(acc).reshape(()), min=1.0)
        mean = s1 / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        if update:
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                rmean.mul_(1 - MOMENTUM).add_(MOMENTUM * mean)
                rvar.mul_(1 - MOMENTUM).add_(MOMENTUM * unbiased)
    else:
        mean, var = rmean, rvar
    inv = torch.rsqrt(var + EPS)
    out = ((x - mean) * (inv * scale) + bias).to(out_dtype)
    if residual is not None:
        out = out + residual.to(out_dtype)
    return torch.relu(out) if relu else out


def inputs(n_valid, const, dtype, seed=0):
    """x, valid, scale, bias, running mean / var, residual and the upstream
    gradient G (nonzero on every row, padded ones too). Channel 0 of the
    valid rows is constant `const` (None: not constant)."""
    rng = np.random.default_rng(seed)
    valid = np.zeros(ROWS, bool)
    valid[rng.permutation(ROWS)[:n_valid]] = True
    x = rng.normal(0.5, 2.0, (ROWS, C))
    if const is not None:
        x[valid, 0] = const
    t = {'x': x, 'scale': rng.normal(1, 0.3, C), 'bias': rng.normal(0, 0.3, C),
         'rmean': rng.normal(0, 0.3, C), 'rvar': rng.uniform(0.5, 2, C),
         'res': rng.normal(0, 1, (ROWS, C)), 'G': rng.normal(0, 1, (ROWS, C))}
    t = {k: torch.tensor(v, dtype=dtype if k in ('x', 'res', 'G')
                         else torch.float64) for k, v in t.items()}
    return t, torch.from_numpy(valid), torch.tensor(n_valid, dtype=torch.int32)


# v0 = s2/n - mean^2 of a constant channel over SOME of inputs()' rows, f64:
# 0.3 rounds below 0 (the clamp binds), 1.3 to exactly 0 (the clamp passes;
# so does a single valid row)
CONST_BINDS, CONST_ZERO, SOME = 0.3, 1.3, 29


@pytest.mark.parametrize('relu,residual', [(True, True), (True, False),
                                           (False, False), (False, True)])
@pytest.mark.parametrize('n_valid,const', [(0, None), (1, CONST_BINDS),
                                           (SOME, CONST_BINDS),
                                           (SOME, CONST_ZERO),
                                           (ROWS, None)])
@pytest.mark.parametrize('training', [True, False])
def test_twin_matches_formula_and_its_autograd(training, n_valid, const,
                                               relu, residual):
    f64 = torch.float64
    t, valid, nv = inputs(n_valid, const, f64)
    if const is not None:
        v0 = float(MB.moments(t['x'], valid, nv)[1][0])
        assert v0 < 0 if (const, n_valid) == (CONST_BINDS, SOME) else v0 == 0
    grads = []
    stats = []
    for fn in ('formula', 'twin'):
        x = t['x'].clone().requires_grad_(True)
        scale = t['scale'].clone().requires_grad_(True)
        bias = t['bias'].clone().requires_grad_(True)
        res = t['res'].clone().requires_grad_(True) if residual else None
        rmean, rvar = t['rmean'].clone(), t['rvar'].clone()
        if fn == 'formula':
            y = formula(x, valid, nv, scale, bias, rmean, rvar, training,
                        True, relu, res, f64)
        else:
            y = MB.bn_act(x, valid, nv, scale, bias, rmean, rvar,
                          training=training, momentum=MOMENTUM, eps=EPS,
                          relu=relu, residual=res, out_dtype=f64)
        (y * t['G']).sum().backward()
        grads.append([y.detach()] + [v.grad for v in (x, scale, bias, res)
                                     if v is not None])
        stats.append((rmean, rvar))
    (want_y, *want_g), (got_y, *got_g) = grads
    assert torch.equal(got_y, want_y)
    for got, want in zip(stats[1], stats[0]):
        assert torch.equal(got, want)
    for got, want in zip(got_g, want_g):
        scale_ = max(float(want.abs().max()), 1e-30)
        assert float((got - want).abs().max()) <= 1e-9 * scale_
    # the working dtypes: bf16 / f32 x into bf16 / f32 y, bit-equal
    for xd, yd in ((torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.bfloat16),
                   (torch.float32, torch.float32)):
        outs = []
        for fn in ('formula', 'twin'):
            x = t['x'].to(xd)
            res = t['res'].to(yd) if residual else None
            p = {k: t[k].float().clone() for k in ('scale', 'bias', 'rmean',
                                                   'rvar')}
            with torch.no_grad():
                if fn == 'formula':
                    y = formula(x, valid, nv, p['scale'], p['bias'],
                                p['rmean'], p['rvar'], training, True, relu,
                                res, yd)
                else:
                    y = MB.bn_act(x, valid, nv, p['scale'], p['bias'],
                                  p['rmean'], p['rvar'], training=training,
                                  relu=relu, residual=res, out_dtype=yd)
            outs.append((y, p['rmean'], p['rvar']))
        for got, want in zip(outs[1], outs[0]):
            assert got.dtype == want.dtype and torch.equal(got, want)


def test_frozen_stats_leave_running_statistics():
    t, valid, nv = inputs(SOME, None, torch.float32)
    bn = MaskedBatchNorm(C)
    bn.update_stats = False
    before = (bn.mean.clone(), bn.var.clone())
    bn(t['x'], valid, nv, relu=True)
    assert torch.equal(bn.mean, before[0]) and torch.equal(bn.var, before[1])
    bn.update_stats = True
    bn(t['x'], valid, nv, relu=True)
    assert not torch.equal(bn.mean, before[0])


def test_group_backward_matches_autograd_through_all_reduce(tmp_path):
    """Rank r's y, dx, dscale, dbias and dresidual from the twin with the
    group against autograd through the formula with ops.masked_moments'
    differentiable all-reduce, f64, 1e-12 of each gradient's scale; the
    running statistics equal on both ranks."""
    got = run_ranks(bn_group_worker, 2, tmp_path)
    for r in range(2):
        for k, (mine, ref) in got[r].items():
            if k.startswith('run'):
                assert torch.equal(mine, ref), (r, k)
                continue
            err = float((mine - ref).abs().max())
            assert err <= 1e-12 * max(float(ref.abs().max()), 1e-30), (r, k)
    assert torch.equal(got[0]['run_mean'][0], got[1]['run_mean'][0])


def test_train_step_goes_through_the_twin_once_per_bn():
    pc, dev = port_batch([])
    batch = {k: torch.from_numpy(np.asarray(a)) for k, a in dev.items()}
    model = S.build_model(pc, 20, 'cpu')
    state = S.init_state(pc, model, S.make_optimizer(pc))
    n_bn = sum(isinstance(m, MaskedBatchNorm) for m in model.modules())
    tracing.reset_counts()
    S.train_step(pc, state, batch, 1e-3, 1.0, 1.0)
    counts = tracing.counts()
    assert counts['masked_bn_plain'] == {'fwd_train': n_bn, 'fwd_eval': 0,
                                         'bwd': n_bn}
    assert not any(counts['masked_bn'].values())
    tracing.reset_counts()
    assert not any(tracing.counts()['masked_bn_plain'].values())
    assert n_bn == 61      # --layers 1: 28 block BNs fewer than the 89 of 2


def test_moments_reference_is_the_twins_formula():
    t, valid, nv = inputs(SOME, CONST_BINDS, torch.float32)
    mean, var, n = ops.masked_moments(t['x'], valid, nv)
    m2, v0, n2 = MB.moments(t['x'], valid, nv)
    assert torch.equal(mean, m2) and torch.equal(n, n2)
    assert torch.equal(var, torch.clamp(v0, min=0.0))
