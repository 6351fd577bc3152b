"""Shared setup of tests/test_torch_parallel.py: gloo ranks on the CPU, each a
spawned process running a function of this module (workers pickle by
import path, so they live here and import torch and the port only, never
JAX), and the unrounded conv twins that the train-step tests use.

run_ranks(fn, world, tmp_path, *args) starts `world` processes; rank r
joins a gloo group through a file in tmp_path (no ports shared between
pytest-xdist workers), calls fn(rank, world, group, *args) at one torch
thread, and its result comes back through torch.save. Every rendezvous,
collective and join is bounded by TIMEOUT_S, so a rank that hangs fails
the test.
"""

import faulthandler
import os
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

from box2mask_torch.engine import state as S
from box2mask_torch.parallel import mesh as M
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import ops

TIMEOUT_S = 90.0


def patch_unrounded(setattr_):
    """Every key conv and dw through its plain twin on unrounded f32
    operands, x kept unrounded for the backward (`setattr_(obj, name,
    value)`: a monkeypatch's setattr, or setattr in a worker)."""
    f32 = dict(operand_dtype=torch.float32)
    setattr_(KC, 'SAVED_X_DTYPE', torch.float32)
    setattr_(KC, 'key_conv', lambda x, kin, kout, w, **kw: (
        KC.key_conv_plain(x, kin, kout, w, **f32, **kw)))
    setattr_(KC, 'key_conv_stem', lambda x, kin, w: (
        KC.key_conv_plain(x, kin, kin.reshape(-1), w, kernel_size=5,
                          out_dtype=torch.float32, **f32)))
    setattr_(KC, 'key_conv_dw', lambda x, g, kin, kout, **kw: (
        KC.key_conv_dw_plain(x, g, kin, kout, **f32, **kw)))
    setattr_(KC, 'key_conv_stem_dw', lambda x, g, kin: (
        KC.key_conv_dw_plain(x, g, kin, kin.reshape(-1), kernel_size=5,
                             **f32)))


def _entry(rank, world, init, out_dir, fn, args):
    torch.set_num_threads(1)
    # a rank that hangs writes its stack before the join gives up on it
    hang = open(os.path.join(out_dir, f'rank{rank}.hang'), 'w')
    faulthandler.dump_traceback_later(TIMEOUT_S - 10, exit=True, file=hang)
    try:
        group = M.init_data_parallel(rank, world, 'gloo', init, 'cpu',
                                     timeout=TIMEOUT_S)
        try:
            res = fn(rank, world, group, *args)
        finally:
            M.teardown()
        torch.save(res, os.path.join(out_dir, f'rank{rank}.pt'))
    except BaseException:
        with open(os.path.join(out_dir, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn, world, tmp_path, *args):
    """fn(rank, world, group, *args) on `world` gloo ranks; the list of
    their results by rank."""
    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    init = 'file://' + os.path.join(out_dir, 'rendezvous')
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=_entry, args=(r, world, init, out_dir, fn,
                                              args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(5)
    errs = []
    for r in range(world):
        for what in ('err', 'hang'):
            path = os.path.join(out_dir, f'rank{r}.{what}')
            if os.path.exists(path) and os.path.getsize(path):
                with open(path) as f:
                    errs.append(f'rank {r} ({what}):\n{f.read()}')
    assert not hung, f'{len(hung)} ranks still running after {TIMEOUT_S} s'
    assert not errs and all(p.exitcode == 0 for p in procs), '\n'.join(errs)
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ workers
def moments_worker(rank, world, group, x, valid, n_valid, a, b):
    """Rank `rank`'s masked_moments over the group and the x-grad of its
    loss sum(a * mean + b * var) (its own a, b)."""
    x = torch.from_numpy(x[rank]).requires_grad_(True)
    mean, var, n = ops.masked_moments(x, torch.from_numpy(valid[rank]),
                                      torch.tensor(n_valid[rank]), group)
    loss = (torch.from_numpy(a[rank]) * mean
            + torch.from_numpy(b[rank]) * var).sum()
    loss.backward()
    return {'mean': mean.detach().numpy(), 'var': var.detach().numpy(),
            'n': float(n), 'dx': x.grad.numpy()}


def bn_group_worker(rank, world, group):
    """Rank `rank`'s masked BN + residual + ReLU over the group, f64, each
    rank with its own rows: y and the grads of sum(G * y) from the op's
    plain twin and from autograd through the formula over
    ops.masked_moments' differentiable all-reduce, by name as (op,
    formula); the running statistics the same way."""
    from box2mask_torch.sparse import masked_bn as MB
    rows, c = 40, 16
    rng = np.random.default_rng(100 + rank)
    n_valid = (31, 12)[rank]
    valid = torch.from_numpy(np.arange(rows) < n_valid)
    nv = torch.tensor(n_valid, dtype=torch.int32)
    vals = {k: torch.from_numpy(rng.normal(mu, sd, shape)) for k, mu, sd,
            shape in (('x', 1, 3, (rows, c)), ('res', 0, 1, (rows, c)),
                      ('G', 0, 1, (rows, c)))}
    shared = np.random.default_rng(7)
    scale0 = torch.from_numpy(shared.normal(1, 0.3, c))
    bias0 = torch.from_numpy(shared.normal(0, 0.3, c))
    out = {}
    for side in ('op', 'formula'):
        x = vals['x'].clone().requires_grad_(True)
        res = vals['res'].clone().requires_grad_(True)
        scale = scale0.clone().requires_grad_(True)
        bias = bias0.clone().requires_grad_(True)
        rmean = torch.zeros(c, dtype=torch.float64)
        rvar = torch.ones(c, dtype=torch.float64)
        if side == 'op':
            y = MB.bn_act(x, valid, nv, scale, bias, rmean, rvar,
                          training=True, relu=True, residual=res,
                          group=group)
        else:
            mean, var, n = ops.masked_moments(x, valid, nv, group)
            with torch.no_grad():
                unbiased = var * n / torch.clamp(n - 1.0, min=1.0)
                rmean.mul_(0.9).add_(0.1 * mean)
                rvar.mul_(0.9).add_(0.1 * unbiased)
            y = torch.relu((x - mean) * (torch.rsqrt(var + 1e-5) * scale)
                           + bias + res)
        (y * vals['G']).sum().backward()
        for k, v in (('y', y.detach()), ('dx', x.grad), ('dres', res.grad),
                     ('dscale', scale.grad), ('dbias', bias.grad),
                     ('run_mean', rmean), ('run_var', rvar)):
            out.setdefault(k, []).append(v)
    return {k: tuple(v) for k, v in out.items()}


def to_torch(dev):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in dev.items()}


def dp_step_worker(rank, world, group, cfg, shards, state_dict, lr, bb_w,
                   cs_w, unrounded):
    """One data-parallel train step of rank `rank` on its shard from the
    weights `state_dict` (rank 0's, broadcast): the averaged loss dict,
    the averaged grads, the parameters and BN buffers after the update,
    and the replica check; before it, the data-parallel val losses and
    the rank's own."""
    if unrounded:
        patch_unrounded(setattr)
    model = S.build_model(cfg, 20, 'cpu', group=group)
    if rank == 0:
        model.load_state_dict(state_dict)
    tx = S.make_optimizer(cfg)
    state = S.TrainState(model, tx, tx.init(list(model.parameters())))
    M.broadcast_state(state, group)
    batch = to_torch(shards[rank])
    val = M.make_parallel_val_step(cfg, group)(state, batch, bb_w, cs_w)
    own = S.make_val_step(cfg)(state, batch, bb_w, cs_w)
    names = [n for n, _ in model.named_parameters()]
    grads = {}
    apply_update = S.apply_update

    def record(state, lr):
        grads.update({n: p.grad.numpy().copy()
                      for n, p in zip(names, state.params)})
        return apply_update(state, lr)
    S.apply_update = record
    try:
        step = M.make_parallel_train_step(cfg, group)
        _, ld = step(state, batch, lr, bb_w, cs_w)
    finally:
        S.apply_update = apply_update
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    M.check_replicas(state, group)
    return {'loss': {k: float(v) for k, v in ld.items()}, 'grads': grads,
            'val': {k: v.numpy() for k, v in val.items()},
            'val_own': {k: v.numpy() for k, v in own.items()},
            'params': {k: sd[k] for k in names},
            'stats': {k: v for k, v in sd.items() if k not in names}}


class _Stop(Exception):
    pass


def remat_worker(rank, world, group, cfg, rows):
    """The rows the Trainer of rank `rank` hands the auto-remat rule
    (config.needs_remat) when its first batch holds rows[rank] level-0
    rows; stops there."""
    from box2mask_torch.datasets.loader import get_dataset
    from box2mask_torch.engine import train as T
    seen = []

    def needs_remat(n, bf16_acts=False):
        seen.append(n)
        raise _Stop
    T.needs_remat = needs_remat
    t = T.Trainer(cfg, get_dataset(cfg, 'train'), None, device='cpu',
                  rank=rank, world_size=world, group=group)
    try:
        t._ensure_state({'valid0': torch.zeros(rows[rank], dtype=torch.bool)})
    except _Stop:
        pass
    return seen
