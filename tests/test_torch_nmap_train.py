"""Training on the neighbor-map path (--key_conv off, --key_conv eval in
mode 'train', host-maps batches) against the JAX package.

  * SparseConvFn's backward (sparse/pallas_conv.py sparse_conv_bwd) against
    the JAX package's custom VJP, pallas_conv._bwd, called directly on the
    same residuals and output gradient: at K = 125 (stem), 27 and 8, with
    sentinel entries, all-sentinel padding rows and cin off a multiple of 8
    (and, for the 3^3 conv's dx by the forward kernel, cin 32).
    Both sides multiply the same bf16-rounded operands exactly in f32 and
    sum in f32 in another order (the 3^3 conv's dx as a sparse_conv over
    the same map with mirrored weights, mirrored_dx): dw and an f32 dx
    within 2e-5 of the tensor's max |value| (sums of <= 512 rows); a bf16
    dx (cast from those sums) within one bf16 rounding, 2^-8 of each
    value, plus that.
  * GatherRowsFn's backward against jax.vjp of the row pick it replaces
    (the XLA route's take over y with a zero row): bit-equal, as every y
    row is picked at most once. jax.grad of the JAX package's own
    gather_rows raises (its pallas_call has no reverse-mode rule).
  * One train step of the port's neighbor-map path against the JAX
    package's, from equal parameters on an equal batch: unrounded
    (--compute_dtype float32, the ops' XLA formulation on both sides) at the
    bounds of tests/test_torch_train_step.py; and under --pallas_conv on
    (the kernels' twins and the autograd Functions) with --bf16_acts
    against the JAX XLA route with --bf16_acts (the JAX package cannot
    differentiate its --pallas_conv on step) at the bounds of
    tests/test_torch_train_step_bf16.py: the two differ by the bf16
    rounding of the up convs' y and by the roundings of their backwards.
  * A host-maps batch holding a scene past 1024 voxels on an axis, and a
    --key_conv eval batch in mode 'train', each take a step with finite
    losses, on the neighbor-map path only.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu.sparse import pallas_conv as JPC
from box2mask_torch import config as PC
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine import state as S
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import ops
from box2mask_torch.sparse import pallas_conv as PCV
from test_torch_pallas_conv import make_case
from test_torch_train_common import (ARGS, LOSS_KEYS, LRS, SCENE, jax_run,
                                     l2_rel, moved_share, port_run, rel_err)
from test_torch_train_step_bf16 import cosine

F32_TOL = 2e-5
CONVS = {  # map, rows of the output's valid count, cin, cout
    'stem': ('nmap5_0', 'num0', 6, 32),
    'same3': ('nmap3_0', 'num0', 20, 48),       # dx by index_add_
    'same3_mirrored': ('nmap3_0', 'num0', 32, 48),  # dx by sparse_conv
    'down': ('down0', 'num1', 13, 32)}


def bwd_inputs(kind, seed):
    b, rng = make_case(seed)
    key, rows, cin, cout = CONVS[kind]
    nbr = b[key]
    V = b['coords0'].shape[0]
    x = rng.normal(size=(V, cin)).astype(np.float32)
    x[~b['valid0']] = 0
    w = (rng.normal(size=(nbr.shape[1], cin, cout)) * 0.2).astype(np.float32)
    g = rng.normal(size=(nbr.shape[0], cout)).astype(np.float32)
    g[int(b[rows]):] = 0            # padding rows: no gradient arrives
    assert (nbr == V).any() and (nbr == V).all(1).any()
    return x, nbr, w, g, int(b['num0'])


def assert_close(got, want, bf16=False):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0.1 and got.shape == want.shape
    tol = F32_TOL * scale + (2.0 ** -8 * np.abs(want) if bf16 else 0.0)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


@pytest.mark.parametrize('xdtype', ['f32', 'bf16'])
@pytest.mark.parametrize('kind', list(CONVS))
def test_sparse_conv_fn_backward_matches_jax_bwd(kind, xdtype):
    x, nbr, w, g, n_in = bwd_inputs(kind, seed=5)
    jdt, tdt = {'f32': (jnp.float32, torch.float32),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[xdtype]
    jdx, _, jdw = JPC._bwd((jnp.asarray(x, jdt), jnp.asarray(nbr),
                            jnp.asarray(w)), jnp.asarray(g))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    assert PCV.mirrored_dx(torch.from_numpy(nbr), tx, tw) == (
        kind == 'same3_mirrored')
    out = PCV.SparseConvFn.apply(tx, torch.from_numpy(nbr), tw)
    assert torch.equal(out.detach(), PCV.sparse_conv_plain(
        tx.detach(), torch.from_numpy(nbr), tw.detach()))
    out.backward(torch.from_numpy(g))
    assert tx.grad.dtype == tdt and tw.grad.dtype == torch.float32
    assert_close(tx.grad, jdx.astype(jnp.float32), bf16=xdtype == 'bf16')
    assert_close(tw.grad, jdw)
    assert not tx.grad[n_in:].any()        # padding rows are no neighbor


def test_sparse_conv_fn_skips_dx_of_data():
    """The stem's input is data: no dx is formed, dw is unchanged."""
    x, nbr, w, g, _ = bwd_inputs('stem', seed=6)
    dx, dw = PCV.sparse_conv_bwd(*(torch.from_numpy(a) for a in (x, nbr, w,
                                                                   g)))
    tw = torch.from_numpy(w).requires_grad_()
    PCV.SparseConvFn.apply(torch.from_numpy(x), torch.from_numpy(nbr),
                           tw).backward(torch.from_numpy(g))
    assert dx is not None and torch.equal(tw.grad, dw)
    none, _ = PCV.sparse_conv_bwd(*(torch.from_numpy(a) for a in (x, nbr, w,
                                                                    g)),
                                  need_dx=False)
    assert none is None


@pytest.mark.parametrize('cout', [16, 96])
def test_gather_rows_fn_backward_matches_xla_take_vjp(cout):
    b, rng = make_case(seed=7)
    U = b['coords1'].shape[0]
    y = rng.normal(size=(U * 8, cout)).astype(np.float32)
    parent, widx = b['up_parent0'], b['up_widx0']
    idx = np.where(parent >= U, U * 8, parent * 8 + widx).astype(np.int32)
    g = rng.normal(size=(idx.shape[0], cout)).astype(np.float32)

    def take(y):
        return jnp.take(jnp.concatenate([y, jnp.zeros((1, cout))]),
                        jnp.asarray(idx), axis=0)
    _, vjp = jax.vjp(take, jnp.asarray(y))
    want, = vjp(jnp.asarray(g))
    ty = torch.from_numpy(y).requires_grad_()
    out = PCV.GatherRowsFn.apply(ty, torch.from_numpy(idx))
    assert torch.equal(out.detach(), PCV.gather_rows_plain(
        torch.from_numpy(y), torch.from_numpy(idx)))
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.grad.numpy(), np.asarray(want))


def test_reference_gather_rows_has_no_vjp():
    """The JAX package's gather_rows (its up convs' pick under --pallas_conv
    on) cannot be differentiated, even in interpret mode: its train step
    under --pallas_conv on raises (ROADMAP section C). The JAX error is an
    internal assertion of pallas_call's JVP rule, so any exception counts."""
    b, rng = make_case(seed=8)
    U = b['coords1'].shape[0]
    y = jnp.asarray(rng.normal(size=(U * 8, 16)).astype(np.float32))
    idx = jnp.asarray(np.where(b['up_parent0'] >= U, U * 8,
                               b['up_parent0'] * 8 + b['up_widx0']))
    with pytest.raises(Exception):
        jax.grad(lambda y: JPC.gather_rows(y, idx, interpret=True).sum())(y)


NMAP_UNROUNDED = ['--compute_dtype', 'float32', '--key_conv', 'off']
# sparse_conv and gather_rows calls of one step at --layers 1: the forward's
# 1 stem + 7 down + 28 3^3 convs and 7 up picks, and one sparse_conv per
# 3^3 conv in the backward (its dx, mirrored_dx)
STEP_CALLS = {'sparse_conv': 36 + 28, 'gather_rows': 7}


def test_nmap_step_unrounded_matches_jax():
    """The bounds and their reasons: tests/test_torch_train_step.py."""
    init, jout = jax_run(NMAP_UNROUNDED, 1)
    KC.reset_counts()
    ops.reset_counts()
    pout = port_run(NMAP_UNROUNDED, init, 1)
    assert sum(KC.PLAIN_CALLS.values()) == 0 and ops.XLA_CALLS['up_conv']
    noisy = port_run(NMAP_UNROUNDED, init, 1, feature_noise=1e-7)
    (jl, jg, jp, js), (pl, pg, pp, ps) = jout[0], pout[0]
    for k in LOSS_KEYS:
        assert abs(pl[k] - jl[k]) <= 1e-5 * abs(jl[k]), (k, pl[k], jl[k])
    assert max(rel_err(ps, js).values()) <= 1e-5
    floor = rel_err(noisy[0][1], pg)
    err = rel_err(pg, jg)
    assert {k: (err[k], floor[k]) for k in jg
            if err[k] > 3 * floor[k] + 1e-5} == {}
    assert l2_rel(pg, jg) <= 1e-2
    assert moved_share(pp, jp) <= 1e-2
    assert max(float(np.abs(pp[k] - jp[k]).max()) for k in jp) <= (
        2 * LRS[0] + 1e-6)


def test_pallas_on_step_matches_jax_xla_route():
    """The bounds and their reasons: tests/test_torch_train_step_bf16.py."""
    extra = ['--key_conv', 'off', '--bf16_acts']
    init, jout = jax_run(extra, 1)
    PCV.reset_counts()
    ops.reset_counts()
    pout = port_run(extra + ['--pallas_conv', 'on'], init, 1)
    assert PCV.PLAIN_CALLS == STEP_CALLS
    assert sum(ops.XLA_CALLS.values()) == 0
    (jl, jg, jp, js), (pl, pg, pp, ps) = jout[0], pout[0]
    for k in jl:
        tol = 1.5e-2 if k in LOSS_KEYS else 5e-2
        assert abs(pl[k] - jl[k]) <= tol * max(abs(jl[k]), 1.0), k
    assert max(rel_err(ps, js).values()) <= 5e-2
    assert l2_rel(pg, jg) <= 0.5 and cosine(pg, jg) >= 0.9
    assert moved_share(pp, jp) <= 0.25


def one_step(extra, scale=1.0, mode='train'):
    """One train step of the port on a 2-scene batch (positions times
    `scale`); returns (the batch, its loss dict, key_conv calls)."""
    pc = PC.get_config(ARGS + extra)
    pc.use_native_host_ops = False
    rets = []
    for s in (3, 4):
        scene, labels = PSyn.make_scene(seed=s, **SCENE)
        scene['positions'] = scene['positions'] * scale
        ret = PV.voxelize_scene(scene, pc)
        ret['labels'] = labels
        PSup.build_supervision(ret, labels, scene, pc, 'scannet')
        rets.append(ret)
    dev, _ = PB.build_batch(rets, pc, PT.SCANNET_SEMANTIC_ID2IDX, mode=mode)
    batch = {k: torch.from_numpy(np.asarray(a)) for k, a in dev.items()}
    state = S.init_state(pc, S.build_model(pc, 20, 'cpu'),
                         S.make_optimizer(pc))
    KC.reset_counts()
    PCV.reset_counts()
    _, ld = S.train_step(pc, state, batch, 1e-3, 1.0, 0.0)
    assert state.step == 1
    assert all(bool(torch.isfinite(v)) for v in ld.values())
    return dev, ld, sum(KC.PLAIN_CALLS.values()), dict(PCV.PLAIN_CALLS)


def test_host_maps_batch_past_1024_trains():
    """Positions times 4 spread a scene over ~24 m, past 1024 voxels of 2
    cm on an axis: the batch takes host maps (with the RuntimeWarning) and
    trains, under --pallas_conv on through the autograd Functions."""
    with pytest.warns(RuntimeWarning, match='1024'):
        dev, _, kc, pallas = one_step(['--pallas_conv', 'on'], scale=4.0)
    assert 'keys0_b' not in dev and 'nmap3_0' in dev
    assert kc == 0 and pallas == STEP_CALLS


def test_key_conv_eval_trains_on_device_maps():
    """--key_conv eval: a train batch builds its maps on the device (mode
    'train') and trains on them; the key path never runs."""
    dev, _, kc, pallas = one_step(['--key_conv', 'eval'])
    assert PB.DEVICE_NMAPS in dev and kc == 0
    assert sum(pallas.values()) == 0
