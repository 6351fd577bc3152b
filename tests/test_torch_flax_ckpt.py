"""Checkpoints of the JAX package in the port, and --apple_warmstart.

  * engine/flax_msgpack.py against flax: `restore(to_bytes(tree))` equals
    flax's `msgpack_restore` on random trees (arrays of several dtypes,
    bfloat16 leaves, numpy and Python scalars, str, None, empty dicts) and on
    chunked arrays (flax's MAX_CHUNK_SIZE patched down): every leaf equal,
    bit for bit, with its dtype.
  * A checkpoint that the JAX package's save_checkpoint writes after one
    step of its neighbor-map train step (small width, --compute_dtype
    float32, for Adam, RMSprop and Adadelta) resumes in the port's Trainer:
    epoch, iteration and training time as saved; parameters, batch
    statistics and optimizer moments bit-equal to the JAX state, the
    optimizer count and the port's step equal to optax's count; the eval
    forward within 1e-5 (max) / 1e-6 (mean) of max |head| of the JAX
    forward (unrounded: only the f32 sum order differs,
    tests/test_torch_nmap_forward.py); the next update, from the JAX step's
    gradients, within 1e-6 relative of optax's (tests/test_torch_train_
    engine.py); for Adam the port's own next gradients within L2 1e-2 of
    JAX's (tests/test_torch_train_step.py). The next checkpoint the Trainer
    writes is the port's own.
  * --apple_warmstart with equal class counts gives the JAX package's
    warm-started parameters, bit for bit, from the same fresh init. From
    20 classes to 28 the JAX package's next update raises TypeError (the
    Adam moments of the re-initialised layer keep the checkpoint's shape,
    ROADMAP section C); the port re-initialises that layer and its moments
    and trains.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
from flax import serialization

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import loader as JLd
from box2mask_tpu.engine import checkpoint as JCk
from box2mask_tpu.engine import state as JS
from box2mask_tpu.engine import train as JT
from box2mask_tpu.nn import losses as JL
from box2mask_torch import config as PC
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import flax_msgpack as FM
from box2mask_torch.engine import state as S
from box2mask_torch.engine.optim import SLOTS
from box2mask_torch.engine.train import Trainer, warmstart_fresh_params
from test_torch_train_common import (ARGS, LRS, _unflat, flat, jax_batch,
                                     l2_rel, port_batch)
from test_torch_train_common import remove_tmp_path  # noqa: F401

EXTRA = ['--compute_dtype', 'float32', '--key_conv', 'off']


def same_leaf(a, b):
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(
            same_leaf(a[k], b[k]) for k in b)
    if isinstance(b, (np.ndarray, np.generic)) and str(b.dtype) == 'bfloat16':
        return (torch.is_tensor(a) and a.dtype == torch.bfloat16
                and np.array_equal(a.view(torch.int16).numpy(),
                                   np.asarray(b).view(np.int16)))
    if isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=True))
    return type(a) is type(b) and (a == b or a != a and b != b)


def random_tree(rng, depth=0):
    leaves = [
        lambda: rng.normal(size=tuple(rng.integers(0, 5, rng.integers(0, 4)))
                           ).astype(rng.choice(['float32', 'float64',
                                                'float16'])),
        lambda: rng.integers(-2**40, 2**40, size=rng.integers(0, 6)),
        lambda: rng.integers(0, 255, size=(2, 3)).astype(np.uint8),
        lambda: np.asarray(jnp.asarray(rng.normal(size=(3, 2)),
                                       jnp.bfloat16)),
        lambda: np.float32(rng.normal()), lambda: np.int32(rng.integers(9)),
        lambda: int(rng.integers(-2**62, 2**62)), lambda: float(rng.normal()),
        lambda: bool(rng.integers(2)), lambda: None, lambda: 'leaf',
        lambda: {}, lambda: np.array(rng.random() > 0.5)]
    out = {}
    for i in range(rng.integers(1, 6)):
        if depth < 3 and rng.random() < 0.3:
            out[f'node{i}'] = random_tree(rng, depth + 1)
        else:
            out[f'leaf{i}'] = leaves[rng.integers(len(leaves))]()
    return out


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_decoder_matches_flax(seed):
    tree = random_tree(np.random.default_rng(seed))
    data = serialization.to_bytes(tree)
    assert same_leaf(FM.restore(data), serialization.msgpack_restore(data))


def test_decoder_reads_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 64)
    rng = np.random.default_rng(4)
    tree = {'x': rng.normal(size=(10, 7)).astype(np.float32),
            'bf': jnp.asarray(rng.normal(size=(40,)), jnp.bfloat16),
            'small': np.arange(3)}
    data = serialization.to_bytes(tree)
    assert FM.CHUNKED in FM.unpackb(data)['x']
    want = serialization.msgpack_restore(data)
    assert same_leaf(FM.restore(data), want)
    with pytest.raises(ValueError, match='ends early'):
        FM.restore(data[:-3])


# ------------------------------------------------------------ JAX checkpoint
@pytest.fixture(scope='module')
def jax_side():
    """The JAX neighbor-map batch, model, init and a jitted grad of its
    train-mode loss (shared by every optimizer)."""
    jc, dev = jax_batch(EXTRA)
    batch = {k: jnp.asarray(v) for k, v in dev.items()}
    model = JS.build_model(jc, 20)
    v = JS.init_variables(model, batch)

    def loss_fn(p, stats):
        full = JS.ensure_maps(batch)
        out, mut = model.apply({'params': p, 'batch_stats': stats}, full,
                               train=True, mutable=['batch_stats'])
        ld = JL.compute_losses(jc, out, full, jnp.float32(1.0),
                               jnp.float32(0.0))
        return ld['optimization_loss'], (ld, mut['batch_stats'])
    grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    fwd = JS.make_forward(jc, model)
    _, pdev = port_batch(EXTRA)
    pbatch = {k: torch.from_numpy(np.asarray(a)) for k, a in pdev.items()}
    return batch, v['params'], v['batch_stats'], grad, fwd, pbatch


_UPDATES = {}


def jax_opt(name):
    """optax's optimizer `name` and its jitted update + apply (one compile
    per optimizer for the whole module)."""
    if name not in _UPDATES:
        tx = optax.inject_hyperparams(getattr(optax, name))(
            learning_rate=LRS[0])

        @jax.jit
        def update(g, opt, params):
            upd, opt = tx.update(g, opt, params)
            return optax.apply_updates(params, upd), opt
        _UPDATES[name] = tx, update
    return _UPDATES[name]


def jax_step(grad, name, params, stats, opt, lr):
    (_, (_, stats)), g = grad(params, stats)
    opt.hyperparams['learning_rate'] = jnp.float32(lr)
    params, opt = jax_opt(name)[1](g, opt, params)
    return params, stats, opt, g


def write_jax_checkpoint(jax_side, name, cfg):
    """One JAX step from its init, saved by the JAX package into the
    experiment of `cfg`; returns (params, stats, optax state)."""
    _, p0, s0, grad, _, _ = jax_side
    tx = jax_opt(name)[0]
    p1, s1, opt, _ = jax_step(grad, name, p0, s0, tx.init(p0), LRS[0])
    JCk.save_checkpoint(cfg.checkpoint_path,
                        JS.TrainState(p1, s1, opt, jnp.int32(1)), 3600.5, 3,
                        7)
    return p1, s1, opt


def port_cfg(extra, tmp_path, monkeypatch):
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    return PC.get_config(ARGS + EXTRA + ['--num_workers', '1',
                                         '--dataset_size', '2'] + extra)


def trainer(cfg, num_classes=None):
    return Trainer(cfg, PLd.get_dataset(cfg, 'train'),
                   PLd.get_dataset(cfg, 'val'), num_classes=num_classes,
                   device='cpu')


@pytest.mark.parametrize('name', ['adam', 'rmsprop', 'adadelta'])
def test_jax_checkpoint_resumes_in_trainer(name, jax_side, tmp_path,
                                           monkeypatch, capsys):
    batch, _, _, grad, fwd, pbatch = jax_side
    cfg = port_cfg(['--optimizer', name], tmp_path, monkeypatch)
    p1, s1, opt = write_jax_checkpoint(jax_side, name, cfg)
    t = trainer(cfg)
    t._ensure_state(pbatch)
    assert 'Resumed from checkpoint_1h:0m:0s_3600.5 (epoch 3)' in (
        capsys.readouterr().out)
    assert (t.start_epoch, t.iteration_num, t.training_time) == (3, 7,
                                                                 3600.5)
    state, model = t.state, t.state.model
    want = from_flax(p1, s1)
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    names = [n for n, _ in model.named_parameters()]
    inner = serialization.to_state_dict(opt)['inner_state']
    slots = next(s for s in inner.values() if s)
    assert state.opt_state['count'] == int(opt.count) == state.step == 1
    for s in SLOTS[name]:
        leaves = flat(slots[s])
        assert all(np.array_equal(v.numpy(), leaves[n])
                   for n, v in zip(names, state.opt_state[s])), s

    jout = fwd(p1, s1, batch)
    pout = S.forward(model, pbatch)
    valid = pbatch['seg_valid'].numpy()
    for k, v in jout.items():
        v, scale = np.asarray(v), float(np.abs(np.asarray(v)).max())
        d = np.abs(pout[k].numpy() - v)
        assert d.max() <= 1e-5 * scale and d[valid].mean() <= 1e-6 * scale

    p2, _, _, g2 = jax_step(grad, name, p1, s1, opt, LRS[1])
    g2 = flat(g2)
    if name == 'adam':
        ld = S.forward_losses(cfg, state, pbatch, 1.0, 0.0)
        S.backward(ld)
        assert l2_rel({n: p.grad.numpy() for n, p in
                       model.named_parameters()}, g2) <= 1e-2
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(g2[n].copy())
    S.apply_update(state, LRS[1])
    p2 = flat(p2)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), p2[n], rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    assert state.step == 2

    path = ckpt.save_checkpoint(cfg.checkpoint_path, state, 3700.0, 4, 8)
    assert ckpt.find_checkpoint(cfg.checkpoint_path) == path
    assert isinstance(ckpt.read_payload(path)['params'], dict)


def test_apple_warmstart_equals_jax_with_equal_classes(jax_side, tmp_path,
                                                       monkeypatch):
    """Both packages warm-start from the same JAX checkpoint and the same
    fresh init (the port's, copied into the JAX template)."""
    cfg = port_cfg(['--apple_warmstart'], tmp_path, monkeypatch)
    p1, s1, opt = write_jax_checkpoint(jax_side, 'adam', cfg)
    t = trainer(cfg)
    fresh = S.init_state(cfg, S.build_model(cfg, 20, 'cpu'),
                         S.make_optimizer(cfg), seed=cfg.fixed_seed or 0)
    fresh_sd = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    t._ensure_state(jax_side[5])
    assert t.start_epoch == 0
    keep = warmstart_fresh_params(t.state.model)
    assert keep == {'mlp_semantics.Linear1x1_2.kernel',
                    'mlp_semantics.Linear1x1_2.bias'}

    jc = JC.get_config(ARGS + EXTRA + ['--apple_warmstart'])
    jt = JT.Trainer(jc, JLd.get_dataset(jc, 'train'),
                    JLd.get_dataset(jc, 'val'))
    names = [n for n, _ in fresh.model.named_parameters()]
    jfresh = _unflat({n: fresh_sd[n].numpy() for n in names})
    jt.state = JS.TrainState(jax.tree.map(jnp.asarray, jfresh), s1,
                             jax_opt('adam')[0].init(jfresh), jnp.int32(0))
    jt._resume()
    want = flat(jt.state.params)
    got = t.state.model.state_dict()
    assert all(np.array_equal(got[n].numpy(), want[n]) for n in names)
    ck = flat(p1)
    assert all(torch.equal(got[n], fresh_sd[n]) if n in keep else
               np.array_equal(got[n].numpy(), ck[n]) for n in names)
    for s in ('mu', 'nu'):
        moments = flat(getattr(opt.inner_state[0], s))
        for n, v in zip(names, t.state.opt_state[s]):
            assert (not v.any()) if n in keep else np.array_equal(
                v.numpy(), moments[n]), (s, n)


def test_apple_warmstart_20_to_28_classes(jax_side, tmp_path, monkeypatch):
    """ScanNet's 20 classes into a 28-class run (ARKitScenes'): the JAX
    package's warm-started state fails its first update; the port's
    trains."""
    cfg = port_cfg(['--apple_warmstart'], tmp_path, monkeypatch)
    write_jax_checkpoint(jax_side, 'adam', cfg)

    jc = JC.get_config(ARGS + EXTRA + ['--apple_warmstart'])
    jt = JT.Trainer(jc, JLd.get_dataset(jc, 'train'),
                    JLd.get_dataset(jc, 'val'), num_classes=28)
    jbatch = jax_side[0]
    jt._ensure_state({k: np.asarray(v) for k, v in jbatch.items()})
    assert jt.start_epoch == 0
    head = jt.state.params['mlp_semantics']['Linear1x1_2']['kernel']
    mu = jt.state.opt_state.inner_state[0].mu['mlp_semantics'][
        'Linear1x1_2']['kernel']
    assert head.shape[1] == 28 and mu.shape[1] == 20
    zeros = jax.tree.map(jnp.zeros_like, jt.state.params)
    with pytest.raises(TypeError, match='incompatible shapes'):
        jt.tx.update(zeros, jt.state.opt_state, jt.state.params)

    t = trainer(cfg, num_classes=28)
    t._ensure_state(jax_side[5])
    model = t.state.model
    assert model.mlp_semantics.Linear1x1_2.kernel.shape[1] == 28
    _, ld = S.train_step(cfg, t.state, jax_side[5], LRS[0], 1.0, 0.0)
    assert all(bool(torch.isfinite(v)) for v in ld.values())
    assert t.state.step == 2
