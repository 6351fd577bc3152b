"""Shared setup of tests/test_torch_train_step*.py: one small supervised
training batch built by both packages, the JAX package's neighbor-map train
step (value_and_grad + optax, jitted) and the port's train step on the CPU.

The JAX step runs on its neighbor-map path (no key_conv window plans): on
the CPU its Pallas kernels run only in interpret mode, far too slowly for a
whole network, and the neighbor-map path computes the same function.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import supervision as JSup
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_tpu.engine import state as JS
from box2mask_tpu.nn import losses as JL
from box2mask_torch import config as PC
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine import state as S
from box2mask_torch.sparse import key_conv as KC

ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision', '--smallest_bb_heuristic',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1', '--voxel_size', '0.02',
        '--vox_bucket', '512', '--seg_bucket', '64', '--layers', '1',
        '--use_normals_input', '--exp_name', 'torch_train']
SCENE = dict(num_instances=5, points_per_instance=250, floor_points=900,
             wall_points=700)
SEEDS = (3, 4)
LRS = (1e-3, 8e-4, 6e-4, 4e-4, 2e-4)


def scenes(make_scene, voxelize, build_supervision, cfg):
    rets = []
    for s in SEEDS:
        scene, labels = make_scene(seed=s, **SCENE)
        ret = voxelize(scene, cfg)
        ret['labels'] = labels
        build_supervision(ret, labels, scene, cfg, 'scannet')
        rets.append(ret)
    return rets


def jax_batch(extra):
    jc = JC.get_config(ARGS + extra)
    jc.use_native_host_ops = False
    rets = scenes(JSyn.make_scene, JV.voxelize_scene, JSup.build_supervision,
                  jc)
    dev, _ = JB.build_batch(rets, jc, JT.SCANNET_SEMANTIC_ID2IDX, mode='train')
    return jc, dev


def port_batch(extra):
    pc = PC.get_config(ARGS + extra)
    pc.use_native_host_ops = False
    rets = scenes(PSyn.make_scene, PV.voxelize_scene, PSup.build_supervision,
                  pc)
    dev, _ = PB.build_batch(rets, pc, PT.SCANNET_SEMANTIC_ID2IDX)
    return pc, dev


def flat(tree, prefix=''):
    out = {}
    for k in tree:
        v = tree[k]
        if hasattr(v, 'keys'):
            out.update(flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = np.asarray(v)
    return out


def jax_run(extra, n_steps, bb_w=1.0, cs_w=0.0):
    """The JAX package's first `n_steps` train steps from its seed-0 init,
    with the learning rates LRS: per step the loss dict, the grads (before
    the update) and the params and batch stats after it, as flat dicts.
    Returns ((init params, init stats), steps)."""
    jc, dev = jax_batch(extra)
    batch = {k: jnp.asarray(v) for k, v in dev.items()}
    model = JS.build_model(jc, 20)
    tx = JS.make_optimizer(jc)
    v = JS.init_variables(model, batch)
    params, stats = v['params'], v['batch_stats']
    opt_state = tx.init(params)

    def step(params, stats, opt_state, batch, lr):
        def loss_fn(p):
            out, mut = model.apply({'params': p, 'batch_stats': stats},
                                   JS.ensure_maps(batch), train=True,
                                   mutable=['batch_stats'])
            ld = JL.compute_losses(jc, out, JS.ensure_maps(batch),
                                   jnp.float32(bb_w), jnp.float32(cs_w))
            return ld['optimization_loss'], (ld, mut['batch_stats'])
        (_, (ld, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        opt_state.hyperparams['learning_rate'] = lr
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), new_stats, opt_state,
                ld, grads)

    step = jax.jit(step)
    p0, s0 = flat(params), flat(stats)
    out = []
    for i in range(n_steps):
        params, stats, opt_state, ld, grads = step(
            params, stats, opt_state, batch, jnp.float32(LRS[i]))
        out.append(({k: float(x) for k, x in ld.items()}, flat(grads),
                     flat(params), flat(stats)))
    return (p0, s0), out


def port_run(extra, init, n_steps, bb_w=1.0, cs_w=0.0, unrounded=False,
             monkeypatch=None, feature_noise=0.0):
    """The port's first `n_steps` train steps from the JAX init `init`
    ((flat params, flat stats)), same outputs as jax_run. `unrounded`
    replaces every conv and dw with its plain twin on unrounded f32
    operands and keeps x unrounded for the backward (through
    `monkeypatch`); `feature_noise` multiplies the input
    features by 1 + feature_noise * N(0, 1) (seeded)."""
    if unrounded:
        f32 = dict(operand_dtype=torch.float32)
        monkeypatch.setattr(KC, 'SAVED_X_DTYPE', torch.float32)
        monkeypatch.setattr(KC, 'key_conv', lambda x, kin, kout, w, **kw: (
            KC.key_conv_plain(x, kin, kout, w, **f32, **kw)))
        monkeypatch.setattr(KC, 'key_conv_stem', lambda x, kin, w: (
            KC.key_conv_plain(x, kin, kin.reshape(-1), w, kernel_size=5,
                              out_dtype=torch.float32, **f32)))
        monkeypatch.setattr(KC, 'key_conv_dw', lambda x, g, kin, kout, **kw: (
            KC.key_conv_dw_plain(x, g, kin, kout, **f32, **kw)))
        monkeypatch.setattr(KC, 'key_conv_stem_dw', lambda x, g, kin: (
            KC.key_conv_dw_plain(x, g, kin, kin.reshape(-1), kernel_size=5,
                                 **f32)))
    pc, dev = port_batch(extra)
    if feature_noise:
        eps = np.random.default_rng(0).standard_normal(
            dev['vox_features'].shape)
        dev['vox_features'] = (dev['vox_features'] * (1 + feature_noise * eps)
                               ).astype(np.float32)
    batch = {k: torch.from_numpy(np.asarray(a)) for k, a in dev.items()}
    model = S.build_model(pc, 20, 'cpu')
    p0, s0 = init
    model.load_state_dict(from_flax(_unflat(p0), _unflat(s0)))
    tx = S.make_optimizer(pc)
    state = S.TrainState(model, tx, tx.init(list(model.parameters())))
    names = [n for n, _ in model.named_parameters()]
    out = []
    for i in range(n_steps):
        ld = S.forward_losses(pc, state, batch, bb_w, cs_w)
        S.backward(ld)
        grads = {n: p.grad.numpy().copy()
                 for n, p in zip(names, state.params)}
        S.apply_update(state, LRS[i])
        sd = {k: v.detach().numpy().copy()
              for k, v in model.state_dict().items()}
        out.append(({k: float(v.detach()) for k, v in ld.items()}, grads,
                    {k: sd[k] for k in names},
                    {k: v for k, v in sd.items() if k not in names}))
    return out


def _unflat(d):
    tree = {}
    for k, v in d.items():
        node = tree
        parts = k.split('.')
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def rel_err(got, want):
    """max |got - want| / max |want| per entry of two flat dicts."""
    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-30)) for k in want}


def l2_rel(got, want):
    """|got - want| / |want| over all entries of two flat dicts (L2)."""
    num = sum(float(((got[k] - want[k]).astype(np.float64) ** 2).sum())
              for k in want)
    den = sum(float((want[k].astype(np.float64) ** 2).sum()) for k in want)
    return (num / den) ** 0.5


def moved_share(got, want, atol=1e-6):
    """Share of parameter elements that differ by more than atol."""
    n = sum(int((np.abs(got[k] - want[k]) > atol).sum()) for k in want)
    return n / sum(want[k].size for k in want)


LOSS_KEYS = ('optimization_loss', 'offset_loss', 'bounds_loss',
             'bb_score_loss', 'semantics_loss')

# Every pytest-xdist worker collects every test module, so this runs in each
# of them. At torch's default of one thread per core, several workers doing
# torch work side by side oversubscribe the cores, and OpenMP's spinning
# threads slow each other down: the two train-step files took ~785 s each
# side by side against ~47 s alone (8 cores); at 2 threads, ~60 s.
torch.set_num_threads(min(2, torch.get_num_threads()))
