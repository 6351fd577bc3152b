"""Reference (PyTorch + MinkowskiEngine) checkpoints in the port without JAX
(box2mask_torch/convert.py's mapping, `python -m
box2mask_torch.convert_reference`) against scripts/convert_torch_ckpt.py.

An ME-layout state_dict is made from a seeded JAX template through the
inverse mapping, as tests/test_ckpt_convert.py makes it (ME offset order,
a DDP `module.` prefix, num_batches_tracked, the dead final* head, an
unknown key):
  * the mapping, the kernel-row permutation and convert_state_dict equal
    the JAX script's exactly, on the .npz and the .tar routes, with the
    same NOTE / Dropped lines and the same strict refusal;
  * the checkpoint convert_reference writes restores (strict, the way
    train and evaluate resume) to tensors bit-equal to from_flax of the JAX
    script's converted tree, with a fresh optimizer state, step 0, and the
    payload's epoch, iteration and training time (else the file name's);
  * the forward from it matches the JAX forward on the JAX script's tree
    at tests/test_torch_forward.py's unrounded bound (1e-5 max, 1e-6 mean
    of the head's max |output|);
  * heads the checkpoint lacks keep their init (WARNING), heads the model
    lacks are left out (NOTE).
The released checkpoint is not read: it is not in the repository.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_tpu.engine import state as JS
from box2mask_torch import config as PC
from box2mask_torch import convert
from box2mask_torch import convert_reference as CR
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.engine.optim import SLOTS
from box2mask_torch.sparse import key_conv as KC
from scripts import convert_torch_ckpt as JCV
from test_torch_forward import ARGS, SCENE

torch.set_num_threads(2)
F32 = ['--compute_dtype', 'float32']


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.fixture(scope='module')
def ref():
    """The JAX batch and template, and an ME-layout state_dict of seeded
    values for every leaf the mapping covers."""
    jc = JC.get_config(ARGS + F32)
    jc.use_native_host_ops = False
    rets = [JV.voxelize_scene(JSyn.make_scene(seed=s, **SCENE)[0], jc)
            for s in (3, 4)]
    jdev, _ = JB.build_batch(rets, jc, JT.SCANNET_SEMANTIC_ID2IDX, mode='val')
    model = JS.build_model(jc, 20)
    v = JS.init_variables(model, {k: jnp.asarray(a) for k, a in jdev.items()})
    rng = np.random.RandomState(0)
    sd = {}
    for t_key, f_path, kind in JCV.build_mapping(layers=1):
        tree = v['batch_stats'] if kind == 'stat' else v['params']
        try:
            leaf = np.asarray(_get(tree, f_path))
        except KeyError:
            continue                    # a head this model does not have
        val = 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        if f_path[-1] == 'var':
            val = np.abs(val) + 0.5
        if f_path[-1] == 'scale':
            val = 1.0 + val
        if kind == 'conv' and val.ndim == 3:
            perm = JCV.cubic_perm_me_to_ours(round(val.shape[0] ** (1 / 3)))
            val = val[np.argsort(perm)]         # stored in ME order
        sd['module.' + t_key] = val
    sd['module.bn0.bn.num_batches_tracked'] = np.int64(7)
    sd['module.final0.kernel'] = np.zeros((96, 96), np.float32)
    sd['module.not_a_layer.weight'] = np.zeros(3, np.float32)
    return jc, jdev, sd


def same_tree(a, b):
    assert set(a) == set(b)
    for k in b:
        if isinstance(b[k], dict):
            same_tree(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_mapping_matches_script():
    for layers in (1, 2, 3):
        assert convert.build_mapping(layers) == JCV.build_mapping(layers)
    for k in (2, 3, 5):
        np.testing.assert_array_equal(convert.cubic_perm_me_to_ours(k),
                                      JCV.cubic_perm_me_to_ours(k))
    w = np.random.default_rng(0).normal(size=(27, 4, 5))
    np.testing.assert_array_equal(convert.convert_conv_kernel(w),
                                  JCV.convert_conv_kernel(w))
    np.testing.assert_array_equal(convert.convert_conv_kernel(w[0]),
                                  JCV.convert_conv_kernel(w[0]))


@pytest.mark.parametrize('route', ['npz', 'tar'])
def test_convert_state_dict_matches_script(ref, tmp_path, capsys, route):
    _, _, sd = ref
    if route == 'npz':
        path = tmp_path / 'sd.npz'
        np.savez(path, **sd)
        got_sd, meta = CR.read_reference(str(path))
        want_sd = dict(np.load(path))
        assert meta == {}
    else:
        path = tmp_path / 'checkpoint_1h:0m:0s_3600.5.tar'
        torch.save({'model_state_dict': {k: torch.as_tensor(v)
                                         for k, v in sd.items()},
                    'epoch': 5, 'iteration_num': 11}, str(path))
        got_sd, meta = CR.read_reference(str(path))
        want_sd, want_meta = JCV.load_torch_tar(str(path))
        assert meta['epoch'] == want_meta['epoch'] == 5
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        assert np.array_equal(got_sd[k], want_sd[k]), k
    capsys.readouterr()
    got = convert.convert_state_dict(got_sd, layers=1)
    got_out = capsys.readouterr().out
    want = JCV.convert_state_dict(want_sd, layers=1)
    assert got_out == capsys.readouterr().out
    assert 'NOTE: 1 torch keys had no flax target' in got_out
    assert 'Dropped 1 --load_unused_head' in got_out
    for g, w in zip(got, want):
        same_tree(g, w)
    for fn in (convert.convert_state_dict, JCV.convert_state_dict):
        with pytest.raises(ValueError, match='no flax target'):
            fn(got_sd, layers=1, strict=True)


def write_port_checkpoint(sd, tmp_path, name, payload):
    path = tmp_path / name
    torch.save({'model_state_dict': {k: torch.as_tensor(v)
                                     for k, v in sd.items()}, **payload},
               str(path))
    out_dir = tmp_path / 'ckpts'
    return CR.main(['--torch_ckpt', str(path), '--out_dir', str(out_dir),
                    '--layers', '1'] + ARGS + F32)


@pytest.mark.parametrize('payload,name,meta', [
    ({'training_time': 7200.25, 'epoch': 9, 'iteration_num': 123},
     'reference.tar', (9, 7200.25, 123)),
    ({}, 'checkpoint_101h:54m:35s_366875.1301574707.tar',
     (0, 366875.1301574707, 0))])
def test_checkpoint_restores_to_script_tree(ref, tmp_path, monkeypatch,
                                            payload, name, meta):
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    _, _, sd = ref
    path = write_port_checkpoint(sd, tmp_path, name, payload)
    want = from_flax(*JCV.convert_state_dict(
        {k: np.asarray(v) for k, v in sd.items()}, layers=1))
    cfg = PC.get_config(ARGS + F32)
    model = S.build_model(cfg, 20, 'cpu')
    state = S.init_state(cfg, model, S.make_optimizer(cfg), seed=5)
    state, epoch, t_time, it, ck = ckpt.load_checkpoint(path, state,
                                                        strict=True)
    assert (epoch, t_time, it) == meta
    assert ck == ckpt.checkpoint_name(meta[1])[:-5]
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert state.step == 0 and state.opt_state['count'] == 0
    assert all(not torch.any(m) for s in SLOTS[state.tx.name]
               for m in state.opt_state[s])


def test_forward_matches_jax_unrounded(ref, tmp_path, monkeypatch):
    jc, jdev, sd = ref
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    path = write_port_checkpoint(sd, tmp_path, 'reference.tar', {})
    params, stats = JCV.convert_state_dict(
        {k: np.asarray(v) for k, v in sd.items()}, layers=1)
    jout = JS.make_forward(jc, JS.build_model(jc, 20))(
        params, stats, {k: jnp.asarray(a) for k, a in jdev.items()})

    def conv(x, kin, kout, w, **kw):
        return KC.key_conv_plain(x, kin, kout, w, operand_dtype=torch.float32,
                                 **kw)
    monkeypatch.setattr(KC, 'key_conv', conv)
    monkeypatch.setattr(KC, 'key_conv_stem', lambda x, kin, w: conv(
        x, kin, kin.reshape(-1), w, kernel_size=5, out_dtype=torch.float32))
    pc = PC.get_config(ARGS + F32)
    pc.use_native_host_ops = False
    prets = [PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], pc)
             for s in (3, 4)]
    pdev, _ = PB.build_batch(prets, pc)
    state = S.init_state(pc, S.build_model(pc, 20, 'cpu'),
                         S.make_optimizer(pc), seed=5)
    state = ckpt.load_checkpoint(path, state, strict=True)[0]
    pout = S.forward(state.model, {k: torch.from_numpy(np.asarray(a))
                                   for k, a in pdev.items()})
    assert set(pout) == set(jout)
    for head, want in jout.items():
        want = np.asarray(want)
        got = pout[head].numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert diff.max() <= 1e-5 * scale, (head, diff.max(), scale)
        assert diff.mean() <= 1e-6 * scale, (head, diff.mean(), scale)


def test_coverage_lines(ref, tmp_path, monkeypatch, capsys):
    """A checkpoint without the semantics head and with a center-score head
    the config lacks: WARNING for the first (its init kept), NOTE for the
    second (left out); the rest converted."""
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    _, _, sd = ref
    sd = {k: v for k, v in sd.items() if 'mlp_semantics' not in k}
    sd['module.mlp_center_score.0.kernel'] = np.zeros((96, 96), np.float32)
    path = write_port_checkpoint(sd, tmp_path, 'reference.tar', {})
    out = capsys.readouterr().out
    assert ('WARNING: 14 model tensors not covered by the torch '
            'checkpoint') in out
    assert ("NOTE: 1 converted tensors have no place in the model (heads the "
            "config does not have): ['mlp_center_scores.Linear1x1_0.kernel']"
            ) in out
    cfg = PC.get_config(ARGS + F32)
    init = S.build_model(cfg, 20, 'cpu')
    S.init_state(cfg, init, S.make_optimizer(cfg))
    state = S.init_state(cfg, S.build_model(cfg, 20, 'cpu'),
                         S.make_optimizer(cfg), seed=5)
    got = ckpt.load_checkpoint(path, state, strict=True)[0].model.state_dict()
    want = init.state_dict()
    for k in got:
        if k.startswith('mlp_semantics'):
            assert torch.equal(got[k], want[k]), k
    assert os.path.basename(path).startswith('checkpoint_0h:0m:0s_0.0')
