"""The port's host code (config, synthetic scenes, voxelization, key pyramid,
batch builder) against the JAX package's, and the port's package purity.

Host code is NumPy on both sides, so every comparison is bit-exact."""

import ast
import os

import numpy as np
import pytest

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_tpu.sparse import device_maps as JDM
from box2mask_torch import config as PC
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.sparse import keys as PK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--loss_weight_bb_bounds', '0.5',
        '--loss_weight_bb_scores', '1', '--loss_weight_semantics', '1',
        '--voxel_size', '0.05', '--vox_bucket', '512', '--seg_bucket', '64',
        '--use_normals_input', '--exp_name', 'torch_host']
SCENE = dict(num_instances=5, points_per_instance=250, floor_points=900,
             wall_points=700)


@pytest.mark.parametrize('cfg_file,cli', [
    ('scannet.txt', []), ('synthetic.txt', []),
    ('scannet.txt', ['--vox_bucket', '131072', '--layers', '1',
                     '--compute_dtype', 'float32', '--lr', '0.1']),
    ('scannet.txt', ['--layers', '1', '--key_conv', 'off', '--pallas_conv',
                     'on', '--host_coordinate_maps', '--key_conv_force'])])
def test_get_config_matches(cfg_file, cli):
    """Every field the port's config carries (the ones the port reads) has
    the JAX package's value; the rest of the JAX flags are accepted and
    ignored. The command line wins over the file. The conv-path flags are
    read, never skipped: they change the port's path as the JAX
    package's."""
    argv = ['--config', os.path.join(ROOT, 'configs', cfg_file)] + cli
    p, j = vars(PC.get_config(argv)), vars(JC.get_config(argv))
    assert set(p) - {'config'} <= set(j)
    assert {k: v for k, v in p.items() if v != j[k]} == {}
    conv = ('key_conv', 'pallas_conv', 'host_coordinate_maps')
    assert [p[k] for k in conv] == (
        ['off', 'on', True] if '--key_conv' in cli else ['on', 'auto', False])
    assert p['layers'] == (1 if cli else 2)
    assert p['network_heads'] and p['eval_ths']
    assert p['bf16_acts'] == (cfg_file == 'scannet.txt')


def test_tables_match():
    pv, _, _, pfg = PT.get_tables('scannet')
    jv, _, _, jfg = JT.get_tables('scannet')
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(pfg(np.arange(41)), jfg(np.arange(41)))


def test_host_level_keys_and_offsets_match():
    rng = np.random.default_rng(0)
    c = np.unique(rng.integers(0, 1024, (5000, 3)), axis=0).astype(np.int32)
    for a, b in zip(PK.host_level_keys(c), JDM.host_level_keys(c)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    from box2mask_tpu.sparse import key_conv as JKC
    for ks, sc in ((3, False), (5, False), (2, True)):
        np.testing.assert_array_equal(PK.offsets_3d(ks, sc),
                                      JKC.offsets_3d(ks, sc))
    for off in ((-1, -1, -1), (1, -2, 0), (0, 1, 1)):
        for scale in (1, 4):
            assert PK.pack_delta(off, scale) == JKC.pack_delta(off, scale)


@pytest.mark.parametrize('seeds', [(3, 4), (5,)])
def test_batch_bit_equal(seeds):
    """make_scene -> voxelize_scene -> build_batch gives the JAX package's
    arrays bit for bit, for every key both carry (the JAX voxelizer on its
    NumPy branch, which the port copies)."""
    pc, jc = PC.get_config(ARGS), JC.get_config(ARGS)
    jc.use_native_host_ops = False
    prets, jrets = [], []
    for s in seeds:
        ps, _ = PSyn.make_scene(seed=s, **SCENE)
        js, _ = JSyn.make_scene(seed=s, **SCENE)
        for k in ps:
            if k != 'name':
                np.testing.assert_array_equal(ps[k], js[k])
        prets.append(PV.voxelize_scene(ps, pc))
        jrets.append(JV.voxelize_scene(js, jc))
    pd, ph = PB.build_batch(prets, pc)
    jd, jh = JB.build_batch(jrets, jc, JT.SCANNET_SEMANTIC_ID2IDX, mode='val')
    for k in ('keys0_b', 'keys7_b', 'vox_features', 'pooling_ids',
              'seg_valid', 'batch_ids', 'input_location', 'valid0', 'batch0'):
        assert k in pd
    for k in pd:
        a, b = np.asarray(pd[k]), np.asarray(jd[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ('num_voxels', 'interleaved_vs'):
        assert ph[k] == jh[k]
    for a, b in zip(ph['vox2point'], jh['vox2point']):
        np.testing.assert_array_equal(a, b)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ''


def test_package_purity():
    """No module of the port, and not chip_smoke.py, imports jax, flax,
    optax or box2mask_tpu."""
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for d, _, names in os.walk(os.path.join(ROOT, 'box2mask_torch')):
        files += [os.path.join(d, n) for n in names if n.endswith('.py')]
    assert len(files) > 15
    banned = ('jax', 'flax', 'optax', 'box2mask_tpu')
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split('.')[0] in banned]
    assert bad == []


def test_resolve_device_defaults_to_cuda():
    """Entry points run on the card unless the CPU is asked for."""
    import torch
    from box2mask_torch.runtime import resolve_device
    assert resolve_device('cpu') == torch.device('cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
    else:
        assert resolve_device(None).type == 'cuda'
