"""The port's neighbor maps and neighbor-map batches against the JAX
package's, bit for bit: the maps built on the device from the key pyramid
(sparse/device_maps.py), the host pyramid (sparse/coords.py), the host-maps
batch layout and the conv-path marker of datasets/batching.build_batch.
Then, inside the port, the neighbor-map twins against the key-matching twin
on the same batch: the two paths compute the same convolutions.
"""

import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.sparse import coords as JCo
from box2mask_tpu.sparse import device_maps as JDM
from box2mask_torch import config as PC
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine import state as S
from box2mask_torch.sparse import coords as PCo
from box2mask_torch.sparse import device_maps as PDM
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import ops
from box2mask_torch.sparse import pallas_conv as PCV
from box2mask_torch.sparse.keys import host_level_keys

ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision', '--smallest_bb_heuristic',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1', '--voxel_size', '0.05',
        '--vox_bucket', '512', '--seg_bucket', '64', '--use_normals_input',
        '--exp_name', 'torch_nmaps']
SCENE = dict(num_instances=5, points_per_instance=250, floor_points=900,
             wall_points=700)
# xdist workers running torch side by side at one thread per core slow
# each other down (OpenMP spin-waits; tests/test_torch_train_common.py)
torch.set_num_threads(min(2, torch.get_num_threads()))


def corner_coords(seed, n=400):
    """~n unique coords in the 8 corner clusters of the 1024^3 key range:
    every axis has voxels at 0 and at 1023 (the maps' axis guards)."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 12, (n, 3))
    hi = 1023 - rng.integers(0, 12, (n, 3))
    c = np.where(rng.random((n, 3)) < 0.5, lo, hi)
    c[:3] = [[0, 0, 0], [1023, 0, 5], [1023, 1023, 1023]]
    return np.unique(c, axis=0).astype(np.int32)


def cloud_coords(seed, n=500, hi=60):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, hi, (n, 3)), axis=0).astype(np.int32)


def scene_rets(seeds, cfg, supervised=False):
    rets = []
    for s in seeds:
        scene, labels = PSyn.make_scene(seed=s, **SCENE)
        ret = PV.voxelize_scene(scene, cfg)
        if supervised:
            ret['labels'] = labels
            PSup.build_supervision(ret, labels, scene, cfg, 'scannet')
        rets.append(ret)
    return rets


def keys_batch(coords_list, vox_bucket=512):
    """(B, pad_l) int32 key rows per level, as build_batch lays them out."""
    per_scene = [host_level_keys(c) for c in coords_list]
    pads = PB.level_pads(per_scene, vox_bucket)
    out = []
    for l, pad in enumerate(pads):
        kb = np.full((len(per_scene), pad), PB.SENT_KEY, np.int32)
        for i, ks in enumerate(per_scene):
            kb[i, :len(ks[l])] = ks[l]
        out.append(kb)
    return out


def assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype,
                                                          a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize('scenes', ['corners+cloud', 'corners+cloud+scene'])
def test_batch_maps_match_jax(scenes):
    coords = [corner_coords(1), cloud_coords(2)]
    if scenes.endswith('scene'):
        cfg = PC.get_config(ARGS)
        coords.append(scene_rets([5], cfg)[0]['vox_coords'])
    keys = keys_batch(coords)
    want = JDM.build_batch_maps_from_keys(tuple(jnp.asarray(k) for k in keys))
    got = PDM.build_batch_maps_from_keys(tuple(torch.from_numpy(k)
                                               for k in keys))
    assert_dicts_equal({k: v.numpy() for k, v in got.items()},
                       {k: np.asarray(v) for k, v in want.items()})
    # missing neighbours point at the global sentinel row B * pad
    B, pad = keys[0].shape
    assert (got['nmap3_0'].numpy() == B * pad).any()


def test_scene_pyramid_and_batch_match_jax():
    a, b = cloud_coords(3, n=300, hi=20), corner_coords(4, n=200)
    pa, pb = PCo.build_scene_pyramid(a), PCo.build_scene_pyramid(b)
    assert_dicts_equal(pa, JCo.build_scene_pyramid(a))
    assert_dicts_equal(pb, JCo.build_scene_pyramid(b))
    assert_dicts_equal(
        PCo.batch_pyramids([pa, pb], vox_bucket=256),
        JCo.batch_pyramids([JCo.build_scene_pyramid(a),
                            JCo.build_scene_pyramid(b)], vox_bucket=256))


@pytest.mark.parametrize('case', ['past_1024', 'host_coordinate_maps'])
def test_host_maps_batch_matches_jax(case):
    """Scenes past 1024 voxels on an axis (a RuntimeWarning on both sides),
    or any scene under --host_coordinate_maps: the host-maps layout, every
    array equal. The second case carries the training labels."""
    extra = ['--host_coordinate_maps'] if case != 'past_1024' else []
    pc, jc = PC.get_config(ARGS + extra), JC.get_config(ARGS + extra)
    jc.use_native_host_ops = False
    rets = scene_rets((3, 4), pc, supervised=case != 'past_1024')
    mode = 'val' if case == 'past_1024' else 'train'
    if case == 'past_1024':
        rets[1]['vox_coords'] = rets[1]['vox_coords'] + np.array(
            [1100, 0, 0], rets[1]['vox_coords'].dtype)
        with pytest.warns(RuntimeWarning, match='1024-voxel/axis'):
            pd, ph = PB.build_batch(rets, pc, JT.SCANNET_SEMANTIC_ID2IDX,
                                    mode=mode)
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            jd, jh = JB.build_batch(rets, jc, JT.SCANNET_SEMANTIC_ID2IDX,
                                    mode=mode)
    else:
        pd, ph = PB.build_batch(rets, pc, JT.SCANNET_SEMANTIC_ID2IDX,
                                mode=mode)
        jd, jh = JB.build_batch(rets, jc, JT.SCANNET_SEMANTIC_ID2IDX,
                                mode=mode, device_maps=False)
        assert 'gt_bb_offsets' in pd
    assert 'keys0_b' not in pd and 'nmap5_0' in pd
    assert_dicts_equal(pd, jd)
    assert ph['num_voxels'] == jh['num_voxels']
    assert 'interleaved_vs' not in ph


@pytest.mark.parametrize('key_conv,mode,nmaps', [
    ('on', 'train', False), ('eval', 'train', True), ('eval', 'val', False),
    ('off', 'val', True)])
def test_conv_path_follows_key_conv(key_conv, mode, nmaps):
    """The JAX package's rule (batching.py:196-198): key matching under
    --key_conv on, or eval outside mode 'train'; neighbor maps built on the
    device otherwise. The batch is otherwise the same arrays."""
    cfg = PC.get_config(ARGS + ['--key_conv', key_conv])
    rets = scene_rets((3,), cfg)
    dev, _ = PB.build_batch(rets, cfg, mode=mode)
    assert (PB.DEVICE_NMAPS in dev) == nmaps
    assert S.is_nmap_batch(dev) == nmaps
    ref, _ = PB.build_batch(rets, PC.get_config(ARGS), mode=mode)
    dev.pop(PB.DEVICE_NMAPS, None)
    assert_dicts_equal(dev, ref)


@pytest.mark.parametrize('mode', ['same3', 'down', 'stem', 'up'])
def test_nmap_twins_match_key_twin(mode):
    """On one batch of two scenes, the neighbor-map twins (sparse_conv_plain;
    the up conv's y product and row pick) against the key-matching twin
    (key_conv_plain): the same bf16 products summed in f32 in another
    order, within 1e-5 of max |out|."""
    cfg = PC.get_config(ARGS)
    coords = [r['vox_coords'] for r in scene_rets((3, 4), cfg)]
    keys = [torch.from_numpy(k) for k in keys_batch(coords)]
    maps = PDM.build_batch_maps_from_keys(tuple(keys))
    rng = np.random.default_rng(0)
    cin, cout = (6, 32) if mode == 'stem' else (32, 48)
    lin = 1 if mode in ('same3', 'up') else 0       # level of x
    x = torch.from_numpy(rng.normal(size=(keys[lin].numel(), cin)).astype(
        np.float32))
    K = {'same3': 27, 'stem': 125}.get(mode, 8)
    w = torch.from_numpy((rng.normal(size=(K, cin, cout))
                          * 0.2).astype(np.float32))
    if mode == 'same3':
        got = PCV.sparse_conv_plain(x, maps['nmap3_1'], w)
        want = KC.key_conv_plain(x, keys[1], keys[1].reshape(-1), w,
                                 kernel_size=3, scale=2)
    elif mode == 'down':
        got = PCV.sparse_conv_plain(x, maps['down0'], w)
        want = KC.key_conv_plain(x, keys[0], keys[1].reshape(-1), w,
                                 kernel_size=2, stride_child=True, scale=1,
                                 guard=False)
    elif mode == 'stem':
        got = PCV.sparse_conv_plain(x, maps['nmap5_0'], w)
        want = KC.key_conv_plain(x, keys[0], keys[0].reshape(-1), w,
                                 kernel_size=5)
    else:
        got = ops.up_conv(x, (maps['up_parent0'], maps['up_widx0']), w)
        want = KC.key_conv_plain(x, keys[1], keys[0].reshape(-1), w,
                                 kernel_size=2, stride_parent=True, scale=1,
                                 guard=False)
    assert got.dtype == want.dtype == torch.float32
    scale = want.abs().max().item()
    assert scale > 0.1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * scale)
