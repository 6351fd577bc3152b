"""The port's training host path against the JAX package's, bit for bit:
box-to-segment association, box supervision, the labelled train batch,
augmentation under a seeded per-scene RandomState, and the loader (scene
order, per-epoch shuffles, batches). Host code is NumPy on both sides."""

import numpy as np
import pytest

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import association as JA
from box2mask_tpu.datasets import augmentation as JAug
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import loader as JLd
from box2mask_tpu.datasets import supervision as JSup
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_torch import config as PC
from box2mask_torch.datasets import association as PA
from box2mask_torch.datasets import augmentation as PAug
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV

ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1', '--voxel_size', '0.05',
        '--vox_bucket', '512', '--seg_bucket', '64', '--use_normals_input',
        '--exp_name', 'torch_train_host', '--num_workers', '2']
SCENE = dict(num_instances=6, points_per_instance=250, floor_points=900,
             wall_points=700)
AUG = ['--augmentation', '--scaling_aug', '1.0', '0.8', '1.2',
       '--flipping_aug', '0.5', '--rotation_90_aug', '--apply_hue_aug',
       '--rotation_aug', '0.5', '--position_jittering', '0.5', '0.01',
       '--chromatic_auto_contrast', '0.3', '--chromatic_translation', '0.5',
       '0.1', '--color_jittering_aug', '0.5', '0.05', '--random_brightness',
       '0.5', '0.1', '--mix_3d_color_aug']


def configs(extra=()):
    pc, jc = PC.get_config(ARGS + list(extra)), JC.get_config(
        ARGS + list(extra))
    pc.use_native_host_ops = jc.use_native_host_ops = False
    return pc, jc


def assert_dicts_equal(a, b, keys=None):
    for k in keys or b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize('extra', [
    [], ['--smallest_bb_heuristic'], ['--majority_vote'],
    ['--point_association'], ['--dropout_boxes', '0.3'],
    ['--noisy_boxes', '0.05', '--smallest_bb_heuristic']])
def test_associate_scannet_bit_equal(extra):
    pc, jc = configs(extra)
    scene, labels = PSyn.make_scene(seed=8, **SCENE)
    segs = np.unique(scene['segments'])[3:]      # a segment absent too
    got = PA.associate_scannet(labels, scene, pc, segs)
    want = JA.associate_scannet(labels, scene, jc, segs)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        elif isinstance(b, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('extra', [['--smallest_bb_heuristic'], []])
def test_supervision_and_train_batch_bit_equal(extra):
    """voxelize -> build_supervision -> build_batch(mode='train'): every key
    of both batches, including the labels."""
    pc, jc = configs(extra)
    prets, jrets = [], []
    for s in (3, 4):
        scene, labels = PSyn.make_scene(seed=s, **SCENE)
        for rets, vox, sup, cfg in ((prets, PV, PSup, pc),
                                    (jrets, JV, JSup, jc)):
            ret = vox.voxelize_scene(scene, cfg)
            ret['labels'] = labels
            sup.build_supervision(ret, labels, scene, cfg, 'scannet')
            rets.append(ret)
    for pr, jr in zip(prets, jrets):
        assert_dicts_equal(pr, jr, ('gt_bb_offsets', 'gt_bb_bounds',
                                    'fg_instances', 'gt_semantics'))
    pd, ph = PB.build_batch(prets, pc, PT.SCANNET_SEMANTIC_ID2IDX)
    jd, jh = JB.build_batch(jrets, jc, JT.SCANNET_SEMANTIC_ID2IDX,
                            mode='train')
    assert set(pd) == set(jd)
    for k in ('gt_bb_offsets', 'gt_bb_bounds', 'fg_instances',
              'gt_semantics', 'gt_semantics_idx'):
        assert k in pd
    assert_dicts_equal(pd, jd)
    assert pd['fg_instances'].any()
    for a, b in zip(ph['instance_ids'], jh['instance_ids']):
        assert a is None and b is None or np.array_equal(a, b)


def test_map_semantics_and_segment_mode_bit_equal():
    ids = np.array([-5, 0, 1, 3, 22, 39, 40, 41, 100])
    np.testing.assert_array_equal(
        PB.map_semantics_to_idx(ids, PT.SCANNET_SEMANTIC_ID2IDX),
        JB.map_semantics_to_idx(ids, JT.SCANNET_SEMANTIC_ID2IDX))
    rng = np.random.default_rng(0)
    vals, seg = rng.integers(-2, 6, 500), rng.integers(0, 40, 500)
    np.testing.assert_array_equal(PV.segment_mode(vals, seg, 40),
                                  JV.segment_mode(vals, seg, 40))


@pytest.mark.parametrize('epoch', [0, 3])
def test_augment_scene_bit_equal_under_scene_rng(epoch):
    pc, jc = configs(AUG + ['--fixed_seed', '17'])
    scene, _ = PSyn.make_scene(seed=5, **SCENE)
    rp = PLd.scene_rng(pc, 'synth00005_00', epoch)
    rj = JLd.scene_rng(jc, 'synth00005_00', epoch)
    assert rp.randint(0, 2 ** 31) == rj.randint(0, 2 ** 31)
    got = PAug.augment_scene(scene, pc, rng=rp)
    want = JAug.augment_scene(scene, jc, rng=rj)
    assert_dicts_equal(got, want, ('positions', 'colors', 'normals',
                                   'segments'))
    assert not np.array_equal(got['positions'], scene['positions'])


def test_loader_bit_equal():
    """Synthetic train set with augmentation under --fixed_seed: the same
    order and the same batches as the JAX loader, epoch after epoch."""
    extra = AUG + ['--fixed_seed', '3', '--dataset_size', '5',
                   '--batch_size', '2', '--synthetic_instances', '3',
                   '--synthetic_points_per_instance', '150',
                   '--synthetic_floor_points', '400',
                   '--synthetic_wall_points', '300']
    pc, jc = configs(extra)
    pl = PLd.get_dataset(pc, 'train').get_loader()
    jl = JLd.get_dataset(jc, 'train').get_loader()
    assert len(pl) == len(jl) == 2
    for epoch in (0, 1):
        pl.set_epoch(epoch)
        jl.set_epoch(epoch)
        np.testing.assert_array_equal(pl._order(), jl._order())
        batches = list(zip(pl, jl))
        assert len(batches) == 2
        for (pd, ph), (jd, jh) in batches:
            assert [s['name'] for s in ph['scene']] == [
                s['name'] for s in jh['scene']]
            assert set(pd) == set(jd)
            assert_dicts_equal(pd, jd)
    pl.close()


def test_other_datasets_raise():
    pc, _ = configs(['--bb_supervision'])
    scene, labels = PSyn.make_scene(seed=1, **SCENE)
    ret = PV.voxelize_scene(scene, pc)
    with pytest.raises(NotImplementedError, match='A15'):
        PSup.build_supervision(ret, labels, scene, pc, 'arkitscenes')
    pc.dataset_name = 's3dis'
    with pytest.raises(NotImplementedError, match='A15'):
        PLd.get_dataset(pc, 'train')
