"""The port's dataset readers (datasets/{ply,scannet,arkitscenes,s3dis}.py),
the augmentations only they use, their supervision branches and the loader
on their datasets, against the JAX package's, bit for bit.

Both read the same on-disk datasets, written at a small size by the port's
datasets/fixtures.py in the layouts of the three readers (the files
tests/test_readers.py writes, at more scenes and points). Every scene and
label array, every supervision array and every host batch must be equal
in dtype, shape and value, in 'train' mode (augmentation on, each
reader's full suite, drawn from the same seeded RandomState) and in 'val'
mode. Host data is NumPy on both sides; use_native_host_ops is off on both
(the C voxelizer and cKDTree may pick different nearest points on ties).
"""

import os

import numpy as np
import pytest

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import arkitscenes as JArk
from box2mask_tpu.datasets import augmentation as JAug
from box2mask_tpu.datasets import loader as JLd
from box2mask_tpu.datasets import ply as JPly
from box2mask_tpu.datasets import s3dis as JS3
from box2mask_tpu.datasets import scannet as JScn
from box2mask_tpu.datasets import supervision as JSup
from box2mask_tpu.datasets import voxelize as JV
from box2mask_torch import config as PC
from box2mask_torch.datasets import arkitscenes as PArk
from box2mask_torch.datasets import augmentation as PAug
from box2mask_torch.datasets import fixtures as F
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.datasets import ply as PPly
from box2mask_torch.datasets import s3dis as PS3
from box2mask_torch.datasets import scannet as PScn
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import voxelize as PV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = {'scannet': 'scannet.txt', 'arkitscenes': 'arkitscenes.txt',
           's3dis': 's3dis_fold5.txt'}
READERS = {'scannet': (PScn, JScn), 'arkitscenes': (PArk, JArk),
           's3dis': (PS3, JS3)}
# every augmentation the readers draw, each with a fair chance to fire
AUG = ['--augmentation', '--rotation_aug', '0.7', '0.05', '0.8',
       '--rotation_90_aug', '--flipping_aug', '0.5', '--HAIS_jitter_aug',
       '--elastic_distortion', '0.7', '--elastic_distortion_HAIS', '0.7',
       '--position_jittering', '0.7', '0.01', '--scaling_aug', '0.7', '0.8',
       '1.2', '--chromatic_auto_contrast', '0.5', '--chromatic_translation',
       '0.7', '0.1', '--color_jittering_aug', '0.7', '0.05',
       '--random_brightness', '0.7', '0.1', '--apply_hue_aug']


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Small on-disk datasets of all three layouts, 'train' and 'val'."""
    root = tmp_path_factory.mktemp('readers')
    dirs = {k: str(root / k) for k in PRESETS}
    os.makedirs(dirs['scannet'])
    split = F.write_scannet(
        dirs['scannet'], ['scene0000_00', 'scene0001_00', 'scene0002_00'],
        n_vertices=6000, n_objects=4, seed=1,
        split={'train': ['scene0002_00'],
               'val': ['scene0000_00', 'scene0001_00']})
    F.write_arkitscenes(dirs['arkitscenes'], ['41000001', '41000002'],
                        'Validation', n_vertices=8000, n_objects=4, seed=2)
    F.write_arkitscenes(dirs['arkitscenes'], ['40000003'], 'Training',
                        n_vertices=8000, n_objects=4, seed=3)
    F.write_s3dis(dirs['s3dis'], ['Area_5.office_1', 'Area_5.hallway_2',
                                  'Area_1.office_3'],
                  n_points=16000, n_objects=4, seed=4)
    return dirs, split


def configs(dataset, data, extra=()):
    dirs, split = data
    args = ['--config', os.path.join(ROOT, 'configs', PRESETS[dataset]),
            '--data_dir', dirs[dataset], '--data_split', split,
            '--voxel_size', '0.05', '--vox_bucket', '512',
            '--seg_bucket', '64', '--num_workers', '2',
            '--exp_name', 'torch_readers'] + list(extra)
    pc, jc = PC.get_config(args), JC.get_config(args)
    pc.use_native_host_ops = jc.use_native_host_ops = False
    return pc, jc


def assert_same(a, b, what=''):
    """Two dicts (or arrays, or values) equal in dtype, shape and value."""
    if isinstance(b, dict):
        assert set(a) == set(b), (what, set(a) ^ set(b))
        for k in b:
            assert_same(a[k], b[k], f'{what}.{k}')
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f'{what}[{i}]')
    elif isinstance(b, (np.ndarray, np.generic)):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def test_ply_round_trip_both_ways(tmp_path):
    """The port's PLY writers read back by both packages' readers, and the
    JAX package's writers by the port's reader: positions, colours, faces
    and vertex normals bit-equal."""
    rng = np.random.default_rng(0)
    mesh, _ = F.make_room(rng, 3000, 3)
    pos, faces, col = mesh['positions'], mesh['faces'], mesh['colors']
    for pkg_w, pkg_r in ((PPly, JPly), (JPly, PPly), (PPly, PPly)):
        for kind in ('mesh', 'points'):
            p = str(tmp_path / f'{kind}.ply')
            if kind == 'mesh':
                pkg_w.write_ply_mesh(p, pos, faces, col)
            else:
                pkg_w.write_ply_points(p, pos, col)
            got, want = pkg_r.read_mesh(p), JPly.read_mesh(p)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    assert_same(g, w, kind)
            np.testing.assert_allclose(got[0], pos, atol=1e-5)
            if kind == 'mesh':
                np.testing.assert_array_equal(got[2], faces)
                assert_same(PPly.compute_vertex_normals(got[0], got[2]),
                            JPly.compute_vertex_normals(got[0], got[2]))
    assert_same(PPly.read_ply(p), JPly.read_ply(p))


@pytest.mark.parametrize('fn', ['hais_jitter', 'elastic_distortion',
                                'hais_elastic'])
def test_reader_augmentations_bit_equal(fn):
    x = np.random.default_rng(5).uniform(-3, 3, (2000, 3))
    args = {'hais_jitter': (), 'elastic_distortion': (0.2, 0.4),
            'hais_elastic': (2.0, 16.0)}[fn]
    got = getattr(PAug, fn)(x, *args, rng=np.random.RandomState(7))
    want = getattr(JAug, fn)(x, *args, rng=np.random.RandomState(7))
    assert_same(got, want)
    assert not np.array_equal(got, x)


@pytest.mark.parametrize('mode', ['train', 'val'])
@pytest.mark.parametrize('dataset', ['scannet', 'arkitscenes', 's3dis'])
def test_process_scene_bit_equal(data, dataset, mode):
    """process_scene of every scene of the split: train with the whole
    augmentation suite, val without (S3DIS: the random point subsample at
    train, [::4] at val)."""
    pc, jc = configs(dataset, data, AUG)
    names = PLd.get_dataset(pc, mode).data_list
    assert list(names) == list(JLd.get_dataset(jc, mode).data_list)
    assert len(names) >= 1
    port, ref = READERS[dataset]
    kw = {'arkitscenes': {'subsample_rate': pc.subsample_rate}}.get(
        dataset, {})
    for i, name in enumerate(names):
        got = port.process_scene(name, mode, pc, do_augmentations=mode
                                 == 'train', rng=np.random.RandomState(i),
                                 **kw)
        want = ref.process_scene(name, mode, jc, do_augmentations=mode
                                 == 'train', rng=np.random.RandomState(i),
                                 **kw)
        assert_same(got, want, name)
        assert len(got[0]['positions']) > 500


@pytest.mark.parametrize('pool', [True, False])
@pytest.mark.parametrize('dataset', ['arkitscenes', 's3dis'])
def test_box_supervision_bit_equal(data, dataset, pool):
    """The ARKitScenes and S3DIS box supervision (association with
    oriented boxes; foreground boxes then background boxes with majority
    votes) on a train scene, with segment pooling on and off."""
    extra = ['--point_association'] if not pool else []
    pc, jc = configs(dataset, data, extra)
    if not pool:
        pc.do_segment_pooling = jc.do_segment_pooling = False
    name = PLd.get_dataset(pc, 'train').data_list[0]
    port, _ = READERS[dataset]
    kw = {'arkitscenes': {'subsample_rate': pc.subsample_rate}}.get(
        dataset, {})
    scene, labels = port.process_scene(name, 'train', pc, **kw)
    rets = []
    for V, Sup, cfg in ((PV, PSup, pc), (JV, JSup, jc)):
        ret = V.voxelize_scene(scene, cfg)
        Sup.build_supervision(ret, labels, scene, cfg, dataset, 'train')
        rets.append(ret)
    assert_same(rets[0], rets[1])
    assert rets[0]['fg_instances'].sum() > 0


@pytest.mark.parametrize('mode', ['train', 'val'])
@pytest.mark.parametrize('dataset', ['scannet', 'arkitscenes', 's3dis'])
def test_loader_batches_bit_equal(data, dataset, mode):
    """The loader over each reader under --fixed_seed (augmentation in
    'train' as the preset ships it): the same scene order, device batches
    and host dicts as the JAX loader's."""
    pc, jc = configs(dataset, data, ['--fixed_seed', '3', '--batch_size',
                                     '2'])
    pl = PLd.get_dataset(pc, mode).get_loader(shuffle=mode == 'train',
                                              drop_last=False)
    jl = JLd.get_dataset(jc, mode).get_loader(shuffle=mode == 'train',
                                              drop_last=False)
    n = 0
    for (pd, ph), (jd, jh) in zip(pl, jl):
        assert_same(pd, jd, 'dev')
        for k in ('scene', 'labels', 'vox2point', 'seg2vox', 'num_voxels',
                  'input_location'):
            assert_same(ph[k], jh[k], k)
        n += len(ph['scene'])
    pl.close()
    assert n == len(pl.dataset) >= 1


def test_presets_read_the_dataset_flags():
    """The flags the readers read, on each dataset preset and on the
    command line: the JAX package's values."""
    keys = ('data_split', 'subsample_rate', 's3dis_split_fold',
            'point_sampling_rate', 'superpoint_algo',
            'ignore_wall_ceiling_floor', 'ignore_ceiling_floor',
            'full_resolution', 'elastic_distortion',
            'elastic_distortion_HAIS', 'HAIS_jitter_aug',
            'cluster_th_search', 'score_th_search', 'mask_bin_th_search',
            'mask_nms_th_search')
    for preset in list(PRESETS.values()) + ['s3dis_fold1.txt',
                                            'synthetic.txt']:
        args = ['--config', os.path.join(ROOT, 'configs', preset)]
        extra = [[], ['--full_resolution', '--cluster_th_search', '0.1',
                      '0.2', '3', '--ignore_ceiling_floor']]
        for e in extra:
            pc, jc = PC.get_config(args + e), JC.get_config(args + e)
            for k in keys:
                assert getattr(pc, k) == getattr(jc, k), (preset, k)
    pc = PC.get_config(['--config', os.path.join(ROOT, 'configs',
                                                 's3dis_fold5.txt')])
    assert (pc.point_sampling_rate, pc.ignore_wall_ceiling_floor,
            pc.s3dis_split_fold) == (0.25, True, 5)
