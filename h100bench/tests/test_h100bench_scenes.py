"""The benchmark's frozen scene generators: seeded, and equal to the
program's generators they were copied from (the tests may import the
program; the benchmark's generators do not)."""

import numpy as np
import pytest

from h100bench import scenes as G

SMALL = dict(num_instances=4, points_per_instance=300, floor_points=1500,
             wall_points=1000)


def _same(a, b):
    assert a.keys() <= b.keys() or b.keys() <= a.keys()
    for k in a.keys() & b.keys():
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('seed', [0, 7, 2**31 + 5])
def test_scannet_scene_is_the_programs(seed):
    from box2mask_torch.datasets import synthetic
    s, lab = G.scannet_scene(seed, 'x', segs_per_instance=6, **SMALL)
    ps, plab = synthetic.make_scene(seed=seed, name='x', segs_per_instance=6,
                                    **SMALL)
    _same(s, ps)
    _same(lab, plab)


def test_scannet_scene_is_seeded():
    a, _ = G.scannet_scene(3, 'a', **SMALL)
    b, _ = G.scannet_scene(3, 'b', **SMALL)
    c, _ = G.scannet_scene(4, 'c', **SMALL)
    np.testing.assert_array_equal(a['positions'], b['positions'])
    assert not np.array_equal(a['positions'][:100], c['positions'][:100])
    assert len(a['positions']) == 1500 + 1000 + 4 * 300


@pytest.mark.parametrize('seed', [1, 11])
def test_make_room_is_the_fixtures(seed):
    from box2mask_torch.datasets import fixtures
    mine = G.make_room(np.random.default_rng(seed), 5000, 3,
                       size=(4.0, 3.0, 2.0), yaw=True)
    theirs, _ = fixtures.make_room(np.random.default_rng(seed), 5000, 3,
                                   size=(4.0, 3.0, 2.0), yaw=True)
    _same(mine, theirs)


def test_arkit_scene_as_the_reader_gives_it():
    from box2mask_torch.datasets import fixtures
    from box2mask_torch.datasets.ply import compute_vertex_normals
    s, lab = G.arkit_scene(5, 'r', n_vertices=4000, n_objects=2,
                           room_size=(3.0, 2.5, 1.2), subsample_rate=2)
    mesh, _ = fixtures.make_room(np.random.default_rng(5), 4000, 2,
                                 size=(3.0, 2.5, 1.2), yaw=True)
    assert lab is None
    np.testing.assert_array_equal(s['positions'], mesh['positions'][::2])
    np.testing.assert_allclose(
        s['normals'],
        compute_vertex_normals(mesh['positions'], mesh['faces'])[::2],
        atol=1e-12)
    np.testing.assert_array_equal(s['segments'], mesh['segments'][::2])


@pytest.mark.parametrize('seed', [2, 9, 123456])
def test_augment_is_the_presets(seed):
    from box2mask_torch.datasets import augmentation
    from h100bench import port
    from h100bench_tiny import REPO, load_config
    config = load_config(REPO, 'scannet')
    cfg = port.make_cfg(config)
    scene, _ = G.scannet_scene(seed, 'x', **SMALL)
    mine = G.augment(scene, config['augmentation'],
                     np.random.RandomState(seed))
    theirs = augmentation.augment_scene(scene, cfg,
                                        rng=np.random.RandomState(seed))
    np.testing.assert_array_equal(mine['positions'], theirs['positions'])
    np.testing.assert_array_equal(mine['colors'], theirs['colors'])
    assert not np.array_equal(mine['positions'], scene['positions'])
