"""The port's visualizations (box2mask_torch/viz) against the JAX package's.

  * Every file export_scene_visualization writes is byte-equal to the JAX
    writer's on the same seeded scene, labels and result: the point PLYs,
    the box wireframe PLY, bbs.npy, the surface meshes under --mesh_viz and
    viewer.html; with and without labels and mesh_viz, with colours in
    [0, 1] and in [0, 255], and with no surviving mask.
  * The helpers alike: instance colours (one seeded generator per id),
    semantic colours, the mask overlay, wireframes with their default
    colours, the voxel surface mesh, and the viewer past max_points (the
    seed-0 subsample).
  * `python -m box2mask_torch.evaluate --predict_specific_scene
    synth00099_00` (the port's synthetic dataset lists that one scene, as
    the JAX package's does) from a checkpoint the JAX package wrote: the
    same file names as the JAX CLI's on the same checkpoint, the same
    instance and semantic colours (so the same masks, labels and mask
    order), bbs.npy within 1e-5. Both sides run --key_conv off
    --compute_dtype float32, where the forwards differ only in the order of
    f32 sums (tests/test_torch_forward.py), and the head weights are made
    crisp as in tests/test_torch_evaluate.py.
  * Under --spatial_shards the viz mode runs the one-device net, as the
    JAX Evaluater's load_or_predict does: the files equal those without
    the flag.
"""

import os
import shutil
import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import loader as JLd
from box2mask_tpu.engine import checkpoint as JCk
from box2mask_tpu.engine import state as JS
from box2mask_tpu.viz import export as JX
from box2mask_tpu.viz import html_viewer as JH
from box2mask_tpu.viz import surface as JSf
from box2mask_tpu.viz import wireframe as JW
from box2mask_torch import config as PC
from box2mask_torch import evaluate as cli
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.viz import export as PX
from box2mask_torch.viz import html_viewer as PH
from box2mask_torch.viz import surface as PSf
from box2mask_torch.viz import wireframe as PW

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def tree(d):
    """{relative path: bytes} of every file under d."""
    out = {}
    for r, _, fs in os.walk(d):
        for f in fs:
            with open(os.path.join(r, f), 'rb') as fh:
                out[os.path.relpath(os.path.join(r, f), d)] = fh.read()
    return out


def scene_case(case, n=700, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 4, (n, 3))
    colors = rng.uniform(0, 1, (n, 3))
    if case == 'colors_255':
        colors = rng.integers(0, 256, (n, 3)).astype(np.float64)
    scene = {'positions': pos, 'colors': colors}
    labels = {'instances': rng.integers(-2, 6, n),
              'semantics': rng.integers(0, 25, n),
              'per_instance_bb_centers': rng.uniform(1, 3, (4, 3)),
              'per_instance_bb_bounds': rng.uniform(.1, .5, (4, 3)),
              'per_instance_semantics': np.array([3, 4, 5, 30])}
    masks = [rng.uniform(size=n) < 0.3 for _ in range(5)]
    bbs = np.hstack([rng.uniform(size=(5, 1)), pos[:5],
                     pos[:5] + rng.uniform(.1, 1, (5, 3))])
    result = {'mask': masks, 'conf': list(rng.uniform(size=5)),
              'label_id': list(rng.integers(1, 40, 5)), 'bbs': bbs}
    if case == 'no_mask':       # the host oracle's result without a box
        result = {'conf': np.zeros(0), 'label_id': np.zeros(0, np.int32),
                  'mask': np.zeros((0, 0), bool)}
    return scene, (None if case == 'no_labels' else labels), result


@pytest.mark.parametrize('case', ['full', 'mesh_viz', 'no_labels',
                                  'no_mask', 'colors_255'])
def test_export_scene_visualization_bytes(tmp_path, case):
    scene, labels, result = scene_case(case)
    cfg = PC.get_config(['--voxel_size', '0.05'] + (
        ['--mesh_viz'] if case in ('mesh_viz', 'no_mask') else []))
    jcfg = JC.get_config(['--voxel_size', '0.05'] + (
        ['--mesh_viz'] if case in ('mesh_viz', 'no_mask') else []))
    JX.export_scene_visualization(str(tmp_path / 'jax' / 'scene0'), scene,
                                  labels, result, jcfg)
    PX.export_scene_visualization(str(tmp_path / 'port' / 'scene0'), scene,
                                  labels, result, cfg)
    want, got = tree(tmp_path / 'jax'), tree(tmp_path / 'port')
    assert sorted(got) == sorted(want)
    names = {os.path.basename(k) for k in got}
    assert ('pred_instances_mesh.ply' in names) == (case in ('mesh_viz',
                                                             'no_mask'))
    assert ('gt_instances.ply' in names) == (case != 'no_labels')
    for k in want:
        assert got[k] == want[k], k


def test_zero_boxes_reference_fault_not_copied(tmp_path):
    """Every box filtered out by the score threshold: the host oracle's viz
    result carries bbs of 0 rows. The JAX wireframe writer raises there, so
    its viz run stops; the port writes an empty wireframe PLY, and every
    other file as the JAX writers write them."""
    scene, labels, _ = scene_case('full')
    result = {'conf': np.zeros(0), 'label_id': np.zeros(0, np.int32),
              'mask': np.zeros((0, 700), bool), 'bbs': np.zeros((0, 7))}
    with pytest.raises(ValueError, match='broadcast'):
        JW.write_wireframe_ply(str(tmp_path / 'j.ply'), np.zeros((0, 3)),
                               np.zeros((0, 3)), np.zeros((0, 3)))
    PX.export_scene_visualization(str(tmp_path / 'port'), scene, labels,
                                  result)
    no_box = dict(result)
    del no_box['bbs']
    JX.export_scene_visualization(str(tmp_path / 'jax'), scene, labels,
                                  no_box)
    got, want = tree(tmp_path / 'port'), tree(tmp_path / 'jax')
    assert set(got) - set(want) == {'pred_bbs.ply', 'bbs.npy'}
    assert np.load(tmp_path / 'port' / 'bbs.npy').shape == (0, 7)
    assert b'element vertex 0\n' in got['pred_bbs.ply']
    assert b'element edge 0\n' in got['pred_bbs.ply']
    for k in want:
        if k != 'viewer.html':      # the viewer lists the (empty) box layer
            assert got[k] == want[k], k


def test_helpers_match():
    ids = np.array([0, -2, 3, 3, 7, -5, 11, 0, 250])
    np.testing.assert_array_equal(PX.instance_colors(ids),
                                  JX.instance_colors(ids))
    sem = np.array([-1, 0, 4, 19, 40, 1000])
    np.testing.assert_array_equal(PX.semantic_colors(sem),
                                  JX.semantic_colors(sem))
    rng = np.random.default_rng(1)
    masks = [rng.uniform(size=50) < 0.5 for _ in range(4)]
    conf = [0.3, 0.9, 0.1, 0.5]
    np.testing.assert_array_equal(PX.masks_to_instance_ids(masks, conf),
                                  JX.masks_to_instance_ids(masks, conf))
    assert PX.masks_to_instance_ids([], []) is None
    c, b = rng.uniform(0, 2, (3, 3)), rng.uniform(.1, .4, (3, 3))
    for p, j in zip(PW.bbs_lines(c, b), JW.bbs_lines(c, b)):
        np.testing.assert_array_equal(p, j)
    cols = rng.uniform(0, 255, (3, 3))
    for p, j in zip(PSf.voxel_surface_mesh(c, cols, 0.3),
                    JSf.voxel_surface_mesh(c, cols, 0.3)):
        assert p.dtype == j.dtype
        np.testing.assert_array_equal(p, j)


def test_wireframe_surface_viewer_bytes(tmp_path):
    """Wireframes with the default colours, the surface mesh, and the
    viewer past max_points (seeded subsample) and with its default title."""
    rng = np.random.default_rng(2)
    c, b = rng.uniform(0, 2, (5, 3)), rng.uniform(.1, .4, (5, 3))
    pos = rng.uniform(0, 3, (900, 3))
    cols = rng.uniform(-20, 300, (900, 3))
    for side, W, Sf, H in (('jax', JW, JSf, JH), ('port', PW, PSf, PH)):
        d = tmp_path / side
        d.mkdir()
        W.write_wireframe_ply(str(d / 'bbs.ply'), c, b)
        Sf.write_surface_mesh_ply(str(d / 'mesh.ply'), pos, cols,
                                  voxel_size=0.1)
        H.write_html_viewer(str(d / 'small.html'), pos,
                            [('a', cols, True), ('b', cols[::-1], False)],
                            [('l', c, c + b, np.full((5, 3), 9), True)],
                            max_points=100)
        H.write_html_viewer(str(d / 'all.html'), pos, [('a', cols, True)])
    want, got = tree(tmp_path / 'jax'), tree(tmp_path / 'port')
    assert sorted(got) == sorted(want) and len(got) == 4
    for k in want:
        assert got[k] == want[k], k


def test_synthetic_predict_specific_scene_lists_one_scene():
    args = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
            '--predict_specific_scene', 'synth00099_00']
    jds = JLd.get_dataset(JC.get_config(args), 'predict_specific_scene')
    pds = PLd.get_dataset(PC.get_config(args), 'predict_specific_scene')
    assert list(pds.data_list) == list(jds.data_list) == ['synth00099_00']


CLI_ARGS = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
            '--dataset_size', '4', '--vox_bucket', '512', '--seg_bucket',
            '64', '--layers', '1', '--num_workers', '2', '--fixed_seed', '10',
            '--key_conv', 'off', '--compute_dtype', 'float32', '--mesh_viz']
SCENE = 'synth00099_00'


def crisp_jax_checkpoint(exp_root):
    """A JAX init with each head's last layer scaled to 1e-3 and fixed
    biases, saved by the JAX package's save_checkpoint into its
    experiment under exp_root; returns the checkpoint's path."""
    os.environ['BOX2MASK_EXP_ROOT'] = exp_root
    jc = JC.get_config(CLI_ARGS + ['--predict_specific_scene', SCENE])
    ds = JLd.get_dataset(jc, 'predict_specific_scene', do_augmentations=False)
    dev_np, _ = next(iter(ds.get_loader(shuffle=False, drop_last=False,
                                        batch_size=1)))
    v = JS.init_variables(JS.build_model(jc, 20),
                          {k: jnp.asarray(a) for k, a in dev_np.items()})
    params = jax.tree_util.tree_map(np.array, v['params'])
    stats = jax.tree_util.tree_map(np.array, v['batch_stats'])
    for head, b in (('mlp_offsets', 0.0), ('mlp_bounds', 0.3),
                    ('mlp_bb_scores', 0.5), ('mlp_semantics', None)):
        lin = params[head]['Linear1x1_2']
        lin['kernel'] = (lin['kernel'] * 1e-3).astype(np.float32)
        if b is None:
            lin['bias'] = np.zeros_like(lin['bias'])
            lin['bias'][5], lin['bias'][8] = 2.0, 1.5
        else:
            lin['bias'] = np.full_like(lin['bias'], b)
    tx = JS.make_optimizer(jc)
    return JCk.save_checkpoint(
        jc.checkpoint_path, JS.TrainState(params, stats, tx.init(params),
                                          jnp.int32(0)), 3600.0, 1, 1)


def ply_colors(path):
    from box2mask_torch.datasets.ply import read_ply
    v = read_ply(path)['vertex']
    return np.stack([v['red'], v['green'], v['blue']], 1)


@pytest.fixture()
def viz_env(tmp_path, monkeypatch):
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    monkeypatch.setenv('BOX2MASK_COMPILE_CACHE', 'off')
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    monkeypatch.chdir(ROOT)
    return tmp_path


def test_cli_predict_specific_scene_matches_jax(viz_env, monkeypatch):
    import evaluate as jax_cli
    root = viz_env
    path = crisp_jax_checkpoint(str(root / 'jax'))
    port_ckpts = root / 'port' / 'synthetic' / 'checkpoints'
    port_ckpts.mkdir(parents=True)
    shutil.copy(path, port_ckpts)
    argv = CLI_ARGS + ['--predict_specific_scene', SCENE]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(root / 'jax'))
        jax_cli.main(list(argv))
        monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(root / 'port'))
        cli.main(list(argv))
    jdir = root / 'jax' / 'synthetic' / 'viz' / SCENE
    pdir = root / 'port' / 'synthetic' / 'viz' / SCENE
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert len(os.listdir(pdir)) == 10
    jb, pb = np.load(jdir / 'bbs.npy'), np.load(pdir / 'bbs.npy')
    assert len(jb) > 0 and pb.shape == jb.shape
    np.testing.assert_allclose(pb, jb, rtol=0, atol=1e-5)
    for f in ('pred_instances.ply', 'pred_semantics.ply'):
        np.testing.assert_array_equal(ply_colors(pdir / f),
                                      ply_colors(jdir / f))
    for f in ('rgb.ply', 'gt_instances.ply', 'gt_semantics.ply'):
        assert (pdir / f).read_bytes() == (jdir / f).read_bytes(), f
    # the colours are those of the port's masks: some instance survived
    assert len(np.unique(ply_colors(pdir / 'pred_instances.ply'), axis=0)) > 1


@pytest.mark.parametrize('mode', ['--produce_visualizations',
                                  '--submission_write_out'])
def test_spatial_shards_one_device_modes(viz_env, monkeypatch, mode):
    """Under --spatial_shards 2 the visualizations (and the submission
    write-out) run the one-device net on whole-scene batches, as the JAX
    Evaluater's load_or_predict does: the files equal those without the
    flag. The JAX CLI hands them the sharded batches, which its one-device
    init cannot read (KeyError)."""
    import evaluate as jax_cli
    argv = [a for a in CLI_ARGS if a not in ('--key_conv', 'off')] + [
        '--dataset_size', '2', mode]
    viz = mode == '--produce_visualizations'
    trees = []
    for sub, extra in (('one', []), ('sharded', ['--spatial_shards', '2'])):
        monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(viz_env / sub))
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            cli.main(argv + extra)
        out = viz_env / sub / 'synthetic'
        trees.append(tree(out / 'viz' if viz else
                          out / 'results' / 'untrained' / 'submission'))
    assert trees[0] == trees[1] and len(trees[0]) >= 2
    if viz:
        monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(viz_env / 'jax'))
        with pytest.raises(KeyError, match='vox_features'):
            jax_cli.main(argv + ['--spatial_shards', '2'])
