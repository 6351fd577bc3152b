"""The plain reference (h100bench/reference/) against the program's plain-
twin path at a tiny size on the CPU: with the program's bf16 rounding off
(f32 activations and operands, unrounded twins) both compute the same
function, so they agree to f32 round-off. The tests import the program;
the reference does not."""

import numpy as np
import pytest
import torch

from h100bench import weights
from h100bench.kinds.common import make_scenes, reference_batch, scene_seeds
from h100bench.reference import numerics as RN
from h100bench.reference import post as RP
from h100bench.reference import targets as RT
from h100bench.reference import voxel
from h100bench.reference.net import Adam, Net, is_trained, losses
from h100bench_tiny import f32_config, load_config, make_root, \
    unrounded_twins

CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    r = make_root(tmp_path_factory.mktemp('ref'))
    f32_config(r, 'scannet')
    return r


def _port_cfg(root, name):
    from h100bench import port
    config = load_config(root, name)
    return port, config, port.make_cfg(config)


@pytest.mark.parametrize('name,seed', [('scannet', 3), ('scannet', 2**33),
                                       ('arkitscenes', 4)])
def test_voxels_are_the_programs(root, name, seed):
    from box2mask_torch.datasets.voxelize import voxelize_scene
    _, config, cfg = _port_cfg(root, name)
    aug = config.get('augmentation') if name == 'scannet' else None
    (scene, _), = make_scenes(config, scene_seeds(seed, 1), augment=aug)
    want = voxelize_scene(scene, cfg)
    got = voxel.voxelize(scene, config['model']['voxel_size'])
    np.testing.assert_array_equal(got['coords'], want['vox_coords'])
    np.testing.assert_array_equal(got['features'], want['vox_features'])
    np.testing.assert_array_equal(got['point_vox'], want['vox2point'])
    np.testing.assert_array_equal(got['segments'],
                                  want['unique_vox_segments'])
    np.testing.assert_array_equal(got['seg_loc'], want['input_location'])


@pytest.mark.parametrize('name', ['scannet', 'arkitscenes'])
def test_parameters_are_the_programs(root, name):
    from box2mask_torch.engine import state as S
    _, config, cfg = _port_cfg(root, name)
    spec = {n: tuple(s) for n, s, _ in weights.specs(config)}
    model = S.build_model(cfg, len(config['classes']['valid_ids']), CPU)
    assert spec == {k: tuple(v.shape) for k, v in model.state_dict().items()}


def _batch(root, name, seed, n, mode):
    port, config, cfg = _port_cfg(root, name)
    aug = config.get('augmentation') if mode == 'train' else None
    items = make_scenes(config, scene_seeds(seed, n), augment=aug)
    dev, host = port.host_batch(cfg, config, items, mode)
    return port, config, cfg, items, dev, host


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_eval_heads_match(root):
    from box2mask_torch.engine import state as S
    port, config, cfg, items, dev, _ = _batch(root, 'scannet', 5, 2, 'test')
    w = weights.make(config, 5, CPU)
    model = port.build_model(cfg, config, w, CPU)
    with unrounded_twins(), torch.no_grad():
        pred = S.forward(model, port.upload(dev, CPU))
    rb = reference_batch(config, items, CPU)
    with torch.no_grad():
        ref = Net(w, config['model']['heads'], 2, RN.Numerics.reference())(
            rb['geo'], rb['feats'], rb['pool'], rb['n_seg'])
    for h, r in ref.items():
        assert _rel(pred[h][:rb['n_seg']], r) < 1e-4, h


def test_targets_loss_and_gradients_match(root):
    from box2mask_torch.engine import state as S
    port, config, cfg, items, dev, _ = _batch(root, 'scannet', 6, 2,
                                              'train')
    m = config['model']
    rb = reference_batch(config, items, CPU)
    n = rb['n_seg']
    tg = [RT.scene_targets(s, lab, v, config['classes']['valid_ids'],
                           config['classes']['foreground'])
          for (s, lab), v in zip(items, rb['vox'])]
    cat = {k: np.concatenate([t[k] for t in tg]) for k in tg[0]}
    np.testing.assert_array_equal(cat['fg'], dev['fg_instances'][:n])
    np.testing.assert_array_equal(cat['offsets'], dev['gt_bb_offsets'][:n])
    np.testing.assert_array_equal(cat['bounds'], dev['gt_bb_bounds'][:n])
    np.testing.assert_array_equal(cat['sem_idx'],
                                  dev['gt_semantics_idx'][:n])

    w = weights.make(config, 6, CPU)
    model = port.build_model(cfg, config, w, CPU)
    state = S.TrainState(model, S.make_optimizer(cfg), None)
    with unrounded_twins():
        ld = S.forward_losses(cfg, state, port.upload(dev, CPU), 1.0, 0.0)
        S.backward(ld)
    params = {k: v.clone().requires_grad_() for k, v in w.items()
              if is_trained(k)}
    full = dict(w, **params)
    tgt = {k: torch.as_tensor(v) for k, v in cat.items()}
    tgt['loc'] = torch.as_tensor(np.concatenate(
        [v['seg_loc'] for v in rb['vox']]))
    loss = losses(Net(full, m['heads'], 2, RN.Numerics.reference(),
                      train=True, remat=True)(
        rb['geo'], rb['feats'], rb['pool'], n), tgt,
        dict(m['loss_weights'], min_bb_size=m['min_bb_size']))
    want = float(ld['optimization_loss'])
    assert abs(float(loss.detach()) - want) < 1e-5 * want
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    norms = {k: float(g.norm()) for k, g in grads.items()}
    med = float(np.median(list(norms.values())))
    for k, p in model.named_parameters():
        gap = float((p.grad - grads[k]).norm()) / max(norms[k], med)
        assert gap < 1e-3, k


def test_adam_is_the_programs():
    from box2mask_torch.engine.optim import Optimizer
    g = torch.Generator().manual_seed(0)
    p = [torch.randn(5, 3, generator=g), torch.randn(7, generator=g)]
    mine = {str(i): t.clone() for i, t in enumerate(p)}
    tx = Optimizer('adam')
    st = tx.init(p)
    adam = Adam(mine)
    for step in range(3):
        grads = [torch.randn(t.shape, generator=g) for t in p]
        for t, gr in zip(p, grads):
            t.grad = gr
        tx.update(p, st, 1e-3)
        adam.step(mine, {str(i): gr for i, gr in enumerate(grads)}, 1e-3)
    for i, t in enumerate(p):
        torch.testing.assert_close(mine[str(i)], t, rtol=1e-6, atol=0)


@pytest.mark.parametrize('name', ['scannet', 'arkitscenes'])
def test_post_processing_is_the_programs(root, name):
    """The reference post-processing of the program's own heads gives the
    program's results: the same masks, classes and confidences."""
    from box2mask_torch.engine import state as S
    from h100bench import checks
    port, config, cfg, items, dev, host = _batch(root, name, 8, 2, 'test')
    w = weights.make(config, 8, CPU)
    pipe = port.pipeline(cfg, config, port.build_model(cfg, config, w, CPU),
                         CPU)
    (results, _, _, _), = list(pipe.run(None, [(dev, host)], cfg.eval_ths))
    pred = S.forward(pipe.model, port.upload(dev, CPU))
    rb = reference_batch(config, items, CPU)
    m = config['model']
    for i, (scene, _) in enumerate(items):
        lo, hi = rb['seg_off'][i], rb['seg_off'][i + 1]
        v = rb['vox'][i]
        want = RP.scene_masks(
            {'offsets': pred['mlp_offsets'][lo:hi].numpy(),
             'bounds': pred['mlp_bounds'][lo:hi].numpy(),
             'scores': pred['mlp_bb_scores'][lo:hi, 0].numpy(),
             'semantics': pred['mlp_semantics'][lo:hi].numpy()},
            v['seg_loc'], v['vox_seg_row'], v['point_seg_row'],
            m['eval_ths'], config['classes']['valid_ids'],
            config['classes']['foreground'], m['min_bb_size'],
            config['eval']['max_masks'], RN.Numerics.reference())
        got = results[scene['name']]
        assert len(want['conf']) > 0
        np.testing.assert_array_equal(want['label_id'], got['label_id'])
        np.testing.assert_allclose(want['conf'], got['conf'], rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(want['mask'], got['mask'])
        assert checks.mask_miss(got, want) == (0, 2 * len(want['conf']))
