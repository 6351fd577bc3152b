"""Spatially sharded evaluation and training of the port as users run them,
on gloo ranks on the CPU, against the JAX package's sharded Evaluater and
the port's one-device evaluation.

  * Evaluater.spatial_dataset_results on 2 ranks (2 synthetic val scenes,
    f32, --key_conv off: the neighbor-map route the JAX package takes on
    the CPU) against the JAX Evaluater's spatial_dataset_results on 2
    devices and against the port's one-device evaluation, with the bounds
    of tests/test_spatial_unet.py test_sharded_eval_matches_single_device:
    per scene the confidences within rtol 1e-3, the labels equal, fewer
    than 1e-3 of the mask bits apart; one shard's pad is smaller than the
    scene; the AP table comes out of the sharded path on rank 0.
  * `python -m box2mask_torch.train --spatial_shards 2` under
    BOX2MASK_PLATFORM=cpu: 2 epochs of 2 scenes on 2 gloo ranks, the
    ranks' parameters equal at the end, checkpoints from rank 0 that load
    into the one-device SelectionNet and the Model facade; a one-device
    checkpoint loads into the SpatialSelectionNet; then `python -m
    box2mask_torch.evaluate --spatial_shards 2` from that checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.datasets.loader import get_dataset as jget_dataset
from box2mask_tpu.engine.evaluate import Evaluater as JEvaluater
from box2mask_torch import config as PC
from box2mask_torch import model as PM
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.parallel import spatial as SP
from test_torch_parallel_common import run_ranks
from test_torch_train_common import remove_tmp_path  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ['--dataset_name', 'synthetic', '--exp_name', 'speval',
        '--network_heads', 'mlp_offsets', 'mlp_bounds', 'mlp_bb_scores',
        'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision', '--smallest_bb_heuristic',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1',
        '--voxel_size', '0.05', '--vox_bucket', '512',
        '--seg_bucket', '64', '--layers', '1', '--num_workers', '1',
        '--dataset_size', '2', '--fixed_seed', '10',
        '--eval_ths', '0.5', '0.05', '0.3', '0.6',
        '--compute_dtype', 'float32']
SPATIAL = ['--spatial_shards', '2', '--spatial_gather_level', '2']


def eval_worker(rank, world, group, cfg, state_dict):
    """Rank `rank`'s spatial_dataset_results from the weights
    `state_dict`, and on rank 0 the ScanNet protocol over them."""
    model = S.build_model(cfg, 20, 'cpu')
    model.load_state_dict(state_dict)
    tx = S.make_optimizer(cfg)
    state = S.TrainState(model, tx, tx.init(list(model.parameters())))
    ev = Evaluater(cfg, state=state, rank=rank, world_size=world,
                   group=group)
    ds = get_dataset(cfg, 'val', do_augmentations=False)
    results, entries = ev.spatial_dataset_results(ds)
    avgs = ev.scannet_eval(results, entries) if rank == 0 else None
    return {'results': results, 'ap50': None if avgs is None
            else avgs['all_ap_50%']}


def assert_same_results(a, b):
    assert set(a) == set(b)
    for name in a:
        r, g = a[name], b[name]
        assert len(r['conf']) == len(g['conf']), name
        ro = np.argsort(-np.asarray(r['conf']), kind='stable')
        go = np.argsort(-np.asarray(g['conf']), kind='stable')
        np.testing.assert_allclose(np.asarray(r['conf'])[ro],
                                   np.asarray(g['conf'])[go], rtol=1e-3)
        np.testing.assert_array_equal(np.asarray(r['label_id'])[ro],
                                      np.asarray(g['label_id'])[go])
        rm, gm = np.asarray(r['mask'])[ro], np.asarray(g['mask'])[go]
        assert rm.shape == gm.shape
        if rm.size:
            assert (rm != gm).mean() < 1e-3, (rm != gm).mean()


def test_spatial_eval_matches_jax_and_one_device(tmp_path, monkeypatch):
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    args = BASE + ['--key_conv', 'off']
    jc_sd, jc_sp = JC.get_config(args), JC.get_config(args + SPATIAL)
    ev_sd = JEvaluater(jc_sd)
    jds = jget_dataset(jc_sd, 'val', do_augmentations=False)
    ev_sd.dataset_prediction(jds, batch_size=1, cache=False)
    ev_sp = JEvaluater(jc_sp, state=ev_sd.state, model=ev_sd.model)
    jres, _ = ev_sp.spatial_dataset_results(
        jget_dataset(jc_sp, 'val', do_augmentations=False))
    sd = from_flax(ev_sd.state.params, ev_sd.state.batch_stats)

    pc_sd, pc_sp = PC.get_config(args), PC.get_config(args + SPATIAL)
    res = run_ranks(eval_worker, 2, tmp_path / 'ranks', pc_sp, sd)
    assert res[1]['results'] == {}
    got = res[0]['results']
    assert_same_results(jres, got)
    assert np.isfinite(res[0]['ap50'])

    model = S.build_model(pc_sd, 20, 'cpu')
    model.load_state_dict(sd)
    tx = S.make_optimizer(pc_sd)
    one, _ = Evaluater(pc_sd, state=S.TrainState(
        model, tx, tx.init(list(model.parameters())))).fused_dataset_results(
        get_dataset(pc_sd, 'val', do_augmentations=False), cache=False)
    assert_same_results(one, got)

    # one shard's pad is smaller than the scene
    _, host = next(iter(get_dataset(pc_sp, 'val', do_augmentations=False)
                        .get_loader(shuffle=False, drop_last=False,
                                    batch_size=1)))
    assert host['spatial_meta']['pads'][0] < host['num_voxels'][0]


RECIPE = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
          '--dataset_size', '2', '--vox_bucket', '512', '--seg_bucket', '64',
          '--layers', '1', '--num_workers', '1', '--ckpt_every', '1',
          '--fixed_seed', '3'] + SPATIAL


def cli(module, args, root):
    env = dict(os.environ, BOX2MASK_EXP_ROOT=root, BOX2MASK_PLATFORM='cpu',
               OMP_NUM_THREADS='1')
    p = subprocess.run([sys.executable, '-m', module] + args, cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-5000:]
    return p.stdout


def test_train_and_eval_cli_spatial_shards(tmp_path, monkeypatch):
    root = str(tmp_path)
    out = cli('box2mask_torch.train', RECIPE + ['--num_epochs', '2'], root)
    losses = [float(line.split('loss ')[1].split()[0])
              for line in out.splitlines() if ' loss ' in line]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert '2 ranks ended with equal parameters' in out
    ckpts = ckpt.list_checkpoints(os.path.join(root, 'synthetic',
                                               'checkpoints'))
    assert len(ckpts) == 1          # the epoch-1 head (rank 0 alone)

    monkeypatch.setenv('BOX2MASK_EXP_ROOT', root)
    cfg = PC.get_config(RECIPE)
    one = S.build_model(cfg, 20, 'cpu')
    tx = S.make_optimizer(cfg)
    state = S.TrainState(one, tx, tx.init(list(one.parameters())))
    ckpt.load_checkpoint(ckpts[0][1], state)          # strict
    ids, id2idx, _, is_fg = PT.get_tables('scannet')
    pm = PM.Model(cfg, ids, id2idx, np.arange(len(ids)), is_fg,
                  device='cpu')
    pm.ensure_state()
    assert pm.load_checkpoint()[0] == 1
    for k, v in pm.state_dict()['params'].items():
        np.testing.assert_array_equal(v, one.state_dict()[k].numpy())
    # the reverse: a one-device checkpoint into the spatial net
    path = ckpt.save_checkpoint(os.path.join(root, 'one'), state, 1.0, 1, 2)
    sp = SP.build_spatial_model(cfg, 20, 'cpu')
    tx2 = S.make_optimizer(cfg)
    st2 = S.TrainState(sp, tx2, tx2.init(list(sp.parameters())))
    ckpt.load_checkpoint(path, st2)
    for (k, a), (k2, b) in zip(one.state_dict().items(),
                               sp.state_dict().items()):
        assert k == k2 and torch.equal(a, b)

    out = cli('box2mask_torch.evaluate', RECIPE, root)
    assert 'Loaded checkpoint: checkpoint_' in out
    assert out.count('average') == 1              # rank 0's AP table
