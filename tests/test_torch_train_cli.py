"""The port's entry points for training: `python -m box2mask_torch.train`,
the `Model` facade and `python -m box2mask_torch.quality_gate`, on the CPU
(BOX2MASK_PLATFORM=cpu).

  * The train CLI's main() at the sizes of the repo's verify recipe
    (configs/synthetic.txt, 4 scenes, --vox_bucket 512, --layers 1):
    losses finite and falling, the epoch-2 checkpoint written; a second
    main() resumes from it at epoch 2 and takes the same losses as the
    first run's last epoch (the resume is exact on the CPU); --train_submission
    trains on train+val; --profile_dir writes a trace of steps 10-14;
    --spatial_shards > 1 is refused naming its ROADMAP item, and without
    CUDA main() raises unless asked for the CPU, --multigpu too (no card
    for its ranks; tests/test_torch_parallel.py runs it on the CPU).
  * Model against the JAX package's Model on the same weights and batch
    (--compute_dtype float32, neighbor maps: nothing rounds): get_prediction
    within 1e-5 (max) / 1e-6 (mean) of max |head| (the min_bb_size clip
    included), compute_loss within 1e-5 relative, pred2mask equal on the
    same prediction, state_dict's names, load_checkpoint of a checkpoint the
    JAX package wrote, and train_step.
  * The quality gate's plumbing: its JSON line, and a non-zero exit under
    the threshold (two epochs, far from overfit).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu import model as JM
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import supervision as JSup
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_tpu.engine import checkpoint as JCk
from box2mask_torch import config as PC
from box2mask_torch import model as PM
from box2mask_torch import quality_gate
from box2mask_torch import train as train_cli
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine.train import Trainer
from test_torch_train_common import ARGS, scenes
from test_torch_train_common import remove_tmp_path  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
          '--dataset_size', '4', '--vox_bucket', '512', '--seg_bucket', '64',
          '--layers', '1', '--num_workers', '2']


def losses(out):
    return [float(line.split('loss ')[1].split()[0])
            for line in out.splitlines() if ' loss ' in line]


def test_train_cli_checkpoint_resume_and_train_val(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    t = train_cli.main(RECIPE + ['--num_epochs', '3'])
    first = losses(capsys.readouterr().out)
    assert t.iteration_num == 6 and len(first) == 6
    assert np.isfinite(first).all() and first[-1] < first[0]
    ckpts = ckpt.list_checkpoints(t.cfg.checkpoint_path)
    assert len(ckpts) == 1
    assert ckpt.read_payload(ckpts[0][1])['epoch'] == 2

    t2 = train_cli.main(RECIPE + ['--num_epochs', '3'])
    out = capsys.readouterr().out
    assert 'Resumed from checkpoint_' in out and '(epoch 2)' in out
    assert t2.start_epoch == 2 and t2.iteration_num == 6
    np.testing.assert_allclose(losses(out), first[4:], rtol=1e-6)

    t3 = train_cli.main(RECIPE + ['--num_epochs', '1', '--train_submission',
                                  '--exp_name', 'submission'])
    assert t3.train_dataset.mode == 'train+val' and t3.iteration_num == 2


def test_train_cli_refuses_and_needs_the_card_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    monkeypatch.delenv('BOX2MASK_PLATFORM', raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            train_cli.main(RECIPE)
        with pytest.raises(RuntimeError, match='CUDA cards'):
            train_cli.main(RECIPE + ['--multigpu'])
        # spatial sharding (ROADMAP A13): one NCCL rank per card, so 2
        # ranks need 2 cards
        with pytest.raises(RuntimeError, match='--spatial_shards asks for '
                                               '2 ranks.*CUDA cards'):
            train_cli.main(RECIPE + ['--spatial_shards', '2'])
        ids, _, _, is_fg = PT.get_tables('scannet')
        with pytest.raises(RuntimeError, match='CUDA'):
            PM.Model(PC.get_config(RECIPE), ids,
                     PT.SCANNET_SEMANTIC_ID2IDX, np.arange(len(ids)), is_fg)


def test_profile_dir_writes_a_trace_of_steps_10_to_14(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    prof = tmp_path / 'prof'
    cfg = PC.get_config(RECIPE + [
        '--profile_dir', str(prof), '--dataset_size', '5', '--batch_size',
        '1', '--synthetic_instances', '3', '--synthetic_points_per_instance',
        '150', '--synthetic_floor_points', '400', '--synthetic_wall_points',
        '300'])
    t = Trainer(cfg, PLd.get_dataset(cfg, 'train'),
                PLd.get_dataset(cfg, 'val'), device='cpu')
    t.iteration_num = 10            # the trace covers steps 10-14
    t.train_model(1)
    assert t.iteration_num == 15
    traces = glob.glob(str(prof / '*.json'))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)['traceEvents']


FACADE = ['--compute_dtype', 'float32', '--key_conv', 'off', '--eval_ths',
          '0.5', '0.05', '0.3', '0.6']


def test_model_facade_matches_jax_model(tmp_path, monkeypatch):
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    jc = JC.get_config(ARGS + FACADE)
    pc = PC.get_config(ARGS + FACADE)
    for c in (jc, pc):
        c.use_native_host_ops = False
    jdev, jhost = JB.build_batch(
        scenes(JSyn.make_scene, JV.voxelize_scene, JSup.build_supervision,
               jc), jc, JT.SCANNET_SEMANTIC_ID2IDX, mode='val')
    pdev, phost = PB.build_batch(
        scenes(PSyn.make_scene, PV.voxelize_scene, PSup.build_supervision,
               pc), pc, PT.SCANNET_SEMANTIC_ID2IDX, mode='val')
    ids, _, _, is_fg = PT.get_tables('scannet')
    id2idx = PT.SCANNET_SEMANTIC_ID2IDX
    inst = np.arange(len(ids))
    jm = JM.Model(jc, ids, id2idx, inst, is_fg)
    jm.ensure_state(jm._device_batch(jdev))
    pm = PM.Model(pc, ids, id2idx, inst, is_fg, device='cpu')
    assert pm.ensure_state(pdev) is pm.state
    jsd = jm.state_dict()
    pm.detection_model.load_state_dict(from_flax(jsd['params'],
                                                 jsd['batch_stats']))
    psd = pm.state_dict()
    assert set(psd['params']) | set(psd['batch_stats']) == set(
        from_flax(jsd['params'], jsd['batch_stats']))

    jpred, ppred = jm.get_prediction(jdev), pm.get_prediction(pdev)
    valid = pdev['seg_valid']
    assert set(jpred) == set(ppred)
    for k, v in jpred.items():
        scale = np.abs(v).max()
        d = np.abs(ppred[k] - v)
        assert d.max() <= 1e-5 * scale and d[valid].mean() <= 1e-6 * scale
    assert ppred['mlp_bounds'].min() >= pc.min_bb_size
    jl, pl = jm.compute_loss(jdev, 5), pm.compute_loss(pdev, 5)
    assert set(jl) == set(pl)
    for k in ('optimization_loss', 'offset_loss', 'bounds_loss',
              'semantics_loss'):
        assert abs(pl[k] - jl[k]) <= 1e-5 * abs(jl[k]), k

    jres = jm.pred2mask(jdev, jpred, 'eval', jhost)
    pres = pm.pred2mask(pdev, jpred, 'eval', phost)
    assert sorted(pres) == sorted(jres)
    for name, r in jres.items():
        assert all(np.array_equal(pres[name][k], r[k]) for k in r), name

    JCk.save_checkpoint(pc.checkpoint_path, jm.state, 7200.0, 5, 11)
    before = pm.train_step(pdev, 5, lr=1e-3)
    assert np.isfinite(before['optimization_loss'])
    assert pm.load_checkpoint() == (5, 7200.0, 'checkpoint_2h:0m:0s_7200.0',
                                    11)
    got = pm.state_dict()['params']
    want = from_flax(jsd['params'], {})
    assert all(np.array_equal(got[k], want[k].numpy()) for k in want)
    pm.eval()
    assert not pm.detection_model.training


def test_quality_gate_reports_and_fails_under_threshold(tmp_path,
                                                        monkeypatch, capsys):
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    rc = quality_gate.main(['--epochs', '2', '--dataset_size', '2',
                            '--threshold', '1.5', '--exp_root',
                            str(tmp_path)])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and rec['pass'] is False and rec['threshold'] == 1.5
    assert 0.0 <= rec['map50'] <= 1.0
    assert glob.glob(str(tmp_path / 'synthetic' / 'results' / '*' / '*' /
                         'table.txt'))
