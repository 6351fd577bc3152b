"""The port's evaluation path (engine/evaluate.py Evaluater, the Trainer's
full eval, the `python -m box2mask_torch.evaluate` CLI) against the JAX
package's Evaluater.

Both sides evaluate the same 4 synthetic scenes (the sizes of
tests/test_fused_eval.py) at --eval_batch_size 2 with the same weights: a
JAX init copied to the port (convert.from_flax), the last layer of each
head scaled to 1e-3 and given fixed biases, as
tests/test_torch_postproc.py does, so the ~0.5% forward difference from
bf16 rounding stays clear of every threshold. The JAX Evaluater runs its
fused pipeline on the CPU under B2M_FUSED_EVAL=1, as its own tests run it.
Per scene: the same mask count, masks and label ids, conf within 1e-5; the
same ScanNet AP at rtol=0; the same result folder name and table.
"""

import os
import pickle
import subprocess
import sys
import types
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.datasets.loader import get_dataset as jax_get_dataset
from box2mask_tpu.engine import state as JS
from box2mask_tpu.engine.evaluate import Evaluater as JaxEvaluater
from box2mask_tpu.metrics import scannet_ap as JAP
from box2mask_torch import config as PC
from box2mask_torch import evaluate as cli
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import evaluate as PE
from box2mask_torch.engine import state as S
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.engine.train import Trainer

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ['--dataset_name', 'synthetic',
        '--network_heads', 'mlp_offsets', 'mlp_bounds', 'mlp_bb_scores',
        'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision', '--smallest_bb_heuristic',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1',
        '--voxel_size', '0.05', '--vox_bucket', '512', '--seg_bucket', '64',
        '--eval_ths', '0.5', '0.05', '0.3', '0.6',
        '--dataset_size', '4', '--fixed_seed', '10', '--layers', '1',
        '--synthetic_instances', '5', '--synthetic_points_per_instance', '250',
        '--synthetic_floor_points', '900', '--synthetic_wall_points', '700',
        '--eval_batch_size', '2', '--exp_name', 'torch_eval']


def configs(root, extra=()):
    """(port cfg, JAX cfg) with experiments under root/port, root/jax."""
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'port')
    pc = PC.get_config(ARGS + list(extra))
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'jax')
    jc = JC.get_config(ARGS + list(extra))
    return pc, jc


def crisp_weights(jc, ds):
    """A JAX init with each head's last layer scaled to 1e-3 of it and
    fixed biases: numpy (params, batch_stats)."""
    dev_np, _ = next(iter(ds.get_loader(shuffle=False, drop_last=False,
                                        batch_size=2)))
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
    return params, stats


def port_state(pc, params, stats):
    model = S.build_model(pc, 20, 'cpu')
    state = S.init_state(pc, model, S.make_optimizer(pc))
    model.load_state_dict(from_flax(params, stats))
    return state


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """Both packages' fused_dataset_results on the same scenes and weights
    (each writes its cache, which the tests below reuse)."""
    root = str(tmp_path_factory.mktemp('eval'))
    saved = {k: os.environ.get(k) for k in ('BOX2MASK_EXP_ROOT',
                                            'B2M_FUSED_EVAL')}
    os.environ['B2M_FUSED_EVAL'] = '1'
    try:
        pc, jc = configs(root)
        jds = jax_get_dataset(jc, 'val', do_augmentations=False)
        pds = get_dataset(pc, 'val', do_augmentations=False)
        params, stats = crisp_weights(jc, jds)
        jev = JaxEvaluater(jc, state=types.SimpleNamespace(
            params=params, batch_stats=stats))
        pev = Evaluater(pc, state=port_state(pc, params, stats))
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            jres, jent = jev.fused_dataset_results(jds)
            pres, pent = pev.fused_dataset_results(pds)
        yield types.SimpleNamespace(
            root=root, pc=pc, jc=jc, jds=jds, pds=pds, params=params,
            stats=stats, jev=jev, pev=pev, jres=jres, jent=jent, pres=pres,
            pent=pent)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def assert_same_results(got, want):
    assert list(got) == list(want)
    n_masks = 0
    for name, w in want.items():
        g = got[name]
        assert len(g['conf']) == len(w['conf']), name
        np.testing.assert_array_equal(g['label_id'], w['label_id'])
        np.testing.assert_array_equal(g['mask'], w['mask'])
        np.testing.assert_allclose(g['conf'], w['conf'], rtol=0, atol=1e-5)
        n_masks += len(w['conf'])
    return n_masks


def test_fused_results_match_jax(run):
    assert len(run.pres) == 4
    assert assert_same_results(run.pres, run.jres) > 8
    for name, r in run.pres.items():
        assert r['mask'].dtype == bool
    # the same GT and the same ScanNet AP
    pgt = run.pev.gt_ids_for_entries(run.pent)
    jgt = run.jev.gt_ids_for_entries(run.jent)
    assert pgt.keys() == jgt.keys()
    for k in jgt:
        np.testing.assert_array_equal(pgt[k], jgt[k])
    # and against a GT made of the JAX package's first masks, where the
    # random weights' AP is not 0
    own = {}
    for name, r in run.jres.items():
        ids = np.zeros(r['mask'].shape[1], np.int64)
        for j in range(min(4, len(r['conf']))):
            ids[r['mask'][j]] = r['label_id'][j] * 1000 + j + 1
        own[name] = ids
    for gt, positive in ((pgt, False), (own, True)):
        pa, _, _ = PE.scannet_ap.evaluate_scannet(run.pres, gt)
        ja, _, _ = JAP.evaluate_scannet(run.jres, gt)
        for k in ('all_ap', 'all_ap_50%', 'all_ap_25%'):
            np.testing.assert_allclose(pa[k], ja[k], rtol=0)   # NaN-aware
        assert pa['all_ap_25%'] > 0 or not positive


def test_eval_writes_table_under_jax_folder_name(run):
    """eval() from the caches: the result folder (relative to each
    package's results path) and table.txt are the JAX package's."""
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        pa = run.pev.eval(run.pds)
        ja = run.jev.eval(run.jds)
    for k in ('all_ap', 'all_ap_50%', 'all_ap_25%'):
        np.testing.assert_allclose(pa[k], ja[k], rtol=0)

    def tables(ev):
        out = {}
        for d, _, files in os.walk(ev.results_path):
            if 'table.txt' in files:
                with open(os.path.join(d, 'table.txt')) as f:
                    out[os.path.relpath(d, ev.results_path)] = f.read()
        return out
    pt, jt = tables(run.pev), tables(run.jev)
    assert len(pt) == 1 and pt == jt
    assert list(pt)[0].startswith('mAP50_') and '_seed:10' in list(pt)[0]


def test_submission_write_out_matches_jax(run, tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        pdir = run.pev.submission_write_out(run.pds, str(tmp_path / 'p'))
        jdir = run.jev.submission_write_out(run.jds, str(tmp_path / 'j'))

    def listing(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)
    assert listing(pdir) == listing(jdir)
    assert len(listing(pdir)) > 8
    for rel in listing(jdir):
        with open(os.path.join(pdir, rel)) as f:
            p = f.read().split()
        with open(os.path.join(jdir, rel)) as f:
            j = f.read().split()
        if rel.startswith('predicted_masks'):
            assert p == j, rel
        else:                           # mask file, label id, conf
            assert p[0::3] == j[0::3] and p[1::3] == j[1::3], rel
            np.testing.assert_allclose(np.float64(p[2::3]),
                                       np.float64(j[2::3]), atol=1e-4)


def test_gt_ids_read_from_gt_txt(run, tmp_path):
    """A scene with <data_dir>/gt_instance_data_txt/<scene>.txt takes its
    GT from there; the others derive it from their labels."""
    name = run.pent[0][2]['scene'][0]['name']
    n_pts = len(run.pent[0][2]['vox2point'][0])
    ids = np.random.default_rng(0).integers(0, 40, n_pts) * 1000 + 3
    os.makedirs(tmp_path / 'gt_instance_data_txt')
    np.savetxt(tmp_path / 'gt_instance_data_txt' / f'{name}.txt', ids,
               fmt='%d')
    gts = []
    for ev, ent in ((run.pev, run.pent), (run.jev, run.jent)):
        saved = ev.cfg.data_dir
        ev.cfg.data_dir = str(tmp_path)
        try:
            gts.append(ev.gt_ids_for_entries(ent))
        finally:
            ev.cfg.data_dir = saved
    pgt, jgt = gts
    np.testing.assert_array_equal(pgt[name], ids)
    derived = run.pev.gt_ids_for_entries(run.pent)
    assert pgt.keys() == jgt.keys() == derived.keys()
    for k in jgt:
        np.testing.assert_array_equal(pgt[k], jgt[k])
        if k != name:
            np.testing.assert_array_equal(pgt[k], derived[k])
    assert not np.array_equal(derived[name], ids)


@pytest.mark.parametrize('top_k', [128, 2])
def test_cache_roundtrip(run, tmp_path, monkeypatch, top_k):
    """A second Evaluater reuses the cached stacked readbacks and gives the
    same results, also from a cache whose hosts lack the memoised
    seg->point index, and for top-k overflow scenes (top_k 2), whose
    fallback results the cache carries."""
    monkeypatch.setattr(PE, 'TOP_K', top_k)
    pc, _ = configs(str(tmp_path))
    state = port_state(pc, run.params, run.stats)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        r1, _ = Evaluater(pc, state=state).fused_dataset_results(run.pds)
        assert_same_results(r1, run.pres)
        ev = Evaluater(pc, state=state)
        ev._fused_pipe = None           # a reload must not run the model
        r2, _ = ev.fused_dataset_results(run.pds)
        assert_same_results(r2, r1)
        path = [os.path.join(d, f) for d, _, fs in os.walk(ev.results_path)
                for f in fs if f.endswith('.pkl')]
        assert len(path) == 1
        with open(path[0], 'rb') as f:
            cached = pickle.load(f)
        assert len(cached) == 2
        assert any(c[2] for c in cached) == (top_k == 2)
        memo = [host.pop('_seg2point', None) is not None
                for _, host, _ in cached]
        assert all(memo) or top_k == 2     # overflow scenes skip the memo
        with open(path[0], 'wb') as f:
            pickle.dump(cached, f)
        r3, _ = ev.fused_dataset_results(run.pds)
    assert_same_results(r3, r1)


def test_restore_from_port_checkpoint(run, tmp_path, capsys):
    """An Evaluater without a state restores the experiment's latest
    checkpoint (engine/checkpoint.save_checkpoint) and gives the live
    weights' results; the results folder is named after it."""
    pc, _ = configs(str(tmp_path))
    path = ckpt.save_checkpoint(pc.checkpoint_path,
                                port_state(pc, run.params, run.stats),
                                3723.5, 12, 40)
    ev = Evaluater(pc, device='cpu')
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        res, _ = ev.fused_dataset_results(run.pds, cache=False)
    assert 'Loaded checkpoint: checkpoint_1h:2m:3s_3723.5' in \
        capsys.readouterr().out
    assert ev.ckpt_name == os.path.basename(path)[:-5]
    assert ev.results_path.endswith(os.path.join('results', ev.ckpt_name))
    assert_same_results(res, run.pres)


def test_full_eval_logs_map_and_survives_failure(run, tmp_path, monkeypatch,
                                                 capsys):
    """Trainer._full_eval evaluates the val set on the live weights and
    logs val/mAP*; an eval that raises logs val/full_eval_failed, prints
    the traceback, and returns."""
    pc, _ = configs(str(tmp_path), ['--eval_wo_aug'])
    tr = Trainer(pc, get_dataset(pc, 'train'), None, device='cpu')
    tr.state = port_state(pc, run.params, run.stats)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        tr._full_eval(260)

    def scalars():
        import json
        with open(tr.metrics.path) as f:
            return [json.loads(line) for line in f]
    got = {k: v for d in scalars() for k, v in d.items()}
    assert got['epoch'] == 260
    np.testing.assert_allclose(
        [got['val/mAP'], got['val/mAP50'], got['val/mAP25']],
        [run.pev.eval(run.pds)[k] for k in
         ('all_ap', 'all_ap_50%', 'all_ap_25%')], rtol=0)

    def boom(self, dataset, write_to_tb=None):
        raise ValueError('eval exploded')
    monkeypatch.setattr(Evaluater, 'eval', boom)
    capsys.readouterr()
    tr._full_eval(280)
    assert scalars()[-1] == {'epoch': 280, 'val/full_eval_failed': 1.0}
    err = capsys.readouterr()
    assert 'eval exploded' in err.err and 'FAILED at epoch 280' in err.out


def test_cli_prints_ap_table(tmp_path):
    """`python -m box2mask_torch.evaluate` under BOX2MASK_PLATFORM=cpu:
    the untrained model's AP table, table.txt written."""
    env = dict(os.environ, BOX2MASK_PLATFORM='cpu', OMP_NUM_THREADS='2',
               BOX2MASK_EXP_ROOT=str(tmp_path))
    env.pop('B2M_FUSED_EVAL', None)
    proc = subprocess.run([sys.executable, '-m', 'box2mask_torch.evaluate']
                          + ARGS, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert 'evaluating the untrained model' in out
    assert 'class       AP     AP50     AP25' in out
    assert 'otherfurniture' in out and 'average' in out
    tables = [d for d, _, fs in os.walk(tmp_path) if 'table.txt' in fs]
    assert len(tables) == 1 and '_seed:10' in tables[0]


def test_cli_eval_training_sweeps_checkpoints(run, tmp_path, monkeypatch):
    """--eval_training evaluates every checkpoint of the experiment, each
    into its own results folder, its mAP scalars at epoch hours // 1 in
    <exp>/eval_training/metrics.jsonl."""
    import json
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    pc, _ = configs(str(tmp_path))
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path / 'port'))
    state = port_state(pc, run.params, run.stats)
    names = [os.path.basename(ckpt.save_checkpoint(
        pc.checkpoint_path, state, t, 0, 0))[:-5] for t in (1800.0, 7300.0)]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        cli.main(ARGS + ['--eval_training'])
    for name in names:
        assert os.path.isdir(os.path.join(pc.exp_path, 'results', name))
    with open(os.path.join(pc.exp_path, 'eval_training',
                           'metrics.jsonl')) as f:
        lines = [json.loads(line) for line in f]
    assert [(d['epoch'], list(d)[1]) for d in lines] == [
        (e, k) for e in (0, 2) for k in ('val/mAP', 'val/mAP50',
                                         'val/mAP25')]


@pytest.mark.parametrize('extra,match', [
    ([], 'no CUDA device'),
    (['--param_search'], 'A10'),
    (['--produce_visualizations'], 'A20'),
    (['--predict_specific_scene', 'synth10000_00'], 'A20')])
def test_cli_refuses(tmp_path, monkeypatch, extra, match):
    """Without CUDA and without BOX2MASK_PLATFORM=cpu the CLI raises (no
    quiet CPU run); the modes not ported raise, naming the ROADMAP item."""
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    if extra:
        monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
        exc = NotImplementedError
    else:
        monkeypatch.delenv('BOX2MASK_PLATFORM', raising=False)
        assert not torch.cuda.is_available()
        exc = RuntimeError
    with pytest.raises(exc, match=match):
        cli.main(ARGS + extra)


@pytest.mark.parametrize('extra,match', [
    (['--dataset_name', 'arkitscenes'], 'A10'),
    (['--dataset_name', 's3dis'], 'A10'),
    (['--spatial_shards', '2'], 'A13')])
def test_evaluater_refuses_paths_not_ported(run, tmp_path, extra, match):
    pc, _ = configs(str(tmp_path), extra)
    ev = Evaluater(pc, device='cpu')
    with pytest.raises(NotImplementedError, match=match):
        ev.eval(run.pds)
    with pytest.raises(NotImplementedError, match='A10'):
        ev.param_search(run.pds)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        Evaluater(pc)
