"""The port's held-out quality gate (`python -m box2mask_torch.quality_gate
--held_out`) against scripts/quality_gate.py.

  * The held-out gate trains on the scenes and evaluates the scenes the
    JAX gate does (train seeds 0 .. N - 1, val 10000-10003), and the
    overfit gate as before (copies of synth10000_00): the argv each gate
    hands the train and eval CLIs, read back through both packages'
    datasets.
  * With run_gate stubbed on both sides: the record's fields equal the JAX
    gate's (git_sha and recorded under --out; the port adds seconds and,
    for the overfit gate, dataset_size), and the exit codes agree.
  * --held_out_only without a prior --out record: the JAX gate counts the
    missing overfit result as passed (exit 0); the port fails (pass false,
    exit 1). With a record, both merge into it.
  * One real held-out run at a tiny size writes its record.
"""

import json
import os
import sys

import numpy as np
import pytest

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import loader as JLd
from box2mask_torch import config as PC
from box2mask_torch import quality_gate as QG
from box2mask_torch.datasets import loader as PLd
from scripts import quality_gate as JQG
from test_torch_train_common import remove_tmp_path  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Stop(Exception):
    pass


def jax_gate_argv(monkeypatch, tmp_path, **kw):
    """(train argv, eval argv) that the JAX gate's run_gate hands its CLIs."""
    import evaluate as jax_eval
    import train as jax_train
    seen = []

    def capture(argv):
        seen.append(list(argv))
        if len(seen) == 2:
            raise _Stop
    monkeypatch.setattr(jax_train, 'main', capture)
    monkeypatch.setattr(jax_eval, 'main', capture)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(_Stop):
        JQG.run_gate(exp_root=str(tmp_path), **kw)
    return seen


def scene_lists(argv_train, argv_eval, package):
    C, L = (JC, JLd) if package == 'jax' else (PC, PLd)
    train = L.get_dataset(C.get_config(argv_train), 'train')
    val = L.get_dataset(C.get_config(argv_eval), 'val')
    return list(train.data_list), list(val.data_list)


@pytest.mark.parametrize('held_out,epochs,size', [(True, 150, 16),
                                                  (False, 40, 16)])
def test_gate_scenes_match_jax(tmp_path, monkeypatch, held_out, epochs,
                               size):
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    jt, je = jax_gate_argv(monkeypatch, tmp_path, epochs=epochs,
                           threshold=0.3, dataset_size=size,
                           held_out=held_out)
    pt, pe = QG.gate_args(epochs, size, held_out)
    want = scene_lists(jt, je, 'jax')
    got = scene_lists(pt, pe, 'port')
    assert got == want
    if held_out:
        assert got == ([f'synth{i:05d}_00' for i in range(size)],
                       [f'synth1000{i}_00' for i in range(4)])
    else:
        assert set(got[0]) == set(got[1]) == {QG.SCENE}
    # the same training schedule
    for flag in ('--num_epochs', '--ckpt_every', '--lr_scheduler_start_epoch',
                 '--lr_scheduler_end_epoch', '--dataset_size'):
        assert pt[pt.index(flag) + 1] == jt[jt.index(flag) + 1], flag


def stub_gates(monkeypatch, overfit_map, held_out_map):
    def jax_gate(epochs, threshold, exp_root=None, dataset_size=32,
                 held_out=False):
        return held_out_map if held_out else overfit_map

    def port_gate(epochs, dataset_size, held_out=False):
        return held_out_map if held_out else overfit_map
    monkeypatch.setattr(JQG, 'run_gate', jax_gate)
    monkeypatch.setattr(QG, 'run_gate', port_gate)


def run_both(argv_of, capsys):
    """(port rc, port record, JAX rc, JAX record) of main(argv_of(side))."""
    out = []
    for side, main in (('port', QG.main), ('jax', JQG.main)):
        rc = main(argv_of(side))
        out += [rc, json.loads(capsys.readouterr().out.strip()
                               .splitlines()[-1])]
    return out


@pytest.mark.parametrize('flags', [[], ['--held_out']])
def test_record_fields_match_jax(tmp_path, monkeypatch, capsys, flags):
    stub_gates(monkeypatch, 0.6, 0.4)
    prc, prec, jrc, jrec = run_both(
        lambda side: flags + ['--out', str(tmp_path / f'{side}.json')],
        capsys)
    assert set(prec) - {'seconds', 'dataset_size'} == set(jrec)
    assert {'git_sha', 'recorded'} <= set(jrec)
    assert prc == jrc == 0 and prec['pass'] is jrec['pass'] is True
    with open(tmp_path / 'port.json') as f:
        assert json.load(f) == prec
    for k in set(jrec) - {'recorded'}:
        assert prec[k] == jrec[k], k


def test_held_out_only_without_record_fails(tmp_path, monkeypatch, capsys):
    """The JAX gate's fault, not copied: with no overfit record its
    `rec.get('pass', True)` passes the overfit gate that never ran."""
    stub_gates(monkeypatch, 0.6, 0.4)
    prc, prec, jrc, jrec = run_both(
        lambda side: ['--held_out_only', '--out',
                      str(tmp_path / f'{side}.json')], capsys)
    assert jrc == 0 and jrec['pass'] is True
    assert 'map50' not in jrec and jrec['held_out_pass'] is True
    assert prc == 1 and prec['pass'] is False and prec['held_out_pass']
    # with a prior overfit record both merge into it
    for side in ('port', 'jax'):
        with open(tmp_path / f'{side}.json', 'w') as f:
            json.dump({'metric': 'synthetic_overfit_map50', 'map50': 0.7,
                       'pass': True}, f)
    prc, prec, jrc, jrec = run_both(
        lambda side: ['--held_out_only', '--out',
                      str(tmp_path / f'{side}.json')], capsys)
    assert prc == jrc == 0 and prec['pass'] is jrec['pass'] is True
    assert prec['map50'] == jrec['map50'] == 0.7


def test_held_out_gate_runs_tiny(tmp_path, monkeypatch, capsys):
    """A real held-out run (2 epochs on 2 train scenes, 4 val scenes at
    --vox_bucket 512, --layers 1) merged into a prior overfit record."""
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    base = list(QG.BASE)
    base[base.index('--vox_bucket') + 1] = '512'
    base[base.index('--seg_bucket') + 1] = '64'
    monkeypatch.setattr(QG, 'BASE', base)
    out = tmp_path / 'rec.json'
    with open(out, 'w') as f:
        json.dump({'metric': 'synthetic_overfit_map50', 'map50': 0.9,
                   'pass': True}, f)
    rc = QG.main(['--held_out_only', '--held_out_epochs', '2',
                  '--held_out_scenes', '2', '--held_out_threshold', '0.0',
                  '--out', str(out), '--exp_root', str(tmp_path / 'exp')])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(out) as f:
        assert json.load(f) == rec
    ho = rec['held_out_map50']
    assert np.isnan(ho) or 0.0 <= ho <= 1.0
    assert rc == (0 if rec['pass'] else 1)
    assert rec['held_out_pass'] == (ho >= 0.0)
    assert (rec['held_out_train_scenes'], rec['held_out_eval_scenes'],
            rec['held_out_epochs'], rec['map50']) == (2, 4, 2, 0.9)
    tables = [d for d, _, fs in os.walk(tmp_path / 'exp' / 'held_out')
              if 'table.txt' in fs]
    assert len(tables) == 1 and 'untrained' not in tables[0]


def test_held_out_bar_is_out_of_reach_of_any_model():
    """The synthetic generator draws each instance's class independently of
    its geometry, size and colour (datasets/synthetic.py make_scene, the
    JAX package's alike), so no model can tell the class of an unseen
    instance. Perfect instance masks of the held-out gate's 4 val scenes
    score mAP@50 1.0 with the true classes, and far under the gate's 0.3
    with classes guessed (uniformly, over seeds; or the commonest class):
    the bar measures class guessing (ROADMAP section C)."""
    from box2mask_torch.datasets.tables import (
        SCANNET_INSTANCE_VALID_CLASS_IDS as IDS)
    from box2mask_torch.metrics import scannet_ap
    cfg = PC.get_config(QG.gate_args(150, 16, held_out=True)[1])
    ds = PLd.get_dataset(cfg, 'val', do_augmentations=False)
    scenes = [ds.read_scene(n) for n in ds.data_list]
    assert len(scenes) == 4
    gt = {s['name']: scannet_ap.encode_gt_ids(l['semantics'],
                                              l['instances'])
          for s, l in scenes}

    def score(guess):
        results = {}
        for s, l in scenes:
            ids = [i for i in np.unique(l['instances'])
                   if l['semantics'][l['instances'] == i][0] in IDS]
            masks = np.stack([l['instances'] == i for i in ids])
            true = np.array([l['semantics'][l['instances'] == i][0]
                             for i in ids])
            results[s['name']] = {'mask': masks, 'conf': np.ones(len(ids)),
                                  'label_id': guess(true)}
        return scannet_ap.evaluate_scannet(results, gt)[0]['all_ap_50%']

    assert score(lambda true: true) == 1.0
    guessed = [score(lambda true, r=np.random.default_rng(s): r.choice(
        IDS, len(true))) for s in range(8)]
    commonest = score(lambda true: np.full(len(true), 3))
    assert max(guessed) < 0.15 and commonest < 0.15, (guessed, commonest)
