"""The harness as data: BENCHMARK.json within the benchmark's contract,
everything found by name, the result line's keys, a new configuration,
traffic mix and metric added without editing a file, no card no result,
and what a run imports and writes."""

import builtins
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from h100bench import harness
from h100bench_tiny import REPO, make_root

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CPU = torch.device('cpu')


@pytest.fixture(scope='module')
def bench():
    return harness.load_bench(REPO)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and '\n' not in s \
        and '\t' not in s


def test_benchmark_json_meets_the_contract(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['command'] == ['python3', 'h100bench/run.py']
    assert bench['paths'] == ['h100bench']
    rs = bench['run_seconds']
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 * 0 + (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(bench)) <= 64 * 1024
    names = set()
    files = set()
    for c in bench['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert NAME.match(c['name']) and _line(c['why'])
        assert _line(c['source']) and c['source'].startswith('https://')
        assert c['file'].startswith('h100bench/') and c['file'] not in files
        files.add(c['file'])
        assert os.path.exists(os.path.join(REPO, c['file']))
        assert len(c['reduced']) <= 16
        with open(os.path.join(REPO, c['file'])) as f:
            assert json.load(f)['name'] == c['name']
    cells = {w['name'] for w in bench['workloads']}
    pairs = set()
    for w in bench['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert NAME.match(w['name']) and NAME.match(w['traffic'])
        assert w['config'] in {c['name'] for c in bench['configs']}
        assert w['chips'] in (1, 4) and _line(w['why'])
        assert (w['config'], w['traffic']) not in pairs
        pairs.add((w['config'], w['traffic']))
    assert sum(w['chips'] == 4 for w in bench['workloads']) <= max(
        1, len(cells) // 4)
    used = {w['config'] for w in bench['workloads']}
    assert used == {c['name'] for c in bench['configs']}
    e2e = {m['name']: m for m in bench['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in bench['end_to_end']:
        assert set(m) <= {'name', 'unit', 'better', 'bound', 'source',
                          'workloads'}
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for m in bench['end_to_end'] + bench['per_layer']:
        assert NAME.match(m['name']) and UNIT.match(m['unit'])
        assert m['better'] in ('lower', 'higher')
        assert m['name'] not in names
        names.add(m['name'])
        assert set(m.get('workloads', ())) <= cells
    for m in bench['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        assert _line(m['layer']) and m['moves'] in e2e
        for w in m.get('workloads', ()):
            assert w in (e2e[m['moves']].get('workloads') or cells)
        if m['name'].endswith('_roofline') or '_roofline.' in m['name'] \
                or 'mfu' in m['name']:
            assert m['unit'] == '%'
    for w in cells:
        reported = [m['name'] for m in harness.end_to_end(bench, w)]
        assert 'setup_s' in reported and len(reported) >= 2
        assert harness.per_layer(bench, w)


def test_everything_is_found_by_name(bench):
    for w in bench['workloads']:
        cell, config, traffic = harness.cell_files(REPO, bench, w['name'])
        __import__(f'h100bench.kinds.{traffic["kind"]}')
        with open(os.path.join(REPO, 'h100bench', 'limits',
                               f'{w["name"]}.json')) as f:
            lim = json.load(f)['limits']
        assert lim and all(math.isfinite(v) and v > 0 for v in lim.values())
    for m in bench['per_layer']:
        assert harness.reader(REPO, m['name'])({}) is None


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, 'box2mask_tpux', sys)
    monkeypatch.setitem(sys.modules, 'jaxline.x', sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, 'jax.numpy', sys)
    assert harness.forbidden_loaded() == ['jax']


def test_result_line_and_writes(tmp_path, monkeypatch):
    """A whole run at a tiny size: the last line's keys, and every file the
    run opens for writing lies in the checkout, HOME, XDG_CACHE_HOME or
    TMPDIR (here: none)."""
    root = make_root(tmp_path)
    for k in ('HOME', 'XDG_CACHE_HOME', 'TMPDIR'):
        d = tmp_path / k.lower()
        d.mkdir()
        monkeypatch.setenv(k, str(d))
    allowed = [root, str(tmp_path), os.path.join(REPO, 'box2mask_torch',
                                                 'build')]
    written = []
    real_open = builtins.open

    def spy(file, mode='r', *a, **kw):
        if any(c in mode for c in 'wax+'):
            written.append(os.path.abspath(str(file)))
        return real_open(file, mode, *a, **kw)
    monkeypatch.setattr(builtins, 'open', spy)
    out = harness.run_cell(root, 'scannet-infer', 2**31 + 9, 1.0, False,
                           CPU, 0.0)
    monkeypatch.setattr(builtins, 'open', real_open)
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'compared']
    assert out['correct'] is True and out['failed'] == 0
    assert set(out['metrics']) == {'setup_s', 'infer_peak_gb'}
    assert set(out['device']) == {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}
    assert set(out['compared']) == {'head_gap', 'mask_miss'}
    json.dumps(harness._finite(out))
    assert all(any(p.startswith(a) for a in allowed) for p in written), \
        written


def _digests(root):
    out = {}
    for d, _, fs in os.walk(root):
        if '__pycache__' in d:
            continue
        for f in fs:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                out[os.path.relpath(p, root)] = hashlib.sha1(
                    fh.read()).hexdigest()
    return out


def test_new_cell_needs_no_edit(tmp_path):
    """A configuration, a traffic mix of an existing kind and a per-layer
    metric added as new files plus new entries: the new cell runs, traced,
    and reports the new metric; no file that was there changed but
    BENCHMARK.json."""
    root = make_root(tmp_path)
    before = _digests(root)
    hb = os.path.join(root, 'h100bench')
    with open(os.path.join(hb, 'configs', 'scannet.json')) as f:
        conf = json.load(f)
    conf['name'] = 'scannet-small'
    conf['scene']['num_instances'] = 2
    with open(os.path.join(hb, 'configs', 'scannet-small.json'), 'w') as f:
        json.dump(conf, f)
    with open(os.path.join(hb, 'traffic', 'eval-offline.json')) as f:
        tr = json.load(f)
    tr.update(batch_size=1, pool_batches=2, trace_batches=2)
    with open(os.path.join(hb, 'traffic', 'eval-b1.json'), 'w') as f:
        json.dump(tr, f)
    with open(os.path.join(hb, 'metrics', 'window_s.infer.py'), 'w') as f:
        f.write('def read(obs):\n    w = obs.get("window")\n'
                '    return None if w is None else w["seconds"]\n')
    shutil.copy(os.path.join(hb, 'limits', 'scannet-infer.json'),
                os.path.join(hb, 'limits', 'small-b1.json'))
    bench = harness.load_bench(root)
    bench['configs'].append({'name': 'scannet-small', 'source': 'x',
                             'file': 'h100bench/configs/scannet-small.json',
                             'reduced': [], 'why': 'x'})
    bench['workloads'].append({'name': 'small-b1', 'config': 'scannet-small',
                               'traffic': 'eval-b1', 'chips': 1, 'why': 'x'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if 'infer_peak_gb' in (m['name'], m.get('moves')):
            m['workloads'].append('small-b1')
    bench['per_layer'].append({'name': 'window_s.infer', 'unit': 's',
                               'better': 'lower', 'source': 'host_clock',
                               'layer': 'window', 'moves':
                               'infer_peak_gb',
                               'workloads': ['small-b1']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)
    out = harness.run_cell(root, 'small-b1', 5, 1.0, True, CPU, 0.0)
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'breakdown', 'compared']
    assert out['correct'] is True and out['attempted'] > 0
    assert out['metrics']['window_s.infer']['value'] > 0
    assert {'busy_s', 'window_s'} <= set(out['device'])
    assert set(out['breakdown']) == {'device_ops', 'idle_gaps'}
    after = _digests(root)
    changed = {k for k in before if before[k] != after.get(k)}
    assert changed == {'BENCHMARK.json'}


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    p = subprocess.run([sys.executable, 'h100bench/run.py', '--workload',
                        'scannet-infer', '--seed', '1', '--seconds', '1',
                        '--trace', '0'], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ''


def test_only_the_benchmark_is_not_enough(tmp_path):
    """A directory with BENCHMARK.json and h100bench/ alone gives no result."""
    shutil.copytree(os.path.join(REPO, 'h100bench'),
                    tmp_path / 'h100bench')
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    p = subprocess.run([sys.executable, 'h100bench/run.py', '--workload',
                        'scannet-infer', '--seed', '1', '--seconds', '1',
                        '--trace', '0'], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ''


IMPORTS = '''
import sys
sys.path.insert(0, {repo!r})
{body}
names = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(names))
'''


def _loaded(body):
    p = subprocess.run([sys.executable, '-c', IMPORTS.format(
        repo=REPO, body=body)], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS='2'))
    assert p.returncode == 0, p.stderr[-3000:]
    return set(p.stdout.split())


def test_reference_imports_nothing_of_the_program():
    names = _loaded('import pkgutil, importlib, h100bench.reference as R\n'
                    'for m in pkgutil.iter_modules(R.__path__):\n'
                    '    importlib.import_module("h100bench.reference." '
                    '+ m.name)')
    assert 'box2mask_torch' not in names
    assert not names & set(harness.FORBIDDEN)


def test_a_run_loads_no_jax(tmp_path):
    root = make_root(tmp_path)
    names = _loaded(
        'import torch\ntorch.set_num_threads(2)\n'
        'from h100bench import harness\n'
        f'harness.run_cell({root!r}, "scannet-infer", 3, 0.5, False, '
        'torch.device("cpu"), 0.0)')
    assert 'box2mask_torch' in names
    assert not names & set(harness.FORBIDDEN)
