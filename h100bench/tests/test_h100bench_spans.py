"""spans.py on made-up event lists (the idle split, launches per span, the
readings), and trace_program over both cells at the tiny size on the
CPU."""

import pytest
import torch

from h100bench import spans as SP
from h100bench import trace_program
from h100bench_tiny import make_root

MAIN, OTHER, HELPER = 1, 2, 3


def test_idle_split_nested_unspanned_and_other_thread():
    # device busy [0, 10), [20, 30), [40, 50), [60, 70); stretch [0, 80]
    device = [(0, 10), (20, 30), (40, 50), (60, 70)]
    spans = [
        (5, 35, 'b2m.infer.post', MAIN),          # holds the gap 10-20
        (12, 18, 'b2m.post.cluster', MAIN),       # nested: 12-18 is its own
        (45, 65, 'b2m.infer.harvest', OTHER),     # main holds nothing there
        (55, 58, 'h100bench.other', MAIN),        # not a b2m. span
        (72, 75, 'b2m.infer.wait_harvest', MAIN),
        (71, 79, 'b2m.infer.pack', OTHER),        # main's span wins 72-75
    ]
    idle = SP.idle_intervals(device, 0, 80)
    assert idle == [(10, 20), (30, 40), (50, 60), (70, 80)]
    by, none = SP.split_idle(idle, [s for s in spans
                                    if s[2].startswith('b2m.')], MAIN)
    assert by == {'b2m.infer.post': 4 + 5, 'b2m.post.cluster': 6,
                  'b2m.infer.harvest': 10, 'b2m.infer.wait_harvest': 3,
                  'b2m.infer.pack': 1 + 4}
    assert none == 5 + 1 + 1
    assert sum(by.values()) + none == sum(b - a for a, b in idle)


def test_summarise_launches_per_span_on_its_thread():
    """A launch counts in each span open at its time on its thread, or on
    the calling thread where its own opens no span (HELPER: autograd's)."""
    spans = [(0, 100, 'b2m.infer.post', MAIN),
             (10, 20, 'b2m.post.cluster', MAIN),
             (50, 60, 'b2m.post.cluster', MAIN),
             (0, 100, 'b2m.infer.pack', OTHER),
             (0, 100, 'other.span', MAIN)]
    launches = [(5, MAIN), (15, MAIN), (55, MAIN), (56, MAIN), (99, MAIN),
                (15, OTHER), (150, MAIN), (70, HELPER), (57, HELPER)]
    out = SP.summarise(spans, launches, [(0, 50)], MAIN, 0, 100)
    assert out['spans']['b2m.infer.post'] == {
        'count': 1, 'host_s': pytest.approx(1e-4), 'launches': 7}
    assert out['spans']['b2m.post.cluster']['count'] == 2
    assert out['spans']['b2m.post.cluster']['launches'] == 4
    assert out['spans']['b2m.infer.pack']['launches'] == 1
    assert 'other.span' not in out['spans']
    assert out['idle_s'] == pytest.approx(50e-6)
    assert out['idle_by_span'] == {'b2m.infer.post': pytest.approx(40e-6),
                                   'b2m.post.cluster': pytest.approx(10e-6)}
    assert out['idle_s_unspanned'] == pytest.approx(0)
    assert SP.spanned_share(out) == pytest.approx(1.0)


def _prog(spans, counts):
    idle = {'b2m.infer.post': 0.3, 'b2m.post.cluster': 0.1,
            'b2m.train.upload': 0.02}
    return {'profile': {'spans': spans, 'idle_by_span': idle},
            'counts': counts, 'batches': 2, 'scenes': 8, 'steps': 4,
            'pack_s': 0.04, 'wire_bytes': 30e6}


def test_readings():
    spans = {n: {'count': 2, 'host_s': 0.01, 'launches': 4000}
             for n in ('b2m.infer.post', 'b2m.infer.wait_pack',
                       'b2m.infer.wait_harvest', 'b2m.train.upload',
                       'b2m.train.step')}
    counts = {'cluster_steps': 1024, 'mask_nms_steps': 1024,
              'post_syncs': 144}
    got = SP.layer_readings('infer', _prog(spans, counts))
    assert got == pytest.approx({
        'post_launches.infer': 2000, 'greedy_steps.infer': 256,
        'post_syncs.infer': 72, 'post_idle_ms.infer': 200,
        'pack_ms.infer': 20, 'wire_mb.infer': 15,
        'pack_wait_ms.infer': 5, 'harvest_wait_ms.infer': 5})
    assert SP.layer_readings('train', _prog(spans, counts)) == \
        pytest.approx({'upload_idle_ms.train': 5,
                       'step_launches.train': 1000})


@pytest.mark.parametrize('workload', ['scannet-infer', 'scannet-train'])
def test_trace_program_tiny(tmp_path, workload):
    out = trace_program.run(make_root(tmp_path), workload, 2**31 + 7,
                            torch.device('cpu'), rounds=1)
    assert set(out['ms_per_batch' if 'infer' in workload
                   else 'ms_per_step']) == {'off', 'profile', 'program'}
    (prog,) = out['programs']
    names = set(prog['spans'])
    if workload == 'scannet-infer':
        assert {'b2m.infer.pack', 'b2m.infer.harvest', 'b2m.infer.post',
                'b2m.post.cluster', 'b2m.post.mask_nms'} <= names
        r = prog['readings']
        assert r['greedy_steps.infer'] > 0 and r['post_syncs.infer'] > 0
        assert r['wire_mb.infer'] > 0 and r['pack_wait_ms.infer'] >= 0
        assert prog['counts']['scenes'] == 2 * prog['batches']
    else:
        assert {'b2m.train.upload', 'b2m.train.step', 'b2m.train.forward',
                'b2m.train.backward', 'b2m.train.optimizer'} <= names
        assert prog['spans']['b2m.train.step']['count'] == prog['steps']
