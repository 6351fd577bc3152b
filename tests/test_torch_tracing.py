"""The port's spans and counters (box2mask_torch/tracing.py).

  * With no profiler a span is one shared null context and records
    nothing; under a profiler it is a host range, not a user annotation.
  * Under the profiler setting of the port's traces, one
    FusedInferencePipeline.run on the CPU shows the pack on the packer
    thread, the harvest on a harvester thread and the clustering nested in
    the post-processing on the main thread; its counters count the scenes
    and the clustering's trips. The Trainer's --profile_dir
    profiler records other threads' spans too.
  * The greedy loops' trips and host reads for N disjoint boxes, each its
    own cluster and its own kept mask; the wire's bytes; counts() carries
    the kernel modules' counters; add() loses no update across threads.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from box2mask_torch import config as PC
from box2mask_torch import tracing
from box2mask_torch.convert import kaiming_init_
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.engine import hostload as PH
from box2mask_torch.engine import state as S
from box2mask_torch.engine import train as PT
from box2mask_torch.engine.infer import FusedInferencePipeline
from box2mask_torch.postprocess.device_post import make_core
from box2mask_torch.postprocess.nms import SYNC_EVERY
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import masked_bn as MB

torch.set_num_threads(2)
ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision', '--smallest_bb_heuristic',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1', '--voxel_size', '0.05', '--vox_bucket', '512', '--seg_bucket', '64',
        '--layers', '1', '--eval_ths', '0.5', '0.05', '0.3', '0.6',
        '--exp_name', 'torch_tracing']
SCENE = dict(num_instances=5, points_per_instance=250, floor_points=900,
             wall_points=700)
MARK = 'test.main'


def _events(fn):
    """Events of fn() under the port's profiler setting, and the profiler's
    id of the calling thread."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=tracing.profiler_config()) as prof:
        with torch.autograd.profiler.record_function(MARK):
            fn()
    events = list(prof.events())
    main = next(e.thread for e in events if e.name == MARK)
    return events, main


def _batches(cfg, seeds):
    _, sem_id2idx, _, _ = get_tables('scannet')
    return [PB.build_batch(
        [PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], cfg)
         for s in pair], cfg, sem_id2idx, mode='val') for pair in seeds]


def test_span_off_is_one_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError(f'a range was entered for {name}')
    monkeypatch.setattr(tracing, '_RecordFunctionFast', refuse)
    a, b = tracing.span('b2m.a'), tracing.span('b2m.b')
    assert a is b is tracing._OFF
    with a:
        pass


def _enter_twice():
    for _ in range(2):
        with tracing.span('b2m.x'):
            torch.ones(4).sum()


def test_span_on_is_a_host_range():
    events, main = _events(_enter_twice)
    got = [e for e in events if e.name == 'b2m.x']
    assert len(got) == 2
    assert all(e.thread == main and not e.is_user_annotation for e in got)


def test_pipeline_spans_on_their_threads():
    cfg = PC.get_config(ARGS)
    cfg.use_native_host_ops = False
    batches = _batches(cfg, ((3, 4),))
    valid_ids, _, _, is_fg = get_tables('scannet')
    model = kaiming_init_(S.build_model(cfg, len(valid_ids), 'cpu'),
                          torch.Generator().manual_seed(1))
    pipe = FusedInferencePipeline(cfg, valid_ids, is_fg, model=model,
                                  device='cpu')
    tracing.reset_counts()
    events, main = _events(lambda: list(pipe.run(None, batches,
                                                 cfg.eval_ths)))
    by = {}
    for e in events:
        by.setdefault(e.name, []).append(e)
    assert len(by['b2m.infer.pack']) == 1
    packer = {e.thread for e in by['b2m.infer.pack']}
    harvesters = {e.thread for e in by['b2m.infer.harvest']}
    assert main not in packer | harvesters and not packer & harvesters
    for child in ('b2m.harvest.readback', 'b2m.harvest.unpack'):
        assert {e.thread for e in by[child]} <= harvesters
    for name in ('b2m.infer.wait_pack', 'b2m.infer.ship',
                 'b2m.infer.forward', 'b2m.infer.post',
                 'b2m.infer.wait_harvest', 'b2m.post.mask_nms'):
        assert {e.thread for e in by[name]} == {main}, name
    posts = by['b2m.infer.post']
    assert len(posts) == 1 and len(by['b2m.post.cluster']) == 2
    for c in by['b2m.post.cluster']:
        assert c.thread == main and any(
            p.time_range.start <= c.time_range.start
            and c.time_range.end <= p.time_range.end for p in posts)
    n = tracing.counts()
    assert n['scenes'] == 2 and n['cluster_steps'] > 0


def test_trainer_profiler_records_every_thread():
    prof = PT._start_profiler(False)
    try:
        with ThreadPoolExecutor(1) as ex:
            ex.submit(_enter_twice).result()
    finally:
        prof.stop()
    assert sum(e.name == 'b2m.x' for e in prof.events()) == 2


def _disjoint(cfg, n, s_pad=64, per_seg=2):
    """pred and batch of one scene whose n valid segments are disjoint
    boxes, all foreground, with `per_seg` voxels each."""
    valid_ids, _, _, is_fg = get_tables('scannet')
    fg_class = int(np.flatnonzero(is_fg(np.asarray(valid_ids)))[0])
    loc = torch.zeros(s_pad, 3)
    loc[:, 0] = torch.arange(s_pad) * 10.0
    sem = torch.zeros(s_pad, len(valid_ids))
    sem[:, fg_class] = 5.0
    pred = {cfg.mlp_offsets: torch.zeros(s_pad, 3),
            cfg.mlp_bounds: torch.full((s_pad, 3), 0.5),
            cfg.mlp_bb_scores: torch.full((s_pad, 1), 5.0),
            cfg.mlp_semantics: sem}
    v = s_pad * per_seg
    batch = {'input_location': loc,
             'seg_valid': torch.arange(s_pad) < n,
             'batch_ids': torch.zeros(s_pad, dtype=torch.int32),
             'pooling_ids': torch.arange(v, dtype=torch.int32) // per_seg,
             'valid0': torch.arange(v) < n * per_seg,
             'batch0': torch.zeros(v, dtype=torch.int32)}
    return pred, batch, valid_ids, is_fg


@pytest.mark.parametrize('n', [0, 5, 16, 17, 40])
def test_greedy_loops_count_trips_and_reads(n):
    cfg = PC.get_config(ARGS)
    pred, batch, valid_ids, is_fg = _disjoint(cfg, n)
    core = make_core(cfg, valid_ids, is_fg, max_masks=64)
    tracing.reset_counts()
    out = core(pred, batch, 0, torch.tensor(cfg.eval_ths))
    assert int(out['n_keep']) == n
    trips = -(-n // SYNC_EVERY) * SYNC_EVERY
    got = tracing.counts()
    assert got['cluster_steps'] == got['mask_nms_steps'] == trips
    assert got['post_syncs'] == 2 * (-(-trips // SYNC_EVERY) + 1)


def test_wire_bytes_are_the_shipped_buffers():
    cfg = PC.get_config(ARGS)
    cfg.use_native_host_ops = False
    dev_np = _batches(cfg, ((3, 4),))[0][0]
    up = PH.BatchUploader('cpu')
    shipped = 0
    for _ in range(2):
        buf, unpack = up.ship(up.pack(dev_np))
        shipped += buf.numel() * buf.element_size()
        unpack(buf)
    assert up.wire_bytes == shipped > 0


def test_counts_carry_the_kernel_counters():
    tracing.reset_counts()
    KC.LAUNCHES['same'] += 3
    tracing.add('scenes')
    got = tracing.counts()
    assert got['key_conv']['same'] == 3 and got['scenes'] == 1
    assert {'key_conv_plain', 'nmap_conv', 'nmap_conv_plain',
            'masked_bn', 'masked_bn_plain', 'torch_formulation',
            'halo'} <= set(got)
    MB.PLAIN_CALLS['bwd'] += 2
    assert tracing.counts()['masked_bn_plain']['bwd'] == 2
    tracing.reset_counts()
    assert KC.LAUNCHES['same'] == 0 == tracing.counts()['scenes']
    assert MB.PLAIN_CALLS['bwd'] == 0


def test_add_loses_no_update_across_threads():
    n_threads, n_adds = 16, 2000
    tracing.reset_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tracing.add('cluster_steps', 3) for _ in range(n_adds)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tracing.counts()['cluster_steps'] == 3 * n_threads * n_adds
