"""The arithmetic of device.py (busy time as the union of device events,
the key-conv kernels picked by name) and the metric readers on made-up
observations; the profiler path on the card."""

import pytest
import torch

from h100bench import device as D
from h100bench import harness
from h100bench_tiny import REPO


def test_busy_time_is_the_union():
    us = [(0, 10), (5, 12), (20, 30), (21, 25)]
    assert D._union_s(us) == pytest.approx(22e-6)
    assert D._union_s([]) == 0


def test_key_conv_kernels_by_name():
    by_name = {'void (anonymous namespace)::key_conv_kernel<96>(x)': 1.0,
               'void (anonymous namespace)::key_conv_dw_kernel<32>(x)': 2.0,
               'match_table_kernel(int const*)': 0.5,
               'void at::native::elementwise_kernel<128>(x)': 4.0}
    assert D.key_conv_device_s(by_name) == 3.5
    assert D.top_ops(by_name, 2)[0][1] == 4.0


OBS = {
    'stages': [{'upload_ms': u, 'forward_ms': 2 * u, 'postproc_ms': 3 * u,
                'harvest_ms': 4 * u} for u in (1.0, 2.0, 30.0)],
    'conv': {'device_s': 2.0, 'bound_s': 0.1},
    'window': {'seconds': 10.0, 'flops': 989e12, 'peak_flop_s': 989e12},
    'profile': {'busy_s': 1.0, 'window_s': 4.0},
}


@pytest.mark.parametrize('name,want', [
    ('upload_ms.infer', 2.0), ('forward_ms.infer', 4.0),
    ('postproc_ms.infer', 6.0), ('harvest_ms.infer', 8.0),
    ('key_conv_roofline.infer', 5.0), ('idle_share.infer', 75.0),
    ('mfu.infer', 10.0)])
def test_infer_readers(name, want):
    assert harness.reader(REPO, name)(OBS) == pytest.approx(want)
    bench = harness.load_bench(REPO)
    assert name not in [m['name'] for m in
                        harness.per_layer(bench, 'scannet-train')]


def test_train_readers():
    obs = dict(OBS, train_stages=[
        {'upload_ms': 1.0, 'forward_ms': 2.0, 'backward_ms': 3.0,
         'optimizer_ms': 4.0}])
    for name, want in (('upload_ms.train', 1.0), ('forward_ms.train', 2.0),
                       ('backward_ms.train', 3.0),
                       ('optimizer_ms.train', 4.0),
                       ('key_conv_roofline.train', 5.0),
                       ('idle_share.train', 75.0), ('mfu.train', 10.0)):
        assert harness.reader(REPO, name)(obs) == pytest.approx(want)
    silent = dict(obs, conv={'device_s': 0.0, 'bound_s': 0.1})
    assert harness.reader(REPO, 'key_conv_roofline.train')(silent) is None


@pytest.mark.cuda
def test_profile_sees_the_card(card):
    x = torch.randn(2048, 2048, device=card)
    prof = D.profile(lambda: [x @ x for _ in range(10)], card)
    assert 0 < prof['busy_s'] <= prof['window_s']
    assert prof['by_name']
