"""`correct` has to come out false when the timed path is broken: the rest
of a run, without the look for a card, at a tiny size on the CPU, once
sound and once with each fault a cell can have planted in the program
underneath (none of these cells crosses chips, so the exchange between
chips cannot be left out). And the control (the reference one precision
step down in the program's place) has to fail what the program passes."""

import types

import pytest
import torch

from h100bench import control, harness
from h100bench import port as real_port
from h100bench_tiny import TINY_LIMITS, make_root

CPU = torch.device('cpu')
INFER = ['scannet-infer']


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp('faults'))


def _run(root, workload, port=real_port):
    return harness.run_cell(root, workload, 2**31 + 17, 1.0, False, CPU, 0.0,
                            port=port)


def _port(**overrides):
    """The program's door with some of its functions replaced."""
    p = types.SimpleNamespace(**{k: getattr(real_port, k) for k in
                                 dir(real_port) if not k.startswith('__')})
    for k, v in overrides.items():
        setattr(p, k, v)
    return p


def _half_batches(cfg, config, items, mode):
    """Half of the batch left out: only its first half goes to the program
    (the mean is taken over the rest)."""
    return real_port.host_batch(cfg, config, items[:len(items) // 2], mode)


def _loss_over_half(real):
    """Half of the batch left out of the loss: the forward runs over the
    whole batch, and the segments of its second half of scenes count as
    padding (the mean is taken over the rest)."""
    def compute_losses(cfg, pred, batch, *args):
        ids = batch['batch_ids']
        first = (ids >= 0) & (ids < (int(ids.max()) + 1) // 2)
        return real(cfg, pred, dict(
            batch, seg_valid=batch['seg_valid'].bool() & first), *args)
    return compute_losses


@pytest.mark.parametrize('workload', INFER + ['scannet-train'])
def test_sound_run_is_correct(root, workload):
    out = _run(root, workload)
    assert out['correct'] is True, out['compared']


@pytest.mark.parametrize('workload', INFER + ['scannet-train'])
def test_half_of_the_batch_left_out(root, workload, monkeypatch):
    if workload in INFER:
        out = _run(root, workload, _port(host_batch=_half_batches))
    else:
        from box2mask_torch.engine import state as S
        monkeypatch.setattr(S, 'compute_losses',
                            _loss_over_half(S.compute_losses))
        out = _run(root, workload)
    assert out['correct'] is False, out['compared']


@pytest.mark.parametrize('workload', INFER)
def test_answer_altered_where_it_is_produced(root, workload, monkeypatch):
    """The unpack of the device results hands back every mask's class as
    the next valid class."""
    from box2mask_torch.engine import infer
    real = infer.stacked_masks_to_results

    def shifted(out_np, host, valid_class_ids, **kw):
        res = real(out_np, host, valid_class_ids, **kw)
        ids = list(valid_class_ids)
        for r in res.values():
            r['label_id'] = r['label_id'].copy()
            for i, v in enumerate(r['label_id']):
                r['label_id'][i] = ids[(ids.index(v) + 1) % len(ids)]
        return res
    monkeypatch.setattr(infer, 'stacked_masks_to_results', shifted)
    out = _run(root, workload)
    assert out['correct'] is False
    assert out['compared']['mask_miss']['value'] > 0.5


@pytest.mark.parametrize('workload', INFER)
def test_head_altered_where_it_is_produced(root, workload, monkeypatch):
    """The forward hands back its box offsets half as long again."""
    from box2mask_torch.nn.unet import SelectionNet
    real = SelectionNet.forward

    def moved(self, batch):
        out = real(self, batch)
        out['mlp_offsets'] = out['mlp_offsets'] * 1.5
        return out
    monkeypatch.setattr(SelectionNet, 'forward', moved)
    out = _run(root, workload)
    assert out['correct'] is False
    assert out['compared']['head_gap']['value'] > \
        TINY_LIMITS[workload]['head_gap']


def test_step_returns_its_state_unchanged(root, monkeypatch):
    from box2mask_torch.engine import state as S

    def no_update(state, lr):
        for p in state.params:
            p.grad = None
        state.step += 1
        return state
    monkeypatch.setattr(S, 'apply_update', no_update)
    out = _run(root, 'scannet-train')
    assert out['correct'] is False
    assert out['compared']['change_gap']['value'] == pytest.approx(1.0)


@pytest.mark.parametrize('workload', ['scannet-infer', 'scannet-train'])
def test_control_is_not_correct(root, workload):
    row = control.readings(root, workload, 2**31 + 23, 1.0, CPU, real_port)
    lim = TINY_LIMITS[workload]
    assert all(row['program'][k] <= v for k, v in lim.items()), row
    assert any(row['control'][k] > v for k, v in lim.items()), row
    for name, got in row.items():
        if name.startswith('fault_'):
            assert any(got[k] > v for k, v in lim.items()), row
