"""A tiny copy of the benchmark for CPU tests: the checkout's BENCHMARK.json
and h100bench/ in a temporary directory, with scenes, buckets and pools cut
to a size the CPU runs in seconds. The cells' limits are set at full size
on the card; runs this small read more (a few rows per coarse level), so
the tiny copy carries limits of its own, set from tiny readings and still
under what the control and each fault read here."""

import contextlib
import json
import os
import shutil

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_LIMITS = {
    'scannet-infer': {'head_gap': 0.1, 'mask_miss': 0.05},
    'scannet-train': {'out_grad_diff': 0.3, 'change_gap': 0.5},
}


def _edit(path, fn):
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, 'w') as f:
        json.dump(d, f, indent=1)


def make_root(tmp):
    root = os.path.join(str(tmp), 'checkout')
    shutil.copytree(os.path.join(REPO, 'h100bench'),
                    os.path.join(root, 'h100bench'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), root)
    hb = os.path.join(root, 'h100bench')

    def scannet(c):
        c['scene'].update(num_instances=3, points_per_instance=300,
                          floor_points=1500, wall_points=1000,
                          room_size=[2.5, 2.0, 1.2])
        c['assumed_flags'] = {'vox_bucket': 512, 'seg_bucket': 64}
        c['preset']['batch_size'] = c['model']['batch_size'] = 2

    def arkit(c):
        c['scene'].update(n_vertices=6000, n_objects=2,
                          room_size=[3.0, 2.5, 1.2])
        c['assumed_flags'] = {'vox_bucket': 512}
    _edit(os.path.join(hb, 'configs', 'scannet.json'), scannet)
    _edit(os.path.join(hb, 'configs', 'arkitscenes.json'), arkit)
    _edit(os.path.join(hb, 'traffic', 'eval-offline.json'), lambda t: t.update(
        batch_size=2, pool_batches=2, trace_batches=2))
    _edit(os.path.join(hb, 'traffic', 'train-steps.json'),
          lambda t: t.update(trace_steps=1))
    for w, lim in TINY_LIMITS.items():
        _edit(os.path.join(hb, 'limits', f'{w}.json'),
              lambda d, lim=lim: d.update(limits=lim))
    return root


def f32_config(root, name='scannet'):
    """The configuration with f32 activations and f32 conv and linear
    operands (--compute_dtype float32), for exact comparisons."""
    def edit(c):
        c['preset'].pop('bf16_acts', None)
        c['preset']['compute_dtype'] = 'float32'
        c['model']['act_dtype'] = c['model']['compute_dtype'] = 'float32'
    _edit(os.path.join(root, 'h100bench', 'configs', f'{name}.json'), edit)


@contextlib.contextmanager
def unrounded_twins():
    """The program's key convs and their weight gradients through the plain
    twins on unrounded f32 operands (its bf16 rounding off)."""
    from box2mask_torch.sparse import key_conv as KC
    f32 = dict(operand_dtype=torch.float32)
    names = ('SAVED_X_DTYPE', 'key_conv', 'key_conv_stem', 'key_conv_dw',
             'key_conv_stem_dw')
    saved = {k: getattr(KC, k) for k in names}
    KC.SAVED_X_DTYPE = torch.float32
    KC.key_conv = lambda x, kin, kout, w, **kw: KC.key_conv_plain(
        x, kin, kout, w, **f32, **kw)
    KC.key_conv_stem = lambda x, kin, w: KC.key_conv_plain(
        x, kin, kin.reshape(-1), w, kernel_size=5, out_dtype=torch.float32,
        **f32)
    KC.key_conv_dw = lambda x, g, kin, kout, **kw: KC.key_conv_dw_plain(
        x, g, kin, kout, **f32, **kw)
    KC.key_conv_stem_dw = lambda x, g, kin: KC.key_conv_dw_plain(
        x, g, kin, kin.reshape(-1), kernel_size=5, **f32)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(KC, k, v)


def load_config(root, name):
    with open(os.path.join(root, 'h100bench', 'configs', f'{name}.json')) as f:
        return json.load(f)
