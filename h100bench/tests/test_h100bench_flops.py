"""The benchmark's operation and byte counts (flops.py): matched pairs as the
program's plain conv twin counts them, the topology as the program's
every-offset count (nn/flops.py) gives it, launches as the kernel table
lists them."""

import numpy as np
import pytest
import torch

from h100bench import flops
from h100bench import scenes as G
from h100bench_tiny import REPO, load_config


@pytest.fixture(scope='module')
def batch():
    from h100bench import port
    config = load_config(REPO, 'scannet')
    config['assumed_flags'] = {'vox_bucket': 512, 'seg_bucket': 64}
    cfg = port.make_cfg(config)
    items = [G.scannet_scene(s, f's{s}', num_instances=3,
                             points_per_instance=300, floor_points=1500,
                             wall_points=1000, room_size=(2.5, 2.0, 1.2))
             for s in (1, 2)]
    dev, _ = port.host_batch(cfg, config, items, 'test')
    return config, dev


def _twin_hits(dev, level, kernel_size):
    """Matched pairs of a same-level conv: the program's plain twin of a
    1-channel all-ones conv counts them."""
    from box2mask_torch.sparse import key_conv as KC
    kin = torch.as_tensor(dev[f'keys{level}_b'])
    K = kernel_size ** 3
    ones = torch.ones(kin.numel(), 1)
    out = KC.key_conv_plain(ones, kin, kin.reshape(-1), torch.ones(K, 1, 1),
                            kernel_size=kernel_size, scale=1 << level,
                            out_dtype=torch.float32)
    return int(out.sum().item())


def test_pairs_match_the_twin(batch):
    _, dev = batch
    c = flops.batch_counts(dev)
    for level in range(8):
        assert c['same'][level] == _twin_hits(dev, level, 3), level
        assert c['rows'][level] == int((dev[f'keys{level}_b']
                                        < flops.SENT_KEY).sum())
    assert c['stem'] == _twin_hits(dev, 0, 5)
    assert 0 < c['same'][0] < 27 * c['rows'][0]


def test_topology_is_the_programs(batch):
    """With every kernel slot counted as a hit (and every head's last layer
    as wide as the semantics', as nn/flops.py bounds it), the sites'
    operations equal the program's estimate for the same rows."""
    from box2mask_torch.nn.flops import estimate_forward_flops
    config, dev = batch
    c = flops.batch_counts(dev)
    m = dict(config['model'], classes=config['classes']['valid_ids'])
    sites = flops.conv_sites(c, m)
    every = 0
    for s in sites:
        n = s['n_out'] * s['K']
        cout = (20 if s['kind'] == 'head' and s['cin'] == 96
                and s['cout'] != 96 else s['cout'])
        every += 2 * n * s['cin'] * cout
    assert every == estimate_forward_flops(
        c['rows'], layers=2, num_classes=20, n_heads=4,
        n_segments=c['segments'], in_dim=6)
    assert flops.forward_flops(sites) < every


def test_launches_and_train_flops(batch):
    config, dev = batch
    m = dict(config['model'], classes=config['classes']['valid_ids'])
    sites = flops.conv_sites(flops.batch_counts(dev), m)
    fwd = flops.key_conv_launches(sites, 2, train=False)
    step = flops.key_conv_launches(sites, 2, train=True)
    assert len(fwd) == 56 + 7 + 7 + 1          # 3^3, down, up, stem
    assert len(step) == 3 * len(fwd) - 1       # + dx (not the stem) + dw
    stem = [s for s in sites if s['kind'] == 'stem']
    assert flops.train_flops(sites) == (3 * flops.forward_flops(sites)
                                        - flops.site_flops(stem[0]))
    b = flops.bound_s(fwd, 989e12, 3.35e12)
    assert b >= sum(f for f, _ in fwd) / 989e12
    assert b >= sum(n for _, n in fwd) / 3.35e12 / len(fwd)


def test_pairs_by_brute_force():
    rng = np.random.default_rng(0)
    cells = np.unique(rng.integers(0, 12, (300, 3)), axis=0)
    want = 0
    s = {tuple(c) for c in cells.tolist()}
    for c in cells.tolist():
        for d in np.ndindex(3, 3, 3):
            want += tuple(np.add(c, d) - 1) in s
    assert flops._pairs(cells, 3) == want
