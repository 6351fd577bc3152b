"""The port's compact upload wire (box2mask_torch/engine/hostload.py)
against the JAX package's (box2mask_tpu/engine/hostload.py).

  * pack() gives the JAX package's bytes (and byte count) on real batches
    of both packages: the port's key-path batch, the same under --key_conv
    off (device maps), a host-maps batch past 1024 voxels on an axis, a
    batch without segment pooling, a batch of pad 65536 (the key-row delta
    codec: its exception cap fits a 2 cm scene there), and the JAX
    package's batch with its TPU window plans (--key_conv_force: the plan
    codecs); for wire raw / compact and derive off / on. unpack() on the
    CPU returns every array bit for bit, with its dtype, and equals the JAX
    unpack. Where the JAX pack refuses (the derivation of seg_valid
    without segment pooling), the port's refuses with the same message.
  * The codecs through their exception lists (key deltas past u16, parent
    jumps past i8, plan bases past u16, segment ids past i8), as
    tests/test_hostload.py builds them; 64-bit arrays narrowed as JAX's
    wire narrows them and given back in their dtype.
  * The refusals and downgrades of tests/test_hostload.py: shape drift,
    colours off the u8 grid, the exception cap, a tampered derivation;
    BatchUploader lands on the wire that packs and stays exact.
  * FusedInferencePipeline on the CPU: the per-scene results with the
    packed wire equal those with the per-array upload, and its counters;
    it packs each batch on its packer thread while it ships the one before.
"""

import threading
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_tpu.engine import hostload as JH
from box2mask_torch import config as PC
from box2mask_torch import tracing
from box2mask_torch.convert import kaiming_init_
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.engine import state as S
from box2mask_torch.engine import hostload as PH
from box2mask_torch.engine.hostload import upload
from box2mask_torch.engine.infer import FusedInferencePipeline
from box2mask_torch.sparse.keys import SENT_KEY

torch.set_num_threads(2)
ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision', '--smallest_bb_heuristic',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1', '--voxel_size', '0.05',
        '--vox_bucket', '512', '--seg_bucket', '64', '--layers', '1',
        '--eval_ths', '0.5', '0.05', '0.3', '0.6', '--exp_name',
        'torch_hostload']
SCENE = dict(num_instances=5, points_per_instance=250, floor_points=900,
             wall_points=700)
CASES = {'key_path': [], 'device_maps': ['--key_conv', 'off'],
         'past_1024': [], 'no_pooling': [],
         'pad_65536': ['--voxel_size', '0.02', '--vox_bucket', '65536'],
         'jax_plans': ['--key_conv_force']}


def batch(case):
    """The numpy batch dict of the case (the JAX package builds the plan
    case, the port every other)."""
    args = [a for a in ARGS if case != 'no_pooling'
            or a != '--do_segment_pooling'] + CASES[case]
    if case == 'jax_plans':
        cfg = JC.get_config(args)
        cfg.use_native_host_ops = False
        rets = [JV.voxelize_scene(JSyn.make_scene(seed=s, **SCENE)[0], cfg)
                for s in (3, 4)]
        return JB.build_batch(rets, cfg, JT.SCANNET_SEMANTIC_ID2IDX,
                              mode='val')[0]
    cfg = PC.get_config(args)
    cfg.use_native_host_ops = False
    rets = [PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], cfg)
            for s in (3, 4)]
    if case == 'past_1024':
        rets[1]['vox_coords'] = rets[1]['vox_coords'] + np.array(
            [1100, 0, 0], rets[1]['vox_coords'].dtype)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return PB.build_batch(rets, cfg, JT.SCANNET_SEMANTIC_ID2IDX,
                              mode='val')[0]


def assert_batch(out, dev, jout=None):
    assert set(out) == set(dev)
    for k, v in dev.items():
        want = torch.from_numpy(np.array(v))        # 0-d stays 0-d
        assert out[k].dtype == want.dtype, k
        assert torch.equal(out[k], want), k
        if jout is not None:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]),
                                          err_msg=k)


@pytest.mark.parametrize('case', sorted(CASES))
def test_pack_bytes_and_unpack_match_jax(case):
    dev = batch(case)
    if case == 'past_1024':
        assert 'keys0_b' not in dev and 'nmap5_0' in dev
    if case == 'pad_65536':          # the key-row delta codec's cap fits
        assert dev['keys0_b'].shape[1] >= 65536
    if case == 'jax_plans':
        assert any(k.startswith('kc3_base') for k in dev)
    sizes = []
    for wire in ('raw', 'compact'):
        for derive in (False, True):
            jpack, junpack, jn = JH.make_batch_packer(dev, wire=wire,
                                                      derive=derive)
            pack, unpack, n = PH.make_batch_packer(dev, wire=wire,
                                                   derive=derive)
            try:
                jbuf = jpack(dev)
            except AssertionError as e:
                with pytest.raises(AssertionError) as got:
                    pack(dev)
                assert str(got.value) == str(e)
                continue
            buf = pack(dev)
            assert n == jn and buf.shape == (n,)
            assert np.array_equal(buf, jbuf), (wire, derive)
            jout = jax.jit(junpack)(jnp.asarray(buf))
            assert_batch(unpack(torch.from_numpy(buf)), dev, jout)
            sizes.append(n)
    assert sizes[-1] < sizes[0]             # the compact wire shrank


def exception_dicts():
    """tests/test_hostload.py's batches that reach every exception list."""
    rng = np.random.default_rng(3)
    B, pad, pad1 = 2, 8192, 4096
    keys = np.zeros((B, pad), np.int64)
    ups = np.zeros((B, pad), np.int64)
    for b in range(B):
        n = 6000 + b * 500
        d = rng.integers(1, 5, size=n)
        d[rng.choice(n, size=40, replace=False)] = rng.integers(
            1 << 17, 1 << 20, size=40)
        keys[b, :n] = np.cumsum(d)
        keys[b, n:] = SENT_KEY
        p = np.cumsum(rng.integers(0, 2, size=n)) % (pad1 // 2)
        p[rng.choice(n, size=30, replace=False)] = rng.integers(
            0, pad1, size=30)
        ups[b, :n] = p + b * pad1
        ups[b, n:] = B * pad1
    keys1 = np.concatenate([np.sort(rng.choice(1 << 20, size=100,
                                               replace=False)),
                            np.full(pad1 - 100, SENT_KEY)])
    trees = {'keys0_b': keys.astype(np.int32),
             'keys1_b': keys1.astype(np.int32)[None, :].repeat(B, axis=0),
             'up_parent0': ups.reshape(-1).astype(np.int32)}
    V, T, G = 4096, 64, 3
    pool = np.cumsum(rng.integers(0, 2, size=V)) % 500
    pool[rng.choice(V, size=17, replace=False)] = rng.integers(
        0, 60000, size=17)
    d = rng.integers(0, 1000, size=(B, T, G)).astype(np.int64)
    d[:, 17, :] = 1 << 18
    plans = {'pooling_ids': pool.astype(np.int32),
             'seg_valid': np.ones(1000, bool),
             'kc3_base0': np.cumsum(d, axis=1).astype(np.int32),
             'kc3_cnt0': rng.integers(0, 23, size=(B, T, G)).astype(np.int32),
             'vox_features': (rng.integers(0, 256, (V, 3)) / 255.0
                              ).astype(np.float32),
             'batch_ids': rng.integers(-1, 2, size=64).astype(np.int32),
             'ids64': rng.integers(0, 1 << 30, size=7).astype(np.int64),
             'flags': rng.integers(0, 255, size=5).astype(np.uint8),
             'small': rng.integers(-100, 100, size=9).astype(np.int8),
             'half': rng.normal(size=5).astype(np.float16),
             'num0': np.int32(57)}
    return {'keys_parents': trees, 'plans_pooling': plans}


@pytest.mark.parametrize('case', ['keys_parents', 'plans_pooling'])
def test_exception_lists_roundtrip(case):
    dev = exception_dicts()[case]
    for wire in ('raw', 'compact'):
        jpack, junpack, jn = JH.make_batch_packer(dev, wire=wire)
        pack, unpack, n = PH.make_batch_packer(dev, wire=wire)
        buf = pack(dev)
        assert np.array_equal(buf, jpack(dev)), wire
        jout = jax.jit(junpack)(jnp.asarray(buf))
        assert_batch(unpack(torch.from_numpy(buf)), dev, jout)
    assert n < 0.55 * PH.make_batch_packer(dev, wire='raw')[2]


def test_pack_refuses_shape_drift_and_lossy_narrowing():
    pack, _, _ = PH.make_batch_packer({'a': np.zeros((4, 4), np.float32)})
    with pytest.raises(AssertionError, match='signature'):
        pack({'a': np.zeros((4, 5), np.float32)})
    pack, _, _ = PH.make_batch_packer({'i': np.zeros(3, np.int64)})
    with pytest.raises(AssertionError, match='do not fit'):
        pack({'i': np.array([1, 2, 1 << 40])})


def test_codec_cap_and_color_grid_are_loud():
    pad = 8192
    v = np.cumsum(np.full(pad, 1 << 16, np.int64)).astype(np.int32)[None]
    pack, _, _ = PH.make_batch_packer({'keys0_b': v}, wire='compact')
    with pytest.raises(AssertionError, match='exceptions exceed'):
        pack({'keys0_b': v})
    grid = {'vox_features': (np.arange(24).reshape(8, 3) / 255.0
                             ).astype(np.float32)}
    pack, _, _ = PH.make_batch_packer(grid, wire='compact')
    with pytest.raises(AssertionError, match='not exactly u8/255'):
        pack({'vox_features': grid['vox_features'] + np.float32(1e-4)})
    off = {'vox_features': np.full((8, 3), 0.123456, np.float32)}
    pack, unpack, n = PH.make_batch_packer(off, wire='compact')
    assert n == JH.make_batch_packer(off, wire='compact')[2] >= 8 * 3 * 4
    assert_batch(unpack(torch.from_numpy(pack(off))), off)


def uploader_base():
    rng = np.random.default_rng(2)
    V = 64
    keys = np.sort(rng.choice(1 << 20, size=40, replace=False))
    base = {'keys0_b': np.concatenate([keys, np.full(V - 40, SENT_KEY)]
                                      ).astype(np.int32)[None, :],
            'vox_features': (rng.integers(0, 256, size=(V, 3)) / 255.0
                             ).astype(np.float32),
            'num0': np.int32(40)}
    base['valid0'] = (base['keys0_b'] != SENT_KEY).reshape(-1)
    base['batch0'] = np.where(base['valid0'], 0, -1).astype(np.int32)
    return base


def test_batch_uploader_fallbacks():
    """The JAX package's chain, one step per refusal: the pristine batch on
    compact + derive + u8 colours; colours off the grid drop the u8 codec;
    a tampered derivable array drops the derivations; the exception cap
    lands on the raw wire. Each batch comes back bit for bit."""
    up = PH.BatchUploader('cpu')
    base = uploader_base()
    aug = dict(base, vox_features=base['vox_features'] + np.float32(1e-4))
    bad = dict(aug, batch0=base['batch0'].copy())
    bad['batch0'][0] = 7
    for dev, how in ((base, ('compact', True, True)),
                     (aug, ('compact', True, False)),
                     (bad, ('compact', False, False))):
        assert_batch(shipped(up, dev), dev)
        assert up.wires()[up.signature(dev)] == how
    pad = 8192
    cap = {'keys0_b': (np.arange(pad, dtype=np.int64) * (1 << 18)
                       ).astype(np.int32)[None],
           'num_segments': np.int32(10),
           'vox_features': np.random.default_rng(7).random(
               (pad, 3)).astype(np.float32)}
    assert_batch(shipped(up, cap), cap)
    assert up.wires()[up.signature(cap)] == ('raw', False, False)
    assert up.wire_bytes > 0 and up.pack_s > 0


def shipped(up, dev):
    buf, unpack = up.ship(up.pack(dev))
    return unpack(buf)


def test_pipeline_packs_one_batch_ahead():
    """Each batch after the first is being packed on the packer thread
    before the main thread ships the batch before it (the ship waits, with
    a time limit, for that pack to start), and reaches the forward bit for
    bit."""
    cfg = PC.get_config(ARGS)
    valid_ids, _, _, is_fg = get_tables('scannet')
    pipe = FusedInferencePipeline(
        cfg, valid_ids, is_fg, model=S.build_model(cfg, len(valid_ids), 'cpu'),
        device='cpu')
    base = uploader_base()
    devs = [dict(base, num0=np.int32(40 - i)) for i in range(4)]
    index = {id(d): i for i, d in enumerate(devs)}
    started = [threading.Event() for _ in devs]
    packed_on_main, ahead = [], []
    pack, ship = pipe.uploader.pack, pipe.uploader.ship

    def logged_pack(dev):
        started[index[id(dev)]].set()
        packed_on_main.append(threading.current_thread()
                              is threading.main_thread())
        return pack(dev)

    def logged_ship(packed):
        i = len(ahead)
        ahead.append(i + 1 == len(devs) or started[i + 1].wait(timeout=30))
        return ship(packed)
    pipe.uploader.pack, pipe.uploader.ship = logged_pack, logged_ship
    seen = []

    def infer(batch, ths):
        seen.append(batch)
        return None, batch, None
    pipe.infer = infer
    pipe._harvest = lambda pred, full, out, host, ths: ({}, {})
    hosts = [{'scene': [{'name': f's{i}'}]} for i in range(len(devs))]
    tracing.reset_counts()
    got = [h for _, _, _, h in pipe.run(None, zip(devs, hosts),
                                        cfg.eval_ths)]
    assert got == hosts and tracing.counts()['scenes'] == len(devs)
    assert packed_on_main == [False] * len(devs)
    assert ahead == [True] * len(devs)
    for dev, batch in zip(devs, seen):
        assert_batch(batch, dev)


def test_pipeline_packed_equals_per_array():
    """FusedInferencePipeline.run (packed wire) against the same pipeline
    fed per-array uploads: every scene's conf, label ids and masks equal;
    the wire each signature took, its bytes and packing seconds counted."""
    cfg = PC.get_config(ARGS)
    cfg.use_native_host_ops = False
    rets = [[PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], cfg)
             for s in seeds] for seeds in ((3, 4), (5, 6), (7, 8))]
    batches = [PB.build_batch(r, cfg, JT.SCANNET_SEMANTIC_ID2IDX,
                              mode='val') for r in rets]
    valid_ids, _, _, is_fg = get_tables('scannet')
    model = kaiming_init_(S.build_model(cfg, len(valid_ids), 'cpu'),
                          torch.Generator().manual_seed(1))
    pipe = FusedInferencePipeline(cfg, valid_ids, is_fg, model=model,
                                  device='cpu')
    ths = torch.tensor(cfg.eval_ths)
    got = {}
    tracing.reset_counts()
    for results, _, _, _ in pipe.run(None, batches, cfg.eval_ths):
        got.update(results)
    assert tracing.counts()['scenes'] == 6 and pipe.pack_s > 0
    assert pipe.wire_bytes == 3 * pipe.uploader._cache[
        pipe.uploader.signature(batches[0][0])]['nbytes']
    assert set(pipe.uploader.wires().values()) == {('compact', True, True)}
    want = {}
    for dev_np, host in batches:
        pred, full, out = pipe.infer(upload(dev_np, pipe.device), ths)
        want.update(pipe._harvest(pred, full, out, host, ths)[0])
    assert sorted(got) == sorted(want) and len(got) == 6
    n_masks = 0
    for name, w in want.items():
        for k in ('conf', 'label_id', 'mask'):
            np.testing.assert_array_equal(got[name][k], w[k], err_msg=name)
        n_masks += len(w['conf'])
    assert n_masks > 0
