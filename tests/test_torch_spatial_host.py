"""Spatial sharding of the port (box2mask_torch/parallel/spatial.py), its
host plans and its pieces, against the JAX package
(box2mask_tpu/parallel/spatial.py) on the CPU: gloo ranks in spawned
processes (tests/test_torch_parallel_common.run_ranks), JAX under
shard_map on the virtual CPU devices of tests/conftest.py.

  * plan_shards and build_spatial_unet_batch bit-equal to the JAX
    functions for every array the port keeps, on the neighbor-map route
    and the key route (whose TPU window plans and transpose maps the port
    drops), spatial_meta included; a scene past the 10-bit key packing
    falls back to the neighbor-map route with the same RuntimeWarning;
    too many shards raise the same ValueError;
  * make_spatial_conv_stack on 4 ranks equal to JAX's on
    tests/test_spatial.py's scene, and its backward through halo_extend
    equal to autograd of the one-process conv chain;
  * the key-route down conv whose extended fine rows have parents on the
    neighbour shard, and the level-G gather under the up conv, against
    autograd of the one-process chain;
  * the max pool's pmax: the JAX package cannot differentiate it, and the
    port's backward raises the same way.
"""

import functools
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import supervision as JSup
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_tpu.parallel import spatial as JSP
from box2mask_torch import config as PC
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.parallel import spatial as SP
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import ops
from box2mask_torch.sparse.coords import (build_scene_pyramid,
                                          kernel_offsets, pack)
from box2mask_torch.sparse.keys import SENT_KEY, host_level_keys
from test_torch_parallel_common import run_ranks
from test_torch_spatial_common import (ARGS, BATCH_KW, D, G, conv_stack_worker,
                                       make_ret, max_pool_worker,
                                       piece_worker, random_scene)
from test_torch_train_common import remove_tmp_path  # noqa: F401

# arrays of the JAX key route that the port does not carry: the TPU window
# plans and the down convs' transpose maps (parallel/spatial.py docstring)
TPU_ONLY = ('sp_kc3_base', 'sp_kc3_cnt', 'sp_kc5_base0', 'sp_kc5_cnt0',
            'sp_kcd_base', 'sp_kcd_cnt', 'sp_kcd_par', 'sp_kcd_widx')


@pytest.fixture(scope='module')
def rets():
    jc, pc = JC.get_config(ARGS), PC.get_config(ARGS)
    jc.use_native_host_ops = pc.use_native_host_ops = False
    return (make_ret(jc, JSyn.make_scene, JV.voxelize_scene,
                     JSup.build_supervision),
            make_ret(pc, PSyn.make_scene, PV.voxelize_scene,
                     PSup.build_supervision))


def assert_same_batch(j, p):
    """Every array of the port's batch bit-equal to the JAX one's; the JAX
    batch holds nothing else but the TPU-only arrays."""
    extra = sorted(k for k in j if k not in p)
    assert all(k.startswith(TPU_ONLY) for k in extra), extra
    assert set(p) <= set(j), sorted(set(p) - set(j))
    for k in p:
        a, b = np.asarray(j[k]), np.asarray(p[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                          b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    return extra


@pytest.mark.parametrize('n,seed,shards', [(2500, 5, 4), (1200, 7, 3)])
def test_plan_shards_matches_jax(n, seed, shards):
    c = random_scene(n, seed=seed)
    a = JSP.plan_shards(c, shards, kernel_size=3, bucket=128)
    b = SP.plan_shards(c, shards, kernel_size=3, bucket=128)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize('key_conv', [False, True], ids=['nmap', 'key'])
def test_spatial_unet_batch_matches_jax(rets, key_conv):
    jret, pret = rets
    for k in ('vox_coords', 'vox_features', 'seg2vox', 'input_location'):
        np.testing.assert_array_equal(jret[k], pret[k], err_msg=k)
    jd, jm = JSP.build_spatial_unet_batch(
        jret, n_shards=D, gather_level=G, sem_id2idx=JT.SCANNET_SEMANTIC_ID2IDX,
        key_conv=key_conv, **BATCH_KW)
    pd, pm = SP.build_spatial_unet_batch(
        pret, n_shards=D, gather_level=G, sem_id2idx=PT.SCANNET_SEMANTIC_ID2IDX,
        key_conv=key_conv, **BATCH_KW)
    extra = assert_same_batch(jd, pd)
    assert bool(extra) == key_conv
    assert ('sp_ext_keys0' in pd) == key_conv
    assert sorted(jm) == sorted(pm)
    for k in jm:
        np.testing.assert_array_equal(np.asarray(jm[k]), np.asarray(pm[k]),
                                      err_msg=k)
    # the halos are measured, not the shard width
    assert all(h < p for h, p in zip(pm['halos'], pm['pads']))


def test_past_key_packing_falls_back_to_neighbor_maps():
    """A scene past 1024 voxels on an axis: both packages warn and build
    the neighbor-map halo route, with the same arrays."""
    rng = np.random.default_rng(3)
    # a wall at x = 0 puts the smallest key of every level first, where the
    # JAX package's coarse slabs start (see the test above)
    wall = np.stack(np.meshgrid([0], np.arange(6), np.arange(6),
                                indexing='ij'), -1).reshape(-1, 3)
    c = np.unique(np.concatenate([np.stack([rng.integers(0, 1100, 3000),
                                            rng.integers(0, 6, 3000),
                                            rng.integers(0, 6, 3000)], 1),
                                  wall]), axis=0).astype(np.int32)
    ret = {'vox_coords': c,
           'vox_features': rng.normal(size=(len(c), 3)).astype(np.float32),
           'seg2vox': (np.arange(len(c)) // 7).astype(np.int64),
           'input_location': rng.normal(size=(-(-len(c) // 7), 3))}
    out = []
    for mod in (JSP, SP):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter('always')
            out.append(mod.build_spatial_unet_batch(ret, 2, gather_level=2,
                                                    key_conv=True)[0])
        msgs = [str(x.message) for x in w
                if issubclass(x.category, RuntimeWarning)]
        assert any('1024-voxel/axis key packing' in m for m in msgs), msgs
    assert assert_same_batch(*out) == []
    assert 'sp_ext_keys0' not in out[1]


def test_coarse_rows_below_the_first_floored_key_belong_to_a_shard(rets):
    """Flooring a key to a coarser level does not keep the x-major order:
    a voxel (x0 + 1, 0, z) floors below the first voxel (x0, y >= 4, z')
    at level 1. The JAX package starts the first slab of every coarse
    level at the floored first key, so such rows belong to no slab; the
    port's first slab starts at row 0 (ROADMAP section C)."""
    ret = rets[1]
    c = np.asarray(ret['vox_coords']).astype(np.int32)
    c = c + np.array([c[:, 0].min() % 2, 4, 0], np.int32)
    x0, z0 = int(c[:, 0].min()), int(c[:, 2].min())
    assert x0 % 2 == 0
    feats = np.asarray(ret['vox_features'])
    mini = {'vox_coords': np.concatenate([c, [[x0 + 1, 0, z0]]]),
            'vox_features': np.concatenate([feats, feats[:1]]),
            'seg2vox': np.concatenate([ret['seg2vox'], [0]]),
            'input_location': ret['input_location']}
    for mod, complete in ((SP, True), (JSP, False)):
        dev, _ = mod.build_spatial_unet_batch(mini, D, gather_level=G,
                                              **BATCH_KW)
        # the sharded levels' rows, and the rows the level-G gather fills
        # (a padding slot D * padG_shard gives the zero row)
        covered = [int(np.sum(dev[f'sp_num{l}'])) == int(dev[f'g_num{l}'])
                   for l in range(1, G)]
        n_g, pad_g = int(dev[f'g_num{G}']), dev['sp_downG'].shape[1]
        covered.append(bool((dev['sp_gather_rows'][:n_g] < D * pad_g).all()))
        assert all(covered) == complete, (mod.__name__, covered)


def test_too_many_shards_raises(rets):
    for mod, ret in zip((JSP, SP), rets):
        with pytest.raises(ValueError, match='use fewer shards'):
            mod.build_spatial_unet_batch(ret, 64, gather_level=3)


def test_conv_stack_matches_jax_and_one_process_autograd(tmp_path):
    """tests/test_spatial.py's scene and stack: 4 ranks, 3 f32 3^3 convs
    with relu between: the outputs against JAX's make_spatial_conv_stack
    on 4 devices, and the grads of sum(out * gout) in x and in the
    weights (summed over the ranks) against autograd of the one-process
    chain over the whole scene's map."""
    c = random_scene(2500, seed=5)
    n = len(c)
    plan = SP.plan_shards(c, D, kernel_size=3, bucket=128)
    pad = plan['pad']
    rng = np.random.default_rng(0)
    C, layers = 16, 3
    x = rng.normal(size=(n, C)).astype(np.float32)
    ws = (rng.normal(size=(layers, 27, C, C)) * 0.1).astype(np.float32)
    gfull = rng.normal(size=(n, C)).astype(np.float32)
    per = -(-n // D)
    xs = np.zeros((D, pad, C), np.float32)
    gs = np.zeros((D, pad, C), np.float32)
    for d in range(D):
        lo, hi = d * per, min((d + 1) * per, n)
        xs[d, :hi - lo], gs[d, :hi - lo] = x[lo:hi], gfull[lo:hi]

    mesh = Mesh(np.array(jax.devices()[:D]), (JSP.AXIS,))
    jout = np.asarray(JSP.make_spatial_conv_stack(mesh, layers)(
        jnp.asarray(xs), jnp.asarray(plan['nmap']),
        jnp.asarray(plan['slab_left']), jnp.asarray(plan['slab_right']),
        jnp.asarray(ws)))
    res = run_ranks(conv_stack_worker, D, tmp_path, xs, plan, ws, gs)
    for d, r in enumerate(res):
        nd = int(plan['num'][d])
        np.testing.assert_allclose(r['out'][:nd], jout[d][:nd], rtol=1e-5,
                                   atol=1e-5)
        # one exchange per conv forward and per conv backward
        assert r['halo']['exchanges'] == 2 * layers

    keys = pack(c)
    nmap = np.full((n, 27), n, np.int32)
    for k, off in enumerate(kernel_offsets(3, 1)):
        q = pack(c + off[None, :])
        pos = np.searchsorted(keys, q)
        hit = (pos < n) & (keys[np.minimum(pos, n - 1)] == q)
        nmap[:, k] = np.where(hit, pos, n)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(ws).requires_grad_(True)
    ref = xt
    for i in range(layers):
        ref = ops.gather_conv(ref, torch.from_numpy(nmap), wt[i],
                              torch.float32)
        if i + 1 < layers:
            ref = torch.relu(ref)
    (ref * torch.from_numpy(gfull)).sum().backward()
    dx = np.concatenate([r['dx'][:int(plan['num'][d])]
                         for d, r in enumerate(res)])
    np.testing.assert_allclose(dx, xt.grad.numpy(), rtol=1e-5, atol=1e-5)
    for d, r in enumerate(res):         # padding rows get no gradient
        assert not r['dx'][int(plan['num'][d]):].any()
    dw = sum(r['dw'] for r in res)
    scale = np.abs(wt.grad.numpy()).max()
    np.testing.assert_allclose(dw, wt.grad.numpy(), rtol=0,
                               atol=1e-5 * scale)


def _local_rows(counts):
    """Contiguous shards' [lo, hi) bounds from their row counts."""
    b = np.concatenate([[0], np.cumsum(counts)])
    return list(zip(b[:-1], b[1:]))


def _shard(full, bounds, pad):
    out = np.zeros((len(bounds), pad) + full.shape[1:], full.dtype)
    for d, (lo, hi) in enumerate(bounds):
        out[d, :hi - lo] = full[lo:hi]
    return out


@pytest.fixture(scope='module')
def key_batch(rets):
    pret = rets[1]
    dev, meta = SP.build_spatial_unet_batch(
        pret, n_shards=D, gather_level=G, key_conv=True, **BATCH_KW)
    coords = np.asarray(pret['vox_coords'])[meta['perm']]
    return dev, meta, build_scene_pyramid(coords), host_level_keys(coords)


def test_down_conv_halo_rows_match_one_process_chain(key_batch, tmp_path):
    """The key-route down conv 0 -> 1 on 4 ranks against autograd of the
    one-process key conv over the whole scene: outputs, dx (an extended
    fine row whose parent is another shard's gets 0 there, and its
    cotangent comes back through the halo exchange's backward) and dw."""
    dev, meta, pyr, keys = key_batch
    b0 = _local_rows(dev['sp_num0'])
    b1 = _local_rows(dev['sp_num1'])
    # some extended halo rows of a rank have their parent on that rank:
    # their dx must travel back to the rank that sent them
    cross = 0
    for d in range(D):
        ek, lo = dev['sp_ext_keys0'][d], int(dev['sp_ext_lo0'][d, 0])
        halo = np.r_[ek[:lo], ek[lo + b0[d][1] - b0[d][0]:]]
        halo = halo[halo < SENT_KEY]
        parents = halo & ~np.int32((1 << 20) | (1 << 10) | 1)
        cross += np.isin(parents, dev['sp_kcd_okeys0'][d]).sum()
    assert cross > 0
    rng = np.random.default_rng(1)
    C, Co = 32, 16
    x = rng.normal(size=(len(keys[0]), C)).astype(np.float32)
    gy = rng.normal(size=(len(keys[1]), Co)).astype(np.float32)
    w = (rng.normal(size=(8, C, Co)) * 0.2).astype(np.float32)
    res = run_ranks(piece_worker, D, tmp_path, 'down', dev,
                    _shard(x, b0, meta['pads'][0]),
                    _shard(gy, b1, meta['pads'][1]), w)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = KC.key_conv_down_train(xt, torch.from_numpy(keys[0])[None],
                               torch.from_numpy(keys[1]), wt)
    (y * torch.from_numpy(gy)).sum().backward()
    for d, r in enumerate(res):
        (lo, hi), (lo1, hi1) = b0[d], b1[d]
        np.testing.assert_allclose(r['y'][:hi1 - lo1], y.detach()[lo1:hi1],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r['dx'][:hi - lo], xt.grad[lo:hi],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r['dw'] for r in res), wt.grad,
                               rtol=1e-5, atol=1e-4)


def test_gather_level_backward_sums_cross_shard_cotangents(key_batch,
                                                           tmp_path):
    """The level-G gather, then the up conv G -> G-1 on the replicated
    rows, on 4 ranks against autograd of the one-process up conv: its
    backward must sum the cotangents the other ranks' fine rows send to
    this rank's coarse rows (an all_gather's transpose would keep only the
    rank's own); such cross-shard parents exist here."""
    dev, meta, pyr, keys = key_batch
    bG = list(zip(meta['boundsG'][:-1], meta['boundsG'][1:]))
    bF = _local_rows(dev[f'sp_num{G - 1}'])
    cross = 0
    for d, (lo, hi) in enumerate(bF):
        par = pyr[f'up_parent{G - 1}'][lo:hi]
        cross += ((par < bG[d][0]) | (par >= bG[d][1])).sum()
    assert cross > 0
    rng = np.random.default_rng(2)
    C, Co = 24, 16
    x = rng.normal(size=(len(keys[G]), C)).astype(np.float32)
    gy = rng.normal(size=(len(keys[G - 1]), Co)).astype(np.float32)
    w = (rng.normal(size=(8, C, Co)) * 0.2).astype(np.float32)
    res = run_ranks(piece_worker, D, tmp_path, 'gather', dev,
                    _shard(x, bG, meta['padG_shard']),
                    _shard(gy, bF, meta['pads'][G - 1]), w)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = ops.up_conv(xt, (torch.from_numpy(pyr[f'up_parent{G - 1}']),
                         torch.from_numpy(pyr[f'up_widx{G - 1}'])), wt,
                    torch.float32)
    (y * torch.from_numpy(gy)).sum().backward()
    for d, r in enumerate(res):
        (lo, hi), (lo1, hi1) = bG[d], bF[d]
        np.testing.assert_allclose(r['y'][:hi1 - lo1], y.detach()[lo1:hi1],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r['dx'][:hi - lo], xt.grad[lo:hi],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r['dw'] for r in res), wt.grad,
                               rtol=1e-5, atol=1e-4)


def test_max_pool_pmax_has_no_gradient_in_either_package(tmp_path):
    """--max_pool_segments_detection_net under --spatial_shards: the pool's
    forward is the maximum over the ranks' segment maxima, and neither
    package differentiates the pmax (ROADMAP section C)."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 40, 8)).astype(np.float32)
    pool = rng.integers(0, 7, size=(2, 40)).astype(np.int32)
    mesh = Mesh(np.array(jax.devices()[:2]), (JSP.AXIS,))

    @functools.partial(shard_map, mesh=mesh, in_specs=(P(JSP.AXIS),
                                                           P(JSP.AXIS)),
                       out_specs=P(), check_vma=False)
    def jgrad(x, pool):
        from box2mask_tpu.sparse import ops as JO
        return jax.grad(lambda v: jax.lax.pmax(
            JO.segment_max(v[0], pool[0], 6), JSP.AXIS).sum())(x)

    with pytest.raises(NotImplementedError, match="'pmax'"):
        jax.jit(jgrad)(jnp.asarray(x), jnp.asarray(pool))
    res = run_ranks(max_pool_worker, 2, tmp_path, x, pool, 6)
    want = np.maximum(*(ops.segment_max(torch.from_numpy(x[d]),
                                        torch.from_numpy(pool[d]), 6).numpy()
                        for d in range(2)))
    for r in res:
        np.testing.assert_array_equal(r['pooled'], want)
        assert "'pmax'" in r['err']
