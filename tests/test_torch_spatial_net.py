"""SpatialSelectionNet of the port (box2mask_torch/parallel/spatial.py) on
gloo ranks, against the JAX package and the port's one-device net, at the
sizes of tests/test_spatial_unet.py (synthetic seed 11, --layers 1, 5 cm
voxels, f32; D = 4, G = 2 for the forward, D = 2 for the grads).

  * Forward, neighbor-map route: equal to JAX make_spatial_apply on 4
    devices within 2e-4 (rtol and atol), JAX's own bound between its
    spatial and one-device forwards.
  * Forward, key route: on the plain twins with unrounded operands, equal
    to the port's one-device key-route forward (which the port's other
    tests hold to the JAX package) within the same bound; the JAX
    package's key-route spatial test runs its Pallas kernels in interpret
    mode and is slow-only.
  * Forward on an ARKitScenes fixture (a rotated room: its first voxel
    floors above the smallest coarse key, the JAX package's fault of
    ROADMAP section C), key route, unrounded twins: equal to the port's
    one-device forward within the same bound.
  * One spatial train step's grads after average_grads, with the
    distributional protocol of tests/test_spatial_unet.py
    test_spatial_grads_match_single_device: on the neighbor-map route
    against jax.grad of the JAX one-device net on the same loss, on the
    key route against the port's one-device key-route grads (unrounded
    twins); the loss dict equal on the ranks, the parameters bit-equal
    across them after the update; the val step's losses equal to the
    one-device eval losses.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import supervision as JSup
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import tables as JT
from box2mask_tpu.datasets import voxelize as JV
from box2mask_tpu.engine import state as JS
from box2mask_tpu.nn import losses as JL
from box2mask_tpu.nn.unet import SelectionNet as JSelectionNet
from box2mask_tpu.parallel import spatial as JSP
from box2mask_torch import config as PC
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import fixtures
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.datasets import supervision as PSup
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.convert import kaiming_init_
from box2mask_torch.engine import state as S
from box2mask_torch.nn.losses import compute_losses
from box2mask_torch.parallel import spatial as SP
from test_torch_parallel_common import patch_unrounded, run_ranks, to_torch
from test_torch_spatial_common import (ARGS, BATCH_KW, D, G, forward_worker,
                                       grads_worker, losses_worker, make_ret,
                                       one_device_losses)
from test_torch_train_common import flat
from test_torch_train_common import remove_tmp_path  # noqa: F401

BB_W, CS_W = 1.0, 0.0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def setup():
    """Both packages' scene, the JAX one-device net's seed-0 variables and
    the port's state_dict of them."""
    jc, pc = JC.get_config(ARGS), PC.get_config(ARGS)
    jc.use_native_host_ops = pc.use_native_host_ops = False
    jret = make_ret(jc, JSyn.make_scene, JV.voxelize_scene,
                    JSup.build_supervision)
    pret = make_ret(pc, PSyn.make_scene, PV.voxelize_scene,
                    PSup.build_supervision)
    dev_std, _ = JB.build_batch([jret], jc, JT.SCANNET_SEMANTIC_ID2IDX,
                                mode='val', device_maps=False)
    batch_std = {k: jnp.asarray(v) for k, v in dev_std.items()}
    model = JSelectionNet(num_classes=20, heads=tuple(jc.network_heads),
                          layers=1, compute_dtype=jnp.float32)
    variables = JS.init_variables(model, batch_std)
    sd = from_flax(jax.tree.map(np.asarray, variables['params']),
                   jax.tree.map(np.asarray, variables['batch_stats']))
    return jc, pc, jret, pret, dev_std, model, variables, sd


def spatial_batch(ret, shards, key_conv):
    return SP.build_spatial_unet_batch(
        ret, n_shards=shards, gather_level=G,
        sem_id2idx=PT.SCANNET_SEMANTIC_ID2IDX, key_conv=key_conv,
        **BATCH_KW)[0]


def one_device_key_batch(pc, pret):
    dev, _ = PB.build_batch([pret], pc, PT.SCANNET_SEMANTIC_ID2IDX,
                            mode='val')
    assert 'keys0_b' in dev and PB.DEVICE_NMAPS not in dev
    return to_torch(dev)


def assert_heads_close(cfg, got, want, n_seg):
    for h in cfg.network_heads:
        np.testing.assert_allclose(np.asarray(got[h])[:n_seg],
                                   np.asarray(want[h])[:n_seg],
                                   rtol=2e-4, atol=2e-4, err_msg=h)


def test_forward_neighbor_maps_matches_jax(setup, tmp_path):
    jc, pc, jret, pret, dev_std, model, variables, sd = setup
    jdev, _ = JSP.build_spatial_unet_batch(
        jret, n_shards=D, gather_level=G,
        sem_id2idx=JT.SCANNET_SEMANTIC_ID2IDX, **BATCH_KW)
    mesh = Mesh(np.array(jax.devices()[:D]), (JSP.AXIS,))
    model_sp = JSP.SpatialSelectionNet(
        num_classes=20, heads=tuple(jc.network_heads), layers=1,
        gather_level=G, compute_dtype=jnp.float32)
    want = JSP.make_spatial_apply(mesh, model_sp, jdev, train=False)(
        variables, {k: jnp.asarray(v) for k, v in jdev.items()})
    res = run_ranks(forward_worker, D, tmp_path, pc,
                    spatial_batch(pret, D, False), sd, False)
    n_seg = int(dev_std['num_segments'])
    for r in res:
        assert_heads_close(pc, r['out'], want, n_seg)
        assert r['xla']['gather_conv'] > 0 and not any(r['plain'].values())


def test_forward_key_route_matches_one_device(setup, tmp_path, monkeypatch):
    jc, pc, jret, pret, dev_std, model, variables, sd = setup
    patch_unrounded(monkeypatch.setattr)
    net = S.build_model(pc, 20, 'cpu')
    net.load_state_dict(sd)
    want = S.forward(net, one_device_key_batch(pc, pret))
    res = run_ranks(forward_worker, D, tmp_path, pc,
                    spatial_batch(pret, D, True), sd, True)
    n_seg = int(dev_std['num_segments'])
    for r in res:
        assert_heads_close(pc, r['out'], {k: v.numpy()
                                          for k, v in want.items()}, n_seg)


def test_forward_arkitscenes_fixture_matches_one_device(tmp_path,
                                                       monkeypatch):
    """The ARKitScenes preset (--layers 1, f32) on a 8 x 6 m fixture room
    of ~51k voxels, 2 ranks at gather level 3: the coarse rows below the
    first floored key are computed (the JAX package drops them)."""
    root = str(tmp_path / 'ark')
    fixtures.write_arkitscenes(root, ['42100000'], 'Validation',
                               n_vertices=120_000, size=(8.0, 6.0, 2.6),
                               n_objects=8, seed=31)
    args = ['--config', os.path.join(ROOT, 'configs', 'arkitscenes.txt'),
            '--data_dir', root, '--fixed_seed', '10', '--layers', '1',
            '--compute_dtype', 'float32']
    one = PC.get_config(args)
    sharded = PC.get_config(args + ['--spatial_shards', '2'])
    net = S.build_model(one, 17, 'cpu')
    kaiming_init_(net, torch.Generator().manual_seed(1))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    batches = [next(iter(PLd.get_dataset(c, 'val').get_loader(
        shuffle=False, batch_size=1)))[0] for c in (one, sharded)]
    assert sharded.spatial_gather_level == 3
    patch_unrounded(monkeypatch.setattr)
    want = S.forward(net, to_torch(batches[0]))
    res = run_ranks(forward_worker, 2, tmp_path / 'ranks', sharded,
                    batches[1], sd, True)
    n_seg = int(batches[0]['num_segments'])
    for r in res:
        assert_heads_close(one, r['out'], {k: v.numpy()
                                           for k, v in want.items()}, n_seg)


def assert_grads_match(ref, got):
    """tests/test_spatial_unet.py's protocol: float32 reassociation flips
    borderline ReLU masks on a few elements, a structural error (a missing
    or wrong collective transpose) mismatches a whole tensor by about a
    factor D. Per tensor almost all elements within 3e-2 of its max, none
    past 0.5."""
    checked = 0
    for name, rg in ref.items():
        gg = got[name]
        scale = max(1e-3, float(np.abs(rg).max()))
        diff = np.abs(gg - rg) / scale
        n_loose = int((diff > 3e-2).sum())
        assert n_loose <= max(2, int(5e-4 * diff.size)), (name, n_loose)
        assert float(diff.max()) < 0.5, (name, float(diff.max()))
        checked += 1
    assert checked > 50


def assert_ranks_agree(res):
    assert all(r['loss'] == res[0]['loss'] for r in res)
    for k in res[0]['grads']:
        for r in res[1:]:
            np.testing.assert_array_equal(r['grads'][k],
                                          res[0]['grads'][k])


def test_grads_neighbor_maps_match_jax_one_device(setup, tmp_path):
    jc, pc, jret, pret, dev_std, model, variables, sd = setup
    batch_std = {k: jnp.asarray(v) for k, v in dev_std.items()}

    def loss(params):
        out, _ = model.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            batch_std, train=True, mutable=['batch_stats'])
        return JL.compute_losses(jc, out, batch_std, jnp.float32(BB_W),
                                 jnp.float32(CS_W))
    ref = flat(jax.jit(jax.grad(lambda p: loss(p)['optimization_loss']))(
        variables['params']))
    want_loss = float(jax.jit(loss)(variables['params'])['optimization_loss'])
    res = run_ranks(grads_worker, 2, tmp_path, pc,
                    spatial_batch(pret, 2, False), sd, BB_W, CS_W, False)
    assert_ranks_agree(res)
    np.testing.assert_allclose(res[0]['loss']['optimization_loss'],
                               want_loss, rtol=1e-4)
    assert sorted(ref) == sorted(res[0]['grads'])
    assert_grads_match(ref, res[0]['grads'])


def test_grads_key_route_match_one_device(setup, tmp_path, monkeypatch):
    jc, pc, jret, pret, dev_std, model, variables, sd = setup
    patch_unrounded(monkeypatch.setattr)
    net = S.build_model(pc, 20, 'cpu')
    net.load_state_dict(sd)
    net.train()
    batch = S.ensure_maps(one_device_key_batch(pc, pret))
    ld = compute_losses(pc, net(batch), batch, BB_W, CS_W)
    ld['optimization_loss'].backward()
    ref = {n: p.grad.numpy() for n, p in net.named_parameters()}
    dev = spatial_batch(pret, 2, True)
    res = run_ranks(grads_worker, 2, tmp_path, pc, dev, sd, BB_W, CS_W,
                    True)
    assert_ranks_agree(res)
    np.testing.assert_allclose(res[0]['loss']['optimization_loss'],
                               float(ld['optimization_loss']), rtol=1e-4)
    assert_grads_match(ref, res[0]['grads'])
    # the val step: eval-mode losses, the same on every rank and as one
    # device's
    val = run_ranks(losses_worker, 2, tmp_path / 'val', pc, dev, sd, BB_W,
                    CS_W, True)
    want = one_device_losses(pc, one_device_key_batch(pc, pret), sd, BB_W,
                             CS_W)
    assert val[0] == val[1]
    for k, v in want.items():
        np.testing.assert_allclose(val[0][k], v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
