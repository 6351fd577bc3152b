"""Shared setup of tests/test_torch_spatial_*.py: the scene and configs of
the JAX package's tests/test_spatial_unet.py, and the gloo-rank workers of
the spatial tests (spawned through test_torch_parallel_common.run_ranks;
they import torch and the port only, never JAX).

Sizes (tests/test_spatial_unet.py): synthetic seed 11, --layers 1, 5 cm
voxels, vox_bucket 512, f32; D = 4 and G = 2 for the host plans and the
forward, D = 2 where ranks train.
"""

import numpy as np
import torch

from box2mask_torch.engine import state as S
from box2mask_torch.nn.losses import compute_losses
from box2mask_torch.parallel import mesh as M
from box2mask_torch.parallel import spatial as SP
from box2mask_torch.sparse import ops
from test_torch_parallel_common import patch_unrounded

D, G = 4, 2
ARGS = ['--dataset_name', 'synthetic',
        '--network_heads', 'mlp_offsets', 'mlp_bounds', 'mlp_bb_scores',
        'mlp_semantics',
        '--do_segment_pooling', '--bb_supervision', '--smallest_bb_heuristic',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1',
        '--voxel_size', '0.05', '--vox_bucket', '512', '--seg_bucket', '64',
        '--layers', '1', '--compute_dtype', 'float32',
        '--spatial_gather_level', str(G), '--exp_name', 'test_spatial_unet']
SCENE = dict(seed=11, num_instances=6, points_per_instance=400,
             floor_points=2000, wall_points=1500)
# build_spatial_unet_batch's arguments in tests/test_spatial_unet.py
BATCH_KW = dict(bucket=32, halo_bucket=64, seg_bucket=64)


def make_ret(cfg, make_scene, voxelize, build_supervision):
    """The supervised scene of tests/test_spatial_unet.py, through one
    package's functions."""
    scene, labels = make_scene(**SCENE)
    ret = voxelize(scene, cfg)
    ret['labels'] = labels
    build_supervision(ret, labels, scene, cfg, 'scannet')
    return ret


def random_scene(n, hi=40, seed=0):
    """tests/test_spatial.py's random unique voxel coords."""
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, hi, size=(n, 3)),
                     axis=0).astype(np.int32)


def numpy_tree(t):
    if isinstance(t, dict):
        return {k: numpy_tree(v) for k, v in t.items()}
    return t.detach().cpu().numpy().copy()


def spatial_model(cfg, group, state_dict, train=False):
    n_classes = state_dict['mlp_semantics.Linear1x1_2.kernel'].shape[1]
    model = SP.build_spatial_model(cfg, n_classes, 'cpu', group=group)
    model.load_state_dict(state_dict)
    model.train(train)
    return model


# ------------------------------------------------------------------ workers
def conv_stack_worker(rank, world, group, x, plan, ws, gout):
    """make_spatial_conv_stack on rank `rank`'s shard; the output, and the
    grads of sum(out * gout) in x (this rank's rows) and in ws (this
    rank's share; the sum over the ranks is the whole)."""
    xr = torch.from_numpy(x[rank]).requires_grad_(True)
    wt = torch.from_numpy(ws).requires_grad_(True)
    stack = SP.make_spatial_conv_stack(len(ws), group)
    out = stack(xr, *(torch.from_numpy(plan[k][rank])
                      for k in ('nmap', 'slab_left', 'slab_right')), wt)
    (out * torch.from_numpy(gout[rank])).sum().backward()
    return {'out': numpy_tree(out), 'dx': numpy_tree(xr.grad),
            'dw': numpy_tree(wt.grad), 'halo': dict(SP.HALO)}


def forward_worker(rank, world, group, cfg, dev, state_dict, unrounded):
    """The eval-mode spatial forward of rank `rank`, and the launch and
    plain-call counts of its convs."""
    if unrounded:
        patch_unrounded(setattr)
    model = spatial_model(cfg, group, state_dict)
    ops.reset_counts()
    out = SP.make_spatial_apply(model)(SP.local_batch(dev, rank,
                                                      torch.device('cpu')))
    from box2mask_torch.sparse import key_conv as KC
    return {'out': numpy_tree(out), 'xla': dict(ops.XLA_CALLS),
            'plain': dict(KC.PLAIN_CALLS)}


def grads_worker(rank, world, group, cfg, dev, state_dict, bb_w, cs_w,
                 unrounded):
    """One spatial train step's loss dict and its averaged grads (before
    the update), and the parameters after it."""
    if unrounded:
        patch_unrounded(setattr)
    model = spatial_model(cfg, group, state_dict)
    tx = S.make_optimizer(cfg)
    state = S.TrainState(model, tx, tx.init(list(model.parameters())))
    names = [n for n, _ in model.named_parameters()]
    grads, apply_update = {}, S.apply_update

    def record(st, lr):
        grads.update({n: p.grad.numpy().copy()
                      for n, p in zip(names, st.params)})
        return apply_update(st, lr)
    S.apply_update = record
    try:
        step = SP.make_spatial_train_step(cfg, group)
        _, ld = step(state, SP.local_batch(dev, rank, torch.device('cpu')),
                     1e-3, bb_w, cs_w)
    finally:
        S.apply_update = apply_update
    M.check_replicas(state, group)
    return {'loss': {k: float(v) for k, v in ld.items()}, 'grads': grads}


def piece_worker(rank, world, group, which, batch, x, gy, w):
    """One piece of the spatial net alone, on rank `rank`: which='down',
    the key-route down conv 0 -> 1 (extended fine rows -> local coarse
    rows); which='gather', the level-G gather and then the up conv
    G -> G-1 over the replicated rows. Its local output rows y, and the
    grads of sum(y * gy) in x (this rank's rows) and in w (this rank's
    share)."""
    b = SP.local_batch(batch, rank, torch.device('cpu'))
    xr = torch.from_numpy(x[rank]).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    if which == 'down':
        y = ops.gather_conv(xr, SP.key_operand(b, 0, 'd', group), wt)
    else:
        xg = SP.gather_to_replicated(xr, b['sp_gather_rows'], group)
        y = ops.up_conv(xg, (b['sp_up_parentG'], b['sp_up_widxG']), wt,
                        torch.float32)
    (y * torch.from_numpy(gy[rank])).sum().backward()
    return {'y': numpy_tree(y), 'dx': numpy_tree(xr.grad),
            'dw': numpy_tree(wt.grad)}


def max_pool_worker(rank, world, group, x, pool, s_pad):
    """The pmax of the segment max pool and what its backward does."""
    xr = torch.from_numpy(x[rank]).requires_grad_(True)
    pooled = SP.all_reduce_max(ops.segment_max(xr, torch.from_numpy(
        pool[rank]), s_pad), group)
    try:
        pooled.sum().backward()
        err = None
    except NotImplementedError as e:
        err = str(e)
    return {'pooled': numpy_tree(pooled), 'err': err}


def losses_worker(rank, world, group, cfg, dev, state_dict, bb_w, cs_w,
                  unrounded):
    """make_spatial_val_step's loss dict of rank `rank`."""
    if unrounded:
        patch_unrounded(setattr)
    model = spatial_model(cfg, group, state_dict)
    tx = S.make_optimizer(cfg)
    state = S.TrainState(model, tx, tx.init(list(model.parameters())))
    ld = SP.make_spatial_val_step(cfg, group)(
        state, SP.local_batch(dev, rank, torch.device('cpu')), bb_w, cs_w)
    return {k: float(v) for k, v in ld.items()}


def one_device_losses(cfg, batch, state_dict, bb_w, cs_w):
    """The one-device SelectionNet's eval-mode loss dict on `batch`."""
    model = S.build_model(cfg, 20, 'cpu')
    model.load_state_dict(state_dict)
    model.eval()
    with torch.no_grad():
        full = S.ensure_maps(batch)
        return {k: float(v) for k, v in compute_losses(
            cfg, model(full), full, bb_w, cs_w).items()}


def seeds_worker(rank, world, group, argv):
    """parallel/mesh.agree_seeds and spatial.check_same_scene on rank
    `rank`: the seeds it takes under --sample_fixed_seed and without a
    seed, whether the first spatial batch of the augmenting `argv` passes
    the check, and whether batches drawn under per-rank seeds fail it."""
    from box2mask_torch.config import get_config
    from box2mask_torch.datasets.loader import get_dataset

    def first(cfg):
        loader = get_dataset(cfg, 'train').get_loader(shuffle=False)
        try:
            return next(iter(loader))
        finally:
            loader.close()

    cpu = torch.device('cpu')
    sampled = M.agree_seeds(get_config(argv + ['--sample_fixed_seed']),
                            group, cpu)
    cfg = M.agree_seeds(get_config(argv), group, cpu)
    dev, host = first(cfg)
    SP.check_same_scene(dev, group, cpu)
    own = get_config(argv)
    own.augment_seed = 1 + rank             # what each rank drew apart
    dev_own, host_own = first(own)
    try:
        SP.check_same_scene(dev_own, group, cpu)
        refused = False
    except RuntimeError:
        refused = True
    return {'fixed': sampled.fixed_seed, 'augment': sampled.augment_seed,
            'seed': cfg.fixed_seed, 'augment_seed': cfg.augment_seed,
            'voxels': host['num_voxels'][0],
            'voxels_own': host_own['num_voxels'][0], 'refused': refused}
