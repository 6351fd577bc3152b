"""Data-parallel training of the port (box2mask_torch/parallel/mesh.py, the
sharded loader, the multi-process Trainer and train CLI) against the JAX
package's data-parallel step, on the CPU: gloo ranks in spawned processes
(tests/test_torch_parallel_common.py), JAX on the 8 virtual CPU devices
that tests/conftest.py forces.

  * The BN all-reduce: ops.masked_moments on 2 ranks with unequal valid
    rows, mean / var / n and each rank's x-grad of its own loss, against
    the JAX package's ops.masked_moments(..., axis_name) under shard_map
    on 2 devices and its jax.grad: within 1e-6 relative. A plain
    all-reduce outside autograd would leave each rank only its own
    loss's grad: that is held outside the bound.
  * World size 1: the data-parallel step is bit-equal to S.train_step
    (loss dict, every grad, parameters and BN statistics after it).
  * Two ranks against the JAX data-parallel step, unrounded
    (--compute_dtype float32, f32 activations, the plain twins on f32
    operands on the port's side) from the same weights (convert.from_flax),
    on two shards of unequal voxel and segment counts. The JAX side is
    `jax.vmap` over the 'data' axis of the loss and grad of
    engine/state.make_train_step(axis_name='data') (value_and_grad, then
    grads and loss dict pmean'd: state.py:140-148) on its neighbor-map
    route: the same psum / pmean semantics as shard_map, whose compile is
    too slow for tier-1 (tests/test_parallel.py skips it there). Bounds:
    loss dict and BN statistics 1e-5 relative, grads L2 <= 1e-2
    (tests/test_torch_train_step.py's bounds), parameters bit-equal across
    the ranks. Negative control: one process on the two shards' scenes in
    one batch (whose losses normalise over the whole batch) gives grads
    outside that L2 bound. make_parallel_val_step gives each rank the
    mean of the ranks' eval-mode losses, bit for bit.
  * The loader: for 2 epochs the scenes of `shard=r` equal the JAX
    BatchLoader(num_shards=2)'s shard r, lengths equal; the num_shards=2
    list bit-equal to the JAX loader's (common pads); a shard=r batch
    bit-equal to JAX build_batch of the same scenes.
  * The train CLI with --multigpu --data_axis_size 2 on gloo ranks
    (BOX2MASK_PLATFORM=cpu, 4 scenes, batch 1 per rank, --layers 1): one
    checkpoint from rank 0, the val loss
    logged once, a resume at its epoch, the ranks' parameters equal at the
    end; more ranks than cards, without the CPU asked for, raise.
  * The config flags (--singlegpu, --data_axis_size, --multigpu with
    --spatial_shards, the auto-remat rule skipped under --multigpu) as the
    JAX package's get_config; the Trainer's remat rule on one rank's rows,
    and the JAX Trainer's division of one device's rows by the device
    count (ROADMAP section C), shown with needs_remat recorded.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from box2mask_tpu import config as JC
from box2mask_tpu.datasets import batching as JB
from box2mask_tpu.datasets import loader as JLd
from box2mask_tpu.engine import state as JS
from box2mask_tpu.nn import losses as JL
from box2mask_tpu.parallel import mesh as JM
from box2mask_tpu.sparse import ops as JO
from box2mask_torch import config as PC
from box2mask_torch import train as train_cli
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.parallel import mesh as M
from test_torch_parallel_common import (dp_step_worker, moments_worker,
                                        run_ranks, to_torch)
from test_torch_train_common import (ARGS, _unflat, flat, l2_rel,
                                     LOSS_KEYS, rel_err)
from test_torch_train_common import remove_tmp_path  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ BN all-reduce
def moments_inputs():
    rng = np.random.default_rng(0)
    rows, c = 40, 6
    n_valid = np.array([31, 12], np.int32)           # unequal shards
    valid = np.arange(rows)[None, :] < n_valid[:, None]
    x = (rng.standard_normal((2, rows, c)) * 3 + 1).astype(np.float32)
    a = rng.standard_normal((2, c)).astype(np.float32)
    b = rng.standard_normal((2, c)).astype(np.float32)
    return x, valid, n_valid, a, b


def jax_moments(x, valid, n_valid, a, b):
    """JAX masked_moments(axis_name) under shard_map on 2 devices and the
    x-grad of each device's loss (shard_map transposes psum to psum)."""
    mesh = Mesh(np.array(jax.devices()[:2]), (JM.AXIS,))

    def per_device(x, valid, n_valid, a, b):
        x, valid, n_valid, a, b = (v[0] for v in (x, valid, n_valid, a, b))

        def loss(x):
            mean, var, n = JO.masked_moments(x, valid, n_valid, JM.AXIS)
            return (a * mean + b * var).sum(), (mean, var, n)
        dx, (mean, var, n) = jax.grad(loss, has_aux=True)(x)
        return mean[None], var[None], n[None], dx[None]

    fn = jax.jit(jax.shard_map(per_device, mesh=mesh,
                               in_specs=(P(JM.AXIS),) * 5,
                               out_specs=(P(JM.AXIS),) * 4, check_vma=False))
    return [np.asarray(v) for v in fn(x, valid, n_valid, a, b)]


def test_bn_all_reduce_matches_jax_shard_map(tmp_path):
    """Tolerance: 1e-6 of max |JAX| per output (f32 sums in another
    order). The negative control (each rank's loss alone, as a
    torch.no_grad all-reduce would give) is held outside it."""
    inputs = moments_inputs()
    mean, var, n, dx = jax_moments(*inputs)
    got = run_ranks(moments_worker, 2, tmp_path, *inputs)
    for r in range(2):
        for k, want in (('mean', mean[r]), ('var', var[r]), ('dx', dx[r])):
            err = np.abs(got[r][k] - want).max() / np.abs(want).max()
            assert err <= 1e-6, (r, k, err)
        assert got[r]['n'] == float(n[r]) == 43.0
    assert np.array_equal(got[0]['mean'], got[1]['mean'])
    # the grad without the other rank's cotangent: far outside the bound
    x, valid, n_valid, a, b = inputs
    xs = torch.from_numpy(np.concatenate([x[0][valid[0]], x[1][valid[1]]]))
    x0 = torch.from_numpy(x[0]).requires_grad_(True)
    m = torch.from_numpy(valid[0]).float()[:, None]
    s1 = (x0 * m).sum(0) + (xs[n_valid[0]:]).sum(0)
    s2 = (x0.square() * m).sum(0) + (xs[n_valid[0]:].square()).sum(0)
    mu = s1 / 43.0
    ((torch.from_numpy(a[0]) * mu + torch.from_numpy(b[0])
      * (s2 / 43.0 - mu.square())).sum()).backward()
    own = x0.grad.numpy()
    assert np.abs(own - dx[0]).max() / np.abs(dx[0]).max() > 1e-2


# ------------------------------------------------------------ the train step
UNROUNDED = ['--compute_dtype', 'float32']
# two shards of one scene each, of unequal voxel and segment counts
SHARD_SCENES = (dict(seed=3, num_instances=5, points_per_instance=250,
                     floor_points=900, wall_points=700),
                dict(seed=8, num_instances=3, points_per_instance=150,
                     floor_points=500, wall_points=300))


def shard_rets(pkg, cfg):
    """The two shards' labelled scenes, from `pkg` ('jax' or 'torch')."""
    if pkg == 'jax':
        from box2mask_tpu.datasets import (supervision as Sup,
                                           synthetic as Syn,
                                           voxelize as V)
    else:
        from box2mask_torch.datasets import (supervision as Sup,
                                             synthetic as Syn,
                                             voxelize as V)
    cfg.use_native_host_ops = False
    rets = []
    for kw in SHARD_SCENES:
        scene, labels = Syn.make_scene(**kw)
        ret = V.voxelize_scene(scene, cfg)
        ret['labels'] = labels
        Sup.build_supervision(ret, labels, scene, cfg, 'scannet')
        rets.append(ret)
    return rets


@pytest.fixture(scope='module')
def jax_dp():
    """The JAX data-parallel step on 2 shards from its seed-0 init: (init
    params, init stats, loss dict, grads, BN stats after the step)."""
    from box2mask_tpu.datasets import tables as JT
    from box2mask_tpu.sparse.device_maps import level_pads_for_scenes
    jc = JC.get_config(ARGS + UNROUNDED)
    rets = shard_rets('jax', jc)
    pads = level_pads_for_scenes([r['vox_coords'] for r in rets],
                                 vox_bucket=jc.vox_bucket)
    seg_pad = max(max(-(-len(r['input_location']) // jc.seg_bucket)
                      * jc.seg_bucket for r in rets), jc.seg_bucket)
    shards = [JB.build_batch([r], jc, JT.SCANNET_SEMANTIC_ID2IDX,
                             mode='train', device_maps=True, level_pads=pads,
                             seg_pad=seg_pad)[0] for r in rets]
    stacked = {k: jnp.asarray(v)
               for k, v in JB.collate_device_batches(shards).items()}
    v = JS.init_variables(JS.build_model(jc, 20),
                          {k: x[0] for k, x in stacked.items()})
    model = JS.build_model(jc, 20, axis_name=JM.AXIS)

    def per_device(params, stats, batch):
        # engine/state.make_train_step's loss and grads with axis_name
        # (state.py:135-148), before the optimizer
        def loss_fn(p):
            full = JS.ensure_maps(batch)
            out, mut = model.apply({'params': p, 'batch_stats': stats}, full,
                                   train=True, mutable=['batch_stats'])
            ld = JL.compute_losses(jc, out, full, jnp.float32(1.0),
                                   jnp.float32(0.0))
            return ld['optimization_loss'], (ld, mut['batch_stats'])
        (_, (ld, new_stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return (jax.lax.pmean(grads, JM.AXIS), jax.lax.pmean(ld, JM.AXIS),
                new_stats)

    step = jax.jit(jax.vmap(per_device, in_axes=(None, None, 0),
                            axis_name=JM.AXIS))
    grads, ld, stats = step(v['params'], v['batch_stats'], stacked)
    pick = jax.tree.map(lambda a: np.asarray(a)[0], (grads, ld, stats))
    return (flat(v['params']), flat(v['batch_stats']),
            {k: float(x) for k, x in pick[1].items()}, flat(pick[0]),
            flat(pick[2]))


def port_shards(extra):
    from box2mask_torch.datasets import batching as PB
    from box2mask_torch.datasets import tables as PT
    pc = PC.get_config(ARGS + extra)
    rets = shard_rets('torch', pc)
    shards = [PB.build_batch([r], pc, PT.SCANNET_SEMANTIC_ID2IDX)[0]
              for r in rets]
    whole = PB.build_batch(rets, pc, PT.SCANNET_SEMANTIC_ID2IDX)[0]
    return pc, shards, whole


def test_world_size_one_step_is_bit_equal(tmp_path, monkeypatch):
    """The data-parallel step on a group of one rank against S.train_step
    from the same weights on the same batch: loss dict, every grad, the
    parameters and the BN statistics after the update, bit for bit (the
    collectives are identities)."""
    pc, shards, _ = port_shards([])
    batch = to_torch(shards[0])
    group = M.init_data_parallel(0, 1, 'gloo',
                                 'file://' + str(tmp_path / 'rendezvous'),
                                 'cpu', timeout=60)
    try:
        runs = []
        for g in (None, group):
            model = S.build_model(pc, 20, 'cpu', group=g)
            state = S.init_state(pc, model, S.make_optimizer(pc), seed=5)
            grads, apply_update = [], S.apply_update

            def record(state, lr):
                grads.append([p.grad.clone() for p in state.params])
                return apply_update(state, lr)
            monkeypatch.setattr(S, 'apply_update', record)
            step = (S.make_train_step(pc) if g is None
                    else M.make_parallel_train_step(pc, g))
            _, ld = step(state, batch, 1e-3, 1.0, 0.0)
            monkeypatch.setattr(S, 'apply_update', apply_update)
            runs.append((ld, grads[0], model.state_dict()))
    finally:
        M.teardown()
    (l1, g1, s1), (l2, g2, s2) = runs
    assert set(l1) == set(l2)
    assert all(torch.equal(l1[k], l2[k]) for k in l1)
    assert len(g1) == len(g2) and all(torch.equal(a, b)
                                      for a, b in zip(g1, g2))
    assert set(s1) == set(s2) and all(torch.equal(s1[k], s2[k]) for k in s1)


def test_two_ranks_match_the_jax_data_parallel_step(jax_dp, tmp_path):
    """Two gloo ranks, unrounded, against the JAX data-parallel step from
    the same weights (bounds in the module docstring); one process on the
    concatenated batch lies outside the grads' bound."""
    p0, s0, jl, jg, js = jax_dp
    pc, shards, whole = port_shards(UNROUNDED)
    sd = from_flax(_unflat(p0), _unflat(s0))
    got = run_ranks(dp_step_worker, 2, tmp_path, pc, shards, sd, 1e-3, 1.0,
                    0.0, True)
    for r in got:
        assert set(r['loss']) == set(jl)
        for k in LOSS_KEYS:
            assert abs(r['loss'][k] - jl[k]) <= 1e-5 * abs(jl[k]), (
                k, r['loss'][k], jl[k])
        assert max(rel_err(r['stats'], js).values()) <= 1e-5
        assert l2_rel(r['grads'], jg) <= 1e-2
    a, b = got
    for k in a['val']:          # make_parallel_val_step: the pmean
        want = (a['val_own'][k] + b['val_own'][k]) / np.float32(2)
        assert a['val'][k] == b['val'][k] == want, k
    assert all(np.array_equal(a['params'][k], b['params'][k])
               for k in a['params'])
    assert all(np.array_equal(a['stats'][k], b['stats'][k])
               for k in a['stats'])

    # negative control: one process, both scenes in one batch
    with pytest.MonkeyPatch.context() as mp:
        from test_torch_parallel_common import patch_unrounded
        patch_unrounded(mp.setattr)
        model = S.build_model(pc, 20, 'cpu')
        model.load_state_dict(sd)
        state = S.TrainState(model, S.make_optimizer(pc), None)
        S.backward(S.forward_losses(pc, state, to_torch(whole), 1.0, 0.0))
        one = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert l2_rel(one, jg) > 1e-2


# ------------------------------------------------------------ the loader
LOADER = ['--dataset_name', 'synthetic', '--dataset_size', '6',
          '--batch_size', '1', '--fixed_seed', '3', '--augmentation',
          '--bb_supervision', '--do_segment_pooling', '--voxel_size', '0.05',
          '--vox_bucket', '16', '--seg_bucket', '8', '--num_workers', '2',
          '--synthetic_instances', '3', '--synthetic_points_per_instance',
          '150', '--synthetic_floor_points', '400',
          '--synthetic_wall_points', '300', '--exp_name', 'torch_dp_loader']


def assert_same(a, b, what=''):
    """Two dicts of arrays equal in keys, dtype, shape and value."""
    assert set(a) == set(b), (what, set(a) ^ set(b))
    for k in b:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        np.testing.assert_array_equal(x, y, err_msg=f'{what}.{k}')


def test_sharded_loader_matches_jax():
    """Bit for bit, 2 epochs, 2 shards of batch 1 over 6 scenes (small
    pad buckets, so that a shard's own pads differ from the common
    ones)."""
    pc, jc = PC.get_config(LOADER), JC.get_config(LOADER)
    pc.use_native_host_ops = jc.use_native_host_ops = False
    pds, jds = PLd.get_dataset(pc, 'train'), JLd.get_dataset(jc, 'train')
    jl = jds.get_loader(num_shards=2)
    both = pds.get_loader(num_shards=2)
    ranks = [PLd.get_dataset(pc, 'train').get_loader(num_shards=2, shard=r)
             for r in range(2)]
    assert len(jl) == len(both) == len(ranks[0]) == len(ranks[1]) == 3
    own_pads = 0
    for epoch in range(2):
        for ld in [jl, both] + ranks:
            ld.set_epoch(epoch)
        order = jl._order()
        for i, (js, ps, r0, r1) in enumerate(zip(jl, both, *ranks)):
            assert len(js) == len(ps) == 2
            for r, ((jd, jh), (pd, ph), (rd, rh)) in enumerate(
                    zip(js, ps, (r0, r1))):
                assert_same(pd, jd, f'epoch {epoch} step {i} shard {r}')
                names = [n['name'] for n in jh['scene']]
                assert [n['name'] for n in ph['scene']] == names
                assert [n['name'] for n in rh['scene']] == names
                rets = [jds[j] for j in order[2 * i + r:2 * i + r + 1]]
                assert [x['scene']['name'] for x in rets] == names
                want, _ = JB.build_batch(rets, jc, jds.sem_id2idx,
                                         mode='train')
                assert_same(rd, want, f'epoch {epoch} step {i} rank {r}')
                own_pads += rd['keys0_b'].shape != pd['keys0_b'].shape
    for ld in [both] + ranks:
        ld.close()
    assert own_pads > 0


@pytest.mark.parametrize('n_scenes, want', [(7, [[2, 2], [1, 1]]),
                                             (5, [[2, 2]])])
def test_sharded_loader_partial_group_leaves_no_rank_short(n_scenes, want):
    """drop_last=False, 2 shards of batch 2: a last partial group of 3
    scenes gives each rank 1 (as the JAX loader's list: scene 7 dropped);
    one of 1 scene, which the JAX loader cannot split (it builds empty
    shards), is dropped, so every rank takes the same number of steps."""
    args = LOADER + ['--dataset_size', str(n_scenes), '--batch_size', '2']
    pc, jc = PC.get_config(args), JC.get_config(args)
    pc.use_native_host_ops = jc.use_native_host_ops = False
    ranks = [PLd.get_dataset(pc, 'train').get_loader(
        drop_last=False, num_shards=2, shard=r) for r in range(2)]
    got = [[len(h['scene']) for _, h in ld] for ld in ranks]
    assert [list(x) for x in zip(*got)] == want
    assert [len(ld) for ld in ranks] == [len(want)] * 2
    if n_scenes == 7:
        jl = JLd.get_dataset(jc, 'train').get_loader(drop_last=False,
                                                     num_shards=2)
        jnames = [[[s['name'] for s in h['scene']] for _, h in step]
                  for step in jl]
        pnames = [[[s['name'] for s in h['scene']] for _, h in ld]
                  for ld in ranks]
        assert [list(x) for x in zip(*pnames)] == jnames
    for ld in ranks:
        ld.close()


# ------------------------------------------------------------ Trainer + CLI
RECIPE = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
          '--dataset_size', '4', '--vox_bucket', '512', '--seg_bucket', '64',
          '--layers', '1', '--num_workers', '2', '--batch_size', '1',
          '--ckpt_every', '1', '--val_every', '1']
DP = ['--multigpu', '--data_axis_size', '2']


def cli(args, root):
    """`python -m box2mask_torch.train` in a subprocess (its own process
    group: a timeout ends its ranks too) on gloo ranks on the CPU, at one
    torch thread per rank; its stdout."""
    env = dict(os.environ, BOX2MASK_PLATFORM='cpu', BOX2MASK_EXP_ROOT=root,
               OMP_NUM_THREADS='1')
    p = subprocess.Popen([sys.executable, '-m', 'box2mask_torch.train']
                         + args, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=240)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    assert p.returncode == 0, err[-4000:]
    return out


def losses(out):
    return [float(line.split('loss ')[1].split()[0])
            for line in out.splitlines() if ' loss ' in line]


def test_train_cli_multigpu_checkpoint_resume_on_gloo_ranks(tmp_path,
                                                           monkeypatch):
    """2 epochs of 2 steps on 2 ranks (4 scenes, batch 1 per rank): one
    checkpoint (at the epoch-1 head) from rank 0, the val loss logged
    once, every print from rank 0, equal parameters at the end; a second
    run resumes at epoch 1 and takes the first run's last-epoch losses
    (rtol 1e-6, as the one-process resume test). On the CPU --multigpu
    needs --data_axis_size; without CUDA, --multigpu asked for more ranks
    than cards (without BOX2MASK_PLATFORM=cpu) raises."""
    root = str(tmp_path)
    out = cli(RECIPE + DP + ['--num_epochs', '2'], root)
    first = losses(out)
    assert len(first) == 4 and np.isfinite(first).all()
    assert out.count('Saved checkpoint') == 1
    assert '2 ranks ended with equal parameters' in out
    ckpts = ckpt.list_checkpoints(os.path.join(root, 'synthetic',
                                               'checkpoints'))
    assert len(ckpts) == 1
    assert ckpt.read_payload(ckpts[0][1])['epoch'] == 1
    with open(os.path.join(root, 'synthetic', 'metrics.jsonl')) as f:
        rows = [json.loads(line) for line in f]
    assert sum('val/optimization_loss' in r for r in rows) == 1

    out = cli(RECIPE + DP + ['--num_epochs', '2'], root)
    assert 'Resumed from checkpoint_' in out and '(epoch 1)' in out
    assert out.count('Resumed from') == 1
    np.testing.assert_allclose(losses(out), first[2:], rtol=1e-6)
    assert '2 ranks ended with equal parameters' in out

    monkeypatch.setenv('BOX2MASK_EXP_ROOT', root)
    monkeypatch.setenv('BOX2MASK_PLATFORM', 'cpu')
    with pytest.raises(ValueError, match='data_axis_size'):
        train_cli.main(RECIPE + ['--multigpu'])
    monkeypatch.delenv('BOX2MASK_PLATFORM', raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='2 ranks'):
            train_cli.main(RECIPE + DP)


# ------------------------------------------------------------ flags, remat
@pytest.mark.parametrize('extra', [
    [], ['--multigpu'], ['--multigpu', '--singlegpu'],
    ['--multigpu', '--data_axis_size', '3'],
    ['--batch_size', '16', '--vox_bucket', '131072'],
    ['--batch_size', '16', '--vox_bucket', '131072', '--multigpu'],
    ['--batch_size', '16', '--vox_bucket', '131072', '--multigpu',
     '--singlegpu']])
def test_data_parallel_flags_match_jax(extra):
    """--multigpu, --singlegpu, --data_axis_size and the auto-remat rule
    (skipped under --multigpu) as the JAX package's get_config reads
    them."""
    args = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt')] + extra
    pc, jc = PC.get_config(args), JC.get_config(args)
    for k in ('multigpu', 'singlegpu', 'data_axis_size', 'remat'):
        assert getattr(pc, k) == getattr(jc, k), k
    assert getattr(pc, 'remat_auto', False) == getattr(jc, 'remat_auto',
                                                       False)


def test_multigpu_with_spatial_shards_is_refused():
    args = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
            '--multigpu', '--spatial_shards', '2']
    with pytest.raises(AssertionError, match='mutually exclusive'):
        JC.get_config(args)
    with pytest.raises(ValueError, match='mutually exclusive'):
        PC.get_config(args)


class _Stop(Exception):
    pass


def test_remat_rule_reads_one_ranks_rows_jax_divides_again(tmp_path,
                                                          monkeypatch):
    """The JAX Trainer under --multigpu on 2 devices hands needs_remat one
    device's level-0 rows divided by the device count (engine/train.py:251
    passes the first shard, :124 divides): at f32 activations 5 x 131072
    rows on a device, past the rule, read as 2.5 x 131072 (no remat). The
    port's ranks hand it one rank's rows, the most of any rank (so that
    every rank decides alike): 3 x 131072 and 5 x 131072 -> 5 x 131072."""
    import box2mask_tpu.config as jconfig
    from box2mask_tpu.engine import train as JT
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    args = LOADER + ['--batch_size', '5', '--dataset_size', '10',
                     '--vox_bucket', '131072',
                     '--multigpu', '--data_axis_size', '2',
                     '--exp_name', 'dp_remat']
    jc = JC.get_config(args)
    assert not jc.remat and not jc.bf16_acts
    seen = []

    def needs_remat(n, bf16_acts=False):
        seen.append(n)
        raise _Stop
    monkeypatch.setattr(jconfig, 'needs_remat', needs_remat)
    t = JT.Trainer(jc, JLd.get_dataset(jc, 'train'), None)
    with pytest.raises(_Stop):
        t.train_model(1)
    per_device = 5 * 131072
    assert jconfig.__dict__['needs_remat'] is needs_remat
    assert seen == [per_device // 2]
    from box2mask_torch.config import needs_remat as rule
    assert rule(per_device) and not rule(per_device // 2)

    from test_torch_parallel_common import remat_worker
    pc = PC.get_config(args)
    got = run_ranks(remat_worker, 2, tmp_path / 'ranks', pc,
                    (3 * 131072, 5 * 131072))
    assert got == [[per_device], [per_device]]
