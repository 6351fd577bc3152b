"""The port's training engine against the JAX package's: the loss suite
(values and gradients w.r.t. the head outputs), the delayed head weights,
the LR schedule, the three optimizers against optax, block remat, the
checkpoint format and the Trainer's resume, on the CPU."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.engine import schedule as JSch
from box2mask_tpu.engine import state as JS
from box2mask_tpu.nn import losses as JL
from box2mask_torch import config as PC
from box2mask_torch.datasets import loader as PLd
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import schedule as PSch
from box2mask_torch.engine import state as S
from box2mask_torch.engine.optim import Optimizer
from box2mask_torch.engine.train import Trainer
from box2mask_torch.nn import losses as PL
from test_torch_train_common import ARGS, port_batch

LOSS_ARGS = ['--network_heads', 'mlp_offsets', 'mlp_bounds', 'mlp_bb_scores',
             'mlp_semantics', 'mlp_center_scores', 'mlp_per_vox_semantics',
             '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
             '--loss_weight_semantics', '1', '--loss_weight_center_scores',
             '0.7', '--use_bb_iou_loss', '--loss_weight_bb_iou', '0.3',
             '--mlp_bb_scores_start_epoch', '100',
             '--mlp_center_scores_start_epoch', '50', '--exp_name', 'loss']


def loss_inputs(seed=0, S_=96, V=160, C=20):
    """Random head outputs and labels (numpy), padding rows included."""
    rng = np.random.default_rng(seed)
    f = np.float32
    n_valid = S_ - 17
    seg_valid = np.arange(S_) < n_valid
    sem = rng.integers(0, C, S_).astype(np.int32)
    sem[rng.random(S_) < 0.2] = -100
    pv = rng.integers(0, C, V).astype(np.int32)
    pv[rng.random(V) < 0.2] = -100
    batch = {
        'seg_valid': seg_valid,
        'fg_instances': (rng.random(S_) < 0.6) & seg_valid,
        'input_location': rng.normal(size=(S_, 3)).astype(f),
        'gt_bb_offsets': rng.normal(0, 0.5, (S_, 3)).astype(f),
        'gt_bb_bounds': rng.uniform(0.05, 1, (S_, 3)).astype(f),
        'gt_semantics_idx': sem,
        'valid0': np.arange(V) < V - 30,
        'gt_per_vox_semantics_idx': pv,
    }
    pred = {
        'mlp_offsets': rng.normal(0, 0.5, (S_, 3)).astype(f),
        'mlp_bounds': rng.uniform(-0.1, 1, (S_, 3)).astype(f),
        'mlp_bb_scores': rng.normal(size=(S_, 1)).astype(f),
        'mlp_center_scores': rng.normal(size=(S_, 1)).astype(f),
        'mlp_semantics': rng.normal(size=(S_, C)).astype(f),
        'mlp_per_vox_semantics': rng.normal(size=(V, C)).astype(f),
    }
    return pred, batch


@pytest.mark.parametrize('epoch', [0, 60, 120])
def test_losses_and_their_grads_match_jax(epoch):
    """compute_losses on the same head outputs and labels, with the
    delayed-start head weights of this epoch: every entry within 1e-6
    relative, and d optimization_loss / d head output within 1e-6 of the
    largest (the detached IoU and center-score targets carry no gradient
    on either side)."""
    pc = PC.get_config(LOSS_ARGS)
    jc = JC.get_config(LOSS_ARGS)
    assert S.head_weights(pc, epoch) == JS.head_weights(jc, epoch)
    bb_w, cs_w = S.head_weights(pc, epoch)
    pred, batch = loss_inputs()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        ld = JL.compute_losses(jc, p, jb, jnp.float32(bb_w),
                               jnp.float32(cs_w))
        return ld['optimization_loss'], ld
    jgrad, jld = jax.grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in pred.items()})
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in pred.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    pld = PL.compute_losses(pc, tp, tb, bb_w, cs_w)
    assert set(pld) == set(jld)
    for k, v in jld.items():
        np.testing.assert_allclose(float(pld[k].detach()), float(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    pld['optimization_loss'].backward()
    for k in pred:
        want = np.asarray(jgrad[k])
        np.testing.assert_allclose(tp[k].grad.numpy(), want, rtol=0,
                                   atol=1e-6 * max(np.abs(want).max(), 1e-3),
                                   err_msg=k)


def test_schedule_and_remat_rule_match_jax():
    args = ['--lr', '0.001', '--use_lr_scheduler',
            '--lr_scheduler_start_epoch', '650',
            '--lr_scheduler_end_epoch', '1650', '--exp_name', 'lr']
    pc, jc = PC.get_config(args), JC.get_config(args)
    for e in (0, 649, 650, 900, 1649, 1650):
        assert PSch.lr_for_epoch(pc, e) == JSch.lr_for_epoch(jc, e)
    for rows in (4 * 131072, 4 * 131072 + 1, 8 * 131072, 9 * 131072):
        for bf16 in (False, True):
            assert PC.needs_remat(rows, bf16) == JC.needs_remat(rows, bf16)


@pytest.mark.parametrize('name', ['Adam', 'Adadelta', 'RMSprop'])
def test_optimizer_matches_optax(name):
    """A toy parameter tree over 5 steps with a changing learning rate:
    params within 1e-6 relative of optax's (f32 rounding of the same
    formula; RMSprop/Adadelta per optax's decay and eps)."""
    rng = np.random.default_rng(1)
    shapes = {'a': (4, 3), 'b': (7,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lrs = [1e-2, 5e-3, 3e-3, 2e-3, 1e-3]
    grads = [{k: rng.normal(size=s).astype(np.float32) * 10 ** -i
              for k, s in shapes.items()} for i in range(5)]
    cfg = JC.get_config(['--optimizer', name, '--exp_name', 'opt'])
    tx = JS.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    tparams = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
               for k in shapes]
    opt = Optimizer(name)
    tst = opt.init(tparams)
    for lr, g in zip(lrs, grads):
        st.hyperparams['learning_rate'] = jnp.float32(lr)
        upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st,
                            jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tparams, shapes):
            p.grad = torch.from_numpy(g[k])
        opt.update(tparams, tst, lr)
        for p, k in zip(tparams, shapes):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        Optimizer('sgd')


def small_setup(extra=()):
    pc, dev = port_batch(list(extra) + ['--compute_dtype', 'float32'])
    batch = {k: torch.from_numpy(np.asarray(a)) for k, a in dev.items()}
    model = S.build_model(pc, 20, 'cpu')
    state = S.init_state(pc, model, S.make_optimizer(pc), seed=3)
    return pc, batch, state


def test_remat_moves_bn_stats_once():
    """--remat recomputes the BasicBlocks in the backward: loss, grads and
    BN running statistics equal the plain step's (the running statistics
    move once, as under flax's nn.remat), also with --remat_levels 1."""
    pc, batch, plain = small_setup()
    stats0 = {k: v.clone() for k, v in plain.model.state_dict().items()}
    results = []
    for extra in ([], ['--remat'], ['--remat', '--remat_levels', '1']):
        cfg, _, st = small_setup(extra)
        assert st.model.remat == ('--remat' in extra)
        st.model.load_state_dict(stats0)
        ld = S.forward_losses(cfg, st, batch, 1.0, 0.0)
        S.backward(ld)
        results.append((float(ld['optimization_loss']),
                        {n: p.grad.clone()
                         for n, p in st.model.named_parameters()},
                        {k: v for k, v in st.model.state_dict().items()
                         if k.endswith(('.mean', '.var'))}))
    base = results[0]
    moved = [k for k, v in base[2].items() if not torch.equal(v, stats0[k])]
    assert len(moved) == len(base[2])
    for loss, grads, stats in results[1:]:
        assert loss == base[0]
        for k, v in stats.items():
            assert torch.equal(v, base[2][k]), k
        for k, g in grads.items():
            torch.testing.assert_close(g, base[1][k], rtol=1e-6, atol=1e-9)


def test_checkpoint_roundtrip_and_selection(tmp_path):
    pc, batch, state = small_setup()
    S.train_step(pc, state, batch, 1e-3, 1.0, 0.0)
    d = str(tmp_path / 'ckpts')
    assert ckpt.find_checkpoint(d) is None
    p1 = ckpt.save_checkpoint(d, state, 3600.5, 2, 7)
    p2 = ckpt.save_checkpoint(d, state, 7300.25, 3, 9)
    assert os.path.basename(p1) == 'checkpoint_1h:0m:0s_3600.5.ckpt'
    assert ckpt.find_checkpoint(d) == p2
    assert ckpt.find_checkpoint(d, closest_to=1) == p1
    assert ckpt.find_checkpoint(d, checkpoint='x') == os.path.join(d, 'x.ckpt')
    _, _, fresh = small_setup()
    got, epoch, t, it, name = ckpt.load_checkpoint(p2, fresh)
    assert (epoch, t, it, name) == (3, 7300.25, 9,
                                    'checkpoint_2h:1m:40s_7300.25')
    assert got.step == state.step == 1
    for (k, a), b in zip(state.model.state_dict().items(),
                         got.model.state_dict().values()):
        assert torch.equal(a, b), k
    for slot in ('mu', 'nu'):
        for a, b in zip(state.opt_state[slot], got.opt_state[slot]):
            assert torch.equal(a, b)
    assert got.opt_state['count'] == 1
    ckpt.write_val_min_marker(str(tmp_path), 1.5)
    ckpt.write_val_min_marker(str(tmp_path), 0.75)
    assert ckpt.read_val_min(str(tmp_path)) == 0.75
    assert ckpt.read_val_min(str(tmp_path / 'none')) == float('inf')


def test_trainer_resumes_at_the_right_epoch(tmp_path, monkeypatch, capsys):
    """Two epochs of one step each (checkpoint at the epoch-1 head), then a
    new Trainer resumes from it at epoch 1 and trains on to epoch 3."""
    monkeypatch.setenv('BOX2MASK_EXP_ROOT', str(tmp_path))
    args = ARGS + ['--dataset_size', '2', '--batch_size', '2',
                   '--ckpt_every', '1', '--val_every', '1',
                   '--num_eval_batches', '1', '--num_workers', '2',
                   '--synthetic_instances', '3',
                   '--synthetic_points_per_instance', '150',
                   '--synthetic_floor_points', '400',
                   '--synthetic_wall_points', '300', '--fixed_seed', '5',
                   '--compute_dtype', 'float32']
    cfg = PC.get_config(args)

    def trainer():
        return Trainer(cfg, PLd.get_dataset(cfg, 'train'),
                       PLd.get_dataset(cfg, 'val'), device='cpu')

    t1 = trainer()
    t1.train_model(2)
    assert t1.iteration_num == 2
    assert [os.path.basename(p) for _, p in
            ckpt.list_checkpoints(cfg.checkpoint_path)] != []
    assert np.isfinite(t1.val_min)
    t2 = trainer()
    t2.train_model(3)
    out = capsys.readouterr().out
    assert 'Resumed from checkpoint_' in out and '(epoch 1)' in out
    assert t2.start_epoch == 1 and t2.iteration_num == 3
    epochs = [e for _, p in ckpt.list_checkpoints(cfg.checkpoint_path)
              for e in [ckpt.load_checkpoint(p, t2.state)[1]]]
    assert sorted(epochs) == [1, 2]
    assert os.path.exists(os.path.join(cfg.exp_path, 'metrics.jsonl'))


def test_build_model_runs_on_the_card_by_default():
    """build_model(device=None) resolves to the card: without CUDA it
    raises instead of building on the CPU."""
    cfg = PC.get_config(ARGS)
    if torch.cuda.is_available():
        assert next(S.build_model(cfg, 20).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match='CUDA'):
            S.build_model(cfg, 20)
    assert not next(S.build_model(cfg, 20, 'cpu').parameters()).is_cuda


def test_init_state_is_seeded():
    a = small_setup()[2].model.state_dict()
    b = small_setup()[2].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
