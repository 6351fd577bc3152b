"""The port's neighbor-map path (--key_conv off, with and without
--pallas_conv on; host-maps batches) as a whole against the JAX package's
neighbor-map path: the forward on the same params, batch statistics and
scenes (test_torch_forward's setup and bounds), the inference pipeline
(test_torch_postproc's comparison), and the training guard.

Bounds. Pallas off: the forwards differ by the bf16 rounding flips of the
conv operands, 1.5e-2 max / 3e-3 mean of the head's max |output| (f32
policy), 2e-2 / 4e-3 under --bf16_acts; with compute_dtype float32 nothing
rounds and only the order of f32 sums differs, 1e-5 / 1e-6. Pallas on (the
port's kernel twins) against JAX pallas off under --bf16_acts: the same
function (each conv one f32 sum of the same bf16 products, each up conv's
output rounded once to bf16 on both sides), so the same bounds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu.engine import state as JS
from box2mask_torch import config as PC
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine import state as S
from box2mask_torch.engine.infer import FusedInferencePipeline
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import pallas_conv as PCV
from test_torch_forward import ARGS, SCENE, setup  # noqa: F401 (fixture)
from test_torch_postproc import pipelines_vs_jax

NMAP = ['--key_conv', 'off']
# xdist workers running torch side by side at one thread per core slow
# each other down (OpenMP spin-waits; tests/test_torch_train_common.py)
torch.set_num_threads(min(2, torch.get_num_threads()))


def forwards(setup, jax_extra, port_extra):
    """Head outputs of the JAX forward (its neighbor-map path) and of the
    port's forward on its neighbor-map path, same params and statistics."""
    jdev, params, stats = setup
    jc = JC.get_config(ARGS + jax_extra)
    jout = JS.make_forward(jc, JS.build_model(jc, 20))(
        params, stats, {k: jnp.asarray(a) for k, a in jdev.items()})
    pc = PC.get_config(ARGS + port_extra)
    pc.use_native_host_ops = False
    rets = [PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], pc)
            for s in (3, 4)]
    pdev, _ = PB.build_batch(rets, pc, mode='val')
    assert S.is_nmap_batch(pdev)
    model = S.build_model(pc, 20, 'cpu')
    model.load_state_dict(from_flax(params, stats))
    KC.reset_counts()
    PCV.reset_counts()
    pout = S.forward(model, {k: torch.from_numpy(np.asarray(a))
                             for k, a in pdev.items()})
    assert sum(KC.PLAIN_CALLS.values()) == 0            # no key matching
    return {k: np.asarray(a) for k, a in jout.items()}, pout


@pytest.mark.parametrize('policy,pallas,max_tol,mean_tol', [
    ('f32', 'off', 1.5e-2, 3e-3), ('bf16_acts', 'off', 2e-2, 4e-3),
    ('bf16_acts', 'on', 2e-2, 4e-3), ('unrounded', 'off', 1e-5, 1e-6)])
def test_nmap_forward_matches_jax(setup, policy, pallas, max_tol, mean_tol):
    extra = {'f32': [], 'bf16_acts': ['--bf16_acts'],
             'unrounded': ['--compute_dtype', 'float32']}[policy]
    jout, pout = forwards(setup, extra,
                          extra + NMAP + ['--pallas_conv', pallas])
    # --layers 1: 1 stem + 7 down + 2 x 14 block convs; 7 up convs
    want_calls = ({'sparse_conv': 36, 'gather_rows': 7} if pallas == 'on'
                  else {'sparse_conv': 0, 'gather_rows': 0})
    assert PCV.PLAIN_CALLS == want_calls
    assert set(pout) == set(jout)
    for head, want in jout.items():
        got = pout[head]
        assert got.dtype == torch.float32
        got = got.numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert diff.max() <= max_tol * scale, (head, diff.max(), scale)
        assert diff.mean() <= mean_tol * scale, (head, diff.mean(), scale)


@pytest.mark.parametrize('pallas', ['off', 'on'])
def test_nmap_pipeline_matches_jax(pallas):
    """FusedInferencePipeline with --key_conv off against the JAX pipeline
    (its neighbor-map path on the CPU): per-scene masks and labels exact,
    conf within 1e-5."""
    out, n_masks = pipelines_vs_jax(NMAP + ['--pallas_conv', pallas],
                                    [(3, 4), (5, 6)])
    assert n_masks > 20
    assert any(out_np['topk_overflow'].any() for _, out_np, _ in out)


def test_host_maps_pipeline_matches_jax():
    """One host-maps batch (--host_coordinate_maps) of one scene through
    the pipeline against the JAX pipeline on the same layout."""
    out, n_masks = pipelines_vs_jax(['--host_coordinate_maps'], [(3,)],
                                    jax_device_maps=False)
    (_, out_np, host), = out
    assert 'interleaved_vs' not in host and out_np['n_keep'].shape == (1,)
    assert n_masks > 4


def test_host_maps_pipeline_holds_one_scene():
    """A host-maps batch of two scenes is refused (JAX evaluate.py:190-193
    holds such batches to one scene): the post-processing reads one voxel
    window per batch on that layout."""
    pc = PC.get_config(ARGS + ['--host_coordinate_maps', '--eval_ths', '0.5',
                               '0.05', '0.3', '0.6'])
    rets = [PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], pc)
            for s in (3, 4)]
    ids, _, _, is_fg = PT.get_tables('scannet')
    pipe = FusedInferencePipeline(pc, ids, is_fg, device='cpu')
    with pytest.raises(ValueError, match='one scene'):
        list(pipe.run(None, [PB.build_batch(rets, pc, mode='val')],
                      pc.eval_ths))


@pytest.mark.parametrize('extra', [NMAP, ['--key_conv', 'eval'],
                                   ['--host_coordinate_maps']])
def test_train_step_on_nmap_batch_raises(extra):
    """Training runs on key-matching batches only: a neighbor-map batch
    (device or host maps) raises, naming the ROADMAP item, and never runs
    the key path instead."""
    pc = PC.get_config(ARGS + extra)
    rets = [PV.voxelize_scene(PSyn.make_scene(seed=3, **SCENE)[0], pc)]
    dev, _ = PB.build_batch(rets, pc, mode='train')
    batch = {k: torch.from_numpy(np.asarray(a)) for k, a in dev.items()}
    state = S.init_state(pc, S.build_model(pc, 20, 'cpu'),
                         S.make_optimizer(pc))
    with pytest.raises(NotImplementedError, match='ROADMAP A18'):
        S.train_step(pc, state, batch, 1e-3, 1.0, 0.0)
    assert state.step == 0
