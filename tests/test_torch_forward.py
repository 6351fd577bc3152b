"""The port's SelectionNet forward against the JAX package's, on the same
params, batch statistics and batch, and the flax -> torch converter.

The JAX forward runs on its neighbor-map path (a batch built without
key_conv window plans): on the CPU its Pallas key_conv runs only in interpret
mode, which costs ~100 s for this forward, and the neighbor-map path computes
the same function (bf16-rounded conv operands, f32 accumulation).

Tolerance. With the bf16 rounding of conv and linear operands taken out of
both sides the two forwards agree to ~1e-6 of the largest head output, the
order of f32 sums (test_forward_matches_jax_unrounded holds them to 1e-5).
With it in, an f32
sum that lands within an ulp of a bf16 rounding boundary rounds the other
way on one side; through ~30 layers with eval-mode BN those flips add up to
~0.5% of the largest head output. Bounds: max |diff| <= 1.5e-2 and mean
|diff| <= 3e-3 of the head's max |output| (f32 policy); 2e-2 and 4e-3 under
--bf16_acts, where every activation is a bf16 as well.
"""

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
from box2mask_tpu.engine import state as JS
from box2mask_torch import config as PC
from box2mask_torch.convert import from_flax, kaiming_init_
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine import state as S
from box2mask_torch.sparse import key_conv as KC

ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--loss_weight_bb_bounds', '0.5',
        '--loss_weight_bb_scores', '1', '--loss_weight_semantics', '1',
        '--voxel_size', '0.05', '--vox_bucket', '512', '--seg_bucket', '64',
        '--layers', '1', '--use_normals_input', '--exp_name', 'torch_fwd']
SCENE = dict(num_instances=5, points_per_instance=250, floor_points=900,
             wall_points=700)


def random_stats(stats, seed=0):
    """Batch statistics replaced by mean ~ N(0, 0.1), var ~ U(0.5, 2)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in t:
            v = t[k]
            if hasattr(v, 'keys'):
                out[k] = walk(v)
            elif k == 'mean':
                out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
            else:
                out[k] = rng.uniform(0.5, 2, np.shape(v)).astype(np.float32)
        return out
    return walk(stats)


@pytest.fixture(scope='module')
def setup():
    jc = JC.get_config(ARGS)
    jc.use_native_host_ops = False
    rets = [JV.voxelize_scene(JSyn.make_scene(seed=s, **SCENE)[0], jc)
            for s in (3, 4)]
    jdev, _ = JB.build_batch(rets, jc, JT.SCANNET_SEMANTIC_ID2IDX, mode='val')
    model = JS.build_model(jc, 20)
    v = JS.init_variables(model, {k: jnp.asarray(a) for k, a in jdev.items()})
    params = jax.tree_util.tree_map(np.asarray, v['params'])
    stats = random_stats(jax.tree_util.tree_map(np.asarray, v['batch_stats']))
    return jdev, params, stats


def _forwards(setup, extra):
    jdev, params, stats = setup
    jc = JC.get_config(ARGS + extra)
    jout = JS.make_forward(jc, JS.build_model(jc, 20))(
        params, stats, {k: jnp.asarray(a) for k, a in jdev.items()})
    pc = PC.get_config(ARGS + extra)
    pc.use_native_host_ops = False
    prets = [PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], pc)
             for s in (3, 4)]
    pdev, _ = PB.build_batch(prets, pc)
    model = S.build_model(pc, 20, 'cpu')
    model.load_state_dict(from_flax(params, stats))
    pout = S.forward(model, {k: torch.from_numpy(np.asarray(a))
                             for k, a in pdev.items()})
    return {k: np.asarray(a) for k, a in jout.items()}, pout


@pytest.mark.parametrize('policy,max_tol,mean_tol', [
    ('f32', 1.5e-2, 3e-3), ('bf16_acts', 2e-2, 4e-3)])
def test_forward_matches_jax(setup, policy, max_tol, mean_tol):
    extra = ['--bf16_acts'] if policy == 'bf16_acts' else []
    jout, pout = _forwards(setup, extra)
    assert set(pout) == set(jout)
    for head, want in jout.items():
        got = pout[head]
        assert got.dtype == torch.float32          # heads stay f32
        got = got.numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert diff.max() <= max_tol * scale, (head, diff.max(), scale)
        assert diff.mean() <= mean_tol * scale, (head, diff.mean(), scale)


def test_forward_matches_jax_unrounded(setup, monkeypatch):
    """The claim behind the bounds above: with no bf16 rounding on either
    side (JAX: --compute_dtype float32 on its neighbor-map path; port: the
    same flag, and the plain twin with unrounded operands in place of every
    conv), the forwards differ only in the order of f32 sums: 1e-5 of the
    head's max |output| at most, 1e-6 on average."""
    def conv(x, kin, kout, w, **kw):
        return KC.key_conv_plain(x, kin, kout, w, operand_dtype=torch.float32,
                                 **kw)
    monkeypatch.setattr(KC, 'key_conv', conv)
    monkeypatch.setattr(KC, 'key_conv_stem', lambda x, kin, w: conv(
        x, kin, kin.reshape(-1), w, kernel_size=5, out_dtype=torch.float32))
    jout, pout = _forwards(setup, ['--compute_dtype', 'float32'])
    assert set(pout) == set(jout)
    for head, want in jout.items():
        got = pout[head].numpy()
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert diff.max() <= 1e-5 * scale, (head, diff.max(), scale)
        assert diff.mean() <= 1e-6 * scale, (head, diff.mean(), scale)


def test_from_flax_covers_every_leaf(setup):
    """Every flax leaf lands in exactly one state_dict entry, and every
    parameter and buffer of the port's model is filled, shape for shape."""
    _, params, stats = setup
    n_leaves = (len(jax.tree_util.tree_leaves(params))
                + len(jax.tree_util.tree_leaves(stats)))
    sd = from_flax(params, stats)
    assert len(sd) == n_leaves
    model = S.build_model(PC.get_config(ARGS), 20, 'cpu')
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    model.load_state_dict(sd, strict=True)
    flat = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    key = (jax.tree_util.DictKey('enc1_block0'),
           jax.tree_util.DictKey('SparseConv_0'),
           jax.tree_util.DictKey('kernel'))
    np.testing.assert_array_equal(
        model.enc1_block0.SparseConv_0.kernel.detach().numpy(), flat[key])


def test_kaiming_init_is_seeded_fan_out():
    model = S.build_model(PC.get_config(ARGS), 20, 'cpu')
    a = kaiming_init_(model, torch.Generator().manual_seed(1))
    w = a.stem_conv.kernel.detach()
    np.testing.assert_allclose(w.std().item(), np.sqrt(2.0 / (125 * 32)),
                               rtol=0.05)
    b = kaiming_init_(S.build_model(PC.get_config(ARGS), 20, 'cpu'),
                      torch.Generator().manual_seed(1))
    for (k, v), v2 in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, v2), k
