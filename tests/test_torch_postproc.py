"""The port's device post-processing and inference pipeline against the JAX
package's.

Post-processing is fed the same numpy predictions on both sides: the NMS
decisions, the packed masks, the labels and the cap flag must be equal, conf
within 1e-6 (sigmoid on either side, one f32 rounding apart).
"""

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
from box2mask_tpu.engine import state as JS
from box2mask_tpu.engine.infer import FusedInferencePipeline as JaxPipeline
from box2mask_tpu.postprocess import device_post as JDP
from box2mask_torch import config as PC
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.engine.infer import FusedInferencePipeline
from box2mask_torch.postprocess import device_post as DP

ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--do_segment_pooling', '--loss_weight_bb_bounds', '0.5',
        '--loss_weight_bb_scores', '1', '--loss_weight_semantics', '1',
        '--voxel_size', '0.05', '--vox_bucket', '512', '--seg_bucket', '64',
        '--layers', '1', '--use_normals_input', '--exp_name', 'torch_post',
        '--eval_ths', '0.5', '0.05', '0.3', '0.6']
SCENE = dict(num_instances=5, points_per_instance=250, floor_points=900,
             wall_points=700)
VALID_IDS, _, _, IS_FG = JT.get_tables('scannet')


def jax_batch(seeds, device_maps=None):
    jc = JC.get_config(ARGS)
    jc.use_native_host_ops = False
    rets = [JV.voxelize_scene(JSyn.make_scene(seed=s, **SCENE)[0], jc)
            for s in seeds]
    return JB.build_batch(rets, jc, JT.SCANNET_SEMANTIC_ID2IDX, mode='val',
                          device_maps=device_maps)


def crisp_pred(dev, seed=0):
    """Random votes with clear margins: no score or class ties."""
    rng = np.random.default_rng(seed)
    S = dev['seg_valid'].shape[0]
    sem = np.full((S, 20), -5.0, np.float32)
    sem[np.arange(S), rng.integers(0, 20, S)] = 5.0
    return {'mlp_offsets': rng.normal(0, 0.05, (S, 3)).astype(np.float32),
            'mlp_bounds': rng.uniform(0.2, 0.8, (S, 3)).astype(np.float32),
            'mlp_bb_scores': rng.uniform(-2, 4, (S, 1)).astype(np.float32),
            'mlp_semantics': sem}


def both_cores(dev, pred, max_masks):
    cfg = PC.get_config(ARGS)
    ths = np.asarray(cfg.eval_ths, np.float32)
    jcore = JDP._make_core(JC.get_config(ARGS), VALID_IDS, IS_FG, max_masks)
    pcore = DP.make_core(cfg, VALID_IDS, IS_FG, max_masks)
    B = dev['keys0_b'].shape[0]
    vs = dev['valid0'].shape[0] // B
    jb = {k: jnp.asarray(v) for k, v in dev.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in dev.items()}
    jp = {k: jnp.asarray(v) for k, v in pred.items()}
    tp = {k: torch.from_numpy(v) for k, v in pred.items()}
    for si in range(B):
        sl = slice(si * vs, (si + 1) * vs)
        j = jcore(jp, jb, jnp.int32(si), jnp.asarray(ths), vox_slice=sl)
        p = pcore(tp, tb, si, torch.from_numpy(ths), vox_slice=sl)
        yield ({k: np.asarray(v) for k, v in j.items()},
               {k: v.numpy() for k, v in p.items()})


def assert_same(j, p, top_k=16):
    assert int(p['n_keep']) == int(j['n_keep'])
    assert bool(p['cluster_cap_hit']) == bool(j['cluster_cap_hit'])
    np.testing.assert_array_equal(p['label_idx'], j['label_idx'])
    np.testing.assert_array_equal(p['masks'], j['masks'])
    np.testing.assert_array_equal(p['seg_masks'], j['seg_masks'])
    np.testing.assert_allclose(p['conf'], j['conf'], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        DP.pack_bits(torch.from_numpy(p['seg_masks'][:top_k])).numpy(),
        np.asarray(JDP._pack_bits(jnp.asarray(j['seg_masks'][:top_k]))))


@pytest.mark.parametrize('seed', [0, 1])
def test_core_matches_jax(seed):
    dev, _ = jax_batch((3, 4))
    n_kept = 0
    for j, p in both_cores(dev, crisp_pred(dev, seed), max_masks=64):
        assert_same(j, p)
        n_kept += int(j['n_keep'])
    assert n_kept > 4


def test_cluster_cap_hit_matches_jax():
    """Every foreground segment its own cluster: the bound of 8 clusters is
    hit on both sides."""
    dev, _ = jax_batch((3,))
    dev = dict(dev)
    S = dev['seg_valid'].shape[0]
    dev['input_location'] = (np.arange(S)[:, None]
                             * np.array([10.0, 0, 0])).astype(np.float32)
    pred = crisp_pred(dev, 2)
    pred['mlp_bounds'][:] = 0.01
    pred['mlp_bb_scores'][:] = np.linspace(1, 4, S)[:, None]
    pred['mlp_semantics'][:] = -5.0
    pred['mlp_semantics'][:, 5] = 5.0
    for j, p in both_cores(dev, pred, max_masks=8):
        assert bool(j['cluster_cap_hit'])
        assert_same(j, p)


def test_topk_overflow_falls_back_to_full_width():
    """With top_k below a scene's kept count the stacked output flags
    topk_overflow exactly where the JAX core keeps more than top_k, and the
    host unpack's full-width fallback gives the results of a large top_k."""
    dev, host = jax_batch((3, 4))
    cfg = PC.get_config(ARGS)
    pred = {k: torch.from_numpy(v) for k, v in crisp_pred(dev, 0).items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in dev.items()}
    ths = torch.tensor(cfg.eval_ths, dtype=torch.float32)
    core = DP.make_core(cfg, VALID_IDS, IS_FG, 64)
    post_full = DP.make_device_postproc(cfg, VALID_IDS, IS_FG, 64)
    results = {}
    for top_k in (2, 64):
        out = DP.fused_postproc(core, cfg, pred, tb, ths, top_k)
        out_np = {k: v.numpy() for k, v in out.items()}
        if top_k == 2:
            jn = [int(j['n_keep']) for j, _ in both_cores(
                dev, {k: v.numpy() for k, v in pred.items()}, 64)]
            np.testing.assert_array_equal(out_np['topk_overflow'],
                                          np.array(jn) > 2)
            assert out_np['topk_overflow'].any()
        results[top_k] = DP.stacked_masks_to_results(
            out_np, host, VALID_IDS, post_fallback=post_full,
            pred=pred, dev_t=tb, ths=ths)
    assert results[2].keys() == results[64].keys()
    for name, r in results[64].items():
        for k in ('conf', 'label_id', 'mask'):
            np.testing.assert_array_equal(results[2][name][k], r[k])


def pipelines_vs_jax(extra, seeds, jax_device_maps=None):
    """The port's FusedInferencePipeline (device='cpu', ARGS + extra)
    against the JAX pipeline on the same batches of scenes `seeds`, with the
    same params, top_k 16 and max_masks 64: per scene the same masks,
    labels and mask count, conf within 1e-5. Returns [(port results,
    out_np, host)] per batch and the number of masks.

    The last layer of each head is scaled to 1e-3 of its init (and given
    fixed biases), so the feature-dependent part of every vote moves a box
    by about a millimetre: the ~0.5% forward difference from bf16 rounding
    (test_torch_forward) then stays clear of the IoU and score thresholds,
    and every decision must come out the same."""
    jc = JC.get_config(ARGS)
    jc.use_native_host_ops = False
    pc = PC.get_config(ARGS + extra)
    pc.use_native_host_ops = False
    jbatches = [jax_batch(s, jax_device_maps) for s in seeds]
    pbatches = [PB.build_batch(
        [PV.voxelize_scene(PSyn.make_scene(seed=x, **SCENE)[0], pc)
         for x in s], pc, mode='val') for s in seeds]
    model = JS.build_model(jc, 20)
    v = JS.init_variables(model, {k: jnp.asarray(a)
                                  for k, a in jbatches[0][0].items()})
    params = jax.tree_util.tree_map(np.array, v['params'])
    stats = jax.tree_util.tree_map(np.array, v['batch_stats'])
    for head, b in (('mlp_offsets', 0.0), ('mlp_bounds', 0.3),
                    ('mlp_bb_scores', 0.5), ('mlp_semantics', None)):
        lin = params[head]['Linear1x1_2']
        lin['kernel'] = (lin['kernel'] * 1e-3).astype(np.float32)
        if b is None:
            lin['bias'] = np.zeros_like(lin['bias'])
            lin['bias'][5], lin['bias'][8] = 2.0, 1.5
        else:
            lin['bias'] = np.full_like(lin['bias'], b)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        jres = [r for r, *_ in JaxPipeline(
            jc, VALID_IDS, IS_FG, model=model, top_k=16, max_masks=64).run(
                params, stats, jbatches, jc.eval_ths)]
        pipe = FusedInferencePipeline(pc, VALID_IDS, IS_FG, top_k=16,
                                      max_masks=64, device='cpu')
        out = list(pipe.run(from_flax(params, stats), pbatches, pc.eval_ths))
    assert pipe.n_scenes == sum(len(s) for s in seeds)
    n_masks = 0
    for (pres, out_np, _, host), jr in zip(out, jres):
        assert list(pres) == list(jr) == [s['name'] for s in host['scene']]
        for name, want in jr.items():
            got = pres[name]
            assert len(got['conf']) == len(want['conf'])
            np.testing.assert_array_equal(got['label_id'], want['label_id'])
            np.testing.assert_array_equal(got['mask'], want['mask'])
            np.testing.assert_allclose(got['conf'], want['conf'], rtol=0,
                                       atol=1e-5)
            n_masks += len(want['conf'])
    return [(pres, out_np, host) for pres, out_np, _, host in out], n_masks


def test_pipeline_matches_jax():
    """The port's pipeline on its key-matching path against the JAX
    pipeline on the same 2 batches of 2 scenes (pipelines_vs_jax). top_k =
    16 below the kept counts also drives the full-width fallback."""
    out, n_masks = pipelines_vs_jax([], [(3, 4), (5, 6)])
    for _, out_np, _ in out:
        assert out_np['topk_overflow'].any()
    assert n_masks > 20
