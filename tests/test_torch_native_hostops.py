"""The port's native host ops (box2mask_torch/native) against the JAX
package's and against the port's NumPy plain versions: the C mask unpack
and the C voxelizer bit-equal, voxelize_scene's native branch bit-equal to
the JAX package's native branch, the library built under a source-hash
name in box2mask_torch/build/, and a failed build raising.

The native voxelizer and the NumPy/cKDTree path may pick different nearest
points on exact distance ties, so each comparison holds one path against
its own counterpart and never mixes the two.
"""

import os
import re

import numpy as np
import pytest
import torch

from box2mask_tpu import config as JC
from box2mask_tpu import native as JN
from box2mask_tpu.datasets import synthetic as JSyn
from box2mask_tpu.datasets import voxelize as JV
from box2mask_torch import config as PC
from box2mask_torch import native as PN
from box2mask_torch.datasets import batching as PB
from box2mask_torch.datasets import synthetic as PSyn
from box2mask_torch.datasets import tables as PT
from box2mask_torch.datasets import voxelize as PV
from box2mask_torch.postprocess import device_post as DP

ARGS = ['--dataset_name', 'synthetic', '--network_heads', 'mlp_offsets',
        'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
        '--loss_weight_bb_bounds', '0.5', '--loss_weight_bb_scores', '1',
        '--loss_weight_semantics', '1', '--voxel_size', '0.05',
        '--vox_bucket', '512', '--seg_bucket', '64', '--layers', '1',
        '--use_normals_input', '--exp_name', 'torch_native',
        '--eval_ths', '0.5', '0.05', '0.3', '0.6']
SCENE = dict(num_instances=4, points_per_instance=200, floor_points=600,
             wall_points=400)


@pytest.mark.parametrize('R,stride,base_byte,P', [
    (0, 16, 0, 100),            # no masks
    (7, 40, 13, 301),           # a byte offset, P not a multiple of 8
    (33, 64, 0, 517)])
def test_unpack_masks_matches_jax_and_numpy(R, stride, base_byte, P):
    rng = np.random.default_rng(R + P)
    packed = rng.integers(0, 256, (R, stride), dtype=np.uint8)
    n_vox = (stride - base_byte) * 8 - 5
    v2p = rng.integers(0, n_vox, P).astype(np.int32)
    got = PN.native_unpack_masks(packed, base_byte, v2p)
    assert got.dtype == np.uint8 and got.shape == (R, P)
    want = JN.native_unpack_masks(packed, base_byte, v2p)
    assert want is not None, 'the JAX package could not build its C library'
    np.testing.assert_array_equal(got, want)
    lo = base_byte * 8
    plain = DP._unpack(packed, R, lo, lo + n_vox)[:, v2p]
    np.testing.assert_array_equal(got.view(np.bool_), plain)


def test_native_ops_reject_bad_shapes_and_indices():
    """Sizes and indices are checked before the C code reads memory."""
    packed = np.zeros((2, 4), np.uint8)
    for base, v2p in ((0, [0, 32]), (1, [24]), (0, [-1])):
        with pytest.raises(ValueError, match='out of the'):
            PN.native_unpack_masks(packed, base, np.array(v2p, np.int32))
    assert PN.native_unpack_masks(packed, 1, np.array([23])).shape == (2, 1)
    with pytest.raises(ValueError, match=r'\(P, 3\)'):
        PN.native_voxelize(np.zeros((5, 2), np.float32))


@pytest.mark.parametrize('cloud', ['uniform', 'scene'])
def test_native_voxelize_matches_jax(cloud):
    if cloud == 'uniform':
        pts = np.random.default_rng(0).uniform(0, 40, (6000, 3)).astype(
            np.float32)
    else:
        scene, _ = PSyn.make_scene(seed=3, **SCENE)
        pts = (scene['positions'] - min(0, scene['positions'].min())) / 0.02
    got, want = PN.native_voxelize(pts), JN.native_voxelize(pts)
    assert want is not None, 'the JAX package could not build its C library'
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    # unique voxels in np.unique order, the inverse map exact
    vox, inv = np.unique(np.round(pts.astype(np.float64)), axis=0,
                         return_inverse=True)
    np.testing.assert_array_equal(got[0], vox.astype(np.int32))
    np.testing.assert_array_equal(got[1], inv.reshape(-1))


@pytest.mark.parametrize('seg', [True, False])
def test_voxelize_scene_native_matches_jax_native(seg):
    extra = ['--do_segment_pooling'] if seg else []
    pc, jc = PC.get_config(ARGS + extra), JC.get_config(ARGS + extra)
    assert pc.use_native_host_ops and jc.use_native_host_ops
    for s in (3, 4):
        p = PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], pc)
        j = JV.voxelize_scene(JSyn.make_scene(seed=s, **SCENE)[0], jc)
        assert p['vox2point'].dtype == np.int32      # the C branch ran
        keys = set(j) - {'scene'}
        assert keys == set(p) - {'scene'}
        for k in keys:
            a, b = np.asarray(p[k]), np.asarray(j[k])
            assert a.dtype == b.dtype and a.shape == b.shape, k
            np.testing.assert_array_equal(a, b, err_msg=k)


def test_voxel_level_unpack_native_equals_numpy():
    """Without segment pooling the stacked readback holds voxel-level
    masks: the C unpack gives the NumPy plain version's results, on the
    stacked rows and on the full-width fallback of a top-k overflow."""
    pc = PC.get_config(ARGS)
    rets = [PV.voxelize_scene(PSyn.make_scene(seed=s, **SCENE)[0], pc)
            for s in (3, 4)]
    dev, host = PB.build_batch(rets, pc, mode='val')
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in dev.items()}
    rng = np.random.default_rng(0)
    S = dev['seg_valid'].shape[0]
    sem = np.full((S, 20), -5.0, np.float32)
    sem[np.arange(S), rng.integers(0, 20, S)] = 5.0
    pred = {'mlp_offsets': rng.normal(0, 0.05, (S, 3)),
            'mlp_bounds': rng.uniform(0.2, 0.8, (S, 3)),
            'mlp_bb_scores': rng.uniform(-2, 4, (S, 1)),
            'mlp_semantics': sem}
    pred = {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in pred.items()}
    ids, _, _, is_fg = PT.get_tables('scannet')
    ths = torch.tensor(pc.eval_ths, dtype=torch.float32)
    core = DP.make_core(pc, ids, is_fg, 64)
    post_full = DP.make_device_postproc(pc, ids, is_fg, 64)
    for top_k in (3, 64):
        out_np = {k: v.numpy() for k, v in DP.fused_postproc(
            core, pc, pred, tb, ths, top_k).items()}
        assert 'masks_packed' in out_np
        assert out_np['topk_overflow'].any() == (top_k == 3)
        res = [DP.stacked_masks_to_results(
            out_np, host, ids, post_fallback=post_full, pred=pred, dev_t=tb,
            ths=ths, native=native) for native in (True, False)]
        assert res[0].keys() == res[1].keys() == {
            s['name'] for s in host['scene']}
        for name, r in res[1].items():
            assert r['mask'].dtype == res[0][name]['mask'].dtype == bool
            assert len(r['conf']) > 0
            for k in ('conf', 'label_id', 'mask'):
                np.testing.assert_array_equal(res[0][name][k], r[k])


def test_library_lands_in_build_under_source_hash():
    PN.get_lib()
    so = PN.library_path()
    assert os.path.dirname(so) == PN.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == 'build'
    assert os.path.exists(so)
    assert re.fullmatch(r'libhostops_[0-9a-f]{12}\.so', os.path.basename(so))
    assert not os.path.exists(os.path.join(os.path.dirname(PN.SRC),
                                           'libhostops.so'))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """use_native_host_ops is on and the library cannot be built: the
    caller gets the compiler's error, never a quiet NumPy fallback."""
    src = tmp_path / 'hostops.c'
    src.write_text('int b2m_voxelize( {\n')
    monkeypatch.setattr(PN, 'SRC', str(src))
    monkeypatch.setattr(PN, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(PN, '_lib', None)
    with pytest.raises(RuntimeError, match='cc failed') as e:
        PN.native_voxelize(np.zeros((4, 3), np.float32))
    assert 'error' in str(e.value)
    with pytest.raises(RuntimeError, match='cc failed'):
        PV.voxelize_scene(PSyn.make_scene(seed=3, **SCENE)[0],
                          PC.get_config(ARGS))
