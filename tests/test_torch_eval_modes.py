"""The port's ARKitScenes and S3DIS evaluation, its non-fused path, the
param search and their host parts against the JAX package.

Units (NumPy on both sides, the same inputs): the box geometry, the VOC
detection AP, the S3DIS metrics and precision / recall at rtol 0; the host
oracle detection_to_masks on both head branches and the device route of
pred_entries_to_results against the JAX make_device_postproc (masks and
labels equal, conf within 1e-5); the port's DBSCAN against scikit-learn's
labels (this file imports scikit-learn; the port does not).

Whole protocols: the port's Evaluater and the JAX Evaluater on the same
small on-disk datasets (datasets/fixtures.py) and the same weights, a JAX
init copied across (convert.from_flax). Both forwards run unrounded
(--compute_dtype float32; the port's key conv with f32 operands), so they
differ only in the order of f32 sums (1e-5 of max |head|,
tests/test_torch_forward.py) and every threshold decision is the same. The
JAX Evaluater runs its fused pipeline under B2M_FUSED_EVAL=1 and its
non-fused route under B2M_FUSED_EVAL=0, as its own tests run them.
"""

import os
import subprocess
import sys
import types
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from sklearn.cluster import DBSCAN

from box2mask_tpu import config as JC
from box2mask_tpu.datasets.loader import get_dataset as jax_get_dataset
from box2mask_tpu.datasets.tables import get_tables
from box2mask_tpu.engine import state as JS
from box2mask_tpu.engine.evaluate import Evaluater as JaxEvaluater
from box2mask_tpu.metrics import box3d as JB3
from box2mask_tpu.metrics import detection_ap as JDA
from box2mask_tpu.metrics import prec_recall as JPR
from box2mask_tpu.metrics import s3dis_metrics as JSM
from box2mask_tpu.postprocess import detection2mask as JD2M
from box2mask_tpu.postprocess import device_post as JDP
from box2mask_tpu.postprocess import iou as JI
from box2mask_tpu.postprocess import nms as JN
from box2mask_tpu.postprocess import s3dis_background as JBG
from box2mask_torch import config as PC
from box2mask_torch.convert import from_flax
from box2mask_torch.datasets import fixtures as F
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine import state as S
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.metrics import box3d as PB3
from box2mask_torch.metrics import detection_ap as PDA
from box2mask_torch.metrics import prec_recall as PPR
from box2mask_torch.metrics import s3dis_metrics as PSM
from box2mask_torch.postprocess import detection2mask as PD2M
from box2mask_torch.postprocess import iou as PI
from box2mask_torch.postprocess import nms as PN
from box2mask_torch.postprocess import s3dis_background as PBG
from box2mask_torch.sparse import key_conv as KC

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = {'scannet': 'scannet.txt', 'arkitscenes': 'arkitscenes.txt',
           's3dis': 's3dis_fold5.txt'}
COMMON = ['--voxel_size', '0.05', '--vox_bucket', '512', '--seg_bucket',
          '64', '--layers', '1', '--fixed_seed', '3', '--eval_batch_size',
          '2', '--compute_dtype', 'float32', '--num_workers', '2',
          '--eval_wo_aug']
GRID = ['--cluster_th_search', '0.4', '0.5', '2', '--score_th_search',
        '0.05', '0.05', '1', '--mask_bin_th_search', '0.3', '0.3', '1',
        '--mask_nms_th_search', '0.5', '0.6', '2']


# ------------------------------------------------------------------ units
def assert_same_results(got, want):
    """Per scene: the same masks and label ids, conf within 1e-5."""
    assert sorted(got) == sorted(want)
    n = 0
    for name, w in want.items():
        g = got[name]
        assert len(g['conf']) == len(w['conf']), name
        np.testing.assert_array_equal(g['label_id'], w['label_id'])
        np.testing.assert_array_equal(np.asarray(g['mask']),
                                      np.asarray(w['mask']))
        np.testing.assert_allclose(g['conf'], w['conf'], rtol=0, atol=1e-5)
        n += len(w['conf'])
    return n


def random_obbs(rng, n):
    out = []
    for _ in range(n):
        c, s = np.cos(rng.uniform(0, np.pi)), np.sin(rng.uniform(0, np.pi))
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        out.append(JB3.oriented_corners(rng.uniform(0.2, 1.0, 3), rot,
                                        rng.uniform(-1, 1, 3)))
    return out


def test_box3d_matches_jax():
    rng = np.random.default_rng(0)
    boxes = random_obbs(rng, 12)
    for a in boxes:
        for b in boxes:
            assert PB3.hull_box_iou(a, b) == JB3.hull_box_iou(a, b)
    for _ in range(20):
        args = (rng.uniform(0.2, 2, 3), rng.uniform(0, np.pi),
                rng.uniform(-1, 1, 3))
        c1, c2 = PB3.get_3d_box(*args), JB3.get_3d_box(*args)
        np.testing.assert_array_equal(c1, c2)
        other = JB3.get_3d_box(rng.uniform(0.2, 2, 3), rng.uniform(0, 3),
                               rng.uniform(-1, 1, 3))
        assert PB3.box3d_iou(c1, other) == JB3.box3d_iou(c1, other)
        rot = JB3.rotz(rng.uniform(0, 3))
        np.testing.assert_array_equal(
            PB3.rotated_bounds(args[0], rot), JB3.rotated_bounds(args[0], rot))
        np.testing.assert_array_equal(
            PB3.corners_from_rotation(args[2], args[0], rot),
            JB3.corners_from_rotation(args[2], args[0], rot))
        ab = ((rng.uniform(-1, 1, 3), rng.uniform(0.1, 1, 3)),
              (rng.uniform(-1, 1, 3), rng.uniform(0.1, 1, 3)))
        assert PB3.aabb_iou_cs(*ab) == JB3.aabb_iou_cs(*ab)


@pytest.mark.parametrize('iou', ['hull', 'aabb'])
def test_eval_det_matches_jax(iou):
    """VOC AP per class (3 classes, 6 scenes, some classes without
    predictions in some scenes) at rtol 0, for both IoU functions the
    ARKitScenes eval uses."""
    rng = np.random.default_rng(1)
    pred, gt = {}, {}
    for s in range(6):
        gts, preds = [], []
        for _ in range(rng.integers(1, 5)):
            cls = int(rng.integers(3))
            box = random_obbs(rng, 1)[0]
            gts.append([cls, box])
            if rng.random() < 0.7:
                jit = box + rng.normal(0, 0.05, box.shape)
                if iou == 'aabb':
                    jit = np.concatenate([jit.mean(0), np.ptp(jit, 0)])
                preds.append([cls, jit, float(rng.random())])
        if iou == 'aabb':
            gts = [[c, np.concatenate([b.mean(0), np.ptp(b, 0)])]
                   for c, b in gts]
        gt[f's{s}'], pred[f's{s}'] = gts, preds
    fn = {'hull': (lambda a, b: PB3.hull_box_iou(a, b)[0],
                   lambda a, b: JB3.hull_box_iou(a, b)[0]),
          'aabb': (PB3.aabb_iou_cs, JB3.aabb_iou_cs)}[iou]
    got = PDA.eval_det(pred, gt, ovthresh=0.25, get_iou_func=fn[0])
    want = JDA.eval_det(pred, gt, ovthresh=0.25, get_iou_func=fn[1])
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0)
    assert max(want[2].values()) > 0
    rec, prec = np.linspace(0, 1, 9), rng.random(9)
    for m in (False, True):
        assert PDA.voc_ap(rec, prec, m) == JDA.voc_ap(rec, prec, m)


def test_s3dis_metrics_and_prec_recall_match_jax():
    rng = np.random.default_rng(2)
    rooms_p, rooms_g = [], []
    for _ in range(3):
        n = 3000
        g_ins = rng.integers(-1, 12, n)
        g_sem = (np.arange(13)[rng.integers(0, 13, 12)])[np.maximum(g_ins,
                                                                    0)]
        p_ins = np.where(rng.random(n) < 0.8, g_ins, rng.integers(-1, 12, n))
        p_sem = np.where(rng.random(n) < 0.9, g_sem, rng.integers(0, 13, n))
        rooms_p.append({'instances': p_ins, 'semantics': p_sem})
        rooms_g.append({'instances': g_ins, 'semantics': g_sem})
    got = PSM.evaluate_s3dis(rooms_p, rooms_g)
    want = JSM.evaluate_s3dis(rooms_p, rooms_g)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0)
    assert want['mPrecision'] > 0.1 and want['mRecall'] > 0.1

    boxes = [[(rng.uniform(-1, 1, 3), rng.uniform(0.2, 1, 3))
              for _ in range(rng.integers(0, 6))] for _ in range(5)]
    preds = [[(c + rng.normal(0, 0.05, 3), s) for c, s in b] + [
        (rng.uniform(-1, 1, 3), rng.uniform(0.2, 1, 3))] for b in boxes]
    for p, g in zip(preds, boxes):
        assert PPR.scene_precision_recall(p, g) == \
            JPR.scene_precision_recall(p, g)
    assert PPR.dataset_precision_recall(preds, boxes) == \
        JPR.dataset_precision_recall(preds, boxes)


@pytest.mark.parametrize('seed', [0, 1])
def test_host_iou_and_nms_match_jax(seed):
    """The host oracle's NumPy IoU and NMS: box and mask IoUs, the vote
    parametrisation, NMS clustering on its IoU matrix and on lazy rows,
    and both greedy mask NMS forms, equal to the JAX package's."""
    rng = np.random.default_rng(seed)
    n = 300
    lo = rng.uniform(0, 4, (n, 3))
    boxes = np.concatenate([lo, lo + rng.uniform(0.1, 1.5, (n, 3))], 1)
    scored = np.concatenate([rng.random((n, 1)), boxes], 1)
    np.testing.assert_array_equal(PI.set_ious_np(boxes, boxes[::-1]),
                                  JI.set_ious_np(boxes, boxes[::-1]))
    np.testing.assert_array_equal(PI.one_vs_all_ious_np(boxes[3], boxes),
                                  JI.one_vs_all_ious_np(boxes[3], boxes))
    loc, off, bnd = rng.normal(size=(3, n, 3))
    sc = rng.random(n)
    for s in (None, sc):
        np.testing.assert_array_equal(PI.to_bbs_min_max_np(loc, off, bnd, s),
                                      JI.to_bbs_min_max_np(loc, off, bnd, s))
    for thr in (4000, 0):                     # IoU matrix, lazy rows
        got = PN.nms_clustering_np(scored, 0.3, matrix_threshold=thr)
        want = JN.nms_clustering_np(scored, 0.3, matrix_threshold=thr)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])
        assert all(np.array_equal(a, b) for a, b in zip(got[1], want[1]))
        assert len(want[0]) > 10
    masks = rng.random((40, 500)) < rng.uniform(0.05, 0.5, (40, 1))
    masks[7] = False                           # an empty mask
    for pair in ((PN.mask_nms_matrix(masks, 0.3),
                  JN.mask_nms_matrix(masks, 0.3)),
                 (PN.mask_nms_np(masks, 0.3, allow_empty=True),
                  JN.mask_nms_np(masks, 0.3, allow_empty=True))):
        (gk, gs), (wk, ws) = pair
        np.testing.assert_array_equal(gk, wk)
        assert [(t, list(r)) for t, r in gs] == [(t, list(r)) for t, r in ws]
    for empty in (True, False):
        m = masks[8:] if not empty else masks
        np.testing.assert_array_equal(
            PI.masks_iou_np(masks[0], m, allow_empty=empty),
            JI.masks_iou_np(masks[0], m, allow_empty=empty))


def dbscan_inputs(seed):
    """Blobs in 6-D, noise, and two exact-distance cases: a border point at
    exactly eps from the edge cores of two clusters, and a chain of points
    at exactly eps apart (eps 0.5, coordinates on the 0.25 grid)."""
    rng = np.random.default_rng(seed)
    blobs = [rng.normal(rng.uniform(-4, 4, 6), rng.uniform(0.1, 0.4),
                        (int(rng.integers(30, 300)), 6)) for _ in range(4)]
    noise = rng.uniform(-5, 5, (int(rng.integers(20, 200)), 6))
    grid_a = np.zeros((5, 6))
    grid_a[:, 0] = 20 + 0.25 * np.arange(5)            # core run, x 20..21
    grid_b = grid_a.copy()
    grid_b[:, 0] += 2.0                                 # x 22..23
    bridge = np.zeros((1, 6))
    bridge[0, 0] = 21.5                  # 0.5 from x 21 and from x 22
    chain = np.zeros((6, 6))
    chain[:, 1] = 30 + 0.5 * np.arange(6)
    x = np.concatenate([*blobs, noise, grid_b, bridge, grid_a, chain])
    return x[rng.permutation(len(x))] if seed % 2 else x


@pytest.mark.parametrize('seed', range(6))
def test_dbscan_labels_equal_sklearn(seed):
    x = dbscan_inputs(seed)
    n_clusters = []
    for eps, ms in ((0.5, 3), (0.5, 5), (0.35, 10), (0.9, 4)):
        want = DBSCAN(eps=eps, min_samples=ms).fit(x).labels_
        got = PBG.dbscan(x, eps, ms)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        n_clusters.append(want.max() + 1)
    assert max(n_clusters) >= 3


def test_clustering_for_background_matches_jax():
    """Walls of > 3000 points survive the DBSCAN; ceiling and floor are one
    instance each; proposals take their majority class."""
    rng = np.random.default_rng(3)
    n = 14000
    coords = np.zeros((n, 3))
    sem = rng.integers(0, 13, n)
    wall = np.zeros(n, bool)
    wall[:9000] = True
    sem[wall] = 2
    sem[~wall & (sem == 2)] = 5
    coords[:4500] = np.stack([np.zeros(4500), rng.uniform(0, 4, 4500),
                              rng.uniform(0, 3, 4500)], 1)
    coords[4500:9000] = np.stack([rng.uniform(0, 4, 4500), np.full(4500, 5.0),
                                  rng.uniform(0, 3, 4500)], 1)
    coords[9000:] = rng.uniform(0, 5, (n - 9000, 3))
    normals = np.zeros((n, 3))
    normals[:4500, 0] = 1
    normals[4500:, 1] = 1
    got = PBG.clustering_for_background(sem, coords, normals)
    want = JBG.clustering_for_background(sem, coords, normals)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and len(np.unique(got[wall])) == 2
    masks = rng.random((6, n)) < 0.3
    np.testing.assert_array_equal(
        PBG.assign_semantics_to_proposals(sem, masks),
        JBG.assign_semantics_to_proposals(sem, masks))


# -------------------------------------------------------- whole protocols
@pytest.fixture(scope='module')
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp('eval_modes')
    dirs = {k: str(root / k) for k in PRESETS}
    os.makedirs(dirs['scannet'])
    split = F.write_scannet(dirs['scannet'], ['scene0000_00',
                                              'scene0001_00'],
                            n_vertices=6000, n_objects=5, seed=11)
    F.write_arkitscenes(dirs['arkitscenes'], ['41000001', '41000002'],
                        'Validation', n_vertices=9000, n_objects=5, seed=12)
    F.write_s3dis(dirs['s3dis'], ['Area_5.office_1', 'Area_5.office_2'],
                  n_points=40000, n_objects=5, seed=13)
    return types.SimpleNamespace(root=str(root), dirs=dirs, split=split)


def preset_args(data, dataset, extra=()):
    return (['--config', os.path.join(ROOT, 'configs', PRESETS[dataset]),
             '--data_dir', data.dirs[dataset], '--data_split', data.split,
             '--exp_name', f'modes_{dataset}'] + COMMON + list(extra))


def configs(data, dataset, extra=()):
    """(port cfg, JAX cfg), f32 activations (the ScanNet preset's
    --bf16_acts off), experiments under root/port and root/jax."""
    args = preset_args(data, dataset, extra)
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(data.root, 'port')
    pc = PC.get_config(args)
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(data.root, 'jax')
    jc = JC.get_config(args)
    pc.bf16_acts = jc.bf16_acts = False
    pc.use_native_host_ops = jc.use_native_host_ops = False
    return pc, jc


@pytest.fixture(scope='module')
def env(data):
    """The port's key convs with unrounded f32 operands, for the module;
    the environment restored after it."""
    saved = {k: os.environ.get(k) for k in ('BOX2MASK_EXP_ROOT',
                                            'B2M_FUSED_EVAL')}
    mp = pytest.MonkeyPatch()

    def conv(x, kin, kout, w, **kw):
        return KC.key_conv_plain(x, kin, kout, w,
                                 operand_dtype=torch.float32, **kw)
    mp.setattr(KC, 'key_conv', conv)
    mp.setattr(KC, 'key_conv_stem', lambda x, kin, w: conv(
        x, kin, kin.reshape(-1), w, kernel_size=5, out_dtype=torch.float32))
    yield data
    mp.undo()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


_WEIGHTS = {}


def evaluaters(data, dataset, extra=()):
    """A port and a JAX Evaluater on the same JAX init (one per dataset
    and set of heads), with the datasets they evaluate ('val', no
    augmentation)."""
    pc, jc = configs(data, dataset, extra)
    jds = jax_get_dataset(jc, 'val', do_augmentations=False)
    pds = get_dataset(pc, 'val', do_augmentations=False)
    n_cls = len(get_tables(dataset)[0])
    key = (dataset, tuple(jc.network_heads))
    if key not in _WEIGHTS:
        dev_np, _ = next(iter(jds.get_loader(shuffle=False, drop_last=False,
                                             batch_size=1)))
        v = JS.init_variables(JS.build_model(jc, n_cls),
                              {k: jnp.asarray(a) for k, a in dev_np.items()})
        params = jax.tree_util.tree_map(np.array, v['params'])
        # votes near their segments and boxes of ~2 m half-size, so the
        # clusters merge (random heads leave hundreds of masks per scene)
        for head, scale, bias in (('mlp_offsets', 0.1, 0.0),
                                  ('mlp_bounds', 0.1, 2.0)):
            lin = params[head]['Linear1x1_2']
            lin['kernel'] = (lin['kernel'] * scale).astype(np.float32)
            lin['bias'] = np.full_like(lin['bias'], bias)
        _WEIGHTS[key] = (params, jax.tree_util.tree_map(
            np.array, v['batch_stats']))
    params, stats = _WEIGHTS[key]
    jev = JaxEvaluater(jc, state=types.SimpleNamespace(params=params,
                                                       batch_stats=stats))
    state = S.init_state(pc, S.build_model(pc, n_cls, 'cpu'),
                         S.make_optimizer(pc))
    state.model.load_state_dict(from_flax(params, stats))
    pev = Evaluater(pc, state=state)
    return pev, jev, pds, jds


def quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return fn(*a, **kw)


def test_scannet_eval_over_the_reader_matches_jax(env, monkeypatch):
    monkeypatch.setenv('B2M_FUSED_EVAL', '1')
    pev, jev, pds, jds = evaluaters(env, 'scannet')
    pres, pent = quiet(pev.fused_dataset_results, pds)
    jres, jent = quiet(jev.fused_dataset_results, jds)
    assert assert_same_results(pres, jres) > 4
    pa, ja = quiet(pev.eval, pds), quiet(jev.eval, jds)
    for k in ('all_ap', 'all_ap_50%', 'all_ap_25%'):
        np.testing.assert_allclose(pa[k], ja[k], rtol=0)


def test_arkitscenes_eval_matches_jax(env, monkeypatch):
    """The fused route (as in the JAX package) and the VOC mAP on
    ConvexHull boxes against the annotations' oriented boxes."""
    monkeypatch.setenv('B2M_FUSED_EVAL', '1')
    pev, jev, pds, jds = evaluaters(env, 'arkitscenes')
    assert pev._use_fused()
    pres, _ = quiet(pev.fused_dataset_results, pds)
    jres, _ = quiet(jev.fused_dataset_results, jds)
    assert assert_same_results(pres, jres) > 4
    pm, jm = quiet(pev.eval, pds), quiet(jev.eval, jds)
    assert isinstance(pm, float) and pm == jm


@pytest.fixture(scope='module')
def s3dis_run(env):
    """Both packages' raw predictions on the S3DIS rooms: the port's
    non-fused route, the JAX package's under B2M_FUSED_EVAL=0."""
    mp = pytest.MonkeyPatch()
    mp.setenv('B2M_FUSED_EVAL', '0')
    pev, jev, pds, jds = evaluaters(env, 's3dis')
    pent = quiet(pev.load_or_predict, pds)
    jent = quiet(jev.load_or_predict, jds)
    mp.undo()
    return types.SimpleNamespace(pev=pev, jev=jev, pds=pds, jds=jds,
                                 pent=pent, jent=jent)


@pytest.mark.parametrize('full_resolution', [False, True])
def test_s3dis_eval_matches_jax(s3dis_run, full_resolution):
    """mPrecision, mRecall and every other output of the S3DIS protocol at
    rtol 0, on the rooms' [::4] points and upsampled to every point
    (--full_resolution, 1-NN)."""
    r = s3dis_run
    assert not r.pev._use_fused()
    for ev in (r.pev, r.jev):
        ev.cfg.full_resolution = full_resolution
    got = quiet(r.pev.eval, r.pds)
    want = quiet(r.jev.s3dis_eval, r.jent)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0)
    assert want['semantic_acc'] > 0


def test_host_oracle_matches_jax_both_branches(s3dis_run, env, monkeypatch):
    """detection_to_masks on the same raw predictions: the per-voxel
    semantics branch (S3DIS heads, no mask NMS) and the semantics-head
    branch (ScanNet heads)."""
    monkeypatch.setenv('B2M_FUSED_EVAL', '0')
    r = s3dis_run
    for (pred, dev, host), (jp, _, _) in zip(r.pent, r.jent):
        np.testing.assert_allclose(
            pred['mlp_per_vox_semantics'], jp['mlp_per_vox_semantics'],
            rtol=0, atol=1e-4 * np.abs(jp['mlp_per_vox_semantics']).max())
    n = 0
    for pred, dev, host in r.pent:
        args = (pred, dev, host, r.pev.cfg, r.pev.valid_class_ids,
                r.pev.is_foreground)
        n += assert_same_results(PD2M.detection_to_masks(*args),
                                 JD2M.detection_to_masks(*args))
    pev, jev, pds, _ = evaluaters(env, 'scannet')
    entries = quiet(pev.dataset_prediction, pds, batch_size=2, cache=False)
    for pred, dev, host in entries:
        args = (pred, dev, host, pev.cfg, pev.valid_class_ids,
                pev.is_foreground)
        for ths in (None, (0.3, 0.1, 0.2, 0.5)):
            n += assert_same_results(
                PD2M.detection_to_masks(*args, ths=ths),
                JD2M.detection_to_masks(*args, ths=ths))
    assert n > 10


def test_device_route_matches_jax_device_postproc(env):
    """The device route of pred_entries_to_results (make_device_postproc
    and device_masks_to_results, here on the CPU) on raw predictions of a
    batch of 2 against the JAX make_device_postproc, and both against the
    host oracle on the same entries."""
    pev, jev, pds, _ = evaluaters(env, 'scannet')
    entries = quiet(pev.dataset_prediction, pds, batch_size=2, cache=False)
    assert len(entries) == 1 and len(entries[0][2]['scene']) == 2
    post = JDP.make_device_postproc(jev.cfg, jev.valid_class_ids,
                                    jev.is_foreground)
    for ths in (pev.cfg.eval_ths, (0.3, 0.1, 0.2, 0.5)):
        got = quiet(pev.device_entries_to_results, entries, ths)
        want = {}
        for pred, dev, host in entries:
            pj = {k: jnp.asarray(v) for k, v in pred.items()}
            dj = {k: jnp.asarray(v) for k, v in dev.items()}
            for si in range(len(host['scene'])):
                out = post(pj, dj, jnp.int32(si),
                           jnp.asarray(ths, jnp.float32))
                want.update(JDP.device_masks_to_results(
                    out, dev, host, jev.valid_class_ids, si))
        assert assert_same_results(got, want) > 4
        assert_same_results(got, pev.pred_entries_to_results(entries, ths))


def test_param_search_writes_jax_lines(env, monkeypatch):
    monkeypatch.setenv('B2M_FUSED_EVAL', '0')
    pev, jev, pds, jds = evaluaters(env, 'scannet', GRID)
    pbest = quiet(pev.param_search, pds)
    jbest = quiet(jev.param_search, jds)
    lines = []
    for ev in (pev, jev):
        with open(os.path.join(ev.results_path, 'param_search.txt')) as f:
            lines.append(f.read().splitlines())
    assert len(lines[1]) == 5 and lines[0] == lines[1]
    assert pbest == jbest


def test_s3dis_fused_route_with_both_semantics_heads(env, monkeypatch):
    """With the semantics head beside the per-voxel one, S3DIS rides the
    fused pipeline in both packages: the u8 per-voxel semantics plane of
    the stacked readback (from the pipeline and from its cache) and the
    protocol's outputs equal the JAX package's."""
    monkeypatch.setenv('B2M_FUSED_EVAL', '1')
    heads = ['--network_heads', 'mlp_offsets', 'mlp_bounds', 'mlp_bb_scores',
             'mlp_semantics', 'mlp_per_vox_semantics',
             '--loss_weight_semantics', '1', '--exp_name', 'modes_s3dis_fused']
    pev, jev, pds, jds = evaluaters(env, 's3dis', heads)
    assert pev._use_fused() and jev._use_fused(jds)
    for cached in (False, True):
        pres, _ = quiet(pev.fused_dataset_results, pds)
        jres, _ = quiet(jev.fused_dataset_results, jds)
        assert assert_same_results(pres, jres) > 0
        assert pev._vox_sem.keys() == jev._vox_sem.keys() and pev._vox_sem
        for name, v in jev._vox_sem.items():
            assert pev._vox_sem[name].dtype == np.uint8
            np.testing.assert_array_equal(pev._vox_sem[name], v)
    got, want = quiet(pev.eval, pds), quiet(jev.eval, jds)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0)


def test_s3dis_submission_matches_jax(s3dis_run, tmp_path, monkeypatch):
    """The submission write-out on the non-fused route: the same mask
    files, and per scene the same mask names and labels, conf within the
    1e-4 of its four printed decimals."""
    monkeypatch.setenv('B2M_FUSED_EVAL', '0')
    r = s3dis_run
    pdir = quiet(r.pev.submission_write_out, r.pds, str(tmp_path / 'p'))
    jdir = quiet(r.jev.submission_write_out, r.jds, str(tmp_path / 'j'))

    def files(d):
        out = {}
        for root, _, fs in os.walk(d):
            for f in fs:
                with open(os.path.join(root, f)) as fh:
                    out[os.path.relpath(os.path.join(root, f), d)] = \
                        fh.read().split()
        return out
    got, want = files(pdir), files(jdir)
    assert got.keys() == want.keys() and len(want) > 2
    for rel, w in want.items():
        g = got[rel]
        if rel.startswith('predicted_masks'):
            assert g == w, rel
        else:                           # mask file, label id, conf
            assert g[0::3] == w[0::3] and g[1::3] == w[1::3], rel
            np.testing.assert_allclose(np.float64(g[2::3]),
                                       np.float64(w[2::3]), atol=1e-4)


def test_reference_fused_s3dis_keyerror_not_copied(s3dis_run, monkeypatch):
    """The JAX package sends the shipped S3DIS heads (no mlp_semantics)
    down its fused path, which reads that head and raises KeyError; the
    port's eval on the same config takes the non-fused route and returns
    the JAX non-fused s3dis_eval."""
    r = s3dis_run
    monkeypatch.setenv('B2M_FUSED_EVAL', '1')
    assert 'mlp_semantics' not in r.jev.cfg.network_heads
    assert r.jev._use_fused(r.jds)
    with pytest.raises(KeyError, match='mlp_semantics'):
        quiet(r.jev.fused_dataset_results, r.jds, cache=False)
    for ev in (r.pev, r.jev):
        ev.cfg.full_resolution = False
    got = quiet(r.pev.eval, r.pds)
    want = quiet(r.jev.s3dis_eval, r.jent)
    for k in ('mPrecision', 'mRecall', 'semantic_acc'):
        np.testing.assert_allclose(got[k], want[k], rtol=0)


def test_cli_runs_each_dataset_on_the_cpu(env, tmp_path):
    """`python -m box2mask_torch.evaluate` with BOX2MASK_PLATFORM=cpu on
    each dataset preset over the on-disk datasets: the protocol's lines."""
    run_env = dict(os.environ, BOX2MASK_PLATFORM='cpu', OMP_NUM_THREADS='1',
                   BOX2MASK_EXP_ROOT=str(tmp_path))
    run_env.pop('B2M_FUSED_EVAL', None)
    procs = {d: subprocess.Popen(
        [sys.executable, '-m', 'box2mask_torch.evaluate']
        + preset_args(env, d), cwd=ROOT, env=run_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for d in PRESETS}
    want = {'scannet': 'class       AP     AP50     AP25',
            'arkitscenes': 'mAP:', 's3dis': 'mean Recall'}
    for d, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        assert 'evaluating the untrained model' in out and want[d] in out
