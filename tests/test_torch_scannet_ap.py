"""The port's ScanNet AP protocol (box2mask_torch/metrics/scannet_ap.py)
against the JAX package's, on the same seeded results and GT: the AP
averages and the (class, overlap) AP array equal at rtol=0 (NaN where the
JAX package has NaN), the table strings equal, the PR curves equal; and the
ScanNet cases of tests/test_metrics.py on the port."""

import numpy as np
import pytest

from box2mask_tpu.metrics import scannet_ap as JAP
from box2mask_torch.metrics import scannet_ap as PAP


def random_scene(rng, n=3000):
    """GT of a few instances of valid and void classes (some under the
    100-point minimum) and predictions made from them: each a GT instance
    with points dropped and a random stretch added, labelled right or
    wrong, at random confidences with ties."""
    gt = np.zeros(n, np.int64)
    sems = [3, 4, 5, 5, 7, 14, 39, 1, 33]          # 1: void (wall)
    pos = 0
    for i, sem in enumerate(rng.choice(sems, 6)):
        cnt = int(rng.integers(60, 500))
        gt[pos:pos + cnt] = sem * 1000 + i + 1
        pos += cnt
    inst = [u for u in np.unique(gt) if u]
    n_pred = int(rng.integers(2, 12))
    masks = np.zeros((n_pred, n), bool)
    labels = np.zeros(n_pred, np.int64)
    for j in range(n_pred):
        u = inst[int(rng.integers(len(inst)))]
        masks[j] = (gt == u) & (rng.random(n) > rng.uniform(0, 0.6))
        a = int(rng.integers(0, n - 50))
        masks[j, a:a + int(rng.integers(0, 300))] = True
        labels[j] = u // 1000 if rng.random() < 0.7 else rng.choice(
            [3, 4, 5, 7, 14, 39, 2])
    conf = rng.choice([0.1, 0.5, 0.9, 0.95], n_pred) * rng.uniform(
        0.99, 1.0, n_pred)
    conf[::3] = 0.5                                  # score ties
    return {'conf': conf.astype(np.float32), 'label_id': labels,
            'mask': masks}, gt


def assert_same_protocol(results, gt):
    pa, pap, ppr = PAP.evaluate_scannet(results, gt)
    ja, jap, jpr = JAP.evaluate_scannet(results, gt)
    np.testing.assert_allclose(pap, jap, rtol=0, atol=0)     # NaN-aware
    for k in ('all_ap', 'all_ap_50%', 'all_ap_25%'):
        np.testing.assert_allclose(pa[k], ja[k], rtol=0, atol=0)
    assert pa['classes'].keys() == ja['classes'].keys()
    for name, c in ja['classes'].items():
        for k, v in c.items():
            np.testing.assert_allclose(pa['classes'][name][k], v, rtol=0,
                                       atol=0)
    assert PAP.format_results_table(pa) == JAP.format_results_table(ja)
    assert ppr.keys() == jpr.keys()
    for th in jpr:
        assert ppr[th].keys() == jpr[th].keys()
        for label, (prec, rec) in jpr[th].items():
            np.testing.assert_array_equal(ppr[th][label][0], prec)
            np.testing.assert_array_equal(ppr[th][label][1], rec)
    return pa


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_evaluate_scannet_matches_jax(seed):
    rng = np.random.default_rng(seed)
    results, gt = {}, {}
    for i in range(4):
        results[f'scene{i:04d}_00'], gt[f'scene{i:04d}_00'] = random_scene(
            rng)
    avgs = assert_same_protocol(results, gt)
    assert 0 < avgs['all_ap_50%'] < 1 and 0 < avgs['all_ap_25%'] < 1
    ids = np.array([1, 2, 3, 1002, 5007])
    np.testing.assert_array_equal(PAP.encode_gt_ids(ids % 1000, ids // 1000),
                                  JAP.encode_gt_ids(ids % 1000, ids // 1000))


def make_gt(n=1000, inst_specs=((3, 1, 300), (5, 2, 300))):
    """gt ids with instances (sem, inst, npts) and background elsewhere."""
    ids = np.zeros(n, np.int64)
    pos = 0
    for sem, inst, cnt in inst_specs:
        ids[pos:pos + cnt] = sem * 1000 + inst
        pos += cnt
    return ids


def perfect_pred(gt_ids):
    uniq = [u for u in np.unique(gt_ids) if u >= 1000]
    return {'conf': np.ones(len(uniq)) * 0.9,
            'label_id': np.array([u // 1000 for u in uniq]),
            'mask': np.stack([gt_ids == u for u in uniq])}


def case_perfect():
    gt = make_gt()
    avgs = assert_same_protocol({'scene0000_00': perfect_pred(gt)},
                                {'scene0000_00': gt})
    assert np.isclose(avgs['all_ap_50%'], 1.0)
    assert np.isclose(avgs['all_ap'], 1.0)
    assert np.isclose(avgs['classes']['cabinet']['ap50%'], 1.0)


def case_missing_instance():
    gt = make_gt(inst_specs=((3, 1, 300), (3, 2, 300)))
    pred = {k: v[:1] for k, v in perfect_pred(gt).items()}
    avgs = assert_same_protocol({'s': pred}, {'s': gt})
    assert 0.4 < avgs['classes']['cabinet']['ap50%'] < 0.6


def case_false_positive_penalized():
    gt = make_gt(inst_specs=((3, 1, 300),))
    fp_mask = np.zeros(len(gt), bool)
    fp_mask[600:800] = True
    pred_fp = {'conf': np.array([0.9, 0.95]), 'label_id': np.array([3, 3]),
               'mask': np.stack([perfect_pred(gt)['mask'][0], fp_mask])}
    avgs = assert_same_protocol({'s': pred_fp}, {'s': gt})   # FP on void
    assert np.isclose(avgs['classes']['cabinet']['ap50%'], 1.0)
    gt3 = gt.copy()
    gt3[600:800] = 4 * 1000 + 7          # the FP region is now a bed
    avgs3 = assert_same_protocol({'s': pred_fp}, {'s': gt3})
    assert avgs3['classes']['cabinet']['ap50%'] < 1.0


def case_min_region_size():
    gt = make_gt(inst_specs=((3, 1, 50),))          # below 100 points
    avgs = assert_same_protocol({'s': perfect_pred(gt)}, {'s': gt})
    assert np.isnan(avgs['all_ap_50%'])


@pytest.mark.parametrize('case', [case_perfect, case_missing_instance,
                                  case_false_positive_penalized,
                                  case_min_region_size],
                         ids=lambda f: f.__name__[5:])
def test_scannet_cases(case):
    case()
