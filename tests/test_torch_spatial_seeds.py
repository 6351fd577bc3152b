"""Every rank of a spatially sharded run builds the same scene: the ranks
take rank 0's seeds (parallel/mesh.agree_seeds) and each step checks that
they hold one scene (parallel/spatial.check_same_scene), on gloo ranks on
the CPU, with the synthetic preset under the ARKitScenes preset's
augmentations (rotation and scaling on every scene, so the voxel count
depends on the draw).

  * agree_seeds under --sample_fixed_seed (each rank's get_config draws its
    own) and without a seed (rank 0 draws the augmentations' seed); the
    first spatial batch passes the check on both ranks, batches drawn under
    per-rank seeds fail it.
  * `python -m box2mask_torch.train --spatial_shards 2` and `python -m
    box2mask_torch.evaluate --spatial_shards 2` (test-time augmentation)
    under BOX2MASK_PLATFORM=cpu with that preset and no --fixed_seed.
"""

import os

from test_torch_parallel_common import run_ranks
from test_torch_spatial_common import seeds_worker
from test_torch_spatial_engine import ROOT, cli
from test_torch_train_common import remove_tmp_path  # noqa: F401

AUGMENTING = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
              '--augmentation', '--rotation_aug', '1.0', '0.0', '0.9',
              '--scaling_aug', '1.0', '0.8', '1.2',
              '--dataset_size', '2', '--vox_bucket', '512',
              '--seg_bucket', '64', '--layers', '1', '--num_workers', '1',
              '--spatial_shards', '2', '--spatial_gather_level', '2']


def test_ranks_agree_on_seeds_and_scenes(tmp_path):
    res = run_ranks(seeds_worker, 2, tmp_path, AUGMENTING)
    r0, r1 = res
    assert r0['fixed'] == r1['fixed'] and r0['fixed'] is not None
    assert r0['augment'] is None and r1['augment'] is None
    assert r0['seed'] is None and r1['seed'] is None
    assert r0['augment_seed'] == r1['augment_seed'] is not None
    assert r0['voxels'] == r1['voxels']
    assert r0['voxels_own'] != r1['voxels_own']
    assert r0['refused'] and r1['refused']


def test_train_and_eval_cli_spatial_shards_without_seed(tmp_path):
    root = str(tmp_path)
    out = cli('box2mask_torch.train', AUGMENTING + ['--num_epochs', '1'],
              root)
    assert '2 ranks ended with equal parameters' in out
    out = cli('box2mask_torch.evaluate', AUGMENTING, root)
    assert out.count('average') == 1              # rank 0's AP table
