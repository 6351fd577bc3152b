"""Evaluation CLI of the port: ``python -m box2mask_torch.evaluate --config
configs/scannet.txt --fixed_seed 10``.

The counterpart of the root evaluate.py: a full validation eval by default
(the dataset's protocol: the ScanNet AP table, the ARKitScenes VOC mAP, the
S3DIS mPrecision / mRecall), the submission write-out under
--submission_write_out[_testset], the eval-threshold grid under
--param_search (`<results>/param_search.txt`), and under --eval_training an
eval of every checkpoint of the experiment, its mAP scalars in
`<exp>/eval_training/metrics.jsonl`. Validation is evaluated WITH
augmentations under the fixed seed unless --eval_wo_aug (test-time
augmentation). Under --produce_visualizations (the val split) or
--predict_specific_scene NAME (that one scene) it writes each scene's
visualizations into `<exp>/viz/<scene>/` (viz/export.py: rgb, gt_instances,
gt_semantics, pred_instances, pred_semantics and pred_bbs PLYs, bbs.npy,
viewer.html; with --mesh_viz two surface-mesh PLYs). It runs on the card;
`BOX2MASK_PLATFORM=cpu` asks for the CPU, and without CUDA and without that
request it raises.

--spatial_shards D evaluates each ScanNet, synthetic or ARKitScenes scene
split over D ranks (engine/evaluate.py, parallel/spatial.py), spawned as
the train CLI's: one NCCL rank per card (raises when there are fewer than
D cards), or D gloo ranks on the CPU under `BOX2MASK_PLATFORM=cpu`; the
ranks take rank 0's seeds, so a scene augments alike on every rank, and
rank 0 prints and writes the results. The visualizations, the submission
write-out and the param search run on one device there, as the JAX
package's do.
"""

import copy
import importlib
import os
import sys

from box2mask_torch.config import get_config
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine.checkpoint import list_checkpoints
from box2mask_torch.engine.evaluate import SPATIAL_DATASETS, Evaluater
from box2mask_torch.engine.train import ScalarLog
from box2mask_torch.parallel import mesh as M
from box2mask_torch.runtime import resolve_device
from box2mask_torch.viz.export import produce_visualizations


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    cfg = get_config(argv)
    platform = os.environ.get('BOX2MASK_PLATFORM') or None
    if (cfg.spatial_shards > 1 and cfg.dataset_name in SPATIAL_DATASETS
            and not (cfg.predict_specific_scene or cfg.produce_visualizations
                     or cfg.submission_write_out
                     or cfg.submission_write_out_testset
                     or cfg.param_search)):
        world = cfg.spatial_shards
        backend = M.ranks_backend(world, platform, '--spatial_shards')
        worker = importlib.import_module('box2mask_torch.evaluate').rank_main
        return M.spawn_ranks(worker, world, backend, argv, platform)
    return run(cfg, resolve_device(platform))


def rank_main(rank, world, backend, init_method, argv, platform):
    """One rank of a --spatial_shards evaluation."""
    device = resolve_device(M.rank_device(rank, world, platform))
    group = M.init_data_parallel(rank, world, backend, init_method, device,
                                 timeout=M.RANKS_TIMEOUT_S)
    try:
        cfg = M.agree_seeds(get_config(argv), group, device)
        run(cfg, device, rank=rank, world_size=world, group=group)
    finally:
        M.teardown()


def run(cfg, device, **ranks):
    """The evaluation `cfg` asks for, on `device` (under --spatial_shards
    as one of the ranks that `ranks` names)."""
    aug = not cfg.eval_wo_aug
    # the modes that run on one device read whole-scene batches, also under
    # --spatial_shards (the JAX CLI hands them the sharded batches there,
    # which the one-device net cannot read: ROADMAP section C)
    whole = copy.copy(cfg)
    whole.spatial_shards = 0
    if cfg.predict_specific_scene or cfg.produce_visualizations:
        mode = ('predict_specific_scene' if cfg.predict_specific_scene
                else 'val')
        return produce_visualizations(
            Evaluater(cfg, device=device, **ranks),
            get_dataset(whole, mode, do_augmentations=aug), cfg)
    if cfg.submission_write_out or cfg.submission_write_out_testset:
        mode = 'test' if cfg.submission_write_out_testset else 'val'
        Evaluater(cfg, device=device, **ranks).submission_write_out(
            get_dataset(whole, mode, do_augmentations=aug))
        return
    if cfg.param_search:
        return Evaluater(cfg, device=device, **ranks).param_search(
            get_dataset(whole, 'val', do_augmentations=aug))

    ds = get_dataset(cfg, 'val', do_augmentations=aug)
    if cfg.eval_training:
        writer = ScalarLog(os.path.join(cfg.exp_path, 'eval_training',
                                        'metrics.jsonl'))
        for t, path in list_checkpoints(cfg.checkpoint_path):
            cfg.checkpoint = os.path.basename(path)[:-5]
            Evaluater(cfg, writer=writer, epoch=int(t // 3600),
                      device=device, **ranks).eval(ds)
        return
    return Evaluater(cfg, device=device, **ranks).eval(ds)


if __name__ == '__main__':
    main(sys.argv[1:])
