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
augmentation). It runs on the card; `BOX2MASK_PLATFORM=cpu` asks for the
CPU, and without CUDA and without that request it raises. Not ported yet:
--produce_visualizations and --predict_specific_scene (ROADMAP A20).

--spatial_shards D evaluates each ScanNet, synthetic or ARKitScenes scene
split over D ranks (engine/evaluate.py, parallel/spatial.py), spawned as
the train CLI's: one NCCL rank per card (raises when there are fewer than
D cards), or D gloo ranks on the CPU under `BOX2MASK_PLATFORM=cpu`; the
ranks take rank 0's seeds, so a scene augments alike on every rank, and
rank 0 prints and writes the results. The submission write-out and the
param search run on one device there, as the JAX package's do.
"""

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


def main(argv=None):
    argv = list(argv) if argv is not None else sys.argv[1:]
    cfg = get_config(argv)
    platform = os.environ.get('BOX2MASK_PLATFORM') or None
    if cfg.predict_specific_scene or cfg.produce_visualizations:
        raise NotImplementedError('visualizations are not ported to '
                                  'box2mask_torch yet (ROADMAP A20)')
    if (cfg.spatial_shards > 1 and cfg.dataset_name in SPATIAL_DATASETS
            and not (cfg.submission_write_out
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
    if cfg.submission_write_out or cfg.submission_write_out_testset:
        mode = 'test' if cfg.submission_write_out_testset else 'val'
        Evaluater(cfg, device=device, **ranks).submission_write_out(
            get_dataset(cfg, mode, do_augmentations=not cfg.eval_wo_aug))
        return

    ds = get_dataset(cfg, 'val', do_augmentations=not cfg.eval_wo_aug)
    if cfg.param_search:
        return Evaluater(cfg, device=device, **ranks).param_search(ds)
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
