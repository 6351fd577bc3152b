"""Evaluation CLI of the port: ``python -m box2mask_torch.evaluate --config
configs/scannet.txt --fixed_seed 10``.

The counterpart of the root evaluate.py: a full validation eval by default
(the ScanNet AP table), the submission write-out under
--submission_write_out[_testset], and under --eval_training an eval of every
checkpoint of the experiment, its mAP scalars in
`<exp>/eval_training/metrics.jsonl`. Validation is evaluated WITH
augmentations under the fixed seed unless --eval_wo_aug (test-time
augmentation). It runs on the card; `BOX2MASK_PLATFORM=cpu` asks for the
CPU, and without CUDA and without that request it raises. Not ported yet:
--param_search (ROADMAP A10), --produce_visualizations and
--predict_specific_scene (A20).
"""

import os
import sys

from box2mask_torch.config import get_config
from box2mask_torch.datasets.loader import get_dataset
from box2mask_torch.engine.checkpoint import list_checkpoints
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.engine.train import ScalarLog
from box2mask_torch.runtime import resolve_device


def main(argv=None):
    cfg = get_config(argv)
    device = resolve_device(os.environ.get('BOX2MASK_PLATFORM') or None)
    if cfg.param_search:
        raise NotImplementedError('--param_search is not ported to '
                                  'box2mask_torch yet (ROADMAP A10)')
    if cfg.predict_specific_scene or cfg.produce_visualizations:
        raise NotImplementedError('visualizations are not ported to '
                                  'box2mask_torch yet (ROADMAP A20)')
    if cfg.submission_write_out or cfg.submission_write_out_testset:
        mode = 'test' if cfg.submission_write_out_testset else 'val'
        Evaluater(cfg, device=device).submission_write_out(
            get_dataset(cfg, mode, do_augmentations=not cfg.eval_wo_aug))
        return

    ds = get_dataset(cfg, 'val', do_augmentations=not cfg.eval_wo_aug)
    if cfg.eval_training:
        writer = ScalarLog(os.path.join(cfg.exp_path, 'eval_training',
                                        'metrics.jsonl'))
        for t, path in list_checkpoints(cfg.checkpoint_path):
            cfg.checkpoint = os.path.basename(path)[:-5]
            Evaluater(cfg, writer=writer, epoch=int(t // 3600),
                      device=device).eval(ds)
        return
    return Evaluater(cfg, device=device).eval(ds)


if __name__ == '__main__':
    main(sys.argv[1:])
