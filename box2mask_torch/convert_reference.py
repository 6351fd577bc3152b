"""Convert a reference (PyTorch + MinkowskiEngine) Box2Mask checkpoint into a
checkpoint of the port: ``python -m box2mask_torch.convert_reference
--config configs/scannet.txt --torch_ckpt X.tar|X.npz [--out_dir D]
[--layers L]`` (the counterpart of scripts/convert_torch_ckpt.py, without
JAX).

The torch state_dict maps onto the flax-layout trees (convert.py
convert_state_dict: the names, the ME x-fastest -> z-fastest kernel-row
permutation), those onto the port's state_dict (convert.from_flax), and the
result is checked against the port model's parameter names and shapes:
model entries the checkpoint does not cover keep their seeded init (a
WARNING names them), converted entries the model lacks (heads the config
does not have) are left out (a NOTE names them). The checkpoint is written
with engine/checkpoint.py save_checkpoint into the experiment's checkpoint
folder (or --out_dir), with a fresh optimizer state and step 0, named by
the payload's `training_time` (else the number in the file name), with the
payload's `epoch` and `iteration_num`; `python -m box2mask_torch.train`
and `python -m box2mask_torch.evaluate` resume from it as from their own.

A `.tar` is read with torch.load(weights_only=False): the reference's
payload is a pickled dict holding more than tensors, and unpickling runs
its code, so convert only a checkpoint you trust. The released checkpoint
(the reference's README) is not part of this repository. The model is
built on the card unless BOX2MASK_PLATFORM=cpu asks for the CPU.
"""

import argparse
import os
import re
import sys

import numpy as np

from box2mask_torch import convert
from box2mask_torch.config import get_config
from box2mask_torch.datasets.tables import get_tables
from box2mask_torch.engine import checkpoint as ckpt
from box2mask_torch.engine import state as S
from box2mask_torch.runtime import resolve_device


def read_reference(path):
    """(state_dict as numpy, payload) of a `.tar` / `.pth` torch checkpoint
    or an `.npz` export of its state_dict (no payload)."""
    if path.endswith('.npz'):
        return dict(np.load(path)), {}
    return convert.load_torch_tar(path)


def fill_model(model, sd):
    """Load the converted state_dict `sd` into `model` where the names and
    shapes fit; print what the checkpoint leaves out and what the model
    has no place for."""
    want = model.state_dict()
    missing = sorted(k for k in want if k not in sd)
    extra = sorted(k for k in sd if k not in want)
    bad = sorted(k for k in sd if k in want and sd[k].shape != want[k].shape)
    if bad:
        raise ValueError(f'{len(bad)} converted tensors do not fit the '
                         f'model: {[(k, tuple(sd[k].shape)) for k in bad[:6]]}'
                         ' (check --layers and the config\'s heads)')
    if missing:
        print(f'WARNING: {len(missing)} model tensors not covered by the '
              f'torch checkpoint (e.g. head mismatch): {missing[:6]}')
    if extra:
        print(f'NOTE: {len(extra)} converted tensors have no place in the '
              f'model (heads the config does not have): {extra[:6]}')
    model.load_state_dict({k: v for k, v in sd.items() if k in want},
                          strict=False)


def main(argv=None):
    ap = argparse.ArgumentParser('box2mask_torch.convert_reference')
    ap.add_argument('--config', default=None,
                    help='config preset (for exp/checkpoint dirs + layers)')
    ap.add_argument('--torch_ckpt', required=True,
                    help='.tar torch checkpoint or .npz state_dict export')
    ap.add_argument('--out_dir', default=None)
    ap.add_argument('--layers', type=int, default=None)
    args, rest = ap.parse_known_args(argv)
    cfg = get_config((['--config', args.config] if args.config else [])
                     + rest + (['--layers', str(args.layers)]
                               if args.layers else []))
    sd, meta = read_reference(args.torch_ckpt)
    params, stats = convert.convert_state_dict(sd, layers=cfg.layers)
    valid_ids = get_tables(cfg.dataset_name if cfg.dataset_name != 'synthetic'
                           else 'scannet')[0]
    device = resolve_device(os.environ.get('BOX2MASK_PLATFORM') or None)
    model = S.build_model(cfg, len(valid_ids), device)
    state = S.init_state(cfg, model, S.make_optimizer(cfg))
    fill_model(model, convert.from_flax(params, stats))

    m = re.search(r'_([0-9]+(\.[0-9]+)?)\.(tar|pth|ckpt)$',
                  os.path.basename(args.torch_ckpt))
    t_time = float(meta.get('training_time', m.group(1) if m else 0.0))
    path = ckpt.save_checkpoint(args.out_dir or cfg.checkpoint_path, state,
                                t_time, int(meta.get('epoch', 0)),
                                int(meta.get('iteration_num', 0)))
    print(f'Converted checkpoint written: {path}')
    return path


if __name__ == '__main__':
    main(sys.argv[1:])
