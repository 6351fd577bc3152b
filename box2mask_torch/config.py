"""Config: the flags the port reads (its own copy of the part of
box2mask_tpu/config.py that the inference, training and evaluation slices
use; same names, defaults, derived fields and checks).

Reads the same ``configs/*.txt`` format (``key = value`` lines, bare flags,
``[a, b, c]`` lists, ``#`` comments) without depending on configargparse.
Precedence: CLI > config file > default. Flags of the JAX package that the
port does not read (the TPU's, the mesh's) are accepted, from a config file
or the command line, and ignored; the multi-device and visualization flags
are read.
The conv-path flags are read, with the JAX package's names, defaults and
choices:
``--key_conv {on,eval,off}`` (key-matching convs, or neighbor maps built on
the device; datasets/batching.build_batch), ``--pallas_conv {auto,on,off}``
(the neighbor-map convs through the CUDA kernels of sparse/pallas_conv.py;
auto is off, as in the JAX package) and ``--host_coordinate_maps`` (neighbor
maps built on the host). ``--key_conv_force`` (TPU window plans, which the
port does not use) is one of the flags accepted and ignored.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

HEADS = ('mlp_offsets', 'mlp_bounds', 'mlp_bb_scores', 'mlp_semantics',
         'mlp_center_scores', 'mlp_per_vox_semantics')


def _parse_config_file(path):
    """Parse a config txt into {key: raw-string-or-list-or-None}."""
    out = {}
    with open(path) as f:
        for raw in f.readlines():
            line = raw.split('#', 1)[0].strip()
            if not line:
                continue
            if '=' in line:
                key, _, val = line.partition('=')
                key, val = key.strip(), val.strip()
            elif ' ' in line:
                key, _, val = line.partition(' ')
                key, val = key.strip(), val.strip()
            else:
                key, val = line, None
            if val is not None and val.startswith('[') and val.endswith(']'):
                val = [v.strip() for v in val[1:-1].split(',') if v.strip()]
            out[key] = val
    return out


def config_parser():
    p = argparse.ArgumentParser('box2mask-torch')
    add = p.add_argument
    add('--config', type=str, default=None, help='config file path')
    add('--exp_name', type=str, default=None)
    add('--dataset_name', type=str, default='scannet')
    add('--data_split', type=str,
        default='data/scannet/scannetv2_official_split.npz')
    add('--num_workers', type=int, default=16)
    add('--use_normals_input', default=False, action='store_true')
    # arkitscenes
    add('--subsample_rate', type=int, default=10)
    # s3dis
    add('--s3dis_split_fold', default=5, type=int)
    add('--point_sampling_rate', default=None, type=float)
    add('--superpoint_algo', default='learned_superpoint', type=str,
        choices=['learned_superpoint'])
    add('--ignore_wall_ceiling_floor', default=False, action='store_true')
    add('--ignore_ceiling_floor', default=False, action='store_true')
    add('--full_resolution', default=False, action='store_true')
    # synthetic dataset scale (dataset-free runs, tests, chip_smoke.py)
    add('--synthetic_instances', type=int, default=8)
    add('--synthetic_points_per_instance', type=int, default=600)
    add('--synthetic_floor_points', type=int, default=3000)
    add('--synthetic_wall_points', type=int, default=2200)
    # box supervision
    add('--bb_supervision', default=False, action='store_true')
    add('--point_association', default=False, action='store_true')
    add('--smallest_bb_heuristic', default=False, action='store_true')
    add('--majority_vote', default=False, action='store_true')
    add('--dropout_boxes', type=float, default=None)
    add('--noisy_boxes', type=float, default=None)
    add('--voxel_size', type=float, default=0.02)
    add('--align', default=False, action='store_true')
    add('--dont_align', default=False, action='store_true')
    # debugging
    add('--overfit_to_single_scene', type=int, default=None)
    add('--overfit_to_single_scene_str', type=str, default=None)
    add('--dataset_size', type=int, default=None)
    add('--fixed_seed', type=int, default=None)
    add('--eval_ths', type=float, nargs=4, default=None,
        help='cluster_th, score_th, mask_bin_th, mask_nms_th')
    # eval / prediction (box2mask_tpu/config.py:96-114, :142)
    add('--data_dir', type=str, default='./data/scannet/')
    add('--checkpoint', type=str, default=None)
    add('--sample_fixed_seed', default=False, action='store_true')
    add('--load_ckpt_closest_to', type=int, default=None)
    add('--eval_batch_size', type=int, default=4)
    add('--eval_wo_aug', default=False, action='store_true')
    add('--eval_training', default=False, action='store_true')
    add('--eval_specific_param', default=False, action='store_true')
    add('--submission_write_out', default=False, action='store_true')
    add('--submission_write_out_testset', default=False, action='store_true')
    # param search (box2mask_tpu/config.py:113-118): linspace(a, b, n) each
    add('--param_search', default=False, action='store_true')
    add('--cluster_th_search', default=[0.3, 0.8, 6], nargs=3, type=float)
    add('--score_th_search', default=[0, 0.2, 5], nargs=3, type=float)
    add('--mask_bin_th_search', default=[0.2, 0.35, 4], nargs=3, type=float)
    add('--mask_nms_th_search', default=[0.4, 0.8, 5], nargs=3, type=float)
    # visualizations (viz/export.py): PLYs, bbs.npy and viewer.html per
    # scene under <exp>/viz; --mesh_viz adds voxel surface meshes
    add('--produce_visualizations', default=False, action='store_true')
    add('--predict_specific_scene', type=str, default=None)
    add('--mesh_viz', default=False, action='store_true')
    # spatial sharding (parallel/spatial.py): one scene's U-Net split over
    # this many ranks, levels < --spatial_gather_level sharded with
    # halo-exchanged convs, the coarser levels replicated; 0 / 1 = off
    add('--spatial_shards', type=int, default=0)
    add('--spatial_gather_level', type=int, default=3)
    add('--use_native_host_ops', default=True, action='store_true',
        help='the C host library (native/) for voxelization and the eval '
             'mask unpack; raises when it cannot be built')
    # training
    add('--eval_first', dest='skip_first_eval', action='store_false')
    p.set_defaults(skip_first_eval=True)
    add('--eval_every', type=int, default=12)
    add('--val_every', type=int, default=12)
    add('--ckpt_every', type=int, default=4)
    add('--train_submission', default=False, action='store_true')
    add('--loose_model_loading', default=False, action='store_true')
    # read nowhere, in the JAX package as here (its checkpoint converter
    # drops the old head weights instead)
    add('--load_unused_head', default=False, action='store_true')
    add('--apple_warmstart', default=False, action='store_true')
    add('--profile_dir', type=str, default=None,
        help='Write a torch.profiler trace of train steps 10-14 to this dir.')
    # data-parallel training (parallel/mesh.py): one process per card
    add('--multigpu', default=False, action='store_true',
        help='Data-parallel training, one process per local card '
             '(torch.distributed, SyncBN moments, averaged grads).')
    add('--singlegpu', default=False, action='store_true')
    add('--data_axis_size', type=int, default=None,
        help='Processes (cards) of --multigpu (default: every local card).')
    add('--batch_size', type=int, default=4)
    add('--remat', default=False, action='store_true')
    add('--no_auto_remat', default=False, action='store_true')
    add('--remat_levels', type=int, default=7)
    add('--bf16_acts', default=False, action='store_true')
    add('--num_epochs', type=int, default=1500)
    add('--lr', type=float, default=1e-6)
    add('--optimizer', type=str, default='Adam')
    add('--loss_on_all_instances', default=False, action='store_true')
    add('--num_eval_batches', type=int, default=5)
    add('--use_lr_scheduler', default=False, action='store_true')
    add('--lr_scheduler_start_epoch', type=int, default=None)
    add('--lr_scheduler_end_epoch', type=int, default=None)
    # augmentations (datasets/augmentation.py and the readers)
    add('--augmentation', default=False, action='store_true')
    add('--position_jittering', type=float, default=[0.00, 0.01], nargs=2)
    add('--scaling_aug', type=float, default=[0.0, 0.9, 1.1], nargs=3)
    add('--color_jittering_aug', default=[0.0, 0.1], type=float, nargs=2)
    add('--HAIS_jitter_aug', default=False, action='store_true')
    add('--rotation_aug', type=float, default=[0.0, math.pi / 100, 1],
        nargs='+')
    add('--rotation_90_aug', default=False, action='store_true')
    add('--mix_3d_color_aug', default=False, action='store_true')
    add('--apply_hue_aug', default=False, action='store_true')
    add('--flipping_aug', default=0.0, type=float)
    add('--elastic_distortion', default=0.0, type=float)
    add('--elastic_distortion_HAIS', default=0.0, type=float)
    add('--chromatic_auto_contrast', default=0.0, type=float)
    add('--chromatic_translation', type=float, default=[0.0, 0.1], nargs=2)
    add('--random_brightness', type=float, default=[0.0, 0.1], nargs=2)
    # detection net
    add('--do_segment_pooling', default=False, action='store_true')
    add('--network_heads', default=None, type=str, nargs='+', choices=HEADS)
    add('--mlp_bounds_relu', default=False, action='store_true')
    add('--max_pool_segments_detection_net', default=False,
        action='store_true')
    add('--layers', type=int, default=2)
    # losses
    add('--use_bb_iou_loss', default=False, action='store_true')
    add('--loss_weight_semantics', type=float, default=None)
    add('--loss_weight_bb_offsets', type=float, default=1.0)
    add('--loss_weight_bb_bounds', type=float, default=None)
    add('--loss_weight_bb_scores', type=float, default=None)
    add('--loss_weight_center_scores', type=float, default=None)
    add('--loss_weight_bb_iou', type=float, default=None)
    add('--loss_weight_per_vox_semantics', type=float, default=1)
    add('--mlp_bb_scores_start_epoch', default=0, type=int)
    add('--mlp_center_scores_start_epoch', default=0, type=int)
    add('--min_bb_size', default=0.04, type=float)
    add('--vox_bucket', type=int, default=4096,
        help='Padding granularity (voxels) per pyramid level.')
    add('--seg_bucket', type=int, default=512,
        help='Padding granularity for oversegments.')
    add('--compute_dtype', type=str, default='bfloat16',
        choices=['bfloat16', 'float32'],
        help='dtype of conv/linear operands; accumulation is float32.')
    add('--prefetch_batches', type=int, default=2)
    # conv path (box2mask_tpu/config.py:235-251)
    add('--pallas_conv', type=str, default='auto',
        choices=['auto', 'on', 'off'],
        help='neighbor-map convs through the CUDA kernels; auto = off')
    add('--key_conv', type=str, default='on', choices=['on', 'eval', 'off'],
        help='key-matching convs (on), for val/test batches only (eval), or '
             'neighbor maps built on the device (off)')
    add('--host_coordinate_maps', default=False, action='store_true',
        help='build the neighbor maps on the host (sparse/coords.py)')
    return p


def needs_remat(total_padded_rows, bf16_acts=False):
    """True when a training step over this many level-0 voxel rows is past
    the JAX package's one-chip memory rule (box2mask_tpu/config.py:289):
    8 x 131072 rows need block remat with f32 activations; with bf16
    activations the threshold doubles. The port keeps the rule as it is, so
    a preset trains under the same remat setting on either package."""
    return total_padded_rows > (8 if bf16_acts else 4) * 131072


def _apply_config_file(parser, argv):
    """Config-file values as argv-style defaults (CLI wins); keys the port
    does not read are skipped (the conv-path keys key_conv, pallas_conv and
    host_coordinate_maps are read: config_parser)."""
    ns, _ = parser.parse_known_args(argv)
    if not ns.config:
        return argv
    option_map = {opt[2:]: a for a in parser._actions
                  for opt in a.option_strings if opt.startswith('--')}
    extra = []
    for key, val in _parse_config_file(ns.config).items():
        a = option_map.get(key)
        if a is None:
            continue
        if isinstance(a, (argparse._StoreTrueAction,
                          argparse._StoreFalseAction)):
            if val is None or str(val).lower() in ('true', '1', 'yes'):
                extra.append('--' + key)
        elif val is None:
            raise ValueError(f'Config key {key!r} missing a value')
        elif isinstance(val, list):
            extra.extend(['--' + key] + [str(v) for v in val])
        else:
            extra.append('--' + key + '=' + str(val))
    return extra + list(argv or [])


def get_config(args=None):
    """Parse args + config file and derive the fields the port reads, with
    the JAX package's checks (box2mask_tpu/config.py:308-413): head-name
    constants, `in_channels`, `full_model`, the experiment paths, the
    head / loss-weight checks, the auto-remat rule, --sample_fixed_seed and
    the --eval_batch_size / --key_conv off check."""
    parser = config_parser()
    argv = list(args) if args is not None else sys.argv[1:]
    argv = _apply_config_file(parser, argv)
    cfg, _ = parser.parse_known_args(argv)
    if cfg.singlegpu:
        cfg.multigpu = False
    if cfg.spatial_shards > 1:
        if cfg.multigpu:
            raise ValueError('--spatial_shards and --multigpu are mutually '
                             'exclusive')
        cfg.batch_size = 1          # one scene, sharded across devices
    if cfg.dont_align:
        cfg.align = False
    cfg.loss_on_fg_instances = not cfg.loss_on_all_instances
    if len(cfg.rotation_aug) == 1:
        cfg.rotation_aug = [cfg.rotation_aug[0], math.pi / 100, 1]
    if cfg.sample_fixed_seed:
        cfg.fixed_seed = int.from_bytes(os.urandom(4), byteorder='big')
    if cfg.dropout_boxes and not 0 <= cfg.dropout_boxes <= 1:
        raise ValueError(f'--dropout_boxes {cfg.dropout_boxes} not in [0, 1]')
    for head in HEADS:
        setattr(cfg, head, head)
    cfg.network_heads_options = list(HEADS)
    if cfg.network_heads is None:
        cfg.network_heads = []
    if len(set(cfg.network_heads)) != len(cfg.network_heads):
        raise ValueError(f'repeated head in {cfg.network_heads}')
    heads = cfg.network_heads
    cfg.full_model = ('mlp_bounds' in heads and 'mlp_offsets' in heads
                      and ('mlp_semantics' in heads
                           or 'mlp_per_vox_semantics' in heads)
                      and 'mlp_bb_scores' in heads)
    cfg.in_channels = 3 + 3 * cfg.use_normals_input

    if cfg.exp_name == 'cfg_name':
        name = os.path.basename(cfg.config)
        if not name.endswith('.txt'):
            raise ValueError(f'exp_name cfg_name needs a .txt config, got '
                             f'{cfg.config}')
        cfg.exp_name = name[:-4]
    root = os.environ.get('BOX2MASK_EXP_ROOT', os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'experiments'))
    cfg.exp_path = os.path.join(root, str(cfg.exp_name)) + '/'
    cfg.checkpoint_path = cfg.exp_path + 'checkpoints/'

    if 'mlp_center_scores' in heads and 'mlp_offsets' not in heads:
        raise ValueError('mlp_center_scores head requires mlp_offsets')
    if 'mlp_bb_scores' in heads and cfg.loss_weight_bb_scores is None:
        raise ValueError('mlp_bb_scores head requires --loss_weight_bb_scores')
    if 'mlp_semantics' in heads and not cfg.loss_weight_semantics:
        raise ValueError('mlp_semantics head requires --loss_weight_semantics')
    if cfg.use_bb_iou_loss:
        if not ('mlp_offsets' in heads and 'mlp_bounds' in heads):
            raise ValueError('bb IoU loss requires offsets+bounds heads')
        if cfg.loss_weight_bb_iou is None:
            raise ValueError('bb IoU loss requires --loss_weight_bb_iou')
    # the shipped presets run as shipped: block remat when the step is past
    # the memory rule (parameters are the same either way); --multigpu
    # shards the batch, so the Trainer applies the rule to one rank's rows
    if (not cfg.remat and not cfg.no_auto_remat and not cfg.multigpu
            and needs_remat(cfg.batch_size * cfg.vox_bucket, cfg.bf16_acts)):
        cfg.remat = True
        cfg.remat_auto = True
    # fused eval at batch size > 1 needs the key-pyramid batch layout:
    # refuse an explicit --eval_batch_size (command line or config file)
    # here, not mid-eval; a defaulted one drops to 1
    if cfg.key_conv == 'off' and cfg.eval_batch_size > 1:
        if any(a.startswith('--eval_batch_size') for a in argv):
            raise ValueError(
                'fused eval at --eval_batch_size > 1 requires the key_conv '
                'batch layout: drop "--key_conv off" or set '
                '--eval_batch_size 1')
        cfg.eval_batch_size = 1
    return cfg
