"""The benchmark's one door into the program, box2mask_torch: its
configuration, host preparation of the generated scenes, model, inference
pipeline, train step and kernel counters. No other module of the benchmark
imports the program, and nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from box2mask_torch.config import get_config
from box2mask_torch.datasets import batching, supervision, tables, voxelize
from box2mask_torch.engine import hostload, infer
from box2mask_torch.engine import state as S
from box2mask_torch.postprocess.device_post import (fused_postproc,
                                                    stacked_masks_to_results)
from box2mask_torch.sparse import _build
from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse import ops
from box2mask_torch.sparse import pallas_conv as PC

def argv(config):
    """The configuration file's preset and assumed flags as the program's
    command line."""
    out = []
    for key, val in {**config['preset'], **config['assumed_flags']}.items():
        if val is True:
            out.append('--' + key)
        elif isinstance(val, list):
            out.extend(['--' + key] + [str(v) for v in val])
        else:
            out.append(f'--{key}={val}')
    return out


def make_cfg(config):
    """The program's config for `config`, checked against what the file
    states the model is (so the program runs as the configuration says)."""
    cfg = get_config(argv(config))
    m = config['model']
    got = {'layers': cfg.layers, 'in_channels': cfg.in_channels,
           'heads': list(cfg.network_heads), 'voxel_size': cfg.voxel_size,
           'min_bb_size': cfg.min_bb_size,
           'compute_dtype': cfg.compute_dtype,
           'act_dtype': 'bfloat16' if cfg.bf16_acts else 'float32',
           'segment_pooling': bool(cfg.do_segment_pooling),
           'eval_ths': [float(t) for t in cfg.eval_ths],
           'remat': bool(cfg.remat), 'key_conv': cfg.key_conv,
           'batch_size': cfg.batch_size, 'lr': cfg.lr,
           'bb_scores_start_epoch': cfg.mlp_bb_scores_start_epoch,
           'loss_weights': {
               'offsets': cfg.loss_weight_bb_offsets,
               'bounds': cfg.loss_weight_bb_bounds,
               'bb_scores': cfg.loss_weight_bb_scores,
               'semantics': cfg.loss_weight_semantics}}
    for k, v in got.items():
        if k in m and m[k] != v:
            raise ValueError(f'{config["name"]}: the program reads {k} = '
                             f'{v!r}, the configuration states {m[k]!r}')
    valid_ids, _, _, _ = tables.get_tables(config['dataset'])
    if list(valid_ids) != config['classes']['valid_ids']:
        raise ValueError(f'{config["name"]}: class table differs')
    return cfg


def dataset_tables(config):
    valid_ids, sem_id2idx, _, is_fg = tables.get_tables(config['dataset'])
    return valid_ids, sem_id2idx, is_fg


def host_batch(cfg, config, items, mode):
    """items: [(scene, labels)] -> (dev_np, host) from the program's
    voxelizer, supervision and batch builder."""
    _, sem_id2idx, _ = dataset_tables(config)
    rets = []
    for scene, labels in items:
        ret = voxelize.voxelize_scene(scene, cfg)
        if mode != 'test':
            ret['labels'] = labels
            supervision.build_supervision(ret, labels, scene, cfg,
                                          config['dataset'], mode)
        rets.append(ret)
    return batching.build_batch(rets, cfg, sem_id2idx=sem_id2idx, mode=mode)


def build_all():
    """Build (or find built) the program's CUDA kernels; nvcc seconds per
    source (0 when the build directory already held it)."""
    _build.build_all()
    return dict(_build.build_seconds)


def build_model(cfg, config, weights, device):
    model = S.build_model(cfg, len(config['classes']['valid_ids']), device)
    model.load_state_dict(weights, strict=True)
    return model


def pipeline(cfg, config, model, device):
    valid_ids, _, is_fg = dataset_tables(config)
    ev = config['eval']
    return infer.FusedInferencePipeline(
        cfg, valid_ids, is_fg, model=model, top_k=ev['top_k'],
        max_masks=ev['max_masks'], device=device)


def upload(dev_np, device):
    return hostload.upload(dev_np, device)


def sync_ms(fn, device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def infer_stages(pipe, cfg, dev_np, host, device):
    """One batch's layers, each alone and synchronised: ms of the packed
    upload (pack, ship, decode), the forward (maps and model), the device
    post-processing, the readback and host unpack; and the kept masks."""
    ths = torch.as_tensor(np.asarray(cfg.eval_ths, np.float32),
                          device=device)
    up = pipe.uploader

    def packed_upload():
        buf, unpack = up.ship(up.pack(dev_np))
        return unpack(buf)
    batch, t_up = sync_ms(packed_upload, device)

    def forward():
        full = S.ensure_maps(batch)
        return full, pipe.model(full)
    (full, pred), t_fwd = sync_ms(forward, device)
    out, t_post = sync_ms(lambda: fused_postproc(
        pipe.core, cfg, pred, full, ths, pipe.top_k), device)

    def harvest():
        out_np = {k: v.cpu().numpy() for k, v in out.items()}
        stacked_masks_to_results(
            out_np, host, pipe.valid_class_ids, post_fallback=pipe.post_full,
            pred=pred, dev_t=full, ths=ths,
            native=cfg.use_native_host_ops)
        return out_np
    out_np, t_harvest = sync_ms(harvest, device)
    return {'upload_ms': t_up, 'forward_ms': t_fwd, 'postproc_ms': t_post,
            'harvest_ms': t_harvest,
            'kept_masks': [int(n) for n in out_np['n_keep']]}


def forward_only(pipe, dev_np, device):
    """fn() running one eval forward of the batch (uploaded once)."""
    batch = upload(dev_np, device)

    @torch.no_grad()
    def fn():
        pipe.model.eval()
        return pipe.model(S.ensure_maps(batch))
    return fn


class Trainer:
    """The training step as `Trainer.train_model` drives it, without its
    loader and epoch heads: upload of the batch, the step, the loss read
    back."""

    def __init__(self, cfg, model, epoch, device):
        self.cfg, self.device = cfg, device
        tx = S.make_optimizer(cfg)
        self.state = S.TrainState(model, tx, tx.init(list(model.parameters())))
        self.bb_w, self.cs_w = S.head_weights(cfg, epoch)
        self.names = [n for n, _ in model.named_parameters()]

    def step(self, dev_np, lr):
        batch = upload(dev_np, self.device)
        _, ld = S.train_step(self.cfg, self.state, batch, lr, self.bb_w,
                             self.cs_w)
        return float(ld['optimization_loss'])

    @torch.no_grad()
    def first_grads(self, b1=0.9):
        """Per parameter, the gradient the optimiser got in its first step,
        read after that step (Adam's first moment over 1 - b1), on the
        host."""
        st = self.state.opt_state
        return {n: (m.float() / (1 - b1)).cpu()
                for n, m in zip(self.names, st['mu'])}

    @torch.no_grad()
    def params(self):
        return {n: p.detach().clone() for n, p in
                self.state.model.named_parameters()}

    def split_ms(self, dev_np, lr):
        """The step's layers, each alone and synchronised."""
        cfg, st = self.cfg, self.state
        batch, t_up = sync_ms(lambda: upload(dev_np, self.device),
                              self.device)
        ld, t_fwd = sync_ms(lambda: S.forward_losses(
            cfg, st, batch, self.bb_w, self.cs_w), self.device)
        _, t_bwd = sync_ms(lambda: S.backward(ld), self.device)
        _, t_opt = sync_ms(lambda: S.apply_update(st, lr), self.device)
        return {'upload_ms': t_up, 'forward_ms': t_fwd, 'backward_ms': t_bwd,
                'optimizer_ms': t_opt}


def reset_counts():
    KC.reset_counts()
    PC.reset_counts()
    ops.reset_counts()


def counts():
    """Kernel launches and plain-twin calls since reset_counts: the window
    runs the key-matching kernels and no plain twin or torch formulation
    of a conv."""
    return {'key_conv': dict(KC.LAUNCHES),
            'key_conv_plain': dict(KC.PLAIN_CALLS),
            'nmap_conv': dict(PC.LAUNCHES),
            'nmap_conv_plain': dict(PC.PLAIN_CALLS),
            'torch_formulation': dict(ops.XLA_CALLS)}
