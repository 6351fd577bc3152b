"""Model construction, the train state and the step functions (port of
box2mask_tpu/engine/state.py:30-70 ensure_maps, :73 make_optimizer, :88
build_model, :127 init_state, :134 make_train_step, :160 make_val_step,
:169 make_forward, :179 head_weights).

A train step is `train_step(state, batch, lr, bb_w, cs_w) -> (state, loss
dict)`: the forward in train mode, the losses, the backward, and one
optimizer update with the learning rate of this step, on either conv path
(key matching, or neighbor maps through the autograd Functions of
sparse/pallas_conv.py or the ops' torch formulation). The model holds the
parameters and the BN running statistics (the JAX package's params and
batch_stats), so the state is updated in place. The three phases are also
callable one by one (forward_losses, backward, apply_update), for timing
them apart; each is a span (b2m.train.forward, .backward, .optimizer), and
a train_step is b2m.train.step around them.
"""

from __future__ import annotations

import dataclasses

import torch

from box2mask_torch import tracing
from box2mask_torch.convert import kaiming_init_
from box2mask_torch.datasets.batching import DEVICE_NMAPS
from box2mask_torch.engine.optim import Optimizer
from box2mask_torch.nn.losses import compute_losses
from box2mask_torch.nn.unet import SelectionNet
from box2mask_torch.runtime import resolve_device
from box2mask_torch.sparse import device_maps as DM
from box2mask_torch.sparse.keys import NUM_LEVELS, SENT_KEY

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def is_nmap_batch(batch):
    """True when the batch's convs run over neighbor maps: maps built on the
    device (--key_conv off, or eval in mode 'train') or on the host (the
    host-maps layout, which carries no key pyramid)."""
    return DEVICE_NMAPS in batch or 'keys0_b' not in batch


def ensure_maps(batch):
    """The per-level arrays the forward reads beside the batch. A host-maps
    batch carries them all. A neighbor-map batch gets every conv's map built
    on its device (sparse/device_maps.build_batch_maps_from_keys); a
    key-matching batch gets the per-level valid masks and counts, all its
    convs need. Batch-provided entries win (valid0, batch0, num0)."""
    if 'keys0_b' not in batch:
        return batch
    if DEVICE_NMAPS in batch:
        maps = DM.build_batch_maps_from_keys(
            tuple(batch[f'keys{l}_b'] for l in range(NUM_LEVELS)))
    else:
        maps = {}
        for l in range(NUM_LEVELS):
            v = batch[f'keys{l}_b'].reshape(-1) < SENT_KEY
            maps[f'valid{l}'] = v
            maps[f'num{l}'] = v.sum().to(torch.int32)
    maps.update(batch)
    return maps


def build_model(cfg, num_classes, device=None, group=None):
    """SelectionNet for `cfg` with uninitialized conv kernels (load a
    state_dict, or convert.kaiming_init_), in eval mode, on `device` (None:
    the card, runtime.resolve_device). With a process `group` its BN layers
    take their training moments over the group's ranks (SyncBN, the JAX
    package's axis_name)."""
    model = SelectionNet(
        num_classes=num_classes,
        in_channels=cfg.in_channels,
        heads=tuple(cfg.network_heads),
        layers=cfg.layers,
        do_segment_pooling=cfg.do_segment_pooling,
        max_pool_segments=cfg.max_pool_segments_detection_net,
        mlp_bounds_relu=cfg.mlp_bounds_relu,
        compute_dtype=DTYPES[cfg.compute_dtype],
        act_dtype=torch.bfloat16 if cfg.bf16_acts else torch.float32,
        # auto == off, as in the JAX package (engine/state.py:98-100)
        use_pallas=cfg.pallas_conv == 'on',
        remat=cfg.remat, remat_max_level=cfg.remat_levels, group=group)
    model.eval()
    return model.to(resolve_device(device))


@torch.no_grad()
def forward(model, batch):
    """Eval forward returning the raw head outputs."""
    model.eval()
    return model(ensure_maps(batch))


# ------------------------------------------------------------------ training
def make_optimizer(cfg):
    """Adam / Adadelta / RMSprop by cfg.optimizer, with optax's update rules;
    the learning rate is given per step (engine/optim.py)."""
    return Optimizer(cfg.optimizer)


@dataclasses.dataclass
class TrainState:
    """The model (parameters + BN running statistics), the optimizer and
    its state, and the count of steps taken."""
    model: SelectionNet
    tx: Optimizer
    opt_state: dict
    step: int = 0

    @property
    def params(self):
        return list(self.model.parameters())


def init_state(cfg, model, tx, seed=0):
    """Seeded kaiming weights (convert.kaiming_init_) and a fresh optimizer
    state. The JAX package draws its init from a jax.random key, so the two
    packages' inits differ; tests copy one side's weights to the other."""
    kaiming_init_(model, torch.Generator().manual_seed(seed))
    return TrainState(model, tx, tx.init(list(model.parameters())))


def forward_losses(cfg, state, batch, bb_w, cs_w):
    """Train-mode forward and the loss dict (BN running statistics move),
    on either conv path: key matching, or neighbor maps (built on the
    device by ensure_maps, or carried by a host-maps batch), whose convs
    differentiate through sparse/pallas_conv.py's autograd Functions or the
    ops' XLA formulation."""
    model = state.model
    model.train()
    with tracing.span('b2m.train.forward'):
        full = ensure_maps(batch)
        return compute_losses(cfg, model(full), full, bb_w, cs_w)


def backward(ld):
    with tracing.span('b2m.train.backward'):
        ld['optimization_loss'].backward()


def apply_update(state, lr):
    """One optimizer step from the accumulated grads, then clear them."""
    params = state.params
    with tracing.span('b2m.train.optimizer'):
        state.tx.update(params, state.opt_state, lr)
        for p in params:
            p.grad = None
    state.step += 1
    return state


def train_step(cfg, state, batch, lr, bb_w, cs_w):
    with tracing.span('b2m.train.step'):
        ld = forward_losses(cfg, state, batch, bb_w, cs_w)
        backward(ld)
        apply_update(state, lr)
        return state, {k: v.detach() for k, v in ld.items()}


def make_train_step(cfg):
    """`step(state, batch, lr, bb_w, cs_w) -> (state, loss dict)`."""
    def step(state, batch, lr, bb_w, cs_w):
        return train_step(cfg, state, batch, lr, bb_w, cs_w)
    return step


def make_val_step(cfg):
    """`step(state, batch, bb_w, cs_w) -> loss dict` in eval mode."""
    @torch.no_grad()
    def step(state, batch, bb_w, cs_w):
        state.model.eval()
        full = ensure_maps(batch)
        return compute_losses(cfg, state.model(full), full, bb_w, cs_w)
    return step


def head_weights(cfg, epoch):
    """Delayed-start loss weights (reference models/model.py:136-137,179)."""
    bb_w = cfg.loss_weight_bb_scores or 0.0
    if epoch < cfg.mlp_bb_scores_start_epoch:
        bb_w = 0.0
    cs_w = cfg.loss_weight_center_scores or 0.0
    if epoch < cfg.mlp_center_scores_start_epoch:
        cs_w = 0.0
    return float(bb_w), float(cs_w)
