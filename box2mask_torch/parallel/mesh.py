"""Data-parallel training over torch.distributed (port of
box2mask_tpu/parallel/mesh.py).

The JAX package runs one process over a 1-D mesh with axis 'data': the train
step under shard_map, each device on its own shard of the batch, the BN sums
psum'd over the axis (SyncBN), the grads and the loss dict pmean'd. Here one
process drives one card (rank r on cuda:r, NCCL), as the reference's
mp.spawn + DDP did, and the same step is written with explicit collectives:

  * every MaskedBatchNorm of a model built with the process group sums its
    moments over the ranks through one all-reduce in its forward
    (sparse/masked_bn.py), and its backward all-reduces the two sums the
    moments' gradient needs, as shard_map transposes psum
    (check_vma=False);
  * after the backward, one all-reduce of every grad, flattened into one
    buffer, divided by the world size (the pmean), then the loss dict the
    same way; then the optimizer update on every rank.

So the gradient is that of the mean of the per-shard losses, with BN
statistics over the union of the shards' valid rows: not the gradient of
one process on the concatenated batch, whose losses normalise over all of
it. The all-reduce hands every rank the same bits, so the parameters stay
bit-equal across ranks without a broadcast after the first.

The collectives run in the same order on every rank only if every rank
runs the same graph: the same model, the same remat decision
(engine/train.py), and the same number of steps (datasets/loader.py's
sharded loader).
"""

from __future__ import annotations

import datetime
import hashlib
import os
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from box2mask_torch.engine import state as S

AXIS = 'data'
# bound on every collective and barrier of a run of ranks that the train
# and evaluate CLIs spawn: the other ranks wait at a barrier while rank 0
# writes a checkpoint, runs the full evaluation of the val set or a
# scene's post-processing and the protocol
RANKS_TIMEOUT_S = 7200.0


def init_data_parallel(rank, world_size, backend='nccl', init_method=None,
                       device=None, timeout=600.0):
    """Join the process group of `world_size` ranks as `rank` and return it
    (the default group). `init_method` is the rendezvous
    ('tcp://localhost:<port>', 'file://<path>'); `timeout` (seconds) bounds
    the rendezvous and every collective. With a CUDA `device` the process
    makes it its current device first (NCCL: one card per rank)."""
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type == 'cuda'
            and device.index is not None):
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def teardown():
    """Leave the process group (a no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def ranks_backend(world, platform, flag):
    """The backend of a run of `world` ranks: gloo on the CPU (`platform`
    'cpu'), else NCCL with one card per rank, raising when the machine has
    fewer cards (`flag` names the option that asked for the ranks)."""
    if platform == 'cpu':
        return 'gloo'
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if world < 1 or world > cards:
        raise RuntimeError(f'{flag} asks for {world} ranks, one per card, '
                           f'and {cards} CUDA cards are available; set '
                           'BOX2MASK_PLATFORM=cpu to run the ranks on the '
                           'CPU')
    return 'nccl'


def rank_device(rank, world, platform):
    """Rank `rank`'s device: cuda:rank, or the CPU when `platform` is 'cpu',
    where the ranks share the cores: each takes its share, or fewer where
    OMP_NUM_THREADS asks for fewer (torch's default reads it)."""
    if platform != 'cpu':
        return torch.device('cuda', rank)
    torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                     (os.cpu_count() or 1) // world)))
    return torch.device('cpu')


def spawn_ranks(worker, world, backend, *args):
    """Run worker(rank, world, backend, init_method, *args) in `world`
    spawned processes joined by a file rendezvous, and wait for them; a
    rank that fails ends the run with its error. `worker` pickles by
    import path."""
    rendezvous = tempfile.mkdtemp(prefix='box2mask_ranks_')
    try:
        mp.start_processes(
            worker, args=(world, backend, 'file://' + os.path.join(
                rendezvous, 'init')) + args,
            nprocs=world, join=True, start_method='spawn')
    finally:
        shutil.rmtree(rendezvous, ignore_errors=True)


def agree_seeds(cfg, group, device):
    """Every rank of `group` takes rank 0's seeds, so that the ranks of one
    run draw its randomness alike: --fixed_seed (each rank's get_config
    draws its own under --sample_fixed_seed; the shuffle and the initial
    weights read it) and, where there is none, `cfg.augment_seed`, drawn
    on rank 0, which seeds each scene's augmentation in its place
    (datasets/loader.scene_rng). A spatially sharded scene must be the
    same scene on every rank; data-parallel ranks must shuffle alike."""
    seeds = torch.tensor(
        [-1 if cfg.fixed_seed is None else cfg.fixed_seed,
         int.from_bytes(os.urandom(4), byteorder='big')], dtype=torch.int64,
        device=collective_device(group, device))
    dist.broadcast(seeds, 0, group=group)
    fixed, augment = (int(s) for s in seeds.tolist())
    cfg.fixed_seed = None if fixed < 0 else fixed
    cfg.augment_seed = augment if cfg.fixed_seed is None else None
    return cfg


def same_on_every_rank(value, group, device, what):
    """Raise unless the int `value` (a digest, < 2^63) is the same on every
    rank of `group`; `what` names it in the error."""
    lo = torch.tensor([value], dtype=torch.int64,
                      device=collective_device(group, device))
    hi = lo.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if lo.item() != hi.item():
        raise RuntimeError(f'the ranks hold different {what}')


def _flat_tensors(state):
    """Every tensor a rank holds of the train state: parameters, BN
    buffers, optimizer moments."""
    out = [p.data for p in state.model.parameters()]
    out += list(state.model.buffers())
    for slot, v in state.opt_state.items():
        if slot != 'count':
            out += list(v)
    return out


def collective_device(group, device):
    """Where a small host-side value travels: the rank's card `device`
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == 'nccl':
        return torch.device(device)
    return torch.device('cpu')


def broadcast_state(state, group, src=0):
    """Copy rank `src`'s parameters, BN buffers, optimizer moments and step
    counts to every rank of `group` (the JAX package initialises once and
    replicates, engine/train.py:155-161), in one broadcast of a flat
    buffer and one of the counts."""
    tensors = _flat_tensors(state)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.broadcast(flat, src, group=group)
    off = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    counts = torch.tensor([state.step, state.opt_state['count']],
                          dtype=torch.int64,
                          device=collective_device(group, flat.device))
    dist.broadcast(counts, src, group=group)
    state.step, state.opt_state['count'] = (int(c) for c in counts.tolist())
    return state


def all_reduce_mean_(tensors, group):
    """Replace each tensor by its mean over the ranks of `group` (the
    pmean), in one all-reduce of their concatenation; returns the bytes
    all-reduced."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return flat.numel() * flat.element_size()


def mean_losses(ld, group):
    """The loss dict averaged over the ranks (pmean), detached."""
    keys = sorted(ld)
    vals = [ld[k].detach().float().reshape(1).clone() for k in keys]
    all_reduce_mean_(vals, group)
    return {k: v.reshape(()) for k, v in zip(keys, vals)}


def average_grads(state, group):
    """pmean of every parameter's grad over `group`, in place (a parameter
    without a grad counts as zeros, as in the optimizer)."""
    for p in state.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return all_reduce_mean_([p.grad for p in state.params], group)


def make_parallel_train_step(cfg, group):
    """`step(state, batch, lr, bb_w, cs_w) -> (state, loss dict)` of one
    rank, `batch` its shard: forward (BN moments over every rank), losses,
    backward, the grads and the loss dict pmean'd, the optimizer update.
    `state.model` must be built with `group`
    (engine/state.build_model(..., group=group))."""
    def step(state, batch, lr, bb_w, cs_w):
        ld = S.forward_losses(cfg, state, batch, bb_w, cs_w)
        S.backward(ld)
        average_grads(state, group)
        ld = mean_losses(ld, group)
        S.apply_update(state, lr)
        return state, ld
    return step


def make_parallel_val_step(cfg, group):
    """`step(state, batch, bb_w, cs_w) -> loss dict`: the eval-mode losses
    of the rank's shard (BN on its running statistics: no collective in
    the forward), averaged over the ranks (mesh.py:63-78)."""
    val = S.make_val_step(cfg)

    def step(state, batch, bb_w, cs_w):
        return mean_losses(val(state, batch, bb_w, cs_w), group)
    return step


def replica_digest(state):
    """A 63-bit digest of the bytes of the rank's parameters and BN
    buffers."""
    h = hashlib.sha256()
    for t in list(state.model.parameters()) + list(state.model.buffers()):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return int.from_bytes(h.digest()[:8], 'little') >> 1


def check_replicas(state, group):
    """Raise unless every rank of `group` holds the same parameters and BN
    buffers, bit for bit."""
    same_on_every_rank(replica_digest(state), group,
                       next(state.model.parameters()).device, 'parameters')
