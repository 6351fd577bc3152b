#!/usr/bin/env python3
"""Where a spatially sharded rank's train-step memory goes, and what the
f32 train-mode grads distance of chip_smoke.py phase 16 (c) is made of (one
NVIDIA GPU).

  python3 scripts/spatial_diagnose.py

Builds the kernels and phase 16's ARKitScenes fixture, then on its first
val scene, from phase 16's seeded weights, for the one-device SelectionNet
and for rank 0 of the SpatialSelectionNet on 2 gloo ranks sharing the card:

  * [memory]: one train-mode forward and backward with the kernels: the
    bytes autograd saves for the backward, by the net's top-level module
    that was running (its level: stem, down / enc / up / dec l, heads; the
    glue code after a module counts with it), each storage once, the
    parameters and the batch left out; the memory held after the forward,
    the forward's peak and the backward's peak, each over what was
    allocated before the forward;
  * [grads32]: the unrounded f32 twins' train-mode grads (phase 16 (c)'s
    check), sharded and averaged over the ranks against one device's: the
    L2 distance, the cosine and the tensors with the largest share of the
    difference, each with its own relative distance; the same with batch
    moments in one group of BNs only (heads, levels < G, levels >= G), the
    others on their running statistics; and one device's own distance when
    its input features move by 1e-7 relative (3 draws), which is how far
    f32 rounding alone moves this function's train-mode grads.

Prints one JSON line each, then the card's name and power limit.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import chip_smoke as CS  # noqa: E402
from box2mask_torch.convert import kaiming_init_  # noqa: E402
from box2mask_torch.datasets import tables  # noqa: E402
from box2mask_torch.engine import state as S  # noqa: E402
from box2mask_torch.engine.hostload import upload  # noqa: E402
from box2mask_torch.nn.losses import compute_losses  # noqa: E402
from box2mask_torch.nn.modules import MaskedBatchNorm  # noqa: E402
from box2mask_torch.parallel import mesh as M  # noqa: E402
from box2mask_torch.parallel import spatial as SP  # noqa: E402
from box2mask_torch.sparse import _build  # noqa: E402

_LEVEL = re.compile(r'(?:stem|(?:down|enc|up|dec)(\d))_')
BN_GROUPS = ('heads', 'sharded', 'replicated')
PERTURB, DRAWS, TOP = 1e-7, 3, 8


def level(name):
    """'l0' ... 'l7' of a top-level module's name, or 'heads'."""
    m = _LEVEL.match(name)
    return f'l{m.group(1) or 0}' if m else 'heads'


class SavedTally:
    """Bytes autograd saves for the backward while `hooks()` is on, by the
    top-level module of `model` that ran last, each storage once; the
    storages in `exclude` do not count."""

    def __init__(self, model, exclude):
        self.by, self.seen, self.where = {}, set(exclude), 'input'
        self.handles = []
        for name, m in model.named_children():
            self.handles.append(m.register_forward_pre_hook(
                lambda mod, inp, n=name: setattr(self, 'where', n)))

    def pack(self, t):
        s = t.untyped_storage()
        if s.data_ptr() not in self.seen:
            self.seen.add(s.data_ptr())
            self.by[self.where] = self.by.get(self.where, 0) + s.nbytes()
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        lambda t: t)

    def by_level(self):
        out = {}
        for name, b in self.by.items():
            k = level(name)
            out[k] = out.get(k, 0) + b
        return {k: round(v / 1e9, 4) for k, v in sorted(out.items())}

    def close(self):
        for h in self.handles:
            h.remove()


def storages(tensors):
    return {t.untyped_storage().data_ptr() for t in tensors
            if isinstance(t, torch.Tensor)}


def memory(cfg, model, batch, device):
    """[memory] of one train-mode forward and backward with the kernels."""
    model.train()
    bb_w, cs_w = S.head_weights(cfg, 200)
    full = S.ensure_maps(batch) if not isinstance(
        model, SP.SpatialSelectionNet) else batch
    tally = SavedTally(model, storages(list(model.parameters())
                                       + list(model.buffers())
                                       + list(full.values())))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    with tally.hooks():
        loss = compute_losses(cfg, model(full), full, bb_w, cs_w)[
            'optimization_loss']
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(device) - base
    fwd_peak = torch.cuda.max_memory_allocated(device) - base
    torch.cuda.reset_peak_memory_stats(device)
    loss.backward()
    torch.cuda.synchronize()
    bwd_peak = torch.cuda.max_memory_allocated(device) - base
    tally.close()
    model.zero_grad(set_to_none=True)
    by = tally.by_level()
    return {'saved_GB_by_level': by,
            'saved_GB': round(sum(by.values()), 4),
            'held_after_forward_GB': round(held / 1e9, 4),
            'forward_peak_GB': round(fwd_peak / 1e9, 4),
            'backward_peak_GB': round(bwd_peak / 1e9, 4)}


def bn_group(name, G):
    m = _LEVEL.match(name)
    if not m:
        return 'heads'
    return 'sharded' if int(m.group(1) or 0) < G else 'replicated'


def grads32(cfg32, model, sd, batch, G, train, group=None, eps=0.0,
            gen=None):
    """The unrounded twins' grads of one forward (BN on batch moments in
    every BN with `train` True, in BN_GROUPS `train` alone, or on the
    running statistics with False), the input features moved by `eps`
    relative; averaged over `group`. On the host."""
    model.load_state_dict(sd)
    model.train(train is not False)
    if isinstance(train, str):
        for n, m in model.named_modules():
            if isinstance(m, MaskedBatchNorm):
                m.train(bn_group(n, G) == train)
    full = batch if group is not None else S.ensure_maps(batch)
    if eps:
        key = 'vox_features'
        f = full[key]
        full = dict(full, **{key: f * (1 + eps * torch.randn(
            f.shape, generator=gen).to(f.device))})
    bb_w, cs_w = S.head_weights(cfg32, 200)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    with CS.unrounded_twins():
        loss = compute_losses(cfg32, model(full), full, bb_w, cs_w)[
            'optimization_loss']
        gs = torch.autograd.grad(loss, params, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for g, p in zip(gs, params)]
    if group is not None:
        M.all_reduce_mean_(gs, group)
    model.load_state_dict(sd)
    return {n: g.detach().cpu() for n, g in zip(names, gs)}


def split(a, b):
    """L2 distance of a from b over every tensor, the cosine, and the TOP
    tensors by share of the squared difference, each with its own relative
    distance and its share of |b|^2."""
    l2, cos, _ = CS.grad_distance(a, b)
    d = {k: float((a[k].double() - b[k].double()).square().sum()) for k in b}
    n = {k: float(b[k].double().square().sum()) for k in b}
    dt, nt = sum(d.values()), sum(n.values())
    top = sorted(d, key=d.get, reverse=True)[:TOP]
    by_level = {}
    for k in b:
        lv = level(k.split('.')[0])
        by_level[lv] = by_level.get(lv, 0.0) + d[k] / max(dt, 1e-300)
    return {'L2': l2, 'cosine': cos,
            'share_by_level': {k: round(v, 4)
                               for k, v in sorted(by_level.items())},
            'top': [[k, round(d[k] / max(dt, 1e-300), 4),
                     (d[k] / max(n[k], 1e-300)) ** 0.5,
                     round(n[k] / nt, 4)] for k in top]}


def rank_main(rank, world, backend, init, out_dir, data_dir):
    try:
        device = CS.resolve_device(torch.device('cuda', 0))
        group = M.init_data_parallel(rank, world, backend, init, device,
                                     timeout=900)
        try:
            res = rank_run(rank, group, device, out_dir, data_dir)
        finally:
            M.teardown()
        torch.save(res, os.path.join(out_dir, f'rank{rank}.pt'))
    except BaseException:
        with open(os.path.join(out_dir, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def rank_run(rank, group, device, out_dir, data_dir):
    cfg = CS.spatial_cfg(data_dir)
    cfg32 = CS.spatial_cfg(data_dir, f32=True)
    G = cfg.spatial_gather_level
    n_classes = len(tables.get_tables('arkitscenes')[0])
    sd = torch.load(os.path.join(out_dir, 'weights.pt'))
    dev_np, host = CS.first_batch(CS.spatial_dataset(cfg))
    batch = SP.local_batch(dev_np, rank, device)
    model = SP.build_spatial_model(cfg, n_classes, device, group)
    model.load_state_dict(sd)
    model(batch)                                            # warm-up
    model.zero_grad(set_to_none=True)
    out = {'memory': memory(cfg, model, batch, device),
           'rows': {f'l{l}': int(dev_np[f'sp_num{l}'][rank])
                    for l in range(G)},
           'pads': host['spatial_meta']['pads'],
           'halos': host['spatial_meta']['halos']}
    out['rows'].update({f'l{l}': int(np.asarray(dev_np[f'g_num{l}']).sum())
                        for l in range(G, 8)})
    del model
    torch.cuda.empty_cache()
    model32 = SP.build_spatial_model(cfg32, n_classes, device, group)
    model32.load_state_dict(sd)
    out['grads32'] = {str(t): grads32(cfg32, model32, sd, batch, G, t, group)
                      for t in (True,) + BN_GROUPS}
    return out


def run_ranks(data_dir, out_dir):
    init = 'file://' + os.path.join(out_dir, 'init')
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=rank_main, args=(r, 2, 'gloo', init,
                                                 out_dir, data_dir))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(1200)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    for r in range(2):
        err = os.path.join(out_dir, f'rank{r}.err')
        if os.path.exists(err):
            with open(err) as f:
                raise RuntimeError(f'rank {r}: {f.read()}')
    return [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                       weights_only=False) for r in range(2)]


def main():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    _build.build_all()
    device = CS.resolve_device(None)
    root = tempfile.mkdtemp(prefix='b2m_spdiag_')
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'exp')
    try:
        data_dir = os.path.join(root, 'arkitscenes')
        CS.spatial_fixtures(data_dir)
        cfg = CS.spatial_cfg(data_dir, sharded=False)
        cfg32 = CS.spatial_cfg(data_dir, sharded=False, f32=True)
        G = CS.spatial_cfg(data_dir).spatial_gather_level
        n_classes = len(tables.get_tables('arkitscenes')[0])
        model = S.build_model(cfg, n_classes, device)
        kaiming_init_(model, torch.Generator().manual_seed(1))
        sd = {k: v.detach().cpu().clone()
              for k, v in model.state_dict().items()}
        torch.save(sd, os.path.join(root, 'weights.pt'))
        dev_np, host = CS.first_batch(CS.spatial_dataset(cfg))
        batch = upload(dev_np, device)
        S.forward(model, batch)                             # warm-up
        one = {'memory': memory(cfg, model, batch, device),
               'voxels': host['num_voxels'][0]}
        del model
        torch.cuda.empty_cache()
        model32 = S.build_model(cfg32, n_classes, device)
        ref = {str(t): grads32(cfg32, model32, sd, batch, G, t)
               for t in (True,) + BN_GROUPS}
        gen = torch.Generator().manual_seed(7)
        perturbed = [split(grads32(cfg32, model32, sd, batch, G, True,
                                   eps=PERTURB, gen=gen), ref['True'])
                     for _ in range(DRAWS)]
        del model32, batch
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = run_ranks(data_dir, root)
        ranks_s = time.perf_counter() - t0
        r0 = res[0]
        CS.log('[memory] ' + json.dumps({
            'card': smi, 'voxels': one['voxels'],
            'one_device': one['memory'], 'rank0': r0['memory'],
            'rank1': res[1]['memory'], 'rank0_rows_by_level': r0['rows'],
            'pads': r0['pads'], 'halos': r0['halos']}))
        for t in (True,) + BN_GROUPS:
            CS.log('[grads32] ' + json.dumps({
                'card': smi, 'batch_moments_in': 'every BN' if t is True
                else t, 'sharded_vs_one_device': split(
                    r0['grads32'][str(t)], ref[str(t)])}))
        CS.log('[grads32] ' + json.dumps({
            'card': smi, 'batch_moments_in': 'every BN',
            f'one_device_inputs_moved_{PERTURB:g}': perturbed,
            'ranks_s': ranks_s}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(smi)


if __name__ == '__main__':
    main()
