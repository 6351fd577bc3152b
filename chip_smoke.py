#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (python3 chip_smoke.py).

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels of box2mask_torch/csrc with nvcc;
  2. each kernel mode against its plain PyTorch twin on the card, at the
     main path's shapes (keys of 4 ScanNet-scale synthetic scenes), timed;
  3. the slice: FusedInferencePipeline.run over 3 batches of 4 unique
     ScanNet-scale scenes (configs/scannet.txt: layers 2, bf16 activations,
     cin 6, 4 heads, segment pooling) with seeded kaiming weights; every
     scene returns results, every kernel mode launched, no twin ran; then
     where its time goes: each stage of a batch run alone and synchronized,
     and one batch's forward + post-processing under torch.profiler (device
     busy time, idle share, kernels by device time);
  4. the whole forward with the kernels against the same forward with the
     plain twins, on one of those batches;
  5. the weight-gradient kernels (dw in its three modes, stem dw) against
     their plain twins at the training path's shapes (keys of 8 ScanNet-scale
     scenes), timed, with the device time of the level-0 dw and of the stem
     dw split by kernel;
  6. the training slice: configs/scannet.txt as it ships (layers 2, bf16
     activations, batch size 8, augmentation, box supervision, no remat) on
     2 unique batches of 8 labelled ScanNet-scale synthetic scenes from the
     port's loader, seeded kaiming weights, 6 train steps each with its own
     learning rate; every loss finite, every kernel mode launched (dw and
     stem dw included), no twin ran; then the step split into forward,
     backward and optimizer (each run alone and synchronized), peak memory,
     and one step under torch.profiler;
  7. one step's gradients with the kernels against the plain twins'
     backward on the kernels' own forward, and against the twins' whole
     step, per parameter tensor;
  8. the neighbor-map kernels (sparse_conv: stem, 3^3, down; gather_rows:
     the up convs' row pick) against their plain twins on the neighbor maps
     of the same 4 ScanNet-scale scenes, timed (gather_rows and
     torch.index_select also by device time alone), and the map build
     (ensure_maps) of one batch timed;
  9. the neighbor-map slice: phase 3 under --key_conv off --pallas_conv on,
     the same scenes and weights; every scene returns results, 64
     sparse_conv and 7 gather_rows launches per batch, no twin, no
     key_conv kernel and no call of the ops' plain XLA formulation
     (sparse/ops.py XLA_CALLS) ran; then its stages and one batch under
     torch.profiler;
 10. that forward with the kernels against the same forward with the plain
     twins, and against the key path's forward (phase 4's bounds);
 11. the evaluation slice: `python -m box2mask_torch.evaluate`'s main(),
     in-process, on configs/scannet.txt with 8 synthetic ScanNet-scale val
     scenes (the phase 3 recipe, test-time augmentation under a fixed
     seed) at --eval_batch_size 4, from a checkpoint of seeded kaiming
     weights (engine/checkpoint.save_checkpoint) in a temporary experiment
     root: the checkpoint loaded, 8 scenes with results, every key-path
     forward kernel mode launched and no twin ran, each scene's results
     bit-equal to FusedInferencePipeline.run on the same batches and
     weights (both under deterministic index_add_), the C mask unpack
     bit-equal to NumPy's on every scene's full-width voxel rows, table.txt
     written, and a second eval from the cache with the same AP and no
     launch; one `[eval]` line of its times (scenes/s of
     fused_dataset_results, the loader's seconds alone, seconds of the AP
     protocol, native and NumPy voxelize and unpack ms per scene).
Prints the card's name and power limit, one JSON line of per-kernel numbers,
and last `{"ok": true, "device": {...}}`.
"""

import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from box2mask_torch import evaluate as eval_cli
from box2mask_torch.config import get_config
from box2mask_torch.convert import kaiming_init_
from box2mask_torch.datasets import batching, loader, synthetic, tables
from box2mask_torch.datasets.voxelize import voxelize_scene
from box2mask_torch.engine import checkpoint, state as S
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.engine.infer import FusedInferencePipeline, upload
from box2mask_torch.postprocess import device_post as DP
from box2mask_torch.postprocess.device_post import (fused_postproc,
                                                    stacked_masks_to_results)
from box2mask_torch.runtime import resolve_device
from box2mask_torch.sparse import _build, key_conv as KC
from box2mask_torch.sparse import ops, pallas_conv as PC
from box2mask_torch.sparse.keys import SENT_KEY

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, N_BATCHES = 4, 3
TRAIN_STEPS = 6
FWD_MODES = ('same', 'down', 'up', 'stem')
HBM_BYTES_S = 3.35e12           # H100 SXM, NVIDIA data sheet
BF16_FLOP_S = 989e12
F32_TOL = 2e-5                  # of max |twin|: f32 sum order only
# dw sums n = up to ~1M rows per element in another order on each side (the
# kernel in 64-row tensor-core steps per slice, then over the slices; the
# twin's GEMM along the rows). A recursive f32 sum of n terms strays by
# ~sqrt(n) * 2^-24 of the sum of their absolute values: the bound is 4x
# that, of max (|x|^T |g|), the twin on absolute values. Each dw is also
# held to an f64 sum of the same bf16 operands, and both sides' distance
# from it is printed.
def dw_tol(n_rows):
    return 4 * n_rows ** 0.5 * 2.0 ** -24


FWD_MAX_TOL = 2e-2              # of max |head|: bf16 rounding flips
FWD_MEAN_TOL = 4e-3             # (the CPU forward test's bf16_acts bounds)
SRC = 'box2mask_torch/csrc/key_conv.cu'
NMAP_SRC = 'box2mask_torch/csrc/nmap_conv.cu'
TPU_NMAP_CONV = 'box2mask_tpu/sparse/pallas_conv.py:36'   # _kernel
TPU_GATHER = 'box2mask_tpu/sparse/pallas_conv.py:148'     # _gather_kernel
NMAP_FLAGS = ['--key_conv', 'off', '--pallas_conv', 'on']
TPU_KERNEL = 'box2mask_tpu/sparse/key_conv.py:116'     # _kernel
TPU_STEM = 'box2mask_tpu/sparse/key_conv.py:542'       # _stem_kernel
TPU_DW = 'box2mask_tpu/sparse/key_conv.py:814'         # _dw_kernel
TPU_STEM_DW = 'box2mask_tpu/sparse/key_conv.py:557'    # _stem_dw_kernel
# one step's grads, kernels vs twins: |diff| / |twin| over all tensors (L2)
# and the cosine of the two grad vectors, two ways. Each launch of the step
# is held to its twin on its own inputs as well, to the kernel tolerances
# above.
# (a) The twins' backward on the kernels' forward graph. With the forward
# fixed the backward is linear in its incoming gradient, so the two differ
# only by each launch's sum order and the bf16 roundings of dx it flips:
# the bound is the unrounded CPU step test's (tests/test_torch_train_step.py).
GRAD_BWD_L2_TOL, GRAD_BWD_COS_TOL = 1e-2, 0.9999
# (b) The twins' whole step. Every conv rounds its operands to bf16, so an
# f32 sum that lands near a rounding boundary in one version rounds the
# other way in the next conv, and the train-mode network amplifies those
# flips through its deep, few-row levels: nine readings of the same trees
# spread over L2 0.089-0.274, cosine 0.975-0.996. The bounds are those of
# the CPU test of the same comparison, the port's step against the JAX
# package's under --bf16_acts (tests/test_torch_train_step_bf16.py), loss
# 1.5e-2 relative included.
GRAD_L2_TOL, GRAD_COS_TOL, LOSS_TOL = 0.5, 0.9, 1.5e-2


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps=7):
    """Median over `reps` single calls, CUDA events, after a warm-up."""
    fn()
    ts = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        ts.append(e0.elapsed_time(e1))
    return statistics.median(ts)


def bf16_ulp(v):
    """One bf16 ulp at each element's magnitude (8-bit significand). Two
    sides whose f32 sums differ only in summation order round to the same or
    a neighbouring bf16 value: within the larger of their ulps, plus the f32
    sum-order error where a sum cancels to a small value."""
    e = torch.floor(torch.log2(v.abs().clamp(min=1e-30)))
    return torch.exp2(e - 7)


def hits(kin, kout, **kw):
    """Matched (row, offset) pairs of this run's keys: the twin of a
    1-channel all-ones conv counts them exactly."""
    K = 125 if kw.get('kernel_size') == 5 else (
        8 if kw.get('kernel_size') == 2 else 27)
    ones = torch.ones(kin.numel(), 1, device=kin.device)
    w = torch.ones(K, 1, 1, device=kin.device)
    return int(KC.key_conv_plain(ones, kin, kout, w, **kw).sum().item())


FWD_M, DW_M = 128, 64           # output rows per tile: forward, dw kernel


def tile_rows(hit_cols, m):
    """Rows the tensor cores multiply at m-row tiles: the live (tile,
    offset) pairs (at least one hit in the tile) x m. hit_cols yields one
    (rows,) bool hit mask per offset."""
    live = 0
    for h in hit_cols:
        h = torch.cat([h, h.new_zeros(-h.numel() % m)])
        live += int(h.view(-1, m).any(1).sum())
    return live * m


def occupancy(kin, kout, m, kernel_size=3, stride_child=False,
              stride_parent=False, scale=1, guard=True):
    """Live (tile, offset) pairs x m of a key conv, from the twin's masks."""
    return tile_rows((hit for hit, _ in KC._matches(
        kin, kout, kernel_size, stride_child, stride_parent, scale, guard)),
        m)


def occ_txt(n_hits, rows):
    return (f'occupancy {n_hits} hits / {rows} tile rows multiplied = '
            f'{n_hits / max(rows, 1):.3f}')


def bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def dw_check(x, g, kin, kout, a, b, **kw):
    """A dw kernel result `a` and its twin's `b` against the bound
    dw_tol(rows) of max |x|^T|g|, and both against the f64 sum. Returns
    (max |a - b|, tolerance, a's and b's distance from the f64 sum over
    max |x|^T|g|, ok)."""
    f64 = dict(operand_dtype=torch.float64)
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    ref = KC.key_conv_dw_plain(xb, gb, kin, kout, **f64, **kw)
    scale = KC.key_conv_dw_plain(xb.abs(), gb.abs(), kin, kout, **f64,
                                 **kw).max().item()
    tol = dw_tol(kout.numel()) * scale
    err = (a - b).abs().max().item()
    d_a = (a.double() - ref).abs().max().item() / scale
    d_b = (b.double() - ref).abs().max().item() / scale
    ok = (err <= tol and d_a <= dw_tol(kout.numel())
          and a.shape == b.shape and bool(torch.isfinite(a).all()))
    return err, tol, d_a, d_b, ok


def kernel_phase(dev, g):
    """Each mode at the main path's shapes: kernel vs plain twin."""
    keys = [dev[f'keys{l}_b'] for l in range(8)]
    sites = [  # name, mode, cin, cout, keys in, keys out, kwargs
        ('same3_l0_96', 'same', 96, 96, 0, 0, dict(kernel_size=3, scale=1)),
        ('same3_l0_128_96', 'same', 128, 96, 0, 0,      # dec0_block0
         dict(kernel_size=3, scale=1)),
        ('same3_l2_64', 'same', 64, 64, 2, 2,           # enc2 blocks
         dict(kernel_size=3, scale=4)),
        ('same3_l3_256', 'same', 256, 256, 3, 3,
         dict(kernel_size=3, scale=8)),
        ('down_l0_32', 'down', 32, 32, 0, 1,
         dict(kernel_size=2, stride_child=True, scale=1, guard=False)),
        ('down_l2_64', 'down', 64, 64, 2, 3,            # down3
         dict(kernel_size=2, stride_child=True, scale=4, guard=False)),
        ('up_l1_96', 'up', 96, 96, 1, 0,
         dict(kernel_size=2, stride_parent=True, scale=1, guard=False)),
        ('stem5_l0_6_32', 'stem', 6, 32, 0, 0, dict(kernel_size=5)),
    ]
    rows = []
    for name, mode, cin, cout, li, lo, kw in sites:
        kin, kout = keys[li], keys[lo].reshape(-1)
        K = {'same': 27, 'stem': 125}.get(mode, 8)
        x32 = torch.randn(kin.numel(), cin, generator=g).to('cuda')
        w = (torch.randn(K, cin, cout, generator=g)
             * (2.0 / (K * cout)) ** 0.5).to('cuda')
        n_hits = hits(kin, kout, **kw)
        occ = occ_txt(n_hits, occupancy(kin, kout, FWD_M, **kw))
        n_in = int((kin < SENT_KEY).sum())
        n_kout = int((kout < SENT_KEY).sum())
        dtypes = (torch.float32,) if mode == 'stem' else (
            torch.float32, torch.bfloat16)
        for dt in dtypes:
            x = x32.to(dt)
            if mode == 'stem':
                kern = lambda: KC.key_conv_stem(x, kin, w)          # noqa
                twin = lambda: KC.key_conv_plain(                   # noqa
                    x, kin, kout, w, out_dtype=torch.float32, **kw)
            else:
                kern = lambda: KC.key_conv(x, kin, kout, w, **kw)   # noqa
                twin = lambda: KC.key_conv_plain(x, kin, kout, w, **kw)  # noqa
            a, b = kern(), twin()
            torch.cuda.synchronize()
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f'{name}: {a.dtype}{tuple(a.shape)} vs '
                                     f'{b.dtype}{tuple(b.shape)}')
            err = (a.float() - b.float()).abs()
            ref = b.float().abs().max().item()
            if dt == torch.float32:
                tol_txt = f'{F32_TOL:g} * max|twin| = {F32_TOL * ref:.3e}'
                ok = err.max().item() <= F32_TOL * ref
            else:
                tol_txt = (f'one bf16 rounding step + {F32_TOL:g} * '
                           'max|twin| per element')
                ulp = torch.maximum(bf16_ulp(a.float()), bf16_ulp(b.float()))
                ok = bool((err <= ulp + F32_TOL * ref).all())
            if not ok or ref == 0 or not torch.isfinite(a).all():
                raise AssertionError(f'{name} {dt}: max err {err.max()} '
                                     f'(tol {tol_txt}, max|twin| {ref})')
            ms, plain_ms = time_ms(kern), time_ms(twin)
            # least traffic: the valid input rows and keys read once, w as
            # the bf16 the kernel multiplies, the dense output written once
            out_bytes = a.numel() * a.element_size()
            keys_bytes = 4 * (n_in + (0 if li == lo else n_kout))
            nbytes = (n_in * cin * x.element_size() + keys_bytes
                      + w.numel() * 2 + out_bytes)
            flops = 2.0 * n_hits * cin * cout
            bound_ms, bound_by = bound(nbytes, flops)
            row = dict(name=f'{name}_{str(dt)[6:]}', mode=mode,
                       max_abs_err=err.max().item(), tol=tol_txt, ms=ms,
                       plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, flops=flops,
                       hits=n_hits)
            log(f'[kernel] {row["name"]}: max_abs_err {row["max_abs_err"]:.3e}'
                f' (tol {tol_txt}) kernel {ms:.3f} ms, plain twin '
                f'{plain_ms:.3f} ms, bound {row["bound_ms"]:.4f} ms '
                f'({row["bound_by"]}; {nbytes} B, {flops:.3e} FLOP); {occ}')
            rows.append(row)
    return rows


def traced_ms(fn, reps):
    """fn() `reps` times under torch.profiler: per kernel name, the mean
    device ms of the launches the trace holds and their count. The trace
    drops launches right after the profiler starts (a level-0 dw call lost
    its first two kernels), so a kernel's time is the mean over the
    launches it caught, not a sum over the calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    agg = {}
    for e in prof.events():
        if e.device_type.name == 'CUDA':
            m = re.search(r'(\w+_kernel)', e.name)
            k = m.group(1) if m else e.name[:40]
            t, c = agg.get(k, (0.0, 0))
            agg[k] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return {k: (t / c, c) for k, (t, c) in agg.items()}


def device_ms(fn, reps=20):
    """Device time of one call of fn, whose kernels each launch once per
    call: the sum over its kernels of traced_ms's mean; and the count of
    launches traced of the `reps` calls."""
    agg = traced_ms(fn, reps)
    return (sum(t for t, _ in agg.values()),
            min((c for _, c in agg.values()), default=0))


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def stage_phase(pipe, cfg, batches, device, smi, tag=''):
    """Where the slice's time goes: per batch, each stage run alone and
    synchronized (the maps of ensure_maps apart from the forward); then one
    batch's maps + forward + post-processing under torch.profiler: device
    busy time, wall time, idle share, top kernels."""
    ths = torch.tensor(cfg.eval_ths, dtype=torch.float32, device=device)
    rows = []
    for dev_np, host in batches:
        batch, t_up = sync_ms(lambda: upload(dev_np, device))
        full, t_maps = sync_ms(lambda: S.ensure_maps(batch))
        pred, t_fwd = sync_ms(lambda: pipe.model(full))
        out, t_post = sync_ms(lambda: fused_postproc(
            pipe.core, cfg, pred, full, ths, pipe.top_k))
        t0 = time.perf_counter()
        out_np = {k: v.cpu().numpy() for k, v in out.items()}
        stacked_masks_to_results(out_np, host, pipe.valid_class_ids,
                                 post_fallback=pipe.post_full, pred=pred,
                                 dev_t=full, ths=ths)
        rows.append({'upload_ms': t_up, 'maps_ms': t_maps,
                     'forward_ms': t_fwd,
                     'postproc_ms': t_post,
                     'd2h_unpack_ms': (time.perf_counter() - t0) * 1e3,
                     'n_keep': out_np['n_keep'].tolist()})
    log(f'[{tag}stages] ' + json.dumps({'card': smi, 'per_batch': rows}))

    batch = upload(batches[0][0], device)

    def window():
        full = S.ensure_maps(batch)
        fused_postproc(pipe.core, cfg, pipe.model(full), full, ths,
                       pipe.top_k)
    profile_window(f'{tag}profile', window, smi)


def profile_window(tag, fn, smi):
    """fn() under torch.profiler: wall time, device busy time, idle share
    and the kernels by device time, as one `[tag]` JSON line."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    agg = {}
    for e in prof.events():             # device-side events: kernels, copies
        if e.device_type.name == 'CUDA':
            t, c = agg.get(e.name, (0.0, 0))
            agg[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    top = sorted(agg.items(), key=lambda kv: -kv[1][0])
    busy = sum(t for t, _ in agg.values())
    log(f'[{tag}] ' + json.dumps({
        'card': smi, 'wall_ms': wall_ms, 'device_busy_ms': busy,
        'idle_share': 1.0 - busy / wall_ms,
        'top': [{'name': k[:100], 'ms': t, 'calls': c}
                for k, (t, c) in top[:12]]}))
    if busy <= 0:
        raise AssertionError('the profiler saw no device time')


def dw_phase(dev, g):
    """dw in its three modes and the stem dw at the training path's shapes
    (bf16 x and g as the backward gives them; the stem's g is f32): kernel
    vs plain twin, timed."""
    keys = [dev[f'keys{l}_b'] for l in range(8)]
    sites = [  # name, mode, cin, cout, keys in, keys out, kwargs
        ('dw_same3_l0_96', 'dw', 96, 96, 0, 0, dict(kernel_size=3, scale=1)),
        ('dw_same3_l0_128_96', 'dw', 128, 96, 0, 0,      # dec0_block0
         dict(kernel_size=3, scale=1)),
        ('dw_same3_l2_64', 'dw', 64, 64, 2, 2, dict(kernel_size=3, scale=4)),
        ('dw_same3_l3_256', 'dw', 256, 256, 3, 3,
         dict(kernel_size=3, scale=8)),
        ('dw_down_l0_32', 'dw', 32, 32, 0, 1,
         dict(kernel_size=2, stride_child=True, scale=1, guard=False)),
        ('dw_up_l1_96', 'dw', 96, 96, 1, 0,              # up0_tr
         dict(kernel_size=2, stride_parent=True, scale=1, guard=False)),
        ('stem_dw_6_32', 'stem_dw', 6, 32, 0, 0, dict(kernel_size=5)),
    ]
    rows = []
    for name, mode, cin, cout, li, lo, kw in sites:
        kin, kout = keys[li], keys[lo].reshape(-1)
        x = torch.randn(kin.numel(), cin, generator=g).to('cuda',
                                                          torch.bfloat16)
        gr = torch.randn(kout.numel(), cout, generator=g).to('cuda')
        if mode == 'stem_dw':
            kern = lambda: KC.key_conv_stem_dw(x, gr, kin)          # noqa
        else:
            gr = gr.to(torch.bfloat16)
            kern = lambda: KC.key_conv_dw(x, gr, kin, kout, **kw)   # noqa
        twin = lambda: KC.key_conv_dw_plain(x, gr, kin, kout, **kw)  # noqa
        a, b = kern(), twin()
        err, tol, d_a, d_b, ok = dw_check(x, gr, kin, kout, a, b, **kw)
        tol_txt = (f'{dw_tol(kout.numel()):.2e} * max |x|^T|g| = {tol:.3e}; '
                   f'from the f64 sum: kernel {d_a:.2e}, twin {d_b:.2e} of '
                   'max |x|^T|g|')
        if not ok:
            raise AssertionError(f'{name}: max err {err} ({tol_txt})')
        if not torch.equal(a, kern()):
            raise AssertionError(f'{name}: two launches differ')
        ms, plain_ms = time_ms(kern), time_ms(twin)
        n_hits = hits(kin, kout, **kw)
        occ = occ_txt(n_hits, occupancy(kin, kout, DW_M, **kw))
        if name in ('dw_same3_l0_96', 'stem_dw_6_32'):
            dw_split(kern, name)
        n_in = int((kin < SENT_KEY).sum())
        n_kout = int((kout < SENT_KEY).sum())
        # least traffic: valid x and g rows read once as the call receives
        # them (bf16 x; bf16 g for dw, f32 g for the stem dw, whose rounding
        # is inside the call), the valid keys, the f32 dw written once
        nbytes = (n_in * cin * x.element_size()
                  + n_kout * cout * gr.element_size()
                  + 4 * (n_in + (0 if li == lo else n_kout)) + a.numel() * 4)
        flops = 2.0 * n_hits * cin * cout
        bound_ms, bound_by = bound(nbytes, flops)
        row = dict(name=name, mode=mode, max_abs_err=err, tol=tol_txt, ms=ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes=nbytes, flops=flops, hits=n_hits)
        log(f'[kernel] {name}: max_abs_err {err:.3e} (tol {tol_txt}) kernel '
            f'{ms:.3f} ms, plain twin {plain_ms:.3f} ms, bound '
            f'{bound_ms:.4f} ms ({bound_by}; {nbytes} B, {flops:.3e} FLOP); '
            f'{occ}')
        rows.append(row)
    return rows


def dw_split(fn, name, reps=5):
    """Device time of one dw launch by kernel (any pad or cast of the
    wrapper, match table, pass 1, pass 2): traced_ms over `reps` calls."""
    agg = traced_ms(fn, reps)
    log(f'[dw_split] {name}: device ms by kernel (mean over the launches '
        f'traced, of {reps} calls) ' + json.dumps(
            {k: {'ms': t, 'traced': c} for k, (t, c) in agg.items()}))


def train_batches(smi):
    """2 unique batches of 8 labelled ScanNet-scale synthetic scenes from
    the port's loader, under the preset as it ships."""
    cfg = get_config([
        '--config', os.path.join(ROOT, 'configs', 'scannet.txt'),
        '--vox_bucket', '131072', '--seg_bucket', '2048',
        '--dataset_name', 'synthetic', '--dataset_size', '16',
        '--synthetic_instances', '18',
        '--synthetic_points_per_instance', '4000',
        '--synthetic_floor_points', '45000', '--synthetic_wall_points',
        '35000', '--fixed_seed', '7', '--num_workers', '8'])
    assert (cfg.batch_size == 8 and cfg.bf16_acts and cfg.augmentation
            and cfg.bb_supervision and cfg.layers == 2 and not cfg.remat)
    t0 = time.perf_counter()
    ld = loader.get_dataset(cfg, 'train').get_loader()
    batches = list(ld)
    ld.close()
    log(f'[host] {len(batches)} train batches of {cfg.batch_size} scenes '
        f'prepared in {time.perf_counter() - t0:.1f} s; level-0 voxels per '
        f'scene {[n for _, h in batches for n in h["num_voxels"]]}')
    if len(batches) != 2:
        raise AssertionError(f'{len(batches)} train batches')
    return cfg, batches


def train_phase(cfg, batches, device, smi):
    """The training slice: TRAIN_STEPS steps, each with its own learning
    rate, cycling over the batches; then where the step's time goes."""
    n_classes = len(tables.get_tables('scannet')[0])
    tx = S.make_optimizer(cfg)
    state = S.init_state(cfg, S.build_model(cfg, n_classes), tx, seed=1)
    dev = [upload(d, device) for d, _ in batches]
    bb_w, cs_w = S.head_weights(cfg, 200)          # every head weighted
    S.train_step(cfg, state, dev[0], cfg.lr, bb_w, cs_w)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    KC.reset_counts()
    lrs = [cfg.lr * (1 - 0.1 * i) for i in range(TRAIN_STEPS)]
    losses = []
    t0 = time.perf_counter()
    for i, lr in enumerate(lrs):
        _, ld = S.train_step(cfg, state, dev[i % len(dev)], lr, bb_w, cs_w)
        losses.append(ld)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(KC.LAUNCHES), dict(KC.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated(device)
    opt = [float(ld['optimization_loss']) for ld in losses]
    finite = all(torch.isfinite(v).all().item() for ld in losses
                 for v in ld.values())
    log(f'[train] optimization_loss per step {opt} (lr {lrs}); launches '
        f'per mode over {TRAIN_STEPS} steps: {launches}; plain-twin calls: '
        f'{plain}')
    if not finite:
        raise AssertionError('non-finite losses in the training slice')
    if min(launches.values()) == 0 or sum(plain.values()) != 0:
        raise AssertionError('the train steps did not run every kernel, or '
                             'ran a plain twin')

    split = []
    for b in dev:                       # each phase run alone, synchronized
        ld, t_fwd = sync_ms(lambda: S.forward_losses(cfg, state, b, bb_w,
                                                     cs_w))
        _, t_bwd = sync_ms(lambda: S.backward(ld))
        _, t_opt = sync_ms(lambda: S.apply_update(state, lrs[-1]))
        split.append({'forward_ms': t_fwd, 'backward_ms': t_bwd,
                      'optimizer_ms': t_opt})
    scenes = TRAIN_STEPS * cfg.batch_size
    log('[train] ' + json.dumps({
        'card': smi, 'steps': TRAIN_STEPS, 'batch_size': cfg.batch_size,
        'wall_s': wall, 'steps_per_s': TRAIN_STEPS / wall,
        'scenes_per_s': scenes / wall, 'ms_per_step': wall / TRAIN_STEPS * 1e3,
        'split_per_batch': split, 'peak_max_memory_allocated_GB': peak / 1e9,
        'launches': launches}))
    profile_window('train_profile', lambda: S.train_step(
        cfg, state, dev[0], lrs[-1], bb_w, cs_w), smi)
    return state, dev, launches


def grad_distance(a, b):
    """|a - b| / |b| over all tensors (L2), the cosine of a and b, and per
    tensor max |a - b| / max |b|."""
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    dot = sum(float((a[k].double() * b[k].double()).sum()) for k in b)
    na = sum(float(a[k].double().square().sum()) for k in b)
    per = {k: ((a[k] - b[k]).abs().max() / b[k].abs().max().clamp(
        min=1e-30)).item() for k in b}
    return (num / den) ** 0.5, dot / (na * den) ** 0.5, per


def grads_phase(cfg, state, batch):
    """One step's grads with the kernels, from the same parameters (BN
    normalizes with batch moments, so the running statistics moved by one
    pass do not enter the next), against (a) the twins' backward on the
    kernels' own forward graph (the preset runs without remat, so that
    backward recomputes no forward) and (b) the twins' whole step. In the
    kernels' pass every launch is also held to its twin on the same
    inputs."""
    bb_w, cs_w = S.head_weights(cfg, 200)
    names = [n for n, _ in state.model.named_parameters()]
    params = [p for _, p in state.model.named_parameters()]
    kern = {'key_conv': KC.key_conv, 'key_conv_stem': KC.key_conv_stem,
            'key_conv_dw': KC.key_conv_dw,
            'key_conv_stem_dw': KC.key_conv_stem_dw}
    twin = {'key_conv': KC.key_conv_plain,
            'key_conv_stem': lambda x, kin, w: KC.key_conv_plain(
                x, kin, kin.reshape(-1), w, kernel_size=5,
                out_dtype=torch.float32),
            'key_conv_dw': KC.key_conv_dw_plain,
            'key_conv_stem_dw': lambda x, g, kin: KC.key_conv_dw_plain(
                x, g, kin, kin.reshape(-1), kernel_size=5)}
    worst = {}

    def checked(name):
        def fn(*a, **kw):
            out, ref = kern[name](*a, **kw), twin[name](*a, **kw)
            o, r = out.float(), ref.float()
            err = (o - r).abs()
            scale = r.abs().max().clamp(min=1e-30).item()
            rel = err.max().item() / scale
            ok = rel <= F32_TOL
            if name.endswith('_dw'):             # sums of up to ~1M rows
                x, g, *rest = a
                if name == 'key_conv_stem_dw':
                    rest, kw = [rest[0], rest[0].reshape(-1)], {
                        'kernel_size': 5}
                e, tol, d_a, d_b, ok = dw_check(x, g, *rest, out, ref, **kw)
                rel = max(d_a, d_b)
            elif out.dtype == torch.bfloat16:    # one rounding step
                ulp = torch.maximum(bf16_ulp(o), bf16_ulp(r))
                ok = bool((err <= ulp + F32_TOL * scale).all())
            key = f'{name}_{str(out.dtype)[6:]}'
            n, w, good = worst.get(key, (0, 0.0, True))
            worst[key] = (n + 1, max(w, rel), good and ok)
            return out
        return fn

    def patched(fns, fn):
        saved = {k: getattr(KC, k) for k in fns}
        for k, f in fns.items():
            setattr(KC, k, f)
        try:
            return fn()
        finally:
            for k, f in saved.items():
                setattr(KC, k, f)

    def forward():
        return S.forward_losses(cfg, state, batch, bb_w, cs_w)

    def grads(ld, retain=False):
        gs = torch.autograd.grad(ld['optimization_loss'], params,
                                 retain_graph=retain)
        return dict(zip(names, (g.detach() for g in gs)))

    def report(tag, a, b, l2_tol, cos_tol):
        l2, cos, per = grad_distance(a, b)
        log(f'[grads] {len(b)} parameter tensors, kernels vs {tag}: |diff| '
            f'/ |twin| (L2 over all) {l2:.3e} (bound {l2_tol:g}), cosine '
            f'{cos:.6f} (bound {cos_tol:g}); per tensor max |diff| / max '
            f'|twin|: median {statistics.median(per.values()):.3e}, worst '
            f'five {sorted(per.items(), key=lambda kv: -kv[1])[:5]}')
        if not (l2 <= l2_tol and cos >= cos_tol):
            raise AssertionError(f'grads: kernels vs {tag} L2 {l2}, cos {cos}')

    checked_fns = {k: checked(k) for k in kern}
    ld_k = patched(checked_fns, forward)
    gk = patched(checked_fns, lambda: grads(ld_k, retain=True))
    log('[grads] every launch of one step vs its twin on the same inputs '
        '(calls, worst max |diff| / max |twin| -- for dw the larger '
        'distance of kernel and twin from the f64 sum / max |x|^T|g| --, '
        'within tolerance): ' + json.dumps(worst))
    if not all(good for _, _, good in worst.values()):
        raise AssertionError(f'a launch differs from its twin: {worst}')
    if not all(torch.isfinite(v).all().item() for v in gk.values()):
        raise AssertionError('grads: the kernels\' step is not finite')
    gb = patched(twin, lambda: grads(ld_k))                     # (a)
    loss_k = ld_k['optimization_loss'].item()
    del ld_k
    report('the twins\' backward on the same forward', gk, gb,
           GRAD_BWD_L2_TOL, GRAD_BWD_COS_TOL)
    del gb
    ld_t = patched(twin, forward)                               # (b)
    gt, loss_t = patched(twin, lambda: grads(ld_t)), ld_t[
        'optimization_loss'].item()
    del ld_t
    log(f'[grads] optimization_loss kernels {loss_k:.6f}, twins '
        f'{loss_t:.6f}: relative {abs(loss_k - loss_t) / abs(loss_t):.3e} '
        f'(bound {LOSS_TOL:g})')
    if not abs(loss_k - loss_t) <= LOSS_TOL * abs(loss_t):
        raise AssertionError(f'loss: kernels {loss_k}, twins {loss_t}')
    report('the twins\' whole step', gk, gt, GRAD_L2_TOL, GRAD_COS_TOL)


def slice_phase(pipe, cfg, batches, smi, tag):
    """FusedInferencePipeline.run over batches[1:] after a warm-up on
    batches[0]: every scene returns finite results of the right shapes.
    The kernel counts are set to 0 just before the timed run and read just
    after; returns (key_conv launches, key_conv twin calls, pallas_conv
    launches, pallas_conv twin calls, calls of the ops' XLA formulations,
    which run plain PyTorch)."""
    for _ in pipe.run(None, batches[:1], cfg.eval_ths):     # warm-up
        pass
    finite = []                 # per batch and head, read after the run
    infer = pipe.infer

    def checked_infer(batch, ths):
        pred, full, out = infer(batch, ths)
        finite.extend(torch.isfinite(v).all() for v in pred.values())
        return pred, full, out
    pipe.infer = checked_infer
    torch.cuda.synchronize()
    KC.reset_counts()
    PC.reset_counts()
    ops.reset_counts()
    t0 = time.perf_counter()
    n_results, n_masks = 0, 0
    for results, out_np, _, host in pipe.run(None, batches[1:],
                                             cfg.eval_ths):
        names = [s['name'] for s in host['scene']]
        if sorted(results) != sorted(names):
            raise AssertionError(f'results for {sorted(results)}, '
                                 f'scenes {names}')
        for si, name in enumerate(names):
            r = results[name]
            n_pts = len(host['vox2point'][si])
            if (r['mask'].shape != (len(r['conf']), n_pts)
                    or not np.isfinite(r['conf']).all()):
                raise AssertionError(f'{name}: bad result shapes/values')
            n_masks += len(r['conf'])
        n_results += len(results)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (dict(KC.LAUNCHES), dict(KC.PLAIN_CALLS), dict(PC.LAUNCHES),
              dict(PC.PLAIN_CALLS), dict(ops.XLA_CALLS))
    pipe.infer = infer
    n_batches = len(batches) - 1
    if len(finite) != n_batches * len(cfg.network_heads) or not all(
            bool(f) for f in finite):
        raise AssertionError(f'non-finite head outputs in the {tag}')
    log(f'[{tag}] head outputs finite in all {n_batches} batches')
    log(f'[{tag}] launches over {n_batches} batches: key_conv {counts[0]}, '
        f'pallas_conv {counts[2]}; plain-twin calls: key_conv {counts[1]}, '
        f'pallas_conv {counts[3]}; XLA-formulation calls {counts[4]}')
    log(f'[{tag}] {n_results} scenes, {n_masks} masks, {wall:.3f} s -> '
        f'{n_results / wall:.3f} scenes/s on {smi}')
    return counts


def with_twins(fn):
    """fn() with every conv kernel wrapper replaced by its plain twin."""
    saved = (KC.key_conv, KC.key_conv_stem, PC.sparse_conv, PC.gather_rows)
    KC.key_conv = KC.key_conv_plain
    KC.key_conv_stem = lambda x, kin, w: KC.key_conv_plain(
        x, kin, kin.reshape(-1), w, kernel_size=5, out_dtype=torch.float32)
    PC.sparse_conv, PC.gather_rows = PC.sparse_conv_plain, PC.gather_rows_plain
    try:
        return fn()
    finally:
        (KC.key_conv, KC.key_conv_stem, PC.sparse_conv,
         PC.gather_rows) = saved


def compare_forwards(tag, pred_a, pred_b, batch, what):
    """Every head of two forwards of one batch within FWD_MAX_TOL (max) and
    FWD_MEAN_TOL (mean over valid segments) of max |b|."""
    torch.cuda.synchronize()
    seg_valid = batch['seg_valid'].bool()
    for head, b in pred_b.items():
        a = pred_a[head]
        if (a.shape != b.shape or a.shape[0] != seg_valid.shape[0]
                or a.dtype != torch.float32 or not torch.isfinite(a).all()):
            raise AssertionError(f'{head}: {a.dtype} {tuple(a.shape)}')
        scale = b.abs().max().item()
        diff = (a - b).abs()
        rel = diff.max().item() / scale
        rel_mean = diff[seg_valid].mean().item() / scale
        log(f'[{tag}] {head}: |{what}| / max |b|: max {rel:.3e} (bound '
            f'{FWD_MAX_TOL:g}), mean over valid segments {rel_mean:.3e} '
            f'(bound {FWD_MEAN_TOL:g}); bf16 rounding flips of the '
            f'activations; max |b| {scale:.3e}')
        if not (rel <= FWD_MAX_TOL and rel_mean <= FWD_MEAN_TOL):
            raise AssertionError(f'{head}: {what} differs by {rel} max, '
                                 f'{rel_mean} mean')


def nmap_kernel_phase(dev, g, smi):
    """The neighbor-map kernels against their plain twins on the maps of
    the batch's scenes (built here as ensure_maps builds them for a
    --key_conv off batch, and timed): sparse_conv at every K and the main
    path's widths, f32 and bf16 x, within F32_TOL of max |twin|;
    gather_rows on the up convs' row picks, bit-equal, beside
    torch.index_select on the same padded rows."""
    nb = dict(dev, **{batching.DEVICE_NMAPS: torch.ones(
        (), dtype=torch.bool, device='cuda')})
    maps = S.ensure_maps(nb)
    maps_ms = time_ms(lambda: S.ensure_maps(nb))
    log(f'[nmap_maps] ensure_maps (every neighbor map of one 4-scene batch) '
        f'{maps_ms:.3f} ms on {smi}')
    pads = [dev[f'keys{l}_b'].shape[1] for l in range(8)]
    B = dev['keys0_b'].shape[0]
    sites = [  # name, map, level of x, cin, cout
        ('nmap_stem5_l0_6_32', 'nmap5_0', 0, 6, 32),
        ('nmap_same3_l0_96', 'nmap3_0', 0, 96, 96),
        ('nmap_same3_l0_128_96', 'nmap3_0', 0, 128, 96),   # dec0_block0
        ('nmap_same3_l2_64', 'nmap3_2', 2, 64, 64),         # enc2 blocks
        ('nmap_same3_l3_256', 'nmap3_3', 3, 256, 256),
        ('nmap_down_l0_32', 'down0', 0, 32, 32),
        ('nmap_down_l2_64', 'down2', 2, 64, 64),            # down3
    ]
    rows = []
    for name, key, level, cin, cout in sites:
        nbr = maps[key]
        vin = B * pads[level]
        x32 = torch.randn(vin, cin, generator=g).to('cuda')
        x32[~maps[f'valid{level}']] = 0
        w = (torch.randn(nbr.shape[1], cin, cout, generator=g)
             * (2.0 / (nbr.shape[1] * cout)) ** 0.5).to('cuda')
        n_hits = int((nbr < vin).sum())
        occ = occ_txt(n_hits, tile_rows(
            (nbr[:, k] < vin for k in range(nbr.shape[1])), FWD_M))
        n_in = int(maps[f'num{level}'])
        main = torch.float32 if key == 'nmap5_0' else torch.bfloat16
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            kern = lambda: PC.sparse_conv(x, nbr, w)            # noqa
            twin = lambda: PC.sparse_conv_plain(x, nbr, w)      # noqa
            a, b = kern(), twin()
            torch.cuda.synchronize()
            err = (a - b).abs().max().item()
            ref = b.abs().max().item()
            pad_rows = (nbr >= vin).all(1)
            if (a.dtype != torch.float32 or a.shape != b.shape or ref == 0
                    or err > F32_TOL * ref or a[pad_rows].any()
                    or not torch.isfinite(a).all()):
                raise AssertionError(f'{name} {dt}: max err {err} (tol '
                                     f'{F32_TOL:g} * {ref})')
            ms, plain_ms = time_ms(kern), time_ms(twin)
            # least traffic: valid x rows, the map and bf16 w read once,
            # the f32 output written once; FLOPs of the matched pairs
            nbytes = (n_in * cin * x.element_size() + nbr.numel() * 4
                      + w.numel() * 2 + a.numel() * 4)
            flops = 2.0 * n_hits * cin * cout
            bound_ms, bound_by = bound(nbytes, flops)
            rows.append(dict(
                name=f'{name}_{str(dt)[6:]}', kernel='sparse_conv',
                main=dt == main, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
            log(f'[kernel] {rows[-1]["name"]}: max_abs_err {err:.3e} (tol '
                f'{F32_TOL:g} * max|twin| = {F32_TOL * ref:.3e}) kernel '
                f'{ms:.3f} ms, plain twin {plain_ms:.3f} ms, bound '
                f'{bound_ms:.4f} ms ({bound_by}; {nbytes} B, {flops:.3e} '
                f'FLOP); {occ}')
    for name, level, cout in (('nmap_gather_up1_0_96', 0, 96),
                              ('nmap_gather_up4_3_256', 3, 256)):
        U = B * pads[level + 1]
        parent, widx = maps[f'up_parent{level}'], maps[f'up_widx{level}']
        idx = torch.where(parent >= U, U * 8, parent * 8 + widx).to(
            torch.int32)
        y = torch.randn(U * 8, cout, generator=g).to('cuda')
        kern = lambda: PC.gather_rows(y, idx)                   # noqa
        twin = lambda: PC.gather_rows_plain(y, idx)             # noqa
        a, b = kern(), twin()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f'{name}: kernel and twin differ by '
                                 f'{(a - b).abs().max().item()}')
        yz, idx64 = torch.cat([y, y.new_zeros(1, cout)]), idx.long()
        library = lambda: torch.index_select(yz, 0, idx64)     # noqa
        library_ms = time_ms(library)
        ms, plain_ms = time_ms(kern), time_ms(twin)
        (dev_ms, dev_n), (lib_dev_ms, lib_n) = (device_ms(kern),
                                                device_ms(library))
        n_valid = int((idx < U * 8).sum())
        nbytes = idx.numel() * 4 + n_valid * cout * 4 + a.numel() * 4
        bound_ms, bound_by = bound(nbytes, 0.0)
        rows.append(dict(name=name, kernel='gather_rows', main=True,
                         max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms))
        log(f'[kernel] {name}: bit-equal to its twin; kernel {ms:.3f} ms, '
            f'plain twin {plain_ms:.3f} ms, index_select {library_ms:.3f} '
            f'ms, bound {bound_ms:.4f} ms ({bound_by}; {nbytes} B); device '
            f'time (torch.profiler, mean of the launches traced of 20): '
            f'kernel {dev_ms:.4f} ms ({dev_n} traced), index_select '
            f'{lib_dev_ms:.4f} ms ({lib_n} traced)')
    return rows


EVAL_ARGS = ['--config', os.path.join(ROOT, 'configs', 'scannet.txt'),
             '--dataset_name', 'synthetic', '--synthetic_instances', '18',
             '--synthetic_points_per_instance', '4000',
             '--synthetic_floor_points', '45000',
             '--synthetic_wall_points', '35000', '--dataset_size', '8',
             '--eval_batch_size', '4', '--fixed_seed', '11']


class RecordedEvaluater(Evaluater):
    """The CLI's Evaluater, recording what fused_dataset_results returned
    and the wall seconds of it and of the AP protocol (scannet_eval)."""
    runs = []

    def fused_dataset_results(self, dataset, ths=None, cache=True):
        t0 = time.perf_counter()
        out = super().fused_dataset_results(dataset, ths, cache)
        torch.cuda.synchronize()
        self.runs.append({'ev': self, 'results': out[0], 'entries': out[1],
                          'fused_s': time.perf_counter() - t0})
        return out

    def scannet_eval(self, results, entries, write_to_tb=None):
        t0 = time.perf_counter()
        avgs = super().scannet_eval(results, entries, write_to_tb)
        self.runs[-1].update(ap_s=time.perf_counter() - t0, avgs=avgs)
        return avgs


def same_ap(a, b):
    return all(np.array_equal(a[k], b[k], equal_nan=True)
               for k in ('all_ap', 'all_ap_50%', 'all_ap_25%'))


def eval_phase(smi):
    """Phase 11: the evaluation CLI on the card from a checkpoint, held to
    the pipeline, the C unpack held to NumPy's, the cache reload held to
    the first eval; returns the `[eval]` numbers."""
    root = tempfile.mkdtemp(prefix='b2m_eval_')
    saved_root = os.environ.get('BOX2MASK_EXP_ROOT')
    os.environ['BOX2MASK_EXP_ROOT'] = root
    saved_cli = eval_cli.Evaluater
    eval_cli.Evaluater = RecordedEvaluater
    # segment pooling sums with index_add_, whose CUDA atomics add in any
    # order: deterministic kernels make two runs comparable bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cfg = get_config(EVAL_ARGS)
        valid_ids, _, _, is_fg = tables.get_tables('scannet')
        state = S.init_state(cfg, S.build_model(cfg, len(valid_ids)),
                             S.make_optimizer(cfg), seed=2)
        ckpt_path = checkpoint.save_checkpoint(cfg.checkpoint_path, state,
                                               3600.0, 0, 0)
        ckpt_name = os.path.basename(ckpt_path)[:-5]

        torch.cuda.synchronize()
        KC.reset_counts()
        PC.reset_counts()
        ops.reset_counts()
        avgs = eval_cli.main(EVAL_ARGS)
        torch.cuda.synchronize()
        counts = (dict(KC.LAUNCHES), dict(KC.PLAIN_CALLS), dict(PC.LAUNCHES),
                  dict(PC.PLAIN_CALLS), dict(ops.XLA_CALLS))
        run = RecordedEvaluater.runs[-1]
        ev, results = run['ev'], run['results']
        log(f'[eval] launches: key_conv {counts[0]}, pallas_conv '
            f'{counts[2]}; plain-twin calls: key_conv {counts[1]}, '
            f'pallas_conv {counts[3]}; XLA-formulation calls {counts[4]}')
        if (min(counts[0][m] for m in FWD_MODES) == 0
                or sum(counts[1].values()) + sum(counts[3].values()) != 0
                or sum(counts[2].values()) + sum(counts[4].values()) != 0):
            raise AssertionError('the eval did not run every key-path kernel '
                                 'mode, or ran a twin or a neighbor-map conv')
        if ev.ckpt_name != ckpt_name:
            raise AssertionError(f'checkpoint {ckpt_name} not loaded '
                                 f'({ev.ckpt_name})')
        tables_txt = [d for d, _, fs in os.walk(ev.results_path)
                      if 'table.txt' in fs]
        if len(tables_txt) != 1 or not same_ap(avgs, run['avgs']):
            raise AssertionError(f'table.txt not written: {tables_txt}')
        names = sorted(s['name'] for _, _, h in run['entries']
                       for s in h['scene'])
        if len(names) != 8 or sorted(results) != names:
            raise AssertionError(f'results for {sorted(results)}')

        # the pipeline on the same batches with the saved weights
        pipe = FusedInferencePipeline(cfg, valid_ids, is_fg,
                                      model=state.model, top_k=128)
        harvested = []
        harvest = pipe._harvest

        def keep(pred, full, out, host, ths):
            harvested.append((pred, full, host, ths))
            return harvest(pred, full, out, host, ths)
        pipe._harvest = keep
        ds = loader.get_dataset(cfg, 'val',
                                do_augmentations=not cfg.eval_wo_aug)
        want, n_overflow, n_masks = {}, 0, 0
        for r, out_np, _, _ in pipe.run(None, ds.get_loader(
                shuffle=False, drop_last=False,
                batch_size=cfg.eval_batch_size), cfg.eval_ths):
            want.update(r)
            n_overflow += int(out_np['topk_overflow'].sum())
        for name in names:
            g, w = results[name], want[name]
            if not (np.array_equal(g['conf'], w['conf'])
                    and np.array_equal(g['label_id'], w['label_id'])
                    and np.array_equal(g['mask'], w['mask'])):
                raise AssertionError(f'{name}: the eval\'s results differ '
                                     'from the pipeline\'s')
            n_masks += len(w['conf'])
        log(f'[eval] {len(names)} scenes, {n_masks} masks, bit-equal to '
            f'FusedInferencePipeline.run; {n_overflow} top-k overflow scenes')

        # the C unpack against NumPy on every scene's full-width voxel rows
        unpack_ms = {True: [], False: []}
        n_rows = 0
        for pred, full, host, ths in harvested:
            for si in range(len(host['scene'])):
                o = {k: v.cpu().numpy() for k, v in
                     pipe.post_full(pred, full, si, ths).items()}
                n = int(o['n_keep'])
                start = si * host['interleaved_vs']
                v2p = np.asarray(host['vox2point'][si])
                masks = {}
                for native in (True, False):
                    t0 = time.perf_counter()
                    masks[native] = DP._point_masks(
                        o['masks_packed'], n, start, host['num_voxels'][si],
                        v2p, native)
                    unpack_ms[native].append(
                        (time.perf_counter() - t0) * 1e3)
                if (start % 8 or masks[True].dtype != bool
                        or not np.array_equal(masks[True], masks[False])):
                    raise AssertionError(f"{host['scene'][si]['name']}: C "
                                         'unpack differs from NumPy')
                n_rows += n
        log(f'[eval] C unpack bit-equal to NumPy on {n_rows} full-width '
            f'voxel rows of {len(names)} scenes')

        # native and NumPy voxelization of the first batch's scenes, timed.
        # They are two paths, not one held to the other (as in the JAX
        # package): the C voxelizer rounds float32 coordinates, NumPy the
        # augmented scenes' float64 ones, and they may break distance ties
        # apart; the points whose voxel differs are counted.
        vox_ms = {True: [], False: []}
        moved = 0
        for name in names[:4]:
            scene, _ = ds.read_scene(name, rng=loader.scene_rng(cfg, name))
            vox = {}
            for native in (True, False):
                c = copy.copy(cfg)
                c.use_native_host_ops = native
                t0 = time.perf_counter()
                r = voxelize_scene(scene, c)
                vox_ms[native].append((time.perf_counter() - t0) * 1e3)
                vox[native] = r['vox_coords'][r['vox2point']]
            moved += int((vox[True] != vox[False]).any(1).sum())

        # the loader alone: the host's share of fused_dataset_results
        t0 = time.perf_counter()
        for _ in ds.get_loader(shuffle=False, drop_last=False,
                               batch_size=cfg.eval_batch_size):
            pass
        loader_s = time.perf_counter() - t0

        # a second eval from the cache: the same AP, nothing launched
        KC.reset_counts()
        avgs2 = eval_cli.main(EVAL_ARGS)
        if not same_ap(avgs, avgs2) or sum(KC.LAUNCHES.values()):
            raise AssertionError(f'cache reload AP {avgs2} vs {avgs}')
        row = {
            'scenes_per_s': len(names) / run['fused_s'],
            'fused_dataset_results_s': run['fused_s'],
            'loader_alone_s': loader_s,
            'ap_protocol_s': run['ap_s'],
            'cache_reload_fused_s': RecordedEvaluater.runs[-1]['fused_s'],
            'voxelize_ms_per_scene': {
                'native': statistics.mean(vox_ms[True]),
                'numpy': statistics.mean(vox_ms[False])},
            'unpack_ms_per_scene': {
                'native': statistics.mean(unpack_ms[True]),
                'numpy': statistics.mean(unpack_ms[False])},
            'points_in_another_voxel_c_vs_numpy': moved,
            'mAP': avgs['all_ap'], 'mAP50': avgs['all_ap_50%'],
            'mAP25': avgs['all_ap_25%'], 'card': smi}
        log('[eval] ' + json.dumps(row))
        return row
    finally:
        torch.use_deterministic_algorithms(False)
        eval_cli.Evaluater = saved_cli
        if saved_root is None:
            os.environ.pop('BOX2MASK_EXP_ROOT', None)
        else:
            os.environ['BOX2MASK_EXP_ROOT'] = saved_root
        shutil.rmtree(root, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    device = resolve_device(None)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log('python', sys.version.split()[0], 'torch', torch.__version__,
        'cuda', torch.version.cuda)

    # ---- 1. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f'[build] {time.perf_counter() - t0:.1f} s '
        f'(nvcc per source: {_build.build_seconds})')

    cfg = get_config(['--config', os.path.join(ROOT, 'configs', 'scannet.txt'),
                      '--vox_bucket', '131072', '--seg_bucket', '2048'])
    assert cfg.layers == 2 and cfg.bf16_acts and cfg.in_channels == 6
    valid_ids, _, _, is_fg = tables.get_tables('scannet')
    t0 = time.perf_counter()
    batches = synthetic.scannet_scale_batches(      # + 1 warm-up batch
        cfg, N_BATCHES + 1, BATCH)
    log(f'[host] {len(batches) * BATCH} scenes prepared in '
        f'{time.perf_counter() - t0:.1f} s; level-0 voxels per scene '
        f'{[n for _, h in batches for n in h["num_voxels"]]}')
    g = torch.Generator().manual_seed(0)

    # ---- 2. kernels vs plain twins
    dev0 = upload(batches[1][0], device)
    rows = kernel_phase(dev0, g)

    # ---- 3. the slice
    model = S.build_model(cfg, len(valid_ids))
    kaiming_init_(model, torch.Generator().manual_seed(1))
    pipe = FusedInferencePipeline(cfg, valid_ids, is_fg, model=model,
                                  top_k=128, max_masks=256)
    launches, plain, nm_launches, nm_plain, xla = slice_phase(
        pipe, cfg, batches, smi, 'slice')
    if (min(launches[m] for m in FWD_MODES) == 0
            or sum(plain.values()) + sum(nm_plain.values()) != 0
            or sum(nm_launches.values()) + sum(xla.values()) != 0):
        raise AssertionError('main path did not run every kernel, or ran '
                             'a plain twin or a neighbor-map conv')
    stage_phase(pipe, cfg, batches[1:], device, smi)

    # ---- 4. whole forward: kernels vs plain twins
    batch = upload(batches[1][0], device)
    pred_key = S.forward(model, batch)
    pred_t = with_twins(lambda: S.forward(model, batch))
    compare_forwards('forward', pred_key, pred_t, batch, 'kernel - twin')

    # ---- 5. weight-gradient kernels vs plain twins
    tcfg, tbatches = train_batches(smi)
    dw_rows = dw_phase(upload(tbatches[0][0], device), g)

    # ---- 6. the training slice
    state, tdev, train_launches = train_phase(tcfg, tbatches, device, smi)

    # ---- 7. one step's grads: kernels vs plain twins
    grads_phase(tcfg, state, tdev[1])
    del state, tdev
    torch.cuda.empty_cache()

    # ---- 8. neighbor-map kernels vs plain twins, and the map build
    nm_rows = nmap_kernel_phase(dev0, g, smi)

    # ---- 9. the neighbor-map slice (--key_conv off --pallas_conv on)
    ncfg = get_config(['--config', os.path.join(ROOT, 'configs',
                                                'scannet.txt'),
                       '--vox_bucket', '131072', '--seg_bucket', '2048']
                      + NMAP_FLAGS)
    t0 = time.perf_counter()
    nbatches = synthetic.scannet_scale_batches(ncfg, N_BATCHES + 1, BATCH)
    log(f'[host] {len(nbatches) * BATCH} scenes prepared for the '
        f'neighbor-map slice in {time.perf_counter() - t0:.1f} s')
    nmodel = S.build_model(ncfg, len(valid_ids))
    nmodel.load_state_dict(model.state_dict())      # phase 3's weights
    npipe = FusedInferencePipeline(ncfg, valid_ids, is_fg, model=nmodel,
                                   top_k=128, max_masks=256)
    kc_launches, kc_plain, nm_launches, nm_plain, xla = slice_phase(
        npipe, ncfg, nbatches, smi, 'nmap_slice')
    want = {'sparse_conv': 64 * N_BATCHES, 'gather_rows': 7 * N_BATCHES}
    if (nm_launches != want or sum(nm_plain.values()) != 0
            or sum(xla.values()) != 0
            or sum(kc_launches.values()) + sum(kc_plain.values()) != 0):
        raise AssertionError(f'neighbor-map slice launched {nm_launches} '
                             f'(want {want}), twins {nm_plain}, XLA route '
                             f'{xla}, key_conv {kc_launches} / {kc_plain}')
    stage_phase(npipe, ncfg, nbatches[1:], device, smi, tag='nmap_')
    # both slices once more, in turns, for their scenes/s side by side
    slice_phase(pipe, cfg, batches, smi, 'slice_again')
    slice_phase(npipe, ncfg, nbatches, smi, 'nmap_slice_again')

    # ---- 10. neighbor-map forward: kernels vs twins, vs the key path
    nbatch = upload(nbatches[1][0], device)
    pred_n = S.forward(nmodel, nbatch)
    pred_nt = with_twins(lambda: S.forward(nmodel, nbatch))
    compare_forwards('nmap_forward', pred_n, pred_nt, nbatch,
                     'kernel - twin')
    compare_forwards('nmap_forward', pred_n, pred_key, nbatch,
                     'neighbor-map path - key path')
    del npipe, nmodel, nbatches, nbatch, pred_n, pred_nt
    torch.cuda.empty_cache()

    # ---- 11. the evaluation slice (python -m box2mask_torch.evaluate)
    eval_phase(smi)

    kernels = []
    main_dtype = {'stem': 'float32'}
    for r in rows:
        if not r['name'].endswith(main_dtype.get(r['mode'], 'bfloat16')):
            continue
        kernels.append({
            'name': r['name'], 'route': 'cuda', 'source': SRC,
            'replaces': TPU_STEM if r['mode'] == 'stem' else TPU_KERNEL,
            'launches': launches[r['mode']], 'max_abs_err': r['max_abs_err'],
            'ms': r['ms'], 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': None})
    for r in dw_rows:
        kernels.append({
            'name': r['name'], 'route': 'cuda', 'source': SRC,
            'replaces': TPU_STEM_DW if r['mode'] == 'stem_dw' else TPU_DW,
            'launches': train_launches[r['mode']],
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': None})
    for r in nm_rows:
        if r['main']:
            kernels.append({
                'name': r['name'], 'route': 'cuda', 'source': NMAP_SRC,
                'replaces': TPU_NMAP_CONV if r['kernel'] == 'sparse_conv'
                else TPU_GATHER, 'launches': nm_launches[r['kernel']],
                'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                'bound_by': r['bound_by'], 'library_ms': r['library_ms']})
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
