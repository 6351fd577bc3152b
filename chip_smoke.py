#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (python3 chip_smoke.py).

Phases, in order; any failure exits non-zero:
  1. build the CUDA kernels of box2mask_torch/csrc with nvcc;
  2. each kernel mode against its plain PyTorch twin on the card, at the
     main path's shapes (keys of 4 ScanNet-scale synthetic scenes), timed;
     the masked BN op's kernels at the level-0 train and eval shapes
     against the twin's torch ops and their byte bounds (`[kernel] bn_*`,
     `[bn_op]`);
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
     stem dw included), the BN op through its kernels once per BN forward
     and backward, no twin ran; then the step split into forward,
     backward and optimizer (each run alone and synchronized), peak memory,
     and one step under torch.profiler;
  7. one step's gradients with the kernels against the plain twins' (the
     BN op's too) backward on the kernels' own forward, and against the
     twins' whole
     step, per parameter tensor, on the state that a warm-up and
     TRAIN_STEPS steps of phase 6's schedule reach from its initial
     weights, re-run under deterministic algorithms (`replayed_state`), so
     that every run reads the same state;
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
     protocol, native and NumPy voxelize and unpack ms per scene);
 12. the datasets: on-disk ScanNet v2, ARKitScenes and S3DIS fixtures of
     4 scenes each at the size of users' scenes (150k-vertex meshes;
     300k-vertex meshes with oriented-box annotations; 1M-point rooms under
     Area_5 with learned-superpoint npys; datasets/fixtures.py), then for
     each preset (configs/scannet.txt, arkitscenes.txt, s3dis_fold5.txt)
     the CLI's main() from a checkpoint of seeded weights: every key-path
     forward kernel mode launched, no twin, no neighbor-map conv; the
     dataset's protocol ran and returned a finite result; ScanNet and
     ARKitScenes results bit-equal to FusedInferencePipeline.run on the
     same batches, S3DIS's raw heads (the non-fused route) bit-equal to
     engine/state.forward; then --param_search on the ScanNet fixtures over
     a 2 x 1 x 1 x 2 grid, on the device route at every point, each point's
     results bit-equal to the pipeline's at its thresholds; one
     `[datasets]` line per run (scenes/s, the loader's seconds alone, the
     protocol's seconds, masks per scene, launches).
 13. training on the neighbor-map path: phase 6's batches and initial
     weights under --key_conv off --pallas_conv on (the preset as it ships
     otherwise), 3 train steps: every loss finite, 120 sparse_conv (the
     forward's 64, the 56 3^3 convs' dx) and 7 gather_rows launches per
     step, no twin, no key_conv, no call of the ops' XLA formulation; the
     step split into forward, backward and optimizer, peak memory, the
     backward under torch.profiler; one step's grads against the twins'
     backward on the same forward graph and the twins' whole step (phase
     7's bounds, on the state its steps reach, replayed as in phase 7);
     the level-0 3^3 conv's forward, dx and dw and the up 1->0 row pick
     at the training shapes (`[nmap_train_conv]`); one more
     step on a host-maps batch holding a 24 m room (past 1024 voxels of
     2 cm on an axis);
 14. training as users start it, in a temporary experiment root: `python
     -m box2mask_torch.train`'s main() for 2 epochs of the synthetic preset
     (with normals), every key-path kernel launched (dw and stem dw
     included), no twin; a resume at the checkpoint's epoch; a
     --apple_warmstart ARKitScenes run (28 classes, phase 12's fixture
     generator, its Training and Validation splits) from that checkpoint:
     the semantic output layer at its fresh init, every other tensor
     bit-equal to the checkpoint, one finite step; Model.get_prediction bit-equal to
     engine/state.forward; `python -m box2mask_torch.quality_gate` at
     GATE_ARGS, which must pass, writing its record, every key-path
     kernel launched, no twin (its launches counted from 0 just before
     it); one `[train_cli]` line of their times.
 15. data-parallel training (parallel/mesh.py) on phase 6's batches and
     initial weights: (a) a group of one NCCL rank, whose step is
     bit-equal to phase 6's S.train_step on the same batch and weights
     (loss dict, every grad, BN running statistics, parameters; both under
     deterministic algorithms), both steps timed in turns, and the grads'
     all-reduce (bytes, ms); `python -m box2mask_torch.train --multigpu`
     in a subprocess, one NCCL rank per card, 2 epochs of the synthetic
     preset, a checkpoint, the ranks' parameters equal at the end; (b) two
     gloo ranks, both on this card, each
     on its loader shard of 4 of every batch of 8, from rank 0's weights:
     DP_STEPS steps on each conv path (key matching; --key_conv off
     --pallas_conv on), every loss finite and equal on the ranks, the
     parameters bit-equal across the ranks after every step, every
     training kernel launched on every rank (neighbor maps: 120
     sparse_conv and 7 gather_rows launches per step), no twin, no XLA
     formulation; one step's averaged grads within phase 7's bounds of the
     twins' data-parallel backward on the same forward graph; (c) the same
     over NCCL, one card per rank, where the machine has two cards.
 16. spatial sharding (parallel/spatial.py): the ARKitScenes preset as it
     ships (layers 2, cin 6 with normals, 4 heads, segment pooling, 4 cm
     voxels, f32, key_conv on) under --spatial_shards 2
     --spatial_gather_level 3, on SP_SCENES on-disk scenes of a 20 x 14 m
     room (300-480k voxels each) from seeded kaiming weights (seed 1); the
     one-device SelectionNet first on the same scenes and weights (its
     outputs kept on the host, its memory freed), then two gloo ranks on
     this card: (a) the eval-mode forward within phase 4's bounds of the
     one-device forward and of the same spatial forward on the twins, the
     forward key modes (same, down, stem) launched on every rank, no up,
     no twin; each key kernel at the spatial shapes against its twin; (b)
     Evaluater.eval on the scenes with the kernels (the ARKitScenes mAP
     from rank 0) and on unrounded f32 twins: there, per scene, the
     confidences within rtol 1e-3, labels equal and < 1e-3 of the mask
     bits apart from the one-device fused eval on the same twins (with
     the kernels, bf16 rounding flips part two forwards' NMS decisions,
     as they part one device's kernels from its twins: printed); (c) one
     step's averaged grads against the one-device step's on the same
     scene and weights, under deterministic algorithms: with the kernels
     and BN on its running statistics (the JAX package's protocol for its
     key-conv spatial grads test: train-mode BN amplifies rounding flips
     through the few-voxel deep levels; printed) within phase 7's
     whole-step bounds, and on unrounded f32 twins in train mode within
     3e-3 / 0.99999, its largest tensors' shares printed (the batch-moment
     BNs amplify f32 summation order: scripts/spatial_diagnose.py); the
     kernels' grads within phase 7's 1e-2 of the
     twins' backward on the same graph; then SP_STEPS spatial train
     steps: losses finite and equal on the ranks, the parameters
     bit-equal across them after each, every training kernel mode
     launched on every rank, no twin; rank 0's checkpoint loaded into the
     one-device Model facade, bit-equal; (d) the forward's ms beside
     the one-device forward's, the step's ms, one step under
     torch.profiler (the halo exchanges' share of it), peak memory per
     rank beside the one-device run's; (e) where the machine has two
     cards, the forward and one step over NCCL, one card per rank, and the
     train and evaluate CLIs under --spatial_shards 2; else one line that
     says why not.
 17. the modules of the last slice: (a) `python -m box2mask_torch.evaluate
     --produce_visualizations --mesh_viz` on phase 12's 4 ScanNet fixture
     scenes (configs/scannet.txt as it ships) from a checkpoint of seeded
     weights: every key-path forward kernel mode launched, no twin; every
     scene's full file set, each point PLY of the scene's point count, the
     colours of pred_instances.ply bit-equal to instance_colors of the
     masks that pred_entries_to_results gives on the cached predictions,
     bbs.npy finite; then --predict_specific_scene on one scene, the same
     checks; (b) a seeded state_dict in the reference's (MinkowskiEngine)
     layout at the preset's width, converted by `python -m
     box2mask_torch.convert_reference`, restored by an Evaluater bit-equal
     to from_flax(convert_state_dict(sd)), its forward on a batch of phase
     3 bit-equal to the forward on those weights built directly; (c) the
     compact wire on phase 3's batches: unpack(pack(batch)) on the card
     bit-equal to the per-array upload on every key, the wire each
     signature took, the pipeline's per-scene results bit-equal with
     either route, and the bytes, pack, upload and decode ms beside the
     per-array upload's; the pipeline's scenes/s end to end with the
     per-array upload, the wire packed one batch ahead (as shipped) and
     the wire packed on the main thread (`[wire_e2e]`).
Phase 3 also prints `[flops]`: the forward GFLOPs per scene (nn/flops.py,
the batches' active rows per level) and the share of BF16_FLOP_S that the
timed batches reach (`forward_mfu`, `batch_mfu`).
Prints the card's name and power limit, one JSON line of per-kernel numbers
(with each kernel's launches on one rank of phase 15 (b), `dp_launches`, on
rank 0 of phase 16 (c), `spatial_launches`, in phase 17 (a)'s
visualizations, `viz_launches`, and in phase 14's quality gate,
`gate_launches`), and last `{"ok": true, "device": {...}}`.
"""

import contextlib
import copy
import io
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from box2mask_torch import evaluate as eval_cli
from box2mask_torch import quality_gate, train as train_cli
from box2mask_torch.config import get_config
from box2mask_torch.convert import kaiming_init_
from box2mask_torch.datasets import (batching, fixtures, loader,
                                     supervision, synthetic, tables)
from box2mask_torch.datasets.voxelize import voxelize_scene
from box2mask_torch.engine import checkpoint, state as S
from box2mask_torch.engine.evaluate import Evaluater
from box2mask_torch.engine.hostload import BatchUploader, upload
from box2mask_torch.engine.infer import FusedInferencePipeline
from box2mask_torch.engine.train import Trainer, warmstart_fresh_params
from box2mask_torch.model import Model
from box2mask_torch.nn.flops import estimate_forward_flops
from box2mask_torch.nn.losses import compute_losses
from box2mask_torch.nn.modules import MaskedBatchNorm
from box2mask_torch.parallel import mesh as M
from box2mask_torch.parallel import spatial as SP
from box2mask_torch.postprocess import device_post as DP
from box2mask_torch.postprocess.device_post import (fused_postproc,
                                                    stacked_masks_to_results)
from box2mask_torch.runtime import resolve_device
from box2mask_torch.sparse import _build, key_conv as KC
from box2mask_torch.sparse import masked_bn as MB
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
BN_SRC = 'box2mask_torch/csrc/masked_bn.cu'
SLICE_BN_CALLS = {}             # slice_phase tag -> the BN op's eval calls
# the BN op's kernels; the JAX package leaves batch norm to XLA
BN_KERNELS = ('bn_sums_kernel', 'bn_reduce_kernel', 'bn_norm_kernel',
              'bn_bwd_sums_kernel', 'bn_dx_kernel')
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


def bn_kernel_phase(g):
    """The masked BN op's kernels at the level-0 shapes of the ScanNet
    preset (bf16 activations, C = 96): the train step's BasicBlock BN_1
    with residual and ReLU (8 scenes, 1,048,576 rows; forward and backward)
    and the eval forward (4 scenes, 524,288 rows): each kernel's device time
    (torch.profiler) against its byte bound at HBM_BYTES_S, and the whole
    op against the twin's torch ops on the card (held within one bf16 step
    of the normalized value plus one of y, as the card tests)."""
    rows_out = []
    c = 96
    for mode, rows in (('train', 1 << 20), ('eval', 1 << 19)):
        n_s = torch.randint(110_000, 125_000, (rows // 131072,), generator=g)
        valid = (torch.arange(131072)[None, :] < n_s[:, None]).reshape(-1)
        n_valid = int(valid.sum())
        x = (torch.randn(rows, c, generator=g) * 2 + 0.5).to('cuda')
        x = x.to(torch.bfloat16)
        res = torch.randn(rows, c, generator=g).to('cuda', torch.bfloat16)
        gout = torch.randn(rows, c, generator=g).to('cuda', torch.bfloat16)
        valid, nv = valid.to('cuda'), torch.tensor(n_valid, dtype=torch.int32,
                                                   device='cuda')
        scale = torch.rand(c, generator=g).to('cuda') + 0.5
        bias = torch.randn(c, generator=g).to('cuda') * 0.1
        rm, rv = torch.zeros(c, device='cuda'), torch.ones(c, device='cuda')
        cfg = MB.Cfg(mode == 'train', True, 0.1, 1e-5, True, torch.bfloat16,
                     None)
        fwd = lambda: MB.forward_cuda(x, scale, bias, res, valid, nv,  # noqa
                                      rm, rv, cfg)
        fwd_twin = lambda: MB.forward_plain(x, scale, bias, res, valid,  # noqa
                                            nv, rm, rv, cfg)
        y, st = fwd()
        y_t, st_t = fwd_twin()
        mean, inv = ((st_t[:c], st_t[c:2 * c]) if st_t is not None
                     else (rm, torch.rsqrt(rv + 1e-5)))
        z = (x.float() - mean) * (inv * scale) + bias
        err = (y.float() - y_t.float()).abs()
        tol = (bf16_ulp(z) + torch.maximum(bf16_ulp(y.float()),
                                           bf16_ulp(y_t.float()))
               + F32_TOL * z.abs().max())
        if not bool((err <= tol).all()) or not torch.isfinite(y).all():
            raise AssertionError(f'bn {mode}: max err {err.max()}')
        e2 = 2 * rows * c               # bytes of one bf16 rows x c tensor
        parts = [('bn_sums_kernel', n_valid * c * 2 + rows, fwd)] if (
            mode == 'train') else []
        parts.append(('bn_norm_kernel', 3 * e2, fwd))
        twin_fwd_ms = time_ms(fwd_twin)
        bwd_ms = bwd_twin_ms = None
        if mode == 'train':
            bwd = lambda: MB.backward_cuda(gout, x, y, valid, scale, st,  # noqa
                                           rm, rv, cfg, need_res=True)
            bwd_twin = lambda: MB.backward_plain(gout, x, y, valid,  # noqa
                                                 scale, st, rm, rv, cfg)
            dx, _, _, _ = bwd()
            dx_t = bwd_twin()[0]
            derr = (dx.float() - dx_t.float()).abs()
            dscale = dx_t.float().abs().max()
            dtol = torch.maximum(bf16_ulp(dx.float()),
                                 bf16_ulp(dx_t.float())) + F32_TOL * dscale
            if not bool((derr <= dtol).all()):
                raise AssertionError(f'bn dx: max err {derr.max()}')
            parts += [('bn_bwd_sums_kernel', 3 * e2, bwd),
                      ('bn_dx_kernel', 5 * e2 + rows, bwd)]
            bwd_ms, bwd_twin_ms = time_ms(bwd), time_ms(bwd_twin)
        op_ms = time_ms(fwd)
        traced = {id(f): traced_ms(f, 10) for _, _, f in parts}
        for name, nbytes, fn in parts:
            t = traced[id(fn)]
            ms = t[name][0]
            if name in ('bn_sums_kernel', 'bn_bwd_sums_kernel'):
                ms += t['bn_reduce_kernel'][0]    # the fixed-order reduce
            bound_ms = nbytes / HBM_BYTES_S * 1e3
            fwd_part = name in ('bn_sums_kernel', 'bn_norm_kernel')
            twin_ms = twin_fwd_ms if fwd_part else bwd_twin_ms
            row = dict(name=f'{name}_{mode}_l0_{c}_bfloat16', mode=mode,
                       kernel=name, max_abs_err=float(err.max()), ms=ms,
                       plain_ms=twin_ms, bound_ms=bound_ms, bound_by='bytes',
                       bytes=nbytes)
            log(f'[kernel] {row["name"]}: device {ms:.4f} ms (sums: with '
                f'their reduce), bound {bound_ms:.4f} ms ({nbytes} B at '
                f'{HBM_BYTES_S:.3g} B/s), twin (torch ops, the whole '
                f'{"forward" if fwd_part else "backward"}) {twin_ms:.3f} ms')
            rows_out.append(row)
        log(f'[bn_op] {mode}, {rows} rows x {c}: forward {op_ms:.3f} ms '
            f'(twin {twin_fwd_ms:.3f}), backward {bwd_ms} ms (twin '
            f'{bwd_twin_ms}); kernels traced (ms, launches) per call: '
            + json.dumps([{k: v for k, v in t.items() if k in BN_KERNELS}
                          for t in traced.values()]))
    return rows_out


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
        def packed_upload():            # the pipeline's route
            buf, unpack = pipe.uploader.ship(pipe.uploader.pack(dev_np))
            return unpack(buf)
        batch, t_up = sync_ms(packed_upload)
        _, t_per_array = sync_ms(lambda: upload(dev_np, device))
        full, t_maps = sync_ms(lambda: S.ensure_maps(batch))
        pred, t_fwd = sync_ms(lambda: pipe.model(full))
        out, t_post = sync_ms(lambda: fused_postproc(
            pipe.core, cfg, pred, full, ths, pipe.top_k))
        t0 = time.perf_counter()
        out_np = {k: v.cpu().numpy() for k, v in out.items()}
        stacked_masks_to_results(out_np, host, pipe.valid_class_ids,
                                 post_fallback=pipe.post_full, pred=pred,
                                 dev_t=full, ths=ths)
        rows.append({'upload_ms': t_up, 'per_array_upload_ms': t_per_array,
                     'maps_ms': t_maps, 'forward_ms': t_fwd,
                     'postproc_ms': t_post,
                     'd2h_unpack_ms': (time.perf_counter() - t0) * 1e3,
                     'n_keep': out_np['n_keep'].tolist(),
                     'forward_flops': forward_flops(cfg, pipe, dev_np),
                     'scenes': len(host['scene'])})
    log(f'[{tag}stages] ' + json.dumps({'card': smi, 'per_batch': rows}))
    flops_line(tag, rows, smi)

    batch = upload(batches[0][0], device)

    def window():
        full = S.ensure_maps(batch)
        fused_postproc(pipe.core, cfg, pipe.model(full), full, ths,
                       pipe.top_k)
    profile_window(f'{tag}profile', window, smi)


def forward_flops(cfg, pipe, dev_np):
    """nn/flops.py's forward FLOPs of the batch: its active rows per level
    (the keys that are not the sentinel), its segments."""
    ns = [int((np.asarray(dev_np[f'keys{l}_b']) != SENT_KEY).sum())
          for l in range(8)]
    return estimate_forward_flops(
        ns, layers=cfg.layers, num_classes=len(pipe.valid_class_ids),
        n_heads=len(cfg.network_heads),
        n_segments=int(dev_np['num_segments']), in_dim=cfg.in_channels)


def flops_line(tag, rows, smi):
    """The forward GFLOPs per scene and the share of the card's bf16 peak
    (BF16_FLOP_S, dense) that the timed batches reach: over the forward
    stage alone, and over the batch's stages end to end."""
    flops = sum(r['forward_flops'] for r in rows)
    fwd_s = sum(r['forward_ms'] for r in rows) / 1e3
    batch_s = sum(r['upload_ms'] + r['maps_ms'] + r['forward_ms']
                  + r['postproc_ms'] + r['d2h_unpack_ms'] for r in rows) / 1e3
    log(f'[{tag}flops] ' + json.dumps({
        'card': smi, 'forward_gflops_per_scene':
        flops / sum(r['scenes'] for r in rows) / 1e9,
        'forward_mfu': flops / fwd_s / BF16_FLOP_S,
        'batch_mfu': flops / batch_s / BF16_FLOP_S,
        'peak_flop_s': BF16_FLOP_S}))


def profile_window(tag, fn, smi, sums=()):
    """fn() under torch.profiler: wall time, device busy time, idle share
    and the kernels by device time, as one `[tag]` JSON line; with the
    device ms and count of the kernels whose names hold each of `sums`."""
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
                for k, (t, c) in top[:12]],
        **{f'{sub}_ms_calls': [sum(t for k, (t, _) in agg.items()
                                   if sub in k.lower()),
                               sum(c for k, (_, c) in agg.items()
                                   if sub in k.lower())]
           for sub in sums}}))
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
    cfg = get_config(TRAIN_ARGS)
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


TRAIN_ARGS = ['--config', os.path.join(ROOT, 'configs', 'scannet.txt'),
              '--vox_bucket', '131072', '--seg_bucket', '2048',
              '--dataset_name', 'synthetic', '--dataset_size', '16',
              '--synthetic_instances', '18',
              '--synthetic_points_per_instance', '4000',
              '--synthetic_floor_points', '45000', '--synthetic_wall_points',
              '35000', '--fixed_seed', '7', '--num_workers', '8']


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
    MB.reset_counts()
    lrs = [cfg.lr * (1 - 0.1 * i) for i in range(TRAIN_STEPS)]
    losses = []
    t0 = time.perf_counter()
    for i, lr in enumerate(lrs):
        _, ld = S.train_step(cfg, state, dev[i % len(dev)], lr, bb_w, cs_w)
        losses.append(ld)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(KC.LAUNCHES), dict(KC.PLAIN_CALLS)
    bn_calls, bn_plain = dict(MB.LAUNCHES), dict(MB.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated(device)
    opt = [float(ld['optimization_loss']) for ld in losses]
    finite = all(torch.isfinite(v).all().item() for ld in losses
                 for v in ld.values())
    log(f'[train] optimization_loss per step {opt} (lr {lrs}); launches '
        f'per mode over {TRAIN_STEPS} steps: {launches}; plain-twin calls: '
        f'{plain}; masked BN op calls through the kernels {bn_calls}, '
        f'through the twin {bn_plain}')
    if not finite:
        raise AssertionError('non-finite losses in the training slice')
    n_bn = sum(isinstance(m, MaskedBatchNorm) for m in state.model.modules())
    want_bn = {'fwd_train': n_bn * TRAIN_STEPS, 'fwd_eval': 0,
               'bwd': n_bn * TRAIN_STEPS}
    if (min(launches.values()) == 0 or sum(plain.values()) != 0
            or bn_calls != want_bn or sum(bn_plain.values()) != 0):
        raise AssertionError('the train steps did not run every kernel, or '
                             f'ran a plain twin (BN op {bn_calls}, want '
                             f'{want_bn})')

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
        'launches': launches, 'bn_calls': bn_calls}))
    profile_window('train_profile', lambda: S.train_step(
        cfg, state, dev[0], lrs[-1], bb_w, cs_w), smi)
    return state, dev, dict(launches, **{f'bn_{k}': v for k, v in
                                         bn_calls.items()}), \
        wall / TRAIN_STEPS * 1e3


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


def key_launch_check(name, out, ref, a, kw):
    """A key_conv launch against its twin on the same inputs: (worst
    relative distance, within tolerance)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    scale = r.abs().max().clamp(min=1e-30).item()
    rel = err.max().item() / scale
    ok = rel <= F32_TOL
    if name.endswith('_dw'):                 # sums of up to ~1M rows
        x, g, *rest = a
        if name == 'key_conv_stem_dw':
            rest, kw = [rest[0], rest[0].reshape(-1)], {'kernel_size': 5}
        e, tol, d_a, d_b, ok = dw_check(x, g, *rest, out, ref, **kw)
        rel = max(d_a, d_b)
    elif out.dtype == torch.bfloat16:        # one rounding step
        ulp = torch.maximum(bf16_ulp(o), bf16_ulp(r))
        ok = bool((err <= ulp + F32_TOL * scale).all())
    return rel, ok


def nmap_launch_check(name, out, ref, a, kw):
    """A neighbor-map launch against its twin on the same inputs:
    sparse_conv within F32_TOL of max |twin|, gather_rows bit-equal."""
    rel = ((out - ref).abs().max() / ref.abs().max().clamp(
        min=1e-30)).item()
    ok = torch.equal(out, ref) if name == 'gather_rows' else rel <= F32_TOL
    return rel, ok and bool(torch.isfinite(out).all())


def replayed_state(cfg, dev, steps):
    """The state of phase 6's schedule (phase 13's under its cfg): seed 1's
    weights after the warm-up step and `steps` steps cycling over `dev`,
    under deterministic algorithms. Phase 6's own steps sum with CUDA
    atomics (index_add_), so the state they leave differs from run to run,
    and the whole-step distance of phase 7 is a function of the state."""
    n_classes = len(tables.get_tables('scannet')[0])
    state = S.init_state(cfg, S.build_model(cfg, n_classes),
                         S.make_optimizer(cfg), seed=1)
    bb_w, cs_w = S.head_weights(cfg, 200)
    with deterministic():
        S.train_step(cfg, state, dev[0], cfg.lr, bb_w, cs_w)
        for i in range(steps):
            S.train_step(cfg, state, dev[i % len(dev)],
                         cfg.lr * (1 - 0.1 * i), bb_w, cs_w)
    return state


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (index_add_ without atomics) inside, the
    previous setting after."""
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])


def grads_phase(cfg, state, batch):
    """Phase 7 on the key path: the four key_conv kernels of the step."""
    twin = {'key_conv': KC.key_conv_plain,
            'key_conv_stem': lambda x, kin, w: KC.key_conv_plain(
                x, kin, kin.reshape(-1), w, kernel_size=5,
                out_dtype=torch.float32),
            'key_conv_dw': KC.key_conv_dw_plain,
            'key_conv_stem_dw': lambda x, g, kin: KC.key_conv_dw_plain(
                x, g, kin, kin.reshape(-1), kernel_size=5)}
    with deterministic():
        step_grads_check('grads', cfg, state, batch, KC,
                         {k: getattr(KC, k) for k in twin}, twin,
                         key_launch_check)


def step_grads_check(tag, cfg, state, batch, module, kern, twin, check):
    """One step's grads with the kernels (`kern`: the wrappers of `module`
    by name), from the same parameters (BN normalizes with batch moments,
    so the running statistics moved by one pass do not enter the next),
    against (a) the twins' backward on the kernels' own forward graph (the
    presets run without remat, so that backward recomputes no forward) and
    (b) the twins' whole step. In the kernels' pass every launch is also
    held to its twin on the same inputs (`check`). The callers run it
    under deterministic algorithms, on a replayed state: the readings are
    the same in every run."""
    bb_w, cs_w = S.head_weights(cfg, 200)
    names = [n for n, _ in state.model.named_parameters()]
    params = [p for _, p in state.model.named_parameters()]
    worst = {}

    def checked(name):
        def fn(*a, **kw):
            out, ref = kern[name](*a, **kw), twin[name](*a, **kw)
            rel, ok = check(name, out, ref, a, kw)
            key = f'{name}_{str(out.dtype)[6:]}'
            n, w, good = worst.get(key, (0, 0.0, True))
            worst[key] = (n + 1, max(w, rel), good and ok)
            return out
        return fn

    def patched(fns, fn):
        saved = {k: getattr(module, k) for k in fns}
        for k, f in fns.items():
            setattr(module, k, f)
        try:
            return fn()
        finally:
            for k, f in saved.items():
                setattr(module, k, f)

    def forward():
        return S.forward_losses(cfg, state, batch, bb_w, cs_w)

    def grads(ld, retain=False):
        gs = torch.autograd.grad(ld['optimization_loss'], params,
                                 retain_graph=retain)
        return dict(zip(names, (g.detach() for g in gs)))

    def report(what, a, b, l2_tol, cos_tol):
        l2, cos, per = grad_distance(a, b)
        log(f'[{tag}] {len(b)} parameter tensors, kernels vs {what}: |diff| '
            f'/ |twin| (L2 over all) {l2:.3e} (bound {l2_tol:g}), cosine '
            f'{cos:.6f} (bound {cos_tol:g}); per tensor max |diff| / max '
            f'|twin|: median {statistics.median(per.values()):.3e}, worst '
            f'five {sorted(per.items(), key=lambda kv: -kv[1])[:5]}')
        if not (l2 <= l2_tol and cos >= cos_tol):
            raise AssertionError(f'{tag}: kernels vs {what} L2 {l2}, cos '
                                 f'{cos}')

    checked_fns = {k: checked(k) for k in kern}
    ld_k = patched(checked_fns, forward)
    gk = patched(checked_fns, lambda: grads(ld_k, retain=True))
    log(f'[{tag}] every launch of one step vs its twin on the same inputs '
        '(calls, worst max |diff| / max |twin| -- for dw the larger '
        'distance of kernel and twin from the f64 sum / max |x|^T|g| --, '
        'within tolerance): ' + json.dumps(worst))
    if not all(good for _, _, good in worst.values()):
        raise AssertionError(f'a launch differs from its twin: {worst}')
    if not all(torch.isfinite(v).all().item() for v in gk.values()):
        raise AssertionError(f'{tag}: the kernels\' step is not finite')
    gb = patched(twin, lambda: with_bn_twin(lambda: grads(ld_k)))   # (a)
    loss_k = ld_k['optimization_loss'].item()
    del ld_k
    report('the twins\' backward on the same forward', gk, gb,
           GRAD_BWD_L2_TOL, GRAD_BWD_COS_TOL)
    del gb
    ld_t = patched(twin, lambda: with_bn_twin(forward))         # (b)
    gt, loss_t = patched(twin, lambda: with_bn_twin(
        lambda: grads(ld_t))), ld_t['optimization_loss'].item()
    del ld_t
    log(f'[{tag}] optimization_loss kernels {loss_k:.6f}, twins '
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
    MB.reset_counts()
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
    bn_calls, bn_plain = dict(MB.LAUNCHES), dict(MB.PLAIN_CALLS)
    pipe.infer = infer
    n_batches = len(batches) - 1
    n_bn = sum(isinstance(m, MaskedBatchNorm) for m in pipe.model.modules())
    if (bn_calls != {'fwd_train': 0, 'fwd_eval': n_bn * n_batches, 'bwd': 0}
            or sum(bn_plain.values())):
        raise AssertionError(f'{tag}: BN op calls {bn_calls}, twin calls '
                             f'{bn_plain} ({n_bn} BNs x {n_batches} batches '
                             'through the kernels wanted)')
    SLICE_BN_CALLS[tag] = bn_calls['fwd_eval']
    if len(finite) != n_batches * len(cfg.network_heads) or not all(
            bool(f) for f in finite):
        raise AssertionError(f'non-finite head outputs in the {tag}')
    log(f'[{tag}] head outputs finite in all {n_batches} batches')
    log(f'[{tag}] launches over {n_batches} batches: key_conv {counts[0]}, '
        f'pallas_conv {counts[2]}; plain-twin calls: key_conv {counts[1]}, '
        f'pallas_conv {counts[3]}; XLA-formulation calls {counts[4]}; '
        f'masked BN op calls {bn_calls}, twin calls {bn_plain}')
    log(f'[{tag}] {n_results} scenes, {n_masks} masks, {wall:.3f} s -> '
        f'{n_results / wall:.3f} scenes/s on {smi}')
    return counts


def with_twins(fn):
    """fn() with every conv kernel wrapper and the BN op's kernels replaced
    by their plain twins."""
    saved = (KC.key_conv, KC.key_conv_stem, PC.sparse_conv, PC.gather_rows)
    KC.key_conv = KC.key_conv_plain
    KC.key_conv_stem = lambda x, kin, w: KC.key_conv_plain(
        x, kin, kin.reshape(-1), w, kernel_size=5, out_dtype=torch.float32)
    PC.sparse_conv, PC.gather_rows = PC.sparse_conv_plain, PC.gather_rows_plain
    try:
        return with_bn_twin(fn)
    finally:
        (KC.key_conv, KC.key_conv_stem, PC.sparse_conv,
         PC.gather_rows) = saved


def with_bn_twin(fn):
    """fn() with the BN op's CUDA forward and backward replaced by the
    twin's torch ops (on the card's tensors)."""
    saved = (MB.forward_cuda, MB.backward_cuda)
    MB.forward_cuda = MB.forward_plain
    MB.backward_cuda = lambda *a, need_res: MB.backward_plain(*a)
    try:
        return fn()
    finally:
        MB.forward_cuda, MB.backward_cuda = saved


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


# phase 12: the datasets. On-disk fixtures at the size of users' scenes,
# written from a seed into a temporary directory (datasets/fixtures.py):
# rooms of gridded surfaces and box-shaped objects in each reader's layout.
DATASET_SCENES = 4
DATASET_FIXTURES = {        # vertices (ScanNet, ARKitScenes) or points
    'scannet': 150_000,     # ~ ScanNet v2 vh_clean_2 meshes
    'arkitscenes': 300_000,  # ~150k points after the preset's [::2]
    's3dis': 1_000_000,     # ~250k points after the preset's 0.25 rate
}
DATASET_PRESETS = {'scannet': 'scannet.txt', 'arkitscenes': 'arkitscenes.txt',
                   's3dis': 's3dis_fold5.txt'}
PROTOCOLS = {'scannet': 'scannet_eval', 'arkitscenes': 'arkitscenes_eval',
             's3dis': 's3dis_eval'}
PARAM_GRID = ['--cluster_th_search', '0.4', '0.5', '2', '--score_th_search',
              '0.05', '0.05', '1', '--mask_bin_th_search', '0.3', '0.3', '1',
              '--mask_nms_th_search', '0.5', '0.6', '2']


class DatasetEvaluater(Evaluater):
    """The CLI's Evaluater, recording the wall seconds of its prediction
    and protocol steps, what they returned, and each call of the
    post-processing routes (per thresholds: results, device route or
    host oracle)."""
    runs = []

    def _timed(self, key, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        self.runs[-1].setdefault(key, 0.0)
        self.runs[-1][key] += time.perf_counter() - t0
        return out

    def _run(self):
        if not self.runs or self.runs[-1]['ev'] is not self:
            self.runs.append({'ev': self, 'post': [], 'protocols': []})
        return self.runs[-1]

    def fused_dataset_results(self, dataset, ths=None, cache=True):
        run = self._run()
        out = self._timed('predict_s', super().fused_dataset_results,
                          dataset, ths, cache)
        run.update(results=out[0], entries=out[1])
        return out

    def dataset_prediction(self, dataset, batch_size=1, cache=True):
        run = self._run()
        out = self._timed('predict_s', super().dataset_prediction, dataset,
                          batch_size, cache)
        run['entries'] = out
        return out

    def pred_entries_to_results(self, entries, ths=None):
        run = self._run()
        device = self._post_on_device()
        out = self._timed('post_s', super().pred_entries_to_results,
                          entries, ths)
        run['post'].append((tuple(float(t) for t in (
            ths if ths is not None else self.cfg.eval_ths)), device, out))
        return out

    def _protocol(name):
        def call(self, *a, **kw):
            run = self._run()
            run['protocols'].append(name)
            out = self._timed('protocol_s', getattr(Evaluater, name), self,
                              *a, **kw)
            run['result'] = out
            return out
        return call

    scannet_eval = _protocol('scannet_eval')
    arkitscenes_eval = _protocol('arkitscenes_eval')
    s3dis_eval = _protocol('s3dis_eval')
    s3dis_eval_fused = _protocol('s3dis_eval_fused')
    del _protocol

    def _s3dis_protocol(self, per_scene):
        self._run()['masks_per_scene'] = [len(p[3]) for p in per_scene]
        return self._timed('s3dis_protocol_s', super()._s3dis_protocol,
                           per_scene)


def write_dataset_fixtures(root):
    """The three datasets, DATASET_SCENES scenes each (val split): returns
    {dataset: (data_dir, data_split)}."""
    dirs = {d: os.path.join(root, d) for d in DATASET_PRESETS}
    os.makedirs(dirs['scannet'])
    split = fixtures.write_scannet(
        dirs['scannet'], [f'scene07{i:02d}_00' for i in range(DATASET_SCENES)],
        n_vertices=DATASET_FIXTURES['scannet'], seed=21)
    fixtures.write_arkitscenes(
        dirs['arkitscenes'], [f'4200{i:04d}' for i in range(DATASET_SCENES)],
        'Validation', n_vertices=DATASET_FIXTURES['arkitscenes'], seed=22)
    fixtures.write_s3dis(
        dirs['s3dis'], [f'Area_5.office_{i + 1}'
                        for i in range(DATASET_SCENES)],
        n_points=DATASET_FIXTURES['s3dis'], seed=23)
    return {d: (dirs[d], split) for d in dirs}


def finite_result(dataset, out):
    """The protocol's headline numbers: ScanNet AP, ARKitScenes mAP, S3DIS
    mRecall and semantic accuracy (mPrecision is NaN when no predicted
    instance survives, as in the JAX package)."""
    if dataset == 'scannet':
        vals = [out['all_ap'], out['all_ap_50%'], out['all_ap_25%']]
    elif dataset == 'arkitscenes':
        vals = [out]
    else:
        vals = [out['mRecall'], out['semantic_acc'], out['semantic_mIoU']]
    return all(np.isfinite(v) for v in vals), vals


def same_results(a, b):
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[n]['conf'], b[n]['conf'])
        and np.array_equal(a[n]['label_id'], b[n]['label_id'])
        and np.array_equal(a[n]['mask'], b[n]['mask']) for n in b)


def datasets_phase(smi):
    """Phase 12: the evaluation CLI over each dataset's reader on the card,
    from a checkpoint; returns {dataset, or 'param_search': the key_conv
    launches of its run by mode}."""
    root = tempfile.mkdtemp(prefix='b2m_datasets_')
    saved_root = os.environ.get('BOX2MASK_EXP_ROOT')
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'exp')
    saved_cli = eval_cli.Evaluater
    eval_cli.Evaluater = DatasetEvaluater
    torch.use_deterministic_algorithms(True, warn_only=True)
    launches = {}
    try:
        t0 = time.perf_counter()
        data = write_dataset_fixtures(os.path.join(root, 'data'))
        log(f'[datasets] fixtures written in {time.perf_counter() - t0:.1f}'
            f' s: {DATASET_SCENES} scenes each of {DATASET_FIXTURES}')
        for dataset, preset in DATASET_PRESETS.items():
            data_dir, split = data[dataset]
            args = ['--config', os.path.join(ROOT, 'configs', preset),
                    '--data_dir', data_dir, '--data_split', split,
                    '--fixed_seed', '12']
            launches[dataset] = dataset_eval(dataset, args, smi)
        data_dir, split = data['scannet']
        launches['param_search'] = param_search_check(
            ['--config', os.path.join(ROOT, 'configs', 'scannet.txt'),
             '--data_dir', data_dir, '--data_split', split, '--fixed_seed',
             '12', '--param_search'] + PARAM_GRID, smi)
        return launches
    finally:
        torch.use_deterministic_algorithms(False)
        eval_cli.Evaluater = saved_cli
        if saved_root is None:
            os.environ.pop('BOX2MASK_EXP_ROOT', None)
        else:
            os.environ['BOX2MASK_EXP_ROOT'] = saved_root
        shutil.rmtree(root, ignore_errors=True)


def cli_run(args, ckpt_seed=2):
    """A checkpoint of seeded kaiming weights for the config, then the CLI's
    main() with every count set to 0 just before it and read just after:
    (cfg, state, the DatasetEvaluater run, main's return, counts)."""
    cfg = get_config(args)
    valid_ids = tables.get_tables(cfg.dataset_name)[0]
    state = S.init_state(cfg, S.build_model(cfg, len(valid_ids)),
                         S.make_optimizer(cfg), seed=ckpt_seed)
    ckpt_name = os.path.basename(checkpoint.save_checkpoint(
        cfg.checkpoint_path, state, 3600.0, 0, 0))[:-5]
    torch.cuda.synchronize()
    KC.reset_counts()
    PC.reset_counts()
    ops.reset_counts()
    t0 = time.perf_counter()
    out = eval_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (dict(KC.LAUNCHES), dict(KC.PLAIN_CALLS), dict(PC.LAUNCHES),
              dict(PC.PLAIN_CALLS), dict(ops.XLA_CALLS))
    if (min(counts[0][m] for m in FWD_MODES) == 0
            or sum(counts[1].values()) + sum(counts[3].values()) != 0
            or sum(counts[2].values()) + sum(counts[4].values()) != 0):
        raise AssertionError(f'{args}: launches {counts}: not every key-path '
                             'kernel mode, or a twin or a neighbor-map conv')
    run = DatasetEvaluater.runs[-1]
    if run['ev'].ckpt_name != ckpt_name:
        raise AssertionError(f'checkpoint not loaded ({run["ev"].ckpt_name})')
    return cfg, state, run, out, counts, wall


def materialize(cfg, batch_size):
    """The val loader's batches as the CLI builds them, and its seconds."""
    ds = loader.get_dataset(cfg, 'val', do_augmentations=not cfg.eval_wo_aug)
    t0 = time.perf_counter()
    batches = list(ds.get_loader(shuffle=False, drop_last=False,
                                 batch_size=batch_size))
    return batches, time.perf_counter() - t0


def pipeline_results(cfg, model, batches, ths):
    valid_ids, _, _, is_fg = tables.get_tables(cfg.dataset_name)
    pipe = FusedInferencePipeline(cfg, valid_ids, is_fg, model=model,
                                  top_k=128)
    want = {}
    for r, _, _, _ in pipe.run(None, batches, ths):
        want.update(r)
    return want


def dataset_eval(dataset, args, smi):
    """One dataset's eval through the CLI, held to the pipeline (ScanNet,
    ARKitScenes: the fused route) or to engine/state.forward (S3DIS: the
    non-fused route's raw heads); one `[datasets]` line."""
    cfg, state, run, out, counts, wall = cli_run(args)
    if run['protocols'] != [PROTOCOLS[dataset]]:
        raise AssertionError(f'{dataset}: protocols {run["protocols"]}')
    ok, vals = finite_result(dataset, out)
    if not ok:
        raise AssertionError(f'{dataset}: protocol result {vals}')
    names = sorted(str(s['name']) for _, _, h in run['entries']
                   for s in h['scene'])
    if len(names) != DATASET_SCENES:
        raise AssertionError(f'{dataset}: scenes {names}')
    if dataset == 's3dis':
        batches, loader_s = materialize(cfg, 1)
        device = next(state.model.parameters()).device
        n_heads = 0
        for (dev_np, host), (pred, _, h) in zip(batches, run['entries']):
            want = S.forward(state.model, upload(dev_np, device))
            if [s['name'] for s in host['scene']] != [
                    s['name'] for s in h['scene']]:
                raise AssertionError('s3dis: batch order')
            for k, v in want.items():
                if not np.array_equal(pred[k], v.cpu().numpy()):
                    raise AssertionError(f's3dis {k}: dataset_prediction\'s '
                                         'head differs from state.forward')
                n_heads += 1
        check = (f'raw heads bit-equal to engine/state.forward ({n_heads} '
                 'head arrays)')
        n_masks = run['masks_per_scene']
    else:
        batches, loader_s = materialize(cfg, cfg.eval_batch_size)
        want = pipeline_results(cfg, state.model, batches, cfg.eval_ths)
        if not same_results(run['results'], want):
            raise AssertionError(f'{dataset}: results differ from '
                                 'FusedInferencePipeline.run')
        n_masks = [len(want[n]['conf']) for n in names]
        check = 'results bit-equal to FusedInferencePipeline.run'
    row = {'dataset': dataset, 'route': 'fused' if run['ev']._use_fused()
           else 'non-fused (host oracle)', 'protocol': run['protocols'][0],
           'result': vals, 'scenes': DATASET_SCENES,
           'points_per_scene': [len(v) for _, h in batches
                                for v in h['vox2point']],
           'voxels_per_scene': [int(n) for _, h in batches
                                for n in h['num_voxels']],
           'eval_s': wall, 'eval_scenes_per_s': DATASET_SCENES / wall,
           'scenes_per_s': DATASET_SCENES / run['predict_s'],
           'predict_s': run['predict_s'], 'loader_alone_s': loader_s,
           'protocol_s': run['protocol_s'], 'masks_per_scene': n_masks,
           'launches': counts[0], 'card': smi}
    if dataset == 's3dis':      # the host oracle, then the protocol proper
        row['host_oracle_s'] = run['protocol_s'] - run['s3dis_protocol_s']
        row['s3dis_protocol_s'] = run['s3dis_protocol_s']
    log(f'[datasets] {dataset}: {check}; ' + json.dumps(row))
    DatasetEvaluater.runs.clear()
    return counts[0]


def param_search_check(args, smi):
    """--param_search on the ScanNet fixtures: the device route at every
    grid point, its results equal to the pipeline's at those thresholds on
    the same batches (batch size 1, as the search predicts)."""
    cfg, state, run, best, counts, wall = cli_run(args)
    grid = [tuple(float(t) for t in ths) for ths, _, _ in run['post']]
    if len(grid) != 4 or not all(dev for _, dev, _ in run['post']):
        raise AssertionError(f'param search: {len(grid)} grid points, device '
                             f'route {[d for _, d, _ in run["post"]]}')
    batches, loader_s = materialize(cfg, 1)
    for ths, _, got in run['post']:
        if not same_results(got, pipeline_results(cfg, state.model, batches,
                                                  ths)):
            raise AssertionError(f'param search at {ths}: results differ '
                                 'from the pipeline\'s')
    with open(os.path.join(run['ev'].results_path, 'param_search.txt')) as f:
        lines = f.read().splitlines()
    if len(lines) != 5 or not lines[-1].startswith('best'):
        raise AssertionError(f'param_search.txt: {lines}')
    row = {'grid_points': len(grid), 'best': [list(best[0]), best[1]],
           'eval_s': wall, 'predict_s': run['predict_s'],
           'post_s': run['post_s'], 'loader_alone_s': loader_s,
           'launches': counts[0], 'card': smi}
    log('[datasets] param_search: device route at every grid point, results '
        'bit-equal to FusedInferencePipeline.run; ' + json.dumps(row))
    DatasetEvaluater.runs.clear()
    return counts[0]


# phase 13: training on the neighbor-map path (--key_conv off --pallas_conv
# on), the preset as it ships, on phase 6's batches and initial weights.
NMAP_TRAIN_STEPS = 3
# per train step at layers 2: the forward's 1 stem + 7 down + 56 3^3 convs
# and 7 up picks, and the backward's dx of each 3^3 conv (one sparse_conv
# over the same map with mirrored weights, pallas_conv.mirrored_dx)
NMAP_STEP_LAUNCHES = {'sparse_conv': 64 + 56, 'gather_rows': 7}


def nmap_step_counts():
    """(pallas_conv launches, every twin call and XLA-formulation call,
    key_conv launches): the neighbor-map train step's counts."""
    return (dict(PC.LAUNCHES), sum(PC.PLAIN_CALLS.values())
            + sum(KC.PLAIN_CALLS.values()) + sum(ops.XLA_CALLS.values()),
            sum(KC.LAUNCHES.values()))


def reset_all_counts():
    KC.reset_counts()
    PC.reset_counts()
    ops.reset_counts()


def nmap_train_phase(tbatches, device, smi):
    """Phase 13: NMAP_TRAIN_STEPS train steps on the neighbor maps of phase
    6's batches from phase 6's initial weights (seed 1), every loss finite
    and NMAP_STEP_LAUNCHES per step, no twin, no XLA formulation, no key
    conv; where the step's time goes; one step's grads against the twins;
    the level-0 3^3 conv's forward and backward at the training shapes; one
    more step on a host-maps batch holding a 24 m room. Returns the kernel
    rows at the training shapes and the launches of the run."""
    cfg = get_config(TRAIN_ARGS + NMAP_FLAGS)
    assert (cfg.batch_size == 8 and cfg.bf16_acts and cfg.key_conv == 'off'
            and cfg.pallas_conv == 'on' and not cfg.remat)
    n_classes = len(tables.get_tables('scannet')[0])
    state = S.init_state(cfg, S.build_model(cfg, n_classes),
                         S.make_optimizer(cfg), seed=1)
    marker = {batching.DEVICE_NMAPS: np.ones((), bool)}
    dev = [upload(dict(d, **marker), device) for d, _ in tbatches]
    bb_w, cs_w = S.head_weights(cfg, 200)
    S.train_step(cfg, state, dev[0], cfg.lr, bb_w, cs_w)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_all_counts()
    lrs = [cfg.lr * (1 - 0.1 * i) for i in range(NMAP_TRAIN_STEPS)]
    losses = []
    t0 = time.perf_counter()
    for i, lr in enumerate(lrs):
        _, ld = S.train_step(cfg, state, dev[i % len(dev)], lr, bb_w, cs_w)
        losses.append(ld)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, others, kc = nmap_step_counts()
    peak = torch.cuda.max_memory_allocated(device)
    opt = [float(ld['optimization_loss']) for ld in losses]
    log(f'[nmap_train] optimization_loss per step {opt} (lr {lrs}); '
        f'launches over {NMAP_TRAIN_STEPS} steps {launches}, twin and XLA '
        f'calls {others}, key_conv launches {kc}')
    if not all(torch.isfinite(v).all().item() for ld in losses
               for v in ld.values()):
        raise AssertionError('non-finite losses in the neighbor-map steps')
    want = {k: v * NMAP_TRAIN_STEPS for k, v in NMAP_STEP_LAUNCHES.items()}
    if launches != want or others or kc:
        raise AssertionError(f'neighbor-map steps launched {launches} (want '
                             f'{want}), twins / XLA {others}, key_conv {kc}')

    split = []
    for b in dev:                       # each phase run alone, synchronized
        ld, t_fwd = sync_ms(lambda: S.forward_losses(cfg, state, b, bb_w,
                                                     cs_w))
        _, t_bwd = sync_ms(lambda: S.backward(ld))
        _, t_opt = sync_ms(lambda: S.apply_update(state, lrs[-1]))
        split.append({'forward_ms': t_fwd, 'backward_ms': t_bwd,
                      'optimizer_ms': t_opt})
    log('[nmap_train] ' + json.dumps({
        'card': smi, 'steps': NMAP_TRAIN_STEPS, 'batch_size': cfg.batch_size,
        'wall_s': wall, 'ms_per_step': wall / NMAP_TRAIN_STEPS * 1e3,
        'steps_per_s': NMAP_TRAIN_STEPS / wall,
        'scenes_per_s': NMAP_TRAIN_STEPS * cfg.batch_size / wall,
        'split_per_batch': split, 'peak_max_memory_allocated_GB': peak / 1e9,
        'launches': launches}))
    ld = S.forward_losses(cfg, state, dev[0], bb_w, cs_w)
    profile_window('nmap_train_backward_profile', lambda: S.backward(ld),
                   smi)
    del ld
    for p in state.params:
        p.grad = None

    twin = {'sparse_conv': PC.sparse_conv_plain,
            'gather_rows': PC.gather_rows_plain}
    with deterministic():
        step_grads_check('nmap_grads', cfg,
                         replayed_state(cfg, dev, NMAP_TRAIN_STEPS), dev[1],
                         PC, {k: getattr(PC, k) for k in twin}, twin,
                         nmap_launch_check)
    rows = nmap_train_conv(S.ensure_maps(dev[0]), smi)
    del dev
    nmap_host_maps_step(cfg, state, device, smi)
    del state
    torch.cuda.empty_cache()
    return rows, launches


def nmap_train_conv(maps, smi):
    """The level-0 3^3 conv (96 -> 96) and the up 1 -> 0 row pick at the
    training shapes (8 scenes): the forward, the backward's dx (the same
    kernel over the mirrored weights) and dw (torch ops), each kernel
    against its twin; the dx by index_add_ (sparse_conv_bwd) against the
    kernel's. Returns kernel rows."""
    g = torch.Generator().manual_seed(5)
    nbr = maps['nmap3_0']
    valid = maps['valid0']
    vin = nbr.shape[0]
    x = torch.randn(vin, 96, generator=g).to('cuda')
    x[~valid] = 0
    x = x.to(torch.bfloat16)
    w = (torch.randn(27, 96, 96, generator=g) * (2.0 / (27 * 96)) ** 0.5
         ).to('cuda')
    gy = torch.randn(vin, 96, generator=g).to('cuda')
    gy[~valid] = 0
    wm = w.flip(0).transpose(1, 2)
    n_hits = int((nbr < vin).sum())
    n_in = int(maps['num0'])
    rows = []
    for name, a, wk in (('nmap_train_same3_l0_96', x, w),
                        ('nmap_train_dx_same3_l0_96', gy, wm)):
        kern = lambda: PC.sparse_conv(a, nbr, wk)               # noqa
        twin = lambda: PC.sparse_conv_plain(a, nbr, wk)         # noqa
        out, ref = kern(), twin()
        err = (out - ref).abs().max().item()
        scale = ref.abs().max().item()
        if err > F32_TOL * scale or not torch.isfinite(out).all():
            raise AssertionError(f'{name}: max err {err} (tol {F32_TOL:g} '
                                 f'* {scale})')
        nbytes = (n_in * 96 * a.element_size() + nbr.numel() * 4
                  + wk.numel() * 2 + out.numel() * 4)
        bound_ms, bound_by = bound(nbytes, 2.0 * n_hits * 96 * 96)
        rows.append(dict(name=name, kernel='sparse_conv', max_abs_err=err,
                         ms=time_ms(kern), plain_ms=time_ms(twin),
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None))
    dx_k = PC.sparse_conv(gy, nbr, wm)
    dx_t, _ = PC.sparse_conv_bwd(x.float(), nbr, w, gy, True, False)
    dx_err = (dx_k - dx_t).abs().max().item() / dx_t.abs().max().item()
    if dx_err > F32_TOL:
        raise AssertionError(f'dx by the kernel vs by index_add_: {dx_err}')
    dw_ms = time_ms(lambda: PC.sparse_conv_bwd(x, nbr, w, gy, False, True))
    dx_index_add_ms = time_ms(lambda: PC.sparse_conv_bwd(x, nbr, w, gy, True,
                                                         False))
    log('[nmap_train_conv] ' + json.dumps({
        'card': smi, 'rows': vin, 'valid_rows': n_in, 'hits': n_hits,
        'forward_ms': rows[0]['ms'], 'dx_kernel_ms': rows[1]['ms'],
        'dw_torch_ops_ms': dw_ms, 'dx_index_add_ms': dx_index_add_ms,
        'backward_ms': rows[1]['ms'] + dw_ms,
        'dx_kernel_vs_index_add_rel': dx_err}))

    U = maps['nmap3_1'].shape[0]
    parent, widx = maps['up_parent0'], maps['up_widx0']
    idx = torch.where(parent >= U, U * 8, parent * 8 + widx).to(torch.int32)
    y = torch.randn(U * 8, 96, generator=g).to('cuda')
    kern = lambda: PC.gather_rows(y, idx)                       # noqa
    twin = lambda: PC.gather_rows_plain(y, idx)                 # noqa
    if not torch.equal(kern(), twin()):
        raise AssertionError('nmap_train_gather_up1_0_96: kernel and twin '
                             'differ')
    yz, idx64 = torch.cat([y, y.new_zeros(1, 96)]), idx.long()
    n_valid = int((idx < U * 8).sum())
    bound_ms, bound_by = bound(idx.numel() * 4 + 2 * n_valid * 96 * 4, 0.0)
    rows.append(dict(name='nmap_train_gather_up1_0_96', kernel='gather_rows',
                     max_abs_err=0.0, ms=time_ms(kern), plain_ms=time_ms(twin),
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=time_ms(lambda: torch.index_select(
                         yz, 0, idx64))))
    for r in rows:
        log(f'[kernel] {r["name"]}: max_abs_err {r["max_abs_err"]:.3e} '
            f'kernel {r["ms"]:.3f} ms, plain twin {r["plain_ms"]:.3f} ms, '
            f'bound {r["bound_ms"]:.4f} ms ({r["bound_by"]}), library '
            f'{r["library_ms"]}')
    return rows


def nmap_host_maps_step(cfg, state, device, smi):
    """One train step on a batch of two ScanNet-scale scenes, one of them a
    24 x 5 m room (1200 voxels of 2 cm along x, past the 1024 of the key
    packing): the batch takes host maps and trains."""
    rets = []
    t0 = time.perf_counter()
    for i, room in enumerate(((6.0, 5.0, 2.6), (24.0, 5.0, 2.6))):
        scene, labels = synthetic.make_scene(
            seed=3000 + i, num_instances=18, points_per_instance=4000,
            floor_points=45000, wall_points=35000, segs_per_instance=6,
            room_size=room)
        ret = voxelize_scene(scene, cfg)
        ret['labels'] = labels
        supervision.build_supervision(ret, labels, scene, cfg, 'scannet')
        rets.append(ret)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        dev_np, host = batching.build_batch(
            rets, cfg, tables.SCANNET_SEMANTIC_ID2IDX, mode='train')
    prep_s = time.perf_counter() - t0
    extent = max(int(r['vox_coords'].max()) for r in rets)
    if 'keys0_b' in dev_np or extent < 1024 or not any(
            '1024' in str(w.message) for w in caught):
        raise AssertionError(f'the 24 m room did not take host maps (max '
                             f'coord {extent})')
    batch = upload(dev_np, device)
    bb_w, cs_w = S.head_weights(cfg, 200)
    torch.cuda.synchronize()
    reset_all_counts()
    (_, ld), step_ms = sync_ms(lambda: S.train_step(cfg, state, batch,
                                                    cfg.lr, bb_w, cs_w))
    launches, others, kc = nmap_step_counts()
    loss = float(ld['optimization_loss'])
    log(f'[nmap_train] host maps: 2 scenes, max voxel coord {extent}, '
        f'voxels {host["num_voxels"]}, batch built in {prep_s:.1f} s; one '
        f'step {step_ms:.1f} ms, optimization_loss {loss:.4f}, launches '
        f'{launches}, twin and XLA calls {others}, key_conv launches {kc} '
        f'on {smi}')
    if (not all(torch.isfinite(v).all().item() for v in ld.values())
            or launches != NMAP_STEP_LAUNCHES or others or kc):
        raise AssertionError('the host-maps step failed')


# phase 14: training as users start it, in a temporary experiment root
CLI_ARGS = ['--config', os.path.join(ROOT, 'configs', 'synthetic.txt'),
            '--use_normals_input', '--fixed_seed', '5', '--ckpt_every', '1',
            '--num_workers', '8']
# the quality gate at a recipe that overfits within the phase's budget
# (a third of the steps of the gate's default, 75 epochs x 32 copies)
GATE_ARGS = ['--epochs', '40', '--dataset_size', '16']


def quiet(fn, keep=('Resumed', 'Warm-started', 'Saved checkpoint',
                    'No checkpoints', '{')):
    """fn() with its standard output captured; echoes the lines that start
    with one of `keep`. Returns (fn's return, the output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    text = buf.getvalue()
    for line in text.splitlines():
        if line.startswith(keep):
            log('  ' + line)
    return out, text


def cli_phase(device, smi):
    """Phase 14: `python -m box2mask_torch.train`'s main() for 2 epochs of
    the synthetic preset (with normals, so that its weights fit the
    ARKitScenes preset), a resume at the checkpoint's epoch, a warm start
    of ARKitScenes (28 classes, phase 12's fixture generator, both
    splits) from that checkpoint, Model.get_prediction against
    engine/state.forward, and the quality gate."""
    root = tempfile.mkdtemp(prefix='b2m_train_cli_')
    saved_root = os.environ.get('BOX2MASK_EXP_ROOT')
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'exp')
    saved_resume = Trainer._resume
    row = {'card': smi}
    try:
        torch.cuda.synchronize()
        reset_all_counts()
        t0 = time.perf_counter()
        tr, _ = quiet(lambda: train_cli.main(CLI_ARGS + ['--num_epochs', '2']))
        torch.cuda.synchronize()
        row['train_2_epochs_s'] = time.perf_counter() - t0
        counts = (dict(KC.LAUNCHES), sum(KC.PLAIN_CALLS.values()),
                  sum(PC.LAUNCHES.values()) + sum(PC.PLAIN_CALLS.values())
                  + sum(ops.XLA_CALLS.values()))
        log(f'[train_cli] 2 epochs, {tr.iteration_num} steps: key_conv '
            f'launches {counts[0]}, twins / neighbor-map convs {counts[1:]}')
        if min(counts[0].values()) == 0 or counts[1] or counts[2]:
            raise AssertionError('the train CLI did not run every key-path '
                                 'kernel, or ran a twin')
        with open(os.path.join(tr.cfg.exp_path, 'metrics.jsonl')) as f:
            losses = [json.loads(line)['loss'] for line in f
                      if '"loss"' in line]
        ckpts = checkpoint.list_checkpoints(tr.cfg.checkpoint_path)
        if (len(losses) != tr.iteration_num or not np.isfinite(losses).all()
                or len(ckpts) != 1
                or checkpoint.read_payload(ckpts[0][1])['epoch'] != 1):
            raise AssertionError(f'train CLI: losses {losses[:3]}..., '
                                 f'checkpoints {ckpts}')
        row['losses_first_last'] = [losses[0], losses[-1]]
        ckpt_path = ckpts[0][1]

        t0 = time.perf_counter()
        tr2, text = quiet(lambda: train_cli.main(CLI_ARGS
                                                 + ['--num_epochs', '2']))
        row['resume_1_epoch_s'] = time.perf_counter() - t0
        if tr2.start_epoch != 1 or '(epoch 1)' not in text:
            raise AssertionError(f'resume at epoch {tr2.start_epoch}')

        # the warm start, recorded right after it
        snap = {}

        def recording(self):
            saved_resume(self)
            snap['sd'] = {k: v.clone() for k, v in
                          self.state.model.state_dict().items()}
        Trainer._resume = recording
        ark_dir = os.path.join(root, 'arkitscenes')
        for split, first in (('Training', 4100), ('Validation', 4200)):
            fixtures.write_arkitscenes(
                ark_dir, [f'{first}{i:04d}' for i in range(DATASET_SCENES)],
                split, n_vertices=DATASET_FIXTURES['arkitscenes'], seed=22)
        ark_args = ['--config', os.path.join(ROOT, 'configs',
                                             'arkitscenes.txt'),
                    '--data_dir', ark_dir, '--apple_warmstart',
                    '--num_epochs', '1', '--fixed_seed', '12',
                    '--num_workers', '8']
        acfg = get_config(ark_args)
        os.makedirs(acfg.checkpoint_path)
        shutil.copy(ckpt_path, acfg.checkpoint_path)
        reset_all_counts()
        t0 = time.perf_counter()
        ta, text = quiet(lambda: train_cli.main(ark_args))
        torch.cuda.synchronize()
        row['warmstart_s'] = time.perf_counter() - t0
        keep = warmstart_fresh_params(ta.state.model)
        payload = checkpoint.read_payload(ckpt_path)
        saved = dict(payload['params'], **payload['batch_stats'])
        fresh = S.init_state(acfg, S.build_model(acfg, 28),
                             S.make_optimizer(acfg),
                             seed=acfg.fixed_seed).model.state_dict()
        bad = [k for k, v in snap['sd'].items()
               if not torch.equal(v.cpu(), fresh[k].cpu() if k in keep
                                  else torch.as_tensor(saved[k]))]
        head = 'mlp_semantics.Linear1x1_2.kernel'
        shapes = (tuple(saved[head].shape), tuple(snap['sd'][head].shape))
        log(f'[train_cli] warm start: {len(keep)} tensors re-initialised '
            f'{sorted(keep)}, {len(snap["sd"]) - len(keep)} bit-equal to '
            f'the checkpoint; semantic output layer {shapes[0]} -> '
            f'{shapes[1]}; one step (iteration {ta.iteration_num}), launches '
            f'{dict(KC.LAUNCHES)}; mismatches {bad}')
        with open(os.path.join(acfg.exp_path, 'metrics.jsonl')) as f:
            loss = [json.loads(line)['loss'] for line in f
                    if '"loss"' in line]
        # the iteration count and training time carry over, as in the JAX
        # package's warm start
        if (bad or ta.start_epoch != 0
                or ta.iteration_num != payload['iteration_num'] + 1
                or shapes != ((96, 20), (96, 28)) or 'Warm-started' not in text
                or not np.isfinite(loss).all()):
            raise AssertionError('the warm start failed')
        row['warmstart_loss'] = loss[0]

        # the Model facade against engine/state.forward, deterministic
        # index_add_ on both sides
        cfg = get_config(CLI_ARGS)
        ids, _, _, is_fg = tables.get_tables('scannet')
        m = Model(cfg, ids, tables.SCANNET_SEMANTIC_ID2IDX,
                  np.arange(len(ids)), is_fg)
        m.ensure_state()
        quiet(m.load_checkpoint)
        dev_np, _ = next(iter(loader.get_dataset(
            cfg, 'val', do_augmentations=False).get_loader(
                shuffle=False, drop_last=False)))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            got = m.get_prediction(dev_np, to_cpu=False, min_size=False)
            want = S.forward(m.detection_model, upload(dev_np, device))
            clipped = m.get_prediction(dev_np, to_cpu=False)
        finally:
            torch.use_deterministic_algorithms(False)
        if not (all(torch.equal(got[k], v) for k, v in want.items())
                and torch.equal(clipped['mlp_bounds'], torch.clamp(
                    want['mlp_bounds'], min=cfg.min_bb_size))):
            raise AssertionError('Model.get_prediction differs from '
                                 'engine/state.forward')
        log(f'[train_cli] Model.get_prediction bit-equal to '
            f'engine/state.forward on {len(want)} heads')

        record = os.path.join(root, 'quality_gate.json')
        torch.cuda.synchronize()
        KC.reset_counts()
        PC.reset_counts()
        t0 = time.perf_counter()
        rc, text = quiet(lambda: quality_gate.main(GATE_ARGS + [
            '--out', record]))
        row['quality_gate_s'] = time.perf_counter() - t0
        row['gate_launches'] = dict(KC.LAUNCHES)
        row['quality_gate'] = json.loads(text.strip().splitlines()[-1])
        log('[train_cli] ' + json.dumps(row))
        with open(record) as f:
            written = json.load(f)
        if rc != 0 or written != row['quality_gate']:
            raise AssertionError(f'quality gate: {row["quality_gate"]}, '
                                 f'written {written}')
        if (min(KC.LAUNCHES[m] for m in FWD_MODES + ('dw', 'stem_dw')) == 0
                or sum(PC.LAUNCHES.values()) + sum(
                    KC.PLAIN_CALLS.values()) != 0):
            raise AssertionError(f'quality gate: key_conv '
                                 f'{dict(KC.LAUNCHES)}, neighbor-map '
                                 f'launches {dict(PC.LAUNCHES)}, twins '
                                 f'{dict(KC.PLAIN_CALLS)}')
    finally:
        Trainer._resume = saved_resume
        if saved_root is None:
            os.environ.pop('BOX2MASK_EXP_ROOT', None)
        else:
            os.environ['BOX2MASK_EXP_ROOT'] = saved_root
        shutil.rmtree(root, ignore_errors=True)
    return row


# phase 15: data-parallel training (parallel/mesh.py) on the preset as it
# ships, phase 6's batches and initial weights (seed 1).
DP_STEPS = 2
DP_TIMEOUT_S = 420.0           # the ranks' run, spawn to join


def dp_ws1_phase(cfg, tbatches, device, smi, phase6_ms):
    """(a) A group of one NCCL rank on the card: the data-parallel step
    (SyncBN moments through the all-reduce, grads and losses pmean'd)
    bit-equal to S.train_step on phase 6's first batch from the same
    weights, both under deterministic algorithms: the loss dict, every
    grad, the BN running statistics and the parameters after the update.
    Then both steps timed in turns, and the grads' all-reduce alone."""
    n_classes = len(tables.get_tables('scannet')[0])
    rdv = tempfile.mkdtemp(prefix='b2m_dp_')
    group = M.init_data_parallel(0, 1, 'nccl', 'file://' + os.path.join(
        rdv, 'init'), device, timeout=300)
    try:
        dev = [upload(d, device) for d, _ in tbatches]
        bb_w, cs_w = S.head_weights(cfg, 200)
        runs = {}
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as warned:
                warnings.simplefilter('always')
                for tag, g in (('plain', None), ('dp', group)):
                    state = S.init_state(
                        cfg, S.build_model(cfg, n_classes, device, group=g),
                        S.make_optimizer(cfg), seed=1)
                    step = (S.make_train_step(cfg) if g is None
                            else M.make_parallel_train_step(cfg, g))
                    grads, apply_update = [], S.apply_update

                    def record(st, lr):
                        grads.append([p.grad.clone() for p in st.params])
                        return apply_update(st, lr)
                    S.apply_update = record
                    try:
                        _, ld = step(state, dev[0], cfg.lr, bb_w, cs_w)
                    finally:
                        S.apply_update = apply_update
                    runs[tag] = (ld, grads[0], {
                        k: v.detach().clone()
                        for k, v in state.model.state_dict().items()},
                        state, step)
        finally:
            torch.use_deterministic_algorithms(False)
        (l1, g1, s1, st1, step1), (l2, g2, s2, st2, step2) = (
            runs['plain'], runs['dp'])
        same = {
            'loss_dict': sorted(l1) == sorted(l2) and all(
                torch.equal(l1[k], l2[k]) for k in l1),
            'grads': len(g1) == len(g2) and all(
                torch.equal(a, b) for a, b in zip(g1, g2)),
            'bn_running_stats': all(torch.equal(s1[k], s2[k])
                                    for k, _ in st1.model.named_buffers()),
            'params_after': all(torch.equal(s1[k], s2[k])
                                for k, _ in st1.model.named_parameters())}
        nondet = sorted({str(w.message).split(' does not have')[0][:80]
                         for w in warned if 'deterministic' in
                         str(w.message)})
        log(f'[dp_ws1] one NCCL rank vs S.train_step, phase 6\'s first batch '
            f'and weights, deterministic algorithms: bit-equal {same} '
            f'({len(l1)} losses, {len(g1)} grads, '
            f'{sum(1 for _ in st1.model.buffers())} BN buffers); ops '
            f'without a deterministic version: {nondet}')
        if not all(same.values()):
            raise AssertionError(f'world size 1 differs from the one-device '
                                 f'step: {same}')
        del g1, g2, s1, s2
        # in turns: plain, data parallel, data parallel, plain
        times = {'plain': [], 'dp': []}
        for tag in ('plain', 'dp', 'dp', 'plain'):
            _, _, _, st, step = runs[tag]
            for i in range(DP_STEPS):
                _, t = sync_ms(lambda: step(st, dev[i % 2], cfg.lr, bb_w,
                                            cs_w))
                times[tag].append(t)
        ld = S.forward_losses(cfg, st2, dev[1], bb_w, cs_w)
        S.backward(ld)
        grads = [p.grad for p in st2.params]
        nbytes = M.all_reduce_mean_(grads, group)
        ar_ms = time_ms(lambda: M.all_reduce_mean_(grads, group))
        for p in st2.params:
            p.grad = None
        profile_window('dp_ws1_profile', lambda: step2(
            st2, dev[0], cfg.lr, bb_w, cs_w), smi, sums=('nccl',))
        row = {'card': smi, 'steps': 2 * DP_STEPS,
               'plain_ms_per_step': statistics.median(times['plain']),
               'dp_ms_per_step': statistics.median(times['dp']),
               'phase6_ms_per_step': phase6_ms,
               'times_ms': times, 'grad_allreduce_bytes': nbytes,
               'grad_allreduce_ms': ar_ms}
        log('[dp_ws1] ' + json.dumps(row))
    finally:
        M.teardown()
        shutil.rmtree(rdv, ignore_errors=True)
    del runs, dev, st1, st2, ld, grads
    torch.cuda.empty_cache()
    return row


def dp_cli_check(smi):
    """`python -m box2mask_torch.train --multigpu` as users start it, in a
    subprocess: one NCCL rank per card of this machine (here one), 2
    epochs of the synthetic preset on 16 scenes with a checkpoint at the
    epoch-1 head; the run must end with its ranks' parameters equal."""
    root = tempfile.mkdtemp(prefix='b2m_dp_cli_')
    env = dict(os.environ, BOX2MASK_EXP_ROOT=root)
    env.pop('BOX2MASK_PLATFORM', None)
    t0 = time.perf_counter()
    # its own process group, so that a timeout ends the spawned ranks too
    p = subprocess.Popen(
        [sys.executable, '-m', 'box2mask_torch.train'] + CLI_ARGS
        + ['--multigpu', '--dataset_size', '16', '--num_epochs', '2'],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        out, err = p.communicate(timeout=300)
        wall = time.perf_counter() - t0
        ranks = torch.cuda.device_count()
        ckpts = checkpoint.list_checkpoints(os.path.join(
            root, 'synthetic', 'checkpoints'))
        losses = [float(line.split('loss ')[1].split()[0])
                  for line in out.splitlines() if ' loss ' in line]
        log(f'[dp_cli] python -m box2mask_torch.train --multigpu: exit '
            f'{p.returncode}, {ranks} NCCL ranks, {len(losses)} steps, '
            f'losses first / last {losses[:1]} / {losses[-1:]}, '
            f'checkpoints {len(ckpts)}, {wall:.1f} s on {smi}')
        if (p.returncode != 0 or len(ckpts) != 1 or not losses
                or not np.isfinite(losses).all()
                or f'{ranks} ranks ended with equal parameters' not in out):
            raise AssertionError(f'--multigpu CLI run failed: '
                                 f'{out[-2000:]}\n{err[-4000:]}')
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
        shutil.rmtree(root, ignore_errors=True)


def scene_name(scene):
    """A host batch's scene entry (a synthetic scene is its dict)."""
    return scene['name'] if isinstance(scene, dict) else str(scene)


def dp_rank(rank, world, backend, init, out_dir, cards):
    """One rank of (b) / (c), in a spawned process on cuda:cards[rank]."""
    try:
        device = resolve_device(torch.device('cuda', cards[rank]))
        group = M.init_data_parallel(rank, world, backend, init, device,
                                     timeout=DP_TIMEOUT_S)
        try:
            res = dp_rank_run(rank, world, group, device)
        finally:
            M.teardown()
        with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def dp_rank_run(rank, world, group, device):
    """The rank's shard of phase 6's batches (its loader's `shard`: scenes
    [4 r, 4 r + 4) of each batch of 8), phase 6's weights (seed 1, taken
    from rank 0); per conv path DP_STEPS data-parallel steps with the
    kernels, their counts set to 0 just before and read just after, the
    parameters' digest after each; one step's averaged grads against the
    twins' data-parallel backward on the same forward graph."""
    cfg = get_config(TRAIN_ARGS)
    ld = loader.get_dataset(cfg, 'train').get_loader(
        batch_size=cfg.batch_size // world, num_shards=world, shard=rank)
    batches = list(ld)
    ld.close()
    n_classes = len(tables.get_tables('scannet')[0])
    out = {'scenes': [[scene_name(s) for s in h['scene']]
                      for _, h in batches]}
    for path, flags in (('key', []), ('nmap', NMAP_FLAGS)):
        pcfg = get_config(TRAIN_ARGS + flags)
        marker = ({batching.DEVICE_NMAPS: np.ones((), bool)}
                  if path == 'nmap' else {})
        dev = [upload(dict(d, **marker), device) for d, _ in batches]
        state = S.init_state(pcfg, S.build_model(pcfg, n_classes, device,
                                                 group=group),
                             S.make_optimizer(pcfg), seed=1)
        M.broadcast_state(state, group)
        step = M.make_parallel_train_step(pcfg, group)
        bb_w, cs_w = S.head_weights(pcfg, 200)
        step(state, dev[0], pcfg.lr, bb_w, cs_w)                # warm-up
        torch.cuda.synchronize()
        reset_all_counts()
        losses, ms, digests = [], [], []
        for i in range(DP_STEPS):
            (_, l), t = sync_ms(lambda: step(state, dev[i % 2],
                                             pcfg.lr * (1 - 0.1 * i), bb_w,
                                             cs_w))
            losses.append({k: float(v) for k, v in l.items()})
            ms.append(t)
            M.check_replicas(state, group)
            digests.append(M.replica_digest(state))
        counts = {'key_conv': dict(KC.LAUNCHES),
                  'key_conv_twins': dict(KC.PLAIN_CALLS),
                  'pallas_conv': dict(PC.LAUNCHES),
                  'pallas_conv_twins': dict(PC.PLAIN_CALLS),
                  'xla': dict(ops.XLA_CALLS)}
        if path == 'key':
            twin = {'key_conv': KC.key_conv_plain,
                    'key_conv_stem': lambda x, kin, w: KC.key_conv_plain(
                        x, kin, kin.reshape(-1), w, kernel_size=5,
                        out_dtype=torch.float32),
                    'key_conv_dw': KC.key_conv_dw_plain,
                    'key_conv_stem_dw': lambda x, g, kin: (
                        KC.key_conv_dw_plain(x, g, kin, kin.reshape(-1),
                                             kernel_size=5))}
            module = KC
        else:
            twin = {'sparse_conv': PC.sparse_conv_plain,
                    'gather_rows': PC.gather_rows_plain}
            module = PC
        l2, cos, ar_ms = dp_grads_check(pcfg, state, dev[1], group, module,
                                        twin)
        out[path] = {'losses': losses, 'ms': ms, 'digests': digests,
                     'counts': counts, 'grads_l2': l2, 'grads_cos': cos,
                     'grad_allreduce_ms': ar_ms,
                     'peak_GB': torch.cuda.max_memory_allocated(device)
                     / 1e9}
        del state, dev, step
        torch.cuda.empty_cache()
    return out


def dp_grads_check(cfg, state, batch, group, module, twin):
    """One data-parallel step's grads (BN moments over the ranks, grads
    pmean'd) with the kernels against the twins' backward on the same
    forward graph (phase 7 (a)): (L2 of the difference over |twin|,
    cosine, ms of the grads' all-reduce)."""
    bb_w, cs_w = S.head_weights(cfg, 200)
    names = [n for n, _ in state.model.named_parameters()]
    params = state.params
    ld = S.forward_losses(cfg, state, batch, bb_w, cs_w)
    gk = list(torch.autograd.grad(ld['optimization_loss'], params,
                                  retain_graph=True))
    _, ar_ms = sync_ms(lambda: M.all_reduce_mean_(gk, group))
    saved = {k: getattr(module, k) for k in twin}
    for k, f in twin.items():
        setattr(module, k, f)
    try:
        gt = list(torch.autograd.grad(ld['optimization_loss'], params))
    finally:
        for k, f in saved.items():
            setattr(module, k, f)
    M.all_reduce_mean_(gt, group)
    l2, cos, _ = grad_distance(dict(zip(names, gk)), dict(zip(names, gt)))
    return l2, cos, ar_ms


def run_dp_ranks(world, backend, cards):
    """(b) / (c): `world` spawned ranks; their results by rank."""
    out_dir = tempfile.mkdtemp(prefix='b2m_dp_ranks_')
    init = 'file://' + os.path.join(out_dir, 'init')
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=dp_rank, args=(r, world, backend, init,
                                               out_dir, cards))
             for r in range(world)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + DP_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        errs = []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f'rank{r}.err')
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f'rank {r}: {f.read()}')
            elif p.is_alive() or p.exitcode != 0:
                errs.append(f'rank {r}: alive {p.is_alive()}, exit code '
                            f'{p.exitcode}')
        if errs:
            raise AssertionError('data-parallel ranks failed:\n'
                                 + '\n'.join(errs))
        res = []
        for r in range(world):
            with open(os.path.join(out_dir, f'rank{r}.json')) as f:
                res.append(json.load(f))
        return res, time.perf_counter() - t0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(out_dir, ignore_errors=True)


def dp_multi_phase(tag, world, backend, cards, tbatches, smi):
    """(b) / (c): every loss finite and equal on the ranks, the parameters
    bit-equal across the ranks after every step, on every rank each
    training kernel of the path launched (and on the neighbor maps
    NMAP_STEP_LAUNCHES per step), no twin, no key / neighbor-map kernel of
    the other path, no XLA formulation; the grads within phase 7's bounds
    of the twins' data-parallel backward; each rank's scenes the
    contiguous shard of phase 6's batches. Returns rank 0's launches per
    path."""
    res, wall = run_dp_ranks(world, backend, cards)
    per = len(tbatches[0][1]['scene']) // world
    for r, rr in enumerate(res):
        want = [[scene_name(s) for s in h['scene'][r * per:(r + 1) * per]]
                for _, h in tbatches]
        if rr['scenes'] != want:
            raise AssertionError(f'{tag}: rank {r} scenes {rr["scenes"]}, '
                                 f'want {want}')
    row = {'card': smi, 'ranks': world, 'backend': backend, 'cards': cards,
           'wall_s': wall}
    for path in ('key', 'nmap'):
        rs = [rr[path] for rr in res]
        finite = all(np.isfinite(list(l.values())).all()
                     for r in rs for l in r['losses'])
        same_loss = all(r['losses'] == rs[0]['losses'] for r in rs)
        same_params = all(r['digests'] == rs[0]['digests'] for r in rs)
        bad = []
        for r, rr in enumerate(rs):
            c = rr['counts']
            others = (sum(c['key_conv_twins'].values())
                      + sum(c['pallas_conv_twins'].values())
                      + sum(c['xla'].values()))
            if path == 'key':
                ok = (min(c['key_conv'].values()) > 0
                      and not sum(c['pallas_conv'].values()))
            else:
                ok = (c['pallas_conv'] == {
                    k: v * DP_STEPS for k, v in NMAP_STEP_LAUNCHES.items()}
                    and not sum(c['key_conv'].values()))
            if not ok or others:
                bad.append((r, c))
        grads_ok = all(r['grads_l2'] <= GRAD_BWD_L2_TOL
                       and r['grads_cos'] >= GRAD_BWD_COS_TOL for r in rs)
        row[path] = {
            'ms_per_step': [statistics.median(r['ms']) for r in rs],
            'scenes_per_s': world * per * DP_STEPS / max(
                sum(r['ms']) for r in rs) * 1e3,
            'optimization_loss': [l['optimization_loss']
                                  for l in rs[0]['losses']],
            'finite': finite, 'losses_equal_on_ranks': same_loss,
            'params_bit_equal_every_step': same_params,
            'launches_rank0': (rs[0]['counts']['key_conv'] if path == 'key'
                               else rs[0]['counts']['pallas_conv']),
            'grads_vs_twins_l2': [r['grads_l2'] for r in rs],
            'grads_vs_twins_cos': [r['grads_cos'] for r in rs],
            'grad_allreduce_ms': [r['grad_allreduce_ms'] for r in rs],
            'peak_GB': [r['peak_GB'] for r in rs]}
        if not (finite and same_loss and same_params and not bad
                and grads_ok):
            log(f'[{tag}] ' + json.dumps(row))
            raise AssertionError(f'{tag} {path}: finite {finite}, losses '
                                 f'equal {same_loss}, params equal '
                                 f'{same_params}, counts {bad}, grads '
                                 f'{grads_ok}')
    log(f'[{tag}] ' + json.dumps(row))
    return {p: row[p]['launches_rank0'] for p in ('key', 'nmap')}


# phase 16: spatial sharding (parallel/spatial.py): one scene's U-Net split
# over 2 ranks, the ARKitScenes preset as it ships (layers 2, cin 6, 4
# heads, segment pooling, 4 cm voxels, f32 activations, key_conv on)
SPATIAL_ARGS = ['--config', os.path.join(ROOT, 'configs', 'arkitscenes.txt'),
                '--fixed_seed', '10']
SPATIAL_FLAGS = ['--spatial_shards', '2', '--spatial_gather_level', '3']
SP_SCENES = 2
# a 20 x 14 m room of 1.6M vertices (800k points after the preset's [::2]):
# 300-480k voxels of 4 cm after the preset's scaling augmentation (0.8-1.2
# per axis under the fixed seed), inside the 1024-voxel-per-axis packing
SP_FIXTURE = dict(n_vertices=1_600_000, size=(20.0, 14.0, 2.6),
                  n_objects=32, seed=31)
SP_MIN_VOXELS = 250_000
SP_STEPS = 3
SP_TIMEOUT_S = 600.0
SP_FWD_MODES = ('same', 'down', 'stem')
SP_TRAIN_MODES = ('same', 'down', 'up', 'stem', 'dw', 'stem_dw')
# sharded vs one-device evaluation, per scene (tests/test_spatial_unet.py
# test_sharded_eval_matches_single_device)
SP_CONF_RTOL, SP_MASK_BITS = 1e-3, 1e-3
# one step's unrounded f32 twins' train-mode grads, sharded vs one device:
# the same function up to f32 summation order, which the batch-moment BNs
# amplify, most at levels >= G, where a BN normalises over few rows (82 and
# 17 at levels 6 and 7). scripts/spatial_diagnose.py (NVIDIA H100 80GB
# HBM3, 700.00 W) reads 2.449e-3 here, and one device's own grads 1.59e-3
# to 2.35e-3 when its input features move by 1e-7 relative, with the same
# share by level; just above those
SP_GRAD32_L2_TOL, SP_GRAD32_COS_TOL = 3e-3, 0.99999
SP_TWINS = {'key_conv': KC.key_conv_plain,
            'key_conv_stem': lambda x, kin, w: KC.key_conv_plain(
                x, kin, kin.reshape(-1), w, kernel_size=5,
                out_dtype=torch.float32),
            'key_conv_dw': KC.key_conv_dw_plain,
            'key_conv_stem_dw': lambda x, g, kin: KC.key_conv_dw_plain(
                x, g, kin, kin.reshape(-1), kernel_size=5)}


def spatial_cfg(data_dir, sharded=True, f32=False):
    """The preset; `f32` multiplies the neighbor-map and 1x1 convs' operands
    unrounded (--compute_dtype float32), for the unrounded comparisons."""
    return get_config(SPATIAL_ARGS + ['--data_dir', data_dir]
                      + (SPATIAL_FLAGS if sharded else [])
                      + (['--compute_dtype', 'float32'] if f32 else []))


@contextlib.contextmanager
def unrounded_twins():
    """Every key conv and dw through its plain twin on unrounded f32
    operands, x kept unrounded for the backward (tests/
    test_torch_parallel_common.patch_unrounded): with --compute_dtype
    float32 the one-device and the sharded nets then compute the same f32
    function, up to the order of f32 sums."""
    f32 = dict(operand_dtype=torch.float32)
    names = ('SAVED_X_DTYPE', 'key_conv', 'key_conv_stem', 'key_conv_dw',
             'key_conv_stem_dw')
    saved = {k: getattr(KC, k) for k in names}
    KC.SAVED_X_DTYPE = torch.float32
    KC.key_conv = lambda x, kin, kout, w, **kw: KC.key_conv_plain(
        x, kin, kout, w, **f32, **kw)
    KC.key_conv_stem = lambda x, kin, w: KC.key_conv_plain(
        x, kin, kin.reshape(-1), w, kernel_size=5, out_dtype=torch.float32,
        **f32)
    KC.key_conv_dw = lambda x, g, kin, kout, **kw: KC.key_conv_dw_plain(
        x, g, kin, kout, **f32, **kw)
    KC.key_conv_stem_dw = lambda x, g, kin: KC.key_conv_dw_plain(
        x, g, kin, kin.reshape(-1), kernel_size=5, **f32)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(KC, k, v)


def spatial_fixtures(root):
    """SP_SCENES ARKitScenes scenes of SP_FIXTURE in each split."""
    names = [f'4210{i:04d}' for i in range(SP_SCENES)]
    for split in ('Validation', 'Training'):
        fixtures.write_arkitscenes(root, names, split, **SP_FIXTURE)


def spatial_dataset(cfg):
    """The val split in name order (the reader lists its directory in the
    file system's order), with the eval's test-time augmentation."""
    ds = loader.get_dataset(cfg, 'val', do_augmentations=not cfg.eval_wo_aug)
    ds.data_list = np.sort(ds.data_list)
    return ds


def first_batch(ds):
    ld = ds.get_loader(shuffle=False, drop_last=False, batch_size=1)
    try:
        return next(iter(ld))
    finally:
        ld.close()


def spatial_reference(data_dir, device, out_dir):
    """The one-device SelectionNet on the same scenes and seeded weights
    (seed 1), written for the ranks and the checks: the eval-mode forward
    of the first val scene (its ms, peak memory), one train step's grads
    on it (peak memory), and the fused evaluation's results of the
    SP_SCENES val scenes. Everything it holds on the card is freed."""
    cfg = spatial_cfg(data_dir, sharded=False)
    n_classes = len(tables.get_tables('arkitscenes')[0])
    model = S.build_model(cfg, n_classes, device)
    kaiming_init_(model, torch.Generator().manual_seed(1))
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(out_dir, 'weights.pt'))
    ds = spatial_dataset(cfg)
    dev_np, host = first_batch(ds)
    batch = upload(dev_np, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    pred = S.forward(model, batch)
    fwd_ms = time_ms(lambda: S.forward(model, batch), reps=5)
    fwd_peak = torch.cuda.max_memory_allocated(device) / 1e9
    # how far bf16 rounding flips alone move this scene's heads: the same
    # one-device forward on the twins (logged, for scale)
    pred_t = with_twins(lambda: S.forward(model, batch))
    n_seg = int(batch['seg_valid'].sum())
    log('[spatial_reference] one device, kernels - twins, max / mean over '
        'valid segments of |diff| / max |twins|: ' + json.dumps({
            h: [((pred[h] - pred_t[h])[:n_seg].abs().max()
                 / pred_t[h][:n_seg].abs().max()).item(),
                ((pred[h] - pred_t[h])[:n_seg].abs().mean()
                 / pred_t[h][:n_seg].abs().max()).item()] for h in pred}))
    del pred_t
    tx = S.make_optimizer(cfg)
    state = S.TrainState(model, tx, tx.init(list(model.parameters())))
    bb_w, cs_w = S.head_weights(cfg, 200)
    torch.cuda.reset_peak_memory_stats(device)
    grads = {}
    with deterministic():
        for mode, train in (('train', True), ('eval', False)):
            gk, gt, loss = loss_grads(cfg, model, batch, bb_w, cs_w, train)
            grads[mode] = (gk, loss, grad_distance(gk, gt)[:2])
            model.load_state_dict(sd)
    step_peak = torch.cuda.max_memory_allocated(device) / 1e9
    log('[spatial_reference] one device, kernels\' grads vs the twins\' '
        'backward on the same graph, (L2, cosine), for scale: '
        + json.dumps({m: g[2] for m, g in grads.items()}))
    results = Evaluater(cfg, state=state).fused_dataset_results(
        ds, cache=False)[0]
    results_twins = with_twins(lambda: Evaluater(
        cfg, state=state).fused_dataset_results(ds, cache=False)[0])
    log(f'[spatial_reference] one device\'s eval, kernels vs twins, per '
        'scene (masks, max conf rel diff, labels equal, mask bits '
        'differing), for scale: '
        + str(same_eval_results(results, results_twins)))
    # the same function unrounded in f32 (the twins), for the sharp checks
    cfg32 = spatial_cfg(data_dir, sharded=False, f32=True)
    model32 = S.build_model(cfg32, n_classes, device)
    model32.load_state_dict(sd)
    state32 = S.TrainState(model32, tx, tx.init(list(model32.parameters())))
    with unrounded_twins():
        grads32, _, loss32 = loss_grads(cfg32, model32, batch, bb_w, cs_w,
                                        True, twins=False)
        model32.load_state_dict(sd)
        results32 = Evaluater(cfg32, state=state32).fused_dataset_results(
            ds, cache=False)[0]
    ref = {'pred': {k: v.cpu() for k, v in pred.items()},
           'seg_valid': batch['seg_valid'].cpu(),
           'grads': grads['eval'][0], 'grads_loss': grads['eval'][1],
           'grads_train': grads['train'][0],
           'grads_train_loss': grads['train'][1],
           'grads32': grads32, 'grads32_loss': loss32,
           'results': results, 'results32': results32, 'fwd_ms': fwd_ms,
           'fwd_peak_GB': fwd_peak, 'step_peak_GB': step_peak,
           'n_voxels': host['num_voxels'][0]}
    del model, model32, state, state32, batch, pred, tx
    torch.cuda.empty_cache()
    return ref


def loss_grads(cfg, model, batch, bb_w, cs_w, train, group=None,
               twins=True):
    """The grads of one forward's loss (BN on batch moments with `train`,
    on the running statistics without) with the kernels and, with `twins`,
    with the twins' backward on the same forward graph (phase 7 (a)); with
    a process group each averaged over the ranks (the step's psum / D).
    Returns (kernel grads, twin grads or None, loss) on the host. The
    caller restores the weights: a train-mode forward moves the BN
    statistics."""
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    model.train(train)
    full = S.ensure_maps(batch)
    loss = compute_losses(cfg, model(full), full, bb_w, cs_w)[
        'optimization_loss']

    def grads():
        gs = torch.autograd.grad(loss, params, retain_graph=True,
                                 allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for g, p in zip(gs, params)]
        if group is not None:
            M.all_reduce_mean_(gs, group)
        return {n: g.detach().cpu() for n, g in zip(names, gs)}
    gk, gt = grads(), None
    if twins:
        saved = {k: getattr(KC, k) for k in SP_TWINS}
        for k, f in SP_TWINS.items():
            setattr(KC, k, f)
        try:
            gt = grads()
        finally:
            for k, f in saved.items():
                setattr(KC, k, f)
    return gk, gt, float(loss.detach())


def spatial_kernel_check(batch, g):
    """Each key kernel of the spatial path at its shapes there (level 0's
    extended keys, ext_pad rows; the local level-1 keys of the down conv)
    against its plain twin, timed: [(name, max err, tol, ms, plain ms)]."""
    kin = batch['sp_ext_keys0'].reshape(1, -1)
    kout = batch['sp_kcd_okeys0'].reshape(-1)
    n = kin.numel()
    dev = kin.device
    x = torch.randn(n, 32, generator=g).to(dev)
    x6 = torch.randn(n, 6, generator=g).to(dev)
    gsame = torch.randn(n, 32, generator=g).to(dev)
    gout = torch.randn(kout.numel(), 32, generator=g).to(dev)
    w27 = (torch.randn(27, 32, 32, generator=g) / 30).to(dev)
    w8 = (torch.randn(8, 32, 32, generator=g) / 16).to(dev)
    w125 = (torch.randn(125, 6, 32, generator=g) / 60).to(dev)
    same = dict(kernel_size=3, scale=1)
    down = dict(kernel_size=2, stride_child=True, scale=1, guard=False)
    up = dict(kernel_size=2, stride_parent=True, scale=1, guard=False)
    fwd = [
        ('same3_l0_ext_32', lambda: KC.key_conv(x, kin, kin.reshape(-1),
                                                w27, **same),
         lambda: KC.key_conv_plain(x, kin, kin.reshape(-1), w27, **same)),
        ('down_l0_ext_32', lambda: KC.key_conv(x, kin, kout, w8, **down),
         lambda: KC.key_conv_plain(x, kin, kout, w8, **down)),
        ('up_l1_ext_32', lambda: KC.key_conv(
            gout, kout.reshape(1, -1), kin.reshape(-1),
            w8.transpose(1, 2), **up),
         lambda: KC.key_conv_plain(gout, kout.reshape(1, -1),
                                   kin.reshape(-1), w8.transpose(1, 2),
                                   **up)),
        ('stem5_l0_ext_6_32', lambda: KC.key_conv_stem(x6, kin, w125),
         lambda: SP_TWINS['key_conv_stem'](x6, kin, w125))]
    rows = []
    for name, kern, twin in fwd:
        a, b = kern(), twin()
        err = (a - b).abs().max().item()
        tol = F32_TOL * b.abs().max().item()
        rows.append((name, err, tol, time_ms(kern, 3), time_ms(twin, 3)))
        if not (err <= tol and torch.isfinite(a).all()):
            raise AssertionError(f'spatial {name}: max err {err} > {tol}')
    dws = [('dw_same3_l0_ext_32', (x, gsame, kin, kin.reshape(-1)), same,
            lambda: KC.key_conv_dw(x, gsame, kin, kin.reshape(-1), **same),
            lambda: KC.key_conv_dw_plain(x, gsame, kin, kin.reshape(-1),
                                         **same)),
           ('stem_dw_l0_ext_6_32', (x6, gsame, kin, kin.reshape(-1)),
            dict(kernel_size=5), lambda: KC.key_conv_stem_dw(x6, gsame, kin),
            lambda: SP_TWINS['key_conv_stem_dw'](x6, gsame, kin))]
    for name, args, kw, kern, twin in dws:
        err, tol, _, _, ok = dw_check(*args, kern(), twin(), **kw)
        rows.append((name, err, tol, time_ms(kern, 3), time_ms(twin, 3)))
        if not ok:
            raise AssertionError(f'spatial {name}: max err {err} > {tol}')
    return rows


def spatial_counts():
    return {'key_conv': dict(KC.LAUNCHES), 'twins': dict(KC.PLAIN_CALLS),
            'xla': dict(ops.XLA_CALLS), 'halo': dict(SP.HALO)}


class RecordingEvaluater(Evaluater):
    """The Evaluater, keeping the results its spatial path returned."""

    def spatial_dataset_results(self, dataset):
        self.recorded = super().spatial_dataset_results(dataset)
        return self.recorded


def spatial_rank(rank, world, backend, init, out_dir, cards, data_dir,
                 full):
    """One rank of phase 16, in a spawned process on cuda:cards[rank]."""
    try:
        device = resolve_device(torch.device('cuda', cards[rank]))
        group = M.init_data_parallel(rank, world, backend, init, device,
                                     timeout=SP_TIMEOUT_S)
        try:
            res = spatial_rank_run(rank, group, device, out_dir, data_dir,
                                   full)
        finally:
            M.teardown()
        torch.save(res, os.path.join(out_dir, f'rank{rank}.pt'))
    except BaseException:
        with open(os.path.join(out_dir, f'rank{rank}.err'), 'w') as f:
            f.write(traceback.format_exc())
        raise


def spatial_rank_run(rank, group, device, out_dir, data_dir, full):
    """(a) the eval-mode forward of the first val scene from the reference
    weights, its counts, time and peak memory, and the same forward on the
    twins; with `full`, the spatial kernels against their twins at their
    shapes, (b) Evaluater.eval of the SP_SCENES val scenes; then (c) the
    grads of one step (kernels, and the twins' backward on the same
    graph), and SP_STEPS (with `full`, else 1) train steps from the
    reference weights with their counts, losses and the parameters'
    digest after each, (d) one step under torch.profiler, and the
    checkpoint of rank 0."""
    cfg = spatial_cfg(data_dir)
    n_classes = len(tables.get_tables('arkitscenes')[0])
    sd = torch.load(os.path.join(out_dir, 'weights.pt'))
    model = SP.build_spatial_model(cfg, n_classes, device, group)
    model.load_state_dict(sd)
    ds = spatial_dataset(cfg)
    dev_np, host = first_batch(ds)
    SP.check_same_scene(dev_np, group, device)
    batch = SP.local_batch(dev_np, rank, device)
    meta = host['spatial_meta']
    out = {'pads': meta['pads'], 'halos': meta['halos'],
           'rows': int(dev_np['sp_num0'][rank])}
    fwd = SP.make_spatial_apply(model)
    fwd(batch)                                           # warm-up
    torch.cuda.synchronize()
    reset_all_counts()
    SP.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    pred = fwd(batch)
    torch.cuda.synchronize()
    out['fwd_counts'] = spatial_counts()
    out['fwd_peak_GB'] = torch.cuda.max_memory_allocated(device) / 1e9
    out['fwd_ms'] = time_ms(lambda: fwd(batch), reps=5)
    pred_t = with_twins(lambda: fwd(batch))
    compare_forwards(f'spatial_forward rank {rank}', pred, pred_t, batch,
                     'kernel - twin')
    out['pred'] = {k: v.cpu() for k, v in pred.items()}
    del pred, pred_t
    cfg32 = spatial_cfg(data_dir, f32=True)
    model32 = SP.build_spatial_model(cfg32, n_classes, device, group)
    model32.load_state_dict(sd)
    world = dist.get_world_size(group)
    tx = S.make_optimizer(cfg)
    if full:
        out['kernels'] = spatial_kernel_check(
            batch, torch.Generator().manual_seed(5 + rank))
        for tag, c, m, ctx in (
                ('eval', cfg, model, contextlib.nullcontext()),
                ('eval32', cfg32, model32, unrounded_twins())):
            ev = RecordingEvaluater(c, state=S.TrainState(
                m, tx, tx.init(list(m.parameters()))), rank=rank,
                world_size=world, group=group)
            t0 = time.perf_counter()
            with ctx:
                out[f'{tag}_map'] = ev.eval(spatial_dataset(c))
            out[f'{tag}_s'] = time.perf_counter() - t0
            out[f'{tag}_results'] = ev.recorded[0]
    bb_w, cs_w = S.head_weights(cfg, 200)
    with deterministic():
        for key, train in (('grads_train', True), ('grads', False)):
            gk, gt, out[f'{key}_loss'] = loss_grads(
                cfg, model, batch, bb_w, cs_w, train, group)
            out[f'{key}_vs_twins'] = grad_distance(gk, gt)[:2]
            if rank == 0:
                out[key] = gk
            model.load_state_dict(sd)
    del gk, gt
    with unrounded_twins():
        g32, _, out['grads32_loss'] = loss_grads(
            cfg32, model32, batch, bb_w, cs_w, True, group, twins=False)
    if rank == 0:
        out['grads32'] = g32
    del g32, model32
    tx = S.make_optimizer(cfg)
    state = S.TrainState(model, tx, tx.init(list(model.parameters())))
    step = SP.make_spatial_train_step(cfg, group)
    torch.cuda.synchronize()
    reset_all_counts()
    SP.reset_counts()
    torch.cuda.reset_peak_memory_stats(device)
    losses, ms, digests = [], [], []
    for i in range(SP_STEPS if full else 1):
        (_, ld), t = sync_ms(lambda: step(state, batch,
                                          cfg.lr * (1 - 0.1 * i), bb_w,
                                          cs_w))
        losses.append({k: float(v) for k, v in ld.items()})
        ms.append(t)
        M.check_replicas(state, group)
        digests.append(M.replica_digest(state))
    out['train_counts'] = spatial_counts()
    out.update(losses=losses, step_ms=ms, digests=digests,
               step_peak_GB=torch.cuda.max_memory_allocated(device) / 1e9)
    if not full:
        return out
    # (d) one step under torch.profiler: the spatial collectives' host
    # ranges against the step's wall time, and the device's busy time
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, cfg.lr, bb_w, cs_w)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, busy = {}, 0.0
    for e in prof.events():
        if e.device_type.name == 'CUDA':
            busy += e.time_range.elapsed_us() / 1e3
        elif e.name.startswith('spatial.'):
            t, c = spans.get(e.name, (0.0, 0))
            spans[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    out['profile'] = {'wall_ms': wall, 'device_busy_ms': busy,
                      'idle_share': 1 - busy / wall, 'spans': spans}
    M.check_replicas(state, group)
    if rank == 0:
        checkpoint.save_checkpoint(cfg.checkpoint_path, state, 1.0, 1,
                                   SP_STEPS + 1)
        out['final_digest'] = M.replica_digest(state)
    dist.barrier(group=group)
    return out


def run_spatial_ranks(backend, cards, data_dir, out_dir, full):
    """The 2 ranks of phase 16; their results by rank."""
    init = 'file://' + os.path.join(out_dir, f'init_{backend}')
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=spatial_rank, args=(
        r, 2, backend, init, out_dir, cards, data_dir, full))
        for r in range(2)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + SP_TIMEOUT_S
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        errs = []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f'rank{r}.err')
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f'rank {r}: {f.read()}')
            elif p.is_alive() or p.exitcode != 0:
                errs.append(f'rank {r}: alive {p.is_alive()}, exit code '
                            f'{p.exitcode}')
        if errs:
            raise AssertionError('spatial ranks failed:\n' + '\n'.join(errs))
        res = [torch.load(os.path.join(out_dir, f'rank{r}.pt'),
                          weights_only=False) for r in range(2)]
        for r in range(2):
            os.remove(os.path.join(out_dir, f'rank{r}.pt'))
        return res, time.perf_counter() - t0
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def same_eval_results(a, b):
    """Per scene, the fractions and differences the sharded-eval bounds
    read: (masks, max conf rel diff, labels equal, mask bits differing)."""
    out = {}
    for name in a:
        r, g = a[name], b.get(name)
        if g is None or len(r['conf']) != len(g['conf']):
            out[name] = (len(r['conf']), None if g is None
                         else len(g['conf']), False, 1.0)
            continue
        ro = np.argsort(-np.asarray(r['conf']), kind='stable')
        go = np.argsort(-np.asarray(g['conf']), kind='stable')
        rc, gc = np.asarray(r['conf'])[ro], np.asarray(g['conf'])[go]
        rel = float((np.abs(rc - gc) / np.maximum(np.abs(rc), 1e-30)).max()
                    ) if len(rc) else 0.0
        labels = bool(np.array_equal(np.asarray(r['label_id'])[ro],
                                     np.asarray(g['label_id'])[go]))
        rm, gm = np.asarray(r['mask'])[ro], np.asarray(g['mask'])[go]
        bits = float((rm != gm).mean()) if rm.size else 0.0
        out[name] = (len(rc), rel, labels, bits)
    return out


def top_shares(a, b, n=5):
    """The n tensors with the largest share of |a - b|^2, each with its
    share and its own |a - b| / |b|."""
    d = {k: float((a[k].double() - b[k].double()).square().sum()) for k in b}
    total = sum(d.values()) or 1.0
    return [[k, round(d[k] / total, 4), (d[k] / max(float(
        b[k].double().square().sum()), 1e-300)) ** 0.5]
        for k in sorted(d, key=d.get, reverse=True)[:n]]


def spatial_checks(tag, res, ref, full):
    """(a)-(c) on the ranks' results against the reference; raises."""
    fails = []
    n_seg = int(ref['seg_valid'].sum())      # the segments, in order
    for r, rr in enumerate(res):
        for head, b in ref['pred'].items():
            a, b = rr['pred'][head][:n_seg], b[:n_seg]
            scale = b.abs().max().item()
            diff = (a - b).abs()
            rel, rel_mean = (diff.max().item() / scale,
                             diff.mean().item() / scale)
            log(f'[{tag}] rank {r} {head}: |sharded - one device| / max '
                f'|one device|: max {rel:.3e} (bound {FWD_MAX_TOL:g}), mean '
                f'over valid segments {rel_mean:.3e} (bound '
                f'{FWD_MEAN_TOL:g})')
            if not (rel <= FWD_MAX_TOL and rel_mean <= FWD_MEAN_TOL):
                fails.append(f'rank {r} {head} vs one device')
        c = rr['fwd_counts']
        if (min(c['key_conv'][m] for m in SP_FWD_MODES) == 0
                or c['key_conv']['up'] or sum(c['twins'].values())):
            fails.append(f'rank {r} forward counts {c}')
        c = rr['train_counts']
        if (min(c['key_conv'][m] for m in SP_TRAIN_MODES) == 0
                or sum(c['twins'].values())):
            fails.append(f'rank {r} train counts {c}')
        l2, cos = rr['grads_vs_twins']
        if not (l2 <= GRAD_BWD_L2_TOL and cos >= GRAD_BWD_COS_TOL):
            fails.append(f'rank {r} grads vs twins L2 {l2} cos {cos}')
        log(f'[{tag}] rank {r} kernels\' grads vs the twins\' backward on '
            f'the same graph (L2, cosine): BN on running statistics '
            f'{rr["grads_vs_twins"]} (bounds {GRAD_BWD_L2_TOL}, '
            f'{GRAD_BWD_COS_TOL}); BN on batch moments '
            f'{rr["grads_train_vs_twins"]} (for scale)')
    flat_losses = [l for rr in res for l in rr['losses']]
    if not all(np.isfinite(list(l.values())).all() for l in flat_losses):
        fails.append('a loss is not finite')
    if any(rr['losses'] != res[0]['losses'] for rr in res):
        fails.append('losses differ between the ranks')
    if any(rr['digests'] != res[0]['digests'] for rr in res):
        fails.append('parameters differ between the ranks')
    for what, key, l2_tol, cos_tol in (
            ('kernels, BN on running statistics', 'grads', GRAD_L2_TOL,
             GRAD_COS_TOL),
            ('unrounded f32 twins, BN on batch moments', 'grads32',
             SP_GRAD32_L2_TOL, SP_GRAD32_COS_TOL),
            ('kernels, BN on batch moments (for scale)', 'grads_train',
             None, None)):
        l2, cos, _ = grad_distance(res[0][key], ref[key])
        loss_rel = (abs(res[0][f'{key}_loss'] - ref[f'{key}_loss'])
                    / abs(ref[f'{key}_loss']))
        log(f'[{tag}] one step\'s averaged grads vs the one-device step\'s '
            f'on the same scene and weights, {what}, deterministic '
            f'algorithms: L2 {l2:.4e} (bound {l2_tol}), cosine {cos:.6f} '
            f'(bound {cos_tol}), loss rel {loss_rel:.3e} (bound {LOSS_TOL})')
        if key == 'grads32':
            log(f'[{tag}] its tensors with the largest share of the squared '
                'difference (share, own L2): ' + json.dumps(
                    top_shares(res[0][key], ref[key])))
        if l2_tol is not None and not (l2 <= l2_tol and cos >= cos_tol
                                       and loss_rel <= LOSS_TOL):
            fails.append(f'grads vs one device ({what}) L2 {l2} cos {cos} '
                         f'loss {loss_rel}')
    if full:
        per = same_eval_results(ref['results32'], res[0]['eval32_results'])
        raw = same_eval_results(ref['results'], res[0]['eval_results'])
        log(f'[{tag}_eval] per scene (masks, max conf rel diff, labels '
            f'equal, mask bits differing), sharded vs one device, both on '
            f'unrounded f32 twins: {per} (bounds rtol {SP_CONF_RTOL}, equal, '
            f'< {SP_MASK_BITS}); both with the kernels (bf16 rounding flips '
            f'part the forwards, as one device\'s kernels part from its '
            f'twins): {raw}; ARKitScenes mAP of the sharded path '
            f'{res[0]["eval_map"]} (kernels), {res[0]["eval32_map"]} '
            f'(twins); {res[0]["eval_s"]:.1f} s for {SP_SCENES} scenes')
        if (set(per) != set(res[0]['eval32_results'])
                or len(per) != SP_SCENES
                or set(raw) != set(res[0]['eval_results'])
                or not all(rel is not None and rel <= SP_CONF_RTOL and lab
                           and bits < SP_MASK_BITS
                           for _, rel, lab, bits in per.values())
                or any(rr['eval_results'] != {} or rr['eval_map'] is not None
                       for rr in res[1:])
                or not np.isfinite(res[0]['eval_map'])):
            fails.append(f'sharded eval vs one device: {per}')
    if fails:
        raise AssertionError(f'{tag}: ' + '; '.join(fails))


def spatial_cli_check(data_dir, smi):
    """(e) The train and evaluate CLIs under --spatial_shards 2 as users
    start them, one NCCL rank per card, in subprocesses."""
    root = tempfile.mkdtemp(prefix='b2m_sp_cli_')
    env = dict(os.environ, BOX2MASK_EXP_ROOT=root)
    env.pop('BOX2MASK_PLATFORM', None)
    args = SPATIAL_ARGS + SPATIAL_FLAGS + ['--data_dir', data_dir,
                                           '--ckpt_every', '1']
    try:
        for module, extra, want in (
                ('box2mask_torch.train', ['--num_epochs', '2'],
                 '2 ranks ended with equal parameters'),
                ('box2mask_torch.evaluate', [], 'Loaded checkpoint')):
            t0 = time.perf_counter()
            p = subprocess.Popen(
                [sys.executable, '-m', module] + args + extra, cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, start_new_session=True)
            try:
                out, err = p.communicate(timeout=300)
            finally:
                if p.poll() is None:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
            log(f'[spatial_cli] python -m {module} --spatial_shards 2: exit '
                f'{p.returncode}, {time.perf_counter() - t0:.1f} s on {smi}')
            if p.returncode != 0 or want not in out:
                raise AssertionError(f'{module} --spatial_shards 2 failed: '
                                     f'{out[-2000:]}\n{err[-4000:]}')
    finally:
        shutil.rmtree(root, ignore_errors=True)


def spatial_phase(device, smi):
    """Phase 16. Returns rank 0's launches per kernel mode over (c)'s
    SP_STEPS train steps."""
    root = tempfile.mkdtemp(prefix='b2m_spatial_')
    saved_root = os.environ.get('BOX2MASK_EXP_ROOT')
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'exp')
    t_phase = time.perf_counter()
    try:
        data_dir = os.path.join(root, 'arkitscenes')
        t0 = time.perf_counter()
        spatial_fixtures(data_dir)
        fixture_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref = spatial_reference(data_dir, device, root)
        ref_s = time.perf_counter() - t0
        log(f'[spatial_reference] one device, {ref["n_voxels"]} voxels: '
            f'forward {ref["fwd_ms"]:.2f} ms, peak {ref["fwd_peak_GB"]:.3f} '
            f'GB; train step peak {ref["step_peak_GB"]:.3f} GB; fused eval '
            f'of {SP_SCENES} scenes; {ref_s:.1f} s (fixtures {fixture_s:.1f}'
            f' s) on {smi}')
        if ref['n_voxels'] < SP_MIN_VOXELS:
            raise AssertionError(f'spatial scene of {ref["n_voxels"]} voxels')
        res, wall = run_spatial_ranks('gloo', [0, 0], data_dir, root, True)
        spatial_checks('spatial', res, ref, True)
        conf = checkpoint.list_checkpoints(spatial_cfg(
            data_dir, sharded=False).checkpoint_path)
        ids, id2idx, _, is_fg = tables.get_tables('arkitscenes')
        pm = Model(spatial_cfg(data_dir, sharded=False), ids, id2idx,
                   np.arange(len(ids)), is_fg, device=device)
        pm.ensure_state()
        pm.load_checkpoint()
        if len(conf) != 1 or M.replica_digest(pm.state) != res[0][
                'final_digest']:
            raise AssertionError('the sharded checkpoint does not load into '
                                 'the one-device Model facade')
        del pm
        torch.cuda.empty_cache()
        prof = [rr['profile'] for rr in res]
        halo = [p['spans'].get('spatial.halo_exchange', (0.0, 0))
                for p in prof]
        row = {
            'card': smi, 'ranks': 2, 'backend': 'gloo', 'cards': [0, 0],
            'voxels': ref['n_voxels'], 'rows_per_rank': [
                rr['rows'] for rr in res],
            'pads': res[0]['pads'], 'halos': res[0]['halos'],
            'fwd_ms_sharded': [rr['fwd_ms'] for rr in res],
            'fwd_ms_one_device': ref['fwd_ms'],
            'step_ms': [rr['step_ms'] for rr in res],
            'halo_exchange_share_of_step': [
                h[0] / p['wall_ms'] for h, p in zip(halo, prof)],
            'profiled_step': prof,
            'peak_GB_fwd_per_rank': [rr['fwd_peak_GB'] for rr in res],
            'peak_GB_fwd_one_device': ref['fwd_peak_GB'],
            'peak_GB_step_per_rank': [rr['step_peak_GB'] for rr in res],
            'peak_GB_step_one_device': ref['step_peak_GB'],
            'fwd_counts_rank0': res[0]['fwd_counts'],
            'train_counts_rank0': res[0]['train_counts'],
            'optimization_loss': [l['optimization_loss']
                                  for l in res[0]['losses']],
            'ranks_wall_s': wall}
        for r, rr in enumerate(res):
            log(f'[spatial_launches] rank {r}: forward '
                f'{rr["fwd_counts"]}; {SP_STEPS} train steps '
                f'{rr["train_counts"]}')
        for name, err, tol, ms, plain_ms in res[0]['kernels']:
            log(f'[spatial_kernel] {name}: max_abs_err {err:.3e} (tol '
                f'{tol:.3e}) kernel {ms:.3f} ms, plain twin {plain_ms:.3f} '
                f'ms')
        log('[spatial_times] ' + json.dumps(row))
        launches = dict(res[0]['train_counts']['key_conv'])
        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            res, wall = run_spatial_ranks('nccl', [0, 1], data_dir, root,
                                          False)
            spatial_checks('spatial_nccl', res, ref, False)
            log(f'[spatial_nccl] 2 NCCL ranks on cards 0 and 1: forward ms '
                f'{[rr["fwd_ms"] for rr in res]}, step ms '
                f'{[rr["step_ms"] for rr in res]}, {wall:.1f} s on {smi}')
            spatial_cli_check(data_dir, smi)
        else:
            log(f'[spatial_nccl] not run: NCCL takes one card per rank and '
                f'this machine has {n_cards}; neither are the CLIs, which '
                'spawn NCCL ranks')
        log(f'[spatial] phase 16 in {time.perf_counter() - t_phase:.1f} s')
        return launches
    finally:
        if saved_root is None:
            os.environ.pop('BOX2MASK_EXP_ROOT', None)
        else:
            os.environ['BOX2MASK_EXP_ROOT'] = saved_root
        shutil.rmtree(root, ignore_errors=True)


# phase 17: the modules the last slice ported. (a) The visualizations at
# full width: `python -m box2mask_torch.evaluate --produce_visualizations
# --mesh_viz` on phase 12's ScanNet fixtures (the same generator and seed)
# from a checkpoint of phase 12's seeded weights, then
# --predict_specific_scene on one of them. (b) A reference (ME) checkpoint
# of the ScanNet preset's width through `python -m
# box2mask_torch.convert_reference`. (c) The compact upload wire on phase
# 3's batches.
VIZ_FILES = ('rgb.ply', 'gt_instances.ply', 'gt_semantics.ply',
             'pred_instances.ply', 'pred_semantics.ply', 'pred_bbs.ply',
             'pred_instances_mesh.ply', 'pred_semantics_mesh.ply', 'bbs.npy',
             'viewer.html')
POINT_PLYS = ('rgb.ply', 'gt_instances.ply', 'gt_semantics.ply',
              'pred_instances.ply', 'pred_semantics.ply')


def ply_u8(colors):
    """The uchar colours datasets/ply.write_ply_points stores for `colors`."""
    c = np.asarray(colors)
    if c.max() <= 1.0 + 1e-6:
        c = c * 255.0
    return np.clip(c, 0, 255).astype(np.uint8)


def viz_check(run, viz_dir, names):
    """Every scene of `names` holds the full file set; each point PLY has
    the scene's point count; the colours of pred_instances.ply equal
    instance_colors(masks_to_instance_ids(...)) of the results that
    pred_entries_to_results gives on the same cached predictions, bit for
    bit; bbs.npy is finite. Returns the masks per scene."""
    from box2mask_torch.datasets.ply import read_ply
    from box2mask_torch.viz.export import (instance_colors,
                                           masks_to_instance_ids)
    ev = run['ev']
    results = Evaluater.pred_entries_to_results(ev, run['entries'])
    points = {str(s['name']): len(s['positions'])
              for _, _, h in run['entries'] for s in h['scene']}
    if sorted(os.listdir(viz_dir)) != sorted(names) or sorted(points) != \
            sorted(names):
        raise AssertionError(f'viz scenes {sorted(os.listdir(viz_dir))}, '
                             f'predicted {sorted(points)}, want {names}')
    n_masks = {}
    for name in names:
        d = os.path.join(viz_dir, name)
        if sorted(os.listdir(d)) != sorted(VIZ_FILES):
            raise AssertionError(f'{name}: files {sorted(os.listdir(d))}')
        for f in POINT_PLYS:
            if len(read_ply(os.path.join(d, f))['vertex']) != points[name]:
                raise AssertionError(f'{name}/{f}: not {points[name]} points')
        r = results[name]
        ids = masks_to_instance_ids(r['mask'], r['conf'])
        if ids is None:
            ids = np.zeros(points[name], np.int64)
        v = read_ply(os.path.join(d, 'pred_instances.ply'))['vertex']
        got = np.stack([v['red'], v['green'], v['blue']], 1)
        if not np.array_equal(got, ply_u8(instance_colors(ids))):
            raise AssertionError(f'{name}: pred_instances.ply colours differ '
                                 'from the results of pred_entries_to_'
                                 'results')
        bbs = np.load(os.path.join(d, 'bbs.npy'))
        if bbs.ndim != 2 or bbs.shape[1] != 7 or not np.isfinite(bbs).all():
            raise AssertionError(f'{name}: bbs.npy {bbs.shape}')
        n_masks[name] = len(r['conf'])
    return n_masks


def viz_cli(args, smi, tag):
    """The eval CLI's main() in a viz mode, counts set to 0 just before and
    read just after: (the DatasetEvaluater run, wall s, key_conv launches)."""
    torch.cuda.synchronize()
    KC.reset_counts()
    PC.reset_counts()
    ops.reset_counts()
    t0 = time.perf_counter()
    quiet(lambda: eval_cli.main(args), keep=('Loaded',))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = (dict(KC.LAUNCHES), dict(KC.PLAIN_CALLS), dict(PC.LAUNCHES),
              dict(PC.PLAIN_CALLS), dict(ops.XLA_CALLS))
    if (min(counts[0][m] for m in FWD_MODES) == 0
            or sum(counts[1].values()) + sum(counts[3].values()) != 0
            or sum(counts[2].values()) + sum(counts[4].values()) != 0):
        raise AssertionError(f'{tag}: launches {counts}: not every key-path '
                             'kernel mode, or a twin or a neighbor-map conv')
    run = DatasetEvaluater.runs[-1]
    DatasetEvaluater.runs.clear()
    return run, wall, counts[0]


def viz_part(root, smi):
    """Phase 17 (a); returns the viz run's key_conv launches by mode."""
    data = os.path.join(root, 'scannet')
    os.makedirs(data)
    t0 = time.perf_counter()
    names = [f'scene07{i:02d}_00' for i in range(DATASET_SCENES)]
    split = fixtures.write_scannet(data, names,
                                   n_vertices=DATASET_FIXTURES['scannet'],
                                   seed=21)
    fixture_s = time.perf_counter() - t0
    args = ['--config', os.path.join(ROOT, 'configs', 'scannet.txt'),
            '--data_dir', data, '--data_split', split, '--fixed_seed', '12',
            '--mesh_viz']
    cfg = get_config(args)
    valid_ids = tables.get_tables(cfg.dataset_name)[0]
    state = S.init_state(cfg, S.build_model(cfg, len(valid_ids)),
                         S.make_optimizer(cfg), seed=2)
    checkpoint.save_checkpoint(cfg.checkpoint_path, state, 3600.0, 0, 0)
    del state
    viz_dir = os.path.join(cfg.exp_path, 'viz')
    row = {'card': smi, 'scenes': DATASET_SCENES, 'fixtures_s': fixture_s}
    saved_cli = eval_cli.Evaluater
    eval_cli.Evaluater = DatasetEvaluater
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        run, wall, launches = viz_cli(args + ['--produce_visualizations'],
                                      smi, 'viz')
        row['masks_per_scene'] = viz_check(run, viz_dir, names)
        row.update(produce_visualizations_s=wall,
                   predict_s=run['predict_s'], post_s=run['post_s'],
                   host_oracle_and_writes_s=wall - run['predict_s']
                   - run['post_s'], launches=launches)
        shutil.rmtree(viz_dir)
        one = names[1]
        run, wall, _ = viz_cli(args + ['--predict_specific_scene', one], smi,
                               'viz_one')
        viz_check(run, viz_dir, [one])
        row.update(predict_specific_scene_s=wall,
                   predict_specific_scene_predict_s=run['predict_s'])
    finally:
        torch.use_deterministic_algorithms(False)
        eval_cli.Evaluater = saved_cli
    log('[viz] full file set per scene, point counts, pred_instances.ply '
        'colours bit-equal to pred_entries_to_results\' masks, bbs.npy '
        'finite; ' + json.dumps(row))
    return launches


def reference_state_dict(cfg, seed=3):
    """A seeded state_dict in the reference's (ME) layout for the config's
    model, through the inverse of the converter's mapping (tests/
    test_ckpt_convert.py): ME names, kernel rows in ME's offset order,
    with a `module.` prefix, num_batches_tracked and a dead final* head."""
    from box2mask_torch.convert import build_mapping, cubic_perm_me_to_ours
    shapes = {k: tuple(v.shape) for k, v in S.build_model(
        cfg, len(tables.get_tables(cfg.dataset_name)[0])).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for t_key, f_path, kind in build_mapping(cfg.layers):
        key = '.'.join(f_path)
        if key not in shapes:
            continue
        val = (0.05 * rng.standard_normal(shapes[key])).astype(np.float32)
        if f_path[-1] == 'var':
            val = np.abs(val) + 0.5
        if f_path[-1] == 'scale':
            val = 1.0 + val
        if kind == 'conv' and val.ndim == 3:
            perm = cubic_perm_me_to_ours(round(val.shape[0] ** (1 / 3)))
            val = val[np.argsort(perm)]
        sd['module.' + t_key] = torch.from_numpy(val)
    if len(sd) != len(shapes):
        raise AssertionError(f'the mapping covers {len(sd)} of the model\'s '
                             f'{len(shapes)} tensors')
    sd['module.bn0.bn.num_batches_tracked'] = torch.tensor(7)
    sd['module.final0.kernel'] = torch.zeros(96, 96)
    return sd


def convert_part(root, dev_np, device, smi):
    """Phase 17 (b): the converted checkpoint restored by an Evaluater
    equals from_flax(convert_state_dict(sd)) bit for bit, and its forward
    on one fixture batch equals the forward on those weights built
    directly, on the same kernels (deterministic algorithms)."""
    from box2mask_torch import convert, convert_reference
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'exp_convert')
    cfg = get_config(['--config', os.path.join(ROOT, 'configs',
                                               'scannet.txt')])
    t0 = time.perf_counter()
    sd = reference_state_dict(cfg)
    path = os.path.join(root, 'checkpoint_101h:54m:35s_366875.13.tar')
    torch.save({'model_state_dict': sd, 'epoch': 4, 'iteration_num': 9},
               path)
    make_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    quiet(lambda: convert_reference.main(
        ['--config', os.path.join(ROOT, 'configs', 'scannet.txt'),
         '--torch_ckpt', path]), keep=('Converted', 'WARNING', 'NOTE'))
    convert_s = time.perf_counter() - t0
    os.remove(path)
    ev = Evaluater(cfg)
    quiet(ev._ensure_state, keep=('Loaded',))
    want = convert.from_flax(*convert.convert_state_dict(
        {k: v.numpy() for k, v in sd.items()}, layers=cfg.layers))
    got = ev.state.model.state_dict()
    if ev.ckpt_name != checkpoint.checkpoint_name(366875.13)[:-5] or set(
            got) != set(want) or not all(
                torch.equal(got[k].cpu(), want[k]) for k in want):
        raise AssertionError(f'the converted checkpoint ({ev.ckpt_name}) '
                             'does not restore to from_flax(convert_state_'
                             'dict(sd))')
    direct = S.build_model(cfg, len(ev.valid_class_ids))
    direct.load_state_dict(want)
    batch = upload(dev_np, device)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        a = S.forward(ev.state.model, batch)
        b = S.forward(direct, batch)
    finally:
        torch.use_deterministic_algorithms(False)
    if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in b):
        raise AssertionError('the converted checkpoint\'s forward differs '
                             'from the forward on the directly built weights')
    log(f'[convert_reference] {len(sd)} reference tensors -> {len(want)} '
        f'state_dict entries, restored bit-equal, forward bit-equal on '
        f'{len(a)} heads; make {make_s:.1f} s, convert + save '
        f'{convert_s:.1f} s on {smi}')
    shutil.rmtree(cfg.exp_path, ignore_errors=True)
    del ev, direct, a, b, sd, want, got
    torch.cuda.empty_cache()


def per_array_results(pipe, batches, ths):
    """The pipeline's per-scene results with the batch uploaded array by
    array (the route before the packed wire; held against it here only)."""
    ths_t = torch.as_tensor(np.asarray(ths, np.float32), device=pipe.device)
    out = {}
    for dev_np, host in batches:
        pred, full, o = pipe.infer(upload(dev_np, pipe.device), ths_t)
        out.update(pipe._harvest(pred, full, o, host, ths_t)[0])
    return out


def wire_part(pipe, cfg, batches, device, smi):
    """Phase 17 (c): unpack(pack(batch)) on the card equals the per-array
    upload of every key, bit for bit; the wire each signature took; the
    pipeline's per-scene results equal with either route (deterministic
    algorithms); bytes and ms of each part beside the per-array upload."""
    up = BatchUploader(device)
    rows = []
    for dev_np, _ in batches:
        t0 = time.perf_counter()
        buf, unpack = up.ship(up.pack(dev_np))
        put_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        got, decode_ms = sync_ms(lambda: unpack(buf))
        want, per_array_ms = sync_ms(lambda: upload(dev_np, device))
        for k, v in dev_np.items():
            if (got[k].shape != np.shape(v) or got[k].dtype != want[k].dtype
                    or not torch.equal(got[k].reshape(-1),
                                       want[k].reshape(-1))):
                raise AssertionError(f'wire: {k} differs after unpack')
        entry = up._cache[up.signature(dev_np)]
        pack_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            host_buf = entry['pack'](dev_np)
            pack_ms.append((time.perf_counter() - t0) * 1e3)
        pinned = torch.from_numpy(host_buf).pin_memory()
        dev_buf = torch.empty_like(pinned, device=device)
        _, h2d_ms = sync_ms(lambda: dev_buf.copy_(pinned, non_blocking=True))
        raw = sum(np.asarray(v).nbytes for v in dev_np.values())
        rows.append({'wire_bytes': int(entry['nbytes']), 'raw_bytes': raw,
                     'pack_ms': statistics.median(pack_ms), 'put_ms': put_ms,
                     'upload_ms': h2d_ms, 'decode_ms': decode_ms,
                     'per_array_upload_ms': per_array_ms})
    wires = sorted(set(up.wires().values()))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        packed = {}
        for results, _, _, _ in pipe.run(None, batches, cfg.eval_ths):
            packed.update(results)
        plain = per_array_results(pipe, batches, cfg.eval_ths)
    finally:
        torch.use_deterministic_algorithms(False)
    if not same_results(packed, plain) or len(packed) != len(batches) * BATCH:
        raise AssertionError('the packed pipeline\'s results differ from the '
                             'per-array upload\'s')
    log('[wire] unpack(pack(batch)) bit-equal to the per-array upload on '
        'every key; pipeline results bit-equal with either route; ' +
        json.dumps({'card': smi, 'wires': wires, 'pipeline_wire_bytes':
                    pipe.wire_bytes, 'pipeline_pack_s': pipe.pack_s,
                    'per_batch': rows}))
    if any(w[0] != 'compact' for w in wires):
        log(f'[wire] a signature fell back: {wires}')


class PerArrayRoute:
    """The pipeline's upload before the packed wire, as an uploader: pack
    hands the batch on, ship uploads it array by array (for the end-to-end
    comparison only)."""

    def __init__(self, device):
        self.device, self.pack_s, self.wire_bytes = device, 0.0, 0

    def pack(self, dev):
        return dev

    def ship(self, dev):
        return upload(dev, self.device), lambda batch: batch


class InlinePackRoute(PerArrayRoute):
    """The packed wire, packed on the main thread just before its ship (as
    the JAX package's pipeline packs), for the end-to-end comparison."""

    def __init__(self, up):
        super().__init__(up.device)
        self.up = up

    def ship(self, dev):
        return self.up.ship(self.up.pack(dev))


WIRE_E2E_ORDER = ('per_array', 'packed_ahead', 'packed_inline',
                  'packed_inline', 'packed_ahead', 'per_array')


def wire_e2e(pipe, cfg, batches, smi, rounds=1):
    """Inference scenes/s of the pipeline end to end over phase 3's batches,
    twice over, with each upload route in turn (WIRE_E2E_ORDER, `rounds`
    times; the host's load drifts, so routes compare within a round): the
    per-array upload (the route before the packed wire), the packed wire
    packed one batch ahead on the packer thread (the pipeline as shipped),
    and packed on the main thread."""
    shipped = pipe.uploader
    routes = {'per_array': PerArrayRoute(pipe.device),
              'packed_ahead': shipped,
              'packed_inline': InlinePackRoute(shipped)}
    runs = []
    try:
        for name in WIRE_E2E_ORDER * rounds:
            pipe.uploader = routes[name]
            torch.cuda.synchronize()
            shipped.pack_s = 0.0
            t0 = time.perf_counter()
            n = sum(len(r) for r, _, _, _ in pipe.run(None, batches * 2,
                                                      cfg.eval_ths))
            torch.cuda.synchronize()
            runs.append({'route': name,
                         'scenes_s': n / (time.perf_counter() - t0),
                         'scenes': n,
                         'pack_s': shipped.pack_s})
    finally:
        pipe.uploader = shipped
    by = {name: [r['scenes_s'] for r in runs if r['route'] == name]
          for name in routes}
    log('[wire_e2e] ' + json.dumps({
        'card': smi, 'runs': runs,
        'median_scenes_s': {k: statistics.median(v) for k, v in by.items()},
        'best_scenes_s': {k: max(v) for k, v in by.items()}}))
    return by


def viz_phase(pipe, cfg, batches, device, smi):
    """Phase 17. Returns the viz run's key_conv launches by mode."""
    root = tempfile.mkdtemp(prefix='b2m_viz_')
    saved_root = os.environ.get('BOX2MASK_EXP_ROOT')
    os.environ['BOX2MASK_EXP_ROOT'] = os.path.join(root, 'exp')
    t_phase = time.perf_counter()
    try:
        launches = viz_part(root, smi)
        convert_part(root, batches[1][0], device, smi)
        wire_part(pipe, cfg, batches[1:], device, smi)
        wire_e2e(pipe, cfg, batches, smi)
        log(f'[viz] phase 17 in {time.perf_counter() - t_phase:.1f} s')
        return launches
    finally:
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
    t_start = time.perf_counter()

    def phase(n):               # the script's seconds where phase n starts
        log(f'[phase] {n} starts at {time.perf_counter() - t_start:.1f} s')

    phase(1)
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

    phase(2)
    # ---- 2. kernels vs plain twins
    dev0 = upload(batches[1][0], device)
    rows = kernel_phase(dev0, g)
    bn_rows = bn_kernel_phase(g)

    phase(3)
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

    phase(4)
    # ---- 4. whole forward: kernels vs plain twins
    batch = upload(batches[1][0], device)
    pred_key = S.forward(model, batch)
    pred_t = with_twins(lambda: S.forward(model, batch))
    compare_forwards('forward', pred_key, pred_t, batch, 'kernel - twin')

    phase(5)
    # ---- 5. weight-gradient kernels vs plain twins
    tcfg, tbatches = train_batches(smi)
    dw_rows = dw_phase(upload(tbatches[0][0], device), g)

    phase(6)
    # ---- 6. the training slice
    state, tdev, train_launches, train_ms = train_phase(tcfg, tbatches,
                                                        device, smi)

    phase(7)
    # ---- 7. one step's grads: kernels vs plain twins
    del state
    grads_phase(tcfg, replayed_state(tcfg, tdev, TRAIN_STEPS), tdev[1])
    del tdev
    torch.cuda.empty_cache()

    phase(8)
    # ---- 8. neighbor-map kernels vs plain twins, and the map build
    nm_rows = nmap_kernel_phase(dev0, g, smi)

    phase(9)
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

    phase(10)
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

    phase(11)
    # ---- 11. the evaluation slice (python -m box2mask_torch.evaluate)
    eval_phase(smi)

    phase(12)
    # ---- 12. the datasets: ScanNet, ARKitScenes, S3DIS readers and evals
    ds_launches = datasets_phase(smi)

    phase(13)
    # ---- 13. training on the neighbor-map path
    nt_rows, nt_launches = nmap_train_phase(tbatches, device, smi)

    phase(14)
    # ---- 14. training as users start it: the train CLI, warm start, the
    # Model facade and the quality gate
    gate_launches = cli_phase(device, smi)['gate_launches']

    phase(15)
    # ---- 15. data-parallel training: (a) one NCCL rank bit-equal to the
    # one-device step; (b) two gloo ranks on this card; (c) two NCCL ranks
    # on two cards, where there are two
    dp_ws1_phase(tcfg, tbatches, device, smi, train_ms)
    dp_cli_check(smi)
    dp_launches = dp_multi_phase('dp_gloo', 2, 'gloo', [0, 0], tbatches,
                                 smi)
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        dp_multi_phase('dp_nccl', 2, 'nccl', [0, 1], tbatches, smi)
    else:
        log(f'[dp_nccl] not run: two NCCL ranks need two cards, this '
            f'machine has {n_cards}')
    del tbatches
    torch.cuda.empty_cache()

    phase(16)
    # ---- 16. spatial sharding: one ARKitScenes scene over two gloo ranks
    # on this card (and two NCCL ranks on two cards, where there are two)
    sp_launches = spatial_phase(device, smi)

    phase(17)
    # ---- 17. the visualizations at full width, a reference checkpoint
    # converted without JAX, the compact upload wire
    viz_launches = viz_phase(pipe, cfg, batches, device, smi)

    kernels = []
    # bf16 rows: the ScanNet preset's activations (phase 3's launches); f32
    # rows: the ARKitScenes and S3DIS presets' (no --bf16_acts), phase 12's
    # launches; the stem takes f32 data on every preset
    f32_launches = {m: sum(ds_launches[d].get(m, 0) for d in
                           ('arkitscenes', 's3dis')) for m in FWD_MODES}
    # dp_launches: one rank's launches over phase 15 (b)'s DP_STEPS
    # data-parallel steps of its conv path (bf16 activations, as shipped);
    # spatial_launches: rank 0's over phase 16 (c)'s SP_STEPS spatial steps
    # (f32 activations: the ARKitScenes preset; no neighbor-map kernel);
    # viz_launches: phase 17 (a)'s visualizations (the ScanNet preset, bf16
    # activations); gate_launches: phase 14's quality gate (the synthetic
    # preset, f32 activations)
    for r in rows:
        bf16 = r['mode'] == 'stem' or r['name'].endswith('bfloat16')
        f32 = not r['name'].endswith('bfloat16')
        n = launches[r['mode']] if bf16 else f32_launches[r['mode']]
        kernels.append({
            'name': r['name'], 'route': 'cuda', 'source': SRC,
            'replaces': TPU_STEM if r['mode'] == 'stem' else TPU_KERNEL,
            'launches': n, 'max_abs_err': r['max_abs_err'],
            'ms': r['ms'], 'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': None,
            'dp_launches': dp_launches['key'][r['mode']] if bf16 else 0,
            'spatial_launches': sp_launches[r['mode']] if f32 else 0,
            'viz_launches': viz_launches[r['mode']] if bf16 else 0,
            'gate_launches': gate_launches[r['mode']] if f32 else 0})
    for r in dw_rows:
        kernels.append({
            'name': r['name'], 'route': 'cuda', 'source': SRC,
            'replaces': TPU_STEM_DW if r['mode'] == 'stem_dw' else TPU_DW,
            'launches': train_launches[r['mode']],
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': None,
            'dp_launches': dp_launches['key'][r['mode']],
            'spatial_launches': sp_launches[r['mode']],
            'viz_launches': 0, 'gate_launches': gate_launches[r['mode']]})
    for r in nm_rows:
        if r['main']:
            kernels.append({
                'name': r['name'], 'route': 'cuda', 'source': NMAP_SRC,
                'replaces': TPU_NMAP_CONV if r['kernel'] == 'sparse_conv'
                else TPU_GATHER, 'launches': nm_launches[r['kernel']],
                'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
                'dp_launches': dp_launches['nmap'][r['kernel']],
                'spatial_launches': 0, 'viz_launches': 0,
                'gate_launches': 0})
    # the BN op's kernels: launches are op calls, one launch of each kernel
    # per call (the reduce twice in a train step's BN: forward and backward);
    # eval: phase 3's slice; not counted on the other paths
    for r in bn_rows:
        n = (SLICE_BN_CALLS['slice'] if r['mode'] == 'eval'
             else train_launches['bn_fwd_train'])
        kernels.append({
            'name': r['name'], 'route': 'cuda', 'source': BN_SRC,
            'replaces': None, 'launches': n,
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': None,
            'dp_launches': None, 'spatial_launches': None,
            'viz_launches': None, 'gate_launches': None})
    for r in nt_rows:               # phase 13's shapes and launches
        kernels.append({
            'name': r['name'], 'route': 'cuda', 'source': NMAP_SRC,
            'replaces': TPU_NMAP_CONV if r['kernel'] == 'sparse_conv'
            else TPU_GATHER, 'launches': nt_launches[r['kernel']],
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': r['library_ms'],
            'dp_launches': dp_launches['nmap'][r['kernel']],
            'spatial_launches': 0, 'viz_launches': 0, 'gate_launches': 0})
    phase('end')
    log(smi)
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
