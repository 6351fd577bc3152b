"""The card: what it is, its published peaks, and the readings taken from
it (synchronised host times, torch.profiler traces).

Peaks are NVIDIA's data-sheet figures of one H100 SXM at 700 W: 989 TFLOP/s
dense bf16 on the tensor cores (both presets multiply bf16 operands) and
3.35 TB/s of HBM3. The card's power limit is printed beside every run.
"""

from __future__ import annotations

import subprocess
import time

import torch

PEAK_BF16_FLOP_S = 989e12
PEAK_HBM_BYTES_S = 3.35e12
KEY_CONV_KERNELS = ('key_conv_kernel', 'key_conv_dw_kernel',
                    'key_conv_stem_kernel', 'key_conv_stem_dw_kernel',
                    'match_table_kernel', 'sum_slices_kernel')


def card(device):
    """name, count and power limit of the card (nvidia-smi, if present)."""
    info = {'kind': torch.cuda.get_device_name(device), 'count': 1}
    try:
        info['nvidia_smi'] = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader', '-i', str(device.index or 0)],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        info['nvidia_smi'] = f'unavailable: {e}'
    return info


def sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def _union_s(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def profile(fn, device, host=True):
    """fn() under torch.profiler. Returns the traced window's seconds, the
    seconds in which some operation ran on the device (the union of the
    device events), device seconds by operation name, and the ten longest
    idle gaps, each named by the innermost host span open at its middle
    (with `host` off, only the device is traced and the gaps go unnamed)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    sync(device)
    cuda = device.type == 'cuda'
    acts = (([ProfilerActivity.CUDA] if cuda else [])
            + ([ProfilerActivity.CPU] if host or not cuda else []))
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        window_s = time.perf_counter() - t0
    dev, spans = [], []
    for e in prof.events():
        tr = e.time_range
        item = (tr.start, tr.end, e.name)
        if e.device_type.name == 'CUDA':
            dev.append(item)
        else:
            spans.append(item)
    by_name = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    busy = _union_s([(s, e) for s, e, _ in dev])
    gaps = []
    end = None
    for s, e, _ in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        open_ = [(e - s, n) for s, e, n in spans if s <= mid <= e]
        named.append([min(open_)[1] if open_ else 'no host span',
                      (b - a) / 1e6])
    return {'window_s': window_s, 'busy_s': busy, 'by_name': by_name,
            'idle_gaps': named}


def key_conv_device_s(by_name):
    """Device seconds of the key-conv kernels in a trace's by-name sums."""
    return sum(t for n, t in by_name.items()
               if any(k in n for k in KEY_CONV_KERNELS))


def top_ops(by_name, n=10):
    return [[k[:200], t] for k, t in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:n]]
