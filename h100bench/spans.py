"""The program's own spans and counters, as the benchmark reads them.

The program (box2mask_torch/tracing.py) opens `b2m.` spans at its layer
boundaries while a profiler runs, on every thread it uses: the packer, the
harvesters and the main thread. program_profile(fn, device) runs fn() under
torch.profiler with CPU and CUDA activities and every thread's host events,
and returns:

  spans: per `b2m.` name, its count, its host seconds and the kernels
      launched inside it (the CUDA runtime's launch calls) on its thread,
      or on a thread that opens no `b2m.` span, which works for the
      calling thread (autograd's backward thread);
  idle_s: the stretch's device-idle seconds, the complement of the union
      of the device events over the stretch;
  idle_by_span: those seconds split over the innermost `b2m.` span open on
      the calling thread at each instant, or where it holds none, over the
      latest-opened one another thread holds;
  idle_s_unspanned: the idle seconds under no `b2m.` span;
  seconds: the stretch's seconds; launches: every launch call in it.

The program's counters are box2mask_torch.tracing.counts(). All times are the profiler's microseconds until summarise() turns them
into seconds.
"""

from __future__ import annotations

import bisect

from h100bench import device as D

PREFIX = 'b2m.'
MARK = 'h100bench.stretch'
LAUNCH_CALLS = frozenset((
    'cudaLaunchKernel', 'cudaLaunchKernelExC', 'cuLaunchKernel',
    'cuLaunchKernelEx', 'cudaLaunchCooperativeKernel'))



def _union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def idle_intervals(device, t0, t1):
    """Complement of the union of device intervals within [t0, t1]."""
    busy = _union([(max(s, t0), min(e, t1)) for s, e in device
                   if e > t0 and s < t1])
    out, t = [], t0
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < t1:
        out.append((t, t1))
    return out


def split_idle(idle, spans, main):
    """idle: sorted disjoint (a, b); spans: (start, end, name, thread).
    Each idle instant goes to the innermost span open on thread `main`
    there, else to the latest-opened span open on another thread, else to
    no span. Returns ({name: time}, unspanned time)."""
    marks = sorted([(s, 0, i) for i, (s, _, _, _) in enumerate(spans)]
                   + [(e, 1, i) for i, (_, e, _, _) in enumerate(spans)])
    points = sorted({p for iv in idle for p in iv}
                    | {m[0] for m in marks})
    by, none = {}, 0.0
    open_, k, j = set(), 0, 0
    for p, q in zip(points, points[1:]):
        while k < len(marks) and marks[k][0] <= p:
            _, end, i = marks[k]
            (open_.discard if end else open_.add)(i)
            k += 1
        while j < len(idle) and idle[j][1] <= p:
            j += 1
        if j == len(idle) or idle[j][0] > p:
            continue
        own = [spans[i] for i in open_ if spans[i][3] == main]
        pick = own or [spans[i] for i in open_]
        if pick:
            name = max(pick, key=lambda s: (s[0], -s[1]))[2]
            by[name] = by.get(name, 0.0) + (q - p)
        else:
            none += q - p
    return by, none


def summarise(spans, launches, device, main, t0, t1):
    """The stretch [t0, t1] (us) from its `b2m.` spans (start, end, name,
    thread), the launch calls (start, thread), the device events' (start,
    end) and the calling thread `main`; the dict program_profile returns,
    in seconds. Launches on a thread that opens no span count as the
    calling thread's."""
    spans = [s for s in spans if s[2].startswith(PREFIX)]
    own = {s[3] for s in spans}
    per_thread = {}
    for t, th in sorted(launches):
        per_thread.setdefault(th if th in own else main, []).append(t)
    out = {}
    for s, e, name, th in spans:
        ts = per_thread.get(th, [])
        n = bisect.bisect_right(ts, e) - bisect.bisect_left(ts, s)
        row = out.setdefault(name, {'count': 0, 'host_s': 0.0,
                                    'launches': 0})
        row['count'] += 1
        row['host_s'] += (e - s) / 1e6
        row['launches'] += n
    idle = idle_intervals(device, t0, t1)
    by, none = split_idle(idle, spans, main)
    return {'spans': out,
            'idle_s': sum(b - a for a, b in idle) / 1e6,
            'idle_by_span': {k: v / 1e6 for k, v in sorted(by.items())},
            'idle_s_unspanned': none / 1e6,
            'seconds': (t1 - t0) / 1e6,
            'launches': len(launches)}


def program_profile(fn, device):
    """fn() under torch.profiler, every thread's host events recorded;
    returns (fn's result, summarise's dict)."""
    from torch.profiler import ProfilerActivity, profile
    from torch._C._profiler import _ExperimentalConfig, _RecordFunctionFast
    D.sync(device)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == 'cuda' else [])
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        with _RecordFunctionFast(MARK):
            res = fn()
            D.sync(device)
    spans, launches, dev, mark = [], [], [], None
    for e in prof.events():
        tr = e.time_range
        if e.device_type.name == 'CUDA':
            if not e.is_user_annotation:
                dev.append((tr.start, tr.end))
        elif e.name == MARK:
            mark = e
        elif e.name in LAUNCH_CALLS:
            launches.append((tr.start, e.thread))
        elif e.name.startswith(PREFIX):
            spans.append((tr.start, tr.end, e.name, e.thread))
    t0, t1 = mark.time_range.start, mark.time_range.end
    launches = [x for x in launches if t0 <= x[0] <= t1]
    return res, summarise(spans, launches, dev, mark.thread, t0, t1)


def layer_readings(kind, prog):
    """The per-layer numbers of a program stretch; `prog` holds
    program_profile's dict ('profile'), the program's counters ('counts'),
    the stretch's batches and scenes, or steps, and for inference the
    pipeline's pack_s and wire_bytes."""
    p, c = prog['profile'], prog['counts']
    spans, idle = p['spans'], p['idle_by_span']

    def idle_ms(*names):
        return 1e3 * sum(idle.get(k, 0.0) for k in names)
    if kind == 'train':
        n = prog['steps']
        return {'upload_idle_ms.train': idle_ms('b2m.train.upload') / n,
                'step_launches.train':
                    spans['b2m.train.step']['launches'] / n}
    nb, ns = prog['batches'], prog['scenes']
    return {
        'post_launches.infer': spans['b2m.infer.post']['launches'] / nb,
        'greedy_steps.infer':
            (c['cluster_steps'] + c['mask_nms_steps']) / ns,
        'post_syncs.infer': c['post_syncs'] / nb,
        'post_idle_ms.infer': idle_ms(
            'b2m.infer.post', 'b2m.post.cluster', 'b2m.post.mask_nms') / nb,
        'pack_ms.infer': 1e3 * prog['pack_s'] / nb,
        'wire_mb.infer': prog['wire_bytes'] / 1e6 / nb,
        'pack_wait_ms.infer':
            1e3 * spans['b2m.infer.wait_pack']['host_s'] / nb,
        'harvest_wait_ms.infer':
            1e3 * spans['b2m.infer.wait_harvest']['host_s'] / nb}


def spanned_share(p):
    """Share of a stretch's idle seconds under some `b2m.` span."""
    if p['idle_s'] <= 0:
        return None
    return 1 - p['idle_s_unspanned'] / p['idle_s']
