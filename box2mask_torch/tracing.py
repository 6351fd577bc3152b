"""The port's spans and counters.

span(name) is a host range while a torch profiler runs (torch.profiler, the
Trainer's --profile_dir trace), and one shared null context otherwise, so a
span costs one flag read when nothing records. The range is a plain
RecordFunction, the kind aten ops record: it lies on the clock of the CUDA
events the profiler records, and the kernels launched inside it carry its
correlation, but it is not a user annotation, which Kineto would mirror onto
the device's timeline as a range as long as its kernels and gaps together.
The flag read is the process-wide one: the thread-local profiler state is
off on the packer and harvester threads even when the profiler records
every thread (profiler_config). Names start with `b2m.` and name a layer,
never a batch: a batch's spans are tied together by their order on each
thread.

Counters are host ints added where the work happens (add, under a lock:
a harvester thread's fallback post-processing adds too); none reads a
device value. reset_counts() and counts() cover them and the kernel
modules' own counter dicts, which stay where their tests read them.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

# scenes through FusedInferencePipeline.run; trips of the two greedy
# post-processing loops, and their host reads of a device flag
NAMES = ('scenes', 'cluster_steps', 'mask_nms_steps', 'post_syncs')
COUNTS = dict.fromkeys(NAMES, 0)
_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()


def span(name):
    """A profiler range named `name` while a profiler runs, else a shared
    null context."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _OFF


def add(name, n=1):
    with _LOCK:
        COUNTS[name] += n


def profiler_config():
    """The profiler setting of the port's traces: host events of every
    thread, so the packer's and harvesters' spans are in them."""
    return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)


def _kernel_modules():
    from box2mask_torch.parallel import spatial
    from box2mask_torch.sparse import key_conv, masked_bn, ops, pallas_conv
    return key_conv, pallas_conv, masked_bn, ops, spatial


def reset_counts():
    """Zero every counter of the port."""
    with _LOCK:
        for k in COUNTS:
            COUNTS[k] = 0
    for mod in _kernel_modules():
        mod.reset_counts()


def counts():
    """Every counter of the port: this module's, then the kernel launches
    and plain-twin calls per mode (masked_bn: op calls, each 2-3
    launches), the ops' torch formulation calls and the spatial halo
    exchanges."""
    key_conv, pallas_conv, masked_bn, ops, spatial = _kernel_modules()
    with _LOCK:
        out = dict(COUNTS)
    out.update(key_conv=dict(key_conv.LAUNCHES),
               key_conv_plain=dict(key_conv.PLAIN_CALLS),
               nmap_conv=dict(pallas_conv.LAUNCHES),
               nmap_conv_plain=dict(pallas_conv.PLAIN_CALLS),
               masked_bn=dict(masked_bn.LAUNCHES),
               masked_bn_plain=dict(masked_bn.PLAIN_CALLS),
               torch_formulation=dict(ops.XLA_CALLS),
               halo=dict(spatial.HALO))
    return out
