"""Build and load the port's CUDA kernels: nvcc into a shared library with a
plain C interface, loaded with ctypes.

Each `csrc/*.cu` source builds into `box2mask_torch/build/` under a name that
carries a hash of its source and of the shared headers (`csrc/*.cuh`), at
first use; every source compiles in its own nvcc process, all started
together. Nothing here runs at import time: the CPU tests import every
module of the package on hosts without nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, 'build')
ARCH = 'arch=compute_90a,code=sm_90a'

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# exported C functions per source: name -> argtypes (every function returns
# the cudaGetLastError() code after its launch)
SIGNATURES = {
    'key_conv': {
        'b2m_key_conv': [_P] * 6 + [_I] * 11 + [_P],
        'b2m_key_conv_stem': [_P] * 5 + [_I] * 4 + [_P],
        'b2m_key_conv_dw': [_P] * 7 + [_I] * 11 + [_P],
        'b2m_key_conv_stem_dw': [_P] * 5 + [_I] * 6 + [_P],
    },
    'nmap_conv': {
        'b2m_nmap_conv': [_P] * 5 + [_I] * 5 + [_P],
        'b2m_gather_rows': [_P] * 3 + [_I] * 3 + [_P],
    },
    'masked_bn': {
        'b2m_bn_sums': [_P] * 3 + [_I] * 4 + [_P],
        'b2m_bn_reduce': [_P, _I, _I] + [_P] * 5 + [_I] * 2 + [_F] * 3
        + [_P],
        'b2m_bn_finalize': [_P, _I] + [_P] * 3 + [_I] + [_F] * 3 + [_P],
        'b2m_bn_norm': [_P] * 7 + [_I] * 6 + [_F, _P],
        'b2m_bn_bwd_sums': [_P] * 6 + [_I] * 7 + [_F, _I, _P],
        'b2m_bn_dx': [_P] * 12 + [_I] * 7 + [_F, _I, _P],
    },
}

_libs = {}
_lock = threading.Lock()
build_seconds = {}       # source -> wall seconds of its nvcc run (0 if cached)


def on(device):
    """A context making `device` current for a launch; none when it already
    is (entering a device context costs microseconds per call)."""
    import torch
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream(device):
    """The raw handle of PyTorch's current stream on `device`, for the C
    launch functions: torch.cuda.current_stream() builds a Stream object
    per call, 5-9 us of host time on an H100 host against 0.2-0.6 us for
    this (scripts/ablate_torch_kernels.py)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device.index)


def _nvcc():
    for cand in (shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels are built on the '
                       'machine with the card (CUDA toolkit required)')


def _target(name):
    src = os.path.join(CSRC, f'{name}.cu')
    h = hashlib.sha1(ARCH.encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, '*.cuh'))):
        with open(path, 'rb') as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f'lib{name}_{digest}.so')


def build_all(names=None):
    """Compile every missing library, one nvcc per source, in parallel.
    Raises with nvcc's output if any build fails."""
    names = list(names or SIGNATURES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            build_seconds.setdefault(name, 0.0)
            continue
        tmp = f'{so}.{os.getpid()}.tmp'
        cmd = [_nvcc(), '-gencode', ARCH, '-std=c++17', '-O3', '-shared',
               '-Xcompiler', '-fPIC', '-o', tmp, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        out, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f'{name}:\n{out}')
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))


def load(name):
    """The ctypes library of csrc/<name>.cu, built if needed."""
    lib = _libs.get(name)               # loaded: no lock on the hot path
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src, so = _target(name)
            if not os.path.exists(so):
                build_all([name])
            lib = ctypes.CDLL(so)
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib
