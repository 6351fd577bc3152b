#!/usr/bin/env python3
"""Ablations of the port's stem weight-gradient kernel, and the device and
host time of the neighbor-map row gather, on one NVIDIA GPU.

    python3 scripts/ablate_torch_kernels.py [variant ...]

Stem dw (box2mask_torch/csrc/key_conv.cu key_conv_stem_dw_kernel): each
variant is the source with one part cut out or changed (VARIANTS), built
by nvcc into box2mask_torch/build/ablate/ and called through its C
function on the keys of 8 ScanNet-scale synthetic scenes (cin 6, cout 32,
f32 g, as the training step calls it). Each reading: CUDA events around
10 launches issued back to back, median of 5; what a variant saves against
`base` is what that part costs. The variants that cut work compute a wrong
dw (their relative error is printed). Gather (csrc/nmap_conv.cu): the up
convs' row picks of 4 scenes, by back-to-back launches of the C function
and of the wrapper and of torch.index_select, and by single-call events;
then the host cost per call of the wrapper's steps on a tiny input.
"""

import ctypes
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from box2mask_torch.config import get_config  # noqa: E402
from box2mask_torch.datasets import batching, synthetic  # noqa: E402
from box2mask_torch.engine import state as S  # noqa: E402
from box2mask_torch.engine.infer import upload  # noqa: E402
from box2mask_torch.sparse import _build, key_conv as KC  # noqa: E402
from box2mask_torch.sparse import pallas_conv as PC  # noqa: E402

OUT = os.path.join(_build.BUILD_DIR, 'ablate')
SEARCH = 'if (it < STEM_ITEMS && v < n) {'
GATHER = '''        hopper::cp_async16(dst + u * 8, hit ? x + (size_t)src * 8 : x,
                           hit ? 16 : 0);'''
MMA = '''        mma16816(acc[u][0], af, bf[0], bf[1]);
        mma16816(acc[u][1], af, bf[2], bf[3]);'''
GLOBAL = 'for (int len = 1 << sl; len > 1; len -= len >> 1) {'
ORDER = '''    load_g(i + 1);
    search(i + 2);
    multiply(i);'''
SAMPLES = 'constexpr int STEM_SAMPLES = 1024;'
VARIANTS = {                   # name: [(source text, replacement)]
    'base': [],
    'nosearch': [(SEARCH, 'if (false) {')],          # no query: no hits
    'noglobal': [(GLOBAL, 'for (int len = 1; len > 1; len -= len >> 1) {')],
    'nogather': [(GATHER, '        hopper::cp_async16(dst + u * 8, x, 0);')],
    'nomul': [(MMA, '        (void)af; (void)bf;')],
    'two_blocks': [('__launch_bounds__(STEM_THREADS, 3)',
                    '__launch_bounds__(STEM_THREADS, 2)')],
    'samples_256': [(SAMPLES, 'constexpr int STEM_SAMPLES = 256;')],
    'multiply_first': [(ORDER, '''    load_g(i + 1);
    multiply(i);
    search(i + 2);''')],
}


def build(names):
    """One nvcc per variant, all started together; name -> C function."""
    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(_build.CSRC, 'key_conv.cu')).read()
    procs = {}
    for name in names:
        s = src
        for a, b in VARIANTS[name]:
            if a not in s:
                raise RuntimeError(f'{name}: source text not found: {a!r}')
            s = s.replace(a, b)
        path = os.path.join(OUT, f'key_conv_{name}.cu')
        with open(path, 'w') as f:
            f.write(s)
        cmd = [_build._nvcc(), '-gencode', _build.ARCH, '-std=c++17', '-O3',
               '-shared', '-Xcompiler', '-fPIC', '-I', _build.CSRC, '-o',
               os.path.join(OUT, f'lib_{name}.so'), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{out}')
        lib = ctypes.CDLL(os.path.join(OUT, f'lib_{name}.so'))
        f = lib.b2m_key_conv_stem_dw
        f.argtypes = _build.SIGNATURES['key_conv']['b2m_key_conv_stem_dw']
        f.restype = ctypes.c_int
        fns[name] = f
    return fns


def events_ms(fn, reps):
    """CUDA events around `reps` calls issued back to back, per call."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def host_us(fn, n=400):
    """Host time per call on a tiny input, synchronizing every 100."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn()
        if i % 100 == 99:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def stem_dw(cfg, names, g):
    fns = build(names)
    dev = torch.device('cuda', torch.cuda.current_device())
    kin = upload(synthetic.scannet_scale_batches(cfg, 1, 8)[0][0],
                 dev)['keys0_b']
    B, pad = kin.shape
    x = torch.randn(B * pad, 6, generator=g).to(dev, torch.bfloat16)
    gr = torch.randn(B * pad, 32, generator=g).to(dev)
    xb = KC.pad_cin(x)[0]
    n_slices = KC._slices(B * pad)
    part = torch.empty(n_slices, 125, 6, 32, device=dev)
    dw = torch.empty(125, 6, 32, device=dev)
    stream = _build.stream(dev)
    want = KC.key_conv_dw_plain(x, gr, kin, kin.reshape(-1), kernel_size=5)
    for name, f in fns.items():
        def run(f=f):
            rc = f(xb.data_ptr(), kin.data_ptr(), gr.data_ptr(),
                   part.data_ptr(), dw.data_ptr(), B, pad, 6, 32, 0,
                   n_slices, stream)
            if rc:
                raise RuntimeError(f'{name}: cudaError {rc}')
        run()
        torch.cuda.synchronize()
        err = (dw - want).abs().max().item() / want.abs().max().item()
        ms = statistics.median(events_ms(run, 10) for _ in range(5))
        print(f'[stem_dw] {name}: {ms:.4f} ms per launch; max |dw - twin| '
              f'/ max |twin| {err:.2e}', flush=True)


def gather(cfg, g):
    dev = torch.device('cuda', torch.cuda.current_device())
    batch = upload(synthetic.scannet_scale_batches(cfg, 1, 4)[0][0], dev)
    maps = S.ensure_maps(dict(batch, **{batching.DEVICE_NMAPS: torch.ones(
        (), dtype=torch.bool, device=dev)}))
    pads = [batch[f'keys{l}_b'].shape[1] for l in range(8)]
    fn = _build.load('nmap_conv').b2m_gather_rows
    stream = _build.stream(dev)
    for level, cout in ((0, 96), (3, 256)):
        U = 4 * pads[level + 1]
        parent, widx = maps[f'up_parent{level}'], maps[f'up_widx{level}']
        idx = torch.where(parent >= U, U * 8, parent * 8 + widx).to(
            torch.int32)
        y = torch.randn(U * 8, cout, generator=g).to(dev)
        out = torch.empty(idx.shape[0], cout, device=dev)
        yz, i64 = torch.cat([y, y.new_zeros(1, cout)]), idx.long()
        calls = {
            'C function': lambda: fn(y.data_ptr(), idx.data_ptr(),
                                     out.data_ptr(), idx.shape[0],
                                     y.shape[0], cout, stream),
            'gather_rows': lambda: PC.gather_rows(y, idx),
            'index_select': lambda: torch.index_select(yz, 0, i64),
        }
        line = '; '.join(
            f'{k} {events_ms(f, 50):.4f} back to back, '
            f'{statistics.median(events_ms(f, 1) for _ in range(7)):.4f} '
            'single' for k, f in calls.items())
        print(f'[gather] up {level + 1}->{level}, {cout} ch, '
              f'{idx.shape[0]} rows (ms per call): {line}', flush=True)
    y = torch.randn(64, 256, device=dev)
    idx = torch.arange(0, 64, 2, dtype=torch.int32, device=dev)
    out = torch.empty(32, 256, device=dev)
    i64 = idx.long()
    steps = {
        'gather_rows (whole wrapper)': lambda: PC.gather_rows(y, idx),
        'index_select': lambda: torch.index_select(y, 0, i64),
        'C function': lambda: fn(y.data_ptr(), idx.data_ptr(),
                                 out.data_ptr(), 32, 64, 256, stream),
        'torch.empty': lambda: torch.empty(32, 256, device=dev),
        'torch.cuda.current_stream().cuda_stream':
            lambda: torch.cuda.current_stream().cuda_stream,
        '_build.stream': lambda: _build.stream(dev),
        '_build.on': lambda: _build.on(dev).__enter__(),
    }
    for k, f in steps.items():
        print(f'[gather_host] {k}: {host_us(f):.2f} us per call', flush=True)


def main():
    if not torch.cuda.is_available():
        print('ablate_torch_kernels: no CUDA device', file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    cfg = get_config(['--config', os.path.join(ROOT, 'configs',
                                               'scannet.txt'),
                      '--vox_bucket', '131072', '--seg_bucket', '2048'])
    g = torch.Generator().manual_seed(0)
    print(torch.cuda.get_device_name(0), flush=True)
    stem_dw(cfg, names, g)
    gather(cfg, g)
    return 0


if __name__ == '__main__':
    sys.exit(main())
