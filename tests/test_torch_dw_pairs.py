"""The dw's pair lists on the CPU: the plain twin of the pair-list build
(`key_conv.dw_pairs_plain`), the card's scratch layout (csrc/dw_plan.cuh,
compiled here by the host's C++ compiler) and the Python mirror of its work
items (`dw_item_plan`). The card's lists and items are held to these in
tests/test_torch_kernels_cuda.py.

A dw summed over the twin's pairs must equal key_conv_dw_plain in f64 (the
same products, summed in another order: 1e-12 of max |dw|), and the lists
must equal those of a brute-force matcher over dicts of each scene's keys,
pair for pair and in output-row order.
"""

import ctypes
import os
import re
import subprocess

import numpy as np
import pytest
import torch

from box2mask_torch.sparse import _build, key_conv as KC
from box2mask_torch.sparse.keys import (AXIS_BITS, AXIS_MAX, SENT_KEY,
                                        offsets_3d, pack_delta)
from test_torch_kernels_cuda import DW_WIDTHS, case

# the guarded axis wraps (border), offsets without pairs (isolated: only
# the centre matches), pads far over the rows (deep16k at level 3, deep4k
# at level 5), rows off the 64-row tile across scenes (pad200)
LAYOUT_CASES = [(m, l, lay) for m in ('same', 'down', 'up')
                for l, lay in ((0, 'isolated'), (3, 'deep16k'),
                               (5, 'deep4k'), (0, 'pad200'))]


def keys_of(mode, level, cin, cout, layout, seed=0):
    x, kin, kout, _, kw = case(mode, level, cin=cin, cout=cout, seed=seed,
                               layout=layout)
    return x, torch.from_numpy(kin), torch.from_numpy(kout.reshape(-1)), kw


def brute_force_pairs(kin, kout, kernel_size=3, stride_child=False,
                      stride_parent=False, scale=1, guard=True):
    """Per offset the (input row, output row) pairs, from a dict of each
    scene's keys: the same-level conv by fields (an axis wrap matches
    nothing), the strided ones by packed arithmetic."""
    B, pad_in = kin.shape
    pad_out = kout.numel() // B
    rows = [{int(k): b * pad_in + i for i, k in enumerate(kin[b].tolist())
             if k < SENT_KEY} for b in range(B)]
    offs = offsets_3d(kernel_size, stride_child or stride_parent)
    out = [[] for _ in offs]
    for v, key in enumerate(kout.tolist()):
        if key >= SENT_KEY:
            continue
        f = (key >> 2 * AXIS_BITS, (key >> AXIS_BITS) & (AXIS_MAX - 1),
             key & (AXIS_MAX - 1))
        for k, off in enumerate(offs):
            if guard:
                n = [a + int(d) * scale for a, d in zip(f, off)]
                if not all(0 <= a < AXIS_MAX for a in n):
                    continue
                q = (n[0] << 2 * AXIS_BITS) | (n[1] << AXIS_BITS) | n[2]
            else:
                q = key + (-1 if stride_parent else 1) * pack_delta(off,
                                                                    scale)
            src = rows[v // pad_out].get(q)
            if src is not None:
                out[k].append((src, v))
    return [torch.tensor(p, dtype=torch.int64).reshape(-1, 2) for p in out]


def dw_over_pairs(x, g, lists):
    """dw[k] = sum over offset k's pairs of x[in]^T g[out], f64."""
    xd, gd = x.double(), g.double()
    return torch.stack([xd[p[:, 0]].T @ gd[p[:, 1]] for p in lists])


@pytest.mark.parametrize('mode,level,cin,cout,layout', [
    w + ('border',) for w in DW_WIDTHS] + [
    (m, l, 32, 32, lay) for m, l, lay in LAYOUT_CASES])
def test_dw_over_twin_pairs_matches_dw_plain(mode, level, cin, cout,
                                             layout):
    """The twin's pairs carry exactly the dw's products: summed in f64 they
    give key_conv_dw_plain's f64 dw."""
    x, kin, kout, kw = keys_of(mode, level, cin, cout, layout, seed=level)
    g = torch.from_numpy(np.random.default_rng(level).normal(
        size=(kout.numel(), cout)))
    xt = torch.from_numpy(x).double()
    lists = KC.dw_pairs_plain(kin, kout, **kw)
    want = KC.key_conv_dw_plain(xt, g, kin, kout,
                                operand_dtype=torch.float64, **kw)
    got = dw_over_pairs(xt, g, lists)
    assert got.shape == want.shape
    assert want.abs().max() > 0.1                     # non-trivial case
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * float(want.abs().max()))


@pytest.mark.parametrize('mode,level,layout', [
    (m, l, 'border') for m, l in (('same', 0), ('same', 2), ('down', 1),
                                  ('up', 0))] + LAYOUT_CASES)
def test_twin_pairs_match_brute_force(mode, level, layout):
    """Pair for pair against the brute-force matcher: output rows ascending,
    no SENT row, no axis wrap, no miss; the isolated keys leave every
    offset but the centre empty."""
    _, kin, kout, kw = keys_of(mode, level, 8, 16, layout, seed=level)
    lists = KC.dw_pairs_plain(kin, kout, **kw)
    want = brute_force_pairs(kin, kout, **kw)
    assert len(lists) == len(want) == (27 if mode == 'same' else 8)
    for got, ref in zip(lists, want):
        assert got.dtype == torch.int64 and torch.equal(got, ref)
        assert (got[1:, 1] > got[:-1, 1]).all()
    if layout == 'isolated' and mode == 'same':
        assert [len(p) > 0 for p in lists] == [k == 13 for k in range(27)]
    if mode != 'same':          # one partner per row of the finer level
        fine = kin if mode == 'down' else kout
        assert sum(len(p) for p in lists) == int((fine < SENT_KEY).sum())


def dense_case(n_side, level=0):
    """Every (offset, output row) entry matched: output keys the interior
    of a dense cube of input keys, 2 scenes."""
    s = 1 << level
    c = np.stack(np.meshgrid(*[np.arange(n_side) * s] * 3, indexing='ij'),
                 -1).reshape(-1, 3)
    keys = np.sort((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2]).astype(
        np.int32)
    inner = c[(c > 0).all(1) & (c < (n_side - 1) * s).all(1)]
    kout = np.sort((inner[:, 0] << 20) | (inner[:, 1] << 10)
                   | inner[:, 2]).astype(np.int32)
    kin_b = torch.from_numpy(np.stack([keys, keys]))
    kout_b = torch.from_numpy(np.concatenate([kout, kout]))
    return kin_b, kout_b, dict(kernel_size=3, scale=s, guard=True)


# the H100 SXM's SMs: the layout's work-item cap scales with them
SMS = 132


@pytest.fixture(scope='module')
def layout_lib(tmp_path_factory):
    """csrc/dw_plan.cuh compiled alone behind b2m_key_conv_dw_scratch's
    interface, at SMS SMs (the card's build asks its device)."""
    d = tmp_path_factory.mktemp('dw_plan')
    src, so = d / 'shim.cpp', d / 'libshim.so'
    src.write_text(
        '#include "dw_plan.cuh"\n'
        'extern "C" int b2m_key_conv_dw_scratch(int n_out, int ks, int cin,'
        ' int cout, long long* out) {\n'
        f'  dw_plan::DwScratch(n_out, ks * ks * ks, cin, cout, {SMS})'
        '.write(out);\n  return 0;\n}\n')
    subprocess.run(['c++', '-std=c++17', '-O1', '-shared', '-fPIC',
                    '-I', _build.CSRC, '-o', str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.b2m_key_conv_dw_scratch
    fn.argtypes = _build.SIGNATURES['key_conv']['b2m_key_conv_dw_scratch']
    fn.restype = ctypes.c_int
    return lib


@pytest.mark.parametrize('cin,cout', sorted({(ci + -ci % 8, co)
                                             for _, _, ci, co in DW_WIDTHS}))
def test_scratch_layout_holds_the_worst_case(layout_lib, cin, cout):
    """Where every entry matched (K x rows pairs) the card's scratch
    (csrc/dw_plan.cuh, read through key_conv.dw_scratch) holds the lists,
    the table, the partials of every item the plan makes at the largest
    target; its regions are disjoint and 64-int aligned."""
    kin, kout, kw = dense_case(6, level=1)
    lists = KC.dw_pairs_plain(kin, kout, **kw)
    n, K = kout.numel(), len(lists)
    assert [len(p) for p in lists] == [n] * K          # all matched
    lay = KC.dw_scratch(layout_lib, n, 3, cin, cout)
    assert lay['cap'] >= 2 * K
    plan = KC.dw_item_plan([len(p) for p in lists], lay['cap'] - K)
    n_items = sum(plan['items'])
    assert n_items <= lay['cap'] and plan['chunk'] % KC.DW_M == 0
    assert plan['first'] == [sum(plan['items'][:k]) for k in range(K)]
    n_pad = -(-n // KC.DW_M) * KC.DW_M               # rows up to the tile
    assert lay['n_pad'] == n_pad >= n and n_pad % KC.DW_M == 0
    assert lay['n_chunks'] == -(-n // 2048)          # PAIR_CH rows each
    need = [('pairs', 2 * K * n), ('table', max(K * n_pad,
                                                 n_items * cin * cout)),
            ('counts', K * lay['n_chunks']), ('meta', KC.DW_META + 3 * K)]
    ends = [lay[r] for r, _ in need[1:]] + [lay['total']]
    for (region, size), end in zip(need, ends):
        assert lay[region] % 64 == 0 and lay[region] + size <= end, region


def test_scratch_layout_constants_match_python(layout_lib):
    """The constants key_conv.py reads the scratch with are the header's,
    and the cap follows the SMs: DW_WAVES waves of 4 blocks an SM over the
    channel blocks of an item, plus K, at least 2 K."""
    with open(os.path.join(_build.CSRC, 'dw_plan.cuh')) as f:
        text = f.read()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(
        r'constexpr int (\w+) = (\d+);', text)}
    assert (const['DW_M'], const['DW_META']) == (KC.DW_M, KC.DW_META)
    # 96 -> 96: one channel block an item; 512 -> 256: 4 x 2
    assert KC.dw_scratch(layout_lib, 1000, 3, 96, 96)['cap'] == 2 * 4 * SMS
    assert KC.dw_scratch(layout_lib, 1000, 3, 512, 256)['cap'] == \
        2 * 4 * SMS // 8
    assert KC.dw_scratch(layout_lib, 1000, 5, 512, 256)['cap'] == 2 * 125


def test_item_plan_balances_the_items():
    """Items of `chunk` pairs (the last of an offset shorter, none for an
    offset without pairs), at most target + K of them, numbered offset by
    offset."""
    counts = [9000, 0, 250, 4096, 1]
    plan = KC.dw_item_plan(counts, 20)
    assert plan['chunk'] == 704                # 13347 / 20 -> 704 (64 x 11)
    assert plan['items'] == [13, 0, 1, 6, 1]
    assert plan['first'] == [0, 13, 13, 14, 20]
    assert sum(plan['items']) <= 20 + len(counts)
    empty = KC.dw_item_plan([0, 0], 5)
    assert empty['items'] == [0, 0] and empty['first'] == [0, 0]


def test_pairs_wrapper_is_the_cards_build_only():
    """key_conv_dw_pairs reads the card's lists back; CPU keys raise and
    name the twin, as the dw kernel's wrappers do for other devices."""
    _, kin, kout, kw = keys_of('same', 0, 8, 16, 'border')
    with pytest.raises(ValueError, match='dw_pairs_plain'):
        KC.key_conv_dw_pairs(kin, kout, cin=6, cout=16, **kw)
    with pytest.raises(ValueError):
        KC.key_conv_dw_pairs(kin.to('meta'), kout.to('meta'), cin=8,
                             cout=16, **kw)


@pytest.mark.parametrize('source', sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_c_sources(source):
    """Each exported function's ctypes argtypes against its declaration in
    csrc/<source>.cu: one pointer per `void*` / `const void*`, one int or
    float per `int` / `float`, in order (a missing int makes ctypes refuse
    every call)."""
    with open(os.path.join(_build.CSRC, f'{source}.cu')) as f:
        text = f.read()
    kind = {'int': ctypes.c_int, 'float': ctypes.c_float}
    for name, argtypes in _build.SIGNATURES[source].items():
        m = re.search(r'\bint\s+' + name + r'\s*\(([^)]*)\)\s*\{', text)
        assert m, name
        params = [p.strip() for p in m.group(1).split(',')]
        want = [ctypes.c_void_p if '*' in p else kind[p.split()[0]]
                for p in params]
        assert argtypes == want, name
