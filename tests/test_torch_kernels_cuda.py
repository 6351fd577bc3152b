"""The CUDA kernels (key-matching and neighbor-map convs, the row gather,
masked batch norm) against their plain PyTorch twins, on the card (every
test here carries the `cuda` marker and skips without one). The file
imports torch and the port only, so the machine with the card runs it
without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The key and input builders are shared with tests/test_torch_key_conv.py,
which holds the twins against the JAX package on the CPU. Keys sit in
clusters at both ends of every axis (coords 0.. and ..1023), so the axis
guards, the borrows of negative field deltas and the negative transpose
queries at the borders are all exercised; B = 2 scenes with different key
counts check that a scene reads only its own key row.

Tolerances: f32 output, 1e-5 of the output scale (both sides round x and w
to bf16 and accumulate in f32; only the order of the f32 sums differs).
bf16 output, one rounding step: each element within the larger of the two
sides' bf16 ulps (the same f32 sums, rounded once; sums that straddle a
rounding boundary land on neighbouring bf16 values), plus the f32 bound
above for sums that cancel to small values.
"""

import numpy as np
import pytest
import torch

from box2mask_torch.sparse import key_conv as KC
from box2mask_torch.sparse.keys import SENT_KEY

PAD = 512


def floor_keys(keys, level):
    m = np.int64((1 << level) - 1)
    return np.unique(keys.astype(np.int64)
                     & ~((m << 20) | (m << 10) | m)).astype(np.int32)


def border_keys(rng, n, level):
    """~n keys of level `level`, in 8 corner clusters touching 0 and 1023."""
    span = 10 << level
    lo = rng.integers(0, span, (3 * n, 3))
    hi = 1023 - rng.integers(0, span, (3 * n, 3))
    c = np.where(rng.random((3 * n, 3)) < 0.5, lo, hi)
    keys = np.unique((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2])
    keys = floor_keys(keys, level)
    return keys[np.sort(rng.permutation(len(keys))[:n])]


def padded(keys, pad=PAD):
    out = np.full(pad, SENT_KEY, np.int32)
    out[:len(keys)] = keys
    return out


def lattice_keys(rng, n, level):
    """n keys of level `level` on a lattice of spacing 3 * 2^level: no key
    has a neighbour, so a 3^3 conv's tiles have exactly one live offset."""
    step = 3 << level
    c = np.unique(step * rng.integers(0, 1024 // step, (3 * n, 3)), axis=0)
    keys = np.sort((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2])
    return keys[np.sort(rng.permutation(len(keys))[:n])].astype(np.int32)


def zrun_keys(rng, n, level):
    """~n keys of level `level` in z-runs of 6 at both ends of the z axis
    (z 0..5 and 1018..1023) in columns at the x / y borders (0..2 and
    1021..1023): where the stem's z-run search meets the axis guard."""
    step = 1 << level
    edge = step * np.array([0, 1, 2, 1021 // step, 1022 // step,
                            1023 // step])
    z = step * np.concatenate([np.arange(6), 1023 // step - np.arange(6)])
    c = np.array([(a, b, cz) for a in edge for b in edge for cz in z])
    keys = np.unique((c[:, 0] << 20) | (c[:, 1] << 10) | c[:, 2])
    keep = np.sort(rng.permutation(len(keys))[:min(n, len(keys))])
    return keys[keep].astype(np.int32)


# key layouts: 'border' (corner clusters, pad 512), 'pad200' (200-row pads:
# n_out not a multiple of the kernels' 128-row tile, tiles that straddle the
# two scenes), 'sent_tiles' (scene 1 holds 40 keys: whole tiles of SENT
# rows), 'isolated' (lattice keys: one live offset per tile, fewer than the
# ring's stages); for the stem dw, not in LAYOUTS: 'zruns' (zrun_keys) and
# 'wide' (4096-row pads: the stem dw's searches leave shared memory for
# device memory past 2048 keys in all); for the dw, not in LAYOUTS, pads
# that dwarf the rows as at the deep levels: 'deep16k' (16384-row pads,
# ~20% valid, as level 3) and 'deep4k' (4096-row pads, ~4% valid, as
# level 5)
LAYOUTS = ('border', 'pad200', 'sent_tiles', 'isolated')
DEEP = {'deep16k': (16384, 3600), 'deep4k': (4096, 164)}


def case(mode, level=0, cin=16, cout=32, seed=0, layout='border'):
    """(x, keys_in_b, keys_out_b, w, static kwargs) for one mode, B = 2."""
    rng = np.random.default_rng(seed)
    pad = {'pad200': 200, 'wide': 4096}.get(layout, PAD)
    pad = DEEP.get(layout, (pad,))[0]
    kin, kout, xs = [], [], []
    for b in range(2):
        n_keys = {PAD: pad - 60 - 90 * b, 200: 150 - 40 * b}.get(
            pad, 3000 - 500 * b)
        if layout in DEEP:
            n_keys = DEEP[layout][1] * (4 - b) // 4
        if layout == 'sent_tiles' and b == 1:
            n_keys = 40
        fine = {'isolated': lattice_keys, 'zruns': zrun_keys}.get(
            layout, border_keys)(rng, n_keys, level)
        coarse = floor_keys(fine, level + 1)
        if mode == 'up':        # coarse features, fine output rows
            kin.append(padded(coarse, pad))
            kout.append(padded(fine, pad))
            n = len(coarse)
        else:
            kin.append(padded(fine, pad))
            kout.append(padded(coarse if mode == 'down' else fine, pad))
            n = len(fine)
        x = rng.normal(size=(pad, cin)).astype(np.float32)
        x[n:] = 0
        xs.append(x)
    K = {'same': 27, 'stem': 125}.get(mode, 8)
    w = (rng.normal(size=(K, cin, cout)) * 0.1).astype(np.float32)
    kw = dict(scale=1 << level)
    if mode == 'same':
        kw.update(kernel_size=3, guard=True)
    elif mode == 'stem':
        kw.update(kernel_size=5, guard=True)
    else:
        kw.update(kernel_size=2, guard=False,
                  **{'stride_child' if mode == 'down' else 'stride_parent':
                     True})
    return np.concatenate(xs), np.stack(kin), np.stack(kout), w, kw


def bf16_ulp(v):
    """One bf16 ulp at the magnitude of each element (8-bit significand)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
    return np.exp2(e - 7)


def assert_close(got, want, dtype):
    assert np.abs(want).max() > 0.1            # non-trivial case
    if dtype == 'f32':
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    else:
        ulp = np.maximum(bf16_ulp(got), bf16_ulp(want))
        assert (np.abs(got - want) <= ulp + 1e-5 * np.abs(want).max()).all()


MODES = [('same', 0), ('same', 1), ('down', 0), ('down', 1), ('up', 0),
         ('up', 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (kernel runs only on the card)')
    return torch.device('cuda')


# (mode, level, cin, cout) at the other widths of SelectionNet: the 64-wide
# output tile (enc2 blocks, down3), cin 128 (dec0_block0, enc3), the 128-
# and 256-wide tiles and the 32-wide stem output; then the tile's channel
# paths: cin 3 (plain loads), 6 (4-byte copies), 16 and 32 (several
# offsets per ring stage), 160 and 256 (two cin chunks), cout 16..256
WIDTHS = [('same', 1, 32, 64), ('same', 0, 64, 64), ('down', 1, 64, 64),
          ('same', 0, 128, 96), ('same', 1, 128, 128), ('up', 0, 256, 256),
          ('stem', 0, 6, 32), ('same', 0, 3, 16), ('same', 1, 6, 32),
          ('same', 0, 16, 48), ('down', 0, 32, 128), ('same', 0, 96, 256),
          ('up', 1, 64, 16), ('same', 0, 160, 96), ('same', 1, 256, 128),
          ('stem', 0, 3, 16)]
# the ring's edges (LAYOUTS) at a narrow and a wide channel count
EDGES = [(m, 0, lay, ci, co) for lay in LAYOUTS[1:] for m in ('same', 'up')
         for ci, co in ((16, 32), (96, 96))] + [
    ('stem', 0, lay, 6, 32) for lay in LAYOUTS[1:]] + [
    ('down', 0, lay, 32, 32) for lay in LAYOUTS[1:]]


@pytest.mark.cuda
@pytest.mark.parametrize('mode,level,dtype,cin,cout,layout', [
    (m, l, d, 96, 96, 'border') for m, l in MODES for d in ('f32', 'bf16')] + [
    ('stem', 0, 'f32', 6, 96, 'border')] + [   # the stem's output is f32
    (m, l, d, ci, co, 'border') for m, l, ci, co in WIDTHS
    for d in (('f32',) if m == 'stem' else ('f32', 'bf16'))] + [
    (m, l, d, ci, co, lay) for m, l, lay, ci, co in EDGES
    for d in (('f32',) if m == 'stem' else ('f32', 'bf16'))])
def test_kernel_matches_plain_twin_on_card(cuda, mode, level, dtype, cin,
                                           cout, layout):
    """Each mode against its twin; two launches bit-identical."""
    x, kin, kout, w, kw = case(mode, level, cin=cin, cout=cout, seed=level,
                               layout=layout)
    xt = torch.from_numpy(x).to(cuda)
    if dtype == 'bf16':
        xt = xt.to(torch.bfloat16)
    kin_t = torch.from_numpy(kin).to(cuda)
    kout_t = torch.from_numpy(kout.reshape(-1)).to(cuda)
    w_t = torch.from_numpy(w).to(cuda)
    before = KC.LAUNCHES[mode]
    if mode == 'stem':
        kern = lambda: KC.key_conv_stem(xt, kin_t, w_t)     # noqa: E731
        want = KC.key_conv_plain(xt, kin_t, kout_t, w_t,
                                 out_dtype=torch.float32, **kw)
    else:
        kern = lambda: KC.key_conv(xt, kin_t, kout_t, w_t, **kw)  # noqa
        want = KC.key_conv_plain(xt, kin_t, kout_t, w_t, **kw)
    got = kern()
    torch.cuda.synchronize()
    assert KC.LAUNCHES[mode] == before + 1
    assert got.dtype == want.dtype
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                 dtype)
    assert torch.equal(got, kern())
    sent = kout_t >= SENT_KEY                   # padding rows: exactly 0
    assert sent.any() and not got[sent].float().any()


# dw at the main path's widths (phase 5 of chip_smoke.py) plus cout 64 and
# cin 128: (mode, level, cin, cout)
DW_WIDTHS = [('same', 0, 96, 96), ('same', 0, 128, 96), ('same', 2, 64, 64),
             ('same', 1, 256, 256), ('same', 1, 32, 64), ('same', 0, 128, 128),
             ('down', 0, 32, 32), ('down', 1, 64, 64), ('down', 1, 128, 128),
             ('up', 0, 96, 96), ('up', 1, 256, 256), ('up', 0, 128, 64),
             ('same', 0, 16, 16), ('same', 0, 6, 32), ('same', 0, 3, 48),
             ('same', 0, 160, 96)]


# deep levels: level 3 on 16384-row pads (~20% valid), level 5 on 4096
# (~4%), in the three modes and at the widths of those levels
DW_DEEP = [('same', 3, 256, 256, 'deep16k'), ('same', 5, 256, 256, 'deep4k'),
           ('same', 3, 96, 96, 'deep16k'), ('same', 5, 512, 256, 'deep4k'),
           ('down', 3, 128, 128, 'deep16k'), ('up', 3, 256, 256, 'deep16k'),
           ('up', 5, 256, 256, 'deep4k')]


@pytest.mark.cuda
@pytest.mark.parametrize('xdtype', ['f32', 'bf16'])
@pytest.mark.parametrize('mode,level,cin,cout,layout', [
    w + ('border',) for w in DW_WIDTHS] + [
    (m, 0, ci, co, lay) for lay in LAYOUTS[1:] for m in ('same', 'down')
    for ci, co in ((32, 32), (96, 96))] + DW_DEEP)
def test_dw_kernel_matches_plain_twin_on_card(cuda, mode, level, cin, cout,
                                              layout, xdtype):
    """dw is f32 from bf16-rounded x and g on both sides: 1e-5 of max |dw|
    (f32 summation order); two launches bit-identical. The deep layouts:
    pads far over the rows, many items of a few pairs, pair counts off the
    64-pair tile."""
    x, kin, kout, w, kw = case(mode, level, cin=cin, cout=cout, seed=level,
                               layout=layout)
    xt = torch.from_numpy(x).to(cuda)
    if xdtype == 'bf16':
        xt = xt.to(torch.bfloat16)
    g = torch.from_numpy(np.random.default_rng(level).normal(
        size=(kout.size, cout)).astype(np.float32)).to(cuda)
    kin_t = torch.from_numpy(kin).to(cuda)
    kout_t = torch.from_numpy(kout.reshape(-1)).to(cuda)
    before = KC.LAUNCHES['dw']
    got = KC.key_conv_dw(xt, g, kin_t, kout_t, **kw)
    want = KC.key_conv_dw_plain(xt, g, kin_t, kout_t, **kw)
    torch.cuda.synchronize()
    assert KC.LAUNCHES['dw'] == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 'f32')
    again = KC.key_conv_dw(xt, g, kin_t, kout_t, **kw)
    assert torch.equal(got, again)                  # deterministic


@pytest.mark.cuda
@pytest.mark.parametrize('mode,level,cin,cout,layout', [
    ('same', 0, 96, 96, 'border'), ('same', 0, 16, 16, 'isolated'),
    ('down', 0, 32, 32, 'pad200'), ('up', 0, 96, 96, 'sent_tiles')] + DW_DEEP)
def test_dw_pair_lists_match_twin_on_card(cuda, mode, level, cin, cout,
                                          layout):
    """The pair lists the card builds for the dw equal the twin's, pair for
    pair in output-row order, and its work items equal the Python mirror of
    the plan at the target the card chose; a second build is the same."""
    _, kin, kout, _, kw = case(mode, level, cin=cin, cout=cout, seed=level,
                               layout=layout)
    kin_t = torch.from_numpy(kin).to(cuda)
    kout_t = torch.from_numpy(kout.reshape(-1)).to(cuda)
    lists, plan = KC.key_conv_dw_pairs(kin_t, kout_t, cin=cin, cout=cout,
                                       **kw)
    want = KC.dw_pairs_plain(kin_t, kout_t, **kw)
    assert len(lists) == len(want)
    for got, ref in zip(lists, want):
        assert torch.equal(got.cpu(), ref.cpu())
    assert plan == KC.dw_item_plan([len(p) for p in want], plan['target'])
    again, plan2 = KC.key_conv_dw_pairs(kin_t, kout_t, cin=cin, cout=cout,
                                        **kw)
    assert plan2 == plan and all(torch.equal(a, b)
                                 for a, b in zip(again, lists))


# the stem dw's edges: z-runs against the axis guard, tiles that straddle
# scenes and a pad off the 64-row tile (pad200), all-SENT tiles, isolated
# keys, searches past the shared-memory samples (wide); cin 3, 6, 8; cout
# 16, 32
STEM_DW_CASES = [(6, 32, 'border'), (3, 32, 'border'), (8, 16, 'border')] + [
    (6, 32, lay) for lay in LAYOUTS[1:] + ('zruns',)] + [
    (3, 16, 'zruns'), (8, 32, 'zruns'), (8, 32, 'pad200'),
    (3, 16, 'sent_tiles'), (6, 16, 'pad200'), (6, 32, 'wide'),
    (3, 16, 'wide')]


@pytest.mark.cuda
@pytest.mark.parametrize('cin,cout,layout', STEM_DW_CASES)
def test_stem_dw_kernel_matches_plain_twin_on_card(cuda, cin, cout, layout):
    """1e-5 of max |dw| (f32 summation order); g given as f32 or as bf16
    gives the same dw bit for bit (the kernel rounds f32 g to bf16 as the
    cast does); two launches bit-identical."""
    x, kin, _, w, _ = case('stem', cin=cin, cout=cout, seed=cin,
                           layout=layout)
    xt = torch.from_numpy(x).to(cuda)
    kin_t = torch.from_numpy(kin).to(cuda)
    g = torch.from_numpy(np.random.default_rng(cin).normal(
        size=(x.shape[0], cout)).astype(np.float32)).to(cuda)
    before = KC.LAUNCHES['stem_dw']
    got = KC.key_conv_stem_dw(xt, g, kin_t)
    want = KC.key_conv_dw_plain(xt, g, kin_t, kin_t.reshape(-1),
                                kernel_size=5, guard=True)
    torch.cuda.synchronize()
    assert KC.LAUNCHES['stem_dw'] == before + 1
    assert got.shape == (125, cin, cout)
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 'f32')
    assert torch.equal(got, KC.key_conv_stem_dw(xt, g, kin_t))
    assert torch.equal(got, KC.key_conv_stem_dw(xt, g.to(torch.bfloat16),
                                                kin_t))


@pytest.mark.cuda
@pytest.mark.parametrize('mode,level', [('same', 0), ('down', 0), ('up', 1),
                                        ('stem', 0)])
def test_train_function_grads_match_twins_on_card(cuda, monkeypatch, mode,
                                                  level):
    """The autograd Functions' dx and dw with the kernels against the same
    Functions with the plain twins put in their place, bf16 input."""
    cin = 6 if mode == 'stem' else 64
    x, kin, kout, w, kw = case(mode, level, cin=cin, cout=32, seed=level)
    kin_t = torch.from_numpy(kin).to(cuda)
    kout_t = torch.from_numpy(kout.reshape(-1)).to(cuda)
    c = torch.from_numpy(np.random.default_rng(1).normal(
        size=(kout.size, 32)).astype(np.float32)).to(cuda)

    def grads():
        xt = torch.from_numpy(x).to(cuda).to(torch.bfloat16)
        xt.requires_grad_()
        wt = torch.from_numpy(w).to(cuda).requires_grad_()
        if mode == 'stem':
            out = KC.key_conv_stem_train(xt, kin_t, wt)
        elif mode == 'same':
            out = KC.key_conv_train(xt, kin_t, kout_t, wt, kernel_size=3,
                                    scale=kw['scale'])
        elif mode == 'down':
            out = KC.key_conv_down_train(xt, kin_t, kout_t, wt,
                                         scale=kw['scale'])
        else:
            out = KC.key_conv_up_train(xt, kin_t, kout_t, wt,
                                       scale=kw['scale'])
        (out.float() * c).sum().backward()
        return xt.grad, wt.grad

    dx_k, dw_k = grads()
    monkeypatch.setattr(KC, 'key_conv', KC.key_conv_plain)
    monkeypatch.setattr(KC, 'key_conv_dw', KC.key_conv_dw_plain)
    monkeypatch.setattr(KC, 'key_conv_stem', lambda x, kin, w: (
        KC.key_conv_plain(x, kin, kin.reshape(-1), w, kernel_size=5,
                          out_dtype=torch.float32)))
    monkeypatch.setattr(KC, 'key_conv_stem_dw', lambda x, g, kin: (
        KC.key_conv_dw_plain(x, g, kin, kin.reshape(-1), kernel_size=5)))
    dx_t, dw_t = grads()
    torch.cuda.synchronize()
    assert dx_k.dtype == dx_t.dtype == torch.bfloat16
    if mode == 'stem':                  # the stem's input is data
        assert not dx_k.float().any() and not dx_t.float().any()
    else:
        assert_close(dx_k.float().cpu().numpy(),
                     dx_t.float().cpu().numpy(), 'bf16')
    assert_close(dw_k.cpu().numpy(), dw_t.cpu().numpy(), 'f32')


# ---------------------------------------------- neighbor-map conv and gather
def nmap_batch(seed=0, n=400):
    """Neighbor maps (sparse/device_maps.py) of 2 scenes of corner-cluster
    keys (voxels at 0 and 1023 on every axis, different counts), as built
    on the device for a --key_conv off batch; CPU tensors."""
    from box2mask_torch.datasets.batching import level_pads
    from box2mask_torch.sparse import device_maps as DM
    from box2mask_torch.sparse.keys import host_level_keys
    rng = np.random.default_rng(seed)
    per_scene = []
    for b in range(2):
        c = np.where(rng.random((n - 90 * b, 3)) < 0.5,
                     rng.integers(0, 12, (n - 90 * b, 3)),
                     1023 - rng.integers(0, 12, (n - 90 * b, 3)))
        per_scene.append(host_level_keys(np.unique(c, axis=0).astype(np.int32)))
    pads = level_pads(per_scene, PAD)
    keys = []
    for l, pad in enumerate(pads):
        kb = np.full((2, pad), SENT_KEY, np.int32)
        for i, ks in enumerate(per_scene):
            kb[i, :len(ks[l])] = ks[l]
        keys.append(torch.from_numpy(kb))
    return DM.build_batch_maps_from_keys(tuple(keys)), pads


# (map, level of x, cin, cout) at the widths of chip_smoke.py phase 8
NMAP_WIDTHS = [('nmap5_0', 0, 6, 32), ('nmap3_0', 0, 96, 96),
               ('nmap3_0', 0, 128, 96), ('nmap3_2', 2, 64, 64),
               ('nmap3_3', 3, 256, 256), ('down0', 0, 32, 32),
               ('down2', 2, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('name,level,cin,cout', NMAP_WIDTHS)
def test_nmap_conv_kernel_matches_plain_twin_on_card(cuda, name, level, cin,
                                                     cout, dtype):
    """sparse_conv is f32 out on both sides from bf16-rounded operands:
    1e-5 of max |out|; padding rows exactly 0."""
    from box2mask_torch.sparse import pallas_conv as PCV
    maps, pads = nmap_batch(seed=level)
    nbr = maps[name].to(cuda)
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.normal(size=(2 * pads[level], cin)).astype(
        np.float32)).to(cuda)
    if dtype == 'bf16':
        x = x.to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(nbr.shape[1], cin, cout))
                          * 0.1).astype(np.float32)).to(cuda)
    before = PCV.LAUNCHES['sparse_conv']
    got = PCV.sparse_conv(x, nbr, w)
    want = PCV.sparse_conv_plain(x, nbr, w)
    torch.cuda.synchronize()
    assert PCV.LAUNCHES['sparse_conv'] == before + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 'f32')
    pad_rows = (nbr >= x.shape[0]).all(1)       # sentinel-only rows
    assert pad_rows.any() and not got[pad_rows].any()
    assert torch.equal(got, PCV.sparse_conv(x, nbr, w))


@pytest.mark.cuda
@pytest.mark.parametrize('level,cout', [(0, 96), (3, 256)])
def test_gather_rows_kernel_matches_plain_twin_on_card(cuda, level, cout):
    """The up conv's row pick with its bf16 rounding: bit-equal."""
    from box2mask_torch.sparse import pallas_conv as PCV
    maps, pads = nmap_batch(seed=level)
    U = 2 * pads[level + 1]
    parent, widx = maps[f'up_parent{level}'], maps[f'up_widx{level}']
    idx = torch.where(parent >= U, U * 8, parent * 8 + widx).to(cuda)
    y = torch.from_numpy(np.random.default_rng(cout).normal(
        size=(U * 8, cout)).astype(np.float32)).to(cuda)
    before = PCV.LAUNCHES['gather_rows']
    got = PCV.gather_rows(y, idx)
    want = PCV.gather_rows_plain(y, idx)
    torch.cuda.synchronize()
    assert PCV.LAUNCHES['gather_rows'] == before + 1
    assert torch.equal(got, want)
    assert (idx == U * 8).any()


def monotone_idx(rng, n, vin, sent_share):
    """(n,) int32 ascending row picks below vin, a share of them replaced
    by the sentinel vin."""
    idx = np.sort(rng.integers(0, vin, n))
    idx[rng.random(n) < sent_share] = vin
    return idx.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize('edge,n,vin,c', [
    ('all_sentinel', 1000, 512, 96),
    ('c_not_4', 1000, 512, 6),          # single-float path
    ('c_not_4', 777, 300, 30),
    ('unaligned_x', 1000, 512, 96),     # x 4 bytes off 16: single floats
    ('odd_n', 1001, 512, 96),           # n off the 4 elements per thread
    ('odd_n', 3, 8, 256),
    ('odd_n', 100003, 4096, 256)])
def test_gather_rows_kernel_edges_on_card(cuda, edge, n, vin, c):
    """gather_rows at its edges: bit-equal to the twin."""
    from box2mask_torch.sparse import pallas_conv as PCV
    rng = np.random.default_rng(n + c)
    vals = rng.normal(size=vin * c + 1).astype(np.float32)
    buf = torch.from_numpy(vals).to(cuda)
    x = (buf[1:] if edge == 'unaligned_x' else buf[:-1]).view(vin, c)
    assert (x.data_ptr() % 16 != 0) == (edge == 'unaligned_x')
    idx = torch.from_numpy(monotone_idx(
        rng, n, vin, 1.0 if edge == 'all_sentinel' else 0.3)).to(cuda)
    got = PCV.gather_rows(x, idx)
    want = PCV.gather_rows_plain(x, idx)
    torch.cuda.synchronize()
    assert got.shape == (n, c) and torch.equal(got, want)
    if edge == 'all_sentinel':
        assert not got.any()


# ------------------------------------------- masked batch norm + ReLU (+ res)
def bn_case(cuda, rows, c, xdtype, ydtype, seed):
    """Level-0-like rows of 8 (train) or 4 (eval) scenes of 131072 rows,
    each valid for a prefix of 100k-125k rows; x ~ N(0.5, 2) with channel 0
    0.5 on the valid rows (s1, s2 exact in any order: v0 = 0 on both
    sides, where the clamp passes the gradient); f32 parameters
    and running statistics; a residual in y's dtype; the upstream gradient
    g in y's dtype, on padded rows too."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    scenes = rows // 131072
    n_s = torch.randint(100_000, 125_000, (scenes,), generator=gen,
                        device=cuda)
    valid = (torch.arange(131072, device=cuda)[None, :]
             < n_s[:, None]).reshape(-1)
    x = torch.randn(rows, c, generator=gen, device=cuda) * 2 + 0.5
    x[valid, 0] = 0.5
    p = {k: torch.randn(c, generator=gen, device=cuda) * 0.3 + mu
         for k, mu in (('scale', 1.0), ('bias', 0.0), ('mean', 0.0))}
    p['var'] = torch.rand(c, generator=gen, device=cuda) * 1.5 + 0.5
    res = torch.randn(rows, c, generator=gen, device=cuda).to(ydtype)
    g = torch.randn(rows, c, generator=gen, device=cuda).to(ydtype)
    return (x.to(xdtype), valid, n_s.sum().to(torch.int32).reshape(()), p,
            res, g)


def bf16_ulp_t(v):
    """One bf16 ulp at the magnitude of each element (torch, on the card)."""
    v = v.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


BN_DTYPES = {'bf16': (torch.bfloat16, torch.bfloat16),
             'f32': (torch.float32, torch.float32),
             'f32_to_bf16': (torch.float32, torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize('act', ['relu', 'relu_res', 'none'])
@pytest.mark.parametrize('c', [32, 64, 96, 128, 256])
@pytest.mark.parametrize('dtypes', list(BN_DTYPES))
def test_masked_bn_kernels_match_twin_on_card(cuda, dtypes, c, act):
    """The four kernels (sums + reduce/finalize, normalize; backward sums +
    reduce, dx) against the twin's torch ops on the same card, train mode
    at the level-0 train shape (1,048,576 rows) and eval at the eval shape
    (524,288). The twin's backward takes the kernels' y and statistics, so
    the backward kernels are held alone. Tolerances: the statistics and
    the f32 sums differ only in the order of the f32 sums (mean 1e-5 of
    max |x|, inv 1e-4 relative: var = s2/n - mean^2 cancels, running
    statistics the same); f32 y and dx 1e-5 of their scale; bf16 y one
    bf16 step of the normalized value z (the statistics move z by ~1e-6,
    so its rounding may land on the neighbouring value), plus one step of
    y when the residual sum rounds again; bf16 dx one step plus 1e-5 of
    its scale (the moments' terms subtract); dbias, dscale 1e-5 of the sum
    of the terms' magnitudes; dresidual = g' bit-equal. Each launch twice:
    bit-equal (fixed-order sums, no atomics). With ReLU, g is a slice of a
    wider tensor, as a concat's gradient comes."""
    from box2mask_torch.sparse import masked_bn as MB
    xdt, ydt = BN_DTYPES[dtypes]
    relu, has_res = act != 'none', act == 'relu_res'
    for training, rows in ((True, 1 << 20), (False, 1 << 19)):
        x, valid, nv, p, res, g = bn_case(cuda, rows, c, xdt, ydt, c + rows)
        if relu:
            wide = torch.randn(rows, c + 32, device=cuda).to(ydt)
            wide[:, :c] = g
            g = wide[:, :c]
        res = res if has_res else None
        cfg = MB.Cfg(training, True, 0.1, 1e-5, relu, ydt, None)
        runs = {}
        for side in ('kernel', 'kernel_again', 'twin'):
            rm, rv = p['mean'].clone(), p['var'].clone()
            fwd = MB.forward_plain if side == 'twin' else MB.forward_cuda
            y, st = fwd(x, p['scale'], p['bias'], res, valid, nv, rm, rv,
                        cfg)
            runs[side] = (y, st, rm, rv)
        torch.cuda.synchronize()
        y_k, st_k, rm_k, rv_k = runs['kernel']
        for a, b in zip(runs['kernel'], runs['kernel_again']):
            assert (a is None and b is None) or torch.equal(a, b)
        y_t, st_t, rm_t, rv_t = runs['twin']
        assert y_k.dtype == ydt
        if training:
            mean_k, inv_k = st_k[:c], st_k[c:2 * c]
            mean_t, inv_t = st_t[:c], st_t[c:2 * c]
            xmax = float(x.float().abs().max())
            assert float((mean_k - mean_t).abs().max()) <= 1e-5 * xmax
            assert float(((inv_k - inv_t) / inv_t).abs().max()) <= 1e-4
            assert torch.equal(st_k[2 * c:], st_t[2 * c:])   # flags, n
            assert float(st_k[0]) == 0.5 and float(st_k[2 * c]) == 1.0
            assert float((rm_k - rm_t).abs().max()) <= 1e-5 * xmax
            assert float(((rv_k - rv_t) / rv_t).abs().max()) <= 1e-4
            mean, inv = mean_t, inv_t
        else:
            assert torch.equal(rm_k, p['mean']) and torch.equal(rv_k,
                                                                p['var'])
            mean, inv = p['mean'], torch.rsqrt(p['var'] + 1e-5)
        z = (x.float() - mean) * (inv * p['scale']) + p['bias']
        zmax = float(z.abs().max())
        diff = (y_k.float() - y_t.float()).abs()
        if ydt == torch.float32:
            assert float(diff.max()) <= 1e-5 * zmax
        else:
            tol = bf16_ulp_t(z) + 1e-5 * zmax
            if has_res:
                tol = tol + torch.maximum(bf16_ulp_t(y_k), bf16_ulp_t(y_t))
            assert bool((diff <= tol).all())
        # backward on the kernels' forward
        outs = {}
        for side in ('kernel', 'kernel_again', 'twin'):
            if side == 'twin':
                dx, ds, db, dres = MB.backward_plain(
                    g, x, y_k, valid, p['scale'], st_k, p['mean'], p['var'],
                    cfg)
            else:
                dx, ds, db, dres = MB.backward_cuda(
                    g, x, y_k, valid, p['scale'], st_k, p['mean'], p['var'],
                    cfg, need_res=has_res)
            outs[side] = (dx, ds, db, dres if has_res else None)
        torch.cuda.synchronize()
        for a, b in zip(outs['kernel'], outs['kernel_again']):
            assert (a is None and b is None) or torch.equal(a, b)
        (dx_k, ds_k, db_k, dr_k), (dx_t, ds_t, db_t, dr_t) = (outs['kernel'],
                                                              outs['twin'])
        assert dx_k.dtype == xdt
        if has_res:
            assert dr_k.dtype == ydt and torch.equal(dr_k, dr_t)
        gp = torch.where(y_k > 0, g, 0).float() if relu else g.float()
        xhat = ((x.float() - (st_k[:c] if training else mean))
                * (st_k[c:2 * c] if training else inv))
        for got, want, mag in ((db_k, db_t, gp.abs().sum(0)),
                               (ds_k, ds_t, (gp * xhat).abs().sum(0))):
            assert bool(((got - want).abs() <= 1e-5 * mag + 1e-30).all())
        dmax = float(dx_t.float().abs().max())
        ddiff = (dx_k.float() - dx_t.float()).abs()
        if xdt == torch.float32:
            assert float(ddiff.max()) <= 1e-5 * dmax
        else:
            tol = torch.maximum(bf16_ulp_t(dx_k), bf16_ulp_t(dx_t))
            assert bool((ddiff <= tol + 1e-5 * dmax).all())


@pytest.mark.cuda
def test_cuda_tensor_without_kernel_library_raises(cuda, monkeypatch,
                                                   tmp_path):
    """With no built library and no nvcc, a CUDA tensor raises in the
    wrapper; it never falls back to the plain twin."""
    from box2mask_torch.sparse import _build
    from box2mask_torch.sparse import pallas_conv as PCV

    def no_nvcc():
        raise RuntimeError('nvcc not found')
    monkeypatch.setattr(_build, 'BUILD_DIR', str(tmp_path))
    monkeypatch.setattr(_build, '_libs', {})
    monkeypatch.setattr(_build, '_nvcc', no_nvcc)
    maps, pads = nmap_batch()
    x = torch.ones(2 * pads[0], 32, device=cuda)
    w = torch.ones(8, 32, 32, device=cuda)
    plain = dict(PCV.PLAIN_CALLS)
    with pytest.raises(RuntimeError, match='nvcc'):
        PCV.sparse_conv(x, maps['down0'].to(cuda), w)
    with pytest.raises(RuntimeError, match='nvcc'):
        PCV.gather_rows(x, maps['up_parent0'].to(cuda))
    assert PCV.PLAIN_CALLS == plain
    from box2mask_torch.sparse import masked_bn as MB
    bn_plain = dict(MB.PLAIN_CALLS)
    ones = torch.ones(32, device=cuda)
    with pytest.raises(RuntimeError, match='nvcc'):
        MB.bn_act(x, torch.ones(x.shape[0], dtype=torch.bool, device=cuda),
                  torch.tensor(x.shape[0], device=cuda), ones, ones, ones,
                  ones, training=True, relu=True)
    assert MB.PLAIN_CALLS == bn_plain
