"""The CUDA key-matching conv kernels against their plain PyTorch twins, on
the card (every test here carries the `cuda` marker and skips without one).
The file imports torch and the port only, so the machine with the card runs
it without JAX:

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


def case(mode, level=0, cin=16, cout=32, seed=0):
    """(x, keys_in_b, keys_out_b, w, static kwargs) for one mode, B = 2."""
    rng = np.random.default_rng(seed)
    kin, kout, xs = [], [], []
    for b in range(2):
        fine = border_keys(rng, PAD - 60 - 90 * b, level)
        coarse = floor_keys(fine, level + 1)
        if mode == 'up':        # coarse features, fine output rows
            kin.append(padded(coarse))
            kout.append(padded(fine))
            n = len(coarse)
        else:
            kin.append(padded(fine))
            kout.append(padded(coarse if mode == 'down' else fine))
            n = len(fine)
        x = rng.normal(size=(PAD, cin)).astype(np.float32)
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
# and 256-wide tiles and the 32-wide stem output
WIDTHS = [('same', 1, 32, 64), ('same', 0, 64, 64), ('down', 1, 64, 64),
          ('same', 0, 128, 96), ('same', 1, 128, 128), ('up', 0, 256, 256),
          ('stem', 0, 6, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize('mode,level,dtype,cin,cout', [
    (m, l, d, 96, 96) for m, l in MODES for d in ('f32', 'bf16')] + [
    ('stem', 0, 'f32', 6, 96)] + [          # the stem's output is always f32
    (m, l, d, ci, co) for m, l, ci, co in WIDTHS
    for d in (('f32',) if m == 'stem' else ('f32', 'bf16'))])
def test_kernel_matches_plain_twin_on_card(cuda, mode, level, dtype, cin,
                                           cout):
    x, kin, kout, w, kw = case(mode, level, cin=cin, cout=cout, seed=level)
    xt = torch.from_numpy(x).to(cuda)
    if dtype == 'bf16':
        xt = xt.to(torch.bfloat16)
    kin_t = torch.from_numpy(kin).to(cuda)
    kout_t = torch.from_numpy(kout.reshape(-1)).to(cuda)
    w_t = torch.from_numpy(w).to(cuda)
    before = KC.LAUNCHES[mode]
    if mode == 'stem':
        got = KC.key_conv_stem(xt, kin_t, w_t)
        want = KC.key_conv_plain(xt, kin_t, kout_t, w_t,
                                 out_dtype=torch.float32, **kw)
    else:
        got = KC.key_conv(xt, kin_t, kout_t, w_t, **kw)
        want = KC.key_conv_plain(xt, kin_t, kout_t, w_t, **kw)
    torch.cuda.synchronize()
    assert KC.LAUNCHES[mode] == before + 1
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                 dtype)


# dw at the main path's widths (phase 5 of chip_smoke.py) plus cout 64 and
# cin 128: (mode, level, cin, cout)
DW_WIDTHS = [('same', 0, 96, 96), ('same', 0, 128, 96), ('same', 2, 64, 64),
             ('same', 1, 256, 256), ('same', 1, 32, 64), ('same', 0, 128, 128),
             ('down', 0, 32, 32), ('down', 1, 64, 64), ('down', 1, 128, 128),
             ('up', 0, 96, 96), ('up', 1, 256, 256), ('up', 0, 128, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('xdtype', ['f32', 'bf16'])
@pytest.mark.parametrize('mode,level,cin,cout', DW_WIDTHS)
def test_dw_kernel_matches_plain_twin_on_card(cuda, mode, level, cin, cout,
                                              xdtype):
    """dw is f32 from bf16-rounded x and g on both sides: 1e-5 of max |dw|
    (f32 summation order)."""
    x, kin, kout, w, kw = case(mode, level, cin=cin, cout=cout, seed=level)
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
@pytest.mark.parametrize('cin,cout', [(6, 32), (3, 32), (8, 16)])
def test_stem_dw_kernel_matches_plain_twin_on_card(cuda, cin, cout):
    x, kin, _, w, _ = case('stem', cin=cin, cout=cout, seed=cin)
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
    pad_rows = (nbr >= x.shape[0]).all(1)
    assert pad_rows.any() and not got[pad_rows].any()


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
