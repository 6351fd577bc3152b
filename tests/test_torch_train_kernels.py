"""The port's weight-gradient twins (key_conv_dw, key_conv_stem_dw) against
the JAX package's Pallas dw kernels in interpret mode, as the JAX tests run
them on the CPU, in every mode of the training path.

Keys and inputs come from test_torch_kernels_cuda.case (keys clustered at
both ends of every axis, B = 2 scenes). Both sides round x and g to bf16 and
accumulate in f32, so the two dw differ only in the order of the f32 sums:
tolerance 1e-5 of max |dw| (an input already in bf16 is the same bf16 value
on both sides).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu.sparse import key_conv as JKC
from box2mask_torch.sparse import key_conv as KC
from test_torch_kernels_cuda import PAD, case


def jax_plans(kin, kout, kernel_size, scale, stride_parent=False,
              window=JKC.WINDOW):
    """The JAX package's per-scene window plans (bases, counts) for one
    conv mode over padded key rows."""
    offs = JKC.offsets_3d(kernel_size, stride_child=kernel_size == 2)
    sign = -1 if stride_parent else 1
    deltas = [sign * JKC.pack_delta(o, scale) for o in offs]
    groups = JKC.group_by_dx(offs)
    win = min(window, kin.shape[1])
    plans = [JKC._host_bases(kin[b], kout[b], deltas, groups, win,
                             kin.shape[1]) for b in range(kin.shape[0])]
    return (jnp.asarray(np.stack([p[0] for p in plans])),
            jnp.asarray(np.stack([p[1] for p in plans])), win)


def cotangent(rows, cout, seed):
    return np.random.default_rng(seed).normal(
        size=(rows, cout)).astype(np.float32)


def as_dtype(a, dtype):
    """a rounded to bf16 (kept as f32 numpy) for dtype 'bf16'."""
    if dtype == 'f32':
        return a
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def assert_f32_close(got, want):
    assert np.abs(want).max() > 0.1                 # non-trivial case
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


DW_MODES = [('same', 0), ('same', 2), ('down', 0), ('down', 1), ('up', 0),
            ('up', 1)]


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('mode,level', DW_MODES)
def test_dw_twin_matches_jax(mode, level, dtype):
    x, kin, kout, w, kw = case(mode, level, seed=level + 11)
    x = as_dtype(x, dtype)
    g = cotangent(kout.size, w.shape[2], seed=level)
    bases, counts, win = jax_plans(kin, kout, kw['kernel_size'], kw['scale'],
                                   stride_parent=kw.get('stride_parent',
                                                        False))
    want = np.asarray(JKC.key_conv_dw(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(kin),
        jnp.asarray(kout.reshape(-1, 1)), bases, counts, window=win,
        interpret=True, **kw))
    xt = torch.from_numpy(x)
    if dtype == 'bf16':
        xt = xt.to(torch.bfloat16)
    before = dict(KC.PLAIN_CALLS)
    got = KC.key_conv_dw(xt, torch.from_numpy(g), torch.from_numpy(kin),
                         torch.from_numpy(kout.reshape(-1)), **kw)
    assert KC.PLAIN_CALLS['dw'] == before['dw'] + 1
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_f32_close(got.numpy(), want)


@pytest.mark.parametrize('cout,layout', [(32, 'border'), (16, 'border'),
                                          (32, 'sent_tiles'), (16, 'zruns')])
def test_stem_dw_twin_matches_jax(cout, layout):
    """5^3 stem at cin 6: cout 32 (the main path's widths) and 16; a scene
    whose key row is mostly SENT (sent_tiles: 40 keys of 512); z-runs at
    the ends of every axis (zruns)."""
    x, kin, _, w, _ = case('stem', cin=6, cout=cout, seed=4, layout=layout)
    g = cotangent(x.shape[0], cout, seed=5)
    bases, counts, win = jax_plans(kin, kin, 5, 1, window=JKC.WINDOW_STEM)
    want = np.asarray(JKC.key_conv_stem_dw(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(kin), bases, counts,
        window=win, interpret=True))
    before = KC.PLAIN_CALLS['stem_dw']
    got = KC.key_conv_stem_dw(torch.from_numpy(x), torch.from_numpy(g),
                              torch.from_numpy(kin))
    assert KC.PLAIN_CALLS['stem_dw'] == before + 1
    assert got.shape == want.shape == (125, 6, cout)
    assert_f32_close(got.numpy(), want)


def test_dw_twin_ignores_padding_rows():
    """Output rows with a SENT key, or whose query matched nothing, add 0 to
    dw even where their cotangent is not finite."""
    x, kin, kout, w, kw = case('same', 0, seed=2)
    g = cotangent(kout.size, w.shape[2], seed=2)
    gt = torch.from_numpy(g.copy())
    want = KC.key_conv_dw(torch.from_numpy(x), gt, torch.from_numpy(kin),
                          torch.from_numpy(kout.reshape(-1)), **kw)
    gt[torch.from_numpy(kout.reshape(-1) >= KC.SENT_KEY)] = float('nan')
    got = KC.key_conv_dw(torch.from_numpy(x), gt, torch.from_numpy(kin),
                         torch.from_numpy(kout.reshape(-1)), **kw)
    assert torch.equal(got, want)


def test_mirror_weights_matches_jax():
    w = np.random.default_rng(0).normal(size=(27, 16, 32)).astype(np.float32)
    np.testing.assert_array_equal(
        KC.mirror_weights(torch.from_numpy(w)).numpy(),
        np.asarray(JKC._mirror_weights(jnp.asarray(w))))


def test_dw_wrappers_reject_other_devices():
    x, kin, kout, w, kw = case('same', seed=1)
    g = torch.zeros(kout.size, w.shape[2])
    with pytest.raises(ValueError):
        KC.key_conv_dw(torch.from_numpy(x).to('meta'), g,
                       torch.from_numpy(kin),
                       torch.from_numpy(kout.reshape(-1)), **kw)
    with pytest.raises(ValueError):
        KC.key_conv_stem_dw(torch.from_numpy(x).to('meta'), g,
                            torch.from_numpy(kin))
