"""The port's four differentiable key convs against jax.grad of the JAX
package's custom-VJP wrappers (key_conv_train, key_conv_down_plan_train,
key_conv_up_train, key_conv_stem_train; the Pallas kernels in interpret
mode, as the JAX tests run them on the CPU).

loss = sum(out * c) for a fixed cotangent c; dx and dw of both sides follow
the same composition (forward conv of the cotangent for dx, the dw kernel on
bf16 x for dw), so they differ only in the order of f32 sums. Tolerances:
f32 results 1e-5 of their max |value|; a bf16 dx (bf16 input) one bf16
rounding step per element plus that bound.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu.sparse import key_conv as JKC
from box2mask_torch.sparse import key_conv as KC
from test_torch_kernels_cuda import assert_close, case
from test_torch_train_kernels import assert_f32_close, cotangent, jax_plans

JDT = {'f32': jnp.float32, 'bf16': jnp.bfloat16}
TDT = {'f32': torch.float32, 'bf16': torch.bfloat16}


def jax_grads(fn, x, w, c, dtype):
    def loss(x, w):
        return jnp.sum(fn(x, w).astype(jnp.float32) * c)
    dx, dw = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x, JDT[dtype]), jnp.asarray(w))
    return np.asarray(dx.astype(jnp.float32)), np.asarray(dw), dx.dtype


def torch_grads(fn, x, w, c, dtype):
    xt = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (fn(xt, wt).float() * torch.from_numpy(c)).sum().backward()
    return xt.grad, wt.grad


def check(jg, tg, dtype):
    jdx, jdw, jdx_dtype = jg
    tdx, tdw = tg
    assert tdx.dtype == TDT[dtype] and str(jdx_dtype) == {
        'f32': 'float32', 'bf16': 'bfloat16'}[dtype]
    assert tdw.dtype == torch.float32
    assert_close(tdx.float().numpy(), jdx, dtype)
    assert_f32_close(tdw.numpy(), jdw)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
@pytest.mark.parametrize('level', [0, 2])
def test_same_level_grads_match_jax(level, dtype):
    x, kin, kout, w, kw = case('same', level, seed=level + 21)
    c = cotangent(kout.size, w.shape[2], seed=level + 1)
    bases, counts, win = jax_plans(kin, kout, 3, kw['scale'])
    jg = jax_grads(lambda x, w: JKC.key_conv_train(
        x, jnp.asarray(kin), jnp.asarray(kout.reshape(-1, 1)), bases, counts,
        w, 3, kw['scale'], True, win), x, w, c, dtype)
    tg = torch_grads(lambda x, w: KC.key_conv_train(
        x, torch.from_numpy(kin), torch.from_numpy(kout.reshape(-1)), w,
        kernel_size=3, scale=kw['scale']), x, w, c, dtype)
    check(jg, tg, dtype)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_down_grads_match_jax(dtype):
    level = 1
    x, fine, coarse, w, kw = case('down', level, seed=31)
    c = cotangent(coarse.size, w.shape[2], seed=3)
    bases, counts, win = jax_plans(fine, coarse, 2, kw['scale'])
    bases_u, counts_u, _ = jax_plans(coarse, fine, 2, kw['scale'],
                                     stride_parent=True,
                                     window=JKC.WINDOW_UP)
    jg = jax_grads(lambda x, w: JKC.key_conv_down_plan_train(
        x, jnp.asarray(fine), jnp.asarray(coarse.reshape(-1, 1)), bases,
        counts, bases_u, counts_u, w, kw['scale'], win), x, w, c, dtype)
    tg = torch_grads(lambda x, w: KC.key_conv_down_train(
        x, torch.from_numpy(fine), torch.from_numpy(coarse.reshape(-1)), w,
        scale=kw['scale']), x, w, c, dtype)
    check(jg, tg, dtype)


@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_up_grads_match_jax(dtype):
    level = 0
    x, coarse, fine, w, kw = case('up', level, seed=41)
    c = cotangent(fine.size, w.shape[2], seed=4)
    bases_u, counts_u, win_u = jax_plans(coarse, fine, 2, kw['scale'],
                                         stride_parent=True,
                                         window=JKC.WINDOW_UP)
    bases_d, counts_d, _ = jax_plans(fine, coarse, 2, kw['scale'])
    jg = jax_grads(lambda x, w: JKC.key_conv_up_train(
        x, jnp.asarray(coarse), jnp.asarray(fine.reshape(-1, 1)), bases_u,
        counts_u, jnp.asarray(fine), jnp.asarray(coarse.reshape(-1, 1)),
        bases_d, counts_d, w, kw['scale'], win_u), x, w, c, dtype)
    tg = torch_grads(lambda x, w: KC.key_conv_up_train(
        x, torch.from_numpy(coarse), torch.from_numpy(fine.reshape(-1)), w,
        scale=kw['scale']), x, w, c, dtype)
    check(jg, tg, dtype)


def test_stem_grads_match_jax():
    """The stem's dx is zeros on both sides (its input is data); dw from the
    stem dw kernel."""
    x, kin, _, w, _ = case('stem', cin=6, cout=32, seed=51)
    c = cotangent(x.shape[0], 32, seed=6)
    bases, counts, win = jax_plans(kin, kin, 5, 1, window=JKC.WINDOW_STEM)
    jdx, jdw, _ = jax_grads(lambda x, w: JKC.key_conv_stem_train(
        x, jnp.asarray(kin), bases, counts, w, win), x, w, c, 'f32')
    tdx, tdw = torch_grads(lambda x, w: KC.key_conv_stem_train(
        x, torch.from_numpy(kin), w), x, w, c, 'f32')
    assert not jdx.any() and not tdx.any() and tdx.dtype == torch.float32
    assert_f32_close(tdw.numpy(), jdw)


def test_backward_counts_and_no_grad_saves_nothing():
    """One backward of the same-level conv runs one dx conv and one dw;
    under no_grad the forward keeps no bf16 copy of x."""
    x, kin, kout, w, kw = case('same', 0, seed=7)
    args = (torch.from_numpy(kin), torch.from_numpy(kout.reshape(-1)))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    before = dict(KC.PLAIN_CALLS)
    KC.key_conv_train(xt, *args, wt, kernel_size=3).sum().backward()
    assert KC.PLAIN_CALLS['same'] == before['same'] + 2
    assert KC.PLAIN_CALLS['dw'] == before['dw'] + 1
    with torch.no_grad():
        out = KC.key_conv_train(xt, *args, wt, kernel_size=3)
    assert out.grad_fn is None
