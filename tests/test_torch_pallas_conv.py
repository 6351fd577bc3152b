"""The port's neighbor-map conv and row gather (sparse/pallas_conv.py) and
the neighbor-map branches of sparse/ops.py against the JAX package's.

The twins are held to the Pallas kernels run as the JAX package's own tests
run them on the CPU (interpret mode): sparse_conv_plain to
pallas_conv._pallas_forward within 1e-5 of max |out| (both multiply the same
bf16-rounded operands and sum in f32, in another order), padding rows
exactly 0; gather_rows_plain to pallas_conv.gather_rows bit for bit (a row
pick and one f32 -> bf16 rounding). The XLA formulations that the ops take
without use_pallas are held to ops.gather_conv / ops.up_conv at
compute_dtype f32 and bf16, within the same bound. Maps come from the host
pyramid (sparse/coords.py), <= 512 rows, so interpret mode stays cheap.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from box2mask_tpu.sparse import coords as JCo
from box2mask_tpu.sparse import ops as jops
from box2mask_tpu.sparse import pallas_conv as JPC
from box2mask_torch.sparse import ops
from box2mask_torch.sparse import pallas_conv as PC

DTYPES = {'f32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}
# xdist workers running torch side by side at one thread per core slow
# each other down (OpenMP spin-waits; tests/test_torch_train_common.py)
torch.set_num_threads(min(2, torch.get_num_threads()))


def make_case(seed=0, n=600):
    """One scene's host batch pyramid: level 0 pads to 512 rows, level 1 to
    256, both multiples of pallas_conv.TILE."""
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(0, 12, size=(n, 3)), axis=0)
    b = JCo.batch_pyramids([JCo.build_scene_pyramid(coords)], vox_bucket=256)
    return b, rng


def conv_inputs(kind, xdtype, seed=0):
    """(x numpy f32 or bf16-valued f32, nbr, w, number of valid out rows)
    for the stem (K = 125, cin 6), the 3^3 conv (27) or the down conv (8)."""
    b, rng = make_case(seed)
    nbr, rows, cin, cout = {
        'stem': ('nmap5_0', 'num0', 6, 32),
        'same3': ('nmap3_0', 'num0', 32, 48),
        'down': ('down0', 'num1', 32, 32)}[kind]
    V = b['coords0'].shape[0]
    x = rng.normal(size=(V, cin)).astype(np.float32)
    x[~b['valid0']] = 0
    if xdtype == 'bf16':
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    K = b[nbr].shape[1]
    w = (rng.normal(size=(K, cin, cout)) * 0.2).astype(np.float32)
    return x, b[nbr], w, int(b[rows])


def to_torch(x, dtype):
    return torch.from_numpy(x).to(DTYPES[dtype][1])


@pytest.mark.parametrize('xdtype', ['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['same3', 'down', 'stem'])
def test_sparse_conv_plain_matches_pallas(kind, xdtype):
    x, nbr, w, n = conv_inputs(kind, xdtype)
    jx = jnp.asarray(x, DTYPES[xdtype][0])
    want = np.asarray(JPC._pallas_forward(jx, jnp.asarray(nbr),
                                          jnp.asarray(w), interpret=True))
    got = PC.sparse_conv_plain(to_torch(x, xdtype), torch.from_numpy(nbr),
                               torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    scale = np.abs(want).max()
    assert scale > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert not got[n:].any() and not want[n:].any()    # padding rows


@pytest.mark.parametrize('cout', [16, 96])
def test_gather_rows_plain_matches_pallas(cout):
    """The up conv's pick: y (U*8, cout) f32, idx = parent * 8 + widx (the
    zero row U*8 for a padding row), monotone."""
    b, rng = make_case(seed=2)
    U = b['coords1'].shape[0]
    y = rng.normal(size=(U * 8, cout)).astype(np.float32)
    parent, widx = b['up_parent0'], b['up_widx0']
    idx = np.where(parent >= U, U * 8, parent * 8 + widx).astype(np.int32)
    want = np.asarray(JPC.gather_rows(jnp.asarray(y), jnp.asarray(idx),
                                      interpret=True))
    got = PC.gather_rows_plain(torch.from_numpy(y), torch.from_numpy(idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[int(b['num0']):].any()


@pytest.mark.parametrize('cd', ['f32', 'bf16'])
@pytest.mark.parametrize('kind', ['same3', 'stem'])
def test_gather_conv_xla_route_matches_jax(kind, cd):
    """Without use_pallas: operands in compute_dtype, per-offset gather and
    f32 matmul summed in offset order (the JAX scan for K > 9)."""
    x, nbr, w, _ = conv_inputs(kind, 'f32', seed=3)
    want = np.asarray(jops.gather_conv(
        jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(w),
        compute_dtype=DTYPES[cd][0], use_pallas=False))
    got = ops.gather_conv(torch.from_numpy(x), torch.from_numpy(nbr),
                          torch.from_numpy(w), DTYPES[cd][1], False).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('use_pallas', [False, True])
@pytest.mark.parametrize('cd', ['f32', 'bf16'])
def test_up_conv_matches_jax(cd, use_pallas):
    """The transpose conv over (parent, widx): y from one product with the
    8 weight slots, then the row pick (the bf16-rounding gather under
    use_pallas, the JAX side in interpret mode)."""
    b, rng = make_case(seed=4)
    U = b['coords1'].shape[0]
    x = rng.normal(size=(U, 32)).astype(np.float32)
    x[~b['valid1']] = 0
    w = (rng.normal(size=(8, 32, 48)) * 0.2).astype(np.float32)
    parent, widx = b['up_parent0'], b['up_widx0']
    if use_pallas:
        y = jnp.einsum('uc,kcd->ukd', jnp.asarray(x, DTYPES[cd][0]),
                       jnp.asarray(w, DTYPES[cd][0]),
                       preferred_element_type=jnp.float32).reshape(U * 8, 48)
        idx = jnp.where(parent >= U, U * 8, parent * 8 + widx)
        want = np.asarray(JPC.gather_rows(y, idx, interpret=True))
    else:
        want = np.asarray(jops.up_conv(
            jnp.asarray(x), jnp.asarray(parent), jnp.asarray(widx),
            jnp.asarray(w), compute_dtype=DTYPES[cd][0], use_pallas=False))
    PC.reset_counts()
    ops.reset_counts()
    got = ops.up_conv(torch.from_numpy(x), (torch.from_numpy(parent),
                                            torch.from_numpy(widx)),
                      torch.from_numpy(w), DTYPES[cd][1], use_pallas).numpy()
    assert PC.PLAIN_CALLS['gather_rows'] == int(use_pallas)
    assert ops.XLA_CALLS == {'gather_conv': 0, 'up_conv': int(not use_pallas)}
    if use_pallas:
        # both sides round y once to bf16; y's f32 sums differ in order only
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp + 1e-5 * np.abs(want).max()).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_dispatch_follows_use_pallas_and_tile():
    """use_pallas takes the kernel wrapper only when the output rows are a
    multiple of TILE (JAX ops.py:118-121); the wrapper runs its twin on the
    CPU and counts it. Every other call takes the XLA formulation, which
    counts its own calls."""
    x, nbr, w, _ = conv_inputs('same3', 'f32', seed=5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    PC.reset_counts()
    ops.reset_counts()
    a = ops.gather_conv(xt, torch.from_numpy(nbr), wt, use_pallas=True)
    ops.gather_conv(xt, torch.from_numpy(nbr[:300]), wt, use_pallas=True)
    ops.gather_conv(xt, torch.from_numpy(nbr), wt, use_pallas=False)
    assert PC.PLAIN_CALLS == {'sparse_conv': 1, 'gather_rows': 0}
    assert PC.LAUNCHES == {'sparse_conv': 0, 'gather_rows': 0}
    assert ops.XLA_CALLS == {'gather_conv': 2, 'up_conv': 0}
    assert torch.equal(a, PC.sparse_conv_plain(xt, torch.from_numpy(nbr), wt))


def test_unknown_device_raises():
    """A tensor neither on the CPU nor on a card is refused, never run on
    the twin."""
    x, nbr, w, _ = conv_inputs('down', 'f32')
    with pytest.raises(ValueError):
        PC.sparse_conv(torch.from_numpy(x).to('meta'), torch.from_numpy(nbr),
                       torch.from_numpy(w))
    with pytest.raises(ValueError):
        PC.gather_rows(torch.from_numpy(x).to('meta'),
                       torch.from_numpy(nbr[:, 0].copy()))
