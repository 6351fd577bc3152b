"""One train step, and a 5-step trajectory, of the port against the JAX
package's under the preset's rounding (--bf16_acts, bf16 conv and linear
operands), from equal parameters on an equal batch
(test_torch_train_common.py builds both runs).

The JAX side runs its neighbor-map path, whose backward rounds differently
from the key_conv custom VJPs the port copies: every conv's dx comes out of
a bf16 transpose there and every dw is rounded to bf16, where the key_conv
VJP keeps dw in f32. With the rounding taken out the two agree to the
network's conditioning floor (test_torch_train_step.py); with it in, each
bf16 rounding (relative 2^-9) enters that conditioning. Bounds, set from
those measurements (measured values in brackets):
  * the loss terms: 1.5e-2 relative (optimization_loss 1.0e-4, the terms
    1.0e-3 .. 5.3e-3); logging signals 5e-2 of max(|value|, 1) (1.2e-2),
  * BN running statistics after the step: 5e-2 of each tensor's max (8e-3),
  * grads over all tensors (L2): 0.5 (0.28), and cosine similarity >= 0.9,
  * params after the step: at most 25% of the elements differ, by Adam's
    sign flips of 2 lr (11%),
  * the 5-step trajectory: optimization_loss within 15% of JAX's at every
    step (<= 9%), falling on both sides.
"""

import numpy as np
import pytest

from test_torch_train_common import (LOSS_KEYS, LRS, jax_run, l2_rel,
                                     moved_share, port_run, rel_err)

ROUNDED = ['--bf16_acts']


@pytest.fixture(scope='module')
def runs():
    init, jout = jax_run(ROUNDED, 5)
    return jout, port_run(ROUNDED, init, 5)


def cosine(a, b):
    dot = sum(float((a[k].astype(np.float64) * b[k]).sum()) for k in b)
    na = sum(float((a[k].astype(np.float64) ** 2).sum()) for k in b)
    nb = sum(float((b[k].astype(np.float64) ** 2).sum()) for k in b)
    return dot / (na * nb) ** 0.5


def test_one_step_rounded_matches_jax(runs):
    jout, pout = runs
    (jl, jg, jp, js), (pl, pg, pp, ps) = jout[0], pout[0]
    assert set(pl) == set(jl)
    for k in jl:
        tol = 1.5e-2 if k in LOSS_KEYS else 5e-2
        assert abs(pl[k] - jl[k]) <= tol * max(abs(jl[k]), 1.0), k
    assert max(rel_err(ps, js).values()) <= 5e-2
    assert l2_rel(pg, jg) <= 0.5 and cosine(pg, jg) >= 0.9
    assert moved_share(pp, jp) <= 0.25
    assert max(float(np.abs(pp[k] - jp[k]).max()) for k in jp) <= (
        2 * LRS[0] + 1e-6)


def test_trajectory_rounded_tracks_jax(runs):
    jout, pout = runs
    jl = [s[0]['optimization_loss'] for s in jout]
    pl = [s[0]['optimization_loss'] for s in pout]
    assert np.isfinite(pl).all()
    for a, b in zip(pl, jl):
        assert abs(a - b) <= 0.15 * abs(b), (pl, jl)
    assert pl[-1] < 0.6 * pl[0] and jl[-1] < 0.6 * jl[0]
