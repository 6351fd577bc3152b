"""One train step, and a 5-step trajectory, of the port against the JAX
package's, from equal parameters on an equal batch, with the bf16 rounding
taken out of both sides: --compute_dtype float32 and f32 activations on
both, and on the port's side the plain twins on unrounded operands in place
of every conv and dw kernel and x kept unrounded for the backward
(test_torch_train_common.py builds both runs).

What bounds the comparison. At random init this small network is badly
conditioned: a relative change of 1e-7 in the input features moves the
port's own grads by up to ~1.7e-2 of a tensor's largest grad (measured), so
the two packages' different f32 summation orders move them as much. The
bounds are therefore set from that floor, measured in the test itself:
  * loss dict and BN running statistics after the step: 1e-5 relative
    (measured 3.5e-7 and 1.1e-6),
  * grads: per tensor within 3x the port's own response to the 1e-7 input
    change plus 1e-5 of the tensor's max |grad|; over all tensors (L2)
    within 1e-2 (measured 1.5e-3),
  * params after the step: Adam's first update is -lr * sign(grad), so an
    element moves 2 lr where a grad near zero has its sign flipped: at most
    1% of the elements (measured 0.10%), none by more than 2 lr,
  * the 5-step trajectory (learning rates 1e-3 .. 2e-4): optimization_loss
    within 5% of JAX's at every step (measured <= 2%: Adam's sign-like
    steps let the small differences above grow), falling on both sides.
"""

import numpy as np
import pytest

from test_torch_train_common import (LOSS_KEYS, LRS, jax_run, l2_rel,
                                     moved_share, port_run, rel_err)

UNROUNDED = ['--compute_dtype', 'float32']


@pytest.fixture(scope='module')
def runs():
    init, jout = jax_run(UNROUNDED, 5)
    with pytest.MonkeyPatch.context() as mp:
        pout = port_run(UNROUNDED, init, 5, unrounded=True, monkeypatch=mp)
        noisy = port_run(UNROUNDED, init, 1, unrounded=True, monkeypatch=mp,
                         feature_noise=1e-7)
    return jout, pout, noisy


def test_one_step_unrounded_matches_jax(runs):
    jout, pout, noisy = runs
    (jl, jg, jp, js), (pl, pg, pp, ps) = jout[0], pout[0]
    assert set(pl) == set(jl)
    for k in LOSS_KEYS:
        assert abs(pl[k] - jl[k]) <= 1e-5 * abs(jl[k]), (k, pl[k], jl[k])
    assert max(rel_err(ps, js).values()) <= 1e-5
    floor = rel_err(noisy[0][1], pg)
    err = rel_err(pg, jg)
    bad = {k: (err[k], floor[k]) for k in jg if err[k] > 3 * floor[k] + 1e-5}
    assert bad == {}
    assert l2_rel(pg, jg) <= 1e-2
    assert moved_share(pp, jp) <= 1e-2
    assert max(float(np.abs(pp[k] - jp[k]).max()) for k in jp) <= (
        2 * LRS[0] + 1e-6)


def test_trajectory_unrounded_tracks_jax(runs):
    jout, pout, _ = runs
    jl = [s[0]['optimization_loss'] for s in jout]
    pl = [s[0]['optimization_loss'] for s in pout]
    assert np.isfinite(pl).all()
    for a, b in zip(pl, jl):
        assert abs(a - b) <= 5e-2 * abs(b), (pl, jl)
    assert pl[-1] < 0.6 * pl[0] and jl[-1] < 0.6 * jl[0]
