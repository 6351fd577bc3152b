"""The optimizers of the JAX package with optax's update rules (optax 0.2,
`optax.inject_hyperparams(optax.<name>)(learning_rate=lr)` at optax's
defaults, box2mask_tpu/engine/state.py:73-85), over a module's parameters.

torch.optim's versions differ from optax's where it matters: RMSprop's
alpha defaults to 0.99 with eps outside the square root (optax: decay 0.9,
eps inside), Adadelta's rho to 0.9 with eps 1e-6 and lr 1.0 (optax: the
lr is passed). So the updates are written out, each in optax's order of
operations:

  adam      mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu;  t += 1
            u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
            b1 0.9, b2 0.999, eps 1e-8
  rmsprop   nu = (1-d) g^2 + d nu;  u = rsqrt(nu + eps) g    d 0.9, eps 1e-8
  adadelta  eg = (1-r) g^2 + r eg;  u = sqrt(ex + eps) / sqrt(eg + eps) g
            ex = (1-r) u^2 + r ex                            r 0.9, eps 1e-6

and p <- p + (-lr) u, the learning rate given per step. inject_hyperparams
holds every numeric hyperparameter as an f32 array, so 1 - b1 and the like
are computed in f32 here too. The moments are updated in place, and so are
the parameters, all tensors at once (torch._foreach_* ops: a few
multi-tensor kernels per operation instead of one kernel per tensor).
"""

from __future__ import annotations

import torch

SLOTS = {'adam': ('mu', 'nu'), 'rmsprop': ('nu',), 'adadelta': ('e_g', 'e_x')}
# optax's defaults: decay rates and eps
HYPER = {'adam': (0.9, 0.999, 1e-8), 'rmsprop': (0.9, 1e-8),
         'adadelta': (0.9, 1e-6)}


def _f32(v):
    """v rounded to f32, as a Python float."""
    return torch.tensor(v, dtype=torch.float32).item()


def _ema_(m, v, decay):
    """m <- (1 - decay) * v + decay * m over lists of tensors, m in place."""
    a = torch._foreach_mul(v, _f32(1 - decay))
    torch._foreach_mul_(m, decay)
    torch._foreach_add_(m, a)


class Optimizer:
    """`init(params)` -> state; `update(params, state, lr)` applies one step
    from the parameters' .grad (a missing grad counts as zeros), in place."""

    def __init__(self, name):
        self.name = name.lower()
        if self.name not in SLOTS:
            raise ValueError(f'unknown optimizer {name}')

    def init(self, params):
        return {'count': 0, **{s: [torch.zeros_like(p) for p in params]
                               for s in SLOTS[self.name]}}

    @torch.no_grad()
    def update(self, params, state, lr):
        state['count'] += 1
        t = state['count']
        f32 = torch.float32
        if self.name == 'adam':
            b1, b2, eps = (torch.tensor(v, dtype=f32)
                           for v in HYPER['adam'])
            c1, c2 = (1 - b1 ** t).item(), (1 - b2 ** t).item()
            b1, b2, eps = b1.item(), b2.item(), eps.item()
        else:
            d, eps = (_f32(v) for v in HYPER[self.name])
        g = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
        g2 = torch._foreach_mul(g, g)
        if self.name == 'adam':
            mu, nu = state['mu'], state['nu']
            _ema_(mu, g, b1)
            _ema_(nu, g2, b2)
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(mu, c1)
            torch._foreach_div_(u, den)
        elif self.name == 'rmsprop':
            _ema_(state['nu'], g2, d)
            u = torch._foreach_add(state['nu'], eps)
            torch._foreach_rsqrt_(u)
            torch._foreach_mul_(u, g)
        else:
            e_g, e_x = state['e_g'], state['e_x']
            _ema_(e_g, g2, d)
            u = torch._foreach_add(e_x, eps)
            torch._foreach_sqrt_(u)
            den = torch._foreach_add(e_g, eps)
            torch._foreach_sqrt_(den)
            torch._foreach_div_(u, den)
            torch._foreach_mul_(u, g)
            _ema_(e_x, torch._foreach_mul(u, u), d)
        torch._foreach_mul_(u, -_f32(lr))
        torch._foreach_add_(params, u)

    def state_dict(self, state):
        """numpy copy of `state` for a checkpoint."""
        return {'count': state['count'],
                **{s: [v.detach().cpu().numpy() for v in state[s]]
                   for s in SLOTS[self.name]}}

    def load_state_dict(self, state, saved):
        """Copy a state_dict() payload into `state` (same parameters)."""
        for s in SLOTS[self.name]:
            if len(saved[s]) != len(state[s]):
                raise ValueError(f'optimizer slot {s}: {len(saved[s])} '
                                 f'tensors saved, {len(state[s])} expected')
            for dst, src in zip(state[s], saved[s]):
                dst.copy_(torch.as_tensor(src))
        state['count'] = int(saved['count'])
        return state
