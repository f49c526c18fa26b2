"""The optimizer menu beside RMSprop (``tpu_unet/optim/optimizers.py``):
SGD (the legacy reference's ``SGD(momentum=0.9)``), Adam and AdamW, with
``torch.optim``'s update rules, as plain functions over the params dict.

Every optimizer keeps the RMSprop contract: the state is a NamedTuple whose
leading fields are fp32 trees shaped like the params (Adam's trailing
``step`` is a scalar int32 tensor), ``update(grads, state, params, lr) ->
(new_params, new_state)`` with the learning rate an argument, the math in
fp32 whatever the params' dtype, nothing updated in place. The field names
are the JAX NamedTuples', so an ``opt/...`` checkpoint keypath names the
same array in both packages.

    SGD (dampening 0):        Adam:                       AdamW:
      g += wd·p                 g += wd·p                   p *= 1 − lr·wd
      buf = μ·buf + g           t += 1                      (then Adam, wd = 0)
      d = g + μ·buf (nesterov)  m = β1·m + (1−β1)·g
          | buf                 v = β2·v + (1−β2)·g²
      p −= lr·d                 p −= lr/(1−β1^t) · m / (sqrt(v)/sqrt(1−β2^t) + ε)

SGD's buffer starts at zeros: μ·0 + g is torch's first-step ``buf = g``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch

from tpu_unet_torch.models.unet import tree_leaves, tree_map
from tpu_unet_torch.optim.rmsprop import pick, rmsprop_init, rmsprop_update


class SGDState(NamedTuple):
    momentum_buf: Any  # tree like params


class AdamState(NamedTuple):
    exp_avg: Any  # tree like params
    exp_avg_sq: Any  # tree like params
    step: Any  # scalar int32 tensor, the bias-correction counter


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def sgd_init(params: Any) -> SGDState:
    return SGDState(momentum_buf=_zeros_f32(params))


def sgd_update(grads: Any, state: SGDState, params: Any, lr, *, momentum: float = 0.9,
               weight_decay: float = 0.0, nesterov: bool = False) -> tuple[Any, SGDState]:
    def leaf(p, g, buf):
        g = g.float()
        pf = p.float()
        if weight_decay != 0:
            g = g + weight_decay * pf
        buf = momentum * buf + g
        d = g + momentum * buf if nesterov else buf
        return (pf - lr * d).to(p.dtype), buf

    new = tree_map(leaf, params, grads, state.momentum_buf)
    return pick(new, 0), SGDState(pick(new, 1))


def adam_init(params: Any) -> AdamState:
    device = tree_leaves(params)[0].device
    return AdamState(_zeros_f32(params), _zeros_f32(params),
                     torch.zeros((), dtype=torch.int32, device=device))


def adam_update(grads: Any, state: AdamState, params: Any, lr, *,
                betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                weight_decay: float = 0.0, decoupled: bool = False) -> tuple[Any, AdamState]:
    """torch.optim.Adam (``decoupled=False``) / AdamW (``decoupled=True``)."""
    b1, b2 = betas
    t = state.step + 1
    tf = t.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=tf.device), tf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=tf.device), tf)
    step_size = lr / bc1
    sqrt_bc2 = torch.sqrt(bc2)

    def leaf(p, g, m, v):
        g = g.float()
        pf = p.float()
        if weight_decay != 0:
            if decoupled:
                pf = pf * (1.0 - lr * weight_decay)
            else:
                g = g + weight_decay * pf
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * (g * g)
        denom = torch.sqrt(v) / sqrt_bc2 + eps
        return (pf - step_size * m / denom).to(p.dtype), m, v

    new = tree_map(leaf, params, grads, state.exp_avg, state.exp_avg_sq)
    return pick(new, 0), AdamState(pick(new, 1), pick(new, 2), t)


OPTIMIZERS = ("rmsprop", "sgd", "adam", "adamw")


def get_optimizer(name: str, *, weight_decay: float = 1e-8, momentum: float | None = None,
                  nesterov: bool = False) -> tuple[Callable[[Any], Any], Callable[..., Any]]:
    """``(init_fn, update_fn)`` for an optimizer name. ``momentum`` None takes
    the optimizer's default (0.999 for RMSprop, the reference's; 0.9 for
    SGD); Adam/AdamW ignore it. ``nesterov`` is an SGD option."""
    if nesterov and name != "sgd":
        raise ValueError("nesterov momentum is an SGD option")
    if name == "rmsprop":
        mom = 0.999 if momentum is None else momentum
        return rmsprop_init, functools.partial(rmsprop_update, weight_decay=weight_decay,
                                               momentum=mom)
    if name == "sgd":
        mom = 0.9 if momentum is None else momentum
        return sgd_init, functools.partial(sgd_update, weight_decay=weight_decay, momentum=mom,
                                           nesterov=nesterov)
    if name == "adam":
        return adam_init, functools.partial(adam_update, weight_decay=weight_decay)
    if name == "adamw":
        return adam_init, functools.partial(adam_update, weight_decay=weight_decay,
                                            decoupled=True)
    raise ValueError(f"unknown optimizer {name!r} (choose from {OPTIMIZERS})")
