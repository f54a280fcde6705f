"""Minimal functional optimizer library (port of `repro.optim.optimizers`).

An Optimizer is a pair (init, update):
    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

`update` returns *deltas* to be added to params (already scaled by -lr),
so the per-component learning rates (per_component.py) compose as a final
rescaling stage. Plain SGD also carries its learning-rate schedule
(`sgd_lr`): the fused apply of per_component.py then takes the raw
gradient and folds -lr into the kernel's step size instead of forming the
delta first.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.utils.tree import tree_map

PyTree = Any
Schedule = Callable[[int], float]


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]  # (grads, state, params, step) -> (updates, state)
    sgd_lr: Optional[Schedule] = None  # set for plain SGD only


def _sched(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: float(lr)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr: Union[float, Schedule]) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return ()

    def update(grads, state, params=None, step=0):
        s = lr_fn(step)
        return tree_map(lambda g: -s * g, grads), state

    return Optimizer(init, update, sgd_lr=lr_fn)


def momentum(lr: Union[float, Schedule], beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None, step=0):
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        upd = (tree_map(lambda m, g: g + beta * m, new_m, grads) if nesterov
               else new_m)
        s = lr_fn(step)
        return tree_map(lambda u: -s * u, upd), new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    mu: PyTree
    nu: PyTree


def adamw(
    lr: Union[float, Schedule],
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = _sched(lr)

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamState(mu=z, nu=tree_map(torch.clone, z))

    def update(grads, state, params=None, step=0):
        t = float(step) + 1.0
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                      state.nu, grads)
        c1, c2 = 1 - b1**t, 1 - b2**t
        s = lr_fn(step)

        def _upd(m, v, p):
            u = (m / c1) / ((v / c2).sqrt() + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            return -s * u

        upd = tree_map(_upd, mu, nu, params if params is not None else mu)
        return upd, AdamState(mu=mu, nu=nu)

    return Optimizer(init, update)
