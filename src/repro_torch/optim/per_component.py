"""Per-component learning rates, the paper's core optimization technique
(port of `repro.optim.per_component`).

MTSL's update (Alg. 1) is
    φ   ← φ   − η_s · g_φ          (server)
    ψ_m ← ψ_m − η_m · g_{ψ_m}      (client m)

a learning-rate *vector* η = (η_s, η_1, ..., η_M). Parameters are routed
to components by a path predicate; client towers carry a leading client
axis, so a per-client rate is a multiplier along that axis.

`per_component_lr(base, is_client)` gives the reference's rescaling
wrapper (`update`: base deltas × multipliers) and the port's fused,
in-place `apply_`, which is the mtsl round's apply step. `apply_` computes
the reference's `p + (u·c)·part` up to one rounding through K1
(`kernels.mtsl_update`), one launch per leaf, with one step size per row
of the leaf viewed as `[R, -1]`:

  * base SGD: the raw gradient with η = lr·c·part (the delta is never
    formed);
  * a stateful base (momentum, adamw): its delta u with η = −c·part.

Tower leaves take R = M rows (η_m per client, and participation part_m
in {0, 1} folds in exactly: a non-participant's tower stays bit-frozen);
server leaves take R = 1. The step sizes stay on the device.

lipschitz_lr is the paper's η_i <= 1/L_i rule for the linear + quadratic
case (Eqs. 9-10).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.kernels.mtsl_update.ops import mtsl_update_
from repro_torch.optim.optimizers import Optimizer
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map_with_path

PyTree = Any


class ComponentLR(NamedTuple):
    """LR multipliers per component.

    server: 0-d multiplier for the server (shared) params.
    clients: [M] multipliers for the client towers, applied along the
        leading client axis of the stacked tower params.
    """

    server: torch.Tensor
    clients: torch.Tensor

    def to(self, device) -> "ComponentLR":
        return ComponentLR(self.server.to(device), self.clients.to(device))


def uniform_component_lr(num_clients: int, server: float = 1.0,
                         client: float = 1.0) -> ComponentLR:
    return ComponentLR(
        server=torch.tensor(server, dtype=torch.float32),
        clients=torch.full((num_clients,), client, dtype=torch.float32),
    )


class ComponentOptimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    # (grads, state, params=None, step=0, component_lr=None) -> (deltas, state)
    update: Callable[..., tuple]
    # (params, grads, state, step=0, component_lr=None, participation=None)
    #   -> state; updates params in place
    apply_: Callable[..., Any]


def per_component_lr(base: Optimizer,
                     is_client: Callable[[str], bool]) -> ComponentOptimizer:
    """Wrap `base` with per-component multipliers (see module docstring)."""

    def init(params):
        return base.init(params)

    def update(grads, state, params=None, step=0,
               component_lr: Optional[ComponentLR] = None):
        upd, state = base.update(grads, state, params, step)
        if component_lr is None:
            return upd, state

        def _scale(path, u):
            if is_client(path):
                c = component_lr.clients
                return u * c.reshape((-1,) + (1,) * (u.ndim - 1)).to(u.dtype)
            return u * component_lr.server.to(u.dtype)

        return tree_map_with_path(_scale, upd), state

    @torch.no_grad()
    def apply_(params, grads, state, step=0,
               component_lr: Optional[ComponentLR] = None,
               participation: Optional[torch.Tensor] = None):
        if base.sgd_lr is not None:
            sign, deltas = base.sgd_lr(step), grads
        else:
            deltas, state = base.update(grads, state, params, step)
            sign = -1.0
        device = tree_leaves(params)[0].device

        def _eta(c, part):
            e = None if c is None else c.reshape(-1) * sign
            if part is not None:
                e = part * sign if e is None else e * part
            if e is None:
                e = torch.full((1,), sign, dtype=torch.float32, device=device)
            return e

        clr = component_lr
        eta_tower = _eta(None if clr is None else clr.clients, participation)
        eta_server = _eta(None if clr is None else clr.server, None)
        for (path, p), d in zip(tree_leaves_with_path(params), tree_leaves(deltas)):
            mtsl_update_(p, d, eta_tower if is_client(path) else eta_server)
        return state

    return ComponentOptimizer(init, update, apply_)


# ---------------------------------------------------------------------------
# Paper Eqs. (9)-(10): Lipschitz constants for the linear + quadratic case
# ---------------------------------------------------------------------------


def lipschitz_lr(w, bs, as_, second_moments, safety: float = 1.0) -> ComponentLR:
    """η_i = safety / L_i for the linear server G(s)=w·s+d, clients
    H_m(x)=b_m·x+a_m with quadratic loss.

        L_s = max(2M, 2 Σ_i (b_i² E[X_i²] + a_i²))      (Eq. 9)
        L_i = max(2w², 2w² E[X_i²])                      (Eq. 10)
    """
    f32 = torch.float32
    w, bs, as_, m2 = (torch.as_tensor(x, dtype=f32) for x in (w, bs, as_, second_moments))
    M = bs.shape[0]
    L_s = torch.clamp(2.0 * torch.sum(bs**2 * m2 + as_**2), min=2.0 * M)
    L_i = torch.maximum(2.0 * w**2, 2.0 * w**2 * m2)
    return ComponentLR(server=safety / L_s, clients=safety / L_i)
