"""Named per-component learning-rate policies (port of
`repro.core.lr_policy`, paper §3).

The paper's theory says: pick eta_i <= 1/L_i per component. Eq. 9 couples
the server constant to the *sum over clients*' second moments (so eta_s
should shrink like 1/M), while Eq. 10 ties each client's constant to its own
data moment (noisier clients -> smaller LR). These policies encode that.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.optim.per_component import (
    ComponentLR,
    lipschitz_lr,
    uniform_component_lr,
)


def uniform(num_clients: int, scale: float = 1.0) -> ComponentLR:
    """Common LR multiplier everywhere (paper Fig. 2b)."""
    return uniform_component_lr(num_clients, server=scale, client=scale)


def server_scaled(num_clients: int, server_scale: Optional[float] = None,
                  client_scale: float = 1.0) -> ComponentLR:
    """Shrink the server LR ~1/M per Eq. 9's L_s = O(M) (paper Fig. 2c)."""
    if server_scale is None:
        server_scale = 1.0 / num_clients
    return uniform_component_lr(num_clients, server=server_scale,
                                client=client_scale)


def moment_scaled(second_moments, server_scale: float = 1.0) -> ComponentLR:
    """Client LR ∝ 1/E[X_m²] per Eq. 10 (paper Fig. 2d/e: the client with the
    10x second moment gets a 10x tighter LR range)."""
    m = torch.as_tensor(second_moments, dtype=torch.float32)
    return ComponentLR(server=torch.tensor(server_scale, dtype=torch.float32),
                       clients=torch.clamp(1.0 / m, max=1.0))


def linear_lipschitz(w, bs, as_, second_moments, safety: float = 1.0) -> ComponentLR:
    """Exact 1/L for the paper's linear + quadratic case (Eqs. 9-10)."""
    return lipschitz_lr(w, bs, as_, second_moments, safety=safety)
