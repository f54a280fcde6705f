"""Split-parameter layout (port of `repro.core.split`):

    params = {"towers": <leading client axis [M, ...]>, "server": ...}

`stack_towers` draws one tower init per client and stacks them leafwise;
`replicate_tower` copies ONE init to every client (the federated
baselines' shared start). Serving reads client m's tower as the view
`towers[..][m]` of each leaf, never as a copy. `client_freeze_lr` is the
paper's add-a-new-client protocol as a ComponentLR.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.utils.tree import tree_map

PyTree = Any


def stack_towers(init_tower: Callable, gen: torch.Generator,
                 num_clients: int) -> PyTree:
    """[M, ...]-stacked tower params, one independent draw per client."""
    towers = [init_tower(gen) for _ in range(num_clients)]
    return tree_map(lambda *xs: torch.stack(xs), towers[0], *towers[1:])


def replicate_tower(init_tower: Callable, gen: torch.Generator,
                    num_clients: int) -> PyTree:
    """[M, ...] copies of one init (FedAvg / SplitFed: a shared start)."""
    return tree_map(
        lambda x: x[None].expand((num_clients,) + tuple(x.shape)).contiguous(),
        init_tower(gen))


def client_view(towers: PyTree, m: int) -> PyTree:
    """Client m's tower: a view into each stacked leaf (no copy)."""
    return tree_map(lambda x: x[m], towers)


def is_client_path(path: str) -> bool:
    """True for a leaf of the client towers (paths from
    `utils.tree.tree_map_with_path`)."""
    return path.startswith("towers")


def client_freeze_lr(num_clients: int, active_client: int):
    """A ComponentLR that freezes everything but one client's tower: the
    paper's add-a-new-client protocol (§4.2, Table 3: only the new client's
    model trains while the others stay frozen)."""
    from repro_torch.optim.per_component import ComponentLR

    clients = torch.zeros((num_clients,), dtype=torch.float32)
    clients[active_client] = 1.0
    return ComponentLR(server=torch.zeros((), dtype=torch.float32),
                       clients=clients)
