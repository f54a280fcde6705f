"""Split-parameter layout (port of `repro.core.split.stack_towers`):

    params = {"towers": <leading client axis [M, ...]>, "server": ...}

One tower init per client, stacked leafwise. Serving reads client m's tower
as the view `towers[..][m]` of each leaf, never as a copy.
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


def client_view(towers: PyTree, m: int) -> PyTree:
    """Client m's tower: a view into each stacked leaf (no copy)."""
    return tree_map(lambda x: x[m], towers)


def is_client_path(path: str) -> bool:
    """True for a leaf of the client towers (paths from
    `utils.tree.tree_map_with_path`)."""
    return path.startswith("towers")
