"""Mesh definitions (port of `repro.launch.mesh`, over torch.distributed).

Axes:
  "data"  — data parallelism == the MTSL client axis
  "model" — the tensor axis (the round has no tensor parallelism: ranks
            that differ only here compute the same round)
  "pod"   — the outer data axis; composes with "data" for clients

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
an initialised process group, one rank per mesh position, its dims named
in the canonical ("pod", "data", "model") order. The launcher starts the
ranks (`launch/train.py --mesh`); `make_mesh_from_spec` lays them out and
builds the client groups (utils/sharding.py) once, collectively.

The reference's TPU constants and its production meshes are not carried
over: they describe the TPU, not this card.
"""
from __future__ import annotations

import torch

from repro_torch.utils.sharding import mesh_axis_sizes, mesh_group

# canonical axis order for user-specified meshes (client axes outermost,
# matching utils/sharding.DEFAULT_RULES["client"])
_AXIS_ORDER = ("pod", "data", "model")


def num_clients_for(mesh) -> int:
    """MTSL clients = pod * data extent."""
    sizes = mesh_axis_sizes(mesh)
    return max(sizes.get("data", 1) * sizes.get("pod", 1), 1)


def parse_mesh_spec(spec: str) -> dict:
    """Parse a launcher mesh spec "data=N[,model=K[,pod=P]]" into an
    axis->size dict. Axis names must come from ("pod","data","model");
    sizes must be positive ints; repeats are rejected. "" -> {} (no mesh).
    """
    out: dict = {}
    spec = spec.strip()
    if not spec:
        return out
    for part in spec.split(","):
        name, eq, val = part.partition("=")
        name = name.strip()
        if name not in _AXIS_ORDER:
            raise ValueError(
                f"unknown mesh axis {name!r} in spec {spec!r}; "
                f"axes: {_AXIS_ORDER}")
        if name in out:
            raise ValueError(f"mesh axis {name!r} repeated in spec {spec!r}")
        if not eq or not val.strip().isdigit() or int(val) < 1:
            raise ValueError(
                f"mesh spec entry {part!r} must be '<axis>=<positive int>'")
        out[name] = int(val)
    return out


def mesh_size(spec) -> int:
    """The number of ranks a spec (string or parsed dict) lays out."""
    sizes = parse_mesh_spec(spec) if isinstance(spec, str) else dict(spec)
    total = 1
    for s in sizes.values():
        total *= s
    return total


def make_mesh_from_spec(spec, device_type: str = "cpu"):
    """Build a DeviceMesh from a "data=N[,model=K[,pod=P]]" spec (string
    or the dict parse_mesh_spec returns) over the first N ranks of the
    initialised world, dims in the canonical ("pod","data","model") order
    restricted to the axes named in the spec. The size product must not
    exceed the world size. None or "" -> None (no mesh: the single-device
    path). Collective: every rank of the world calls it."""
    if spec is None:
        return None
    sizes = parse_mesh_spec(spec) if isinstance(spec, str) else dict(spec)
    if not sizes:
        return None
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    axes = tuple(a for a in _AXIS_ORDER if a in sizes)
    shape = tuple(sizes[a] for a in axes)
    total = mesh_size(sizes)
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh spec {sizes} needs an initialised torch.distributed world "
            f"of {total} ranks (the launcher starts one with --mesh; or run "
            f"under torchrun --nproc-per-node {total})")
    avail = dist.get_world_size()
    if total > avail:
        raise ValueError(
            f"mesh spec {sizes} needs {total} ranks but only {avail} are "
            "available (start the world with as many ranks as the spec's "
            "size product)")
    mesh = DeviceMesh(device_type, torch.arange(total).reshape(shape),
                      mesh_dim_names=axes)
    mesh_group(mesh)  # builds the mesh's groups now, on every rank
    return mesh
