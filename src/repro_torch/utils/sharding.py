"""The client axis over a device mesh (port of `repro.utils.sharding`, the
parts the round path reads).

Axis conventions (launch/mesh.py): "data" is the MTSL client axis, "pod"
the outer client axis that composes with it, "model" the tensor axis. The
reference places a leaf with a NamedSharding and lets GSPMD lower the
cross-client reductions to all-reduces. The port runs one process per mesh
position instead: a rank holds the rows of its clients (`rank_rows`: a
contiguous block, or under a client chunk its part of each chunk) of
every leading-client-axis leaf (towers, per-client optimizer state,
schedule rows, batches), every other leaf is replicated, and the round's
cross-client reductions are all-reduces over the rank's CLIENT GROUP: the
ranks that share its "model" coordinate, ordered by their ("pod", "data")
coordinate (`client_group`, the port's `client_sharding`). The reference
has no tensor parallelism in the round, so ranks that differ only in
their "model" coordinate hold the same block and compute the same round.

`DEFAULT_RULES` and `logical_to_spec` are the reference's, as a pure
function of the mesh's axis sizes (a spec is a tuple with one entry per
dimension: None, an axis name or a tuple of names).
"""
from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Sequence

import torch

# logical name -> preferred mesh axes (tried in order; None = replicate)
DEFAULT_RULES: dict[str, Optional[tuple]] = {
    "client": ("pod", "data"),   # MTSL client axis (stacked towers)
    "batch": ("pod", "data"),
    "vocab": ("model",),
    "embed": None,               # d_model replicated by default (see fsdp)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ffn": ("model",),           # FFN hidden dim
    "experts": ("model",),       # expert parallelism
    "expert_ffn": None,
    "seq": None,
    "layers": None,              # scan-stacked layer dim
    "ssm_heads": ("model",),
    "ssm_inner": ("model",),
    "conv_dim": ("model",),
    "state": None,
    "fsdp": ("data",),           # dim tagged for FSDP when enabled
    "cap": None,
    # KV-cache sequence dim: whatever axes the client/batch dims left over
    "kv_seq": ("pod", "data", "model"),
}


def mesh_axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (its named dims), of an object
    whose `.shape` maps names to sizes (the reference's Mesh), or of such a
    mapping itself."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return dict(shape)
    raise TypeError(f"not a mesh: {mesh!r} (want a DeviceMesh with named dims, "
                    "e.g. from launch.mesh.make_mesh_from_spec)")


def _axis_size(sizes: dict, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    s = 1
    for a in axes:
        s *= sizes.get(a, 1)
    return s


def logical_to_spec(mesh, logical: Sequence[Optional[str]], shape: Sequence[int],
                    rules: Optional[dict] = None) -> tuple:
    """Translate per-dim logical names into per-dim mesh axes for `mesh`
    (the reference's rule): a dim whose size is not divisible by the mapped
    axes' size drops leading axes until it is, or is replicated; each mesh
    axis is used at most once."""
    sizes = mesh_axis_sizes(mesh)
    rules = {**DEFAULT_RULES, **(rules or {})}
    used: set = set()
    spec = []
    for name, dim in zip(logical, shape):
        axes = rules.get(name) if name is not None else None
        tup = tuple(a for a in (axes or ()) if a in sizes and a not in used)
        while tup and dim % _axis_size(sizes, tup) != 0:
            tup = tup[1:]
        if not tup:
            spec.append(None)
            continue
        used.update(tup)
        spec.append(tup[0] if len(tup) == 1 else tup)
    return tuple(spec)


def client_mesh_axes(mesh) -> tuple:
    """The mesh axes the MTSL client dimension shards over: the
    DEFAULT_RULES["client"] axes (("pod","data")) present in `mesh`."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(a for a in DEFAULT_RULES["client"] if a in sizes)


def client_axis_size(mesh) -> int:
    """Total number of client shards D: the product of the client mesh
    axes' sizes (1 on a mesh with neither axis)."""
    return _axis_size(mesh_axis_sizes(mesh), client_mesh_axes(mesh))


class ClientGroup(NamedTuple):
    """This rank's place on the client axis: `group` is the process group
    of its client group (one rank when D = 1), `size` D its ranks,
    `index` this rank's client coordinate in [0, D)."""

    group: Any
    size: int
    index: int

    def rows(self, num_clients: int, chunk: Optional[int] = None):
        """This rank's clients: `rank_rows(num_clients, D, index, chunk)`."""
        return rank_rows(num_clients, self.size, self.index, chunk)


def rank_rows(num_clients: int, size: int, index: int,
              chunk: Optional[int] = None):
    """The clients rank `index` of `size` client shards holds, in the
    order it holds them: { j·c + index·(c/D) + i : j < M/c, i < c/D }, with
    c = M without a chunk or for a chunk >= M. So the ranks' sub-blocks of
    chunk j, read in rank order, are clients [j·c, (j+1)·c), the reference's
    chunk j with the client mesh axes on its in-chunk dimension
    (`_chunk_spec_sharding`), and with c = M a rank holds the contiguous
    block its NamedSharding gives it. A slice when the clients are
    contiguous, else a list of client ids (either indexes a tensor or an
    array)."""
    if num_clients % size:
        raise ValueError(f"num_clients {num_clients} not divisible by the "
                         f"mesh's client-shard count {size}")
    c = num_clients if chunk is None or chunk >= num_clients else chunk
    if num_clients % c:
        raise ValueError(f"num_clients {num_clients} not divisible by "
                         f"client_chunk {c}")
    if c % size:
        raise ValueError(f"client_chunk {c} must be a multiple of the mesh's "
                         f"client-shard count {size}")
    per = c // size
    if c == num_clients or size == 1:
        return slice(index * num_clients // size, (index + 1) * num_clients // size)
    return [j + index * per + i for j in range(0, num_clients, c) for i in range(per)]


def row_count(rows) -> int:
    """The number of clients in a `rank_rows` result."""
    return rows.stop - rows.start if isinstance(rows, slice) else len(rows)


class _MeshGroups(NamedTuple):
    mesh: Any
    client: Optional[ClientGroup]  # None on a rank outside the mesh
    everyone: Any  # the process group over all of the mesh's ranks


_GROUPS: dict = {}


def _mesh_groups(mesh) -> _MeshGroups:
    """The client groups and the whole-mesh group of `mesh`, built once.
    `torch.distributed.new_group` is collective over the world: every rank
    builds every group, in the same order, on its first call (which
    `launch.mesh.make_mesh_from_spec` makes)."""
    key = id(mesh)
    hit = _GROUPS.get(key)
    if hit is not None and hit.mesh is mesh:
        return hit
    import torch.distributed as dist

    sizes = mesh_axis_sizes(mesh)
    names = tuple(sizes)
    grid = torch.as_tensor(mesh.mesh).reshape(tuple(sizes.values()))
    caxes = [i for i, a in enumerate(names) if a in client_mesh_axes(mesh)]
    rest = [i for i in range(len(names)) if i not in caxes]
    # [other coordinates..., client coordinates...] -> one row of ranks per
    # client group, in client order
    rows = grid.permute(rest + caxes).reshape(-1, client_axis_size(mesh)).tolist()
    me = dist.get_rank()
    client = None
    for ranks in rows:
        pg = dist.new_group(ranks)
        if me in ranks:
            client = ClientGroup(pg, len(ranks), ranks.index(me))
    everyone = mesh_ranks(mesh)
    whole = (dist.group.WORLD if len(everyone) == dist.get_world_size()
             else dist.new_group(everyone))
    out = _MeshGroups(mesh, client, whole)
    _GROUPS[key] = out
    return out


def client_group(mesh) -> ClientGroup:
    """This rank's client group on `mesh` (see the module docstring): the
    group every cross-client all-reduce of a sharded round runs over."""
    client = _mesh_groups(mesh).client
    if client is None:
        import torch.distributed as dist

        raise ValueError(f"rank {dist.get_rank()} is not part of the mesh "
                         f"{mesh_axis_sizes(mesh)}")
    return client


def mesh_group(mesh):
    """The process group over every rank of `mesh` (replicated leaves are
    broadcast over it from its first rank). The first call builds every
    group of the mesh, collectively over the world."""
    return _mesh_groups(mesh).everyone


def mesh_ranks(mesh) -> list:
    """The global ranks of `mesh`, ascending."""
    return sorted(torch.as_tensor(mesh.mesh).reshape(-1).tolist())
