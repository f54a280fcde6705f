"""The client axis as an execution resource: chunked maps over client
blocks and the client axis split over a device mesh, behind one seam (port
of `repro.core.client_axis`).

Every round builder maps per-client work over the leading client
dimension (towers, per-client batches, schedule rows). With no ambient
policy that map covers all M clients at once. Under
`client_axis(chunk=c)` it runs over M/c blocks of c clients, one block
after the other, so only one block's intermediates are live at a time.

The reference's chunk is a `lax.scan` inside one traced round, whose
backward XLA schedules block by block. The port runs eagerly, so a
forward map over blocks followed by one backward would keep every
block's activations alive until that backward. The gradient builders
therefore take the chunk themselves: each block runs its forward AND its
backward before the next block starts, and the shared server's gradient
is the sum of the blocks' (the round's loss is a sum over clients, so
this is the dense gradient up to summation order):

  * `core/mtsl.py`'s local step (`_chunked_grads`, the counterpart of the
    reference's `_chunked_loss` / `_chunk_terms`) and its eval
    (`_chunk_eval`);
  * `core/federation.py`'s `_client_value_and_grad`, the seam every
    baseline's local steps go through (the reference's
    `_vmap_with_smask`), and its evals through `client_map`.

The mesh half: under `client_axis(group=g)` (g a
`utils.sharding.ClientGroup`) this process holds only its M/D clients of
every client-axis tensor, and the round's cross-client reductions are a
local reduction followed by an all-reduce over g's process group:
`client_sum` / `client_sum_` (sums, coalesced per dtype), `client_max`
and `gather_clients` (a [M/D, ...] tensor to the [M, ...] one in client
order). Without a group each is the identity, so the single-device round
computes what it did before. Which clients a rank holds is one rule
(`utils.sharding.rank_rows`): without a chunk its contiguous block; with
chunk c its c/D clients of each chunk, so that its local blocks of c/D
(`current_chunk` is that per-rank block size) are its parts of the
chunks, and the ranks' parts of chunk j, in rank order, are the
reference's chunk j, as the reference's devices each hold c/D of a
chunk's c.

`client_blocks(M)` gives the block slices; `client_map` is the forward
map (eval, no gradient). The policy is read when a round RUNS (there is
no trace): `core.algorithms.shard_round_fn(client_chunk=, mesh=)` enters
the context around each call. Nothing here touches global torch state;
`COLLECTIVES` counts the collectives' calls, bytes and host seconds. A
group over a `utils.collectives.DryRunGroup` (the dry-run's) exchanges
nothing: each collective is counted, recorded in the group's `ops` and
returns a tensor of the real collective's shape.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator, NamedTuple, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class ClientAxisCtx(NamedTuple):
    """Ambient execution policy for the client axis."""

    chunk: Optional[int] = None  # block size over all ranks; None = no blocks
    group: Optional[Any] = None  # utils.sharding.ClientGroup; None = no mesh


_STACK: list = [ClientAxisCtx()]


def current_chunk() -> Optional[int]:
    """This process's block size: the chunk, divided by the client-shard
    count under a mesh (each rank scans c/D of a chunk's c clients)."""
    ctx = _STACK[-1]
    if ctx.chunk is None or ctx.group is None:
        return ctx.chunk
    return ctx.chunk // ctx.group.size


def current_group():
    """The ambient ClientGroup, or None off a mesh."""
    return _STACK[-1].group


def local_rows(num_clients: int):
    """The clients this rank holds under the ambient policy
    (`utils.sharding.rank_rows`), or None off a mesh."""
    ctx = _STACK[-1]
    return None if ctx.group is None else ctx.group.rows(num_clients, ctx.chunk)


@contextmanager
def client_axis(chunk: Optional[int] = None, group=None):
    """Scope a client-axis policy over the rounds run inside the block.
    `chunk=None, group=None` is the identity."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"client chunk must be >= 1, got {chunk}")
    if chunk is not None and group is not None and chunk % group.size:
        raise ValueError(f"client chunk {chunk} must be a multiple of the "
                         f"mesh's client-shard count {group.size}")
    _STACK.append(ClientAxisCtx(chunk=chunk, group=group))
    try:
        yield _STACK[-1]
    finally:
        _STACK.pop()


# ---------------------------------------------------------------------------
# collectives over the ambient client group
# ---------------------------------------------------------------------------

# calls, payload bytes and host seconds of the collectives below, by kind
COLLECTIVES = {"all_reduce": [0, 0, 0.0], "all_gather": [0, 0, 0.0]}


def reset_collectives() -> None:
    for v in COLLECTIVES.values():
        v[:] = [0, 0, 0.0]


def collective_stats() -> dict:
    """{kind: {"calls", "bytes", "host_s"}} since the last reset."""
    return {k: {"calls": c, "bytes": b, "host_s": s}
            for k, (c, b, s) in COLLECTIVES.items()}


def _count(kind: str, nbytes: int, t0: float) -> None:
    rec = COLLECTIVES[kind]
    rec[0] += 1
    rec[1] += nbytes
    rec[2] += time.perf_counter() - t0


def _dry_run(group) -> bool:
    from repro_torch.utils.collectives import DryRunGroup

    return isinstance(group.group, DryRunGroup)


def _all_reduce(flat: torch.Tensor, op: str, group) -> torch.Tensor:
    t0 = time.perf_counter()
    if _dry_run(group):
        group.group.record("all-reduce", flat, flat.shape)
    else:
        import torch.distributed as dist

        dist.all_reduce(flat, op=getattr(dist.ReduceOp, op), group=group.group)
    _count("all_reduce", flat.numel() * flat.element_size(), t0)
    return flat


def client_sum_(tensors) -> list:
    """The element-wise sums of `tensors` over the ambient client group
    (each rank passes its partial sums; all get the totals), as new
    tensors: one all-reduce per dtype and device, over the tensors
    concatenated. The identity (the same tensors) without a group."""
    g = current_group()
    tensors = list(tensors)
    if g is None:
        return tensors
    out = [None] * len(tensors)
    by: dict = {}
    for i, t in enumerate(tensors):
        by.setdefault((t.dtype, t.device), []).append(i)
    for idx in by.values():
        flat = _all_reduce(torch.cat([tensors[i].detach().reshape(-1) for i in idx]),
                           "SUM", g)
        lo = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[lo:lo + n].view(tensors[i].shape)
            lo += n
    return out


def client_sum(t: torch.Tensor) -> torch.Tensor:
    """`client_sum_` of one tensor."""
    return client_sum_([t])[0]


def client_max(t: torch.Tensor) -> torch.Tensor:
    """The element-wise max of `t` over the ambient client group."""
    g = current_group()
    if g is None:
        return t
    return _all_reduce(t.detach().clone(), "MAX", g)


def gather_clients(t: torch.Tensor) -> torch.Tensor:
    """This rank's [M/D, ...] client rows -> the whole [M, ...] tensor in
    client order, on every rank of the ambient group: the ranks' rows
    gathered (`gather_ranks`), then, under a chunk, each chunk's parts
    put together (rank r's part of chunk j is its j-th block of c/D)."""
    g = current_group()
    if g is None:
        return t
    out = gather_ranks(t)
    per = current_chunk()
    n = t.shape[0]
    if per is None or per >= n:
        return out
    rest = tuple(t.shape[1:])
    return out.reshape((g.size, n // per, per) + rest).transpose(0, 1).reshape(
        (g.size * n,) + rest)


def gather_ranks(t: torch.Tensor) -> torch.Tensor:
    """[n, ...] on each rank of the ambient group -> [D·n, ...], the ranks'
    tensors in rank order, on every rank. gloo carries only all_reduce and
    broadcast for CUDA tensors, so under gloo a CUDA tensor is gathered
    through the host."""
    g = current_group()
    if g is None:
        return t
    import torch.distributed as dist

    t0 = time.perf_counter()
    x = t.detach().contiguous()
    if _dry_run(g):
        out = x.new_empty((g.size * x.shape[0],) + tuple(x.shape[1:]))
        g.group.record("all-gather", x, out.shape)
    elif dist.get_backend(g.group) == "nccl":
        out = x.new_empty((g.size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=g.group)
    else:
        host = x.cpu()
        parts = [torch.empty_like(host) for _ in range(g.size)]
        dist.all_gather(parts, host, group=g.group)
        out = torch.cat(parts).to(x.device)
    _count("all_gather", x.numel() * x.element_size() * g.size, t0)
    return out


def client_blocks(num: int, chunk: Optional[int] = None,
                  group: int = 1) -> Iterator[slice]:
    """Slices of the leading axis of length `num` by the ambient (or given)
    chunk: one slice covering everything when no chunk applies (None or
    chunk >= clients), else num/(chunk·group) slices of chunk·group rows.
    `group` is the rows per client on that axis (FedEM folds K components
    of each client into it). The client count must divide by the chunk."""
    chunk = current_chunk() if chunk is None else chunk
    clients = num // group
    if chunk is None or chunk >= clients:
        yield slice(0, num)
        return
    if clients % chunk:
        raise ValueError(
            f"client axis of size {clients} is not divisible by client chunk "
            f"{chunk}; pick a chunk dividing M")
    rows = chunk * group
    for lo in range(0, num, rows):
        yield slice(lo, lo + rows)


def client_map(fn: Callable, *args, in_axes=0):
    """Map `fn` over the leading client axis of `args` with
    `torch.func.vmap`, honoring the ambient `client_axis` context.

    `in_axes` is an int or a tuple of entries in {0, None} (0: the arg, a
    tree of dicts and lists of tensors, carries the client axis; None:
    broadcast to every client). With no ambient chunk this IS
    `vmap(fn, in_dims=in_axes)(*args)`; with chunk=c each block of c
    clients is mapped in turn and the outputs (which must all carry the
    mapped axis) are concatenated back to [M, ...].
    """
    axes = (in_axes,) * len(args) if isinstance(in_axes, int) else tuple(in_axes)
    if len(axes) != len(args):
        raise ValueError(f"in_axes has {len(axes)} entries for {len(args)} args")
    if any(a not in (0, None) for a in axes):
        raise ValueError(f"client_map supports in_axes entries 0/None, got {axes}")
    mapped = [leaf for a, ax in zip(args, axes) if ax == 0 for leaf in tree_leaves(a)]
    if not mapped:
        raise ValueError("client_map needs at least one mapped (in_axes=0) arg")
    vfn = torch.func.vmap(fn, in_dims=axes)
    blocks = list(client_blocks(mapped[0].shape[0]))
    if len(blocks) == 1:
        return vfn(*args)
    outs = [vfn(*(tree_map(lambda x: x[sl], a) if ax == 0 else a
                  for a, ax in zip(args, axes)))
            for sl in blocks]
    return tree_map(lambda *xs: torch.cat(xs), outs[0], *outs[1:])
