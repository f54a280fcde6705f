"""The client axis as an execution resource: chunked maps over client
blocks (port of `repro.core.client_axis`, its chunking half; the mesh
half is not ported).

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

`client_blocks(M)` gives the block slices; `client_map` is the forward
map (eval, no gradient). The policy is read when a round RUNS (there is
no trace): `core.algorithms.shard_round_fn(client_chunk=)` enters the
context around each call. Nothing here touches global torch state.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Iterator, NamedTuple, Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


class ClientAxisCtx(NamedTuple):
    """Ambient execution policy for the client axis."""

    chunk: Optional[int] = None  # block size; None = all clients at once


_STACK: list = [ClientAxisCtx()]


def current_chunk() -> Optional[int]:
    return _STACK[-1].chunk


@contextmanager
def client_axis(chunk: Optional[int] = None):
    """Scope a client-axis policy over the rounds run inside the block.
    `chunk=None` is the identity."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"client chunk must be >= 1, got {chunk}")
    _STACK.append(ClientAxisCtx(chunk=chunk))
    try:
        yield _STACK[-1]
    finally:
        _STACK.pop()


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
