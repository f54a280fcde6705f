"""Collective traffic of a program, tallied per call: the port's
counterpart of `repro/utils/hlo.py`.

The reference reads its collectives out of the compiled HLO. The port
has no HLO: its cross-client collectives are the calls of
`core/client_axis.py` (`client_sum_`, `client_max`, `gather_clients`),
which count themselves in `client_axis.COLLECTIVES`. A dry-run
(`launch/dryrun.py`) runs one rank of a mesh over a `DryRunGroup`: a
client group of D ranks with no process group behind it. Each
all-reduce and all-gather is then recorded (`CollectiveOp`: kind, bytes,
payload shape, calling function) through the same counter, and returns
a tensor of the shape the real collective gives. `CollectiveStats`,
`top_collectives` and `count_op` read such a list of ops as the
reference's functions read HLO text; the kinds are named as in the
reference ("all-reduce", "all-gather"). Bytes are those of the result,
as the reference counts them: the reduced tensor of an all-reduce, the
gathered one of an all-gather.
"""
from __future__ import annotations

import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, NamedTuple, Tuple


class CollectiveOp(NamedTuple):
    kind: str  # "all-reduce" or "all-gather"
    nbytes: int  # result bytes
    shape: Tuple[int, ...]  # the result's shape
    dtype: str
    caller: str  # "function (file:line)" of the round code that called it


@dataclass
class CollectiveStats:
    bytes_by_kind: dict = field(default_factory=lambda: defaultdict(int))
    count_by_kind: dict = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> str:
        rows = [
            f"  {k:<22s} n={self.count_by_kind[k]:<5d} {v/1e9:9.3f} GB"
            for k, v in sorted(self.bytes_by_kind.items())
        ]
        rows.append(f"  {'TOTAL':<22s}        {self.total_bytes/1e9:9.3f} GB")
        return "\n".join(rows)


def collective_bytes(ops: List[CollectiveOp]) -> CollectiveStats:
    """Bytes and calls of every collective in `ops`, by kind."""
    stats = CollectiveStats()
    for op in ops:
        stats.bytes_by_kind[op.kind] += op.nbytes
        stats.count_by_kind[op.kind] += 1
    return stats


def count_op(ops: List[CollectiveOp], opname: str) -> int:
    """How many of `ops` are of kind `opname` (e.g. "all-reduce")."""
    return sum(op.kind == opname for op in ops)


def top_collectives(ops: List[CollectiveOp], n: int = 10) -> list:
    """The n largest collectives: (kind, "dtype[shape] [caller]", bytes),
    largest first. Shows which tensors dominate the collective term."""
    out = [(op.kind, f"{op.dtype}[{','.join(map(str, op.shape))}] [{op.caller}]",
            op.nbytes) for op in ops]
    out.sort(key=lambda t: -t[2])
    return out[:n]


class DryRunGroup:
    """A client group of `size` ranks with no process group behind it: the
    collectives of `core/client_axis.py` record themselves in `ops` and
    return tensors of the shape the real collective gives (an all-reduce
    its input, an all-gather a new [size * rows, ...] tensor on the
    input's device), with no data exchanged."""

    def __init__(self, size: int):
        self.size = size
        self.ops: List[CollectiveOp] = []

    def record(self, kind: str, t, shape) -> None:
        n = 1
        for d in shape:
            n *= int(d)
        self.ops.append(CollectiveOp(kind, n * t.element_size(), tuple(shape),
                                     str(t.dtype).replace("torch.", ""), _caller()))


def _caller() -> str:
    """The first frame outside `core/client_axis.py` and this module."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.endswith(
            ("client_axis.py", "collectives.py")):
        f = f.f_back
    if f is None:
        return "?"
    code = f.f_code
    return f"{code.co_name} ({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})"


def dry_run_client_group(size: int, index: int = 0):
    """A `utils.sharding.ClientGroup` of `size` ranks over a DryRunGroup
    (this process is rank `index` of it): pass it to
    `core.client_axis.client_axis(group=...)`."""
    from repro_torch.utils.sharding import ClientGroup

    return ClientGroup(DryRunGroup(size), size, index)
