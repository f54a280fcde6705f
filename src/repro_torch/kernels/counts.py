"""The port's launch and call counters, in one place.

A run reads them to show which path did the work: how many times each
kernel launched, and that a plain version ran 0 times on the card. They
are of two kinds.

  * Python counters: int attributes of a function that its code
    increments (`flash_attention.launches`, `mha_reference.cuda_calls`,
    `layers.attn_decode.calls`, ...). The module that keeps one declares
    it with `register(fn, *attrs)`, which sets it to 0 and lists it in
    `REGISTERED`. A CUDA graph's replay runs no Python, so the serving
    graphs (`serve/graphs.py`) record how far the captured call moved
    every registered counter and add that on each replay.
  * Launch counts kept on the card (`DeviceCounts`), for the kernels that
    the serving graphs replay (K3, K4): thread 0 of a launch's first block
    adds one to its entry of an int64 table (`hopper::count_launch`), so a
    replayed launch counts itself as an eager one does. Nothing infers
    these counts from what a capture recorded. A step's warm-up before
    its capture is not one of the steps served: `serve/graphs.py` puts
    the tables back after it (`save` / `restore`, in stream order).

A third record serves the dry-run (`launch/dryrun.py`), which runs a
program on the meta device: `META`, the calls each kernel's wrapper
took on meta tensors, with the cost its model gives each call
(`KernelCost`: FLOPs, bytes moved, workspace bytes). A wrapper given
meta tensors allocates its outputs there, adds the call to `META` and
launches nothing.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

REGISTERED: List[Tuple[object, str]] = []  # (function, attribute)
DEVICE: List["DeviceCounts"] = []  # every kernel's launch counts on the card


def register(fn, *attrs: str) -> None:
    """Declare fn.<attr> (set to 0) for each attr as a Python counter."""
    for attr in attrs:
        setattr(fn, attr, 0)
        if (fn, attr) not in REGISTERED:
            REGISTERED.append((fn, attr))


class DeviceCounts:
    """A kernel's launches by key (its modes or paths), counted on the card
    by the launches themselves. The table of a device is made by the first
    launch there, outside any CUDA graph capture (a capture that would
    make it raises: the step's warm-up makes it first), and is never
    replaced, so a graph keeps counting into the address it captured.
    `read()` waits for the card."""

    def __init__(self, kernel: str, keys: Sequence[str]):
        self.kernel, self.keys = kernel, tuple(keys)
        self._tables: Dict[torch.device, torch.Tensor] = {}
        DEVICE.append(self)

    def entry(self, device: torch.device, key: str) -> int:
        """The address of key's uint64 entry on `device`, for the kernel."""
        t = self._tables.get(device)
        if t is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.kernel}: no launch-count table on {device} yet; run "
                    "the step once before capturing it")
            t = self._tables[device] = torch.zeros(
                len(self.keys), dtype=torch.int64, device=device)
        return t.data_ptr() + t.element_size() * self.keys.index(key)

    def read(self) -> Dict[str, int]:
        """Launches by key since the last reset, over every device."""
        out = dict.fromkeys(self.keys, 0)
        for t in self._tables.values():
            for key, n in zip(self.keys, t.tolist()):
                out[key] += n
        return out

    def total(self) -> int:
        return sum(self.read().values())

    def reset(self) -> None:
        for t in self._tables.values():
            t.zero_()

    def save(self) -> Dict[torch.device, torch.Tensor]:
        """A copy of every table, queued on the current stream."""
        return {dev: t.clone() for dev, t in self._tables.items()}

    def restore(self, saved: Dict[torch.device, torch.Tensor]) -> None:
        """Put the tables back to `saved` on the current stream; a table
        made since then goes back to zero."""
        for dev, t in self._tables.items():
            if dev in saved:
                t.copy_(saved[dev])
            else:
                t.zero_()


class KernelCost(NamedTuple):
    """One call of a kernel, from its shapes: the operations it does, the
    bytes it must move (each input read once, each output written once)
    and the scratch it allocates for the call."""

    flops: int
    bytes: int
    workspace_bytes: int = 0


class MetaTally:
    """Calls of each kernel on the meta device since the last reset: by
    kernel name, {"launches", "flops", "bytes", "workspace_bytes"} (the
    largest workspace of one call), "leaves" (K1's table rows) and
    "by_key", the launches by the mode or path the wrapper names, as its
    counters on the card keep them."""

    def __init__(self):
        self.by_kernel: Dict[str, Dict[str, int]] = {}

    def add(self, kernel: str, cost: KernelCost, key: str = "",
            leaves: int = 0) -> None:
        rec = self.by_kernel.setdefault(
            kernel, {"launches": 0, "flops": 0, "bytes": 0, "workspace_bytes": 0,
                     "leaves": 0, "by_key": {}})
        rec["launches"] += 1
        rec["leaves"] += leaves
        if key:
            rec["by_key"][key] = rec["by_key"].get(key, 0) + 1
        rec["flops"] += int(cost.flops)
        rec["bytes"] += int(cost.bytes)
        rec["workspace_bytes"] = max(rec["workspace_bytes"], int(cost.workspace_bytes))

    def launches(self, kernel: str, key: str = "") -> int:
        rec = self.by_kernel.get(kernel, {})
        return rec.get("by_key", {}).get(key, 0) if key else rec.get("launches", 0)

    def reset(self) -> None:
        self.by_kernel = {}


META = MetaTally()
