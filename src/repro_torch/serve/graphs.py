"""The engines' compiled steps: the port's counterpart of the reference's
`jax.jit` of its decode and extend steps (`repro.serve.continuous`,
`repro.serve.engine`), as CUDA graphs.

A step is a function of no arguments over *static buffers*: every tensor it
reads or writes (caches, slot scalars, the chunk's facts, the token to
decode) lives at a fixed address that the caller fills in place between
steps. `StepGraphs.step(fn)` turns it into a `Step`:

  * on CUDA, `fn` runs once on the engine's capture stream (the warm-up:
    the kernels' libraries load, cuBLAS picks its handles, the rotary
    frequencies and the kernels' counter tables are made for that stream),
    then once more under `torch.cuda.graph` on the same stream, into the
    engine's one memory pool. `Step.run()` replays the graph and returns
    what the captured call returned (tensors of the pool, overwritten by
    the next replay). A step that syncs or copies from pageable memory
    makes the capture raise; nothing falls back to eager;
  * on the CPU, or with `enabled=False` (used to hold replay against the
    eager step on the card), `Step.run()` calls `fn` on the same buffers.
    The CPU tests so run exactly the code that the card captures.

The graphs of one engine share its pool and its capture stream, and
replay in series on the caller's stream, never concurrently (each
replay's temporaries are dead before the next graph runs; every result
that outlives a step is a static buffer or is read before the next
replay).

Python counters do not run on replay. Those that the port's modules
register (`kernels/counts.py`: the decode attentions, the plain versions
on CUDA tensors, K1's and K2's launches) are read around the capture: the
warm-up counts nothing (the counters are put back), the capture's change
is the step's `delta`, and every replay adds it. K3 and K4, the kernels
the graphs replay, count their launches on the card themselves
(`flash_decode.counts`, `ssd_scan.counts`; the warm-up's launches are
taken back, a capture launches nothing), so a check such as K4
launches == decode attentions == steps x launches per step holds a count
of what ran against one of what was captured. The MoE dispatch tally
(`models.moe.moe_forward.tally`) is a device tensor that the captured
step adds to in place; the warm-up runs with it off.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels.counts import DEVICE, REGISTERED
from repro_torch.models import moe


def read_counts() -> Tuple[int, ...]:
    """Every registered Python counter, in `REGISTERED`'s order."""
    return tuple(getattr(obj, attr) for obj, attr in REGISTERED)


def set_counts(values) -> None:
    for (obj, attr), v in zip(REGISTERED, values):
        setattr(obj, attr, v)


def add_counts(delta) -> None:
    set_counts(a + d for a, d in zip(read_counts(), delta))


def counted(fn: Callable):
    """fn()'s result and how far it moved each counter; the counters are
    left as they were."""
    before = read_counts()
    try:
        out = fn()
        delta = tuple(a - b for a, b in zip(read_counts(), before))
    finally:
        set_counts(before)
    return out, delta


def _warm_up(fn: Callable) -> None:
    """fn() with no counter moved and the MoE tally off: the Python
    counters are put back, and so are the launch counts on the card, in
    the stream's order after fn's launches."""
    tally, moe.moe_forward.tally = moe.moe_forward.tally, None
    saved = [c.save() for c in DEVICE]
    try:
        counted(fn)
    finally:
        moe.moe_forward.tally = tally
        for c, s in zip(DEVICE, saved):
            c.restore(s)


def capture(fn: Callable, pool, stream: torch.cuda.Stream):
    """Warm fn up on `stream`, then capture it there into `pool`. Returns
    (graph, the captured call's result, its counters' change)."""
    dev_stream = torch.cuda.current_stream(stream.device)
    stream.wait_stream(dev_stream)
    with torch.cuda.stream(stream):
        _warm_up(fn)
    dev_stream.wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        out, delta = counted(fn)
    return graph, out, delta


class Step:
    """One step: `run()` replays its graph (and adds its counts), or calls
    the function where it was not captured."""

    def __init__(self, fn: Callable, graph=None, out=None, delta=None):
        self.fn, self.graph, self.out, self.delta = fn, graph, out, delta

    def run(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        add_counts(self.delta)
        return self.out


class StepGraphs:
    """One engine's steps: a memory pool and a capture stream shared by its
    graphs (on CUDA with `enabled`), the steps built (`steps`), the graphs
    captured (`captures`: every step on the card, none elsewhere) and the
    wall time their warm-ups and captures took."""

    def __init__(self, device: torch.device, enabled: bool = True):
        self.device = device
        self.enabled = bool(enabled) and device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.enabled else None
        self.stream = torch.cuda.Stream(device) if self.enabled else None
        self.steps = self.captures = 0
        self.capture_ms = 0.0

    def step(self, fn: Callable) -> Step:
        self.steps += 1
        if not self.enabled:
            return Step(fn)
        self.captures += 1
        t0 = time.perf_counter()
        graph, out, delta = capture(fn, self.pool, self.stream)
        torch.cuda.synchronize(self.device)
        self.capture_ms += (time.perf_counter() - t0) * 1e3
        return Step(fn, graph, out, delta)

    def pool_bytes(self) -> Optional[int]:
        """Bytes the allocator holds for the pool (its segments), or None
        where nothing was captured."""
        if not self.enabled:
            return None
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)
