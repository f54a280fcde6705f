"""Async round pipeline: schedule/batch prefetch and non-blocking metrics
(port of `repro.train.pipeline`).

The synchronous loop leaves the card idle while the host (1) draws the
round's ClientSchedule, (2) synthesises the round batch and copies it to
the card, and (3) reads metrics back (`float(loss)` waits for the card).
Three pieces move that host work off the card's critical path without
touching the round math, so a pipelined run is the synchronous run, bit
for bit:

  BackgroundIterator   an iterator run on a daemon thread, `depth` items
                       ahead through a bounded queue: the numpy batch
                       synthesis (or the cached shard reads of
                       data/shards.py) and the schedule draws of rounds
                       i+1..i+depth run while the card runs round i. The
                       thread also converts labels to int64 and copies
                       each batch into pinned host memory. An exception
                       of the source reaches the consumer at its position;
                       close() stops the thread.
  pipeline_rounds      zips batches with schedules, prefetches `depth`
                       pairs on that thread and STAGES each pair one round
                       before it is consumed (`_stage`): on the card an
                       asynchronous copy from pinned memory on a side
                       CUDA stream, whose completion the compute stream
                       waits for (an event) before the round reads the
                       batch. depth=0 is a plain synchronous zip (same
                       values, same order).
  MetricsRing          a bounded ring of in-flight metric payloads: the
                       loop pushes the round's device tensors and the
                       ring reads them back (`.item()`, the wait for the
                       card) only when more than `depth` are in flight or
                       at flush(). depth=0 reads on every push.

The round's metrics are fresh tensors of its forward (mtsl) or of its
apply (the baselines), never views of the state that K1 updates in place
in a later round, so a deferred read sees the round's own values.

Staged tensors are allocated on the side stream and used on the compute
stream; `record_stream` tells the caching allocator so, and it does not
hand their memory out again until the compute stream's work queued at
their release has run.

`TrainConfig.prefetch = 0` (`--prefetch 0`) runs the loop synchronously.
The event engine (train/events.py, `--async`) consumes the same stream:
one cohort dispatch pulls one (batch, schedule) pair.
"""
from __future__ import annotations

import functools
import itertools
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


class BackgroundIterator:
    """Iterate `source` on a daemon thread, `depth` items ahead.

    The producer thread owns all host-side work of the source iterator;
    the consumer just dequeues. An exception raised by the source is
    re-raised at the consumer's matching `next()` call, preserving item
    order. `close()` (also at garbage collection and at stream end) stops
    the producer; it is safe to call more than once.
    """

    _ITEM, _DONE, _ERROR = "item", "done", "error"

    def __init__(self, source: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._produce, args=(iter(source),), daemon=True)
        self._thread.start()

    def _produce(self, it: Iterator) -> None:
        try:
            for item in it:
                if not self._put((self._ITEM, item)):
                    return
            self._put((self._DONE, None))
        except BaseException as e:  # noqa: BLE001 — relayed to the consumer
            self._put((self._ERROR, e))

    def _put(self, entry) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(entry, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> "BackgroundIterator":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        kind, payload = self._q.get()
        if kind is self._ITEM:
            return payload
        self.close()
        if kind is self._ERROR:
            raise payload
        raise StopIteration

    def close(self) -> None:
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


def host_batch(batch: dict, pin: bool = False) -> dict:
    """A numpy (or tensor) round batch as CPU tensors, labels as int64
    (the dtype the rounds index with); in pinned memory when `pin`."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        if k == "label":
            t = t.long()
        out[k] = t.pin_memory() if pin and t.device.type == "cpu" else t
    return out


class _Staged(dict):
    """A batch staged on a side stream: `ready` is the event the compute
    stream must wait for before a round reads it."""

    ready: Optional[torch.cuda.Event] = None


def _stage(batch: dict, device, stream=None) -> dict:
    """Start the host-to-device copy of a (host_batch) round batch.

    On the CPU the batch is the tensors themselves. On the card, each
    tensor is copied with non_blocking=True on `stream` (the pipeline's
    side stream) and the returned batch carries the event recorded after
    the copies; `consume` makes the compute stream wait for it."""
    device = torch.device(device)
    if device.type != "cuda" or stream is None:
        return {k: v.to(device) for k, v in host_batch(batch).items()}
    out = _Staged()
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            out[k] = v.to(device, non_blocking=True)
        out.ready = torch.cuda.Event()
        out.ready.record(stream)
    return out


def consume(batch: dict) -> dict:
    """Make the current (compute) stream wait for a staged batch's copies
    and mark its tensors as used there (`record_stream`), so the caching
    allocator keeps their memory until the compute stream is done with
    them. A plain batch passes through."""
    ready = getattr(batch, "ready", None)
    if ready is None:
        return batch
    cur = torch.cuda.current_stream()
    cur.wait_event(ready)
    for v in batch.values():
        v.record_stream(cur)
    return dict(batch)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device):
    """The staging stream of `device`, one per device for the process."""
    return torch.cuda.Stream(device=device)


def pipeline_rounds(
    batches: Iterable,
    schedules: Iterable,
    depth: int = 2,
    num_rounds: Optional[int] = None,
    device="cpu",
) -> Iterator[tuple]:
    """Yield `(batch, schedule)` pairs, each batch on `device`, with the
    host work running ahead.

    depth=0: a plain synchronous zip, each batch staged inline.
    depth>0: a BackgroundIterator produces the pairs (and pins the
    batches, on the card) up to `depth` rounds ahead, and the consumer
    keeps ONE pair staged ahead: when pair i is yielded, pair i+1's copy
    has already been started on the side stream.

    The yielded values equal `zip(batches, schedules)`'s, staged, for any
    depth; only WHEN the host work happens changes."""
    device = torch.device(device)
    pairs: Iterable = zip(batches, schedules)
    if num_rounds is not None:
        pairs = itertools.islice(pairs, num_rounds)
    if depth <= 0:
        for batch, sched in pairs:
            yield _stage(batch, device), sched
        return
    cuda = device.type == "cuda"
    stream = _side_stream(device) if cuda else None
    bg = BackgroundIterator(((host_batch(b, pin=cuda), s) for b, s in pairs),
                            depth=depth)
    try:
        staged = None
        for batch, sched in bg:
            nxt = (_stage(batch, device, stream), sched)
            if staged is not None:
                yield consume(staged[0]), staged[1]
            staged = nxt
        if staged is not None:
            yield consume(staged[0]), staged[1]
    finally:
        bg.close()


class MetricsRing:
    """Bounded ring of in-flight metric payloads.

    `push(payload)` enqueues a dict whose leaves may be live device
    tensors; nothing is read back until the ring holds more than `depth`
    entries (then the OLDEST is read) or `flush()` drains everything at
    the end of the run. Read entries go to `sink` in push order:
    pipelining never reorders history. depth=0 reads on every push.
    """

    def __init__(self, depth: int, sink: Callable[[dict], None]):
        self._depth = max(int(depth), 0)
        self._sink = sink
        self._ring: list = []

    @staticmethod
    def materialize(payload: dict) -> dict:
        """Read every tensor or array leaf back (0-d ones as Python
        floats)."""
        out = {}
        for k, v in payload.items():
            if isinstance(v, dict):
                out[k] = MetricsRing.materialize(v)
            elif torch.is_tensor(v):
                out[k] = v.item() if v.ndim == 0 else v.detach().cpu().numpy()
            elif isinstance(v, np.ndarray):
                out[k] = float(v) if v.ndim == 0 else v
            else:
                out[k] = v
        return out

    def push(self, payload: dict) -> None:
        self._ring.append(payload)
        while len(self._ring) > self._depth:
            self._sink(self.materialize(self._ring.pop(0)))

    def flush(self) -> None:
        while self._ring:
            self._sink(self.materialize(self._ring.pop(0)))

    def __len__(self) -> int:
        return len(self._ring)
