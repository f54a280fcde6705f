"""Continuous-batching serve engine (port of `repro.serve.continuous`): a
fixed pool of cache *slots* shared by requests that arrive, prefill in
chunks, decode, and leave.

  * Slot pool. Tower and server caches are allocated once with shape
    [slots, ...]: the KV caches [slots, cap, ...], cap = max_len rounded up
    to a chunk multiple, and the Mamba layers' conv tails [slots, W-1, D]
    and f32 SSM states [slots, H, P, N]. Each
    slot carries device-side scalars: pos (tokens cached), tok (last
    sampled token), client (which tower serves it), remaining (tokens
    still to emit), n_out, a sampling key and a temperature, plus a
    [slots, cap] output buffer. A request is admitted by streaming its
    prompt through `_extend` in fixed-size chunks and evicted by the host
    marking the slot free; the next occupant's first chunk zeroes the
    slot's caches.

  * Compiled steps. As the reference's engine runs exactly two jitted
    step functions whose shapes never change, this one runs its steps as
    CUDA graphs (`serve/graphs.py`), captured once at construction while
    every slot is free and replayed for every step after: one decode step
    and one extend step per client (M + 1 graphs in one memory pool;
    `stats["steps"]` built, `stats["captures"]` captured). Admission,
    eviction and slot reuse never capture again. Every step reads and
    writes static buffers only: the slot pool, the slot scalars and
    `_facts`, the chunk's tokens and its facts, which one pinned
    host->device copy a chunk writes. On the CPU (and with
    `graphs=False`) the same steps run eagerly on the same buffers.

  * `_decode` — the hot path. For each client m the tower runs over ALL
    slots with the view of tower m (static shapes, rows independent) and
    only the rows whose client is m are kept; the reference instead
    gathers a copy of each slot's tower per step, which at full width
    would copy every tower once per slot per step. The tower's MoE layers
    dispatch each slot's token alone (`rows_alone`), as the reference's
    batch-1 tower decode under vmap does, so the rows of other clients
    never take an expert's capacity. One batched server decode over all
    slots follows (its MoE layers dispatch the slots together, as the
    reference's server decode does), then sampling on the device (no
    device->host sync per token): greedy and sampled tokens both, each
    slot taking one by its temperature, as the reference does. Inactive
    slots ride along, but their caches are frozen: decode writes K/V,
    conv tails and SSM states in place only for active rows (for the
    tower, active rows of that client).

  * `_extend` — chunked prefill of ONE request into its slot through its
    client's tower (a view, never a copy; one step per client). The
    scheduling facts (slot, start, n_valid, is_last, temperature, key,
    new_tokens) are device scalars, as the reference traces them: the
    slot's caches are gathered into a staging copy (zeroed on the first
    chunk, start == 0), extended in place, and scattered back, as the
    reference's dynamic_slice / dynamic_update_slice do. The final chunk
    samples the request's first output token at its last prompt position;
    the slot scalars are written with `torch.where` on is_last.

  * Host scheduler. `submit()` queues requests; `run()` loops: admit at
    most one prefill chunk per iteration (chunked prefill interleaved with
    the running decode batch), then one decode step if any slot is
    active. Bookkeeping is host-mirrored, so the loop never waits on the
    device; finished rows are copied out on the device and brought to the
    host once at the end.

Families without chunked prefill (vlm, encdec) and ring KV caches are
refused, as in the reference: `ServeEngine.generate` serves them through
the sequential engine. Greedy decoding is token-for-token identical to
the sequential engine per request (MoE capacity aside: under capacity
pressure co-resident requests can interact, as in the reference). Caches are written in place (the reference's are immutable); the
freeze above and the zeroing at admission keep its semantics.
"""
from __future__ import annotations

import functools
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.split import client_view
from repro_torch.models.registry import Model
from repro_torch.serve.engine import check_params_device
from repro_torch.serve.graphs import StepGraphs
from repro_torch.serve.sampling import fold_in, sample
from repro_torch.utils.tree import tree_leaves

PyTree = Any

# the chunk's facts, after its `chunk` tokens in one int64 buffer; the
# temperature as the bits of an f32
_SLOT, _START, _NVALID, _LAST, _KEY, _NEW, _TEMP = range(7)
N_FACTS = 7


@dataclass
class Request:
    """One generation request. `key` overrides the engine-derived sampling
    key (used by ServeEngine.generate for rng-reproducible sampling)."""

    id: int
    client: int
    tokens: Sequence[int]
    new_tokens: int
    temperature: float = 0.0
    key: Optional[int] = None


@dataclass
class _Admission:
    """Host-side progress of an in-flight chunked prefill."""

    req: Request
    slot: int
    done_tokens: int = 0


def continuous_refusal(model: Model) -> Optional[str]:
    """The reference's ValueError message for what continuous batching does
    not serve (families without chunked prefill, ring KV caches), or None
    where it serves the model. Every engine choice reads this one rule."""
    if model.tower_extend is None or model.server_extend is None:
        return (f"family {model.cfg.family!r} does not support chunked prefill"
                " (no tower_extend); use the sequential engine")
    if model.cfg.decode_long_window:
        return ("continuous batching does not support ring KV caches"
                " (decode_long_window); use the sequential engine")
    return None


class ContinuousEngine:
    """Slot-based continuous batching over a split (tower/server) model."""

    def __init__(self, model: Model, params, num_clients: int, max_len: int,
                 *, slots: int = 8, chunk: int = 8, seed: int = 0,
                 device="cuda", graphs: bool = True):
        why = continuous_refusal(model)
        if why:
            raise ValueError(why)
        self.device = dev = check_params_device(params, device)
        self.model = model
        self.params = params
        self.M = num_clients
        self.max_len = max_len
        self.slots = slots
        self.chunk = chunk
        # capacity: chunk multiple >= max_len, so chunked extend writes a
        # full [chunk] block without running past the cache
        self.cap = -(-max_len // chunk) * chunk
        self.seed = seed

        S, cap = slots, self.cap
        self._tcache = model.init_tower_cache(S, cap, dev)
        self._scache = model.init_server_cache(S, cap, dev)

        def zeros(dtype, *shape):
            return torch.zeros((S,) + shape, dtype=dtype, device=dev)

        self._state = {
            "pos": zeros(torch.int32),
            "tok": zeros(torch.int32),
            "client": zeros(torch.int32),
            "remaining": zeros(torch.int32),
            "n_out": zeros(torch.int32),
            "key": zeros(torch.int64),
            "temp": zeros(torch.float32),
            "out": zeros(torch.int32, cap),
        }
        # AND of isfinite over every logits row the engine has sampled from
        self._finite = torch.ones((), dtype=torch.bool, device=dev)
        # the extend step's inputs: one slot's caches staged, and the chunk
        self._tstage = model.init_tower_cache(1, cap, dev)
        self._sstage = model.init_server_cache(1, cap, dev)
        self._facts = torch.zeros((chunk + N_FACTS,), dtype=torch.int64,
                                  device=dev)
        # the compiled steps: captured now, while every slot is free, so the
        # warm-ups write only caches and scalars that admission resets. They
        # hold the engine weakly: an engine no caller holds is freed at once
        # (caches, graphs), not at the next cyclic collection
        self.graphs = StepGraphs(dev, graphs)
        me, cls = weakref.proxy(self), type(self)
        self._decode_step = self.graphs.step(functools.partial(cls._decode, me))
        self._extend_steps = [self.graphs.step(functools.partial(cls._extend, me, m))
                              for m in range(num_clients)]

        # host mirrors (never read back from the device for scheduling)
        self._free: List[int] = list(range(slots))
        self._slot_remaining = [0] * slots
        self._slot_emitted = [0] * slots
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._pending: List[Request] = []
        self._admitting: Optional[_Admission] = None
        self._results: Dict[int, torch.Tensor] = {}
        self.stats = {"extend_steps": 0, "decode_steps": 0, "admitted": 0,
                      "decode_slot_tokens": 0, "steps": self.graphs.steps,
                      "captures": self.graphs.captures}

    # ------------------------------------------------------------------
    # device steps
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _decode(self):
        """One decode step over every slot; returns its logits [slots, V]."""
        model, st, cap = self.model, self._state, self.cap
        towers, server = self.params["towers"], self.params["server"]
        active = st["remaining"] > 0
        tokens = st["tok"].long()[:, None]
        h = None
        for m in range(self.M):
            mine = st["client"] == m
            h_m = model.tower_decode(client_view(towers, m), {"tokens": tokens},
                                     self._tcache, st["pos"],
                                     write=active & mine, rows_alone=True)["h"]
            h = h_m if h is None else torch.where(mine[:, None, None], h_m, h)
        logits = model.server_decode(server, {"h": h}, self._scache, st["pos"],
                                     write=active)
        lg = logits[:, -1, :]
        self._finite &= torch.isfinite(lg).all()

        # per-slot key folded with the slot's position
        sampled = sample(lg, st["temp"], fold_in(st["key"], st["pos"].long()))
        greedy = torch.argmax(lg, dim=-1).to(torch.int32)
        chosen = torch.where(st["temp"] > 0.0, sampled, greedy)
        tok = torch.where(active, chosen, st["tok"])

        rows = torch.arange(self.slots, device=self.device)
        idx = st["n_out"].long().clamp(max=cap - 1)  # frozen rows may sit at cap
        st["out"][rows, idx] = torch.where(active, tok, st["out"][rows, idx])
        act = active.to(torch.int32)
        st["tok"].copy_(tok)
        st["pos"] += act
        st["remaining"] -= act
        st["n_out"] += act
        return lg

    def _cache_pairs(self):
        """(pool leaf [slots, ...], staging leaf [1, ...]) of every cache."""
        return list(zip(tree_leaves(self._tcache) + tree_leaves(self._scache),
                        tree_leaves(self._tstage) + tree_leaves(self._sstage)))

    @torch.no_grad()
    def _extend(self, client: int):
        """One chunk of the request in the slot that `_facts` names, through
        client's tower."""
        model, st, C = self.model, self._state, self.chunk
        f = self._facts
        slot = f[C + _SLOT:C + _SLOT + 1]  # [1]
        start, n_valid = f[C + _START], f[C + _NVALID]
        is_last = f[C + _LAST] != 0
        key = f[C + _KEY:C + _KEY + 1]
        temp = f[C + _TEMP:C + _TEMP + 1].to(torch.int32).view(torch.float32)
        # the slot's caches, staged; the first chunk zeroes them so the
        # previous occupant can never leak through
        first = start == 0
        for pool, stage in self._cache_pairs():
            torch.index_select(pool, 0, slot, out=stage)
            stage.masked_fill_(first, 0)
        smashed = model.tower_extend(client_view(self.params["towers"], client),
                                     {"tokens": f[None, :C]}, self._tstage,
                                     start, n_valid)
        logits = model.server_extend(self.params["server"], smashed,
                                     self._sstage, start, n_valid)
        for pool, stage in self._cache_pairs():
            pool.index_copy_(0, slot, stage)

        # the first output token at the last real prompt position (same key
        # schedule as _decode), kept on the final chunk only
        lg = logits[:, -1, :]
        self._finite &= torch.isfinite(lg).all() | ~is_last
        sampled = sample(lg, temp, fold_in(key, start + n_valid - 1))
        greedy = torch.argmax(lg, dim=-1).to(torch.int32)
        tok0 = torch.where(temp > 0.0, sampled, greedy)

        def put(name, value):
            col = st[name]
            col.index_copy_(0, slot, value.reshape(1).to(col.dtype))

        put("pos", start + n_valid)
        put("client", torch.full_like(slot, client))
        put("remaining", torch.where(is_last, f[C + _NEW] - 1, 0))
        put("n_out", is_last)
        put("key", key)
        put("temp", temp)
        put("tok", torch.where(is_last, tok0, st["tok"].index_select(0, slot)))
        out0 = st["out"][:, 0]
        out0.index_copy_(0, slot, torch.where(is_last, tok0,
                                              out0.index_select(0, slot)))

    # ------------------------------------------------------------------
    # host scheduler
    # ------------------------------------------------------------------

    def submit(self, req: Request):
        L = len(req.tokens)
        if L < 1 or L + req.new_tokens - 1 > self.cap:
            raise ValueError(
                f"request {req.id}: prompt {L} + new {req.new_tokens} exceeds"
                f" capacity {self.cap}")
        if not (0 <= req.client < self.M):
            raise ValueError(f"request {req.id}: client {req.client} not in"
                             f" [0, {self.M})")
        self._pending.append(req)

    def _issue_chunk(self):
        """Run one extend step for the in-flight admission (starting one if
        a slot is free). Returns True if a chunk was issued."""
        if self._admitting is None:
            if not self._pending or not self._free:
                return False
            req = self._pending.pop(0)
            self._admitting = _Admission(req, self._free.pop(0))
            self.stats["admitted"] += 1
        adm = self._admitting
        req, C = adm.req, self.chunk
        L = len(req.tokens)
        start = adm.done_tokens
        n_valid = min(C, L - start)
        is_last = start + n_valid >= L
        facts = np.zeros((C + N_FACTS,), np.int64)
        facts[:n_valid] = np.asarray(req.tokens[start:start + n_valid])
        facts[C + _SLOT], facts[C + _START] = adm.slot, start
        facts[C + _NVALID], facts[C + _LAST] = n_valid, is_last
        facts[C + _KEY] = (req.key if req.key is not None
                           else fold_in(self.seed, req.id))
        facts[C + _NEW] = req.new_tokens
        facts[C + _TEMP] = np.float32(req.temperature).view(np.int32)
        host = torch.from_numpy(facts)
        if self.device.type == "cuda":  # pinned: the copy does not stall the host
            host = host.pin_memory()
        self._facts.copy_(host, non_blocking=True)
        self._extend_steps[req.client].run()
        adm.done_tokens = start + n_valid
        self.stats["extend_steps"] += 1
        if is_last:
            s = adm.slot
            self._slot_req[s] = req
            self._slot_remaining[s] = req.new_tokens - 1
            self._slot_emitted[s] = 1
            self._admitting = None
            self._maybe_finish(s)
        return True

    def _maybe_finish(self, s: int):
        if self._slot_req[s] is not None and self._slot_remaining[s] == 0:
            req = self._slot_req[s]
            n = self._slot_emitted[s]
            # device-side copy (the slot's buffer row is reused); brought
            # to the host once in run()
            self._results[req.id] = self._state["out"][s, :n].clone()
            self._slot_req[s] = None
            self._free.append(s)

    def _decode_once(self) -> Optional[torch.Tensor]:
        """One decode step if a slot is active: its logits [slots, V] (the
        step's buffer, overwritten by the next step), else None."""
        live = [s for s in range(self.slots)
                if self._slot_req[s] is not None and self._slot_remaining[s] > 0]
        if not live:
            return None
        logits = self._decode_step.run()
        self.stats["decode_steps"] += 1
        for s in live:
            self._slot_remaining[s] -= 1
            self._slot_emitted[s] += 1
            self._maybe_finish(s)
        self.stats["decode_slot_tokens"] += len(live)
        return logits

    def run(self):
        """Process every submitted request to completion. Returns
        {request id -> int32 array of new_tokens sampled tokens}."""
        while True:
            issued = self._issue_chunk()
            decoded = self._decode_once() is not None
            if not issued and not decoded:
                break
        out = {rid: toks.cpu().numpy() for rid, toks in self._results.items()}
        self._results.clear()
        return out

    def logits_finite(self) -> bool:
        """Whether every logits row sampled so far was finite (syncs)."""
        return bool(self._finite)

    # ------------------------------------------------------------------
    # benchmark entry points (phase-separated, no interleaving)
    # ------------------------------------------------------------------

    def sync(self):
        """Block until all queued device work is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill_all(self) -> int:
        """Admit every pending request a slot is free for (chunked prefill
        only, no decode). Returns the number of extend steps issued."""
        n = 0
        while self._issue_chunk():
            n += 1
        return n

    def decode_all(self, max_steps: Optional[int] = None) -> int:
        """Decode until no slot is active, or for at most max_steps steps.
        Returns slot-tokens emitted."""
        t0, steps = self.stats["decode_slot_tokens"], 0
        while ((max_steps is None or steps < max_steps)
               and self._decode_once() is not None):
            steps += 1
        return self.stats["decode_slot_tokens"] - t0
