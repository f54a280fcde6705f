"""Event-queue execution engine: staleness-aware asynchronous rounds (port
of `repro.train.events`).

The synchronous loop (train/loop.py) advances in ROUNDS: every client
waits at a barrier for the slowest cohort member before the server
applies anything. This engine replaces the barrier with a simulated
event queue on the phase contract (core/phases.py) and the topology
clock (core/topology.py):

  dispatch   a COHORT of clients picks up its replica's current state and
             runs the algorithm's `local` phase jointly on one round batch.
             Each member's finish time is its own: compute seconds from
             its capability (client_compute_seconds) plus the transfer
             seconds of its own links (client_transfer_seconds).
  arrival    members arriving at the same instant form one apply event.
             The server applies the cohort's payload restricted to the
             arrivals (`apply`), then mixes the result into the live state
             FedAsync-style [Xie et al., 2019]:

                 state <- state + w * (applied - state)

             with per-client weights w = staleness_weights(s, decay) on the
             apply-time schedule (`ClientSchedule.staleness`), s counting
             the applies that landed since the cohort was dispatched.
             Updates staler than `max_staleness` are dropped. Shared
             components commit at the cohort's FIRST arrival only;
             per-client rows commit as their owners arrive. Which leaves
             are rows comes from the algorithm's `client_axes`.
  redispatch arrivals pick up the freshest state as a new cohort at once.

Synchronous degeneration: under uniform capability, ideal links and a
full cohort every member arrives at the same instant, so each apply event
is a whole-cohort first arrival with staleness 0 and takes the unweighted
path, `apply(state, local(state, batch, sched), sched)`: the synchronous
`round_fn`, bit for bit.

Multi-server topologies keep one state per server replica; each replica
runs its own cohort cycle over the clients attached to it, and the
replicas merge every `topo.sync_every` completed rounds on every replica
(`sync_replicas`).

How the port maps the reference's jitted engine:

  * every apply's update goes through K1 as the synchronous round's does
    (mtsl's apply step is one `mtsl_update_multi_` launch; the baselines'
    applies are federation means of payloads their local phases stepped
    through K1), so an mtsl run makes one K1 launch per apply event. The
    FedAsync mix and the replica sync are plain tensor code, as the
    reference's `_build_merge` and `sync_replicas` are.
  * mtsl's apply updates the state it is given in place. A weighted apply
    therefore runs on a copy of the live state, and the mix writes a new
    state; replicas never share tensors.
  * the mixing weights are computed on the host from the numpy schedule
    (no wait for the card).

`EventEngine.snapshot()` serialises the whole clock (sim time, counters,
every in-flight cohort's payload, schedule and pending arrival times,
and on multi-server topologies the replicas) as a tree the msgpack
checkpoint (train/checkpoint.py) stores under extra["events"], so an
async run resumes bit for bit mid-flight (`train(init_state=...,
init_events=...)`). Payloads are stored in the port's layout (the
checkpoint sorts dict keys; mtsl's apply aligns its gradients with the
parameters by key).
"""
from __future__ import annotations

import heapq
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import comm_cost
from repro_torch.core import topology as topology_mod
from repro_torch.core.algorithms import Algorithm, HParams, phase_program
from repro_torch.core.schedule import ClientSchedule, staleness_weights
from repro_torch.utils.convert import state_from_jax, state_to_reference
from repro_torch.utils.tree import tree_map_with_path

PyTree = Any


def _map(fn, tree, *rest):
    """Map `fn` leafwise over trees of dicts, lists, tuples and NamedTuples
    of identical structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)
    return fn(tree, *rest)


def _leaves(tree) -> list:
    out = []
    _map(out.append, tree)
    return out


def _like(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """`out` as a fresh leaf requiring grad iff `x` does (mtsl's parameters
    are leaves that require grad)."""
    return out.requires_grad_() if x.requires_grad else out


def _clone(tree):
    return _map(lambda x: _like(x.detach().clone(), x) if torch.is_tensor(x) else x,
                tree)


class _Cohort:
    """One in-flight dispatched cohort: its joint local-phase payload, the
    dispatch-time schedule, and arrival bookkeeping."""

    __slots__ = ("cid", "members", "replica", "version", "sched", "payload",
                 "applied_any", "pending")

    def __init__(self, cid, members, replica, version, sched, payload,
                 applied_any=False, pending=None):
        self.cid = cid
        self.members = tuple(int(m) for m in members)
        self.replica = int(replica)
        self.version = int(version)  # engine apply count at dispatch
        self.sched = sched
        self.payload = payload
        self.applied_any = bool(applied_any)
        self.pending = len(self.members) if pending is None else int(pending)


def _state_marks(alg: Algorithm, state: PyTree) -> PyTree:
    """Bool tree marking [M, ...] client-axis leaves (all False when the
    algorithm declares none)."""
    if alg.client_axes is None:
        return tree_map_with_path(lambda _p, _x: False, state)
    return alg.client_axes(state)


def _build_merge(marks: PyTree, decay: float, max_staleness: Optional[int]):
    """The engine's staleness mixer: state <- state + w·(applied - state).

    Per-client rows use per-client weights w[m] = mask[m]·decay^s[m]
    (non-arrived rows hold exactly); shared leaves use the event's scalar
    weight gated by `shared_on` (1.0 only at the cohort's first arrival).
    Integer leaves do not mix: shared ints (step counters) take the applied
    value when shared commits, row ints (cluster maps) hold. The weights
    are host tensors from the numpy schedule."""

    @torch.no_grad()
    def merge(state, new, sched: ClientSchedule, shared_on: float):
        w = staleness_weights(torch.as_tensor(np.asarray(sched.staleness)),
                              decay, max_staleness)
        w = w * torch.as_tensor(np.asarray(sched.mask, np.float32))  # [M]
        shared_w = w.max() * shared_on
        commit = bool(shared_w > 0)

        def mix(x, n, is_row):
            if not torch.is_tensor(x):
                return n if commit and not is_row else x
            if not x.is_floating_point():
                return x if is_row or not commit else n
            if is_row:
                ww = w.to(x.device).reshape((w.shape[0],) + (1,) * (x.ndim - 1))
                return _like(x + ww.to(x.dtype) * (n - x), x)
            return _like(x + shared_w.to(x.device, x.dtype) * (n - x), x)

        return _map(mix, state, new, marks)

    return merge


@torch.no_grad()
def sync_replicas(states: list, marks: PyTree, attach, avg_all: bool) -> list:
    """Merge S replica states into one synced state and give every replica
    its own copy of it.

    avg_all (fedavg family: every [M, ...] row is a copy of one global
    model): all float leaves average elementwise, ints take replica 0.
    Otherwise shared float leaves average, shared ints take replica 0, and
    client-axis rows come from each client's OWNER replica (the one it
    attaches to): a replica's view of a foreign client's row is stale by
    construction."""
    S = len(states)
    if S == 1:
        return states
    own = torch.as_tensor(np.asarray(attach, np.int64))

    def merge(is_row, *leaves):
        x = leaves[0]
        if not torch.is_tensor(x):
            return x
        if is_row and not avg_all:
            stacked = torch.stack(leaves)  # [S, M, ...]
            rows = torch.arange(own.shape[0], device=x.device)
            return _like(stacked[own.to(x.device), rows], x)
        if x.is_floating_point():
            return _like(torch.stack(leaves).mean(0), x)
        return x

    merged = _map(merge, marks, *states)
    return [merged] + [_clone(merged) for _ in range(S - 1)]


def _from_stored(tree, device):
    """A loaded payload with its arrays as tensors on `device`."""
    if isinstance(tree, dict):
        return {k: _from_stored(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_from_stored(v, device) for v in tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_from_stored(v, device) for v in tree))
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(np.array(tree)).to(device)
    if torch.is_tensor(tree):
        return tree.to(device)
    return tree


def _host_schedule(sched) -> ClientSchedule:
    """A loaded schedule with writable numpy fields."""
    return ClientSchedule(*(None if x is None else np.array(x) for x in sched))


class EventEngine:
    """The asynchronous executor for one algorithm on one topology.

    Drive it with `run(pairs, max_dispatches)`, a generator over apply
    events, where `pairs` yields (round_batch, ClientSchedule) in dispatch
    order. The engine consumes one pair per cohort dispatch (so an async
    run and a synchronous run of R rounds see the same R batches and
    schedule draws) and keeps yielding until every in-flight cohort has
    drained.
    """

    def __init__(self, alg: Algorithm, model, num_clients: int, hp: HParams,
                 topo, *, staleness_decay: float = 1.0,
                 max_staleness: Optional[int] = None,
                 time_per_sample_s: float = 1e-3,
                 init_state: PyTree = None, snapshot: Optional[dict] = None):
        self.alg = alg
        self.model = model
        self.M = int(num_clients)
        self.hp = hp
        self.topo = topo
        self.decay = float(staleness_decay)
        self.max_staleness = (None if max_staleness is None
                              else int(max_staleness))
        self.tps = float(time_per_sample_s)
        self.spr = alg.steps_per_round(hp)
        self.cfg = model.cfg
        self.tower_params, self.total_params = comm_cost.model_param_counts(model)

        prog = phase_program(alg, model, num_clients, hp)
        self._local, self._apply = prog.local, prog.apply

        self.S = topo.num_servers
        self.attach = tuple(topo.attach) if topo.attach else (0,) * self.M
        self.groups = [tuple(m for m in range(self.M) if self.attach[m] == r)
                       for r in range(self.S)]
        self.sync_every = max(int(getattr(topo, "sync_every", 1)), 1)

        self.marks = _state_marks(alg, init_state)
        self._merge = _build_merge(self.marks, self.decay, self.max_staleness)
        self.device = next(x for x in _leaves(init_state) if torch.is_tensor(x)).device

        # replicas never share tensors: mtsl's apply updates in place
        self.replicas = [init_state] + [_clone(init_state)
                                        for _ in range(self.S - 1)]
        self.heap: list = []
        self.cohorts: dict = {}
        self.t = 0.0
        self.applies = 0
        self.dispatches = 0
        self.dropped = 0
        self.next_seq = 0
        self.next_cid = 0
        self.rounds_done = [0] * self.S
        self.next_sync_at = self.sync_every
        self.total = 0
        if snapshot is not None:
            self._restore(snapshot)

    # -- persistence --------------------------------------------------------

    def snapshot(self) -> dict:
        """The whole engine clock as a checkpointable tree: counters plus
        every in-flight cohort's payload, schedule, and pending per-member
        arrival times (and the replicas, on multi-server topologies)."""
        pend: dict = {c: [] for c in self.cohorts}
        for (t, seq, cid, m) in self.heap:
            pend[cid].append([float(t), int(seq), int(m)])
        snap = {
            "sim_time": float(self.t),
            "applies": int(self.applies),
            "dispatches": int(self.dispatches),
            "dropped": int(self.dropped),
            "next_seq": int(self.next_seq),
            "next_cid": int(self.next_cid),
            "rounds_done": [int(x) for x in self.rounds_done],
            "next_sync_at": int(self.next_sync_at),
            "cohorts": [
                {
                    "cid": int(c.cid),
                    "members": [int(m) for m in c.members],
                    "replica": int(c.replica),
                    "version": int(c.version),
                    "applied_any": bool(c.applied_any),
                    "pending": sorted(pend[c.cid]),
                    "sched": c.sched,
                    "payload": c.payload,
                }
                for c in self.cohorts.values()
            ],
        }
        if self.S > 1:
            snap["replicas"] = [
                self.alg.state_to_tree(state_to_reference(self.alg.name, s, self.cfg))
                for s in self.replicas]
        return snap

    def _restore(self, snap: dict) -> None:
        self.t = float(snap["sim_time"])
        self.applies = int(snap["applies"])
        self.dispatches = int(snap["dispatches"])
        self.dropped = int(snap.get("dropped", 0))
        self.next_seq = int(snap["next_seq"])
        self.next_cid = int(snap["next_cid"])
        self.rounds_done = [int(x) for x in snap["rounds_done"]]
        self.next_sync_at = int(snap["next_sync_at"])
        if "replicas" in snap:
            self.replicas = [
                state_from_jax(self.alg.name, self.alg.state_from_tree(t),
                               self.device, self.cfg)
                for t in snap["replicas"]]
        for ce in snap["cohorts"]:
            c = _Cohort(ce["cid"], ce["members"], ce["replica"], ce["version"],
                        _host_schedule(ce["sched"]),
                        _from_stored(ce["payload"], self.device),
                        applied_any=ce["applied_any"], pending=len(ce["pending"]))
            self.cohorts[c.cid] = c
            for t, seq, m in ce["pending"]:
                heapq.heappush(self.heap, (float(t), int(seq), c.cid, int(m)))

    # -- the clock ----------------------------------------------------------

    def _member_times(self, sched: ClientSchedule, width: int) -> np.ndarray:
        """[M] seconds from dispatch to arrival: capability compute plus the
        client's own link transfers (not the cohort max: that is the
        barrier this engine removes)."""
        sizes = None if sched.sizes is None else np.asarray(sched.sizes)
        compute = topology_mod.client_compute_seconds(
            self.topo, local_steps=self.spr, samples_per_step=width,
            time_per_sample_s=self.tps, budget=np.asarray(sched.budget),
            sizes=sizes)
        transfer = np.zeros(self.M, np.float64)
        if self.alg.round_events is not None:
            mask = np.asarray(sched.mask, np.float64)
            # bill the cohort's actual participants: explicit sizes map
            # each event to its client
            ev_sizes = (sizes if sizes is not None
                        else ((mask > 0) * max(width, 1)).astype(np.int64))
            events = self.alg.round_events(
                self.topo, self.cfg, self.M, width, self.hp,
                tower_params=self.tower_params,
                total_params=self.total_params,
                num_participants=int((mask > 0).sum()), sizes=ev_sizes,
                sync_round=False)
            transfer = topology_mod.client_transfer_seconds(self.topo, events)
        return compute + transfer

    # -- dispatch / apply ----------------------------------------------------

    def _dispatch(self, members, replica: int, t: float, pairs) -> bool:
        if self.dispatches >= self.total:
            return False
        try:
            batch, sched = next(pairs)
        except StopIteration:
            self.total = self.dispatches
            return False
        width = next(iter(batch.values())).shape[1] // self.spr
        if len(members) < self.M:
            mmask = np.zeros(self.M, np.float32)
            mmask[list(members)] = 1.0
            sched = sched._replace(mask=np.asarray(sched.mask, np.float32) * mmask)
        payload = self._local(self.replicas[replica], batch, sched)
        times = self._member_times(sched, width)
        c = _Cohort(self.next_cid, members, replica, self.applies, sched, payload)
        self.next_cid += 1
        self.cohorts[c.cid] = c
        for m in c.members:
            heapq.heappush(self.heap, (t + float(times[m]), self.next_seq, c.cid, m))
            self.next_seq += 1
        self.dispatches += 1
        return True

    def _pop_event(self):
        """Next apply event: all same-cohort entries at the exactly-equal
        earliest time (under uniform capability and ideal links the whole
        cohort lands in one event: the synchronous degeneration)."""
        t, seq, cid, m = heapq.heappop(self.heap)
        group = [m]
        while self.heap and self.heap[0][0] == t and self.heap[0][2] == cid:
            group.append(heapq.heappop(self.heap)[3])
        return t, cid, group

    def _maybe_sync(self) -> bool:
        if self.S <= 1:
            return False
        synced = False
        while min(self.rounds_done) >= self.next_sync_at:
            self.replicas = sync_replicas(self.replicas, self.marks, self.attach,
                                          self.alg.replica_avg_all)
            self.next_sync_at += self.sync_every
            synced = True
        return synced

    def state(self) -> PyTree:
        """The engine's servable / evaluable state: the (synced view of
        the) replica states."""
        if self.S == 1:
            return self.replicas[0]
        return sync_replicas(self.replicas, self.marks, self.attach,
                             self.alg.replica_avg_all)[0]

    def run(self, pairs, max_dispatches: int) -> Iterator[dict]:
        """Generator over apply events.

        Dispatches up to `max_dispatches` cohorts in all (each consuming one
        (batch, schedule) pair), then drains the in-flight arrivals. Yields
        one record per arrival event: sim_time, the applies / dispatches
        counters, the apply's metrics (None for staleness-dropped or
        participant-free events), the arrived participant count, the
        event's staleness, and whether the cohort completed."""
        self.total = int(max_dispatches)
        pairs = iter(pairs)
        if not self.heap and not self.cohorts:
            for r in range(self.S):
                if self.groups[r]:
                    self._dispatch(self.groups[r], r, self.t, pairs)
        while self.heap:
            t, cid, group = self._pop_event()
            c = self.cohorts[cid]
            self.t = t
            c.pending -= len(group)
            s = self.applies - c.version
            first = not c.applied_any
            state = self.replicas[c.replica]
            mask_np = np.asarray(c.sched.mask, np.float32)
            gmask = np.zeros(self.M, np.float32)
            gmask[group] = 1.0
            participants = int((mask_np * gmask).sum())
            metrics = None
            dropped = False
            if participants == 0:
                pass  # only masked-out members arrived: nothing to apply
            elif self.max_staleness is not None and s > self.max_staleness:
                dropped = True
                self.dropped += 1
            elif first and len(group) == len(c.members) and s == 0:
                # the synchronous degeneration: the whole cohort, fresh —
                # bit for bit the round's apply
                state, metrics = self._apply(state, c.payload, c.sched)
                self.replicas[c.replica] = state
                c.applied_any = True
                self.applies += 1
            else:
                asched = c.sched._replace(
                    mask=mask_np * gmask,
                    staleness=np.full((self.M,), s, np.int32))
                new, metrics = self._apply(_clone(state), c.payload, asched)
                self.replicas[c.replica] = self._merge(
                    state, new, asched, 1.0 if first else 0.0)
                c.applied_any = True
                self.applies += 1
            done = c.pending == 0
            if done:
                del self.cohorts[cid]
                self.rounds_done[c.replica] += 1
                self._maybe_sync()
            # re-dispatch BEFORE yielding so a snapshot() taken at the
            # yield point captures a consistent clock
            self._dispatch(tuple(group), c.replica, t, pairs)
            yield {
                "sim_time": self.t,
                "applies": self.applies,
                "dispatches": self.dispatches,
                "metrics": metrics,
                "participants": participants,
                "staleness": s,
                "dropped": dropped,
                "cohort_done": done,
            }
