"""First-class edge network topology: explicit client/server/link graphs
(a copy of `repro.core.topology`, which is numpy only).

The paper's pitch is the "flexibility of distributed network architectures"
— but a flat byte count cannot express WHERE those bytes travel or how long
they take. This module makes the deployment graph a value:

  Topology   client nodes (carrying the capability profile that
             core/schedule.py consumes), client-facing edge servers, an
             optional aggregation core, and directed `Link`s with
             `bandwidth_bytes_per_s` / `latency_s`. Constructors:

               star(M)             M clients <-> one central server — every
                                   algorithm's classic deployment.
               clustered(M, C)     ParallelSFL's graph: C peer cluster
                                   servers, each serving M/C clients,
                                   merging replicas over a backbone core.
               hierarchical(M, C)  C edge aggregators under one cloud root;
                                   clients attach to contiguous edges.
               multi_server(M, S)  S PEER servers that periodically sync;
                                   clients attach to the nearest server —
                                   a genuinely new MTSL scenario (the
                                   shared server becomes S synced replicas).

  TrafficEvent   one directed transfer of `bytes` from `src` to `dst`
                 during serial `phase` p of a round. An algorithm's round
                 is a list of events (emitted by its registration's
                 `round_events` / comm_cost.traffic_events); byte billing
                 is a generic fold over them (comm_cost.
                 round_cost_from_events) and the simulated clock is
                 `round_walltime` below.

  round_walltime  per-round simulated wall-clock: per-client compute time
                  (local steps x microbatch / capability) + per-link
                  transfer time (bytes/bandwidth + latency), MAX over
                  events in the same phase (parallel paths), SUM over
                  phases (serial dependencies).

Semantics that make the legacy analytic model a special case:

  * Byte accounting is ALGORITHM-intrinsic: an emitted event is real
    network traffic between distinct logical entities whether or not the
    topology models the link (ParallelSFL's C replica merges are billed on
    star(M) exactly as core/comm_cost.py always billed them). SMoFi's
    momentum fusion emits NO events — its replicas are co-located.
  * Link physics are TOPOLOGY-intrinsic: a transfer between entities the
    topology does not separate rides an implicit infinite-bandwidth,
    zero-latency link (`Topology.link` falls back to `DEFAULT_LINK`), so
    star(M) with default links reproduces the pre-redesign byte counts
    exactly while costing zero simulated transfer time.

The training math is untouched: a Topology is a simulation overlay for
placement, billing and the clock. For multi_server with sync_every=1 the
replicas see identical aggregated updates every step, so the fully-synced
trajectory the loop computes is exact; larger sync intervals are an
accounting approximation (documented where used).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Mapping, Optional, Sequence

import numpy as np

INF = math.inf

#: directions a TrafficEvent can be billed under (RoundCost buckets)
UP, DOWN, PEER = "up", "down", "peer"


@dataclass(frozen=True)
class Link:
    """A directed network link. Defaults model an ideal wire."""

    bandwidth_bytes_per_s: float = INF
    latency_s: float = 0.0

    def transfer_s(self, nbytes: int) -> float:
        """Seconds to move `nbytes` across this link (0 bytes is free —
        no transfer happens, so no latency is paid)."""
        if nbytes <= 0:
            return 0.0
        return nbytes / self.bandwidth_bytes_per_s + self.latency_s


DEFAULT_LINK = Link()


def mbps(megabits_per_s: float, latency_s: float = 0.0) -> Link:
    """Convenience: a link specified in megabits per second."""
    if megabits_per_s <= 0:
        return Link(INF, latency_s)
    return Link(megabits_per_s * 1e6 / 8.0, latency_s)


@dataclass(frozen=True)
class TrafficEvent:
    """One directed transfer within a round.

    src/dst name topology nodes — or purely LOGICAL entities (e.g.
    ParallelSFL replica nodes on a star topology); unknown pairs resolve
    to DEFAULT_LINK. `phase` orders serial dependencies: events sharing a
    phase run in parallel (walltime takes their max), distinct phases run
    serially (walltime sums). `direction` buckets the bytes for RoundCost:
    "up" toward servers, "down" toward clients, "peer" between same-tier
    servers.
    """

    src: str
    dst: str
    bytes: int
    phase: int = 0
    direction: str = UP


@dataclass(frozen=True)
class Topology:
    """An edge deployment graph (a value — cheap to build, compare, copy).

    clients/servers are node names; `attach[m]` is the index of client m's
    serving edge server; `core` names the aggregation root, when the graph
    has one (clustered/hierarchical). `capability` is the per-client
    relative compute speed profile in (0, 1] that core/schedule.py
    otherwise draws — None means "unspecified" (schedule config decides).
    `sync_every` is the peer-server sync period in rounds (multi_server).
    """

    name: str
    clients: tuple[str, ...]
    servers: tuple[str, ...]
    links: Mapping[tuple[str, str], Link] = field(default_factory=dict)
    attach: tuple[int, ...] = ()
    capability: Optional[tuple[float, ...]] = None
    core: Optional[str] = None
    sync_every: int = 1

    def __post_init__(self):
        if not self.servers:
            raise ValueError("a Topology needs at least one server")
        if self.attach and len(self.attach) != len(self.clients):
            raise ValueError(
                f"attach has {len(self.attach)} entries for "
                f"{len(self.clients)} clients")
        if self.capability is not None and (
                len(self.capability) != len(self.clients)):
            raise ValueError(
                f"capability profile has {len(self.capability)} entries for "
                f"{len(self.clients)} clients")

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    @property
    def num_servers(self) -> int:
        return len(self.servers)

    def client(self, m: int) -> str:
        return self.clients[m]

    def server_of(self, m: int) -> str:
        """Client m's serving edge server."""
        return self.servers[self.attach[m] if self.attach else 0]

    def link(self, src: str, dst: str) -> Link:
        """The declared link src->dst, or the ideal DEFAULT_LINK for pairs
        the topology does not separate (co-located / logical entities)."""
        return self.links.get((src, dst), DEFAULT_LINK)

    def with_capability(self, capability) -> "Topology":
        cap = tuple(float(c) for c in np.asarray(capability).reshape(-1))
        return replace(self, capability=cap)

    def capability_array(self) -> np.ndarray:
        """[M] capability profile (all-ones when unspecified)."""
        if self.capability is None:
            return np.ones((self.num_clients,), np.float64)
        return np.asarray(self.capability, np.float64)


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------


def _client_names(M: int) -> tuple[str, ...]:
    return tuple(f"client{m}" for m in range(M))


def _access_links(clients, servers, attach, uplink, downlink):
    links = {}
    for m, c in enumerate(clients):
        s = servers[attach[m]]
        links[(c, s)] = uplink
        links[(s, c)] = downlink
    return links


def star(
    M: int,
    *,
    uplink: Link = DEFAULT_LINK,
    downlink: Link = DEFAULT_LINK,
    capability=None,
) -> Topology:
    """M clients around one central server — the classic deployment of
    every algorithm in the registry. With default (ideal) links this
    reproduces the legacy analytic byte model exactly."""
    clients = _client_names(M)
    servers = ("server0",)
    attach = (0,) * M
    return Topology(
        name="star", clients=clients, servers=servers,
        links=_access_links(clients, servers, attach, uplink, downlink),
        attach=attach,
        capability=None if capability is None else tuple(capability),
    )


def clustered(
    M: int,
    C: int,
    *,
    uplink: Link = DEFAULT_LINK,
    downlink: Link = DEFAULT_LINK,
    backbone: Link = DEFAULT_LINK,
    capability=None,
) -> Topology:
    """ParallelSFL's deployment: C peer cluster servers, clients assigned
    round-robin (matching federation.cluster_assignment's default map), and
    a backbone core over which the per-cluster replicas merge each round."""
    C = max(1, min(C, M))
    clients = _client_names(M)
    servers = tuple(f"server{c}" for c in range(C))
    attach = tuple(m % C for m in range(M))
    links = _access_links(clients, servers, attach, uplink, downlink)
    core = "core"
    for s in servers:
        links[(s, core)] = backbone
        links[(core, s)] = backbone
    return Topology(
        name="clustered", clients=clients, servers=servers, links=links,
        attach=attach, core=core,
        capability=None if capability is None else tuple(capability),
    )


def hierarchical(
    M: int,
    C: int,
    *,
    uplink: Link = DEFAULT_LINK,
    downlink: Link = DEFAULT_LINK,
    backbone: Link = DEFAULT_LINK,
    capability=None,
) -> Topology:
    """C edge aggregators under one cloud root; clients attach to their
    region's edge server in contiguous blocks (geographic locality)."""
    C = max(1, min(C, M))
    clients = _client_names(M)
    servers = tuple(f"edge{c}" for c in range(C))
    block = -(-M // C)  # ceil: contiguous regions
    attach = tuple(min(m // block, C - 1) for m in range(M))
    links = _access_links(clients, servers, attach, uplink, downlink)
    core = "cloud"
    for s in servers:
        links[(s, core)] = backbone
        links[(core, s)] = backbone
    return Topology(
        name="hierarchical", clients=clients, servers=servers, links=links,
        attach=attach, core=core,
        capability=None if capability is None else tuple(capability),
    )


def multi_server(
    M: int,
    S: int,
    *,
    uplink: Link = DEFAULT_LINK,
    downlink: Link = DEFAULT_LINK,
    backbone: Link = DEFAULT_LINK,
    capability=None,
    sync_every: int = 1,
) -> Topology:
    """S PEER servers that periodically sync; client m (at position m/M on
    a line) attaches to the NEAREST server (at (s+0.5)/S) — the new MTSL
    scenario: one logical shared server deployed as S synced replicas, each
    close to its clients. Backbone links connect every ordered server pair;
    `sync_every` is the replica sync period in rounds."""
    S = max(1, min(S, M))
    clients = _client_names(M)
    servers = tuple(f"server{s}" for s in range(S))
    positions = [(s + 0.5) / S for s in range(S)]
    attach = tuple(
        min(range(S), key=lambda s: abs((m + 0.5) / M - positions[s]))
        for m in range(M))
    links = _access_links(clients, servers, attach, uplink, downlink)
    for a in servers:
        for b in servers:
            if a != b:
                links[(a, b)] = backbone
    return Topology(
        name="multi_server", clients=clients, servers=servers, links=links,
        attach=attach, sync_every=max(int(sync_every), 1),
        capability=None if capability is None else tuple(capability),
    )


TOPOLOGIES = ("star", "clustered", "hierarchical", "multi_server")


def build_topology(kind: str, M: int, *, num_servers: int = 2,
                   uplink: Link = DEFAULT_LINK, downlink: Link = DEFAULT_LINK,
                   backbone: Link = DEFAULT_LINK, capability=None,
                   sync_every: int = 1) -> Topology:
    """Name-driven constructor (the launcher's --topology entry point)."""
    kind = kind.replace("-", "_")
    if kind == "star":
        return star(M, uplink=uplink, downlink=downlink,
                    capability=capability)
    if kind == "clustered":
        return clustered(M, num_servers, uplink=uplink, downlink=downlink,
                         backbone=backbone, capability=capability)
    if kind == "hierarchical":
        return hierarchical(M, num_servers, uplink=uplink, downlink=downlink,
                            backbone=backbone, capability=capability)
    if kind == "multi_server":
        return multi_server(M, num_servers, uplink=uplink, downlink=downlink,
                            backbone=backbone, capability=capability,
                            sync_every=sync_every)
    raise ValueError(f"unknown topology {kind!r}; have {TOPOLOGIES}")


# ---------------------------------------------------------------------------
# the simulated wall-clock model
# ---------------------------------------------------------------------------


def client_compute_seconds(
    topo: Topology,
    *,
    local_steps: int,
    samples_per_step: int,
    time_per_sample_s: float,
    mask=None,
    budget=None,
    sizes=None,
) -> np.ndarray:
    """[M] per-client compute seconds for one round.

    Client m runs `budget[m]` (default `local_steps`) local steps of
    `sizes[m]` (default `samples_per_step`) samples, each sample costing
    `time_per_sample_s` at unit speed, slowed by its capability:

        t_m = steps_m * samples_m * time_per_sample_s / capability_m

    Masked-out clients (mask[m] == 0) cost exactly 0 — they sit the round
    out. `mask`/`budget`/`sizes` accept the matching ClientSchedule fields.
    """
    M = topo.num_clients
    cap = np.maximum(topo.capability_array(), 1e-9)
    steps = (np.full(M, max(local_steps, 1), np.float64) if budget is None
             else np.asarray(budget, np.float64))
    samples = (np.full(M, max(samples_per_step, 0), np.float64)
               if sizes is None else np.asarray(sizes, np.float64))
    t = steps * samples * float(time_per_sample_s) / cap
    if mask is not None:
        t = t * (np.asarray(mask, np.float64) > 0)
    return t


def round_walltime(
    topo: Topology,
    events: Sequence[TrafficEvent],
    *,
    compute_s=None,
) -> float:
    """Simulated seconds for one round on `topo`.

    Transfer time: per event `bytes/bandwidth + latency` on its link;
    events sharing a phase are parallel paths (max), phases are serial
    (sum). Compute time (`compute_s`: scalar, per-client array, or None)
    is a serial phase of its own — the synchronous-round barrier waits for
    the slowest client — preceding the round's communication. With ideal
    (infinite-bandwidth, zero-latency) links the round is exactly
    compute-bound; with zero compute it is exactly the sum over phases of
    the slowest parallel transfer.
    """
    phase_time: dict[int, float] = {}
    for e in events:
        t = topo.link(e.src, e.dst).transfer_s(e.bytes)
        if t > phase_time.get(e.phase, 0.0):
            phase_time[e.phase] = t
    comm = float(sum(phase_time.values()))
    comp = 0.0
    if compute_s is not None:
        arr = np.asarray(compute_s, np.float64).reshape(-1)
        comp = float(arr.max()) if arr.size else 0.0
    return comp + comm


def client_transfer_seconds(
    topo: Topology,
    events: Sequence[TrafficEvent],
) -> np.ndarray:
    """[M] per-CLIENT transfer seconds for one round's events.

    Where `round_walltime` folds events into ONE barrier time (max over a
    phase, sum over phases — every client waits for the slowest path), this
    is the event engine's view: client m only waits for the transfers it is
    an endpoint of. Within a phase a client's transfers are parallel (max);
    across phases they are serial (sum). Events between servers only (e.g.
    replica-merge backbone traffic) belong to no client and don't appear —
    the engine bills those to the apply side, not to client arrivals.
    """
    idx = {name: m for m, name in enumerate(topo.clients)}
    per: dict[tuple[int, int], float] = {}
    for e in events:
        m = idx.get(e.src, idx.get(e.dst))
        if m is None:
            continue
        t = topo.link(e.src, e.dst).transfer_s(e.bytes)
        key = (m, e.phase)
        if t > per.get(key, 0.0):
            per[key] = t
    out = np.zeros((topo.num_clients,), np.float64)
    for (m, _), t in per.items():
        out[m] += t
    return out
