"""Edge-network communication accounting (paper Fig. 3b), event-based
(port of `repro.core.comm_cost`; pure Python over the port's configs and
topologies, the parameter counts from the port's own inits).

Every algorithm's round is declared as per-link `TrafficEvent`s against an
explicit `core.topology.Topology` (traffic_events below; the Algorithm
registry re-exposes them as `Algorithm.round_events`). Byte billing is then
ONE generic fold (`round_cost_from_events`) instead of seven hand-derived
formulas, and the same events drive the simulated wall-clock model
(`topology.round_walltime`).

Per-round traffic, as emitted (P participants, n_m samples from client m):

  MTSL     up:  n_m·(|s| + |y|) per client      (smashed data + labels)
           down: n_m·|s| per client              (activation gradients)
  SplitFed k MTSL exchanges + tower federation: |psi| up + |psi| down
           per participant
  FedAvg   |theta| up + |theta| down per participant
  FedProx  same as FedAvg (the proximal term is computed locally)
  FedEM    K·|theta| each way per participant    (K components)
  SMoFi    k split exchanges + tower federation; the step-wise momentum
           fusion happens between CO-LOCATED server replicas, so it emits
           no events and is free
  ParallelSFL  k split exchanges + within-cluster tower federation + the
           per-cluster server-replica merge: the C cluster servers are
           DISTINCT edge entities, so each uploads |theta_s| to the merge
           hub and downloads the merged result — billed on EVERY topology
           (on star(M) the replicas are logical nodes riding ideal links:
           bytes counted, zero transfer time)

Shared-server algorithms deployed on a topology with SEVERAL client-facing
servers (clustered / hierarchical / multi_server) additionally sync the
replicated server state once per round (`_sync_events`): via the
aggregation core when the graph has one, else pairwise over the peer
backbone. star(M) has one server, so the legacy analytic byte counts are
reproduced EXACTLY — `round_cost(algorithm=...)` below is now a thin shim
folding the events on star(M), pinned by goldens in tests/test_topology.py.

|s| = d_model elements per token/sample at the split boundary; this
module is the paper-faithful *edge* model.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.core.topology import DOWN, PEER, UP, Topology, TrafficEvent, star
from repro_torch.utils import tree as tu

ALGORITHMS = ("mtsl", "splitfed", "fedavg", "fedprox", "fedem", "smofi",
              "parallelsfl")


@dataclass(frozen=True)
class RoundCost:
    up_bytes: int
    down_bytes: int
    peer_bytes: int = 0  # same-tier server<->server traffic (multi_server)

    @property
    def total(self) -> int:
        return self.up_bytes + self.down_bytes + self.peer_bytes


def _smashed_elems(cfg: ModelConfig, batch_per_client: int, seq_len: int = 1) -> int:
    if cfg.family == "mlp":
        return batch_per_client * cfg.mlp_dims[cfg.split_layers]
    if cfg.family == "resnet":
        # spatial map after the stem (stride 1) and `split_layers` stages:
        # stage 0 keeps resolution, each later stage opens with a stride-2
        # SAME conv, i.e. CEIL division per stage (verified against real
        # tower_forward shapes in tests/test_comm_cost.py)
        hw = cfg.image_size
        for _ in range(max(cfg.split_layers - 1, 0)):
            hw = -(-hw // 2)
        c = cfg.resnet_stages[cfg.split_layers - 1][0]
        return batch_per_client * hw * hw * c
    if cfg.family == "encdec":
        return batch_per_client * cfg.encoder_seq * cfg.d_model
    return batch_per_client * seq_len * cfg.d_model


def params_count(tree) -> int:
    return tu.tree_size(tree)


def model_param_counts(model) -> tuple[int, int]:
    """(tower_params, total_params) element counts for a registry model —
    the two quantities every traffic generator is parameterized by. The
    inits run on the meta device (`nn.init.abstract_params`), so a full
    config allocates nothing."""
    import torch

    from repro_torch.nn.init import abstract_params

    gen = torch.Generator()
    with abstract_params():
        tower = tu.tree_size(model.init_tower(gen))
        total = tower + tu.tree_size(model.init_server(gen))
    return tower, total


# ---------------------------------------------------------------------------
# per-algorithm traffic generators
# ---------------------------------------------------------------------------


def _per_client_samples(M: int, P: int, batch_per_client: int,
                        samples_per_step, sizes) -> list[tuple[int, int]]:
    """[(client index, samples per local step)] for the round's participants.

    With an explicit per-client `sizes` vector (capability-aware batch
    sizing), clients with a positive size are the participants. With only a
    TOTAL `samples_per_step`, it is split among the first P clients so the
    sum is EXACT (largest-remainder: S//P each, first S%P get one more).
    Default: the first P clients at `batch_per_client` each.
    """
    if sizes is not None:
        return [(m, int(n)) for m, n in enumerate(sizes) if int(n) > 0]
    if samples_per_step is not None:
        S = max(int(samples_per_step), 0)
        base, extra = divmod(S, P)
        return [(m, base + (1 if m < extra else 0)) for m in range(P)]
    return [(m, batch_per_client) for m in range(P)]


def _split_exchange(topo, parts, s1, lab1, phase, events):
    """One split-learning step: smashed+labels up, activation grads down."""
    for m, n in parts:
        if n > 0:
            events.append(TrafficEvent(topo.client(m), topo.server_of(m),
                                       n * (s1 + lab1), phase, UP))
    for m, n in parts:
        if n > 0:
            events.append(TrafficEvent(topo.server_of(m), topo.client(m),
                                       n * s1, phase + 1, DOWN))
    return phase + 2


def _fed_exchange(topo, parts, nbytes, phase, events):
    """One parameter federation: every participant uploads `nbytes` to its
    server and downloads the aggregate."""
    for m, _ in parts:
        events.append(TrafficEvent(topo.client(m), topo.server_of(m),
                                   nbytes, phase, UP))
    for m, _ in parts:
        events.append(TrafficEvent(topo.server_of(m), topo.client(m),
                                   nbytes, phase + 1, DOWN))
    return phase + 2


def _sync_events(topo, nbytes, phase, events, nodes=None, hub=None):
    """Sync replicated state of `nodes` (default: the topology's servers):
    via the aggregation core when the graph has one (up to the hub, merged
    result back down), else pairwise over the peer backbone (one parallel
    phase). Returns the next free phase."""
    nodes = list(topo.servers) if nodes is None else list(nodes)
    hub = hub if hub is not None else topo.core
    if hub is not None:
        for s in nodes:
            events.append(TrafficEvent(s, hub, nbytes, phase, UP))
        for s in nodes:
            events.append(TrafficEvent(hub, s, nbytes, phase + 1, DOWN))
        return phase + 2
    for a in nodes:
        for b in nodes:
            if a != b:
                events.append(TrafficEvent(a, b, nbytes, phase, PEER))
    return phase + 1


def _require(value, what: str, algorithm: str):
    if value is None:
        raise ValueError(f"{algorithm} traffic needs {what}")
    return value


def traffic_events(
    algorithm: str,
    topo: Topology,
    cfg: ModelConfig,
    num_clients: int,
    batch_per_client: int,
    *,
    seq_len: int = 1,
    tower_params: int | None = None,
    total_params: int | None = None,
    server_params: int | None = None,
    bytes_per_elem: int = 4,
    label_bytes: int = 4,
    num_components: int = 3,
    local_steps: int = 1,
    num_clusters: int = 2,
    num_participants: int | None = None,
    samples_per_step: int | None = None,
    sizes=None,
    sync_round: bool = True,
) -> tuple[TrafficEvent, ...]:
    """One round of `algorithm` on `topo`, as per-link TrafficEvents.

    mtsl/splitfed keep their split-exchange semantics per local step;
    fedavg/fedprox/fedem exchange parameters once per round regardless of
    local steps (local compute is free on the network); smofi/parallelsfl
    compose `local_steps` split exchanges with their federation phases.

    `num_participants` bills the round's first P clients (byte totals only
    depend on the count); `sizes` gives exact per-client sample counts
    (capability-aware batch sizing) and overrides both it and
    `samples_per_step` (a total, split exactly across participants).
    `sync_round=False` skips the multi-server replica sync (rounds between
    periodic syncs, `Topology.sync_every`).
    """
    if server_params is None and (tower_params is not None
                                  and total_params is not None):
        server_params = total_params - tower_params
    M = num_clients
    P = M if num_participants is None else max(1, min(num_participants, M))
    parts = _per_client_samples(M, P, batch_per_client, samples_per_step,
                                sizes)
    s1 = _smashed_elems(cfg, 1, seq_len) * bytes_per_elem
    lab1 = max(seq_len, 1) * label_bytes
    multi = topo.num_servers > 1
    events: list[TrafficEvent] = []
    phase = 0

    if algorithm == "mtsl":
        phase = _split_exchange(topo, parts, s1, lab1, phase, events)
        if multi and sync_round:
            nb = _require(server_params, "server_params", algorithm)
            phase = _sync_events(topo, nb * bytes_per_elem, phase, events)
        return tuple(events)

    if algorithm == "splitfed":
        tp = _require(tower_params, "tower_params", algorithm)
        for _ in range(max(local_steps, 1)):
            phase = _split_exchange(topo, parts, s1, lab1, phase, events)
        phase = _fed_exchange(topo, parts, tp * bytes_per_elem, phase, events)
        if multi and sync_round:
            nb = _require(server_params, "server_params", algorithm) + tp
            phase = _sync_events(topo, nb * bytes_per_elem, phase, events)
        return tuple(events)

    if algorithm in ("fedavg", "fedprox"):
        tot = _require(total_params, "total_params", algorithm)
        phase = _fed_exchange(topo, parts, tot * bytes_per_elem, phase,
                              events)
        if multi and sync_round:
            phase = _sync_events(topo, tot * bytes_per_elem, phase, events)
        return tuple(events)

    if algorithm == "fedem":
        tot = _require(total_params, "total_params", algorithm)
        nb = num_components * tot * bytes_per_elem
        phase = _fed_exchange(topo, parts, nb, phase, events)
        if multi and sync_round:
            phase = _sync_events(topo, nb, phase, events)
        return tuple(events)

    if algorithm == "smofi":
        # k split steps against per-client server replicas (co-located, so
        # the step-wise momentum fusion is free) + one tower federation
        tp = _require(tower_params, "tower_params", algorithm)
        for _ in range(max(local_steps, 1)):
            phase = _split_exchange(topo, parts, s1, lab1, phase, events)
        phase = _fed_exchange(topo, parts, tp * bytes_per_elem, phase, events)
        if multi and sync_round:
            nb = _require(server_params, "server_params", algorithm) + tp
            phase = _sync_events(topo, nb * bytes_per_elem, phase, events)
        return tuple(events)

    if algorithm == "parallelsfl":
        # k split steps + within-cluster tower federation + merging the C
        # DISTINCT cluster-server replicas. The replicas map onto the
        # topology's servers when the counts agree (clustered(M, C));
        # otherwise they are logical entities behind the access servers
        # (ideal links — bytes billed, zero transfer time), which is
        # exactly the legacy star(M) accounting.
        tp = _require(tower_params, "tower_params", algorithm)
        sp = _require(server_params, "server_params", algorithm)
        C = max(1, min(num_clusters, M))
        for _ in range(max(local_steps, 1)):
            phase = _split_exchange(topo, parts, s1, lab1, phase, events)
        phase = _fed_exchange(topo, parts, tp * bytes_per_elem, phase, events)
        replicas = (topo.servers if topo.num_servers == C
                    else tuple(f"replica{c}" for c in range(C)))
        # merge routing follows the graph: via the aggregation core when
        # there is one; pairwise over the real peer backbone when the
        # replicas ARE the topology's servers (multi_server); and via a
        # logical hub on ideal links otherwise (star — which also keeps the
        # degenerate C == 1 merge billed exactly as the legacy formulas do)
        if topo.core is None and replicas == topo.servers and C > 1:
            hub = None  # peer path: real backbone links between replicas
        else:
            hub = topo.core or "merge_hub"
        phase = _sync_events(topo, sp * bytes_per_elem, phase, events,
                             nodes=replicas, hub=hub)
        return tuple(events)

    raise ValueError(
        f"unknown algorithm {algorithm!r}; have {ALGORITHMS}")


# ---------------------------------------------------------------------------
# the generic fold + the legacy analytic shim
# ---------------------------------------------------------------------------


def round_cost_from_events(topo: Topology, events) -> RoundCost:
    """Fold TrafficEvents into per-direction byte totals. The topology sets
    the vocabulary the events are written against; byte billing itself is
    link-independent (transfer TIME is topology.round_walltime's job)."""
    up = down = peer = 0
    for e in events:
        if e.direction == UP:
            up += e.bytes
        elif e.direction == DOWN:
            down += e.bytes
        else:
            peer += e.bytes
    return RoundCost(up_bytes=up, down_bytes=down, peer_bytes=peer)


def round_cost(
    algorithm: str,
    cfg: ModelConfig,
    num_clients: int,
    batch_per_client: int,
    seq_len: int = 1,
    tower_params: int | None = None,
    total_params: int | None = None,
    bytes_per_elem: int = 4,
    label_bytes: int = 4,
    num_components: int = 3,
    local_steps: int = 1,
    server_params: int | None = None,
    num_clusters: int = 2,
    num_participants: int | None = None,
    samples_per_step: int | None = None,
) -> RoundCost:
    """Legacy analytic interface: bytes per round on the algorithm's classic
    star(M) deployment. Now a thin shim — fold the algorithm's TrafficEvents
    on star(M) with ideal links; the result is bit-identical to the
    pre-redesign hand-derived formulas (pinned in tests/test_topology.py).

    mtsl/splitfed/fedavg/fedem keep their original one-exchange semantics
    (callers compose local steps themselves); the smofi/parallelsfl branches
    take `local_steps` and return the full round.

    Under partial participation (core/schedule.py) only the round's
    participants exchange traffic (`num_participants`, default all M);
    `samples_per_step` (capability-aware batch sizing) bills the split
    upload/download by the samples ACTUALLY transmitted."""
    topo = star(num_clients)
    k = local_steps if algorithm in ("smofi", "parallelsfl") else 1
    events = traffic_events(
        algorithm, topo, cfg, num_clients, batch_per_client,
        seq_len=seq_len, tower_params=tower_params,
        total_params=total_params, server_params=server_params,
        bytes_per_elem=bytes_per_elem, label_bytes=label_bytes,
        num_components=num_components, local_steps=k,
        num_clusters=num_clusters, num_participants=num_participants,
        samples_per_step=samples_per_step)
    return round_cost_from_events(topo, events)
