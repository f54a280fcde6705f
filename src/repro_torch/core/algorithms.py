"""Algorithm registry (port of `repro.core.algorithms`): one uniform
train/eval/comm interface that the train loop and the launcher drive
without per-algorithm branches. Registered: the paper's `mtsl` and the
six baselines it is compared with (splitfed, fedavg, fedprox, fedem,
smofi, parallelsfl; `core/federation.py`).

An `Algorithm` bundles:
  init_state(model, gen, num_clients, hp) -> state
  round_fn(model, num_clients, hp) -> fn(state, batch, schedule=None)
      -> (state, metrics). `batch` holds `[M, steps_per_round * b, ...]`
      tensors on the state's device (the baselines split it into local
      steps, `split_local_steps`); `schedule` is a core.schedule.
      ClientSchedule (numpy; None = all clients, full budget); `metrics`
      contains "loss".
  eval_fn(model, num_clients) -> fn(state, batch) -> {"acc_mtl", ...}
  round_bytes(cfg, num_clients, batch_per_client, hp, tower_params=...,
      total_params=..., num_participants=..., samples_per_step=...) ->
      bytes per round on star(M), folded from `round_events`
  round_events(topo, cfg, num_clients, batch_per_client, hp, ...) ->
      the round's traffic as per-link core.topology.TrafficEvents, which
      the loop bills and turns into the simulated clock
      (`simulate_round_walltime`)
  steps_per_round(hp) -> gradient steps one round advances
  phases(model, num_clients, hp) -> core.phases.PhaseProgram, whose
      composition is round_fn
  state_to_tree / state_from_tree, serve_params, uses_optimizer,
  donate_state, client_axes, replica_avg_all, description: as the
      reference declares them (client_axes marks the leaves with a leading
      client axis; nothing in the port shards over a mesh yet).

The reference jits the round and donates the state's buffers
(`jit_round_fn`). Here `round_fn`'s result runs eagerly: mtsl's apply step
updates the state's parameters in place; the baselines step copies of
them in place (through K1) and return the new state.

`phase_program` builds an algorithm's declared phases (the event engine,
train/events.py, drives them). `shard_round_fn(..., client_chunk=c)` is
the client-chunk half of the reference's: the round runs under
`core.client_axis.client_axis(chunk=c)`, so every per-client map in it
goes over M/c blocks. Mesh sharding is not ported (`mesh=` raises).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import comm_cost, federation, lr_policy, topology
from repro_torch.core.client_axis import client_axis
from repro_torch.core.mtsl import (
    TrainState,
    build_eval_step,
    build_train_phases,
    build_train_step,
    init_state as mtsl_init_params,
)
from repro_torch.core.phases import PhaseProgram
from repro_torch.core.schedule import schedule_tensors
from repro_torch.core.split import replicate_tower
from repro_torch.optim.optimizers import Optimizer, sgd
from repro_torch.optim.per_component import ComponentLR
from repro_torch.utils.tree import tree_leaves, tree_map, tree_map_with_path

PyTree = Any


@dataclass(frozen=True)
class HParams:
    """Hyper-parameters shared by the algorithms' builders. Each reads what
    it needs: the round-based baselines `lr` and `local_steps`; mtsl
    `optimizer` (default sgd(lr)), `component_lr` (default: the paper's
    server-scaled policy, server LR x 2/M) and `microbatches`; FedEM
    `num_components`, FedProx `prox_mu`, SMoFi `momentum`, ParallelSFL
    `num_clusters` and `capability`; the FedAvg family `sample_weighted`."""

    lr: float = 0.1
    local_steps: int = 1
    optimizer: Optional[Optimizer] = None
    component_lr: Optional[ComponentLR] = None
    microbatches: int = 1
    num_components: int = 3  # FedEM mixture size
    prox_mu: float = 0.01  # FedProx proximal strength
    momentum: float = 0.9  # SMoFi server-side heavy-ball coefficient
    num_clusters: int = 2  # ParallelSFL cluster count (clamped to [1, M])
    # per-client relative compute speeds in (0, 1] (a tuple, so HParams
    # stays hashable): ParallelSFL clusters similar-capability clients
    # together (federation.cluster_assignment); None: round-robin
    capability: Optional[tuple] = None
    # weight the FedAvg-family federation means by transmitted samples
    # (schedule.sizes; ScheduleConfig.sample_weighted)
    sample_weighted: bool = False

    def with_updates(self, **kw) -> "HParams":
        return replace(self, **kw)


def _identity(state: PyTree) -> PyTree:
    return state


def client_axes_by_keys(*keys: str):
    """An `Algorithm.client_axes` declaration by state-tree key: a leaf is
    marked as carrying the client axis iff a component of its '/'-joined
    path (utils.tree.tree_map_with_path) is one of `keys`."""
    keyset = frozenset(keys)

    def marks(state: PyTree) -> PyTree:
        return tree_map_with_path(
            lambda path, leaf: any(part.lstrip(".") in keyset
                                   for part in path.split("/")),
            state)

    return marks


@dataclass(frozen=True)
class Algorithm:
    """A sync policy as data: state init, round driver, eval, traffic (see
    the module docstring)."""

    name: str
    init_state: Callable[..., PyTree]
    round_fn: Callable[..., Callable]
    eval_fn: Callable[..., Callable]
    round_bytes: Callable[..., int]
    round_events: Optional[Callable[..., tuple]] = None
    steps_per_round: Callable[[HParams], int] = lambda hp: hp.local_steps
    state_to_tree: Callable[[PyTree], PyTree] = _identity
    state_from_tree: Callable[[PyTree], PyTree] = _identity
    serve_params: Optional[Callable[[PyTree], PyTree]] = None
    uses_optimizer: bool = False
    donate_state: bool = True
    client_axes: Optional[Callable[[PyTree], PyTree]] = None
    phases: Optional[Callable[..., PhaseProgram]] = None
    replica_avg_all: bool = False
    description: str = ""


def split_local_steps(batch: PyTree, local_steps: int) -> PyTree:
    """[M, k*b, ...] round batch -> [M, k, b, ...] local-step batches
    (views)."""
    return {k: x.reshape((x.shape[0], local_steps, -1) + tuple(x.shape[2:]))
            for k, x in batch.items()}


def phase_program(alg: "Algorithm", model, num_clients: int,
                  hp: HParams) -> PhaseProgram:
    """`alg`'s declared phase program (the local -> apply decomposition of
    its round). Raises for an algorithm without one: event-driven (async)
    execution needs the phase contract."""
    if alg.phases is None:
        raise ValueError(
            f"algorithm {alg.name!r} declares no phase program; "
            "event-driven (async) execution needs one — register the "
            "algorithm with phases=... (see core/phases.py)")
    return alg.phases(model, num_clients, hp)


def shard_round_fn(alg: "Algorithm", model, num_clients: int, hp: HParams,
                   *, mesh=None, client_chunk: Optional[int] = None):
    """`alg.round_fn` with the client axis treated as an execution
    resource. client_chunk=None is exactly `alg.round_fn`. With
    `client_chunk=c` every call runs under `client_axis(chunk=c)`: the
    per-client work goes over M/c blocks of c clients, each block's
    backward before the next block's forward (core/client_axis.py). M must
    divide by c. `mesh` (sharding the client axis over devices) is not
    ported and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh sharding of the client axis is not ported yet")
    fn = alg.round_fn(model, num_clients, hp)
    if client_chunk is None:
        return fn
    if num_clients % client_chunk:
        raise ValueError(
            f"num_clients {num_clients} not divisible by client_chunk "
            f"{client_chunk}")

    def chunked(state, batch, schedule=None):
        with client_axis(chunk=client_chunk):
            return fn(state, batch, schedule)

    return chunked


def _with_round_batch(prog: PhaseProgram, local_steps: int) -> PhaseProgram:
    """A federation phase program (which takes [M, k, b, ...] local-step
    batches) on the registry's [M, k*b, ...] round batches."""

    def local(state, batch, schedule):
        return prog.local(state, split_local_steps(batch, local_steps), schedule)

    return PhaseProgram(local, prog.apply)


def num_rounds(total_steps: int, steps_per_round: int) -> int:
    """Rounds needed to cover `total_steps` gradient steps: CEIL division,
    so a step budget is never silently truncated."""
    return max(-(-total_steps // steps_per_round), 1)


def _alg_events(name: str, **fixed):
    """An Algorithm.round_events builder over comm_cost.traffic_events: one
    round of `name` as per-link TrafficEvents on an explicit Topology.
    `fixed` maps HParams fields to traffic_events kwargs."""

    def round_events(topo, cfg, num_clients, batch_per_client, hp,
                     *, tower_params=None, total_params=None,
                     num_participants=None, samples_per_step=None,
                     sizes=None, sync_round=True):
        kw = {k: v(hp) for k, v in fixed.items()}
        return comm_cost.traffic_events(
            name, topo, cfg, num_clients, batch_per_client,
            tower_params=tower_params, total_params=total_params,
            num_participants=num_participants,
            samples_per_step=samples_per_step, sizes=sizes,
            sync_round=sync_round, **kw)

    return round_events


def simulate_round_walltime(
    alg: "Algorithm",
    topo,
    cfg,
    num_clients: int,
    batch_per_client: int,
    hp: HParams,
    schedule,
    *,
    tower_params: int,
    total_params: int,
    time_per_sample_s: float,
    round_idx: int,
    local_steps: int,
) -> float:
    """One round's simulated wall-clock for `alg` deployed on `topo`: its
    TrafficEvents on the graph's links plus the schedule-aware per-client
    compute term (topology.round_walltime). `round_idx` (1-based) gates the
    periodic multi-server replica sync (topo.sync_every); `local_steps` is
    the algorithm's steps_per_round and `batch_per_client` the per-step
    row width the round was generated with."""
    sizes = None if schedule.sizes is None else np.asarray(schedule.sizes)
    events = ()
    if alg.round_events is not None:
        events = alg.round_events(
            topo, cfg, num_clients, batch_per_client, hp,
            tower_params=tower_params, total_params=total_params,
            num_participants=schedule.num_participants, sizes=sizes,
            sync_round=(round_idx % topo.sync_every == 0))
    compute = topology.client_compute_seconds(
        topo, local_steps=local_steps, samples_per_step=batch_per_client,
        time_per_sample_s=time_per_sample_s,
        mask=np.asarray(schedule.mask), budget=np.asarray(schedule.budget),
        sizes=sizes)
    return topology.round_walltime(topo, events, compute_s=compute)


@functools.lru_cache(maxsize=None)
def _star_topology(num_clients: int):
    """star(M), built once per size (round_bytes runs every round)."""
    return topology.star(num_clients)


def events_round_bytes(round_events):
    """The scalar `round_bytes` of `round_events`, folded on the classic
    star(M) deployment: the byte and event views come from one
    declaration."""

    def round_bytes(cfg, num_clients, batch_per_client, hp, *,
                    tower_params=None, total_params=None,
                    num_participants=None, samples_per_step=None):
        topo = _star_topology(num_clients)
        events = round_events(
            topo, cfg, num_clients, batch_per_client, hp,
            tower_params=tower_params, total_params=total_params,
            num_participants=num_participants,
            samples_per_step=samples_per_step)
        return comm_cost.round_cost_from_events(topo, events).total

    return round_bytes


_REGISTRY: dict = {}


def register_algorithm(alg: Algorithm, *, overwrite: bool = False) -> Algorithm:
    if alg.name in _REGISTRY and not overwrite:
        raise ValueError(f"algorithm {alg.name!r} already registered; pass "
                         "overwrite=True to replace it")
    _REGISTRY[alg.name] = alg
    return alg


def get_algorithm(name: str) -> Algorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown algorithm {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def list_algorithms() -> tuple:
    return tuple(sorted(_REGISTRY))


def _state_device(state) -> torch.device:
    return tree_leaves(state.params)[0].device


# ---------------------------------------------------------------------------
# mtsl: the paper's algorithm (one split step per round, per-component LRs)
# ---------------------------------------------------------------------------


def _mtsl_optimizer(hp: HParams) -> Optimizer:
    return hp.optimizer if hp.optimizer is not None else sgd(hp.lr)


def _mtsl_component_lr(hp: HParams, num_clients: int) -> ComponentLR:
    if hp.component_lr is not None:
        return hp.component_lr
    # the paper's Eq. 9 policy: server LR ~ 1/M
    return lr_policy.server_scaled(num_clients, server_scale=2.0 / num_clients)


def _mtsl_init(model, gen, num_clients, hp: HParams) -> TrainState:
    params = mtsl_init_params(model, gen, num_clients)
    return TrainState(params, _mtsl_optimizer(hp).init(params), 0)


def _mtsl_round(model, num_clients, hp: HParams):
    step = build_train_step(model, _mtsl_optimizer(hp), num_clients,
                            microbatches=hp.microbatches)
    clr = _mtsl_component_lr(hp, num_clients)

    def round_fn(state, batch, schedule=None):
        # one split step per round: the budget is moot; the mask limits
        # the gradient to participants, and capability sizes limit each
        # client to the first sizes[m] samples of its padded row
        nonlocal clr
        dev = _state_device(state)
        clr = clr.to(dev)  # once: a no-op after the first round
        mask, _, sizes = schedule_tensors(schedule, dev)
        return step(state, batch, clr, mask, sizes)

    return round_fn


def _mtsl_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    local_step, apply_step = build_train_phases(
        model, _mtsl_optimizer(hp), num_clients, microbatches=hp.microbatches)
    clr = _mtsl_component_lr(hp, num_clients)

    def local(state, batch, schedule):
        mask, _, sizes = schedule_tensors(schedule, _state_device(state))
        grads, metrics = local_step(state, batch, mask, sizes)
        return {"grads": grads, "metrics": metrics}

    def apply(state, payload, schedule):
        nonlocal clr
        dev = _state_device(state)
        clr = clr.to(dev)
        mask, _, _ = schedule_tensors(schedule, dev)
        return apply_step(state, payload["grads"], payload["metrics"], clr, mask)

    return PhaseProgram(local, apply)


def _mtsl_eval(model, num_clients):
    ev = build_eval_step(model, num_clients)

    def eval_fn(state, batch):
        return ev(state.params, batch)

    return eval_fn


_mtsl_events = _alg_events("mtsl")


register_algorithm(Algorithm(
    name="mtsl",
    init_state=_mtsl_init,
    round_fn=_mtsl_round,
    eval_fn=_mtsl_eval,
    round_bytes=events_round_bytes(_mtsl_events),
    round_events=_mtsl_events,
    steps_per_round=lambda hp: 1,
    serve_params=lambda state: state.params,
    uses_optimizer=True,
    # towers AND the tower slices of the optimizer moments are per-client
    client_axes=client_axes_by_keys("towers"),
    phases=_mtsl_phases,
    description="Non-federated multi-task split learning (paper Alg. 1): "
                "private towers, shared server, implicit aggregation.",
))


# ---------------------------------------------------------------------------
# splitfed: local split steps against the central server, then tower FedAvg
# ---------------------------------------------------------------------------


def _splitfed_init(model, gen, num_clients, hp: HParams):
    return {"towers": replicate_tower(model.init_tower, gen, num_clients),
            "server": model.init_server(gen)}


def _splitfed_round(model, num_clients, hp: HParams):
    rf = federation.build_splitfed_round(model, hp.lr, num_clients, hp.local_steps)

    def round_fn(state, batch, schedule=None):
        return rf(state, split_local_steps(batch, hp.local_steps), schedule)

    return round_fn


def _splitfed_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    return _with_round_batch(
        federation.build_splitfed_phases(model, hp.lr, num_clients, hp.local_steps),
        hp.local_steps)


def _shared_state_eval(model, num_clients):
    """Eval of {"towers", "server", ...} states (splitfed shares mtsl's
    layout; smofi adds its buffer)."""
    ev = build_eval_step(model, num_clients)

    def eval_fn(state, batch):
        return ev(state, batch)

    return eval_fn


# k split steps' smashed traffic + one tower-federation exchange
_splitfed_events = _alg_events("splitfed", local_steps=lambda hp: hp.local_steps)


register_algorithm(Algorithm(
    name="splitfed",
    init_state=_splitfed_init,
    round_fn=_splitfed_round,
    eval_fn=_shared_state_eval,
    round_bytes=events_round_bytes(_splitfed_events),
    round_events=_splitfed_events,
    serve_params=_identity,  # the state IS {"towers", "server"}
    client_axes=client_axes_by_keys("towers"),
    phases=_splitfed_phases,
    description="SplitFed [Thapa et al.]: split learning with fed-averaged "
                "client parts every round.",
))


# ---------------------------------------------------------------------------
# fedavg: local full-model steps, then full-model averaging
# ---------------------------------------------------------------------------


def _fedavg_init(model, gen, num_clients, hp: HParams):
    return federation.init_fedavg_params(model, gen, num_clients)


def _fedavg_round(model, num_clients, hp: HParams):
    rf = federation.build_fedavg_round(model, hp.lr, num_clients, hp.local_steps,
                                       sample_weighted=hp.sample_weighted)

    def round_fn(state, batch, schedule=None):
        return rf(state, split_local_steps(batch, hp.local_steps), schedule)

    return round_fn


def _fedavg_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    return _with_round_batch(
        federation.build_fedprox_phases(model, hp.lr, num_clients, hp.local_steps,
                                        mu=0.0, sample_weighted=hp.sample_weighted),
        hp.local_steps)


def _param_only_events(name: str):
    """Full-model (or component) exchange only: the traffic does not depend
    on the samples sent."""
    ev = _alg_events(name, **({"num_components": lambda hp: hp.num_components}
                              if name == "fedem" else {}))

    def round_events(topo, cfg, num_clients, batch_per_client, hp, *,
                     tower_params=None, total_params=None,
                     num_participants=None, samples_per_step=None,
                     sizes=None, sync_round=True):
        return ev(topo, cfg, num_clients, batch_per_client, hp,
                  tower_params=tower_params, total_params=total_params,
                  num_participants=num_participants,
                  samples_per_step=None, sizes=sizes, sync_round=sync_round)

    return round_events


_fedavg_events = _param_only_events("fedavg")


register_algorithm(Algorithm(
    name="fedavg",
    init_state=_fedavg_init,
    round_fn=_fedavg_round,
    eval_fn=federation.eval_fedavg,
    round_bytes=events_round_bytes(_fedavg_events),
    round_events=_fedavg_events,
    # per-client full-model copies: both halves carry the client axis
    client_axes=client_axes_by_keys("towers", "servers"),
    phases=_fedavg_phases,
    # the [M, ...] rows are COPIES of one global model
    replica_avg_all=True,
    description="FedAvg [McMahan et al.]: classic federation of the full "
                "model; exhibits client drift under heterogeneity.",
))


# ---------------------------------------------------------------------------
# fedem: synchronous EM mixture of K full models (Marfoq et al., 2021)
# ---------------------------------------------------------------------------


def _fedem_init(model, gen, num_clients, hp: HParams):
    return federation.init_fedem_state(model, gen, num_clients, hp.num_components)


def _fedem_round(model, num_clients, hp: HParams):
    rf = federation.build_fedem_round(model, hp.lr, num_clients,
                                      hp.num_components, hp.local_steps)

    def round_fn(state, batch, schedule=None):
        comps, pi = state
        comps, pi, metrics = rf(comps, pi, split_local_steps(batch, hp.local_steps),
                                schedule)
        return (comps, pi), metrics

    return round_fn


def _fedem_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    return _with_round_batch(
        federation.build_fedem_phases(model, hp.lr, num_clients,
                                      hp.num_components, hp.local_steps),
        hp.local_steps)


def _fedem_eval(model, num_clients):
    ev = federation.build_fedem_eval_step(model, num_clients)

    def eval_fn(state, batch):
        comps, pi = state
        return ev(federation.FedEMState(comps, pi), batch)

    return eval_fn


_fedem_events = _param_only_events("fedem")


register_algorithm(Algorithm(
    name="fedem",
    init_state=_fedem_init,
    round_fn=_fedem_round,
    eval_fn=_fedem_eval,
    round_bytes=events_round_bytes(_fedem_events),
    round_events=_fedem_events,
    state_to_tree=lambda state: {"components": state[0], "pi": state[1]},
    state_from_tree=lambda tree: (tree["components"], tree["pi"]),
    # components are [K, ...] shared mixtures; only the responsibilities
    # pi [M, K] are per-client
    client_axes=lambda state: (tree_map(lambda _: False, state[0]),
                               tree_map(lambda _: True, state[1])),
    phases=_fedem_phases,
    description="FedEM [Marfoq et al. 2021]: mixture of K shared full models "
                "with per-client responsibilities.",
))


# ---------------------------------------------------------------------------
# fedprox: fedavg with a proximal pull toward the round-start global model
# ---------------------------------------------------------------------------


def _fedprox_round(model, num_clients, hp: HParams):
    rf = federation.build_fedprox_round(model, hp.lr, num_clients, hp.local_steps,
                                        hp.prox_mu, sample_weighted=hp.sample_weighted)

    def round_fn(state, batch, schedule=None):
        return rf(state, split_local_steps(batch, hp.local_steps), schedule)

    return round_fn


def _fedprox_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    return _with_round_batch(
        federation.build_fedprox_phases(model, hp.lr, num_clients, hp.local_steps,
                                        hp.prox_mu, sample_weighted=hp.sample_weighted),
        hp.local_steps)


_fedprox_events = _param_only_events("fedprox")


register_algorithm(Algorithm(
    name="fedprox",
    init_state=_fedavg_init,  # fedavg's replicated full-model layout
    round_fn=_fedprox_round,
    eval_fn=federation.eval_fedavg,
    round_bytes=events_round_bytes(_fedprox_events),
    round_events=_fedprox_events,
    client_axes=client_axes_by_keys("towers", "servers"),
    phases=_fedprox_phases,
    replica_avg_all=True,
    description="FedProx [Li et al. 2020]: FedAvg whose local steps add "
                "(mu/2)·||p - p_global||² drift damping (hp.prox_mu).",
))


# ---------------------------------------------------------------------------
# parallelsfl: cluster-wise split federation with per-cluster server replicas
# ---------------------------------------------------------------------------


def _parallelsfl_init(model, gen, num_clients, hp: HParams):
    # the client -> cluster map is part of the STATE (round and eval always
    # agree); with hp.capability it groups similar-capability clients
    cidx, C = federation.cluster_assignment(num_clients, hp.num_clusters,
                                            hp.capability)
    return {"towers": replicate_tower(model.init_tower, gen, num_clients),
            "servers": replicate_tower(model.init_server, gen, C),
            "cidx": torch.as_tensor(cidx, dtype=torch.int64, device=gen.device)}


def _parallelsfl_round(model, num_clients, hp: HParams):
    # the cluster count and map come from the state, not hp
    rf = federation.build_parallelsfl_round(model, hp.lr, num_clients, hp.local_steps)

    def round_fn(state, batch, schedule=None):
        return rf(state, split_local_steps(batch, hp.local_steps), schedule)

    return round_fn


def _parallelsfl_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    return _with_round_batch(
        federation.build_parallelsfl_phases(model, hp.lr, num_clients, hp.local_steps),
        hp.local_steps)


def _parallelsfl_from_tree(tree):
    """Restore hook: a state without "cidx" gets the round-robin map it was
    trained with."""
    if "cidx" not in tree:
        M = tree_leaves(tree["towers"])[0].shape[0]
        servers = tree_leaves(tree["servers"])[0]
        cidx, _ = federation.cluster_assignment(M, servers.shape[0])
        tree = {**tree, "cidx": torch.as_tensor(cidx, dtype=torch.int64,
                                                device=servers.device)}
    return tree


_parallelsfl_events = _alg_events(
    "parallelsfl", local_steps=lambda hp: hp.local_steps,
    num_clusters=lambda hp: hp.num_clusters)


register_algorithm(Algorithm(
    name="parallelsfl",
    init_state=_parallelsfl_init,
    round_fn=_parallelsfl_round,
    eval_fn=federation.eval_parallelsfl,
    round_bytes=events_round_bytes(_parallelsfl_events),
    round_events=_parallelsfl_events,
    state_from_tree=_parallelsfl_from_tree,
    # "servers" are [C, ...] per-CLUSTER replicas; only the towers and the
    # client -> cluster map are per-client
    client_axes=client_axes_by_keys("towers", "cidx"),
    phases=_parallelsfl_phases,
    description="ParallelSFL [Liao et al. 2024]: cluster-wise split "
                "federation — towers fed-average within their cluster, "
                "per-cluster server replicas merge each round "
                "(hp.num_clusters).",
))


# ---------------------------------------------------------------------------
# smofi: splitfed with step-wise server-side momentum fusion
# ---------------------------------------------------------------------------


def _smofi_init(model, gen, num_clients, hp: HParams):
    # one shared server and fused momentum buffer: the per-client replicas
    # never diverge under step-wise fusion, so they are stored once
    towers = replicate_tower(model.init_tower, gen, num_clients)
    server = model.init_server(gen)
    return {"towers": towers, "server": server,
            "smom": tree_map(torch.zeros_like, server)}


def _smofi_round(model, num_clients, hp: HParams):
    rf = federation.build_smofi_round(model, hp.lr, num_clients, hp.local_steps,
                                      hp.momentum)

    def round_fn(state, batch, schedule=None):
        return rf(state, split_local_steps(batch, hp.local_steps), schedule)

    return round_fn


def _smofi_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    return _with_round_batch(
        federation.build_smofi_phases(model, hp.lr, num_clients, hp.local_steps,
                                      hp.momentum),
        hp.local_steps)


_smofi_events = _alg_events("smofi", local_steps=lambda hp: hp.local_steps)


register_algorithm(Algorithm(
    name="smofi",
    init_state=_smofi_init,
    round_fn=_smofi_round,
    eval_fn=_shared_state_eval,  # reads {"towers", "server"}, as splitfed's
    round_bytes=events_round_bytes(_smofi_events),
    round_events=_smofi_events,
    serve_params=lambda state: {"towers": state["towers"],
                                "server": state["server"]},
    client_axes=client_axes_by_keys("towers"),
    phases=_smofi_phases,
    description="SMoFi [Yang et al. 2025]: splitfed whose per-client server "
                "replicas fuse their momentum buffers at every local step "
                "(hp.momentum).",
))
