"""Training loop (port of `repro.train.loop.train`): drives data ->
round_fn -> metrics/eval/checkpoint for any algorithm in the port's
registry (core/algorithms.py: mtsl and the six baselines), with the
reference's history entries.

Each iteration consumes one ROUND batch `[M, steps_per_round * b, ...]`
(numpy, from `data.pipeline.client_batches`). `TrainConfig.steps` counts
GRADIENT steps, so the loop runs `ceil(steps / steps_per_round)` rounds.
Every round draws a seeded ClientSchedule from `TrainConfig.schedule`
(the default is the full synchronous round); a heterogeneous schedule
also hands the capability profile to the algorithm (HParams.capability).

Async round pipeline (train/pipeline.py): by default the host runs
`prefetch = TrainConfig.prefetch` (2) rounds ahead of the card. The
schedules and round batches of rounds i+1..i+prefetch are drawn on a
background thread (and pinned) while the card runs round i, and the next
round's batch is copied to the card on a side stream before it is needed.
Metrics are read back lazily: at the log / eval cadence the loop pushes
the round's device tensors into a ring of depth `prefetch` and reads them
only when the ring overflows or at the end of the run. `prefetch=0`
(`--prefetch 0`) generates, copies and reads synchronously. Any depth
gives the same trajectory: the round math and its input order are
unchanged.

Edge topology and simulated clock (core/topology.py): with
`TrainConfig.topology` set, every round's traffic (the algorithm's
`round_events`) is billed on that graph and history entries carry
"sim_time", the cumulative simulated seconds of per-client compute
(`time_per_sample_s` x samples x steps / capability) and per-link
transfers. A topology with an explicit capability profile overrides the
schedule's drawn one. The training itself is unchanged.

Client chunking (core/client_axis.py): `TrainConfig.client_chunk = c`
runs every round (and eval) over M/c client blocks, each block's backward
before the next block's forward, so only one block's activations are live.

Event-driven execution (train/events.py): `TrainConfig.async_mode`
replaces the round barrier with the staleness-aware event engine
(`_train_async`); history then counts server APPLY events.

Checkpoints (train/checkpoint.py, the reference's file format): with
`TrainConfig.checkpoint_path` set, the state is saved every
`checkpoint_every` rounds (absolute rounds; 0: never periodically) and
always after the last round unless that round's periodic save wrote it,
with extra = {"step", "round"} (+ "sim_time" under a topology; + the
event engine's snapshot under "events" in async mode). A resumed run
passes the restored state as `init_state`, the checkpoint's round as
`start_round` (the schedule stream, the eval stream and the rounds resume
at that absolute round; `batches` yields the remaining round batches),
its "sim_time" as `start_sim_time` and, in async mode, its "events" as
`init_events`.

The client axis over devices (`TrainConfig.mesh`, a DeviceMesh from
`launch.mesh.make_mesh_from_spec`; one process per mesh position): each
rank builds the state from the seed (or takes `init_state`) and keeps its
M/D clients (`place_algorithm_state`; which clients is one rule,
`utils.sharding.rank_rows`: a contiguous block, or under
`client_chunk` c the rank's c/D of each chunk; the replicated leaves are
broadcast from the mesh's first rank), runs every round through
`shard_round_fn(mesh=)` and stages only its clients' rows of each round
batch and of each eval batch through the same prefetch path (a batch of
all M rows is cut to the rank's on the prefetch thread, before it is
pinned; a batch of the rank's rows, such as a cached dataset's
`subset(rows)` reads, passes). Every
rank draws the same seeded schedule stream and gets the global metrics;
history and the log lines come from the mesh's first rank, with the
global loss, participants and sim_time; eval metrics are gathered over
the client group. A checkpoint is the whole state, gathered in client
order (`gather_algorithm_state`) and written by the first rank in the same file
format as an unsharded run's, so either kind of run resumes from the
other's file. `train` returns this rank's part of the state. The async
engine refuses a mesh, as the reference's.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.core import comm_cost
from repro_torch.core.algorithms import (
    HParams,
    client_rows,
    gather_algorithm_state,
    get_algorithm,
    num_rounds,
    place_algorithm_state,
    shard_round_fn,
    simulate_round_walltime,
)
from repro_torch.core.client_axis import client_axis
from repro_torch.core.schedule import (
    ScheduleConfig,
    capability_profile,
    full_schedule,
    schedule_stream,
)
from repro_torch.core.topology import Topology, star
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.optim.per_component import ComponentLR
from repro_torch.train.checkpoint import save_algorithm_state
from repro_torch.train.events import EventEngine
from repro_torch.train.pipeline import MetricsRing, host_batch, pipeline_rounds
from repro_torch.utils.device import generator, resolve_device
from repro_torch.utils.sharding import client_group, mesh_axis_sizes, mesh_group, mesh_ranks


@dataclass
class TrainConfig:
    steps: int = 200  # total gradient steps (rounds = steps / steps_per_round)
    algorithm: str = "mtsl"
    lr: float = 0.1  # used by round-based algorithms (mtsl uses `optimizer`)
    local_steps: int = 1
    log_every: int = 20  # in rounds; 0 = log only the first/last round
    eval_every: int = 0  # in rounds; 0 disables eval
    microbatches: int = 1
    seed: int = 0
    # client participation / straggler simulation (core/schedule.py)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    # nominal per-step batch per client; required under capability batching
    batch_per_client: Optional[int] = None
    # explicit edge deployment graph: bill each round's traffic on it and
    # record "sim_time" (see the module docstring)
    topology: Optional[Topology] = None
    # simulated seconds of client compute per sample at capability 1.0
    time_per_sample_s: float = 1e-3
    # HParams overrides (the launcher's --hp key=value group): the
    # per-algorithm knobs such as prox_mu, momentum, num_clusters
    hp_overrides: dict = field(default_factory=dict)
    device: str = "cuda"
    # checkpoints (see the module docstring)
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 0  # in rounds; 0 = only the final save
    # async round pipeline depth (train/pipeline.py): rounds of schedules
    # and batches the host runs ahead, and logged rounds of metrics left
    # unread in flight. 0 = fully synchronous
    prefetch: int = 2
    # run each round's per-client work over blocks of this many clients
    # (core/client_axis.py); must divide num_clients. None = all at once
    client_chunk: Optional[int] = None
    # event-driven asynchronous execution (train/events.py): the
    # staleness-aware event engine instead of the round barrier. Each
    # dispatch consumes one round batch and one schedule draw, so `steps`
    # bounds the same total work; history counts server APPLY events.
    # Incompatible with mesh / client_chunk
    async_mode: bool = False
    # FedAsync staleness decay: an update dispatched s applies ago merges
    # with weight decay**s. 1.0 = no down-weighting
    staleness_decay: float = 1.0
    # drop updates staler than this many applies (None = keep all)
    max_staleness: Optional[int] = None
    # the client axis over devices: a DeviceMesh (launch/mesh.py) whose
    # client axes (("pod","data")) split every leading-client-axis leaf
    # (see the module docstring). None = one device
    mesh: Optional[object] = None


def stage_batch(batch: dict, device) -> dict:
    """A numpy (or tensor) round batch as tensors on `device`, labels as
    int64 (synchronously)."""
    return {k: v.to(device) for k, v in host_batch(batch).items()}


def train(
    model: Model,
    optimizer: Optimizer,
    batches,
    tcfg: TrainConfig,
    num_clients: int,
    component_lr: Optional[ComponentLR] = None,
    eval_batches=None,
    log: Callable[[str], None] = print,
    init_state=None,
    start_round: int = 0,
    init_events: Optional[dict] = None,
    start_sim_time: float = 0.0,
):
    """Returns (final_state, history list of metric dicts).

    `batches` yields numpy round batches; `eval_batches` (numpy or tensor
    batches) are cycled through at the eval cadence, and the run's last
    round always evals when eval is configured. History entries carry
    step, round, loss, time and participants, plus acc_mtl on eval rounds
    and sim_time under a topology.
    The state is built on `tcfg.device` from `tcfg.seed` unless
    `init_state` is given; `init_state`, `start_round`, `init_events`
    and `start_sim_time` resume a checkpointed run (see the module
    docstring). Under a mesh every rank of the mesh calls it and gets back
    its own part of the state and the same history."""
    mesh = tcfg.mesh
    if mesh is not None:
        mesh_axis_sizes(mesh)  # a TypeError for anything but a mesh
    alg = get_algorithm(tcfg.algorithm)
    scfg = tcfg.schedule or ScheduleConfig()
    if scfg.capability_batching and tcfg.batch_per_client is None:
        raise ValueError(
            "ScheduleConfig.capability_batching needs "
            "TrainConfig.batch_per_client (the nominal per-step batch) to "
            "apportion per-client microbatch sizes")
    cap = capability_profile(num_clients, scfg, tcfg.topology)
    hp = HParams(lr=tcfg.lr, local_steps=tcfg.local_steps,
                 optimizer=optimizer, component_lr=component_lr,
                 microbatches=tcfg.microbatches,
                 sample_weighted=scfg.sample_weighted,
                 capability=None if scfg.is_trivial else tuple(cap))
    if tcfg.hp_overrides:
        hp = hp.with_updates(**tcfg.hp_overrides)
    spr = alg.steps_per_round(hp)
    rounds = num_rounds(tcfg.steps, spr)
    if rounds * spr != tcfg.steps:
        log(f"note: {tcfg.steps} requested steps round UP to {rounds} rounds "
            f"x {spr} steps/round = {rounds * spr} effective gradient steps")

    device = resolve_device(tcfg.device)
    state = (alg.init_state(model, generator(device, tcfg.seed), num_clients, hp)
             if init_state is None else init_state)
    if tcfg.async_mode:
        if mesh is not None or tcfg.client_chunk is not None:
            raise ValueError(
                "async_mode is incompatible with mesh/client_chunk: the "
                "event engine dispatches host-driven cohorts, not a single "
                "sharded round program")
        return _train_async(model, tcfg, num_clients, alg, hp, scfg, cap, spr,
                            rounds, state, batches, eval_batches, log,
                            init_events, device)
    group = rows = None
    if mesh is not None:
        import torch.distributed as dist

        group = client_group(mesh)
        rows = group.rows(num_clients, tcfg.client_chunk)
        state = place_algorithm_state(alg, state, mesh, device, tcfg.client_chunk)
        # this rank's rows of each round batch, cut on the prefetch thread
        batches = (client_rows(b, num_clients, rows) for b in batches)
        if dist.get_rank() != mesh_ranks(mesh)[0]:
            log = lambda _: None  # noqa: E731 — the first rank logs
    round_fn = shard_round_fn(alg, model, num_clients, hp, mesh=mesh,
                              client_chunk=tcfg.client_chunk)
    eval_fn = (_eval_fn(alg, model, num_clients, tcfg, group)
               if eval_batches else None)
    # ONE cycling iterator for the whole run (a list is rotated through);
    # a resumed run skips the evals the interrupted one consumed
    eval_iter = itertools.cycle(eval_batches) if eval_fn is not None else None
    if eval_iter is not None and start_round and tcfg.eval_every:
        for _ in range(start_round // tcfg.eval_every):
            next(eval_iter)
    if scfg.is_trivial:
        sched_iter = itertools.repeat(full_schedule(num_clients, spr))
    else:
        sched_iter = schedule_stream(scfg, num_clients, spr,
                                     tcfg.batch_per_client, start_round)

    # simulated clock: each round's traffic events billed on the graph
    topo, round_sim_s = tcfg.topology, None
    if topo is not None:
        if topo.capability is None:
            topo = topo.with_capability(cap)
        tower_p, total_p = comm_cost.model_param_counts(model)

        def round_sim_s(r, b, sched):
            # b: the per-step row width as generated (padded under
            # capability batching, where sizes carry the true counts)
            return simulate_round_walltime(
                alg, topo, model.cfg, num_clients, b, hp, sched,
                tower_params=tower_p, total_params=total_p,
                time_per_sample_s=tcfg.time_per_sample_s,
                round_idx=r, local_steps=spr)

    def save(r):
        extra = {"step": r * spr, "round": r}
        if round_sim_s is not None:
            extra["sim_time"] = sim_time
        if mesh is None:
            save_algorithm_state(tcfg.checkpoint_path, alg, state, extra=extra,
                                 cfg=model.cfg)
            return
        import torch.distributed as dist

        whole = gather_algorithm_state(alg, state, mesh, tcfg.client_chunk)
        if dist.get_rank() == mesh_ranks(mesh)[0]:
            save_algorithm_state(tcfg.checkpoint_path, alg, whole, extra=extra,
                                 cfg=model.cfg)
        dist.barrier(group=mesh_group(mesh))  # the file is there for every rank

    history = []

    def sink(p):
        entry = {"step": p["step"], "round": p["round"],
                 "loss": float(p["metrics"]["loss"]),
                 "time": p["time"], "participants": p["participants"]}
        if "sim_time" in p:
            entry["sim_time"] = p["sim_time"]
        if "eval" in p:
            entry["acc_mtl"] = float(p["eval"].get("acc_mtl", float("nan")))
        history.append(entry)
        if p["do_log"]:
            log(f"step {entry['step']:>6d}  loss {entry['loss']:.4f}"
                + (f"  acc_mtl {entry['acc_mtl']:.3f}" if "acc_mtl" in entry else "")
                + f"  ({entry['time']:.1f}s)")

    ring = MetricsRing(tcfg.prefetch, sink)
    sim_time = float(start_sim_time)
    rounds_done = saved_round = start_round
    t0 = time.time()  # reporting-only (history["time"]), never trajectory
    remaining = max(rounds - start_round, 0)
    for i, (batch, sched) in enumerate(pipeline_rounds(
            batches, sched_iter, depth=tcfg.prefetch, num_rounds=remaining,
            device=device)):
        r = start_round + i + 1  # absolute 1-based round index
        width = next(iter(batch.values())).shape[1] // spr
        state, metrics = round_fn(state, batch, sched)
        rounds_done = r
        if round_sim_s is not None:
            sim_time += round_sim_s(r, width, sched)
        # the first-round log belongs to a fresh run only: a resumed run
        # records the entries an uninterrupted one would
        do_log = bool((tcfg.log_every and r % tcfg.log_every == 0)
                      or (i == 0 and start_round == 0) or r == rounds)
        do_eval = bool(eval_fn is not None and tcfg.eval_every
                       and (r % tcfg.eval_every == 0 or r == rounds))
        if do_log or do_eval:
            # the time is stamped at dispatch: the ring reads the entry up
            # to `prefetch` logged rounds later
            payload = {"metrics": metrics, "step": r * spr, "round": r,
                       "participants": sched.num_participants,
                       "time": time.time() - t0, "do_log": do_log}
            if round_sim_s is not None:
                payload["sim_time"] = sim_time
            if do_eval:
                eb = next(eval_iter)
                if rows is not None:
                    eb = client_rows(eb, num_clients, rows)
                payload["eval"] = eval_fn(state, stage_batch(eb, device))
            ring.push(payload)
        if (tcfg.checkpoint_path and tcfg.checkpoint_every
                and r % tcfg.checkpoint_every == 0):
            save(r)
            saved_round = r
    ring.flush()
    if tcfg.checkpoint_path and rounds_done > saved_round:
        save(rounds_done)  # always leave a final checkpoint behind
    return state, history


def _eval_fn(alg, model, num_clients: int, tcfg: TrainConfig, group=None):
    """The algorithm's eval, under the run's client chunk and, on a mesh,
    its client group (this rank's clients; the metrics gathered)."""
    ev = alg.eval_fn(model, num_clients)
    if group is None and tcfg.client_chunk is None:
        return ev

    def scoped(state, batch):
        with client_axis(chunk=tcfg.client_chunk, group=group):
            return ev(state, batch)

    return scoped


def _train_async(model, tcfg, num_clients, alg, hp, scfg, cap, spr, rounds,
                 state, batches, eval_batches, log, init_events, device):
    """The event-driven branch of train(): drives the EventEngine
    (train/events.py) instead of the barrier loop.

    One cohort dispatch consumes one round batch and one schedule draw, so
    `TrainConfig.steps` bounds the same total work as the synchronous
    path; history, eval and checkpoint cadences count server APPLY events
    ("round" in history = apply index). Checkpoints carry the engine's
    snapshot under extra["events"]; resume by passing the restored state
    as `init_state=` and that snapshot as `init_events=`, with the batch
    stream positioned snapshot["dispatches"] rounds in."""
    topo = tcfg.topology if tcfg.topology is not None else star(num_clients)
    if topo.capability is None:
        topo = topo.with_capability(cap)
    engine = EventEngine(alg, model, num_clients, hp, topo,
                         staleness_decay=tcfg.staleness_decay,
                         max_staleness=tcfg.max_staleness,
                         time_per_sample_s=tcfg.time_per_sample_s,
                         init_state=state, snapshot=init_events)
    start_disp = engine.dispatches
    if scfg.is_trivial:
        sched_iter = itertools.repeat(full_schedule(num_clients, spr))
    else:
        sched_iter = schedule_stream(scfg, num_clients, spr,
                                     tcfg.batch_per_client, start_disp)
    eval_fn = alg.eval_fn(model, num_clients) if eval_batches else None
    eval_iter = itertools.cycle(eval_batches) if eval_fn is not None else None
    if eval_iter is not None and engine.applies and tcfg.eval_every:
        # resume: skip the evals the interrupted run already consumed
        for _ in range(engine.applies // tcfg.eval_every):
            next(eval_iter)
    # the sync path's prefetch pipeline stages batches and schedule draws
    # ahead of the engine's dispatch demand
    pairs = pipeline_rounds(batches, sched_iter, depth=tcfg.prefetch,
                            num_rounds=max(rounds - start_disp, 0), device=device)

    history = []
    t0 = time.time()  # reporting-only (history["time"]), never trajectory
    ckpt_applies = engine.applies
    last_ev = None

    def entry(ev):
        return {"step": ev["applies"] * spr, "round": ev["applies"],
                "loss": float(ev["metrics"]["loss"]),
                "time": time.time() - t0,
                "participants": ev["participants"],
                "sim_time": ev["sim_time"], "staleness": ev["staleness"]}

    def show(e):
        log(f"apply {e['round']:>6d}  loss {e['loss']:.4f}"
            + (f"  acc_mtl {e['acc_mtl']:.3f}" if "acc_mtl" in e else "")
            + f"  (sim {e['sim_time']:.3f}s, stale {e['staleness']})")

    def acc(st):
        ev = eval_fn(st, stage_batch(next(eval_iter), device))
        return float(ev.get("acc_mtl", float("nan")))

    def save(st, applies):
        snap = engine.snapshot()
        # "sim_time" mirrors the sync path's extra (the engine restores its
        # own clock from the snapshot on resume)
        save_algorithm_state(
            tcfg.checkpoint_path, alg, st, cfg=model.cfg,
            extra={"step": applies * spr, "round": applies,
                   "sim_time": snap["sim_time"], "events": snap})

    for ev in engine.run(pairs, max_dispatches=rounds):
        if ev["metrics"] is None:
            continue  # staleness-dropped or participant-free arrival
        last_ev = ev
        a_i = ev["applies"]
        do_log = bool(tcfg.log_every and a_i % tcfg.log_every == 0)
        do_eval = bool(eval_fn is not None and tcfg.eval_every
                       and a_i % tcfg.eval_every == 0)
        if do_log or do_eval:
            e = entry(ev)
            if do_eval:
                e["acc_mtl"] = acc(engine.state())
            history.append(e)
            if do_log:
                show(e)
        if (tcfg.checkpoint_path and tcfg.checkpoint_every
                and a_i % tcfg.checkpoint_every == 0):
            save(engine.state(), a_i)
            ckpt_applies = a_i
    final_state = engine.state()
    if last_ev is not None and (not history
                                or history[-1]["round"] != last_ev["applies"]):
        # as the sync loop: the run's last applied event always lands in
        # history (with a final eval when eval is configured)
        e = entry(last_ev)
        if eval_fn is not None:
            e["acc_mtl"] = acc(final_state)
        history.append(e)
        show(e)
    if tcfg.checkpoint_path and engine.applies > ckpt_applies:
        save(final_state, engine.applies)
    return final_state, history
