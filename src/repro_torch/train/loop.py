"""Training loop (port of `repro.train.loop.train`, its synchronous path):
drives data -> round_fn -> metrics/eval for any algorithm in the port's
registry (core/algorithms.py: mtsl and the six baselines), with the
reference's history entries.

Each iteration consumes one ROUND batch `[M, steps_per_round * b, ...]`
(numpy, from `data.pipeline.client_batches`) and stages it on the state's
device synchronously. `TrainConfig.steps` counts GRADIENT steps, so the
loop runs `ceil(steps / steps_per_round)` rounds. Every round draws a
seeded ClientSchedule from `TrainConfig.schedule` (the default is the
full synchronous round); a heterogeneous schedule also hands the
capability profile to the algorithm (HParams.capability).

Edge topology and simulated clock (core/topology.py): with
`TrainConfig.topology` set, every round's traffic (the algorithm's
`round_events`) is billed on that graph and history entries carry
"sim_time", the cumulative simulated seconds of per-client compute
(`time_per_sample_s` x samples x steps / capability) and per-link
transfers. A topology with an explicit capability profile overrides the
schedule's drawn one. The training itself is unchanged.

Checkpoints (train/checkpoint.py, the reference's file format): with
`TrainConfig.checkpoint_path` set, the state is saved every
`checkpoint_every` rounds (absolute rounds; 0: never periodically) and
always after the last round unless that round's periodic save wrote it,
with extra = {"step", "round"} (+ "sim_time" under a topology). A
resumed run passes the restored state as `init_state`, the checkpoint's
round as `start_round` (the schedule stream, the eval stream and the
rounds resume at that absolute round; `batches` yields the remaining
round batches) and its "sim_time" as `start_sim_time`.

The reference runs the host side `prefetch` rounds ahead on a thread and
guarantees that any depth gives the same trajectory, so this synchronous
loop (depth 0) reproduces it. Not ported yet, and refused with an error:
the async event engine (with it the multi-server replica sync), mesh
sharding and client chunking.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import comm_cost
from repro_torch.core.algorithms import (
    HParams,
    get_algorithm,
    num_rounds,
    simulate_round_walltime,
)
from repro_torch.core.schedule import (
    ScheduleConfig,
    capability_profile,
    full_schedule,
    schedule_stream,
)
from repro_torch.core.topology import Topology
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.optim.per_component import ComponentLR
from repro_torch.train.checkpoint import save_algorithm_state
from repro_torch.utils.device import generator, resolve_device

_NOT_PORTED = ("mesh", "client_chunk", "async_mode")


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
    # not ported yet: setting any of these raises
    mesh: Optional[object] = None
    client_chunk: Optional[int] = None
    async_mode: bool = False


def stage_batch(batch: dict, device) -> dict:
    """A numpy (or tensor) round batch as tensors on `device`, labels as
    int64."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        out[k] = (t.long() if k == "label" else t).to(device)
    return out


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
    start_sim_time: float = 0.0,
):
    """Returns (final_state, history list of metric dicts).

    `batches` yields numpy round batches; `eval_batches` (numpy or tensor
    batches) are cycled through at the eval cadence, and the run's last
    round always evals when eval is configured. History entries carry
    step, round, loss, time and participants, plus acc_mtl on eval rounds
    and sim_time under a topology.
    The state is built on `tcfg.device` from `tcfg.seed` unless
    `init_state` is given; `init_state`, `start_round` and
    `start_sim_time` resume a checkpointed run (see the module
    docstring)."""
    for name in _NOT_PORTED:
        if getattr(tcfg, name):
            raise NotImplementedError(
                f"TrainConfig.{name} is not ported yet: the port's loop is "
                "the synchronous single-device path")
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
    round_fn = alg.round_fn(model, num_clients, hp)
    eval_fn = alg.eval_fn(model, num_clients) if eval_batches else None
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
        save_algorithm_state(tcfg.checkpoint_path, alg, state, extra=extra,
                             cfg=model.cfg)

    history = []
    sim_time = float(start_sim_time)
    rounds_done = saved_round = start_round
    t0 = time.time()  # reporting-only (history["time"]), never trajectory
    remaining = max(rounds - start_round, 0)
    for i, (batch, sched) in enumerate(zip(itertools.islice(batches, remaining),
                                           sched_iter)):
        r = start_round + i + 1  # absolute 1-based round index
        state, metrics = round_fn(state, stage_batch(batch, device), sched)
        rounds_done = r
        if round_sim_s is not None:
            width = next(iter(batch.values())).shape[1] // spr
            sim_time += round_sim_s(r, width, sched)
        if (tcfg.checkpoint_path and tcfg.checkpoint_every
                and r % tcfg.checkpoint_every == 0):
            save(r)
            saved_round = r
        # the first-round log belongs to a fresh run only: a resumed run
        # records the entries an uninterrupted one would
        do_log = bool((tcfg.log_every and r % tcfg.log_every == 0)
                      or (i == 0 and start_round == 0) or r == rounds)
        do_eval = bool(eval_fn is not None and tcfg.eval_every
                       and (r % tcfg.eval_every == 0 or r == rounds))
        if not (do_log or do_eval):
            continue
        entry = {"step": r * spr, "round": r,
                 "loss": float(metrics["loss"]),
                 "time": time.time() - t0,
                 "participants": sched.num_participants}
        if round_sim_s is not None:
            entry["sim_time"] = sim_time
        if do_eval:
            ev = eval_fn(state, stage_batch(next(eval_iter), device))
            entry["acc_mtl"] = float(ev.get("acc_mtl", float("nan")))
        history.append(entry)
        if do_log:
            log(f"step {entry['step']:>6d}  loss {entry['loss']:.4f}"
                + (f"  acc_mtl {entry['acc_mtl']:.3f}" if "acc_mtl" in entry else "")
                + f"  ({entry['time']:.1f}s)")
    if tcfg.checkpoint_path and rounds_done > saved_round:
        save(rounds_done)  # always leave a final checkpoint behind
    return state, history
