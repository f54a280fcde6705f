"""Training loop (port of `repro.train.loop.train`, its synchronous path):
drives data -> round_fn -> metrics/eval for any algorithm in the port's
registry (core/algorithms.py), with the reference's history entries.

Each iteration consumes one ROUND batch `[M, steps_per_round * b, ...]`
(numpy, from `data.pipeline.client_batches`) and stages it on the state's
device synchronously. `TrainConfig.steps` counts GRADIENT steps, so the
loop runs `ceil(steps / steps_per_round)` rounds. Every round draws a
seeded ClientSchedule from `TrainConfig.schedule` (the default is the
full synchronous round).

The reference runs the host side `prefetch` rounds ahead on a thread and
guarantees that any depth gives the same trajectory, so this synchronous
loop (depth 0) reproduces it. Not ported yet, and refused with an error:
the async event engine, topologies and their simulated clock, mesh
sharding, client chunking and checkpoints.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.algorithms import HParams, get_algorithm, num_rounds
from repro_torch.core.schedule import ScheduleConfig, full_schedule, schedule_stream
from repro_torch.models.registry import Model
from repro_torch.optim.optimizers import Optimizer
from repro_torch.optim.per_component import ComponentLR
from repro_torch.utils.device import generator, resolve_device

_NOT_PORTED = ("checkpoint_path", "topology", "mesh", "client_chunk",
               "async_mode")


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
    # HParams overrides (the launcher's --hp key=value group)
    hp_overrides: dict = field(default_factory=dict)
    device: str = "cuda"
    # not ported yet: setting any of these raises
    checkpoint_path: Optional[str] = None
    topology: Optional[object] = None
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
):
    """Returns (final_state, history list of metric dicts).

    `batches` yields numpy round batches; `eval_batches` (numpy or tensor
    batches) are cycled through at the eval cadence, and the run's last
    round always evals when eval is configured. History entries carry
    step, round, loss, time and participants, plus acc_mtl on eval rounds.
    The state is built on `tcfg.device` from `tcfg.seed` unless
    `init_state` is given."""
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
    hp = HParams(lr=tcfg.lr, local_steps=tcfg.local_steps,
                 optimizer=optimizer, component_lr=component_lr,
                 microbatches=tcfg.microbatches)
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
    # ONE cycling iterator for the whole run (a list is rotated through)
    eval_iter = itertools.cycle(eval_batches) if eval_fn is not None else None
    if scfg.is_trivial:
        sched_iter = itertools.repeat(full_schedule(num_clients, spr))
    else:
        sched_iter = schedule_stream(scfg, num_clients, spr,
                                     tcfg.batch_per_client)

    history = []
    t0 = time.time()  # reporting-only (history["time"]), never trajectory
    for i, (batch, sched) in enumerate(zip(itertools.islice(batches, rounds),
                                           sched_iter)):
        r = i + 1  # 1-based round index
        state, metrics = round_fn(state, stage_batch(batch, device), sched)
        do_log = bool((tcfg.log_every and r % tcfg.log_every == 0)
                      or i == 0 or r == rounds)
        do_eval = bool(eval_fn is not None and tcfg.eval_every
                       and (r % tcfg.eval_every == 0 or r == rounds))
        if not (do_log or do_eval):
            continue
        entry = {"step": r * spr, "round": r,
                 "loss": float(metrics["loss"]),
                 "time": time.time() - t0,
                 "participants": sched.num_participants}
        if do_eval:
            ev = eval_fn(state, stage_batch(next(eval_iter), device))
            entry["acc_mtl"] = float(ev.get("acc_mtl", float("nan")))
        history.append(entry)
        if do_log:
            log(f"step {entry['step']:>6d}  loss {entry['loss']:.4f}"
                + (f"  acc_mtl {entry['acc_mtl']:.3f}" if "acc_mtl" in entry else "")
                + f"  ({entry['time']:.1f}s)")
    return state, history
