"""What the example twins (examples/torch_*.py) share: the reference
examples' runs of `benchmarks.common.run_algorithm`, driven on the
PyTorch port through `repro_torch.train.loop.train`.

`run` takes run_algorithm's arguments and returns the numbers the
examples print: Accuracy_MTL (paper Eq. 14) on the held-out batches, the
bytes sent, the mean participants a round and the simulated seconds to
each accuracy threshold under a topology. `make_source` and
`test_batches` are the reference harness's synthetic source and held-out
batches. The port's benchmark harness is not this module: it belongs to
the benchmark work, which the reference's `benchmarks/` waits on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.algorithms import HParams, get_algorithm, num_rounds
from repro_torch.core.comm_cost import model_param_counts
from repro_torch.core.schedule import (
    ScheduleConfig,
    capability_profile,
    padded_batch_per_client,
    schedule_stream,
)
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.train.loop import TrainConfig, train

ACC_THRESHOLDS = (0.5, 0.7, 0.8, 0.9)  # the reference harness's
SEED = 0


@dataclass
class Run:
    algorithm: str
    acc_mtl: float
    acc_curve: list  # [(gradient steps, acc)]
    bytes_to_acc: dict  # threshold -> bytes sent before reaching it (or None)
    wall_s: float
    total_bytes: int
    mean_participants: float
    sim_to_acc: dict  # threshold -> simulated seconds (None without a topology)
    total_sim_s: float


def make_source(cfg, alpha: float):
    return MultiTaskImageSource(
        num_classes=cfg.num_clients, image_size=cfg.image_size,
        channels=cfg.image_channels, alpha=alpha, seed=SEED)


def test_batches(cfg, src, per_task: int = 64, seed: int = 123) -> dict:
    rng = np.random.default_rng(seed)
    parts = [src.test_batch(rng, m, per_task) for m in range(cfg.num_clients)]
    return {"image": np.stack([x for x, _ in parts]),
            "label": np.stack([y for _, y in parts]).astype(np.int32)}


def steps_scale(text: str) -> float:
    """The twins' --steps: the fraction of the reference example's step
    counts to run (1 = the reference's; any run takes at least a round)."""
    f = float(text)
    if not f > 0:
        raise ValueError(f"--steps must be > 0, got {text}")
    return f


def scaled(steps: int, f: float) -> int:
    return max(1, int(round(steps * f)))


def run(arch: str, algorithm: str, *, steps: int, local_steps: int, alpha: float = 0.0,
        batch_per_client: int = 16, lr: float = 0.1, eval_every: int = 10,
        smoke: bool = False, schedule: Optional[ScheduleConfig] = None,
        topology=None, device: str = "cuda", init_state=None) -> Run:
    """`benchmarks.common.run_algorithm`'s run on the port, at its seed 0
    and its defaults for what the examples leave unset: the same source,
    batches, schedules, evals and byte and clock accounting. The state is
    drawn from the seed on `device` unless `init_state` is given (the
    reference's, converted, in the tests)."""
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg)
    M = cfg.num_clients
    src = make_source(cfg, alpha)
    alg = get_algorithm(algorithm)
    scfg = schedule or ScheduleConfig()
    cap = capability_profile(M, scfg, topology)
    hp = HParams(lr=lr, local_steps=local_steps, optimizer=sgd(lr),
                 sample_weighted=scfg.sample_weighted,
                 capability=None if scfg.is_trivial else tuple(cap))
    spr = alg.steps_per_round(hp)
    rounds = num_rounds(steps, spr)
    per_round_batch = padded_batch_per_client(scfg, batch_per_client) * spr
    tcfg = TrainConfig(steps=steps, algorithm=algorithm, lr=lr, local_steps=local_steps,
                       log_every=1, eval_every=eval_every, seed=SEED, schedule=scfg,
                       batch_per_client=batch_per_client, topology=topology,
                       device=device)
    t0 = time.time()
    _, history = train(model, sgd(lr), client_batches(src, per_round_batch, steps=rounds,
                                                      seed=SEED),
                       tcfg, M, eval_batches=[test_batches(cfg, src)],
                       log=lambda _: None, init_state=init_state)
    wall_s = time.time() - t0

    # bytes a round from the round's participants (and samples sent), as
    # the reference harness bills them
    tower_p, total_p = model_param_counts(model)
    scheds = schedule_stream(scfg, M, spr, batch_per_client, 0)
    acc_curve, bytes_to, cum = [], {a: None for a in ACC_THRESHOLDS}, 0
    sim_to = {a: None for a in ACC_THRESHOLDS}
    for entry, sched in zip(history, scheds):
        kw = {} if scfg.is_trivial else {"samples_per_step": sched.samples_per_step}
        cum += alg.round_bytes(cfg, M, batch_per_client, hp, tower_params=tower_p,
                               total_params=total_p,
                               num_participants=entry["participants"], **kw)
        if "acc_mtl" in entry:
            acc = entry["acc_mtl"]
            acc_curve.append((entry["step"], acc))
            for a in ACC_THRESHOLDS:
                if bytes_to[a] is None and acc >= a:
                    bytes_to[a] = cum
                    sim_to[a] = entry.get("sim_time")
    return Run(algorithm, acc_curve[-1][1] if acc_curve else float("nan"), acc_curve,
               bytes_to, wall_s, total_bytes=cum,
               mean_participants=float(np.mean([e["participants"] for e in history])),
               sim_to_acc=sim_to, total_sim_s=history[-1].get("sim_time", 0.0))
