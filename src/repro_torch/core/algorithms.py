"""Algorithm registry (port of `repro.core.algorithms`, the parts the mtsl
path needs): one uniform train/eval/comm interface that the train loop and
the launcher drive without per-algorithm branches.

An `Algorithm` bundles:
  init_state(model, gen, num_clients, hp) -> state
  round_fn(model, num_clients, hp) -> fn(state, batch, schedule=None)
      -> (state, metrics). `batch` holds `[M, steps_per_round * b, ...]`
      tensors on the state's device; `schedule` is a
      core.schedule.ClientSchedule (numpy; None = all clients, full
      budget); `metrics` contains "loss".
  eval_fn(model, num_clients) -> fn(state, batch) -> {"acc_mtl", ...}
  steps_per_round(hp) -> gradient steps one round advances
  phases(model, num_clients, hp) -> core.phases.PhaseProgram, whose
      composition is round_fn.

The reference jits the round and donates the state's buffers
(`jit_round_fn`). Here `round_fn`'s result runs eagerly and plays that
part itself: the apply step updates the state's parameters in place.

Only `mtsl` is registered. The six baselines (splitfed, fedavg, fedprox,
fedem, smofi, parallelsfl), traffic accounting (`round_bytes`,
`round_events`: the loop bills no topology yet), mesh sharding and client
chunking are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import torch

from repro_torch.core import lr_policy
from repro_torch.core.mtsl import (
    TrainState,
    build_eval_step,
    build_train_phases,
    build_train_step,
    init_state as mtsl_init_params,
)
from repro_torch.core.phases import PhaseProgram
from repro_torch.optim.optimizers import Optimizer, sgd
from repro_torch.optim.per_component import ComponentLR
from repro_torch.utils.tree import tree_leaves

PyTree = Any


@dataclass(frozen=True)
class HParams:
    """Hyper-parameters shared by the algorithms' builders. mtsl reads
    `optimizer` (default sgd(lr)), `component_lr` (default: the paper's
    server-scaled policy, server LR x 2/M) and `microbatches`."""

    lr: float = 0.1
    local_steps: int = 1
    optimizer: Optional[Optimizer] = None
    component_lr: Optional[ComponentLR] = None
    microbatches: int = 1

    def with_updates(self, **kw) -> "HParams":
        return replace(self, **kw)


@dataclass(frozen=True)
class Algorithm:
    """A sync policy as data (see the module docstring)."""

    name: str
    init_state: Callable[..., PyTree]
    round_fn: Callable[..., Callable]
    eval_fn: Callable[..., Callable]
    steps_per_round: Callable[[HParams], int] = lambda hp: hp.local_steps
    phases: Optional[Callable[..., PhaseProgram]] = None


def num_rounds(total_steps: int, steps_per_round: int) -> int:
    """Rounds needed to cover `total_steps` gradient steps: CEIL division,
    so a step budget is never silently truncated."""
    return max(-(-total_steps // steps_per_round), 1)


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


def schedule_tensors(schedule, device) -> tuple:
    """(mask [M] f32, sizes [M] int32 or None) of a ClientSchedule on
    `device`; (None, None) for no schedule."""
    if schedule is None:
        return None, None
    mask = torch.as_tensor(schedule.mask, dtype=torch.float32, device=device)
    sizes = (None if schedule.sizes is None
             else torch.as_tensor(schedule.sizes, device=device))
    return mask, sizes


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
        mask, sizes = schedule_tensors(schedule, dev)
        return step(state, batch, clr, mask, sizes)

    return round_fn


def _mtsl_phases(model, num_clients, hp: HParams) -> PhaseProgram:
    local_step, apply_step = build_train_phases(
        model, _mtsl_optimizer(hp), num_clients, microbatches=hp.microbatches)
    clr = _mtsl_component_lr(hp, num_clients)

    def local(state, batch, schedule):
        mask, sizes = schedule_tensors(schedule, _state_device(state))
        grads, metrics = local_step(state, batch, mask, sizes)
        return {"grads": grads, "metrics": metrics}

    def apply(state, payload, schedule):
        nonlocal clr
        dev = _state_device(state)
        clr = clr.to(dev)
        mask, _ = schedule_tensors(schedule, dev)
        return apply_step(state, payload["grads"], payload["metrics"], clr, mask)

    return PhaseProgram(local, apply)


def _mtsl_eval(model, num_clients):
    ev = build_eval_step(model, num_clients)

    def eval_fn(state, batch):
        return ev(state.params, batch)

    return eval_fn


# round_bytes is not a field here: no layer of the port bills traffic yet
# repro-lint: allow(registry-contract)
register_algorithm(Algorithm(
    name="mtsl",
    init_state=_mtsl_init,
    round_fn=_mtsl_round,
    eval_fn=_mtsl_eval,
    steps_per_round=lambda hp: 1,
    phases=_mtsl_phases,
))
