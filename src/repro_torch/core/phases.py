"""Phase programs: a round as composable (local -> apply) phases (port of
`repro.core.phases`).

  local(state, batch, schedule) -> payload
      everything the CLIENTS of this round compute against the
      round-start state (for mtsl: the forward/backward and its grads).
  apply(state, payload, schedule) -> (new_state, metrics)
      the SERVER-side commit (for mtsl: the per-component update).

The synchronous round is their composition (`compose_phases`). The
event engine (`train/events.py`, `TrainConfig.async_mode`) drives the
two phases on its own clock, as the reference's does.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

PyTree = Any


class PhaseProgram(NamedTuple):
    """One round, split at the uplink: client-side `local`, server-side
    `apply`."""

    local: Callable[[PyTree, PyTree, Any], PyTree]
    apply: Callable[[PyTree, PyTree, Any], tuple]


def compose_phases(program: PhaseProgram,
                   default_schedule: Optional[Callable] = None) -> Callable:
    """The synchronous round `round_fn(state, batch, schedule=None)` as the
    phases' composition; a None schedule is filled by `default_schedule()`
    when one is given."""

    def round_fn(state, batch, schedule=None):
        if schedule is None and default_schedule is not None:
            schedule = default_schedule()
        payload = program.local(state, batch, schedule)
        return program.apply(state, payload, schedule)

    return round_fn
