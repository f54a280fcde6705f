"""Client participation and compute heterogeneity (port of
`repro.core.schedule`).

A `ClientSchedule` is one round's participation mask `[M]`, per-client
local-step budget `[M]` and, under capability-aware batch sizing, the
per-client sample counts `[M]`. It is drawn on the host with numpy from a
seeded stream, exactly as the reference draws it, so both packages give
the same schedules for the same seed. The arrays stay numpy: a round
function turns them into tensors on its own device (`sample_mask` builds
the `[M, b]` live-sample mask there).

The default all-clients / full-budget schedule is trajectory-identical to
a round without one (masks of ones multiply through unchanged).

The masked reductions at the end (`participation_mean` and friends) are
the round builders' federation means, on tensors: they compute the
reference's formulas, not `torch.mean` (with an all-ones mask the two
differ in the last bit).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

# domain-separation constant for the capability draw (so the per-round
# participation stream never reuses it)
_CAPABILITY_STREAM = 0x5C4ED


class ClientSchedule(NamedTuple):
    """One round's schedule, as numpy arrays.

    mask:   [M] float32 in {0, 1}; 1 = client participates this round.
            At least one client always participates.
    budget: [M] int32 in [1, local_steps]; local steps the client completes
            (straggler simulation). mtsl (one step per round) ignores it.
    sizes:  optional [M] int32 per-step sample counts (capability-aware
            batch sizing): client m uses the first sizes[m] samples of its
            padded batch row. Masked clients carry 0, participants >= 1.
    staleness: optional [M] int32 apply-time staleness: how many server
            applies landed between a cohort's dispatch and the arrival
            being applied (the event engine, train/events.py, sets it on
            the apply-time schedule; `staleness_weights` turns it into
            FedAsync mixing weights). None on the synchronous path.
    """

    mask: np.ndarray
    budget: np.ndarray
    sizes: Optional[np.ndarray] = None
    staleness: Optional[np.ndarray] = None

    @property
    def num_participants(self) -> int:
        return int(self.mask.sum())

    @property
    def samples_per_step(self) -> Optional[int]:
        """Total samples transmitted per local step (None when unsized)."""
        return None if self.sizes is None else int(self.sizes.sum())


def sample_mask(sizes: torch.Tensor, width: int) -> torch.Tensor:
    """[M] per-client sample counts -> [M, width] float32 {0,1} mask over a
    padded batch row, on the device of `sizes`: client m's first sizes[m]
    samples are live."""
    pos = torch.arange(width, device=sizes.device)
    return (pos[None, :] < sizes[:, None]).to(torch.float32)


def schedule_tensors(schedule: Optional[ClientSchedule], device) -> tuple:
    """(mask [M] f32, budget [M] int, sizes [M] int or None) of a
    ClientSchedule on `device`; (None, None, None) for no schedule."""
    if schedule is None:
        return None, None, None
    mask = torch.as_tensor(np.asarray(schedule.mask, np.float32), device=device)
    budget = torch.as_tensor(np.asarray(schedule.budget), device=device)
    sizes = (None if schedule.sizes is None
             else torch.as_tensor(np.asarray(schedule.sizes), device=device))
    return mask, budget, sizes


def schedule_sample_mask(schedule: ClientSchedule, batch,
                         axis: int = 2) -> Optional[torch.Tensor]:
    """The round's [M, b] live-sample mask on the batch's device, or None
    when the schedule carries no capability batch sizes. `axis` is the
    per-sample axis of the batch's tensors ([M, local_steps, b, ...] round
    batches -> 2; [M, b, ...] single-step batches -> 1)."""
    if schedule.sizes is None:
        return None
    first = next(iter(batch.values()))
    sizes = torch.as_tensor(np.asarray(schedule.sizes), device=first.device)
    return sample_mask(sizes, first.shape[axis])


@dataclass(frozen=True)
class ScheduleConfig:
    """Run-level participation/heterogeneity knobs.

    participation_rate: per-round Bernoulli participation probability per
        client (>= 1.0 means everyone, every round).
    straggler_frac: fraction of clients that are slow devices; each slow
        client draws a fixed capability in [min_capability, 1).
    seed: seed of BOTH the capability draw and the per-round participation
        stream (domain-separated, reproducible).
    capability_batching: give every participant the full step count but a
        per-step batch proportional to its compute speed (per-round total
        conserved); rows are generated `batch_boost` x wider as headroom.
    sample_weighted: weight the FedAvg-family federation means by the
        transmitted samples (`ClientSchedule.sizes`); uniform sizes, or no
        capability batching, give the unweighted means bit for bit.
    """

    participation_rate: float = 1.0
    straggler_frac: float = 0.0
    seed: int = 0
    min_capability: float = 0.25
    capability_batching: bool = False
    batch_boost: float = 2.0
    sample_weighted: bool = False

    @property
    def is_trivial(self) -> bool:
        """True iff every round is all-clients at full budget."""
        return (self.participation_rate >= 1.0 and self.straggler_frac <= 0.0
                and not self.capability_batching)

    def with_updates(self, **kw) -> "ScheduleConfig":
        return replace(self, **kw)


def full_schedule(num_clients: int, local_steps: int) -> ClientSchedule:
    """All clients participate and complete every local step."""
    return ClientSchedule(
        mask=np.ones((num_clients,), np.float32),
        budget=np.full((num_clients,), max(local_steps, 1), np.int32),
    )


def capability_profile(num_clients: int, scfg: ScheduleConfig,
                       topology=None) -> np.ndarray:
    """[M] relative compute speeds in (0, 1], fixed for the run. A
    `core.topology.Topology` that carries an explicit capability profile
    gives it; otherwise `straggler_frac` of the clients (chosen by
    `scfg.seed`) are slow and draw a capability uniform in
    [min_capability, 1), and the rest run at 1.0."""
    if topology is not None and topology.capability is not None:
        cap = topology.capability_array()
        if cap.shape != (num_clients,):
            raise ValueError(
                f"topology capability profile has shape {cap.shape}, "
                f"want ({num_clients},)")
        return cap
    cap = np.ones((num_clients,), np.float64)
    n_slow = int(round(scfg.straggler_frac * num_clients))
    n_slow = min(max(n_slow, 0), num_clients)
    if n_slow:
        rng = np.random.default_rng([scfg.seed, _CAPABILITY_STREAM])
        slow = rng.choice(num_clients, size=n_slow, replace=False)
        cap[slow] = rng.uniform(scfg.min_capability, 1.0, size=n_slow)
    return cap


def budgets_from_capability(capability, local_steps: int) -> np.ndarray:
    """Straggler budgets: a capability-c client completes
    max(1, floor(c * local_steps)) of the round's `local_steps` steps."""
    b = np.floor(np.asarray(capability, np.float64) * max(local_steps, 1))
    return np.maximum(b, 1).astype(np.int32)


def padded_batch_per_client(scfg: ScheduleConfig, batch_per_client: int) -> int:
    """Per-client per-step row width of generated round batches: padded to
    `batch_boost` x under capability batching, else the nominal width."""
    if not scfg.capability_batching:
        return batch_per_client
    return max(int(np.ceil(scfg.batch_boost * batch_per_client)), 1)


def capability_batch_sizes(
    mask,
    capability,
    per_step_total: int,
    max_per_client: int,
) -> np.ndarray:
    """Apportion one local step's global sample budget among participants in
    proportion to compute speed. Returns [M] int32 sizes: masked-out clients
    get 0, every participant at least 1 and at most `max_per_client`, and
    sum(sizes) == clip(per_step_total, P, P * max_per_client).
    Deterministic largest-remainder apportionment with waterfilling (ties
    broken by client index)."""
    mask = np.asarray(mask, np.float64) > 0
    cap = np.asarray(capability, np.float64)
    if cap.shape != mask.shape:
        raise ValueError(f"capability shape {cap.shape} != mask {mask.shape}")
    M = mask.size
    sizes = np.zeros(M, np.int64)
    P = int(mask.sum())
    if P == 0:
        return sizes.astype(np.int32)
    max_per_client = max(int(max_per_client), 1)
    total = int(np.clip(int(per_step_total), P, P * max_per_client))
    sizes[mask] = 1  # every participant processes something
    remaining = total - P
    cap = np.where(mask, np.maximum(cap, 1e-9), 0.0)
    while remaining > 0:
        head = np.where(mask, max_per_client - sizes, 0)
        w = np.where(head > 0, cap, 0.0)
        ws = w.sum()
        if ws <= 0:
            break
        ideal = remaining * w / ws
        add = np.minimum(np.floor(ideal).astype(np.int64), head)
        granted = int(add.sum())
        if granted == 0:
            # sub-unit remainders: hand out singles by largest claim
            order = np.lexsort((np.arange(M), -ideal))
            for idx in order:
                if remaining == 0:
                    break
                if head[idx] > 0:
                    sizes[idx] += 1
                    head[idx] -= 1
                    remaining -= 1
            continue
        sizes += add
        remaining -= granted
    return sizes.astype(np.int32)


def round_schedule(
    scfg: ScheduleConfig,
    num_clients: int,
    local_steps: int,
    round_idx: int,
    capability: Optional[np.ndarray] = None,
    batch_per_client: Optional[int] = None,
) -> ClientSchedule:
    """The seeded schedule for round `round_idx`: participation drawn from
    `default_rng([seed, round_idx])` (at least one client participates),
    budgets from the fixed capability profile. With
    `scfg.capability_batching`, pass the nominal `batch_per_client`: every
    participant keeps the full step budget and gets `sizes[m]` samples per
    step (round batches are then `padded_batch_per_client` wide)."""
    if scfg.is_trivial:
        return full_schedule(num_clients, local_steps)
    if capability is None:
        capability = capability_profile(num_clients, scfg)
    rng = np.random.default_rng([scfg.seed, int(round_idx)])
    if scfg.participation_rate >= 1.0:
        mask = np.ones((num_clients,), bool)
    else:
        mask = rng.random(num_clients) < scfg.participation_rate
        if not mask.any():
            mask[rng.integers(num_clients)] = True
    sizes = None
    if scfg.capability_batching:
        if batch_per_client is None:
            raise ValueError(
                "capability_batching needs the nominal batch_per_client to "
                "apportion per-step sample budgets")
        sizes = capability_batch_sizes(
            mask, capability,
            per_step_total=num_clients * batch_per_client,
            max_per_client=padded_batch_per_client(scfg, batch_per_client))
        budget = np.full((num_clients,), max(local_steps, 1), np.int32)
    else:
        budget = budgets_from_capability(capability, local_steps)
    return ClientSchedule(mask=mask.astype(np.float32), budget=budget,
                          sizes=sizes)


def schedule_stream(
    scfg: ScheduleConfig,
    num_clients: int,
    local_steps: int,
    batch_per_client: Optional[int] = None,
    start_round: int = 0,
) -> Iterator[ClientSchedule]:
    """Infinite per-round schedule stream (capability drawn once); round i
    of a stream started at `start_round` is round start_round + i."""
    cap = capability_profile(num_clients, scfg)
    i = start_round
    while True:
        yield round_schedule(scfg, num_clients, local_steps, i, cap,
                             batch_per_client)
        i += 1


# ---------------------------------------------------------------------------
# masked reductions shared by the round builders (tensors)
# ---------------------------------------------------------------------------


def broadcast_weights(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-client / per-cluster weights [N] reshaped to broadcast over
    [N, ...]-shaped x."""
    return w.reshape(tuple(w.shape) + (1,) * (x.ndim - w.ndim))


def participation_means(xs, mask: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        clients: bool = True) -> list:
    """[M, ...] tensors -> [...] means over participating clients only,
    sum(x * w) / max(sum(w), 1) with w = mask. Masked-out clients are
    ignored exactly (multiplied by 0.0 before the sum).

    `weights` ([M], e.g. the schedule's sizes) makes it sample-weighted:
    w = mask * weights, normalised by its largest entry first, so uniform
    weights give the unweighted mean bit for bit (w / max(w) is exactly
    the mask).

    With `clients` (the leading axis is the client axis) the sums, the
    weight total and the largest weight are reduced over the ambient
    client group (core/client_axis.py: one all-reduce for the sums and the
    total, one for the max), so a rank holding M/D clients gets the mean
    over all M; `clients=False` averages over a replicated leading axis
    (ParallelSFL's server replicas) locally."""
    from repro_torch.core import client_axis

    w = mask
    if weights is not None:
        w = mask * weights
        wmax = w.max()
        if clients:
            wmax = client_axis.client_max(wmax)
        w = torch.where(wmax > 0, w / wmax, w)
    sums = [(x * broadcast_weights(w, x)).sum(0) for x in xs]
    wsum = w.sum()
    if clients:
        wsum, *sums = client_axis.client_sum_([wsum, *sums])
    wsum = torch.clamp(wsum, min=1.0)
    return [t / wsum for t in sums]


def participation_mean(x: torch.Tensor, mask: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       clients: bool = True) -> torch.Tensor:
    """[M, ...] -> [...]: `participation_means` of one tensor."""
    return participation_means([x], mask, weights, clients)[0]


def participation_bcast_mean(x: torch.Tensor, mask: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             clients: bool = True) -> torch.Tensor:
    """[M, ...] -> [M, ...]: the participation mean given back to every
    client (the federation's download), as a contiguous tensor."""
    return participation_mean(x, mask, weights, clients)[None].expand(
        x.shape).contiguous()


def participation_tree_mean(tree, mask: torch.Tensor,
                            weights: Optional[torch.Tensor] = None,
                            bcast: bool = False):
    """`participation_means` of every leaf of a tree of [M, ...] client-axis
    tensors in one reduction (one all-reduce per dtype under a mesh);
    `bcast` gives each mean back to every client row."""
    from repro_torch.utils.tree import tree_leaves, tree_unflatten_like

    xs = tree_leaves(tree)
    means = participation_means(xs, mask, weights)
    if bcast:
        means = [m[None].expand(x.shape).contiguous() for m, x in zip(means, xs)]
    return tree_unflatten_like(tree, means)


def local_schedule(schedule: Optional[ClientSchedule],
                   rows) -> Optional[ClientSchedule]:
    """The rows `rows` (a slice or a list of client ids) of every
    per-client field of a schedule (a rank's clients under a mesh,
    `utils.sharding.rank_rows`)."""
    if schedule is None:
        return None
    return ClientSchedule(*(None if f is None else f[rows] for f in schedule))


def staleness_weights(staleness: torch.Tensor, decay: float,
                      max_staleness: Optional[int] = None) -> torch.Tensor:
    """[M] int staleness -> [M] f32 FedAsync mixing weights: decay **
    staleness[m], zero beyond `max_staleness`. decay 1.0 with no cutoff is
    all ones."""
    s = staleness.to(torch.float32)
    w = torch.pow(torch.tensor(decay, dtype=torch.float32, device=s.device), s)
    if max_staleness is not None:
        w = w * (s <= float(max_staleness)).to(torch.float32)
    return w


def step_activity(mask: torch.Tensor, budget: torch.Tensor,
                  local_steps: int) -> torch.Tensor:
    """[k, M] activity: client m is active at local step t iff it
    participates this round AND t < budget[m] (stragglers drop out of the
    tail of the round)."""
    t = torch.arange(local_steps, device=budget.device)
    in_budget = (t[:, None] < budget[None, :]).to(mask.dtype)
    return mask[None, :] * in_budget
