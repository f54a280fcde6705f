"""An MoE's dispatch groups across ranks (`models/moe.py`, `round_tokens`):
the port's sharded rounds of deepseek-moe-16b smoke at any moe_groups
against the reference's dense round, on gloo worlds of 2 and 4 ranks.

The reference dispatches the round's tokens in cfg.moe_groups groups,
each with its own expert capacity; moe_groups = 1 (its default) is one
group over every client's tokens. A rank of the port holds a contiguous
block of clients, so of tokens, and keeps a row iff its position among
the rows of its (group, expert) on lower ranks and its own is below the
capacity: the reference's stable-sort rule.

Setting: M = 4 clients, b = 2, S = 12 (T = 96 tokens a round), capacity
factor 0.5, so experts overflow. Cells:

  * mtsl at moe_groups 1 (one group over both or all four ranks), D (a
    group a rank) and 3 (groups of 32 tokens that straddle ranks), on
    data=2 and data=4;
  * fedavg at moe_groups 1 and 3: each client's full model dispatches
    its own tokens, on its own rank;
  * mtsl at moe_groups 1 with remat "block" on data=2: the backward
    dispatches again, and gathers again; and that with an MoE layer in
    each tower (3 layers, 2 in the towers), which dispatches its one
    client's tokens alone, on its rank, in the forward and the recompute.

Each is held against the reference's dense round from the reference's
init (PRNGKey(0)), 2 rounds at lr 0.1: losses within 1e-5 of
max(1, |loss|), every state leaf within 1e-5. Before that the test shows
the setting tells the semantics apart: the port's dense round drops rows
(its dispatch tally), and per-rank capacity (a group a rank) gives
another loss, further from moe_groups = 1's than the tolerance.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.core.schedule import full_schedule
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import state_from_jax
from torch_mesh_ranks import flat_state, max_gap, spawn

ARCH, M, B, S, ROUNDS, LR, TOL = "deepseek-moe-16b", 4, 2, 12, 2, 0.1, 1e-5
FACTOR = 0.5
LOCAL = {"mtsl": 1, "fedavg": 2}
CELLS = {2: [("mtsl", 1), ("mtsl", 2), ("mtsl", 3), ("fedavg", 1), ("fedavg", 3),
             ("mtsl", "1-remat"), ("mtsl", "1-tower")],
         4: [("mtsl", 1), ("mtsl", 4), ("mtsl", 3), ("fedavg", 1), ("fedavg", 3)]}
TOWER_MOE = {"num_layers": 3, "split_layers": 2}  # an MoE layer in each tower


def _updates(groups):
    """"1-remat": moe_groups 1 with every block rematerialised, so the
    backward dispatches (and gathers) again; "1-tower": that with an MoE
    layer in each tower too, which dispatches its client's tokens alone
    (in the forward and in the recompute), as the reference's vmap over
    clients does."""
    if groups == "1-remat":
        return {**_updates(1), "remat": "block"}
    if groups == "1-tower":
        return {**_updates("1-remat"), **TOWER_MOE}
    return {"num_clients": M, "moe_groups": groups, "capacity_factor": FACTOR}


def _layers(groups):
    """The updates that change the parameters."""
    return TOWER_MOE if groups == "1-tower" else {}


def _batch(alg):
    rng = np.random.default_rng(7)
    vocab = get_config(ARCH, smoke=True).vocab_size
    return {"tokens": rng.integers(0, vocab, size=(M, B * LOCAL[alg], S)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _init(alg, tower_moe=False):
    """The reference's init (PRNGKey(0)) as numpy and as the port's state
    (the parameters do not depend on moe_groups or remat)."""
    upd = {**_updates(1), **(TOWER_MOE if tower_moe else {})}
    cfg = jax_get_config(ARCH, smoke=True).with_updates(**upd)
    a = jax_alg.get_algorithm(alg)
    hp = jax_alg.HParams(lr=LR, local_steps=LOCAL[alg])
    init = jax.tree.map(np.asarray, jax.jit(
        lambda r: a.init_state(jax_build_model(cfg), r, M, hp))(jax.random.PRNGKey(0)))
    port_cfg = get_config(ARCH, smoke=True).with_updates(**upd)
    return init, state_from_jax(alg, init, "cpu", port_cfg)


@functools.lru_cache(maxsize=None)
def _reference(alg, groups):
    """The reference's dense round: (losses, final state, flattened)."""
    if groups == "1-remat":  # remat changes no value
        return _reference(alg, 1)
    cfg = jax_get_config(ARCH, smoke=True).with_updates(**_updates(groups))
    hp = jax_alg.HParams(lr=LR, local_steps=LOCAL[alg])
    a = jax_alg.get_algorithm(alg)
    rf = jax_alg.jit_round_fn(a, jax_build_model(cfg), M, hp)
    state = jax.tree.map(jax.numpy.asarray, _init(alg, bool(_layers(groups)))[0])
    batch = {k: jax.numpy.asarray(v) for k, v in _batch(alg).items()}
    sched = jax_schedule.full_schedule(M, a.steps_per_round(hp))
    losses = []
    for _ in range(ROUNDS):
        state, m = rf(state, batch, sched)
        losses.append(float(m["loss"]))
    port_cfg = get_config(ARCH, smoke=True).with_updates(**_updates(groups))
    return losses, flat_state(state_from_jax(alg, jax.tree.map(np.asarray, state),
                                             "cpu", port_cfg))


def _payload(world):
    cells = {}
    for alg, groups in CELLS[world]:
        cells[f"data={world}/{alg}/g{groups}"] = {
            "cfg": {"arch": ARCH, "updates": _updates(groups)}, "alg": alg, "M": M,
            "lr": LR, "local_steps": LOCAL[alg], "rounds": ROUNDS,
            "init": _init(alg, bool(_layers(groups)))[1], "batch": _batch(alg),
            "mesh": f"data={world}",
            "sched": ([1.0] * M, [LOCAL[alg]] * M), "dense": False}
    return {"meshes": (f"data={world}",), "cells": cells}


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    """Both worlds start while the parent draws the inits; they run their
    cells while the parent runs the reference's rounds."""
    worlds = {w: spawn(w, "rounds", tmp_path_factory.mktemp(f"moe_mesh{w}"))
              for w in CELLS}
    keys = sorted({c for cells in CELLS.values() for c in cells}, key=str)
    with ThreadPoolExecutor(len(keys)) as ex:
        list(ex.map(_init, LOCAL))
        _init("mtsl", True)
        for w, (send, _) in worlds.items():
            send(_payload(w))
        list(ex.map(lambda c: _reference(*c), keys))
    return {w: join() for w, (_, join) in worlds.items()}


def _port_dense_round(groups, tally=False):
    """One port mtsl round, unsharded: (loss, kept rows, routed rows)."""
    cfg = get_config(ARCH, smoke=True).with_updates(**_updates(groups))
    model = build_model(cfg)
    alg = get_algorithm("mtsl")
    state = alg.init_state(model, torch.Generator().manual_seed(0), M, HParams(lr=LR))
    moe_mod.moe_forward.tally = torch.zeros(2, dtype=torch.int64) if tally else None
    try:
        _, m = alg.round_fn(model, M, HParams(lr=LR))(
            state, stage_batch(_batch("mtsl"), "cpu"), full_schedule(M, 1))
        counts = moe_mod.moe_forward.tally
    finally:
        moe_mod.moe_forward.tally = None
    kept, routed = counts.tolist() if tally else (None, None)
    return float(m["loss"]), kept, routed


@pytest.mark.parametrize("world", sorted(CELLS))
def test_setting_tells_global_from_per_rank_capacity(world):
    loss, kept, routed = _port_dense_round(1, tally=True)
    assert kept < routed, (kept, routed)  # the dense round drops rows
    per_rank, _, _ = _port_dense_round(world)  # capacity from each rank's tokens
    assert abs(per_rank - loss) > 100 * TOL * max(1.0, abs(loss)), (per_rank, loss)


@pytest.mark.parametrize("cell", [(w, a, g) for w in sorted(CELLS) for a, g in CELLS[w]],
                         ids=lambda c: f"data={c[0]}-{c[1]}-g{c[2]}")
def test_sharded_moe_round_matches_reference(reports, cell):
    world, alg, groups = cell
    losses, state, _, spread = reports[world]["cells"][f"data={world}/{alg}/g{groups}"]["mesh"]
    assert spread == 0.0  # every rank gathers the same state
    want_losses, want_state = _reference(alg, groups)
    scale = max(1.0, max(abs(x) for x in want_losses))
    gap = max(abs(a - b) for a, b in zip(losses, want_losses))
    assert len(losses) == ROUNDS and gap <= TOL * scale, (losses, want_losses)
    assert max_gap(state, want_state) <= TOL


@pytest.mark.parametrize("world", sorted(CELLS))
def test_mtsl_gathers_counts_once_a_layer(reports, world):
    """mtsl's rank-aware dispatch all-gathers its [G, E] counts once per
    MoE layer a round (the server has one), twice under remat; fedavg's
    per-client dispatch gathers nothing beyond the round's own."""
    cells = reports[world]["cells"]
    gathers = {k: cells[f"data={world}/{k}"]["collectives"]["all_gather"]["calls"]
               for k in ("mtsl/g1", "fedavg/g1")}
    # a round's own gathers: mtsl's per-task losses twice (objective,
    # metrics), fedavg's once
    assert gathers["mtsl/g1"] == ROUNDS * (2 + 1), gathers
    assert gathers["fedavg/g1"] == ROUNDS * 1, gathers
    if world == 2:  # remat dispatches again in the backward
        remat = cells["data=2/mtsl/g1-remat"]["collectives"]["all_gather"]["calls"]
        assert remat == ROUNDS * (2 + 2), remat


def test_mixed_chunk_refused_for_moe_under_mesh():
    from repro_torch.core.algorithms import shard_round_fn

    class Stub:
        shape = {"data": 2}

    model = build_model(get_config(ARCH, smoke=True).with_updates(num_clients=M))
    with pytest.raises(ValueError, match="MoE model with client_chunk 2"):
        shard_round_fn(get_algorithm("mtsl"), model, M, HParams(), mesh=Stub(),
                       client_chunk=2)
