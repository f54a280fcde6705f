"""Shared by the tests of an MoE's dispatch groups across ranks
(tests/test_torch_moe_mesh_groups*.py, one file per gloo world): the
setting, the reference's rounds and the ranks' payload.

Setting: deepseek-moe-16b smoke, M = 4 clients, b = 2, S = 12 (T = 96
tokens a round), capacity factor 0.5, so experts overflow; 2 rounds at lr
0.1 from the reference's init (PRNGKey(0)). A cell is (algorithm,
moe_groups, client chunk): moe_groups an int, or "1-remat" (moe_groups 1
with every block rematerialised, so the backward dispatches and gathers
again) or "1-tower" (that with an MoE layer in each tower too, which
dispatches its one client's tokens alone, as the reference's vmap over
clients does); a chunk of None runs the round unchunked.

The reference's side is `shard_round_fn(alg, model, M, hp,
client_chunk=c)` without a mesh: on this JAX its mesh path fails
(tests/test_sharding_parity.py), and GSPMD sharding changes no values, so
the chunked round without a mesh computes what the sharded one does.
"""
import copy
import functools

import jax
import numpy as np
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
from torch_mesh_ranks import flat_state

ARCH, M, B, S, ROUNDS, LR, TOL = "deepseek-moe-16b", 4, 2, 12, 2, 0.1, 1e-5
FACTOR = 0.5
LOCAL = {"mtsl": 1, "fedavg": 2}
TOWER_MOE = {"num_layers": 3, "split_layers": 2}  # an MoE layer in each tower
# the chunked mesh run's checkpoint: `train()` on data=2 at chunk 2, the
# file written after CUT of CKPT_ROUNDS rounds, b 2, S 12
CHUNK, CUT, CKPT_ROUNDS = 2, 2, 4


def cell_key(world, alg, groups, chunk=None):
    return f"data={world}/{alg}/g{groups}" + ("" if chunk is None else f"/c{chunk}")


def cell_id(cell):
    world, alg, groups, chunk = cell
    return f"data={world}-{alg}-g{groups}" + ("" if chunk is None else f"-chunk{chunk}")


def updates(groups):
    if groups == "1-remat":
        return {**updates(1), "remat": "block"}
    if groups == "1-tower":
        return {**updates("1-remat"), **TOWER_MOE}
    return {"num_clients": M, "moe_groups": groups, "capacity_factor": FACTOR}


def _tower_moe(groups) -> bool:
    """The cell's parameters have an MoE layer in each tower."""
    return groups == "1-tower"


def batch(alg):
    rng = np.random.default_rng(7)
    vocab = get_config(ARCH, smoke=True).vocab_size
    return {"tokens": rng.integers(0, vocab, size=(M, B * LOCAL[alg], S)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def init(alg, tower_moe=False):
    """The reference's init (PRNGKey(0)) as numpy and as the port's state
    (the parameters do not depend on moe_groups or remat)."""
    upd = {**updates(1), **(TOWER_MOE if tower_moe else {})}
    cfg = jax_get_config(ARCH, smoke=True).with_updates(**upd)
    a = jax_alg.get_algorithm(alg)
    hp = jax_alg.HParams(lr=LR, local_steps=LOCAL[alg])
    state = jax.tree.map(np.asarray, jax.jit(
        lambda r: a.init_state(jax_build_model(cfg), r, M, hp))(jax.random.PRNGKey(0)))
    port_cfg = get_config(ARCH, smoke=True).with_updates(**upd)
    return state, state_from_jax(alg, state, "cpu", port_cfg)


@functools.lru_cache(maxsize=None)
def reference(alg, groups, chunk=None):
    """The reference's round, unchunked or over client chunks of `chunk`:
    (losses, final state, flattened)."""
    if groups == "1-remat":  # remat changes no value
        return reference(alg, 1, chunk)
    cfg = jax_get_config(ARCH, smoke=True).with_updates(**updates(groups))
    hp = jax_alg.HParams(lr=LR, local_steps=LOCAL[alg])
    a = jax_alg.get_algorithm(alg)
    rf = jax_alg.shard_round_fn(a, jax_build_model(cfg), M, hp, client_chunk=chunk)
    state = jax.tree.map(jax.numpy.asarray, init(alg, _tower_moe(groups))[0])
    b = {k: jax.numpy.asarray(v) for k, v in batch(alg).items()}
    sched = jax_schedule.full_schedule(M, a.steps_per_round(hp))
    losses = []
    for _ in range(ROUNDS):
        state, m = rf(state, b, sched)
        losses.append(float(m["loss"]))
    port_cfg = get_config(ARCH, smoke=True).with_updates(**updates(groups))
    return losses, flat_state(state_from_jax(alg, jax.tree.map(np.asarray, state),
                                             "cpu", port_cfg))


def payload(world, cells, ckpt=None):
    """The rounds task's payload for `cells` [(alg, groups, chunk)] on
    data=`world`, with the chunked checkpoint run's setting `ckpt`."""
    out = {}
    for alg, groups, chunk in cells:
        out[cell_key(world, alg, groups, chunk)] = {
            "cfg": {"arch": ARCH, "updates": updates(groups)}, "alg": alg, "M": M,
            "lr": LR, "local_steps": LOCAL[alg], "rounds": ROUNDS,
            "init": init(alg, _tower_moe(groups))[1], "batch": batch(alg),
            "mesh": f"data={world}", "chunk": chunk,
            "sched": ([1.0] * M, [LOCAL[alg]] * M), "dense": False}
    p = {"meshes": (f"data={world}",), "cells": out}
    if ckpt is not None:
        p["train"] = ckpt
    return p


def port_dense_round(groups, tally=False):
    """One port mtsl round without a mesh from a seeded init: (loss, kept
    rows, routed rows)."""
    cfg = get_config(ARCH, smoke=True).with_updates(**updates(groups))
    model = build_model(cfg)
    alg = get_algorithm("mtsl")
    state = alg.init_state(model, torch.Generator().manual_seed(0), M, HParams(lr=LR))
    return _port_round(model, state, tally)


def port_reference_init_round(groups, order, chunk):
    """One port mtsl round without a mesh from the reference's init, over
    client chunks of `chunk`, with the clients (towers and batch rows) in
    `order` (None: as they are): (loss, the reference's chunked loss)."""
    cfg = get_config(ARCH, smoke=True).with_updates(**updates(groups))
    state = copy.deepcopy(init("mtsl", _tower_moe(groups))[1])
    loss = _port_round(build_model(cfg), state, False, order, chunk)[0]
    return loss, reference("mtsl", groups, chunk)[0][0]


def _port_round(model, state, tally, order=None, chunk=None):
    from repro_torch.core.algorithms import shard_round_fn

    alg = get_algorithm("mtsl")
    b = batch("mtsl")
    if order is not None:
        idx = list(order)
        state = state._replace(params={**state.params,
                                       "towers": _rows(state.params["towers"], idx)})
        b = {k: v[idx] for k, v in b.items()}
    moe_mod.moe_forward.tally = torch.zeros(2, dtype=torch.int64) if tally else None
    try:
        _, m = shard_round_fn(alg, model, M, HParams(lr=LR), client_chunk=chunk)(
            state, stage_batch(b, "cpu"), full_schedule(M, 1))
        counts = moe_mod.moe_forward.tally
    finally:
        moe_mod.moe_forward.tally = None
    kept, routed = counts.tolist() if tally else (None, None)
    return float(m["loss"]), kept, routed


def _rows(tree, idx):
    """The client rows `idx` of every leaf of a stacked tower tree, as new
    leaves that require grad."""
    if isinstance(tree, dict):
        return {k: _rows(v, idx) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rows(v, idx) for v in tree]
    return tree.detach()[idx].clone().requires_grad_()
