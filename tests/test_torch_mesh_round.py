"""The port's sharded rounds (`shard_round_fn(mesh=)`,
`place_algorithm_state`, `gather_algorithm_state`) on a 4-rank gloo world
on the CPU, against the reference's dense round and the port's own.

The reference's sharded round does not run on this JAX (its mesh has
Explicit axes, which `with_sharding_constraint` refuses), so, as the
reference's tests/test_sharding_parity.py holds its sharded round against
its dense one, the port's is held against:

  * the reference's dense round (`jit_round_fn`) from the reference's init
    (PRNGKey(0)) carried across with `state_from_jax`;
  * the port's dense round from the same init.

Cells (paper-mlp smoke, M = 8, 3 rounds, lr 0.1, the reference test's
batch shapes and schedules):

  * the seven algorithms x {full, masked (half the clients, straggler
    budgets)} on `data=4`;
  * mtsl and fedavg on `data=2,model=2` and `pod=2,data=2` (the model
    axis's replicas compute the same round: every rank's gathered state
    is bit-equal);
  * the seven algorithms on `data=2,model=2` with a client chunk of 4
    (each rank scans two blocks of two of its own clients);
  * MoE (deepseek-moe-16b smoke, M = 4, moe_groups = 4 = D) on `data=4`:
    each rank dispatches its own tokens as its one group;
  * evals gathered; `make_mesh_from_spec` refusing a spec larger than the
    world.

Tolerances: every state leaf within 1e-5 absolute, every round loss
within 1e-5 of max(1, |loss|), against both; evals equal. The refusals
(no client_axes, M not divisible by D, a chunk that is not a multiple of
D) are made without a world, each with the reference's message. An MoE at
any moe_groups under a mesh is tests/test_torch_moe_mesh_groups.py's.

One spawn per module (tests/torch_mesh_ranks.py) runs every cell; the
parent computes the reference's inits and rounds, in threads, while the
ranks start and run.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core.algorithms import (
    Algorithm,
    HParams,
    get_algorithm,
    shard_round_fn,
)
from repro_torch.launch.mesh import make_mesh_from_spec
from repro_torch.models.registry import build_model
from repro_torch.utils.convert import state_from_jax
from torch_mesh_ranks import ROUNDS_ALGS, flat_state, max_gap, spawn

M, ROUNDS, LR, TOL = 8, 3, 0.1, 1e-5
WORLD = 4
CFG = get_config("paper-mlp", smoke=True)
MOE = {"arch": "deepseek-moe-16b", "M": 4, "b": 2, "S": 16, "rounds": 2}
SCHEDS = {"full": [1.0] * M, "masked": [1.0, 0.0] * (M // 2)}  # the masks


class StubMesh:
    def __init__(self, **sizes):
        self.shape = dict(sizes)


def _ls(alg):
    return 1 if alg == "mtsl" else 2


def _sched(name, ls):
    """(mask, budget): the masked schedule's stragglers stop after one step."""
    budget = [ls] * M if name == "full" else [ls, 1] * (M // 2)
    return SCHEDS[name], budget


def _batch(spr, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(M, 8 * spr, CFG.image_size, CFG.image_size))
            .astype(np.float32),
            "label": rng.integers(0, CFG.num_classes, size=(M, 8 * spr)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _init(alg):
    """The reference's init (PRNGKey(0)) as numpy, and the port's state."""
    model = jax_build_model(jax_get_config("paper-mlp", smoke=True))
    a = jax_alg.get_algorithm(alg)
    hp = jax_alg.HParams(lr=LR, local_steps=_ls(alg))
    init = jax.tree.map(np.asarray, jax.jit(
        lambda r: a.init_state(model, r, M, hp))(jax.random.PRNGKey(0)))
    return init, state_from_jax(alg, init, "cpu", CFG)


def _moe_cfg(module):
    get = get_config if module == "port" else jax_get_config
    return get(MOE["arch"], smoke=True).with_updates(num_clients=MOE["M"],
                                                     moe_groups=MOE["M"])


def _moe_batch():
    rng = np.random.default_rng(7)
    vocab = _moe_cfg("port").vocab_size
    return {"tokens": rng.integers(0, vocab, size=(MOE["M"], MOE["b"], MOE["S"]))
            .astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _moe_init():
    cfg = _moe_cfg("ref")
    model = jax_build_model(cfg)
    a = jax_alg.get_algorithm("mtsl")
    hp = jax_alg.HParams(lr=LR)
    init = jax.tree.map(np.asarray, jax.jit(
        lambda r: a.init_state(model, r, MOE["M"], hp))(jax.random.PRNGKey(0)))
    return init, state_from_jax("mtsl", init, "cpu", _moe_cfg("port"))


def _payload():
    cells = {}
    mlp = {"arch": "paper-mlp", "updates": {}}
    for alg in ROUNDS_ALGS:
        ls = _ls(alg)
        common = {"cfg": mlp, "alg": alg, "M": M, "lr": LR, "local_steps": ls,
                  "rounds": ROUNDS, "init": _init(alg)[1],
                  "batch": _batch(1 if alg == "mtsl" else ls, ROUNDS_ALGS.index(alg))}
        for s in SCHEDS:
            cells[f"data=4/{alg}/{s}"] = {**common, "mesh": "data=4",
                                          "sched": _sched(s, ls)}
        full = {**common, "sched": _sched("full", ls), "dense": False}
        if alg in ("mtsl", "fedavg"):
            for spec in ("data=2,model=2", "pod=2,data=2"):
                cells[f"{spec}/{alg}/full"] = {**full, "mesh": spec}
        cells[f"data=2,model=2+chunk4/{alg}/full"] = {
            **full, "mesh": "data=2,model=2", "chunk": 4}
    cells["data=4/moe/full"] = {
        "cfg": {"arch": MOE["arch"], "updates": {"num_clients": MOE["M"],
                                                 "moe_groups": MOE["M"]}},
        "alg": "mtsl", "M": MOE["M"], "lr": LR, "local_steps": 1,
        "rounds": MOE["rounds"], "init": _moe_init()[1], "batch": _moe_batch(),
        "mesh": "data=4", "sched": ([1.0] * MOE["M"], [1] * MOE["M"])}
    return {"meshes": ("data=4", "data=2,model=2", "pod=2,data=2"), "cells": cells}


@functools.lru_cache(maxsize=None)
def _reference(alg):
    """The reference's dense round: {schedule: (losses, final state in the
    port's layout, flattened)}."""
    if alg == "moe":
        model, Mr, ls = jax_build_model(_moe_cfg("ref")), MOE["M"], 1
        init, rounds, batch = _moe_init()[0], MOE["rounds"], _moe_batch()
        scheds = {"full": jax_schedule.full_schedule(Mr, 1)}
        port_cfg, a = _moe_cfg("port"), jax_alg.get_algorithm("mtsl")
    else:
        model = jax_build_model(jax_get_config("paper-mlp", smoke=True))
        Mr, ls, rounds = M, _ls(alg), ROUNDS
        a = jax_alg.get_algorithm(alg)
        init = _init(alg)[0]
        batch = _batch(a.steps_per_round(jax_alg.HParams(local_steps=ls)),
                       ROUNDS_ALGS.index(alg))
        scheds = {name: jax_schedule.ClientSchedule(
            mask=jnp.asarray(_sched(name, ls)[0], jnp.float32),
            budget=jnp.asarray(_sched(name, ls)[1], jnp.int32)) for name in SCHEDS}
        port_cfg = CFG
    rf = jax_alg.jit_round_fn(a, model, Mr, jax_alg.HParams(lr=LR, local_steps=ls))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for name, sch in scheds.items():
        state, losses = jax.tree.map(jnp.asarray, init), []
        for _ in range(rounds):
            state, m = rf(state, batch, sch)
            losses.append(float(m["loss"]))
        port = state_from_jax("mtsl" if alg == "moe" else alg,
                              jax.tree.map(np.asarray, state), "cpu", port_cfg)
        out[name] = (losses, flat_state(port))
    return out


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    """The ranks import the port while the parent draws the reference's
    inits; they run every cell while the parent runs the reference's
    rounds (XLA compiles in threads, in parallel)."""
    send, join = spawn(WORLD, "rounds", tmp_path_factory.mktemp("mesh_rounds"))
    with ThreadPoolExecutor(len(ROUNDS_ALGS) + 1) as ex:
        list(ex.map(lambda a: _moe_init() if a == "moe" else _init(a),
                    (*ROUNDS_ALGS, "moe")))
        send(_payload())
        list(ex.map(_reference, (*ROUNDS_ALGS, "moe")))
    return join()


def _check(losses, state, want_losses, want_state, what):
    scale = max(1.0, max(abs(x) for x in want_losses))
    gap = max(abs(a - b) for a, b in zip(losses, want_losses))
    assert len(losses) == len(want_losses) and gap <= TOL * scale, (
        what, losses, want_losses)
    sgap = max_gap(state, want_state)
    assert sgap <= TOL, (what, sgap)


CELLS = ([f"data=4/{a}/{s}" for a in ROUNDS_ALGS for s in SCHEDS]
         + [f"{spec}/{a}/full" for spec in ("data=2,model=2", "pod=2,data=2")
            for a in ("mtsl", "fedavg")]
         + [f"data=2,model=2+chunk4/{a}/full" for a in ROUNDS_ALGS]
         + ["data=4/moe/full"])


@pytest.mark.parametrize("cell", CELLS)
def test_sharded_round_matches_dense(report, cell):
    """The sharded round against the port's dense round and the
    reference's, from the same init: losses and every state leaf; the
    gathered state is the same on every rank; evals equal."""
    spec, alg, sched = cell.split("/")
    got = report["cells"][cell]["mesh"]
    losses, state, ev, spread = got
    assert spread == 0.0, (cell, spread)  # model-axis replicas and ranks agree
    dense_key = f"data=4/{alg}/{sched}"
    d_losses, d_state, d_ev = report["cells"][dense_key]["dense"]
    r_losses, r_state = _reference(alg)[sched]
    _check(losses, state, d_losses, d_state, f"{cell} vs the port's dense")
    _check(losses, state, r_losses, r_state, f"{cell} vs the reference's dense")
    if ev is not None:
        for k in d_ev:
            np.testing.assert_allclose(ev[k], d_ev[k], rtol=0, atol=1e-6, err_msg=k)


def test_mesh_larger_than_world_refused(report):
    assert "needs 8 ranks but only 4 are available" in report["refusals"]["world"]
    with pytest.raises(RuntimeError, match="initialised torch.distributed"):
        make_mesh_from_spec("data=2")  # this process has no world


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["no_client_axes", "indivisible", "chunk"])
def test_shard_round_refusals_match_reference(case):
    """The reference makes these refusals before it touches the mesh's
    devices, so both take a stub with `.shape`."""
    jmodel = jax_build_model(jax_get_config("paper-mlp", smoke=True))
    model = build_model(CFG)
    stub = StubMesh(data=4)
    if case == "no_client_axes":
        base, jbase = get_algorithm("mtsl"), jax_alg.get_algorithm("mtsl")
        alg = Algorithm(**{**base.__dict__, "name": "no-axes", "client_axes": None})
        jalg = jax_alg.Algorithm(**{**jbase.__dict__, "name": "no-axes",
                                    "client_axes": None})
        args, kw = (8,), {}
    elif case == "indivisible":
        alg, jalg, args, kw = get_algorithm("mtsl"), jax_alg.get_algorithm("mtsl"), (6,), {}
    else:
        alg, jalg = get_algorithm("mtsl"), jax_alg.get_algorithm("mtsl")
        args, kw = (8,), {"client_chunk": 2}
    want = _refusal(lambda: jax_alg.shard_round_fn(jalg, jmodel, *args, jax_alg.HParams(),
                                                   mesh=stub, **kw))
    got = _refusal(lambda: shard_round_fn(alg, model, *args, HParams(), mesh=stub, **kw))
    assert got == want
