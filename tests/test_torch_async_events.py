"""The port's event engine (`repro_torch.train.events`) and the loop's
async branch (`repro_torch.train.loop`).

  * Synchronous degeneration: under uniform capability and ideal links the
    async loop's trajectory equals the synchronous loop's, bit for bit,
    for all seven algorithms (history and final state).
  * train()'s async checkpoint (extra["events"]) resumes to the
    uninterrupted state, bit for bit.
  * Multi-server replicas hold no shared tensors and replay
    deterministically.

The event stream against a live reference engine and the mid-flight
snapshot resume are in tests/test_torch_async_reference.py (shared
helpers: tests/torch_async.py).
"""
import itertools

import pytest
import torch

from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.data.pipeline import client_batches
from repro_torch.optim import sgd
from repro_torch.train.checkpoint import load_algorithm_state
from repro_torch.train.loop import TrainConfig, train
from torch_async import (
    ALL_ALGS,
    CFG,
    HP,
    MODEL,
    M,
    R,
    _bits_equal,
    _leaves,
    _pairs,
    _port_engine,
    _source,
)


# ------------------------------------------------ synchronous degeneration


@pytest.mark.parametrize("alg", ALL_ALGS)
def test_async_equals_sync_under_uniform_ideal(alg):
    ls = 1 if alg == "mtsl" else 2
    out = {}
    for mode in (False, True):
        tcfg = TrainConfig(steps=4 * ls, algorithm=alg, lr=0.05, local_steps=ls,
                           log_every=1, device="cpu", async_mode=mode)
        out[mode] = train(MODEL, sgd(0.05), client_batches(_source(), 4 * ls, seed=0),
                          tcfg, M, log=lambda _: None)
    (s0, h0), (s1, h1) = out[False], out[True]
    assert [e["loss"] for e in h1] == [e["loss"] for e in h0]
    assert [e["round"] for e in h1] == [e["round"] for e in h0]
    assert all(e["staleness"] == 0 for e in h1)
    assert _bits_equal(s1, s0)


def test_train_async_checkpoint_resume(tmp_path):
    spr, rounds = 2, 4
    ck = str(tmp_path / "ck.msgpack")

    def mk(skip=0):
        return itertools.islice(client_batches(_source(), 4 * spr, steps=rounds,
                                               seed=0), skip, rounds)

    # uniform capability: a run cut after `rounds // 2` dispatches drains
    # no straggler early, so resuming must reach the uninterrupted state
    base = dict(algorithm="mtsl", lr=0.1, local_steps=2, log_every=0,
                device="cpu", async_mode=True)
    s_full, _ = train(MODEL, sgd(0.1), mk(), TrainConfig(steps=rounds, **base), M,
                      log=lambda _: None)
    train(MODEL, sgd(0.1), mk(),
          TrainConfig(steps=rounds // 2, checkpoint_path=ck, **base), M,
          log=lambda _: None)
    restored, _, extra = load_algorithm_state(ck, cfg=CFG)
    snap = extra["events"]
    assert snap["dispatches"] == rounds // 2 and extra["sim_time"] == snap["sim_time"]
    s_res, _ = train(MODEL, sgd(0.1), mk(skip=snap["dispatches"]),
                     TrainConfig(steps=rounds, **base), M, log=lambda _: None,
                     init_state=restored, init_events=snap)
    assert _bits_equal(s_res, s_full)


# ------------------------------------------------ multi-server replicas


@pytest.mark.parametrize("alg", ["mtsl", "fedavg"])
def test_multi_server_replicas_sync_periodically(alg):
    a = get_algorithm(alg)
    state0 = a.init_state(MODEL, torch.Generator().manual_seed(0), M, HParams(**HP))
    runs = []
    for _ in range(2):
        eng = _port_engine(alg, "multi-server", state0)
        for _ in eng.run(_pairs(alg), max_dispatches=R):
            pass
        runs.append(eng)
    eng = runs[0]
    assert eng.S == 2 and len(eng.replicas) == 2 and min(eng.rounds_done) >= 1
    ptrs = [{x.data_ptr() for x in _leaves(r)} for r in eng.replicas]
    assert not ptrs[0] & ptrs[1]  # replicas share no storage
    assert all(torch.isfinite(x).all() for x in _leaves(eng.state()))
    assert _bits_equal(eng.state(), runs[1].state())
