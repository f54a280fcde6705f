"""The port's event engine against a live reference engine
(`repro.train.events.EventEngine`), and the snapshot resume.

  * On a heterogeneous deployment (one client at capability 0.2 on a star
    with 10 Mb/s links, staleness decay 0.6, max staleness 1; and a
    two-server multi-server topology with replica syncs every 2 rounds):
    the same event stream exactly (sim_time, applies, dispatches,
    participants, staleness, dropped updates, cohort completion) and
    every applied loss within 1e-5 of its scale, from the reference's
    initial state.
  * A mid-flight snapshot round-trips through the msgpack checkpoint and
    resumes bit for bit (in-flight payloads, schedules and arrival times;
    the replicas on a multi-server topology).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.core import topology as jax_topo
from repro.models.registry import build_model as jax_build_model
from repro.train.events import EventEngine as JaxEngine
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.train.checkpoint import load_algorithm_state, save_algorithm_state
from repro_torch.utils.convert import state_from_jax
from torch_async import (
    CFG,
    HP,
    MODEL,
    M,
    R,
    _batches,
    _bits_equal,
    _pairs,
    _port_engine,
    _topo,
)


# ------------------------------------------------ against the reference


@functools.lru_cache(maxsize=None)
def _reference(alg, kind):
    model = jax_build_model(jax_get_config("paper-mlp", smoke=True))
    a = jax_alg.get_algorithm(alg)
    hp = jax_alg.HParams(**HP)
    spr = a.steps_per_round(hp)
    state0 = jax.jit(lambda r: a.init_state(model, r, M, hp))(jax.random.PRNGKey(0))
    eng = JaxEngine(a, model, M, hp, _topo(kind, jax_topo), staleness_decay=0.6,
                    max_staleness=1, init_state=state0)
    pairs = [(b, jax_schedule.full_schedule(M, spr)) for b in _batches(spr)]
    events = [{k: (None if v is None else float(v["loss"])) if k == "metrics" else v
               for k, v in ev.items()}
              for ev in eng.run(iter(pairs), max_dispatches=R)]
    return jax.tree.map(np.asarray, state0), events, eng.dropped


@pytest.mark.parametrize("alg,kind", [("mtsl", "star"), ("splitfed", "star"),
                                      ("mtsl", "multi-server"),
                                      ("fedavg", "multi-server")])
def test_engine_matches_live_reference(alg, kind):
    state_j, events_j, dropped_j = _reference(alg, kind)
    eng = _port_engine(alg, kind, state_from_jax(alg, state_j, "cpu", CFG),
                       max_staleness=1)
    events = list(eng.run(_pairs(alg), max_dispatches=R))
    assert len(events) == len(events_j) > R
    assert max(ev["staleness"] for ev in events) > 0
    assert eng.dropped == dropped_j
    keys = ("sim_time", "applies", "dispatches", "participants", "staleness",
            "dropped", "cohort_done")
    losses = [ev["metrics"] for ev in events_j if ev["metrics"] is not None]
    scale = max(1.0, max(abs(x) for x in losses))
    for ev, ev_j in zip(events, events_j):
        assert {k: ev[k] for k in keys} == {k: ev_j[k] for k in keys}
        assert (ev["metrics"] is None) == (ev_j["metrics"] is None)
        if ev["metrics"] is not None:
            assert abs(float(ev["metrics"]["loss"]) - ev_j["metrics"]) <= 1e-5 * scale


# ------------------------------------------------ snapshot / resume


@pytest.mark.parametrize("alg,kind", [("mtsl", "star"), ("splitfed", "star"),
                                      ("mtsl", "multi-server")])
def test_snapshot_resume_is_bitwise(alg, kind, tmp_path):
    a = get_algorithm(alg)
    state0 = a.init_state(MODEL, torch.Generator().manual_seed(0), M, HParams(**HP))
    eng = _port_engine(alg, kind, state0)
    gen = eng.run(_pairs(alg), max_dispatches=R)
    for i, _ in enumerate(gen):
        if i == 3:  # stop mid-flight: cohorts still in the air
            break
    assert eng.cohorts
    path = str(tmp_path / "async.msgpack")
    save_algorithm_state(path, a, eng.state(), extra={"events": eng.snapshot()},
                         cfg=CFG)
    restored, name, extra = load_algorithm_state(path, cfg=CFG)
    snap = extra["events"]
    assert name == alg
    resumed = _port_engine(alg, kind, restored, snapshot=snap)
    for _ in resumed.run(_pairs(alg, snap["dispatches"]), max_dispatches=R):
        pass
    for _ in gen:  # finish the uninterrupted run
        pass
    assert (resumed.applies, resumed.t, resumed.dropped) == (eng.applies, eng.t,
                                                            eng.dropped)
    assert _bits_equal(resumed.state(), eng.state())


