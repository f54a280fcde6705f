"""Checkpoint and resume in the port's train loop (the twins of the
reference's tests/test_pipeline.py resume tests, on the synchronous loop:
the port has no prefetch pipeline, and the reference guarantees that any
depth gives the synchronous trajectory).

  * a run checkpointed after 3 of 6 rounds and resumed from the file
    (init_state, start_round, the remaining batches) reproduces the
    uninterrupted run: history and final state bit for bit, for mtsl,
    fedavg and parallelsfl under a heterogeneous schedule (the seeded
    stream must resume at the absolute round);
  * with log and eval cadences that skip rounds, the resumed history and
    its evals equal the uninterrupted run's tail;
  * a resumed run's periodic checkpoints land on absolute rounds;
  * under a topology the simulated clock survives the resume
    ("sim_time" in the checkpoint's extra, start_sim_time);
  * without a topology the extra is exactly {"step", "round"}.
"""
import functools

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.core.schedule import ScheduleConfig
from repro_torch.core.topology import star
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models import build_model
from repro_torch.optim import sgd
from repro_torch.train.checkpoint import load_algorithm_state
from repro_torch.train.loop import TrainConfig, train
from repro_torch.utils.tree import tree_leaves_with_path

HET_SCHEDULE = ScheduleConfig(participation_rate=0.6, straggler_frac=0.5, seed=11)


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config("paper-mlp", smoke=True)
    src = MultiTaskImageSource(num_classes=cfg.num_clients,
                               image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=0)
    return cfg, build_model(cfg), src


def _leaves(state):
    """{path: tensor} of a state (TrainState, dict or tuple)."""
    if hasattr(state, "params"):
        state = {"params": state.params, "opt": list(state.opt_state),
                 "step": torch.tensor(state.step)}
    elif isinstance(state, tuple):
        state = list(state)
    return dict(tree_leaves_with_path(state))


def _assert_same_state(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert sorted(la) == sorted(lb)
    for k in la:
        assert torch.equal(la[k].detach(), lb[k].detach()), k


_RESUME = ("init_state", "start_round", "start_sim_time", "eval_batches")


def _run(alg, rounds, batches, **kw):
    """train() for `rounds` rounds; `kw` holds TrainConfig fields (log_every
    1 unless given) and train()'s resume arguments."""
    cfg, model, _ = _setup()
    ls = 1 if alg == "mtsl" else 2
    spr = get_algorithm(alg).steps_per_round(HParams(local_steps=ls))
    fields = dict(steps=rounds * spr, algorithm=alg, lr=0.1, local_steps=ls,
                  log_every=1, seed=0, batch_per_client=4, device="cpu")
    fields.update({k: v for k, v in kw.items() if k not in _RESUME})
    return train(model, sgd(0.1), iter(batches), TrainConfig(**fields),
                 cfg.num_clients, log=lambda s: None,
                 **{k: v for k, v in kw.items() if k in _RESUME})


def _batches(alg, rounds):
    _, _, src = _setup()
    ls = 1 if alg == "mtsl" else 2
    spr = get_algorithm(alg).steps_per_round(HParams(local_steps=ls))
    return list(client_batches(src, 4 * spr, steps=rounds, seed=0))


@pytest.mark.parametrize("alg", ["mtsl", "fedavg", "parallelsfl"])
def test_checkpoint_resume_matches_uninterrupted(alg, tmp_path):
    cfg, _, _ = _setup()
    rounds = 6
    batches = _batches(alg, rounds)
    state_ref, h_ref = _run(alg, rounds, batches, schedule=HET_SCHEDULE)
    path = str(tmp_path / f"{alg}.msgpack")
    _, h_part1 = _run(alg, 3, batches[:3], schedule=HET_SCHEDULE,
                      checkpoint_path=path)
    restored, name, extra = load_algorithm_state(path, alg, cfg=cfg)
    assert name == alg and extra["round"] == 3
    state_res, h_part2 = _run(alg, rounds, batches[3:], schedule=HET_SCHEDULE,
                              init_state=restored, start_round=extra["round"])
    resumed = h_part1 + h_part2
    for key in ("loss", "step", "round", "participants"):
        assert [e[key] for e in resumed] == [e[key] for e in h_ref], key
    _assert_same_state(state_res, state_ref)


def test_resume_matches_uninterrupted_with_coprime_cadences(tmp_path):
    """Log and eval cadences that do not fire every round: the resumed run
    logs no first round the uninterrupted run lacks, and its eval stream
    resumes at the same position (two distinct eval batches show an
    offset)."""
    cfg, _, src = _setup()
    kw = dict(log_every=4, eval_every=2, schedule=HET_SCHEDULE,
              eval_batches=[next(client_batches(src, 8, seed=s)) for s in (123, 321)])
    batches = _batches("fedavg", 6)
    _, h_ref = _run("fedavg", 6, batches, **kw)
    path = str(tmp_path / "ck.msgpack")
    _run("fedavg", 3, batches[:3], checkpoint_path=path, **kw)
    restored, _, extra = load_algorithm_state(path, "fedavg", cfg=cfg)
    _, h_tail = _run("fedavg", 6, batches[3:], init_state=restored,
                     start_round=extra["round"], **kw)
    ref_tail = [e for e in h_ref if e["round"] > 3]
    assert any("acc_mtl" in e for e in ref_tail)
    for key in ("round", "loss", "acc_mtl"):
        assert [e.get(key) for e in h_tail] == [e.get(key) for e in ref_tail], key


def test_resume_checkpoint_cadence_uses_absolute_rounds(tmp_path):
    cfg, _, _ = _setup()
    path = str(tmp_path / "ck.msgpack")
    batches = _batches("fedavg", 6)
    _run("fedavg", 3, batches[:3], checkpoint_path=path)
    restored, _, extra = load_algorithm_state(path, "fedavg", cfg=cfg)
    _run("fedavg", 6, batches[3:], checkpoint_path=path, checkpoint_every=2,
         init_state=restored, start_round=extra["round"])
    _, _, extra2 = load_algorithm_state(path, "fedavg", cfg=cfg)
    # absolute rounds 4 and 6 hit the every-2 cadence; the last write is
    # round 6 = gradient step 12
    assert extra2 == {"step": 12, "round": 6}


def test_sim_time_survives_checkpoint_resume(tmp_path):
    cfg, _, _ = _setup()
    topo = star(cfg.num_clients)
    batches = _batches("mtsl", 6)
    _, h_ref = _run("mtsl", 6, batches, topology=topo)
    sims = [e["sim_time"] for e in h_ref]
    assert sims == sorted(sims) and sims[0] > 0
    path = str(tmp_path / "ck.msgpack")
    _run("mtsl", 3, batches[:3], topology=topo, checkpoint_path=path)
    restored, _, extra = load_algorithm_state(path, "mtsl", cfg=cfg)
    assert extra["round"] == 3
    assert extra["sim_time"] == pytest.approx(h_ref[2]["sim_time"])
    _, h_tail = _run("mtsl", 6, batches[3:], topology=topo, init_state=restored,
                     start_round=extra["round"], start_sim_time=extra["sim_time"])
    assert [e["sim_time"] for e in h_tail] == pytest.approx(sims[3:])
    assert [e["loss"] for e in h_tail] == [e["loss"] for e in h_ref[3:]]


def test_checkpoint_extra_has_no_sim_time_without_topology(tmp_path):
    cfg, _, _ = _setup()
    path = str(tmp_path / "ck.msgpack")
    _run("mtsl", 2, _batches("mtsl", 2), checkpoint_path=path)
    _, _, extra = load_algorithm_state(path, "mtsl", cfg=cfg)
    assert set(extra) == {"step", "round"}
