"""The port's host scan round (`repro_torch.core.scan_round`) against the
dense mtsl round, as `tests/test_client_axis.py` holds the reference's,
and against the reference's scan round.

  * sgd, momentum and adamw x {full, masked}: 3 rounds of
    `build_mtsl_scan_round(chunk=4)` at M = 8 against the registry's dense
    mtsl round from one initial state: losses within 1e-5 of their scale,
    `acc` within 1e-6, parameters within 1e-5 (adamw divides by sqrt(v),
    which carries the blocks' reduction order into the step: within 1e-4
    of 1, as the reference's test's rtol).
  * Every update goes through K1's wrapper: M/chunk + 1 multi-tensor
    calls a round (the plain version on the CPU).
  * The same optimizers x {full, masked} against the reference's
    `build_mtsl_scan_round` from one converted init and the same batches
    (M = 4, chunk 2; `tests/torch_client_axis.py`): losses within 1e-5 of
    their scale, parameters at the tolerances above.
  * The restrictions raise; rounds at two M with one chunk run the same
    per-block functions (the port is eager: there is no compile to count).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.algorithms import HParams, get_algorithm
from repro_torch.core.scan_round import build_mtsl_scan_round
from repro_torch.core.schedule import ClientSchedule, full_schedule
from repro_torch.kernels.mtsl_update import ops as k1
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import momentum
from repro_torch.train.loop import stage_batch
from repro_torch.utils.device import generator
from repro_torch.utils.tree import tree_leaves
from torch_client_axis import check_scan_round

CFG = get_config("paper-mlp", smoke=True)
MODEL = build_model(CFG)  # one model: the per-block functions key on it


def _batch(M, rows, seed=0):
    rng = np.random.default_rng(seed)
    return stage_batch({
        "image": rng.normal(size=(M, rows, CFG.image_size, CFG.image_size))
        .astype(np.float32),
        "label": rng.integers(0, CFG.num_classes, size=(M, rows)).astype(np.int32)},
        "cpu")


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("sched_name", ["full", "masked"])
def test_scan_round_matches_dense_mtsl(opt_name, sched_name, monkeypatch):
    M, chunk = 8, 4
    opt = {"sgd": None, "momentum": momentum(0.1), "adamw": adamw(0.1)}[opt_name]
    hp = HParams(lr=0.1, optimizer=opt)
    alg = get_algorithm("mtsl")
    sched = (full_schedule(M, 1) if sched_name == "full" else
             ClientSchedule(np.array([1.0, 0.0] * (M // 2), np.float32),
                            np.ones(M, np.int32)))
    batch = _batch(M, 8)
    dense = alg.round_fn(MODEL, M, hp)
    scan = build_mtsl_scan_round(MODEL, M, hp, chunk=chunk)
    s_d = alg.init_state(MODEL, generator("cpu", 0), M, hp)
    s_s = alg.init_state(MODEL, generator("cpu", 0), M, hp)
    calls = []
    real = k1.mtsl_update_multi_
    monkeypatch.setattr("repro_torch.optim.per_component.mtsl_update_multi_",
                        lambda *a: calls.append(1) or real(*a))
    for _ in range(3):
        s_d, m_d = dense(s_d, batch, sched)
        n0 = len(calls)
        s_s, m_s = scan(s_s, batch, sched)
        assert len(calls) - n0 == M // chunk + 1
        scale = max(1.0, abs(float(m_d["loss"])))
        assert abs(float(m_d["loss"]) - float(m_s["loss"])) <= 1e-5 * scale
        assert abs(float(m_d["acc"]) - float(m_s["acc"])) <= 1e-6
    rtol = 1e-4 if opt_name == "adamw" else 0
    for x, y in zip(tree_leaves(s_d.params), tree_leaves(s_s.params)):
        torch.testing.assert_close(y.detach(), x.detach(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adamw"])
@pytest.mark.parametrize("sched_name", ["full", "masked"])
def test_scan_round_matches_reference_scan_round(opt_name, sched_name):
    check_scan_round(opt_name, sched_name)


def test_scan_round_rejects_unsupported():
    hp = HParams(lr=0.1)
    with pytest.raises(ValueError, match="divisible"):
        build_mtsl_scan_round(MODEL, 6, hp, chunk=4)
    with pytest.raises(ValueError, match="accumulation"):
        build_mtsl_scan_round(MODEL, 8, hp.with_updates(microbatches=2), chunk=4)
    round_fn = build_mtsl_scan_round(MODEL, 4, hp, chunk=2)
    state = get_algorithm("mtsl").init_state(MODEL, generator("cpu", 0), 4, hp)
    sched = full_schedule(4, 1)._replace(sizes=np.full((4,), 8, np.int32))
    with pytest.raises(ValueError, match="sizes"):
        round_fn(state, _batch(4, 8), sched)


def test_scan_round_one_build_across_m():
    chunk, hp = 2, HParams(lr=0.1)
    kernels = []
    for M in (4, 8):
        round_fn = build_mtsl_scan_round(MODEL, M, hp, chunk=chunk)
        state = get_algorithm("mtsl").init_state(MODEL, generator("cpu", 0), M, hp)
        round_fn(state, _batch(M, 8), None)
        kernels.append(round_fn.kernels)
    assert kernels[0] is kernels[1]
    assert build_mtsl_scan_round(MODEL, 8, hp, chunk=4).kernels is not kernels[0]
