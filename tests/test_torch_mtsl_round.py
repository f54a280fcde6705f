"""The port's mtsl round against the JAX reference's.

Three rounds through each package's registry on the smoke configs of
paper-mlp and paper-resnet16, from the same initial tree (initialised in
JAX, carried across with `params_from_jax`) and the same numpy batches,
each package drawing its own (byte-identical) schedule stream. Schedules:
full, masked (participation 0.5), capability batching (with stragglers),
and microbatches=2. The reference round is `jit_round_fn`; the port's is
the registry's `round_fn`, which applies the update through K1's plain
version on CPU tensors. Tolerance: losses, per-task losses and every
parameter leaf within 1e-5 (f32, reduction order); acc_mtl of the final
state equal.

The full case runs without a ComponentLR (both packages default to the
server LR x 2/M); the others run the launcher's server_scaled(M) (1/M).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import lr_policy as jax_lr_policy
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import lr_policy, schedule
from repro_torch.core.mtsl import TrainState
from repro_torch.data.pipeline import client_batches
from repro_torch.data.synthetic import MultiTaskImageSource
from repro_torch.models.registry import build_model
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_leaves, tree_leaves_with_path, tree_map

ARCHS = ["paper-mlp", "paper-resnet16"]
ROUNDS, B, LR, TOL = 3, 4, 0.1, 1e-5
CASES = {  # name: (ScheduleConfig kwargs, microbatches, server-scaled clr)
    "full": ({}, 1, False),
    "masked": ({"participation_rate": 0.5, "seed": 3}, 1, True),
    "capability": ({"capability_batching": True, "straggler_frac": 0.5,
                    "seed": 1}, 1, True),
    "microbatches": ({}, 2, True),
}


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    hp = jax_alg.HParams(lr=LR)
    init = jax.jit(lambda rng: jax_alg.get_algorithm("mtsl").init_state(
        model, rng, cfg.num_clients, hp))  # one compile, not one per eager op
    return cfg, model, init(jax.random.PRNGKey(5))


def _port_state(arch, cfg):
    _, _, state_j = _reference_init(arch)
    params = params_from_jax(jax.tree.map(np.asarray, state_j.params), "cpu", cfg)
    return TrainState(tree_map(lambda x: x.requires_grad_(), params), (), 0)


def _batches(cfg, width, n, seed=0):
    src = MultiTaskImageSource(num_classes=cfg.num_clients, image_size=cfg.image_size,
                               channels=cfg.image_channels, seed=seed)
    return list(client_batches(src, width, steps=n, seed=seed))


def _run_case(arch, case):
    skw, mb, scaled = CASES[case]
    cfg_j, model_j, state_j = _reference_init(arch)
    cfg = get_config(arch, smoke=True)
    assert cfg.__dict__ == cfg_j.__dict__
    M = cfg.num_clients
    hp_j = jax_alg.HParams(lr=LR, microbatches=mb,
                           component_lr=jax_lr_policy.server_scaled(M) if scaled else None)
    hp = alg_mod.HParams(lr=LR, microbatches=mb,
                         component_lr=lr_policy.server_scaled(M) if scaled else None)
    scfg_j = jax_schedule.ScheduleConfig(**skw)
    scfg = schedule.ScheduleConfig(**skw)
    width = schedule.padded_batch_per_client(scfg, B)
    stream_j = jax_schedule.schedule_stream(scfg_j, M, 1, B)
    stream = schedule.schedule_stream(scfg, M, 1, B)
    rf_j = jax_alg.jit_round_fn(jax_alg.get_algorithm("mtsl"), model_j, M, hp_j)
    alg = alg_mod.get_algorithm("mtsl")
    model = build_model(cfg)
    rf = alg.round_fn(model, M, hp)
    state = _port_state(arch, cfg)
    batches = _batches(cfg, width, ROUNDS)
    for batch in batches:
        state_j, met_j = rf_j(state_j, batch, next(stream_j))
        state, met = rf(state, stage_batch(batch, "cpu"), next(stream))
        np.testing.assert_allclose(float(met["loss"]), float(met_j["loss"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(met["per_task"].numpy(),
                                   np.asarray(met_j["per_task"]), rtol=TOL, atol=TOL)
    leaves_j = flatten_dict(state_j.params)
    leaves = dict(tree_leaves_with_path(state.params))
    assert sorted(leaves) == sorted(leaves_j)
    for path, a in leaves.items():
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(leaves_j[path]),
                                   rtol=TOL, atol=TOL, err_msg=path)
    assert state.step == int(state_j.step) == ROUNDS
    ev_batch = _batches(cfg, 8, 1, seed=9)[0]
    acc_j = jax.jit(jax_alg.get_algorithm("mtsl").eval_fn(model_j, M))(state_j, ev_batch)
    acc = alg.eval_fn(model, M)(state, stage_batch(ev_batch, "cpu"))
    assert float(acc["acc_mtl"]) == float(acc_j["acc_mtl"])
    np.testing.assert_array_equal(acc["per_task_acc"].numpy(),
                                  np.asarray(acc_j["per_task_acc"]))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_mtsl_round_matches_jax(arch, case):
    _run_case(arch, case)


@pytest.mark.parametrize("arch", ARCHS)
def test_all_ones_schedule_is_bit_identical_to_none(arch):
    cfg = get_config(arch, smoke=True)
    M = cfg.num_clients
    model = build_model(cfg)
    rf = alg_mod.get_algorithm("mtsl").round_fn(model, M, alg_mod.HParams(lr=LR))
    batches = _batches(cfg, B, 2)
    a, b = _port_state(arch, cfg), _port_state(arch, cfg)
    for batch in batches:
        a, met_a = rf(a, stage_batch(batch, "cpu"), None)
        b, met_b = rf(b, stage_batch(batch, "cpu"), schedule.full_schedule(M, 1))
        assert torch.equal(met_a["loss"], met_b["loss"])
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_phases_compose_to_the_round():
    arch = "paper-mlp"
    cfg = get_config(arch, smoke=True)
    M = cfg.num_clients
    model = build_model(cfg)
    alg = alg_mod.get_algorithm("mtsl")
    hp = alg_mod.HParams(lr=LR)
    prog = alg.phases(model, M, hp)
    rf = alg.round_fn(model, M, hp)
    sched = next(schedule.schedule_stream(
        schedule.ScheduleConfig(participation_rate=0.5, seed=3), M, 1))
    batch = stage_batch(_batches(cfg, B, 1)[0], "cpu")
    a, b = _port_state(arch, cfg), _port_state(arch, cfg)
    a, met_a = rf(a, batch, sched)
    b, met_b = prog.apply(b, prog.local(b, batch, sched), sched)
    assert torch.equal(met_a["loss"], met_b["loss"])
    for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)):
        assert torch.equal(x, y)


def test_server_lr_defaults():
    """The launcher's policy is server_scaled(M) = 1/M; `train()` without a
    ComponentLR falls back to 2/M inside the mtsl round: bit-identical to
    passing server_scaled(M, 2/M), and not to the launcher's 1/M."""
    from repro_torch.optim import sgd
    from repro_torch.train.loop import TrainConfig, train

    M = 10
    assert float(lr_policy.server_scaled(M).server) == pytest.approx(1 / M)
    cfg = get_config("paper-mlp", smoke=True)
    M = cfg.num_clients
    model = build_model(cfg)

    def run(clr):
        state, hist = train(model, sgd(LR), _batches(cfg, B, 2),
                            TrainConfig(steps=2, device="cpu", log_every=1),
                            M, component_lr=clr, log=lambda _: None,
                            init_state=_port_state("paper-mlp", cfg))
        return state, [e["loss"] for e in hist]

    default, explicit = run(None), run(lr_policy.server_scaled(M, 2.0 / M))
    launcher = run(lr_policy.server_scaled(M))
    assert default[1] == explicit[1] != launcher[1]
    for a, b in zip(tree_leaves(default[0].params), tree_leaves(explicit[0].params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_float64_tree_keeps_float64_gradients(arch):
    """The card's precision witness runs the round's forward and backward
    on an f64 tree: the loss must not round the logits to f32 on the way.
    Its gradients are f64, and the f32 tree's are within f32 rounding of
    them (1e-5 of each leaf's largest gradient)."""
    from repro_torch.core.mtsl import build_train_phases
    from repro_torch.optim import sgd

    cfg = get_config(arch, smoke=True)
    M = cfg.num_clients
    local_step, _ = build_train_phases(build_model(cfg), sgd(LR), M)
    batch = stage_batch(_batches(cfg, B, 1)[0], "cpu")
    mask = torch.tensor([1.0, 0.0] * (M // 2) + [1.0] * (M % 2))
    s32 = _port_state(arch, cfg)
    s64 = TrainState(tree_map(lambda x: x.detach().double().requires_grad_(),
                              s32.params), (), 0)
    b64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    g32, m32 = local_step(s32, batch, mask)
    g64, m64 = local_step(s64, b64, mask)
    assert m64["loss"].dtype == torch.float64 and m32["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(m32["loss"]), float(m64["loss"]), rtol=1e-6)
    for (path, a), b in zip(tree_leaves_with_path(g32), tree_leaves(g64)):
        assert b.dtype == torch.float64, path
        scale = float(b.abs().max()) or 1.0
        assert float((a.double() - b).abs().max()) <= 1e-5 * scale, path


def test_lr_policies_match_jax():
    sm = np.array([0.5, 1.0, 10.0, 2.0], np.float32)
    pairs = [
        (lr_policy.uniform(4, 0.3), jax_lr_policy.uniform(4, 0.3)),
        (lr_policy.server_scaled(4), jax_lr_policy.server_scaled(4)),
        (lr_policy.server_scaled(4, 0.7, 2.0), jax_lr_policy.server_scaled(4, 0.7, 2.0)),
        (lr_policy.moment_scaled(sm, 0.5), jax_lr_policy.moment_scaled(sm, 0.5)),
        (lr_policy.linear_lipschitz(1.5, [0.2, 1.0, 3.0, 0.5], [0.1, 0.0, 0.3, 1.0], sm, 0.9),
         jax_lr_policy.linear_lipschitz(1.5, [0.2, 1.0, 3.0, 0.5], [0.1, 0.0, 0.3, 1.0], sm, 0.9)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(float(ours.server), float(ref.server), rtol=1e-6)
        np.testing.assert_allclose(ours.clients.numpy(), np.asarray(ref.clients), rtol=1e-6)
