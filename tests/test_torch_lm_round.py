"""The port's mtsl round on the decoder LMs against the JAX reference's.

The LM batches of both packages are byte-identical. Then three rounds
through each package's registry on the smoke configs of mamba2-130m (ssm)
and zamba2-7b (hybrid: Mamba2 layers and the stack-level shared attention
block), from one initial tree (initialised in JAX, carried across with
`params_from_jax`) and the same numpy token batches, each package drawing
its own (byte-identical) schedule stream. Cases: the full schedule, a
masked schedule (participation 0.5) and microbatches=2; one zamba2 case
runs the reference with its Pallas kernels on (`use_flash_kernel`,
interpret mode). The reference round is `jit_round_fn`; the port's is the
registry's `round_fn`, whose attention and SSD scan run the kernels' plain
versions on CPU tensors. Tolerance: losses, per-task losses and every
parameter leaf within 1e-5 (f32, reduction order); the LM eval's
per-task losses within 1e-5.
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
from repro.data.lm import MultiTaskLMSource as JaxLMSource
from repro.data.pipeline import client_batches as jax_client_batches
from repro.models.registry import build_model as jax_build_model
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import lr_policy, schedule
from repro_torch.core.mtsl import TrainState
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
from repro_torch.models.registry import build_model
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import params_from_jax
from repro_torch.utils.tree import tree_leaves_with_path, tree_map

ROUNDS, B, S, LR, TOL = 3, 2, 24, 0.1, 1e-5
CASES = {  # name: (arch, ScheduleConfig kwargs, microbatches, reference kernels)
    "mamba2-full": ("mamba2-130m", {}, 1, False),
    "mamba2-masked": ("mamba2-130m", {"participation_rate": 0.5, "seed": 3}, 1, False),
    "mamba2-microbatches": ("mamba2-130m", {}, 2, False),
    "zamba2-full": ("zamba2-7b", {}, 1, False),
    "zamba2-masked-kernels": ("zamba2-7b", {"participation_rate": 0.5, "seed": 3},
                              1, True),
    "zamba2-microbatches": ("zamba2-7b", {}, 2, False),
}


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    init = jax.jit(lambda rng: jax_alg.get_algorithm("mtsl").init_state(
        model, rng, cfg.num_clients, jax_alg.HParams(lr=LR)))
    return init(jax.random.PRNGKey(11))


def _port_state(arch, cfg):
    params = params_from_jax(jax.tree.map(np.asarray, _reference_init(arch).params),
                             "cpu", cfg)
    return TrainState(tree_map(lambda x: x.requires_grad_(), params), (), 0)


def _batches(cfg, width, n, seed=0):
    src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=cfg.num_clients,
                            beta=0.5, seed=seed)
    return list(client_batches(src, width, steps=n, seed=seed, seq_len=S))


def test_lm_batches_are_byte_identical():
    kw = dict(vocab_size=64, num_clients=3, beta=0.7, seed=4)
    ref = list(jax_client_batches(JaxLMSource(**kw), 5, steps=3, seq_len=17,
                                  seed=2, as_numpy=True))
    src = MultiTaskLMSource(**kw)
    got = list(client_batches(src, 5, steps=3, seq_len=17, seed=2))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.keys() == b.keys() == {"tokens"}
        assert a["tokens"].dtype == b["tokens"].dtype == np.int32
        assert a["tokens"].shape == (3, 5, 17)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    jsrc = JaxLMSource(**kw)
    for m in range(3):
        np.testing.assert_array_equal(src.chains[m], jsrc.chains[m])
        assert src.entropy_floor(m) == jsrc.entropy_floor(m)


def _run_case(case):
    arch, skw, mb, kernels = CASES[case]
    cfg = get_config(arch, smoke=True)
    cfg_j = jax_get_config(arch, smoke=True)
    assert cfg.__dict__ == cfg_j.__dict__
    model_j = jax_build_model(cfg_j.with_updates(use_flash_kernel=kernels))
    M = cfg.num_clients
    scaled = bool(skw) or mb > 1
    hp_j = jax_alg.HParams(lr=LR, microbatches=mb, component_lr=(
        jax_lr_policy.server_scaled(M) if scaled else None))
    hp = alg_mod.HParams(lr=LR, microbatches=mb, component_lr=(
        lr_policy.server_scaled(M) if scaled else None))
    stream_j = jax_schedule.schedule_stream(jax_schedule.ScheduleConfig(**skw), M, 1, B)
    stream = schedule.schedule_stream(schedule.ScheduleConfig(**skw), M, 1, B)
    rf_j = jax_alg.jit_round_fn(jax_alg.get_algorithm("mtsl"), model_j, M, hp_j)
    alg = alg_mod.get_algorithm("mtsl")
    model = build_model(cfg)
    rf = alg.round_fn(model, M, hp)
    state_j, state = _reference_init(arch), _port_state(arch, cfg)
    for batch in _batches(cfg, B, ROUNDS):
        state_j, met_j = rf_j(state_j, batch, next(stream_j))
        state, met = rf(state, stage_batch(batch, "cpu"), next(stream))
        assert set(met) == set(met_j) == {"loss", "per_task", "aux"}
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
    return model_j, model, state_j, state


@pytest.mark.parametrize("case", list(CASES))
def test_lm_mtsl_round_matches_jax(case):
    model_j, model, state_j, state = _run_case(case)
    if case != "zamba2-full":
        return
    # the LM eval on a held-out batch: per-task next-token losses
    cfg, M = model.cfg, model.cfg.num_clients
    ev_batch = _batches(cfg, 3, 1, seed=9)[0]
    ev_j = jax.jit(jax_alg.get_algorithm("mtsl").eval_fn(model_j, M))(state_j, ev_batch)
    ev = alg_mod.get_algorithm("mtsl").eval_fn(model, M)(state, stage_batch(ev_batch, "cpu"))
    assert set(ev) == set(ev_j) == {"per_task_loss", "loss"}
    np.testing.assert_allclose(ev["per_task_loss"].numpy(),
                               np.asarray(ev_j["per_task_loss"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ev["loss"]), float(ev_j["loss"]), rtol=TOL, atol=TOL)


def test_lm_towers_run_per_client():
    """The LM towers are a loop over clients on views of the stacked
    tree: client m's smashed output is its own tower on its own tokens."""
    from repro_torch.core.split import client_view
    from repro_torch.core.mtsl import _towers_fn

    cfg = get_config("zamba2-7b", smoke=True)
    model = build_model(cfg)
    params = _port_state("zamba2-7b", cfg).params
    toks = stage_batch(_batches(cfg, B, 1)[0], "cpu")["tokens"]
    with torch.no_grad():
        h = _towers_fn(model, cfg.num_clients)(params["towers"], {"tokens": toks})["h"]
        for m in range(cfg.num_clients):
            one = model.tower_forward(client_view(params["towers"], m),
                                      {"tokens": toks[m]})["h"]
            assert torch.equal(h[m], one)


@pytest.mark.parametrize("scan", [False, True])
def test_converted_zamba2_tree_gives_the_reference_loss(scan):
    """A JAX-initialised zamba2 tree (the stack-level shared block, the
    Mamba leaves, and under scan_layers a repeating server segment) carried
    across with params_from_jax: a training tree with every leaf in f32,
    and the same mtsl loss and per-task losses (1e-5) in both packages."""
    from repro.core.mtsl import make_loss_fn as jax_make_loss_fn
    from repro_torch.core.mtsl import make_loss_fn

    kw = {"num_layers": 7, "scan_layers": True} if scan else {}
    cfg_j = jax_get_config("zamba2-7b", smoke=True).with_updates(**kw)
    cfg = get_config("zamba2-7b", smoke=True).with_updates(**kw)
    model_j, M = jax_build_model(cfg_j), cfg.num_clients
    state_j = jax.jit(lambda r: jax_alg.get_algorithm("mtsl").init_state(
        model_j, r, M, jax_alg.HParams()))(jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, state_j.params), "cpu", cfg)
    assert "shared" in params["server"]["blocks"]
    assert isinstance(params["server"]["blocks"]["seg0"], list) == scan
    assert {x.dtype for _, x in tree_leaves_with_path(params)} == {torch.float32}
    batch = _batches(cfg, B, 1, seed=5)[0]
    loss_j, met_j = jax.jit(jax_make_loss_fn(model_j, M))(state_j.params, batch)
    with torch.no_grad():
        loss, met = make_loss_fn(build_model(cfg), M)(params, stage_batch(batch, "cpu"))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(met["per_task"].numpy(), np.asarray(met_j["per_task"]),
                               rtol=TOL, atol=TOL)
