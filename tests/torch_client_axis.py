"""Shared by tests/test_torch_client_axis*.py and
tests/test_torch_scan_round.py: the reference's chunked round and host
scan round from their own inits (cached per algorithm or optimizer), and
the checks that hold the port's rounds against them."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.core import schedule
from repro_torch.core.algorithms import HParams, get_algorithm, shard_round_fn
from repro_torch.core.client_axis import client_axis
from repro_torch.core.mtsl import TrainState
from repro_torch.core.scan_round import build_mtsl_scan_round
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizers import adamw, momentum, sgd
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import state_from_jax

CFG = get_config("paper-mlp", smoke=True)
MODEL = build_model(CFG)
M = 4
CHUNK = 2


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


def _batch(rows, seed=0):
    rng = np.random.default_rng(seed)
    return {"image": rng.normal(size=(M, rows, CFG.image_size, CFG.image_size))
            .astype(np.float32),
            "label": rng.integers(0, CFG.num_classes, size=(M, rows)).astype(np.int32)}


def _schedules(module, ls, arr):
    """full, and masked with straggler budgets (the budget-1 entries)."""
    full = module.full_schedule(M, ls)
    masked = module.ClientSchedule(
        mask=arr(np.array([1.0, 0.0] * (M // 2), np.float32)),
        budget=arr(np.array([max(ls, 1), 1] * (M // 2), np.int32)))
    return {"full": full, "masked": masked}


@functools.lru_cache(maxsize=None)
def _reference(alg):
    """The reference's chunked round from its own init: (init, {schedule:
    losses}) for 3 rounds."""
    model = jax_build_model(jax_get_config("paper-mlp", smoke=True))
    a = jax_alg.get_algorithm(alg)
    ls = 1 if alg == "mtsl" else 2
    hp = jax_alg.HParams(lr=0.1, local_steps=ls)
    spr = a.steps_per_round(hp)
    init = jax.jit(lambda r: a.init_state(model, r, M, hp))(jax.random.PRNGKey(0))
    rf = jax_alg.shard_round_fn(a, model, M, hp, client_chunk=CHUNK)
    batch = {k: jnp.asarray(v) for k, v in _batch(8 * spr).items()}
    out = {}
    for name, sched in _schedules(jax_schedule, ls, jnp.asarray).items():
        s, losses = init, []
        for _ in range(3):
            s, m = rf(s, batch, sched)
            losses.append(float(m["loss"]))
        out[name] = losses
    return jax.tree.map(np.asarray, init), out


def check_chunked_round(alg, sched_name):
    """3 rounds of the port's chunked round against its dense round
    (losses and every state leaf within 1e-5) and the reference's chunked
    round (losses within 1e-5 of scale), and the chunked eval against the
    dense eval."""
    init_j, ref_losses = _reference(alg)
    ls = 1 if alg == "mtsl" else 2
    a = get_algorithm(alg)
    hp = HParams(lr=0.1, local_steps=ls)
    sched = _schedules(schedule, ls, lambda x: x)[sched_name]
    batch = stage_batch(_batch(8 * a.steps_per_round(hp)), "cpu")
    dense = a.round_fn(MODEL, M, hp)
    chunked = shard_round_fn(a, MODEL, M, hp, client_chunk=CHUNK)
    s_d = state_from_jax(alg, init_j, "cpu", CFG)
    s_c = state_from_jax(alg, init_j, "cpu", CFG)
    scale = max(1.0, max(abs(x) for x in ref_losses[sched_name]))
    for r in range(3):
        s_d, m_d = dense(s_d, batch, sched)
        s_c, m_c = chunked(s_c, batch, sched)
        assert abs(float(m_c["loss"]) - float(m_d["loss"])) <= 1e-5 * scale
        assert abs(float(m_c["loss"]) - ref_losses[sched_name][r]) <= 1e-5 * scale
    for x, y in zip(leaves(s_d), leaves(s_c)):
        torch.testing.assert_close(y.detach(), x.detach(), rtol=0, atol=1e-5)
    ev = a.eval_fn(MODEL, M)
    with client_axis(chunk=CHUNK):
        e_c = ev(s_c, batch)
    e_d = ev(s_c, batch)
    for k in e_d:
        torch.testing.assert_close(e_c[k], e_d[k], rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _reference_scan(opt_name):
    """The reference's host scan round (chunk CHUNK) from its own init:
    (init params, {schedule: (losses, final params)}) for 3 rounds."""
    from repro.core.scan_round import build_mtsl_scan_round as jax_scan_round
    from repro.optim.optimizers import adamw as jax_adamw
    from repro.optim.optimizers import momentum as jax_momentum

    model = jax_build_model(jax_get_config("paper-mlp", smoke=True))
    opt = {"sgd": None, "momentum": jax_momentum(0.1), "adamw": jax_adamw(0.1)}[opt_name]
    hp = jax_alg.HParams(lr=0.1, local_steps=1, optimizer=opt)
    a = jax_alg.get_algorithm("mtsl")
    init = jax.jit(lambda r: a.init_state(model, r, M, hp))(jax.random.PRNGKey(0))
    rf = jax_scan_round(model, M, hp, chunk=CHUNK)
    batch = {k: jnp.asarray(v) for k, v in _batch(8).items()}
    out = {}
    for name, sched in _schedules(jax_schedule, 1, jnp.asarray).items():
        s, losses = init, []
        for _ in range(3):
            s, m = rf(s, batch, sched)
            losses.append(float(m["loss"]))
        out[name] = (losses, jax.tree.map(np.asarray, s.params))
    return jax.tree.map(np.asarray, init.params), out


def _port_params(params_j):
    return state_from_jax("mtsl", TrainState(params_j, (), 0), "cpu", CFG).params


def check_scan_round(opt_name, sched_name):
    """3 rounds of the port's scan round against the reference's from the
    same converted init and batches: losses within 1e-5 of their scale,
    parameters within 1e-5 (adamw: and 1e-4 of 1, as the dense test)."""
    init_j, ref = _reference_scan(opt_name)
    ref_losses, ref_params = ref[sched_name]
    opt = {"sgd": None, "momentum": momentum(0.1), "adamw": adamw(0.1)}[opt_name]
    hp = HParams(lr=0.1, optimizer=opt)
    params = _port_params(init_j)
    state = TrainState(params, (opt if opt is not None else sgd(0.1)).init(params), 0)
    scan = build_mtsl_scan_round(MODEL, M, hp, chunk=CHUNK)
    sched = _schedules(schedule, 1, lambda x: x)[sched_name]
    batch = stage_batch(_batch(8), "cpu")
    scale = max(1.0, max(abs(x) for x in ref_losses))
    for r in range(3):
        state, metrics = scan(state, batch, sched)
        assert abs(float(metrics["loss"]) - ref_losses[r]) <= 1e-5 * scale
    rtol = 1e-4 if opt_name == "adamw" else 0
    for x, y in zip(leaves(_port_params(ref_params)), leaves(state.params)):
        torch.testing.assert_close(y.detach(), x, rtol=rtol, atol=1e-5)
