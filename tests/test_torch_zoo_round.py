"""The port's mtsl round on the rest of the model zoo against the JAX
reference's: the MoE archs (deepseek-moe-16b with a dense lead layer and
shared experts, qwen3-moe-30b-a3b), a dense arch not covered before
(mistral-nemo-12b), the VLM (llama-3.2-vision-11b: cross-attention layers
over projected vision features) and the encoder-decoder (whisper-tiny:
non-causal encoder blocks, the decoder's cross attention, the tokens
carried in the smashed data).

Three rounds through each package's registry on each smoke config, from
one initial tree (initialised in JAX, carried across with
`params_from_jax`, which so covers every new tree) and the same numpy
batches: tokens from the LM source, `vis` / `frames` from
`np.random.default_rng`, shaped as the reference's `launch/specs.py` shapes
them. Each package draws its own (byte-identical) schedule stream; cases
full and masked (participation 0.5), both with the server-scaled component
LR, so that one jitted reference round serves both. The port's attention
runs K2's plain versions on CPU tensors. Tolerance: losses, per-task
losses and every parameter leaf within 1e-5 (f32, reduction order), as
`tests/test_torch_lm_round.py` holds them.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import algorithms as jax_alg
from repro.core import lr_policy as jax_lr_policy
from repro.core import schedule as jax_schedule
from repro.models.registry import build_model as jax_build_model
from repro.utils.tree import flatten_dict
from repro_torch.configs import get_config
from repro_torch.core import algorithms as alg_mod
from repro_torch.core import lr_policy, schedule
from repro_torch.data.lm import MultiTaskLMSource
from repro_torch.data.pipeline import client_batches
from repro_torch.models.registry import build_model
from repro_torch.train.loop import stage_batch
from repro_torch.utils.convert import state_from_jax
from repro_torch.utils.tree import tree_leaves_with_path

ROUNDS, B, S, LR, TOL = 3, 2, 24, 0.1, 1e-5
ARCHS = ("deepseek-moe-16b", "qwen3-moe-30b-a3b", "mistral-nemo-12b",
         "llama-3.2-vision-11b", "whisper-tiny")
SCHEDULES = {"full": {}, "masked": {"participation_rate": 0.5, "seed": 3}}


def zoo_batches(cfg, width, n, seq_len, seed=0):
    """n round batches {"tokens": [M, width, seq_len]} from the LM source,
    plus the VLM's "vis" [M, width, vis_seq, vis_dim] or the
    encoder-decoder's "frames" [M, width, encoder_seq, d_model] in f32 from
    np.random.default_rng(seed)."""
    M = cfg.num_clients
    src = MultiTaskLMSource(vocab_size=cfg.vocab_size, num_clients=M, beta=0.5,
                            seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for batch in client_batches(src, width, steps=n, seed=seed, seq_len=seq_len):
        if cfg.family == "vlm":
            batch["vis"] = rng.standard_normal(
                (M, width, cfg.vis_seq, cfg.vis_dim), dtype=np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (M, width, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
        out.append(batch)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(model, initial state, jitted round) of the reference, per arch."""
    cfg = jax_get_config(arch, smoke=True)
    model = jax_build_model(cfg)
    M = cfg.num_clients
    hp = jax_alg.HParams(lr=LR, component_lr=jax_lr_policy.server_scaled(M))
    alg = jax_alg.get_algorithm("mtsl")
    init = jax.jit(lambda rng: alg.init_state(model, rng, M, hp))(
        jax.random.PRNGKey(11))
    return model, init, jax_alg.jit_round_fn(alg, model, M, hp)


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_zoo_mtsl_round_matches_jax(arch, sched):
    cfg = get_config(arch, smoke=True)
    assert cfg.__dict__ == jax_get_config(arch, smoke=True).__dict__
    _, state_j, rf_j = _reference(arch)
    M = cfg.num_clients
    skw = SCHEDULES[sched]
    stream_j = jax_schedule.schedule_stream(jax_schedule.ScheduleConfig(**skw), M, 1, B)
    stream = schedule.schedule_stream(schedule.ScheduleConfig(**skw), M, 1, B)
    rf = alg_mod.get_algorithm("mtsl").round_fn(build_model(cfg), M, alg_mod.HParams(
        lr=LR, component_lr=lr_policy.server_scaled(M)))
    state = state_from_jax("mtsl", jax.tree.map(np.asarray, state_j), "cpu", cfg)
    for batch in zoo_batches(cfg, B, ROUNDS, S):
        state_j, met_j = rf_j(state_j, batch, next(stream_j))
        state, met = rf(state, stage_batch(batch, "cpu"), next(stream))
        assert set(met) == set(met_j) == {"loss", "per_task", "aux"}
        for key in ("loss", "aux"):
            np.testing.assert_allclose(float(met[key]), float(met_j[key]),
                                       rtol=TOL, atol=TOL)
        np.testing.assert_allclose(met["per_task"].numpy(),
                                   np.asarray(met_j["per_task"]), rtol=TOL, atol=TOL)
    if cfg.family == "moe":
        assert float(met["aux"]) > 0  # the router's balance loss is on the path
    leaves_j = flatten_dict(state_j.params)
    leaves = dict(tree_leaves_with_path(state.params))
    assert sorted(leaves) == sorted(leaves_j)
    for path, a in leaves.items():
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(leaves_j[path]),
                                   rtol=TOL, atol=TOL, err_msg=path)
    assert state.step == int(state_j.step) == ROUNDS
