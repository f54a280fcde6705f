"""Shared by the tests of the port's MoE serving path
(`tests/test_torch_moe_serving.py`, deepseek-moe-16b: a dense lead layer,
shared experts; `tests/test_torch_moe_serving_qwen3.py`,
qwen3-moe-30b-a3b: no shared experts), against the JAX reference in f32
on the smoke configs:

  * the `moe` block's prefill, decode and extend (outputs and KV caches)
    within 1e-5 of the reference's block on the same weights;
  * the reference's continuous-batching scenario (3 slots, 5 mixed-length
    requests, chunk 4, M = 2): greedy tokens of the port's ContinuousEngine
    and generate_sequential equal the reference's generate_sequential
    token for token (tests/torch_ssm_serving.py), and the reference's
    ContinuousEngine gives the same tokens.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_ssm_serving as S
from repro.configs import get_config as jax_get_config
from repro.models import stacks as JST
from repro.serve.continuous import ContinuousEngine as JaxContinuousEngine
from repro.serve.continuous import Request as JaxRequest
from repro.utils.sharding import strip
from repro_torch.configs import get_config
from repro_torch.models import stacks as TST
from repro_torch.utils.convert import convert_tree

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


@functools.lru_cache(maxsize=None)
def _block(arch):
    cfg_j, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    bj, bt = JST.make_block(cfg_j, "moe"), TST.make_block(cfg, "moe")
    pj = strip(bj.init(jax.random.PRNGKey(4)))
    pt = convert_tree(jax.tree.map(np.asarray, pj), "cpu", cfg)
    return cfg, bj, bt, pj, pt


def check_block_serving(arch):
    cfg, bj, bt, pj, pt = _block(arch)
    rng = np.random.default_rng(1)
    B, L, cap, C = 2, 9, 24, 4
    x = rng.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    x_t = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    x_c = rng.normal(size=(B, C, cfg.d_model)).astype(np.float32)
    pos = np.array([L, L - 3], np.int32)

    @jax.jit
    def ref(p, x, x_t, x_c, pos):
        y, cache = bj.prefill(p, x, {"max_len": cap})
        y_t, cache_t = bj.decode(p, x_t, cache, {"pos": pos})
        y_c, cache_c = bj.extend(p, x_c, cache_t, {"start": pos + 1})
        return y, cache, y_t, cache_t, y_c, cache_c

    want = jax.tree.map(np.asarray, ref(pj, *map(jnp.asarray, (x, x_t, x_c, pos))))
    with torch.no_grad():
        y, cache = bt.prefill(pt, torch.tensor(x), {"max_len": cap})
        _close(y, want[0])
        for k in ("k", "v"):
            _close(cache[k], want[1][k])
        y_t = bt.decode(pt, torch.tensor(x_t), cache, {"pos": torch.tensor(pos)})
        _close(y_t, want[2])
        for k in ("k", "v"):
            _close(cache[k], want[3][k])
        y_c = bt.extend(pt, torch.tensor(x_c), cache,
                        {"start": torch.tensor(pos + 1), "n_valid": C})
        _close(y_c, want[4])
        for k in ("k", "v"):
            _close(cache[k], want[5][k])


@functools.lru_cache(maxsize=None)
def _reference_continuous(arch):
    """The reference's ContinuousEngine on tests/torch_ssm_serving.py's
    scenario, over the port's weights."""
    cfg, model, params = S._reference(arch)
    eng = JaxContinuousEngine(model, params, cfg.num_clients, S.MAX_LEN,
                              slots=3, chunk=4)
    for i, (p, n) in enumerate(zip(S._prompts(cfg), S.NEW_TOKENS)):
        eng.submit(JaxRequest(id=i, client=i % cfg.num_clients, tokens=p,
                              new_tokens=n))
    res = eng.run()
    return [np.asarray(res[i]) for i in range(len(S.PROMPT_LENS))]


def check_greedy_parity(arch):
    S.check_greedy_parity(arch)
    refs, _ = S._reference_outputs(arch)
    for got, want in zip(_reference_continuous(arch), refs):
        np.testing.assert_array_equal(got, want)
