"""Layer functions of the PyTorch port against the JAX reference, on the
gemma3-12b smoke config in f32: the same numpy inputs and the same weights
(initialised in JAX, carried across with the port's converter) through
`repro.models.layers` and `repro_torch.models.layers`. Tolerance 1e-5:
f32 in both, differing only in reduction order and transcendental ulps.
Decode runs the reference with its Pallas kernel on (interpret mode) and
off; the port's decode always goes through its flash-decode wrapper.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as JL
from repro.utils.sharding import strip
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.utils.convert import convert_tree

TOL = 1e-5
CFG_J = jax_get_config("gemma3-12b", smoke=True)
CFG_T = get_config("gemma3-12b", smoke=True)
WINDOW = CFG_T.sliding_window  # 16


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=0)


def _attn_params(seed=3):
    pj = strip(JL.attn_params(jax.random.PRNGKey(seed), CFG_J))
    return pj, convert_tree(jax.tree.map(np.asarray, pj), "cpu", CFG_T)


def _jit(fn, **static):
    """The reference function under jit (one compile instead of one per
    eager op)."""
    return jax.jit(functools.partial(fn, **static))


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_configs_are_copies():
    assert CFG_T.__dict__ == CFG_J.__dict__
    full_t, full_j = get_config("gemma3-12b"), jax_get_config("gemma3-12b")
    assert full_t.__dict__ == full_j.__dict__
    assert full_t.param_count() == full_j.param_count()


def test_rmsnorm_rope_embed_mlp():
    rng = np.random.default_rng(0)
    d = CFG_T.d_model
    x = _rand(rng, 2, 5, d)
    scale = 1.0 + 0.1 * _rand(rng, d)
    _close(TL.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x)),
           _jit(JL.rmsnorm)({"scale": jnp.asarray(scale)}, jnp.asarray(x)))

    xh = _rand(rng, 2, 5, 4, 32)
    pos = rng.integers(0, 600, size=(2, 5))
    for theta in (CFG_T.rope_theta, 1_000_000.0):
        _close(TL.rope(torch.tensor(xh), torch.tensor(pos), theta),
               _jit(JL.rope, theta=theta)(jnp.asarray(xh), jnp.asarray(pos)))

    pe = strip(JL.embedding_params(jax.random.PRNGKey(1), CFG_J))
    toks = rng.integers(0, CFG_T.vocab_size, size=(2, 7))
    _close(TL.embed(convert_tree(jax.tree.map(np.asarray, pe), "cpu", CFG_T),
                    torch.tensor(toks), CFG_T),
           _jit(JL.embed, cfg=CFG_J)(pe, jnp.asarray(toks)))

    pm = strip(JL.mlp_params(jax.random.PRNGKey(2), CFG_J))
    _close(TL.mlp_forward(convert_tree(jax.tree.map(np.asarray, pm), "cpu",
                                       CFG_T), torch.tensor(x), CFG_T),
           _jit(JL.mlp_forward, cfg=CFG_J)(pm, jnp.asarray(x)))


@pytest.mark.parametrize("window", [0, WINDOW])
def test_attn_prefill(window):
    pj, pt = _attn_params()
    x = _rand(np.random.default_rng(1), 2, 11, CFG_T.d_model)
    yj, cj = _jit(JL.attn_prefill, cfg=CFG_J, window=window, max_len=20)(
        pj, jnp.asarray(x))
    yt, ct = TL.attn_prefill(pt, torch.tensor(x), CFG_T, window=window, max_len=20)
    _close(yt, yj)
    _close(ct["k"], cj["k"])
    _close(ct["v"], cj["v"])


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("window", [0, WINDOW])
def test_attn_decode_per_row_positions(window, flash):
    """Per-row positions (one slot at its own depth each), some past the
    window; the port writes the new K/V in place and leaves frozen rows'
    caches untouched."""
    pj, pt = _attn_params()
    rng = np.random.default_rng(2)
    B, cap = 4, 48
    x = _rand(rng, B, 1, CFG_T.d_model)
    k = _rand(rng, B, cap, CFG_T.num_kv_heads, CFG_T.head_dim)
    v = _rand(rng, B, cap, CFG_T.num_kv_heads, CFG_T.head_dim)
    pos = np.array([0, 9, 30, 47], np.int32)
    cfg_j = CFG_J.with_updates(use_flash_kernel=flash)
    yj, cj = _jit(JL.attn_decode, cfg=cfg_j, window=window)(
        pj, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(pos))
    cache = {"k": torch.tensor(k), "v": torch.tensor(v)}
    yt = TL.attn_decode(pt, torch.tensor(x), cache, torch.tensor(pos), CFG_T,
                        window=window)
    _close(yt, yj)
    _close(cache["k"], cj["k"])
    _close(cache["v"], cj["v"])

    write = torch.tensor([True, False, True, False])
    frozen = {"k": torch.tensor(k), "v": torch.tensor(v)}
    TL.attn_decode(pt, torch.tensor(x), frozen, torch.tensor(pos), CFG_T,
                   window=window, write=write)
    for name, old in (("k", k), ("v", v)):
        torch.testing.assert_close(frozen[name][~write], torch.tensor(old)[~write],
                                   rtol=0, atol=0)
        torch.testing.assert_close(frozen[name][write], cache[name][write],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("window", [0, WINDOW])
def test_attn_extend(window):
    pj, pt = _attn_params()
    rng = np.random.default_rng(4)
    B, C, cap = 3, 8, 32
    x = _rand(rng, B, C, CFG_T.d_model)
    k = _rand(rng, B, cap, CFG_T.num_kv_heads, CFG_T.head_dim)
    v = _rand(rng, B, cap, CFG_T.num_kv_heads, CFG_T.head_dim)
    start = np.array([0, 8, 24], np.int32)
    yj, cj = _jit(JL.attn_extend, cfg=CFG_J, window=window)(
        pj, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v)},
        jnp.asarray(start))
    cache = {"k": torch.tensor(k), "v": torch.tensor(v)}
    yt = TL.attn_extend(pt, torch.tensor(x), cache, torch.tensor(start), CFG_T,
                        window=window)
    _close(yt, yj)
    _close(cache["k"], cj["k"])
    _close(cache["v"], cj["v"])
